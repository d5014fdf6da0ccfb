// Fast edge-list parser: mmap + manual tokenizing, multithreaded by chunk.
//
// Host-side native equivalent of the reference's file loaders
// (structures/Graph.java:28-50 BufferedReader+split, networkx read_edgelist
// in node2vec/src/main.py:76-89).  Exposed to Python via ctypes
// (graphtpu_torch/native/__init__.py).  Lines: "src SEP dst [SEP weight]".
// delimiter '\0' means any run of spaces/tabs/commas.
//
// Built with g++ at first use by graphtpu_torch/native/__init__.py.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <atomic>
#include <thread>
#include <vector>

namespace {

struct Chunk {
  const char* begin;
  const char* end;
  int64_t count = 0;
  bool weighted = false;
  std::vector<int64_t> src, dst;
  std::vector<float> wts;
};

inline bool is_sep(char c, char delim) {
  if (delim != '\0') return c == delim || c == ' ' || c == '\t';
  return c == ' ' || c == '\t' || c == ',';
}

inline const char* parse_i64(const char* p, const char* end, int64_t* out) {
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) { neg = (*p == '-'); ++p; }
  int64_t v = 0;
  const char* start = p;
  while (p < end && *p >= '0' && *p <= '9') { v = v * 10 + (*p - '0'); ++p; }
  if (p == start) return nullptr;
  *out = neg ? -v : v;
  return p;
}

void parse_chunk(Chunk* ch, char delim) {
  const char* p = ch->begin;
  const char* end = ch->end;
  while (p < end) {
    // skip leading whitespace / blank lines
    while (p < end && (*p == '\n' || *p == '\r' || *p == ' ' || *p == '\t')) ++p;
    if (p >= end) break;
    const char* eol = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!eol) eol = end;
    int64_t a, b;
    const char* q = parse_i64(p, eol, &a);
    if (q) {
      while (q < eol && is_sep(*q, delim)) ++q;
      const char* r = parse_i64(q, eol, &b);
      if (r) {
        ch->src.push_back(a);
        ch->dst.push_back(b);
        while (r < eol && is_sep(*r, delim)) ++r;
        if (r < eol && *r != '\r') {
          char* wend = nullptr;
          float w = strtof(r, &wend);
          if (wend && wend != r) {
            ch->wts.push_back(w);
            ch->weighted = true;
          } else {
            ch->wts.push_back(1.0f);
          }
        } else {
          ch->wts.push_back(1.0f);
        }
        ++ch->count;
      }
    }
    p = eol + 1;
  }
}

}  // namespace

extern "C" {

// Returns edge count, or -1 on error.  Caller provides output buffers with
// `capacity` slots; has_weights set to 1 if any line carried a weight column.
int64_t gt_parse_edgelist(const char* path, char delim, int64_t* out_src,
                          int64_t* out_dst, float* out_wts, int* has_weights,
                          int64_t capacity) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) { close(fd); return -1; }
  if (st.st_size == 0) { close(fd); *has_weights = 0; return 0; }
  const char* data = static_cast<const char*>(
      mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0));
  close(fd);
  if (data == MAP_FAILED) return -1;
  const char* end = data + st.st_size;

  unsigned hw = std::thread::hardware_concurrency();
  size_t nthreads = hw ? hw : 2;
  if (static_cast<size_t>(st.st_size) < (1u << 20)) nthreads = 1;

  std::vector<Chunk> chunks(nthreads);
  size_t chunk_bytes = st.st_size / nthreads + 1;
  const char* pos = data;
  for (size_t i = 0; i < nthreads; ++i) {
    const char* cend = pos + chunk_bytes;
    if (cend >= end) {
      cend = end;
    } else {
      const char* nl = static_cast<const char*>(memchr(cend, '\n', end - cend));
      cend = nl ? nl + 1 : end;  // advance to a line boundary
    }
    chunks[i].begin = pos;
    chunks[i].end = cend;
    pos = cend;
    if (pos >= end) { chunks.resize(i + 1); break; }
  }

  std::vector<std::thread> threads;
  for (size_t i = 1; i < chunks.size(); ++i)
    threads.emplace_back(parse_chunk, &chunks[i], delim);
  parse_chunk(&chunks[0], delim);
  for (auto& t : threads) t.join();

  int64_t total = 0;
  bool weighted = false;
  for (auto& ch : chunks) { total += ch.count; weighted |= ch.weighted; }
  if (total > capacity) { munmap(const_cast<char*>(data), st.st_size); return -1; }

  int64_t off = 0;
  for (auto& ch : chunks) {
    memcpy(out_src + off, ch.src.data(), ch.count * sizeof(int64_t));
    memcpy(out_dst + off, ch.dst.data(), ch.count * sizeof(int64_t));
    memcpy(out_wts + off, ch.wts.data(), ch.count * sizeof(float));
    off += ch.count;
  }
  *has_weights = weighted ? 1 : 0;
  munmap(const_cast<char*>(data), st.st_size);
  return total;
}

}  // extern "C"
