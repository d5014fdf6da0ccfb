// Massive synthetic-graph generator: multithreaded, Bloom-filter dedup,
// streamed edge-list output.
//
// Host-side native equivalent of the reference's huge-graph fixture tools:
// utils/GraphGeneratorBf.java:21-39 (multithreaded 700M-vertex bipartite
// generator deduping through a Guava BloomFilter) and the uniform/directed
// modes of utils/GraphGenerator.java:28-93.  Like the reference, dedup is
// probabilistic: a Bloom false positive drops a genuinely-new edge, which is
// acceptable for fixture graphs (the bit budget below keeps the rate <2%).
//
// Exposed to Python via ctypes and built with g++ at first use by
// graphtpu_torch/native/__init__.py.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// splitmix64: tiny, high-quality, per-thread seedable PRNG.
inline uint64_t splitmix64(uint64_t* state) {
  uint64_t z = (*state += 0x9E3779B97F4A7C15ULL);
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ULL;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBULL;
  return z ^ (z >> 31);
}

// Lock-free Bloom filter over a shared atomic bitset; test-and-set returns
// true iff the key was (probably) already present.
class BloomFilter {
 public:
  BloomFilter(uint64_t n_keys, int bits_per_key = 12)
      : nbits_(round_pow2(n_keys * static_cast<uint64_t>(bits_per_key))),
        mask_(nbits_ - 1),
        words_((nbits_ + 63) / 64) {}

  bool test_and_set(uint64_t key) {
    uint64_t h1 = mix(key);
    uint64_t h2 = mix(key ^ 0x9E3779B97F4A7C15ULL) | 1;  // odd stride
    bool all_set = true;
    for (int i = 0; i < 3; ++i) {
      uint64_t bit = (h1 + static_cast<uint64_t>(i) * h2) & mask_;
      uint64_t word_mask = 1ULL << (bit & 63);
      uint64_t prev =
          words_[bit >> 6].fetch_or(word_mask, std::memory_order_relaxed);
      all_set &= (prev & word_mask) != 0;
    }
    return all_set;
  }

 private:
  static uint64_t round_pow2(uint64_t v) {
    uint64_t p = 1024;
    while (p < v) p <<= 1;
    return p;
  }
  static uint64_t mix(uint64_t z) {
    z = (z ^ (z >> 33)) * 0xFF51AFD7ED558CCDULL;
    z = (z ^ (z >> 33)) * 0xC4CEB9FE1A85EC53ULL;
    return z ^ (z >> 33);
  }
  uint64_t nbits_, mask_;
  std::vector<std::atomic<uint64_t>> words_;
};

struct GenJob {
  FILE* out;
  std::mutex io_mu;
  BloomFilter* bloom;
  std::atomic<int64_t> accepted{0};
  int64_t target;
  int64_t n_left, n_right;
  int mode;  // 0 = bipartite (dst offset by n_left), 1 = uniform undirected,
             // 2 = directed
};

inline char* append_u64(char* p, uint64_t v) {
  char tmp[20];
  int n = 0;
  do {
    tmp[n++] = static_cast<char>('0' + v % 10);
    v /= 10;
  } while (v);
  while (n) *p++ = tmp[--n];
  return p;
}

// Each worker owns the disjoint key class {key : key % n_threads == tid} and
// skips draws outside it (the reference partitions the src id space per
// thread for the same reason, GraphGeneratorBf.java): two threads can then
// never race test_and_set on the same key, which would otherwise let both
// observe not-set bits and emit a duplicate edge.  The union of uniform
// draws filtered per class is still uniform over the key space.
void gen_worker(GenJob* job, uint64_t seed, uint64_t tid, uint64_t nthreads) {
  uint64_t st = seed;
  std::string buf;
  buf.reserve(1 << 20);
  char line[48];
  while (job->accepted.load(std::memory_order_relaxed) < job->target) {
    uint64_t a, b, key;
    if (job->mode == 0) {  // bipartite
      a = splitmix64(&st) % static_cast<uint64_t>(job->n_left);
      b = splitmix64(&st) % static_cast<uint64_t>(job->n_right);
      key = a * static_cast<uint64_t>(job->n_right) + b;
      b += static_cast<uint64_t>(job->n_left);
    } else {
      a = splitmix64(&st) % static_cast<uint64_t>(job->n_left);
      b = splitmix64(&st) % static_cast<uint64_t>(job->n_left);
      if (a == b) continue;  // GraphGenerator skips self-loops
      if (job->mode == 1) {  // undirected: canonical (min,max) key
        uint64_t lo = a < b ? a : b, hi = a < b ? b : a;
        key = lo * static_cast<uint64_t>(job->n_left) + hi;
      } else {
        key = a * static_cast<uint64_t>(job->n_left) + b;
      }
    }
    if (nthreads > 1 && key % nthreads != tid) continue;  // not my key class
    if (job->bloom->test_and_set(key)) continue;  // (probably) duplicate
    // claim a slot; roll back if another thread crossed the target first
    int64_t slot = job->accepted.fetch_add(1, std::memory_order_relaxed);
    if (slot >= job->target) {
      job->accepted.fetch_sub(1, std::memory_order_relaxed);
      break;
    }
    char* p = append_u64(line, a);
    *p++ = ' ';
    p = append_u64(p, b);
    *p++ = '\n';
    buf.append(line, p - line);
    if (buf.size() >= (1 << 20) - 64) {
      std::lock_guard<std::mutex> lk(job->io_mu);
      fwrite(buf.data(), 1, buf.size(), job->out);
      buf.clear();
    }
  }
  if (!buf.empty()) {
    std::lock_guard<std::mutex> lk(job->io_mu);
    fwrite(buf.data(), 1, buf.size(), job->out);
  }
}

}  // namespace

extern "C" {

// Generate `target_edges` deduped random edges and stream them to `path` as
// "src dst" lines.  mode: 0 bipartite (right ids offset by n_left, matching
// GraphGenerator.generateBipartite), 1 uniform undirected, 2 directed.
// Returns edges written, or -1 on error.
int64_t gt_generate_graph(const char* path, int64_t n_left, int64_t n_right,
                          int64_t target_edges, int mode, uint64_t seed,
                          int n_threads) {
  if (target_edges <= 0 || n_left <= 0 || (mode == 0 && n_right <= 0))
    return -1;
  // can't place more unique edges than the key space holds
  uint64_t space = mode == 0
                       ? static_cast<uint64_t>(n_left) *
                             static_cast<uint64_t>(n_right)
                       : static_cast<uint64_t>(n_left) *
                             static_cast<uint64_t>(n_left - 1) /
                             (mode == 1 ? 2 : 1);
  if (static_cast<uint64_t>(target_edges) > space / 2)
    return -1;  // Bloom dedup needs a sparse key space (as in the reference)
  FILE* out = fopen(path, "w");
  if (!out) return -1;

  GenJob job;
  job.out = out;
  job.bloom = new BloomFilter(static_cast<uint64_t>(target_edges));
  job.target = target_edges;
  job.n_left = n_left;
  job.n_right = n_right;
  job.mode = mode;

  unsigned hw = std::thread::hardware_concurrency();
  int nt = n_threads > 0 ? n_threads : static_cast<int>(hw ? hw : 2);
  if (target_edges < 100000) nt = 1;
  std::vector<std::thread> threads;
  for (int i = 1; i < nt; ++i)
    threads.emplace_back(gen_worker, &job,
                         seed * 0x9E3779B97F4A7C15ULL + 0x632BE59BD9B4E019ULL * i,
                         static_cast<uint64_t>(i), static_cast<uint64_t>(nt));
  gen_worker(&job, seed * 0x9E3779B97F4A7C15ULL, 0, static_cast<uint64_t>(nt));
  for (auto& t : threads) t.join();

  int64_t written = job.accepted.load();
  delete job.bloom;
  if (fclose(out) != 0) return -1;
  return written;
}

}  // extern "C"
