// Row top-k selection on Hopper (sm_90a): the k largest entries of each
// row of a row-major [B, N] tensor, in the order of a stable descending sort.
//
// Replaces no TPU kernel.  graphtpu leaves top-k to `lax.top_k`
// (graphtpu/kernels/topk.py), so nothing in the JAX package stands behind
// this file.  It takes the place of the full stable sort of every row that
// kernels/topk.py:_stable_topk ran on a CUDA tensor (a segmented radix sort
// of all N entries with int64 indices, to keep k of them): at the gold
// cells' [32,768, 32,768] f32 scores that sort took ~80 ms a solve and held
// each 4,096-row chunk's sort output alive, 12.9 GB in all.
//
// What it computes, for each row r: the k entries that a stable descending
// sort puts first, with their column indices, in that order.  The order is
// that of the radix sort's order-preserving key: a float's bits with the
// sign bit flipped where it is clear and every bit flipped where it is set,
// -0.0 taken as +0.0 (so +NaN sorts above +inf, -NaN below -inf); equal
// keys come in ascending column order.  With `diag` >= 0, column diag + r
// of row r reads as -inf.  Values are the row's bits (-inf at the masked
// column), indices int64.  The answer is the set of the k greatest
// composites (key, -column), a total order, written in that order.
//
// What bounds it on this card: bytes.  The least work is one read of the
// row: at [32,768, 32,768] f32 4.295 GB, 1.28 ms at 3.35 TB/s.  The outputs
// (B·k entries) are small.  So a row's elements should cost the SM little
// besides their one read, and the SM should keep reading while it works.
//
// The design: one block a row, 512 threads (1,024 where k > 512), 32 KB +
// 8·k bytes of shared memory, so that two blocks share an SM and one row's
// reads overlap another's work.
//   1. Pass 0 reads the row once from device memory, 16-byte loads, eight
//      in flight a thread, and keeps each thread's largest key: no store,
//      no atomic, a few instructions an element (the raw key, which
//      differs from the key only at -0.0, is lifted once a thread).
//   2. A bound L: the k-th largest of G >= k group maxima (G = 32, or the
//      least power of two >= k; a group is nt / G neighbouring threads),
//      sorted by a bitonic network (shuffles in one warp where G = 32).
//      At least k elements are >= L, so T, the k-th largest, is >= L.
//   3. Only threads whose largest key is >= L read their elements again
//      (from L2) and append the keys >= L to a list of 2,048 entries, the
//      lanes of a warp with one atomic add; a thread that meets a full
//      list stops.  On a row of distinct values a few dozen threads read
//      again and list a few dozen keys.  A list of at most 128 is ranked
//      as it is; a longer one goes through the radix select below.
//   4. A list that overflowed: ties at L.  One scan of the row in tiles of
//      nt·V columns puts every key > L in the list and the first k keys
//      equal to L by column in the k slots, each tile's equal keys placed
//      by a block-wide prefix count, until k are found (an all-zero row:
//      one tile).  If fewer than k keys are > L, T's key is L, and the
//      answer is those keys and the first slots.
//   5. Else (k or more keys above L, and too many at or above it), the
//      radix select over the row: T's composite resolved in 12-bit
//      digits, most significant first, each pass a 4,096-bin histogram of
//      the digit over the elements whose prefix equals T's so far (integer
//      atomics; a run of equal digits in a thread added once), the bin
//      where the count from the top reaches `need`, need -= the count
//      above it; once the elements >= T's prefix fit the list they move
//      there and the passes go on over the list.  A pass whose bin holds
//      exactly `need` elements ends it; the k list entries >= T's prefix
//      go to the slots.
//   6. The k answers are ranked among themselves (k compares an answer)
//      and written; a value is its key's bits, read back from the row
//      only for a zero key (-0.0 and +0.0 share it).
// Integer atomics only, and every order that depends on timing (the list's
// and the slots') is undone by the final ranking over a total order, so
// the answer is the same on every run.  No allocation: the outputs are the
// caller's.  On an H100 the kernel reads the gold cells' scores at ~77-79%
// of the card's peak rate (PERF.md).
//
// The entry point launches on the given stream, does not synchronise, and
// returns cudaGetLastError() or the launch's own error.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kThreads = 512;      // a block's threads where k <= 512
constexpr int kDigit = 12;
constexpr int kBins = 1 << kDigit;
constexpr int kMaxK = 1024;
constexpr int kUnroll = 8;         // 16-byte loads in flight a thread
constexpr int kListCap = 2048;
constexpr int kRankDirect = 128;   // a list this short is ranked as it is

// key(b): the order-preserving key of a float's bits b.  raw(b) is the
// same but for -0.0, which it puts just below +0.0; lift(raw(b)) of the
// largest raw key is the largest key, so a maximum may take raw keys.
// bits(key(b)) is b, but for -0.0 (+0.0's key).
template <int E>
struct Fmt;

template <>
struct Fmt<4> {
  static constexpr int kKeyBits = 32;
  static constexpr uint32_t kNegInf = 0xff800000u;
  static __device__ __forceinline__ uint32_t raw(uint32_t b) {
    return b ^ ((uint32_t)((int32_t)b >> 31) | 0x80000000u);
  }
  static __device__ __forceinline__ uint32_t key(uint32_t b) {
    return raw(b == 0x80000000u ? 0u : b);
  }
  static __device__ __forceinline__ uint32_t lift(uint32_t k) {
    return k == 0x7fffffffu ? 0x80000000u : k;
  }
  static __device__ __forceinline__ uint32_t bits(uint32_t k) {
    return k ^ ((k & 0x80000000u) ? 0x80000000u : 0xffffffffu);
  }
};

template <>
struct Fmt<2> {
  static constexpr int kKeyBits = 16;
  static constexpr uint32_t kNegInf = 0xff80u;
  static __device__ __forceinline__ uint32_t raw(uint32_t b) {
    return b ^ ((b & 0x8000u) ? 0xffffu : 0x8000u);
  }
  static __device__ __forceinline__ uint32_t key(uint32_t b) {
    return raw(b == 0x8000u ? 0u : b);
  }
  static __device__ __forceinline__ uint32_t lift(uint32_t k) {
    return k == 0x7fffu ? 0x8000u : k;
  }
  static __device__ __forceinline__ uint32_t bits(uint32_t k) {
    return k ^ ((k & 0x8000u) ? 0x8000u : 0xffffu);
  }
};

template <int E>
__device__ __forceinline__ uint32_t load_elem(const unsigned char* p) {
  if constexpr (E == 4) return __ldg(reinterpret_cast<const unsigned*>(p));
  else return __ldg(reinterpret_cast<const unsigned short*>(p));
}

template <int E>
__device__ __forceinline__ uint32_t lane_of(const uint4& q, int e) {
  if constexpr (E == 4) return e == 0 ? q.x : e == 1 ? q.y : e == 2 ? q.z : q.w;
  else {
    const uint32_t w = (e >> 1) == 0 ? q.x : (e >> 1) == 1 ? q.y : (e >> 1) == 2 ? q.z : q.w;
    return (w >> (16 * (e & 1))) & 0xffffu;
  }
}

// The row's key at column i: its bits' key, -inf's at the masked column
// (kRaw: the raw key).
template <int E, bool kDiag, bool kRaw = false>
__device__ __forceinline__ uint32_t key_of(uint32_t bits, int i, int diag) {
  if (kDiag && i == diag) bits = Fmt<E>::kNegInf;
  return kRaw ? Fmt<E>::raw(bits) : Fmt<E>::key(bits);
}

template <int E, bool kDiag>
__device__ __forceinline__ uint32_t key_at(const unsigned char* row, int i, int diag) {
  return key_of<E, kDiag>(load_elem<E>(row + (int64_t)i * E), i, diag);
}

// f(key, column) for each element of the row that thread t holds: 16-byte
// chunks c = t, t + nt, ... where `vec` (kUnroll loads issued before the
// first is used), then the columns past the last whole chunk (all of
// them, one by one, where not `vec`), i = t, t + nt, ...
template <int E, bool kDiag, bool kRaw, typename F>
__device__ __forceinline__ void for_row(const unsigned char* row, int n, bool vec, int diag,
                                        F& f) {
  constexpr int V = 16 / E;
  const int t = threadIdx.x;
  const int nt = blockDim.x;
  int done = 0;
  if (vec) {
    const int chunks = n / V;
    auto chunk = [&](const uint4& q, int c) {
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int i = c * V + e;
        f(key_of<E, kDiag, kRaw>(lane_of<E>(q, e), i, diag), i);
      }
    };
    int c = t;
    for (; c + (kUnroll - 1) * nt < chunks; c += kUnroll * nt) {
      uint4 q[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        q[u] = __ldg(reinterpret_cast<const uint4*>(row + (int64_t)(c + u * nt) * 16));
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) chunk(q[u], c + u * nt);
    }
    for (; c < chunks; c += nt)
      chunk(__ldg(reinterpret_cast<const uint4*>(row + (int64_t)c * 16)), c);
    done = chunks * V;
  }
  for (int i = done + t; i < n; i += nt)
    f(key_of<E, kDiag, kRaw>(load_elem<E>(row + (int64_t)i * E), i, diag), i);
}

// x summed over the threads before this one, and over all (ws: 32 words).
__device__ __forceinline__ uint32_t block_scan(uint32_t x, uint32_t& total, uint32_t* ws) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  uint32_t incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) ws[warp] = incl;
  __syncthreads();
  uint32_t before = 0;
  total = 0;
  for (int w = 0; w < nwarps; ++w) {
    if (w < warp) before += ws[w];
    total += ws[w];
  }
  __syncthreads();
  return before + incl - x;
}

// The k-th largest (k >= 1) of g[0..G), G a power of two: a bitonic
// network, in one warp's registers where G = 32, else in place in g.
__device__ __forceinline__ uint32_t kth_largest(uint32_t* g, int G, int k, uint32_t* res) {
  const int t = threadIdx.x;
  if (G == 32) {
    if (t < 32) {
      uint32_t v = g[t];
#pragma unroll
      for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
          const uint32_t w = __shfl_xor_sync(0xffffffffu, v, stride);
          const bool desc = (t & size) == 0, lower = (t & stride) == 0;
          v = desc == lower ? max(v, w) : min(v, w);
        }
      }
      if (t == k - 1) res[0] = v;
    }
  } else {
    for (int size = 2; size <= G; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int i = t; i < G / 2; i += blockDim.x) {
          const int lo = 2 * stride * (i / stride) + (i % stride), hi = lo + stride;
          const uint32_t a = g[lo], b = g[hi];
          if ((lo & size) == 0 ? a < b : a > b) {
            g[lo] = b;
            g[hi] = a;
          }
        }
        __syncthreads();
      }
    }
    if (t == 0) res[0] = g[k - 1];
  }
  __syncthreads();
  return res[0];
}

// What is known of T, the k-th largest composite (key, rmask - column):
// its key bits under kmask are kval, its column bits under imask are ival.
struct Prefix {
  uint32_t kmask, kval, imask, ival, rmask;
  int dsh;  // this pass's digit: bits dsh .. dsh + width - 1 of the key or column
  uint32_t dmask;

  __device__ __forceinline__ bool at_least(uint32_t key, uint32_t col) const {
    const uint32_t kk = key & kmask;
    return kk > kval || (kk == kval && ((rmask - col) & imask) >= ival);
  }
};

// Per-thread counting into the shared histogram: a run of equal digits
// is added once.
struct Counter {
  uint32_t* hist;
  uint32_t d = 0, c = 0;
  __device__ __forceinline__ void add(uint32_t digit) {
    if (c != 0 && digit != d) {
      atomicAdd(hist + d, c);
      c = 0;
    }
    d = digit;
    ++c;
  }
  __device__ __forceinline__ void flush() {
    if (c != 0) atomicAdd(hist + d, c);
  }
};

// The bin where the count of hist from the top bin down reaches `need`,
// the count above it and its own count, into res[0..2]; every bin is left
// zero.  Thread t holds kBins / nt consecutive bins from the top.
__device__ __forceinline__ void find_bin(uint32_t* hist, uint32_t need, uint32_t* ws,
                                         uint32_t* res) {
  const int per = kBins / blockDim.x;
  const int top = kBins - 1 - threadIdx.x * per;
  uint32_t own = 0;
  for (int j = 0; j < per; ++j) own += hist[top - j];
  uint32_t total;
  uint32_t above = block_scan(own, total, ws);
  for (int j = 0; j < per; ++j) {
    const uint32_t c = hist[top - j];
    if (above < need && need <= above + c) {
      res[0] = top - j;
      res[1] = above;
      res[2] = c;
    }
    above += c;
    hist[top - j] = 0;
  }
}

template <int E, bool kDiag>
__global__ void __launch_bounds__(kMaxThreads)
topk_rows_kernel(const unsigned char* __restrict__ in, unsigned char* __restrict__ out_vals,
                 int64_t* __restrict__ out_idx, int n, int k, int64_t diag0, int idx_bits,
                 int groups) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ uint32_t ws[32];
  __shared__ uint32_t res[3];
  __shared__ uint32_t n_list, n_sel;
  uint32_t* hist = smem;                     // kBins
  uint32_t* list_key = hist + kBins;         // kListCap
  uint32_t* list_col = list_key + kListCap;  // kListCap
  uint32_t* slot_key = list_col + kListCap;  // k
  uint32_t* slot_col = slot_key + k;         // k
  const int64_t r = blockIdx.x;
  const unsigned char* row = in + r * (int64_t)n * E;
  const int64_t dcol = diag0 < 0 ? -1 : diag0 + r;
  const int diag = (dcol >= 0 && dcol < n) ? (int)dcol : -1;
  const bool vec = reinterpret_cast<uintptr_t>(row) % 16 == 0;
  const int t = threadIdx.x, nt = blockDim.x;
  if (t == 0) n_list = n_sel = 0;

  // 1. pass 0: each thread's largest key
  uint32_t tmax = 0;
  auto take_max = [&](uint32_t key, uint32_t) { tmax = max(tmax, key); };
  for_row<E, kDiag, true>(row, n, vec, diag, take_max);
  tmax = Fmt<E>::lift(tmax);

  // 2. L: the k-th largest of the group maxima (groups of gs threads)
  const int gs = nt / groups;
  uint32_t gmax = tmax;
  for (int o = gs >> 1; o > 0; o >>= 1) gmax = max(gmax, __shfl_xor_sync(0xffffffffu, gmax, o));
  if (t % gs == 0) list_key[t / gs] = gmax;  // the list is free until step 3
  __syncthreads();
  const uint32_t L = kth_largest(list_key, groups, k, res);

  // 3. the keys >= L into the list, a warp's at once, while it has room:
  // n_list ends as their count (or past kListCap: too many to list)
  if (tmax >= L) {
    const int lane = t & 31;
    bool full = false;  // this thread has met a full list: n_list is past kListCap
    auto gather = [&](uint32_t key, uint32_t col) {
      if (key < L || full) return;
      const unsigned m = __activemask();  // the lanes here, each with a key >= L
      const int leader = __ffs(m) - 1;
      uint32_t base = 0;
      if (lane == leader) base = atomicAdd(&n_list, (uint32_t)__popc(m));
      base = __shfl_sync(m, base, leader) + __popc(m & ((1u << lane) - 1u));
      if (base < (uint32_t)kListCap) {
        list_key[base] = key;
        list_col[base] = col;
      } else {
        full = true;
      }
    };
    for_row<E, kDiag, false>(row, n, vec, diag, gather);
  }
  __syncthreads();
  const uint32_t ge = n_list;
  uint32_t listed = 0;
  bool ranked = false;  // the answer is in ans_key/ans_col, ready to rank
  const uint32_t* ans_key = slot_key;
  const uint32_t* ans_col = slot_col;
  uint32_t n_ans = (uint32_t)k;
  if (ge <= (uint32_t)kListCap) {
    listed = ge;
    if (ge <= (uint32_t)kRankDirect) {
      ans_key = list_key;
      ans_col = list_col;
      n_ans = ge;
      ranked = true;
    }
  } else {
    // 4. ties at L: every key > L into the list (gt of them), the first k
    // keys equal to L by column into the slots, tile by tile; if gt < k,
    // T's key is L and the answer is the gt and the first k - gt slots
    constexpr int V = 16 / E;
    const bool any_gt = __syncthreads_or(tmax > L);
    if (t == 0) n_list = 0;
    __syncthreads();
    uint32_t found = 0;
    for (int base = 0; base < n; base += nt * V) {
      if (found >= (uint32_t)k && !any_gt) break;  // uniform: nothing left to find
      const int i0 = base + t * V;
      uint4 q = make_uint4(0u, 0u, 0u, 0u);
      const bool whole = vec && i0 + V <= n;
      if (whole) q = __ldg(reinterpret_cast<const uint4*>(row + (int64_t)i0 * E));
      auto key_here = [&](int e) {
        return whole ? key_of<E, kDiag>(lane_of<E>(q, e), i0 + e, diag)
                     : key_at<E, kDiag>(row, i0 + e, diag);
      };
      uint32_t eq = 0;
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int i = i0 + e;
        if (i < n) {
          const uint32_t key = key_here(e);
          if (key > L) {
            const uint32_t s = atomicAdd(&n_list, 1u);
            if (s < (uint32_t)kListCap) {
              list_key[s] = key;
              list_col[s] = (uint32_t)i;
            }
          }
          eq += key == L;
        }
      }
      if (found < (uint32_t)k) {  // uniform
        uint32_t total;
        uint32_t at = found + block_scan(eq, total, ws);
        for (int e = 0; e < V && eq != 0; ++e) {
          const int i = i0 + e;
          if (i < n && key_here(e) == L) {
            if (at < (uint32_t)k) {
              slot_key[at] = L;
              slot_col[at] = (uint32_t)i;
            }
            ++at;
            --eq;
          }
        }
        found += total;
      }
    }
    __syncthreads();
    const uint32_t gt = n_list;
    if (gt < (uint32_t)k) {
      for (uint32_t j = t; j < (uint32_t)k - gt; j += nt) {
        list_key[gt + j] = slot_key[j];
        list_col[gt + j] = slot_col[j];
      }
      __syncthreads();
      ans_key = list_key;
      ans_col = list_col;
      ranked = true;
    }
  }

  if (!ranked) {
    // 5. the radix select, over the list (listed > 0) or the row
    for (int i = t; i < kBins; i += nt) hist[i] = 0;
    __syncthreads();
    Prefix p;
    p.kmask = p.kval = p.imask = p.ival = 0;
    p.rmask = idx_bits >= 32 ? 0xffffffffu : (1u << idx_bits) - 1u;
    bool on_key = true;
    int hi = Fmt<E>::kKeyBits;  // the current field's bits below `hi` are unresolved
    uint32_t need = (uint32_t)k;
    bool in_list = listed > 0;
    for (;;) {
      p.dsh = hi > kDigit ? hi - kDigit : 0;
      p.dmask = (1u << (hi - p.dsh)) - 1u;
      Counter cnt{hist};
      // the key's digit among keys with T's prefix; the column's among T's key
      auto count_key = [&](uint32_t key, uint32_t) {
        if ((key & p.kmask) == p.kval) cnt.add((key >> p.dsh) & p.dmask);
      };
      auto count_col = [&](uint32_t key, uint32_t col) {
        const uint32_t rc = p.rmask - col;
        if (key == p.kval && (rc & p.imask) == p.ival) cnt.add((rc >> p.dsh) & p.dmask);
      };
      if (in_list) {
        for (uint32_t j = t; j < listed; j += nt) {
          if (on_key) count_key(list_key[j], list_col[j]);
          else count_col(list_key[j], list_col[j]);
        }
      } else if (on_key) {
        for_row<E, kDiag, false>(row, n, vec, diag, count_key);
      } else {
        for_row<E, kDiag, false>(row, n, vec, diag, count_col);
      }
      cnt.flush();
      __syncthreads();
      find_bin(hist, need, ws, res);
      __syncthreads();
      const uint32_t b = res[0], above = res[1], here = res[2];
      need -= above;
      if (on_key) {
        p.kmask |= p.dmask << p.dsh;
        p.kval |= b << p.dsh;
      } else {
        p.imask |= p.dmask << p.dsh;
        p.ival |= b << p.dsh;
      }
      const bool done = here == need;
      // the elements >= T's prefix, k - need + here of them, into the list
      if (!in_list && (done || (uint32_t)k - need + here <= (uint32_t)kListCap)) {
        auto move = [&](uint32_t key, uint32_t col) {
          if (p.at_least(key, col)) {
            const uint32_t s = atomicAdd(&n_list, 1u);
            list_key[s] = key;
            list_col[s] = col;
          }
        };
        if (t == 0) n_list = 0;
        __syncthreads();
        for_row<E, kDiag, false>(row, n, vec, diag, move);
        __syncthreads();
        in_list = true;
        listed = n_list;
      }
      if (done) break;
      hi = p.dsh;
      if (hi == 0) {
        if (!on_key) break;  // every bit resolved: here is 1 == need, so not reached
        on_key = false;
        hi = idx_bits;
      }
    }
    // the k list entries >= T's prefix into the slots
    for (uint32_t j = t; j < listed; j += nt) {
      const uint32_t key = list_key[j], col = list_col[j];
      if (p.at_least(key, col)) {
        const uint32_t s = atomicAdd(&n_sel, 1u);
        if (s < (uint32_t)k) {
          slot_key[s] = key;
          slot_col[s] = col;
        }
      }
    }
    __syncthreads();
  }

  // 6. each answer at its rank among them (those of rank < k)
  for (uint32_t s = t; s < n_ans; s += nt) {
    const uint32_t key = ans_key[s], col = ans_col[s];
    uint32_t rank = 0;
    for (uint32_t j = 0; j < n_ans; ++j) {
      const uint32_t kj = ans_key[j];
      rank += (kj > key) || (kj == key && ans_col[j] < col);
    }
    if (rank < (uint32_t)k) {
      const int64_t at = r * k + rank;
      out_idx[at] = col;
      const uint32_t bits = key == Fmt<E>::key(0u) ? load_elem<E>(row + (int64_t)col * E)
                                                    : Fmt<E>::bits(key);
      if (E == 4) *reinterpret_cast<uint32_t*>(out_vals + at * 4) = bits;
      else *reinterpret_cast<unsigned short*>(out_vals + at * 2) = (unsigned short)bits;
    }
  }
}

template <int E, bool kDiag>
int launch(const void* in, void* vals, int64_t* idx, int64_t rows, int n, int k, int64_t diag,
           cudaStream_t stream) {
  constexpr int V = 16 / E;
  auto kernel = topk_rows_kernel<E, kDiag>;
  // groups: 32, or the least power of two >= k; a block has at least as
  // many threads, 64 at least, and about kUnroll chunks a thread up to kThreads
  int groups = 32;
  while (groups < k) groups *= 2;
  const int64_t want = ((int64_t)n + V * kUnroll - 1) / (V * kUnroll);
  int threads = 64;
  while (threads < kThreads && threads < want) threads *= 2;
  if (threads < groups) threads = groups;
  const int64_t smem = ((int64_t)kBins + 2 * kListCap + 2 * k) * 4;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int bits = 1;  // column digits: the bit length of n - 1
  while (bits < 31 && ((int64_t)(n - 1) >> bits) != 0) ++bits;
  kernel<<<(unsigned)rows, threads, (size_t)smem, stream>>>(
      static_cast<const unsigned char*>(in), static_cast<unsigned char*>(vals), idx, n, k, diag,
      bits, groups);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// vals [rows, k] (elements of `elem_bytes`, 4 = f32 or 2 = bf16) and idx
// [rows, k] int64 = the first k of each row of in [rows, n] under a stable
// descending sort; diag >= 0 masks column diag + r of row r as -inf.
int gt_topk_rows(const void* in, void* vals, void* idx, int64_t rows, int64_t n, int k,
                 int elem_bytes, int64_t diag, void* stream) {
  if (rows < 0 || n < 1 || n > 0x7fffffffLL || rows > 0x7fffffffLL || k < 1 || k > kMaxK ||
      k > n)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t* out_idx = static_cast<int64_t*>(idx);
  if (elem_bytes == 4) {
    return diag >= 0 ? launch<4, true>(in, vals, out_idx, rows, (int)n, k, diag, s)
                     : launch<4, false>(in, vals, out_idx, rows, (int)n, k, diag, s);
  }
  if (elem_bytes == 2) {
    return diag >= 0 ? launch<2, true>(in, vals, out_idx, rows, (int)n, k, diag, s)
                     : launch<2, false>(in, vals, out_idx, rows, (int)n, k, diag, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
