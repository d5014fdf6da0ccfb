// TopSim's frontier expansion on Hopper (sm_90a): one budget-splitting
// depth of every source's slot frontier in one launch (TS1).
//
// Replaces no TPU kernel.  graphtpu leaves the expansion to XLA
// (graphtpu/simrank/topsim.py), so nothing in the JAX package stands
// behind this file.  It takes the place of the ~60 PyTorch ops of
// simrank/topsim.py:_expand_frontier_plain, each of which read and wrote
// every slot of the group (int64 counts, a prefix sum, a searchsorted a
// slot, gathers of every parent field and of whole paths, a `where` over
// them), 4.49 ms a depth of a group at the TopSim cell's shape.
//
// What it computes, for each row r of the frontier (a source; `paths`
// [T, W, L] int32, `mass` [T, W] float32; depth d, d + 1 < L):
//   * each parent slot p with mass m > 0, node cur = paths[r, p, d] >= 0
//     and deg[cur] > 0 is active; it splits over its deg[cur] neighbours
//     if m >= deg[cur] (every active parent with `enumerate_all`), else it
//     draws ceil(m) children;
//   * the children take slots by an exclusive prefix sum of the counts in
//     slot order; the child at slot s (< W and < the row's total) has the
//     parent whose range holds s, the parent's path with node d + 1 set,
//     and mass m / nchild (IEEE division);
//   * a split child's node is col[row_ptr[cur] + rank]; a sampled child's
//     is col[beg + min((int)(u * len), len - 1)] with beg, len from
//     row_ptr[cur], row_ptr[cur + 1] and u = u[r, s] (float32): -1 where
//     the row is empty.  The split rule reads `deg`, the draw `row_ptr`;
//   * every other slot reads -1 in all L nodes and mass 0.0;
//   * dropped[r] = sum over p of m * lost / max(nchild, 1), lost the
//     children past W.
// The slots, nodes and masses equal the plain version's bit for bit; only
// `dropped` sums in another order.
//
// What bounds it on this card: bytes.  One pass writes the child paths
// (T·W·L·4) and masses (T·W·4) and reads the parents' masses, the draws
// and the parents' nodes (T·W·4 each): at the TopSim cell's T = 512, W =
// 20,008, L = 7 that is 0.451 GB, 0.135 ms at 3.35 TB/s.  The parent
// nodes are strided within the paths (a 32-byte sector a live parent), so
// what the card must move lies between that and ~0.7 GB.
//
// The design: one block a row, 256 threads, at least four blocks an SM (48
// registers a thread, 20 KB of shared memory a block, whatever W), so that
// the cell's 512 rows run in one wave; the row streams through its parents
// once, in chunks of 1,024, and writes each chunk's children while the
// chunk's parents are still in L1.
//   A. A chunk's parents, four consecutive a thread with their loads issued
//      together (mass; the node only where the mass is > 0; its degree),
//      give their child counts.  A chunk whose masses are all 0 (the empty
//      tail of the frontier) costs one coalesced read and one barrier.
//      A block-wide exclusive scan in 64 bits (shuffles, then one warp over
//      the 8 warp totals), carried from chunk to chunk, gives each parent's
//      first slot.  First slot (clamped to W as int32: a slot s < W compares
//      with it as with the unclamped value), node, mass, count and rule go
//      to shared memory.  The dropped mass is summed per thread, then
//      across the block.
//   B. The slots from the last one written up to min(the first slot after
//      the chunk, W) all have their parent in the chunk.  In rounds of 512,
//      two a thread, each finds its parent by a binary search of the
//      chunk's first slots (the last parent whose first slot is <= s),
//      picks or draws its node (the CSR reads hit L2) and writes its mass
//      (coalesced); parent and node go to shared memory, and then the
//      round's child paths are written element by element, a warp storing
//      128 contiguous bytes, each element read from the parent's row
//      (which A's node read brought into L1).
//   C. The slots past the last child: -1 and 0.0 in 16-byte stores.
// Offsets and row bases are 64-bit.  No atomics: the same inputs give the
// same bits on every run.
//
// The entry point launches on the given stream, allocates nothing, does
// not synchronise, and returns cudaGetLastError() or the launch's own error.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kParents = 4;                       // parents a thread in a chunk
constexpr int kChunk = kThreads * kParents;       // parents a chunk
constexpr int kSlots = 2;                         // slots a thread in a round
constexpr int kRound = kThreads * kSlots;         // slots a round

// A parent's child count (0 unless active) and whether it splits.
__device__ __forceinline__ int child_count(float m, int cur, int d, bool enumerate_all,
                                           bool& split) {
  split = false;
  if (!(m > 0.f) || cur < 0 || d <= 0) return 0;
  split = enumerate_all || m >= (float)d;
  return split ? d : (int)ceilf(m);
}

// Exclusive block-wide prefix sum of x; `total` gets the block's sum.
__device__ __forceinline__ long long block_exclusive_scan(long long x, long long* s_warp,
                                                          long long& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    long long v = lane < kWarps ? s_warp[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += y;
    }
    if (lane < kWarps) s_warp[lane] = v;
  }
  __syncthreads();
  const long long before = warp ? s_warp[warp - 1] : 0;
  total = s_warp[kWarps - 1];
  __syncthreads();  // s_warp is free for the next call
  return before + incl - x;
}

// Fill n ints from p with v, 16-byte stores where aligned.
__device__ __forceinline__ void fill(int* p, int64_t n, int v) {
  const int64_t lead = (int64_t)(((16 - (reinterpret_cast<uintptr_t>(p) & 15)) & 15) / 4);
  const int64_t head = lead < n ? lead : n;
  for (int64_t i = threadIdx.x; i < head; i += kThreads) p[i] = v;
  int4* q = reinterpret_cast<int4*>(p + head);
  const int64_t nq = (n - head) / 4;
  const int4 vv = make_int4(v, v, v, v);
  for (int64_t i = threadIdx.x; i < nq; i += kThreads) q[i] = vv;
  for (int64_t i = head + 4 * nq + threadIdx.x; i < n; i += kThreads) p[i] = v;
}

template <typename RP>
__global__ void __launch_bounds__(kThreads, 4)
expand_rows(const int* __restrict__ paths, const float* __restrict__ mass,
            const float* __restrict__ u, const RP* __restrict__ row_ptr,
            const int* __restrict__ col, int64_t n_edges, const int* __restrict__ deg,
            int* __restrict__ out_paths, float* __restrict__ out_mass,
            float* __restrict__ dropped, int w, int len, int depth, bool enumerate_all) {
  __shared__ long long s_warp[kWarps];
  __shared__ float s_drop[kWarps];
  __shared__ int s_first[kChunk];   // a chunk's parents: first slot, clamped to W
  __shared__ int s_cur[kChunk];     //   node at the depth
  __shared__ float s_mass[kChunk];  //   mass
  __shared__ int s_nc[kChunk];      //   child count, negated where the parent splits
  __shared__ int s_parent[kRound];  // a round's slots: parent in the chunk, -1 past the end
  __shared__ int s_node[kRound];    //   child node

  const int tid = threadIdx.x;
  const int64_t row = blockIdx.x;
  const int* prow = paths + row * w * len;
  const float* mrow = mass + row * w;
  int* orow = out_paths + row * w * len;
  float* omrow = out_mass + row * w;
  const int64_t last_edge = n_edges > 0 ? n_edges - 1 : 0;

  long long carry = 0;  // the first slot of the chunk's first parent
  int written = 0;      // slots written: all below min(carry, W)
  float drop = 0.f;
  for (int base = 0; base < w; base += kChunk) {
    // A. the chunk's counts, first slots and dropped mass
    const int l0 = tid * kParents;
    const int p0 = base + l0;
    float m[kParents];
    int cur[kParents], d[kParents], nc[kParents];
    bool split[kParents];
    int any = 0;
#pragma unroll
    for (int i = 0; i < kParents; ++i) {
      m[i] = p0 + i < w ? __ldg(mrow + p0 + i) : 0.f;
      any |= m[i] != 0.f;
    }
    if (!__syncthreads_or(any)) continue;  // no child, nothing dropped, no slot written
#pragma unroll
    for (int i = 0; i < kParents; ++i)
      cur[i] = m[i] > 0.f ? __ldg(prow + (int64_t)(p0 + i) * len + depth) : -1;
#pragma unroll
    for (int i = 0; i < kParents; ++i) d[i] = cur[i] >= 0 ? __ldg(deg + cur[i]) : 0;
    long long sum = 0;
#pragma unroll
    for (int i = 0; i < kParents; ++i) {
      nc[i] = child_count(m[i], cur[i], d[i], enumerate_all, split[i]);
      sum += nc[i];
    }
    long long chunk;
    long long first = carry + block_exclusive_scan(sum, s_warp, chunk);
#pragma unroll
    for (int i = 0; i < kParents; ++i) {
      s_first[l0 + i] = (int)min(first, (long long)w);
      s_cur[l0 + i] = cur[i];
      s_mass[l0 + i] = m[i];
      s_nc[l0 + i] = split[i] ? -nc[i] : nc[i];
      if (p0 + i < w) {
        const long long lost = min(max(first + nc[i] - (long long)w, 0LL), (long long)nc[i]);
        drop += m[i] * (float)lost / (float)max(nc[i], 1);
      }
      first += nc[i];
    }
    carry += chunk;
    __syncthreads();

    // B. the slots whose parents are in the chunk, a round at a time
    const int end = (int)min(carry, (long long)w);
    for (; written < end; written += kRound) {
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        const int sl = k * kThreads + tid;
        const int s = written + sl;
        int par = -1, node = -1;
        if (s < end) {
          int lo = 0, hi = kChunk - 1;
          while (lo < hi) {
            const int mid = (lo + hi + 1) >> 1;
            if (s_first[mid] <= s) lo = mid;
            else hi = mid - 1;
          }
          par = lo;
          const int pc = s_cur[par];
          const int pn = s_nc[par];
          const int64_t beg = (int64_t)__ldg(row_ptr + pc);
          if (pn < 0) {
            int64_t e = beg + (s - s_first[par]);
            e = e < 0 ? 0 : (e > last_edge ? last_edge : e);
            node = __ldg(col + e);
          } else {
            const int64_t n = (int64_t)__ldg(row_ptr + pc + 1) - beg;
            if (n > 0) {
              const int64_t at = (int)(__ldg(u + row * w + s) * (float)n);
              node = __ldg(col + beg + (at < n - 1 ? at : n - 1));
            }
          }
          omrow[s] = s_mass[par] / (float)(pn < 0 ? -pn : pn);
        }
        s_parent[sl] = par;
        s_node[sl] = node;
      }
      __syncthreads();
      const int n_el = min(kRound, end - written) * len;
      int* dst = orow + (int64_t)written * len;
      const int* src = prow + (int64_t)base * len;
      for (int e0 = 0; e0 < n_el; e0 += kThreads * 4) {
        int v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int e = e0 + k * kThreads + tid;
          v[k] = 0;
          if (e < n_el) {
            const int sl = e / len;
            const int j = e - sl * len;
            v[k] = j == depth + 1 ? s_node[sl] : __ldg(src + s_parent[sl] * len + j);
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int e = e0 + k * kThreads + tid;
          if (e < n_el) dst[e] = v[k];
        }
      }
      __syncthreads();  // s_parent, s_node free for the next round
    }
    written = end;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) drop += __shfl_down_sync(0xffffffffu, drop, o);
  if ((tid & 31) == 0) s_drop[tid >> 5] = drop;
  __syncthreads();
  if (tid == 0) {
    float t = 0.f;
    for (int i = 0; i < kWarps; ++i) t += s_drop[i];
    dropped[row] = t;
  }

  // C. the empty slots past the last child
  if (written < w) {
    fill(orow + (int64_t)written * len, (int64_t)(w - written) * len, -1);
    fill(reinterpret_cast<int*>(omrow + written), w - written, 0);  // +0.0f
  }
}

template <typename RP>
int launch(const int* paths, const float* mass, const float* u, const RP* row_ptr,
           const int* col, int64_t n_edges, const int* deg, int* out_paths, float* out_mass,
           float* dropped, int64_t rows, int64_t w, int64_t len, int depth, bool enumerate_all,
           cudaStream_t stream) {
  expand_rows<RP><<<(unsigned)rows, kThreads, 0, stream>>>(
      paths, mass, u, row_ptr, col, n_edges, deg, out_paths, out_mass, dropped, (int)w,
      (int)len, depth, enumerate_all);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One expansion of `rows` frontiers of `w` slots of paths of `len` nodes at
// `depth` (see above).  `row_ptr` has `row_ptr_bytes` (4 or 8) an entry;
// `u` may be null with `enumerate_all`.
int gt_expand_frontier(const void* paths, const void* mass, const void* u, const void* row_ptr,
                       int row_ptr_bytes, const void* col, int64_t n_edges, const void* deg,
                       void* out_paths, void* out_mass, void* dropped, int64_t rows, int64_t w,
                       int64_t len, int depth, int enumerate_all, void* stream) {
  if (rows < 0 || w < 1 || len < 2 || depth < 0 || depth + 1 >= len ||
      w * len > 0x7fffffffLL || rows > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (u == nullptr && !enumerate_all) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(paths);
  const float* m = static_cast<const float*>(mass);
  const float* uu = static_cast<const float*>(u);
  const int* c = static_cast<const int*>(col);
  const int* d = static_cast<const int*>(deg);
  int* op = static_cast<int*>(out_paths);
  float* om = static_cast<float*>(out_mass);
  float* dr = static_cast<float*>(dropped);
  if (row_ptr_bytes == 4)
    return launch(p, m, uu, static_cast<const int32_t*>(row_ptr), c, n_edges, d, op, om, dr,
                  rows, w, len, depth, enumerate_all != 0, s);
  if (row_ptr_bytes == 8)
    return launch(p, m, uu, static_cast<const int64_t*>(row_ptr), c, n_edges, d, op, om, dr,
                  rows, w, len, depth, enumerate_all != 0, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
