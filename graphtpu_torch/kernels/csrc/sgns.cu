// SGNS's step on Hopper (sm_90a): one step's summed gradients of both
// tables, formed from per-pair scalar coefficients (SG1).
//
// Replaces no TPU kernel.  graphtpu forms SGNS's gradients with XLA ops
// (graphtpu/models/sgns.py:sgns_manual_grads) and has no Pallas kernel for
// them.  It takes the place of models/sgns.py:sgns_closed_form and the two
// segment_rows_sum calls of sgns_manual_grads on a CUDA device with shared
// negatives, which gathered u = syn1[contexts] ([B, 2w, D]), wrote the
// gradient rows du = g·v and dun, concatenated them, gathered them again in
// sorted order and summed them: ~0.8 ms a step at B = 8,192, 2w = 20, N =
// 5, D = 128, every byte of it a row that is a scalar times a table row.
//
// What it computes, for a batch of B centers c_b, their 2w context slots
// (ids x_bk, mask m_bk) and N shared negatives y_bn, over tables syn0,
// syn1 of V rows of D float32:
//   * SG1a, a warp a center: with v = syn0[max(c_b, 0)], live = c_b >= 0,
//       g_bk      = sigma(v·syn1[x_bk]) - 1         where live and m_bk, else 0
//       g_b,2w+n  = sigma(v·syn1[y_bn]) · k_bn       where k_bn > 0, else 0
//     k_bn the count of slots k with live, m_bk, x_bk != y_bn and y_bn !=
//     c_b (gensim skips accidental hits); dv_b = sum over the slots, in
//     slot order, of g·row; and the items' sort keys: a context's id where
//     m_bk (else the skip key V), a negative's id, V + 1 + c_b for a live
//     center (else V).  Writes g [B, 2w + N], dv [B, D] and the keys.
//   * SG1b, after a stable sort of the keys: the output row of key r (g1's
//     row r for r < V, g0's row r - V - 1 above V) is the sum of its items'
//     rows in sorted order, i.e. in item order: contexts, then negatives,
//     then centers, each batch-major.  A context's or negative's row is
//     g·syn0[max(c_b, 0)] (the product rounded, then added), a center's is
//     dv_b.  Its count is the number of its items.
// No [B, 2w, D] tensor is written.
//
// What bounds it on this card: bytes.  The tables are read and the two
// gradient tables written once (4·V·D·4 bytes), the batch's ids read once:
// 34.4 MB at the cell's shape, 10.3 us at 3.35 TB/s.  At V = 16,384 both
// tables (16.8 MB) stay in the 50 MB L2, so the row reads (a 512-byte row
// a live slot in SG1a, one an item in SG1b: ~140 MB) come from L2.
//
// The design:
//   SG1a. A warp a center, lane l holding columns l, l + 32, ... of a row
//     (J = D / 32 rounded up to a power of two).  Lane l reads slot l's id
//     and mask in one coalesced load (windows of 32 slots) and writes its
//     key; a lane holding a negative counts its slots from the contexts'
//     ids, broadcast by shuffles.  The slots then go in groups of G, their
//     ids shuffled to every lane, their rows' loads issued together, the G
//     dot products reduced by one xor butterfly (every lane ends with the
//     same bits: each step adds a + b and b + a), the coefficients formed
//     in every lane, dv summed from the rows still in registers.  A masked
//     slot, a negative with no count, and every slot of a dead center load
//     nothing.
//   SG1b. (1) A warp a chunk of 32 sorted items, one a lane: each lane
//     reads its item's key, its neighbours' keys (a key's first and last
//     position go to `first`/`last`, zeroed by a memset first), its source
//     row and coefficient; then the warp walks the 32 items in order, A
//     rows' loads in flight, adding each into the running sum of its key.
//     Where a key's run ends, the sum is its row if the run lies wholly in
//     the chunk, else a partial: slot 0 of the chunk's two if the run starts
//     at the chunk's first item, slot 1 otherwise.  So a hub's items spread
//     over as many warps as its chunks.  (2) A thread a row reads its first
//     and last position and writes its count; a warp then writes zeros to
//     each of its empty rows and, for each row that crosses a chunk
//     boundary, adds the partials of its chunks in chunk order.
// Every sum is taken in a fixed order, with no float atomics: the same
// inputs give the same bits on every run.
//
// The entry points launch on the given stream, allocate nothing, do not
// synchronise, and return cudaGetLastError() or the launch's own error.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;  // sorted items a chunk of SG1b, one a lane
constexpr unsigned kAll = 0xffffffffu;

// Rows a warp has in flight (SG1a's slots loaded together, SG1b's items
// and partials): fewer where a lane holds more columns.
template <int J>
__host__ __device__ constexpr int in_flight() { return J <= 4 ? 8 : (J <= 8 ? 4 : 2); }

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// A lane's columns lane + 32 j of a row of d, 0 past d or where !on.
template <int J>
__device__ __forceinline__ void load_row(const float* __restrict__ row, int d, int lane, bool on,
                                         float (&x)[J]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = lane + 32 * j;
    x[j] = on && c < d ? __ldg(row + c) : 0.f;
  }
}

template <int J>
__device__ __forceinline__ void store_row(float* __restrict__ row, int d, int lane,
                                          const float (&x)[J]) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = lane + 32 * j;
    if (c < d) row[c] = x[j];
  }
}

template <int J>
__global__ void __launch_bounds__(kThreads)
sg1_coeffs(const float* __restrict__ syn0, const float* __restrict__ syn1,
           const int* __restrict__ centers, const int* __restrict__ contexts,
           const bool* __restrict__ mask, const int* __restrict__ negatives,
           float* __restrict__ g, float* __restrict__ dv, int* __restrict__ keys, int b, int w2,
           int nn, int d, int v) {
  constexpr int G = in_flight<J>();
  const int lane = threadIdx.x & 31;
  const int bi = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (bi >= b) return;  // the whole warp
  const int s = w2 + nn;
  const int c = centers[bi];
  const bool live = c >= 0;
  const int* ctx = contexts + (int64_t)bi * w2;
  const bool* msk = mask + (int64_t)bi * w2;
  const int* neg = negatives + (int64_t)bi * nn;
  if (lane == 0) keys[(int64_t)b * s + bi] = live ? c + v + 1 : v;

  float cv[J], acc[J];
  load_row<J>(syn0 + (int64_t)(live ? c : 0) * d, d, lane, true, cv);
#pragma unroll
  for (int j = 0; j < J; ++j) acc[j] = 0.f;

  // slots 0 .. 2w - 1 are the contexts, 2w .. 2w + N - 1 the negatives, in
  // windows of 32: lane l reads slot base + l's id and forms its factor
  // (1 for a live context, a negative's count, 0 where the slot is 0)
  for (int base = 0; base < s; base += 32) {
    const int slot = base + lane;
    int id = 0;
    float factor = 0.f;
    if (slot < w2) {
      id = ctx[slot];
      const bool m = msk[slot];
      keys[(int64_t)bi * w2 + slot] = m ? id : v;
      factor = live && m ? 1.f : 0.f;
    } else if (slot < s) {
      id = neg[slot - w2];
      keys[(int64_t)b * w2 + (int64_t)bi * nn + slot - w2] = id;
    }
    if (base + 32 > w2 && base < s) {  // the window holds negatives: count their slots
      int hits = 0;
      for (int q0 = 0; q0 < w2; q0 += 32) {
        const int q = q0 + lane;
        const int x = q < w2 ? ctx[q] : 0;
        const bool m = q < w2 && msk[q];
        for (int k = 0; k < 32 && q0 + k < w2; ++k) {
          const int xk = __shfl_sync(kAll, x, k);
          const bool mk = __shfl_sync(kAll, (int)m, k) != 0;
          hits += mk && xk != id;
        }
      }
      if (slot >= w2 && slot < s && live && id != c) factor = (float)hits;
    }
    float mine = 0.f;  // the coefficient of the lane's slot
    const int span = min(32, s - base);
    for (int t0 = 0; t0 < span; t0 += G) {
      float u[G][J], x[G], f[G];
#pragma unroll
      for (int t = 0; t < G; ++t) {  // t0 + t < 32: G divides 32
        f[t] = __shfl_sync(kAll, factor, t0 + t);
        const int rid = __shfl_sync(kAll, id, t0 + t);
        load_row<J>(syn1 + (int64_t)rid * d, d, lane, f[t] != 0.f, u[t]);
        x[t] = 0.f;
#pragma unroll
        for (int j = 0; j < J; ++j) x[t] = fmaf(cv[j], u[t][j], x[t]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int t = 0; t < G; ++t) x[t] += __shfl_xor_sync(kAll, x[t], o);
      }
#pragma unroll
      for (int t = 0; t < G; ++t) {
        float gk = 0.f;
        if (f[t] != 0.f) gk = base + t0 + t < w2 ? sigmoid(x[t]) - 1.f : sigmoid(x[t]) * f[t];
#pragma unroll
        for (int j = 0; j < J; ++j) acc[j] = fmaf(gk, u[t][j], acc[j]);
        if (lane == t0 + t) mine = gk;
      }
    }
    if (slot < s) g[(int64_t)bi * s + slot] = mine;
  }
  store_row<J>(dv + (int64_t)bi * d, d, lane, acc);
}

template <int J>
__global__ void __launch_bounds__(kThreads)
sg1_chunks(const int* __restrict__ skeys, const int64_t* __restrict__ order,
           const float* __restrict__ g, const float* __restrict__ dv,
           const float* __restrict__ syn0, const int* __restrict__ centers,
           float* __restrict__ out, float* __restrict__ partial, int* __restrict__ first,
           int* __restrict__ last, int n, int b, int w2, int nn, int d, int v) {
  constexpr int A = in_flight<J>();
  const int lane = threadIdx.x & 31;
  const int chunk = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int p0 = chunk * kChunk;
  if (p0 >= n) return;  // the whole warp
  const int cnt = min(kChunk, n - p0);
  const int p = p0 + lane;
  const bool in = lane < cnt;
  const int key = in ? skeys[p] : -1;
  const int prev = in && p > 0 ? skeys[p - 1] : -1;
  const int next = in && p + 1 < n ? skeys[p + 1] : -1;
  if (in && key != prev) first[key] = p;
  if (in && key != next) last[key] = p + 1;
  const int key_before = __shfl_sync(kAll, prev, 0);

  // the lane's item: its source row and coefficient
  const float* src = syn0;
  float coef = 0.f;
  if (in && key != v) {
    const int64_t i = order[p], n1 = (int64_t)b * w2, n2 = (int64_t)b * nn;
    if (i < n1 + n2) {
      const int64_t bi = i < n1 ? i / w2 : (i - n1) / nn;
      const int slot = i < n1 ? (int)(i - bi * w2) : w2 + (int)(i - n1 - bi * nn);
      coef = g[bi * (w2 + nn) + slot];
      src = syn0 + (int64_t)max(centers[bi], 0) * d;
    } else {
      coef = 1.f;
      src = dv + (i - n1 - n2) * d;
    }
  }
  const unsigned long long src_bits = reinterpret_cast<uintptr_t>(src);

  float acc[J];
#pragma unroll
  for (int j = 0; j < J; ++j) acc[j] = 0.f;
  int run0 = 0;  // the first item of the running key's run in the chunk
  for (int t0 = 0; t0 < cnt; t0 += A) {
    float r[A][J], cf[A];
    int kk[A];
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const int t = t0 + a;  // < 32: A divides 32
      const float* sp = reinterpret_cast<const float*>(
          static_cast<uintptr_t>(__shfl_sync(kAll, src_bits, t)));
      cf[a] = __shfl_sync(kAll, coef, t);
      kk[a] = __shfl_sync(kAll, key, t);
      load_row<J>(sp, d, lane, t < cnt && kk[a] != v, r[a]);
    }
#pragma unroll
    for (int a = 0; a < A; ++a) {
      const int t = t0 + a;
      const int nk = __shfl_sync(kAll, next, t);
      if (t < cnt) {
#pragma unroll
        for (int j = 0; j < J; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(cf[a], r[a][j]));
        if (kk[a] != nk || t == cnt - 1) {  // the run ends here, or the chunk does
          if (kk[a] != v) {
            const bool whole = (run0 > 0 || key_before != kk[a]) && kk[a] != nk;
            float* dst = whole ? out + (int64_t)kk[a] * d
                               : partial + ((int64_t)chunk * 2 + (run0 == 0 ? 0 : 1)) * d;
            store_row<J>(dst, d, lane, acc);
          }
#pragma unroll
          for (int j = 0; j < J; ++j) acc[j] = 0.f;
          run0 = t + 1;
        }
      }
    }
  }
}

template <int J>
__global__ void __launch_bounds__(kThreads)
sg1_finish(const int* __restrict__ first, const int* __restrict__ last,
           const float* __restrict__ partial, float* __restrict__ out,
           float* __restrict__ counts, int rows, int d, int v) {
  constexpr int A = in_flight<J>();
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kThreads + threadIdx.x;
  int s = 0, e = 0;
  if (r < rows) {
    s = first[r];
    e = last[r];
    counts[r] = (float)(e - s);
  }
  const bool todo = r < rows && r != v && (e == s || s / kChunk != (e - 1) / kChunk);
  for (unsigned left = __ballot_sync(kAll, todo); left; left &= left - 1) {
    const int l = __ffs(left) - 1;
    const int rr = __shfl_sync(kAll, r, l), rs = __shfl_sync(kAll, s, l),
              re = __shfl_sync(kAll, e, l);
    float acc[J];
#pragma unroll
    for (int j = 0; j < J; ++j) acc[j] = 0.f;
    if (re > rs) {  // the partials of its chunks, in chunk order
      const int c0 = rs / kChunk, c1 = (re - 1) / kChunk;
      for (int q0 = c0; q0 <= c1; q0 += A) {
        float x[A][J];
#pragma unroll
        for (int a = 0; a < A; ++a) {
          const int q = q0 + a;
          const int slot = q == c0 && rs % kChunk != 0 ? 1 : 0;
          load_row<J>(partial + ((int64_t)q * 2 + slot) * d, d, lane, q <= c1, x[a]);
        }
#pragma unroll
        for (int a = 0; a < A; ++a) {
          if (q0 + a <= c1) {
#pragma unroll
            for (int j = 0; j < J; ++j) acc[j] = __fadd_rn(acc[j], x[a][j]);
          }
        }
      }
    }
    store_row<J>(out + (int64_t)rr * d, d, lane, acc);
  }
}

// J = D / 32 rounded up to a power of two, 0 past 512 columns
int cols_per_lane(int d) {
  for (int j = 1; j <= 16; j <<= 1)
    if (32 * j >= d) return j;
  return 0;
}

template <int J>
int launch_coeffs(const float* syn0, const float* syn1, const int* centers, const int* contexts,
                  const bool* mask, const int* negatives, float* g, float* dv, int* keys, int b,
                  int w2, int nn, int d, int v, cudaStream_t s) {
  sg1_coeffs<J><<<(b + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      syn0, syn1, centers, contexts, mask, negatives, g, dv, keys, b, w2, nn, d, v);
  return (int)cudaGetLastError();
}

template <int J>
int launch_rows(const int* skeys, const int64_t* order, const float* g, const float* dv,
                const float* syn0, const int* centers, float* out, float* partial, int* first,
                int* last, float* counts, int n, int b, int w2, int nn, int d, int v,
                cudaStream_t s) {
  const int chunks = (n + kChunk - 1) / kChunk;
  sg1_chunks<J><<<(chunks + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      skeys, order, g, dv, syn0, centers, out, partial, first, last, n, b, w2, nn, d, v);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int rows = 2 * v + 1;
  sg1_finish<J><<<(rows + kThreads - 1) / kThreads, kThreads, 0, s>>>(first, last, partial, out,
                                                                     counts, rows, d, v);
  return (int)cudaGetLastError();
}

bool bad_shape(int64_t b, int64_t w2, int64_t nn, int64_t d, int64_t v) {
  return b < 1 || w2 < 1 || nn < 0 || d < 1 || v < 1 || cols_per_lane((int)d) == 0 ||
         b * (w2 + nn + 1) > 0x7fffffffLL || 2 * v + 1 > 0x7fffffffLL || b > 0x7fffffffLL;
}

}  // namespace

extern "C" {

// SG1a over a batch of `b` centers with `w2` context slots and `nn`
// shared negatives each, tables of `v` rows of `d` columns (see above):
// writes g [b, w2 + nn], dv [b, d] and keys [b (w2 + nn + 1)].
int gt_sg1_coeffs(const void* syn0, const void* syn1, const void* centers, const void* contexts,
                  const void* mask, const void* negatives, void* g, void* dv, void* keys,
                  int64_t b, int64_t w2, int64_t nn, int64_t d, int64_t v, void* stream) {
  if (bad_shape(b, w2, nn, d, v)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* t0 = static_cast<const float*>(syn0);
  const float* t1 = static_cast<const float*>(syn1);
  const int* ce = static_cast<const int*>(centers);
  const int* cx = static_cast<const int*>(contexts);
  const bool* mk = static_cast<const bool*>(mask);
  const int* ng = static_cast<const int*>(negatives);
  float* gg = static_cast<float*>(g);
  float* dd = static_cast<float*>(dv);
  int* kk = static_cast<int*>(keys);
  switch (cols_per_lane((int)d)) {
    case 1: return launch_coeffs<1>(t0, t1, ce, cx, mk, ng, gg, dd, kk, b, w2, nn, d, v, s);
    case 2: return launch_coeffs<2>(t0, t1, ce, cx, mk, ng, gg, dd, kk, b, w2, nn, d, v, s);
    case 4: return launch_coeffs<4>(t0, t1, ce, cx, mk, ng, gg, dd, kk, b, w2, nn, d, v, s);
    case 8: return launch_coeffs<8>(t0, t1, ce, cx, mk, ng, gg, dd, kk, b, w2, nn, d, v, s);
    case 16: return launch_coeffs<16>(t0, t1, ce, cx, mk, ng, gg, dd, kk, b, w2, nn, d, v, s);
  }
  return (int)cudaErrorInvalidValue;
}

// SG1b over the `n` = b (w2 + nn + 1) keys sorted stably (`skeys`, and
// `order` their int64 positions before the sort): writes the [2v + 1, d]
// rows `out` (g1 in rows 0 .. v - 1, g0 in v + 1 .. 2v; row v unwritten)
// and their float32 `counts` [2v + 1].  Scratch: `partial` [ceil(n / 32),
// 2, d] float32 and `bounds` [2, 2v + 1] int32 (zeroed here).
int gt_sg1_rows(const void* skeys, const void* order, const void* g, const void* dv,
                const void* syn0, const void* centers, void* out, void* partial, void* bounds,
                void* counts, int64_t n, int64_t b, int64_t w2, int64_t nn, int64_t d,
                int64_t v, void* stream) {
  if (bad_shape(b, w2, nn, d, v) || n != b * (w2 + nn + 1)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* first = static_cast<int*>(bounds);
  int* last = first + (2 * v + 1);
  const int err = (int)cudaMemsetAsync(bounds, 0, sizeof(int) * 2 * (2 * v + 1), s);
  if (err != 0) return err;
  const int* sk = static_cast<const int*>(skeys);
  const int64_t* od = static_cast<const int64_t*>(order);
  const float* gg = static_cast<const float*>(g);
  const float* dd = static_cast<const float*>(dv);
  const float* t0 = static_cast<const float*>(syn0);
  const int* ce = static_cast<const int*>(centers);
  float* o = static_cast<float*>(out);
  float* pt = static_cast<float*>(partial);
  float* ct = static_cast<float*>(counts);
  switch (cols_per_lane((int)d)) {
    case 1:
      return launch_rows<1>(sk, od, gg, dd, t0, ce, o, pt, first, last, ct, n, b, w2, nn, d, v,
                            s);
    case 2:
      return launch_rows<2>(sk, od, gg, dd, t0, ce, o, pt, first, last, ct, n, b, w2, nn, d, v,
                            s);
    case 4:
      return launch_rows<4>(sk, od, gg, dd, t0, ce, o, pt, first, last, ct, n, b, w2, nn, d, v,
                            s);
    case 8:
      return launch_rows<8>(sk, od, gg, dd, t0, ce, o, pt, first, last, ct, n, b, w2, nn, d, v,
                            s);
    case 16:
      return launch_rows<16>(sk, od, gg, dd, t0, ce, o, pt, first, last, ct, n, b, w2, nn, d, v,
                            s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
