// Machinery shared by the column-panel kernels of csrc/ (B1/B2 and X1-X3 in
// spmv.cu, B3 in gather.cu): a block of kPanelWarps consumer warps and one
// producer warp; the producer feeds a ring of shared-memory stages with
// bulk copies (TMA) under full and consumed barriers (mbarrier), while the
// consumers copy table rows into the panel with cp.async and then read
// them from it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

// The sliced layout of kernels/spmm.py:SellLayout, and the launch's scratch.
struct GtSell {
  const uint16_t* slots;     // [n_chunks * kChunk]: table row of each position (pads: 0)
  const int32_t* lane_row;   // [units * 32]
  const int32_t* lane_cnt;   // [units * 32]
  const int32_t* unit_hub;   // [units]
  const int32_t* ss_chunks;  // [n_ss]: chunks of each super-slice
  const int32_t* hub_rows;   // [n_hub]
  const int32_t* hub_piece;  // [n_hub + 1]
  const float* row_w;        // [V + 1]: the row's folded weight (B1) or scale (B2)
  float* hub_acc;            // n_pieces > 0: [(KAHAN ? 2 : 1) * n_pieces * C]
  int64_t n_chunks;
  int64_t n_ss;
  int64_t n_hub;
  int64_t n_pieces;
  // [units * 32]: the stream index of each lane's first item (X2 only);
  // fields are appended, so a build that predates one reads the same prefix
  const int32_t* lane_base;
};

// The rate probe's kernels on the column panel (spmv.cu), each over the
// stream's sliced layout into out[V+1, C] f32:
// X1: each row's max over its items' table rows, B2's 8 items in flight.
int sell_max_f32(const GtSell& L, const float* table, float* out, int64_t v, int64_t c,
                 cudaStream_t stream);
// X2: sum over each row's items t of row_w[row] * buf[t mod 16], buf [16, C]
// f32, in B2's launch shape but reading no panel and no slot.
int sell_buffer_sums_f32(const GtSell& L, const float* buf, float* out, int64_t v, int64_t c,
                         cudaStream_t stream);
// X3: raw, unweighted, unscaled run sums, 16 items in flight.
int sell_raw_sums_f32(const GtSell& L, const float* table, float* out, int64_t v, int64_t c,
                      cudaStream_t stream);

namespace gt {

constexpr int kPanelWarps = 16;                  // consumer warps of a panel block
constexpr int kPanelBlock = (kPanelWarps + 1) * 32;  // + one producer warp
constexpr int kSmemMax = 232448;                 // dynamic shared memory a block may use
constexpr int kBarrierBytes = 128;               // full and consumed barriers
constexpr int kSlab = 16;                        // bytes of each table row in the panel

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// bulk copy (TMA) global -> shared, completing `bytes` on the barrier
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// 16-byte copy that bypasses L1
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_all;\n" ::: "memory");
}

// barrier of the consumer warps only (the producer warp runs on)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kPanelWarps * 32) : "memory");
}

// Barriers set up by thread 0: full[s] takes the producer's one arrival
// and the copy's bytes, consumed[s] one arrival from each consumer warp.
__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* consumed, int stages) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&consumed[s], kPanelWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The producer: one thread copies chunk ch of `src` (chunk_bytes each, the
// chunks src_stride bytes apart) into stage ch mod STAGES of the ring once
// every consumer warp is done with it.
template <int STAGES>
__device__ __forceinline__ void produce(unsigned char* ring, const unsigned char* src,
                                        int64_t n_chunks, uint32_t chunk_bytes,
                                        int64_t src_stride, uint64_t* full, uint64_t* consumed) {
  int s = 0;
  uint32_t round = 0;
  for (int64_t ch = 0; ch < n_chunks; ++ch) {
    if (round > 0) mbar_wait(&consumed[s], (round - 1) & 1);
    mbar_expect_tx(&full[s], chunk_bytes);
    bulk_copy(ring + (size_t)s * chunk_bytes, src + ch * src_stride, chunk_bytes, &full[s]);
    if (++s == STAGES) { s = 0; ++round; }
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float x, float& y) { y = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16& y) { y = __float2bfloat16_rn(x); }

// 16 bytes of a panel row as SC floats
template <typename T>
__device__ __forceinline__ void unpack(uint4 q, float (&x)[kSlab / sizeof(T)]) {
  T v[kSlab / sizeof(T)];
  memcpy(v, &q, kSlab);
#pragma unroll
  for (int e = 0; e < (int)(kSlab / sizeof(T)); ++e) x[e] = to_f32(v[e]);
}

}  // namespace gt
