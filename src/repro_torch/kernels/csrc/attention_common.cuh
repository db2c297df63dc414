// Device helpers of the kernels without TMA or wgmma: B2's mma.sync dq
// kernel and the fp32 SIMT kernels (flash_attention.cu,
// flash_attention_bwd.cu), and mlstm.cu (the cp.async helpers): the
// reference's mask constant, cp.async tile copies, bf16 mma.sync and
// ldmatrix fragments, and the causal / window / kv_len visibility test. The
// Hopper kernels B1 and B3 take the constants, the visibility test,
// pack_bf16, cp_async4 (lse, delta) and exp2_ftz from here too; their TMA,
// mbarrier and wgmma helpers are in hopper.cuh.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace attn {

constexpr float kNegInf = -0.7f * 3.402823466e+38f;   // as the reference
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Query position qpos sees key position kpos.
__device__ __forceinline__ bool visible(int qpos, int kpos, int T, int causal,
                                        int window) {
  bool ok = kpos < T;
  if (causal) ok = ok && kpos <= qpos;
  if (window > 0) ok = ok && kpos > qpos - window;
  return ok;
}

// 2^x in one MUFU.EX2 (results below 2^-126 flush to 0), the exp2f of the
// softmax without exp2f's denormal fix-up.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  // src-size 0 zero-fills the 16 bytes (rows past the edge, columns >= D)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
               "r"(smem_addr(smem)), "l"(gmem), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool pred) {
  // src-size 0 zero-fills the 4 bytes
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::
               "r"(smem_addr(smem)), "l"(gmem), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* smem) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(smem)));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The A fragment (16x16, row-major) of rows row0..row0+15 and columns
// col0..col0+15 of a bf16 tile in shared memory with row stride ld.
__device__ __forceinline__ void load_a_frag(uint32_t* a,
                                            const __nv_bfloat16* tile, int ld,
                                            int row0, int col0, int g4,
                                            int t4) {
  const __nv_bfloat16* p0 = tile + (row0 + g4) * ld + col0 + 2 * t4;
  const __nv_bfloat16* p1 = p0 + 8 * ld;
  a[0] = ld32(p0);
  a[1] = ld32(p1);
  a[2] = ld32(p0 + 8);
  a[3] = ld32(p1 + 8);
}

// Copy `rows` rows of DP bf16 (16-byte chunks) into shared memory with row
// stride LD, NT threads cooperating. row_ptr(r) gives the global row or
// nullptr when r is outside the tensor; such rows and chunks at column >= D
// are zero-filled (the copy then reads nothing and is handed `base`, a
// valid address).
template <int DP, int LD, int NT, typename RowPtr>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, int rows, int D,
                                          const __nv_bfloat16* base,
                                          RowPtr row_ptr) {
  constexpr int kChunks = DP / 8;
  for (int c = threadIdx.x; c < rows * kChunks; c += NT) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const __nv_bfloat16* src = row_ptr(r);
    const bool ok = src != nullptr && col < D;
    cp_async16(dst + r * LD + col, ok ? src + col : base, ok);
  }
}

}  // namespace attn
