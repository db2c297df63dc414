// Device helpers shared by the attention kernels (flash_attention.cu,
// flash_attention_bwd.cu) and rglru.cu: the reference's mask constant, the
// causal / window / kv_len visibility test, exp2_ftz, pack_bf16 and the
// 4-byte cp.async copies (lse, delta; rglru's fp32 columns). The TMA,
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace attn
