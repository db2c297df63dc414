// Self-test of hopper.cuh on the card. Not a port of a TPU kernel: it checks
// the TMA maps, the mbarrier wait and the wgmma descriptors that B1 and B3
// are built from, so that a descriptor or swizzle fault (which gives wrong
// numbers, not an error) fails under its own name before the attention
// checks run (chip_smoke.py, phase "hopper").
//
// One warpgroup:
//   * loads A (64 x D bf16, read through map_q as q of shape
//     (1, 32, 1, 2, D): 32 positions x 2 heads) and B (128 x D bf16, read
//     through map_kv as k of shape (1, 128, 1, D)) by TMA into 128B-swizzled
//     boxes of 64 columns, completing on one mbarrier;
//   * C1 = A B^T (64 x 128 fp32): wgmma m64n128k16, A and B from shared
//     memory, both K-major (the products of S = Q K^T);
//   * C2 = bf16(C1) B (64 x D fp32): wgmma m64nDk16 with C1, rounded to bf16
//     in registers, as the register A operand and B MN-major (the product
//     O += P V).
// The caller holds C1 against the fp32 product of A and B, and C2 against
// the fp32 product of bf16(C1) and B. D is 64 or 128: one box, or two.
//
// hopper_selftest returns cudaGetLastError() after the launch (or the error
// of encoding a TMA map); it launches on the given stream.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kQBox = 64 * 128;     // bytes of a 64-row box
constexpr int kKBox = 128 * 128;    // bytes of a 128-row box

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int DP>
__global__ void __launch_bounds__(128)
hopper_selftest_kernel(const __grid_constant__ CUtensorMap tm_a,
                       const __grid_constant__ CUtensorMap tm_b, float* c1,
                       float* c2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sA = align_1024(smem_raw);
  unsigned char* sB = sA + (DP / 64) * kQBox;
  uint64_t* bar = reinterpret_cast<uint64_t*>(sB + (DP / 64) * kKBox);
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_arrive_expect_tx(bar, (DP / 64) * (kQBox + kKBox));
    for (int h = 0; h < DP / 64; ++h) {
      tma_load_5d(sA + h * kQBox, &tm_a, bar, 64 * h, 0, 0, 0, 0);
      tma_load_4d(sB + h * kKBox, &tm_b, bar, 64 * h, 0, 0, 0);
    }
  }
  mbar_wait(bar, 0);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = warp * 16 + lane / 4, col = 2 * (lane % 4);

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    wgmma_ss<0>(acc, desc_k(sA + (kk / 4) * kQBox + (kk % 4) * 32),
                desc_k(sB + (kk / 4) * kKBox + (kk % 4) * 32), kk > 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
#pragma unroll
  for (int i = 0; i < 64; ++i)
    c1[(row + 8 * ((i / 2) % 2)) * 128 + 8 * (i / 4) + col + i % 2] = acc[i];

  uint32_t pa[8][4];
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
    pa[ks][0] = pack(acc[8 * ks], acc[8 * ks + 1]);
    pa[ks][1] = pack(acc[8 * ks + 2], acc[8 * ks + 3]);
    pa[ks][2] = pack(acc[8 * ks + 4], acc[8 * ks + 5]);
    pa[ks][3] = pack(acc[8 * ks + 6], acc[8 * ks + 7]);
  }
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 8; ++ks)
    wgmma_rs<1>(o, pa[ks], desc_mn(sB + ks * 16 * 128, kKBox), ks > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);
#pragma unroll
  for (int i = 0; i < DP / 2; ++i)
    c2[(row + 8 * ((i / 2) % 2)) * DP + 8 * (i / 4) + col + i % 2] = o[i];
}

template <int DP>
cudaError_t launch(const void* a, const void* b, float* c1, float* c2,
                   cudaStream_t stream) {
  CUtensorMap tm_a, tm_b;
  cudaError_t err = map_q(&tm_a, a, 1, 32, 1, 2, DP, 2, 32);
  if (err == cudaSuccess) err = map_kv(&tm_b, b, 1, 128, 1, DP, 128);
  if (err != cudaSuccess) return err;
  const int smem = (DP / 64) * (kQBox + kKBox) + 8 + 1024;
  err = cudaFuncSetAttribute(hopper_selftest_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  hopper_selftest_kernel<DP><<<1, 128, smem, stream>>>(tm_a, tm_b, c1, c2);
  return cudaGetLastError();
}

}  // namespace

// a: (64, D) bf16, b: (128, D) bf16, contiguous and 16-byte aligned;
// c1: (64, 128) fp32; c2: (64, D) fp32. D is 64 or 128.
extern "C" int hopper_selftest(const void* a, const void* b, float* c1,
                               float* c2, int D, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(D == 64 ? launch<64>(a, b, c1, c2, st)
                                  : launch<128>(a, b, c1, c2, st));
}

extern "C" const char* hopper_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
