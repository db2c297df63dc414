// Self-test of hopper.cuh on the card. Not a port of a TPU kernel: it checks
// the TMA maps, the mbarrier wait and the wgmma descriptors that B1-B3 are
// built from, and the cluster helpers of B4, so that a descriptor, swizzle
// or cluster fault (which gives wrong numbers, not an error) fails under its
// own name before the kernels' checks run (chip_smoke.py, phase "hopper").
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
// A second kernel checks the cluster helpers that B4 is built from, in one
// cluster of `cluster` blocks of 128 threads:
//   * rank 0 loads an fp32 tile (8 x 256, unswizzled) once by TMA multicast
//     into every block of the cluster, each block's full mbarrier armed with
//     its bytes; every block copies what landed to tiles[rank];
//   * every block writes rank * 1000 + thread into its shared memory, and
//     after the cluster barrier reads the next rank's values through mapa /
//     ld.shared::cluster into dsmem[rank];
//   * every block stores the same values into the next rank's shared memory
//     (st.shared::cluster) and then arrives on that rank's mbarrier; each
//     block waits on its own (acquire.cluster) and copies what it received
//     to pushed[rank];
//   * every block arrives once on rank 0's mbarrier (count `cluster`) from
//     afar, and rank 0 sets ranks[cluster] = 1 once that phase completes;
//     ranks[block] is each block's cluster rank.
// The caller holds each against what it must be.
//
// hopper_selftest and hopper_cluster_selftest return cudaGetLastError()
// after the launch (or the error of encoding a TMA map); they launch on the
// given stream.

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

namespace {

using namespace hopper;

constexpr int kClRows = 8, kClCols = 256;   // the multicast tile

__global__ void __launch_bounds__(128)
hopper_cluster_selftest_kernel(const __grid_constant__ CUtensorMap tm,
                               float* tiles, float* dsmem, float* pushed,
                               int* ranks, int cluster) {
  __shared__ __align__(128) float tile[kClRows * kClCols];
  __shared__ float mine[128], got[128];
  __shared__ uint64_t full, remote, push_full;
  const uint32_t rank = cluster_rank();
  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(&full, 1);
    mbar_init(&remote, cluster);
    mbar_init(&push_full, 1);
    fence_mbar_init();
  }
  mine[tid] = (float)(rank * 1000 + tid);
  __syncthreads();
  cluster_sync();                     // barriers and `mine` cluster-wide
  if (tid == 0) {
    mbar_arrive_expect_tx(&full, kClRows * kClCols * 4);
    if (rank == 0)
      tma_load_4d_multicast(tile, &tm, &full, (uint16_t)((1u << cluster) - 1),
                            0, 0, 0, 0);
    mbar_arrive_remote(&remote, 0);
  }
  mbar_wait(&full, 0);
  for (int i = tid; i < kClRows * kClCols; i += 128)
    tiles[rank * kClRows * kClCols + i] = tile[i];
  const uint32_t next = (rank + 1) % cluster;
  dsmem[rank * 128 + tid] = ld_dsmem(mapa(&mine[tid], next));
  st_dsmem(mapa(&got[tid], next), mine[tid]);
  __syncthreads();
  if (tid == 0) mbar_arrive_remote_release(&push_full, next);
  mbar_wait_cluster(&push_full, 0);
  pushed[rank * 128 + tid] = got[tid];
  if (tid == 0) ranks[blockIdx.x] = (int)rank;
  if (rank == 0 && tid == 0) {
    mbar_wait(&remote, 0);
    ranks[cluster] = 1;
  }
  cluster_sync();                     // no block leaves while others read it
}

}  // namespace

// src: (8, 256) fp32, 16-byte aligned; tiles: (cluster, 8, 256) fp32;
// dsmem, pushed: (cluster, 128) fp32; ranks: cluster + 1 ints. cluster is
// 1..8.
extern "C" int hopper_cluster_selftest(const float* src, float* tiles,
                                       float* dsmem, float* pushed,
                                       int* ranks, int cluster,
                                       void* stream) {
  if (cluster < 1 || cluster > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm;
  const uint64_t dims[4] = {kClCols, 1, kClRows, 1};
  const uint64_t strides[3] = {kClCols, kClCols, kClRows * kClCols};
  const uint32_t box[4] = {kClCols, 1, kClRows, 1};
  cudaError_t err =
      hopper::encode(&tm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, src, 4, dims,
                     strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(128);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, hopper_cluster_selftest_kernel, tm, tiles,
                           dsmem, pushed, ranks, cluster);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* hopper_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
