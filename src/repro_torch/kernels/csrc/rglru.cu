// RG-LRU linear recurrence (B5) for Hopper, sm_90a.
//
// Replaces repro/kernels/rglru.py::_rglru_kernel (the Pallas TPU kernel
// behind repro.kernels.ops.rglru) and computes the same function:
//
//   h_t = exp(log_a_t) * h_{t-1} + b_t,   h_{-1} = h0 (0 when absent),
//   returning h (B, S, R) and h_last = h_{S-1} (B, R), all fp32.
//
// Layouts (contiguous, fp32): log_a, b, h (B, S, R); h0, h_last (B, R).
// Any S and R: the ragged tail of either is masked, where the reference
// pads it (rglru.py:62-68).
//
// What bounds it on an H100. One exp and one multiply-add an element
// against 12 bytes (log_a and b read once, h written once; h0 and h_last
// are 8 bytes a channel): at recurrentgemma-9b's width (B=8, S=2048,
// R=4096) 8.05e8 bytes, 0.2404 ms at 3.35 TB/s, against 6.7e7 operations.
// It is bound by the bytes, so the kernel reads each input element once and
// writes each output once: one pass, one launch.
//
// The design follows the reference's own structure. Its grid walks the time
// chunks in order and carries h in VMEM, one DMA bringing each (chunk,
// r_block) tile; here the walk is a loop inside the block:
//
//  * one block per (batch row, r_block channels), one thread per channel,
//    carrying h in a register; each step is the reference's step
//    h = fmaf(expf(la), h, b) (rglru.py:35), and h goes straight from the
//    register to device memory, one 128-byte row a warp a step;
//  * a ring of `stages` tiles in shared memory, each `depth` steps x r_block
//    channels of log_a and of b, keeps many steps of loads in flight without
//    more threads: with one thread per channel a plain load loop has 32,768
//    threads at this width, too few to keep the memory busy;
//  * each thread fills its own column of a tile by 4-byte cp.async (the
//    steps within S) and arrives on the stage's full mbarrier once the
//    copies have landed. No other thread reads that column, so the ring
//    needs no empty barrier, and any R, r_block and base address is taken;
//  * `chunk` (the reference's DMA tile) is the depth of a ring tile, and
//    `r_block` the channels of a block, as in the tuner's grid. The ring
//    holds about kRingBytes (between kMinStages and kMaxStages tiles); where
//    kMinStages tiles of a chunk do not fit a block's shared memory, the
//    plan cuts the chunk into equal shallower tiles. rglru_plan returns what
//    a launch will use.
//
// C entry points return cudaGetLastError() after the launch; they launch on
// the given stream and do not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "attention_common.cuh"   // attn::cp_async4
#include "hopper.cuh"             // mbarriers

namespace {

constexpr int kMinStages = 2;
constexpr int kMaxStages = 8;
constexpr int kRingBytes = 64 << 10;
constexpr int kMaxSmem = 232448;       // bytes a block may use (H100)
constexpr int kMaxThreads = 1024;
constexpr int kBatch = 8;              // steps whose loads go out together

struct Args {
  const float* log_a;
  const float* b;
  const float* h0;      // nullptr: zeros
  float* h;
  float* h_last;
  int B, S, R, r_block, nr;   // nr: blocks across R
};

struct Plan {
  int depth;       // steps of a ring tile
  int stages;
  int threads;     // r_block rounded up to whole warps
  int smem;        // dynamic shared memory bytes
};

// A stage: log_a's depth x r_block tile, then b's; a step's row is r_block
// floats.
int stage_bytes(int depth, int r_block) {
  return 2 * depth * r_block * 4;
}

__global__ void __launch_bounds__(kMaxThreads)
rglru_scan_kernel(Args a, Plan p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ring = reinterpret_cast<float*>(smem_raw);
  const int tile = p.depth * a.r_block;     // floats of one input's tile
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + (size_t)p.stages * 2 * tile);
  const int rb = blockIdx.x % a.nr, bi = blockIdx.x / a.nr;
  const int tid = threadIdx.x, r = rb * a.r_block + tid;
  const int ntiles = (a.S + p.depth - 1) / p.depth;
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) hopper::mbar_init(&full[s], p.threads);
    hopper::fence_mbar_init();
  }
  __syncthreads();

  // Channel r: this thread's column of every stage.
  const bool live = tid < a.r_block && r < a.R;
  const size_t base = (size_t)bi * a.S * a.R + r;

  // This thread's column of tile t, then its arrival on the stage's full
  // barrier once the copies have landed.
  auto issue = [&](int t) {
    asm volatile("" ::: "memory");   // this column's reads of the stage first
    const int s = t % p.stages;
    if (live) {
      float* la_s = ring + (size_t)s * 2 * tile + tid;
      const int t0 = t * p.depth, n = min(p.depth, a.S - t0);
      const size_t g = base + (size_t)t0 * a.R;
      for (int i = 0; i < n; ++i) {
        attn::cp_async4(la_s + i * a.r_block, a.log_a + g + (size_t)i * a.R,
                        true);
        attn::cp_async4(la_s + tile + i * a.r_block,
                        a.b + g + (size_t)i * a.R, true);
      }
    }
    hopper::mbar_arrive_cp_async(&full[s]);
  };
  for (int t = 0; t < min(p.stages, ntiles); ++t) issue(t);

  float h = live && a.h0 ? a.h0[(size_t)bi * a.R + r] : 0.f;
  float* out = a.h + base;
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % p.stages;
    hopper::mbar_wait(&full[s], (t / p.stages) & 1);
    if (live) {
      const float* la_s = ring + (size_t)s * 2 * tile + tid;
      const float* b_s = la_s + tile;
      const int n = min(p.depth, a.S - t * p.depth);
      int i = 0;
      for (; i + kBatch <= n; i += kBatch) {
        float la8[kBatch], b8[kBatch];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          la8[k] = la_s[(i + k) * a.r_block];
          b8[k] = b_s[(i + k) * a.r_block];
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          h = fmaf(expf(la8[k]), h, b8[k]);
          *out = h;
          out += a.R;
        }
      }
      for (; i < n; ++i) {
        h = fmaf(expf(la_s[i * a.r_block]), h, b_s[i * a.r_block]);
        *out = h;
        out += a.R;
      }
    }
    if (t + p.stages < ntiles) issue(t + p.stages);
  }
  if (live) a.h_last[(size_t)bi * a.R + r] = h;
}

int round_up(int x, int m) { return (x + m - 1) / m * m; }

// The plan of a launch: the chunk (no deeper than S) in k equal tiles, k as
// small as fits kMinStages tiles and their barriers; then as many stages as
// fill kRingBytes, within kMinStages..kMaxStages and the tiles there are.
cudaError_t make_plan(int S, int R, int chunk, int r_block, Plan* p) {
  if (S < 1 || R < 1 || chunk < 1 || r_block < 1 || r_block > kMaxThreads)
    return cudaErrorInvalidValue;
  p->threads = round_up(r_block, 32);
  const int c = std::min(chunk, S);
  for (int k = 1;; ++k) {
    p->depth = (c + k - 1) / k;
    if (kMinStages * (stage_bytes(p->depth, r_block) + 8) <= kMaxSmem ||
        p->depth == 1)
      break;
  }
  const int sb = stage_bytes(p->depth, r_block);
  const int ntiles = (S + p->depth - 1) / p->depth;
  p->stages = std::max(kMinStages, std::min(kMaxStages, kRingBytes / sb));
  p->stages = std::min(p->stages, ntiles);
  p->smem = p->stages * (sb + 8);
  return p->smem <= kMaxSmem ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

// h, h_last from log_a, b and h0 (nullptr: zeros).
extern "C" int rglru_fwd(const float* log_a, const float* b, const float* h0,
                         float* h, float* h_last, int B, int S, int R,
                         int chunk, int r_block, void* stream) {
  Plan p;
  cudaError_t err = make_plan(S, R, chunk, r_block, &p);
  if (err != cudaSuccess || B < 1) return static_cast<int>(
      err != cudaSuccess ? err : cudaErrorInvalidValue);
  Args a;
  a.log_a = log_a; a.b = b; a.h0 = h0; a.h = h; a.h_last = h_last;
  a.B = B; a.S = S; a.R = R; a.r_block = r_block;
  a.nr = (R + r_block - 1) / r_block;
  if (p.smem > 48 * 1024) {
    err = cudaFuncSetAttribute(rglru_scan_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               p.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  rglru_scan_kernel<<<a.nr * a.B, p.threads, p.smem,
                      static_cast<cudaStream_t>(stream)>>>(a, p);
  return static_cast<int>(cudaGetLastError());
}

// The plan rglru_fwd launches with: out[0..3] = tile depth, stages, dynamic
// shared memory bytes, threads a block. Returns 0, or an error where it
// launches nothing.
extern "C" int rglru_plan(int S, int R, int chunk, int r_block, int* out) {
  Plan p;
  const cudaError_t err = make_plan(S, R, chunk, r_block, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = p.depth; out[1] = p.stages; out[2] = p.smem; out[3] = p.threads;
  return 0;
}

extern "C" const char* rglru_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
