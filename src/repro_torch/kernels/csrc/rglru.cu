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
// What bounds it on an H100. The recurrence does one multiply-add and one
// exp per element: at recurrentgemma-9b's width (B=8, S=2048, R=4096) it
// must read log_a and b and write h, 3*B*S*R*4 = 8.1e8 bytes, 0.24 ms at
// 3.35 TB/s, against 6.7e7 operations: it is bound by the bytes. But a scan
// with one thread per channel has only B*R = 32,768 threads, 256 blocks of
// 128 on 132 SMs, each walking 2048 dependent steps: too few loads in
// flight to keep the memory busy. The design therefore also splits the
// sequence:
//
//  * ``chunk`` is the length of a time segment. Pass 1 (rglru_segments)
//    walks each (segment, channel) from h = 0 and writes the segment's
//    local end state and the product of its decays exp(log_a_t); pass 2
//    (rglru_carries) walks the S/chunk segment summaries of each channel in
//    order and writes the state entering each segment (from h0); pass 3
//    (rglru_outputs) walks each (segment, channel) again from that state
//    with the same multiply-add as the reference, writing h and h_last.
//    With a single segment (chunk >= S) passes 1 and 2 are skipped. The
//    threads in flight grow by S/chunk, for 8 more bytes a step (pass 1's
//    reread): 20 bytes a step against the 12 of the bound.
//  * ``r_block`` is the number of channels a block holds, one thread each,
//    so each step's loads are coalesced along R.
//  * Both are runtime arguments, so each (chunk, r_block) the tuner tries
//    is a different launch shape.
// The state entering a segment is a product of decays times h plus the
// local end state, where the reference multiplies step by step: the same
// function with the rounding of a different association order.
//
// C entry points return cudaGetLastError() after the launches; they launch
// on the given stream and do not synchronise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Args {
  const float* log_a;
  const float* b;
  const float* h0;      // nullptr: zeros
  float* h;
  float* h_last;
  float* seg_h;         // (B, NS, R) local end state of each segment
  float* seg_a;         // (B, NS, R) product of the segment's decays
  float* seg_in;        // (B, NS, R) state entering each segment
  int B, S, R, chunk, NS;
};

__global__ void rglru_segments_kernel(Args a) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int seg = blockIdx.y, bi = blockIdx.z;
  if (r >= a.R) return;
  const int t0 = seg * a.chunk, t1 = min(a.S, t0 + a.chunk);
  const float* la = a.log_a + ((size_t)bi * a.S) * a.R + r;
  const float* bb = a.b + ((size_t)bi * a.S) * a.R + r;
  float h = 0.f, p = 1.f;
#pragma unroll 8
  for (int t = t0; t < t1; ++t) {
    const float d = expf(la[(size_t)t * a.R]);
    h = fmaf(d, h, bb[(size_t)t * a.R]);
    p *= d;
  }
  const size_t o = ((size_t)bi * a.NS + seg) * a.R + r;
  a.seg_h[o] = h;
  a.seg_a[o] = p;
}

__global__ void rglru_carries_kernel(Args a) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int bi = blockIdx.y;
  if (r >= a.R) return;
  float h = a.h0 ? a.h0[(size_t)bi * a.R + r] : 0.f;
  for (int seg = 0; seg < a.NS; ++seg) {
    const size_t o = ((size_t)bi * a.NS + seg) * a.R + r;
    a.seg_in[o] = h;
    h = fmaf(a.seg_a[o], h, a.seg_h[o]);
  }
}

__global__ void rglru_outputs_kernel(Args a) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  const int seg = blockIdx.y, bi = blockIdx.z;
  if (r >= a.R) return;
  const int t0 = seg * a.chunk, t1 = min(a.S, t0 + a.chunk);
  float h;
  if (a.NS > 1)
    h = a.seg_in[((size_t)bi * a.NS + seg) * a.R + r];
  else
    h = a.h0 ? a.h0[(size_t)bi * a.R + r] : 0.f;
  const size_t base = ((size_t)bi * a.S) * a.R + r;
  const float* la = a.log_a + base;
  const float* bb = a.b + base;
  float* out = a.h + base;
#pragma unroll 8
  for (int t = t0; t < t1; ++t) {
    h = fmaf(expf(la[(size_t)t * a.R]), h, bb[(size_t)t * a.R]);
    out[(size_t)t * a.R] = h;
  }
  if (t1 == a.S) a.h_last[(size_t)bi * a.R + r] = h;
}

}  // namespace

extern "C" int rglru_fwd(const float* log_a, const float* b, const float* h0,
                         float* h, float* h_last, float* seg_h, float* seg_a,
                         float* seg_in, int B, int S, int R, int chunk,
                         int r_block, void* stream) {
  Args a;
  a.log_a = log_a; a.b = b; a.h0 = h0; a.h = h; a.h_last = h_last;
  a.seg_h = seg_h; a.seg_a = seg_a; a.seg_in = seg_in;
  a.B = B; a.S = S; a.R = R; a.chunk = chunk;
  a.NS = (S + chunk - 1) / chunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nr = (R + r_block - 1) / r_block;
  if (a.NS > 1) {
    rglru_segments_kernel<<<dim3(nr, a.NS, B), r_block, 0, st>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    rglru_carries_kernel<<<dim3(nr, B), r_block, 0, st>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  rglru_outputs_kernel<<<dim3(nr, a.NS, B), r_block, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rglru_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
