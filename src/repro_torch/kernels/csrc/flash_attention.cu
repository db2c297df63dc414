// Flash-attention forward (B1) for Hopper, sm_90a.
//
// Replaces repro/kernels/flash_attention.py::_attn_kernel (the Pallas TPU
// kernel behind repro.kernels.ops.flash_attention) and computes the same
// function: GQA attention with an fp32 online softmax (acc, m, l),
// per-element causal / sliding-window / kv_len masks, scale 1/sqrt(D) unless
// given, out in the inputs' dtype and LSE = m + log(max(l, 1e-30)) in fp32.
//
// Layouts (contiguous): q, out (B, S, K, G, D); k, v (B, T, K, D);
// lse (B, S, K, G). Query head (k, g) reads kv head k.
//
// What bounds it on an H100. At the serve shape (B=8, S=T=2048, 16 q heads
// over 8 kv heads, D=128, causal) the two products need about
// 4*B*S^2*H*D/2 = 1.4e11 FLOP, 0.14 ms at 989 TFLOP/s bf16, while q, k, v,
// out and lse move about 200 MB, 0.06 ms at 3.35 TB/s: it is bound by the
// tensor cores. The design therefore
//   * never writes a score to device memory: S = Q K^T, the softmax and
//     P V happen in registers, tile by tile;
//   * runs both products on the tensor cores (mma.sync m16n8k16, bf16 in,
//     fp32 accumulate), with Q's fragments held in registers for the whole
//     kv loop and P handed from the S accumulators straight to the A operand
//     of P V without a trip through shared memory;
//   * clips the kv loop to the visible range (up to the diagonal when
//     causal, from q_start - window + 1 with a window) instead of testing
//     every kv block as the TPU kernel does, and masks per element only on
//     the tiles that straddle an edge;
//   * has one block own a tile of query rows of ONE (batch, kv head) across
//     all G query heads of the group, so each K/V tile is read once per
//     group; K/V tiles are double-buffered with cp.async;
//   * launches the longest causal tiles first.
// wgmma, TMA and warp specialisation (the way to the full tensor-core rate)
// are left for a later change.
//
// fp32 inputs take a separate SIMT kernel (fp32 FMA, no tensor cores), so an
// fp32 caller gets fp32 products and not TF32.
//
// C entry points return cudaGetLastError() after the launch; they launch on
// the given stream and do not synchronise.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

using namespace attn;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int B, S, T, K, G, D;
  float scale;
  int causal;
  int window;   // <= 0: no window
};

// Rows of a block are flattened (position, group) pairs: row r is query
// position q0 + r / G, head g = r % G. BQ = rows / G positions per block.
struct Tile {
  int q0, bq, q_last, kv_lo, kv_hi;
};

__device__ __forceinline__ Tile tile_of(const Args& a, int rows) {
  const int n_tiles = gridDim.x;
  const int qt = n_tiles - 1 - blockIdx.x;          // longest causal first
  Tile t;
  t.bq = rows / a.G;
  t.q0 = qt * t.bq;
  t.q_last = min(t.q0 + t.bq, a.S) - 1;
  t.kv_hi = a.causal ? min(a.T, t.q_last + 1) : a.T;
  t.kv_lo = a.window > 0 ? max(0, t.q0 - a.window + 1) : 0;
  return t;
}

__device__ __forceinline__ bool visible(const Args& a, int qpos, int kpos) {
  return attn::visible(qpos, kpos, a.T, a.causal, a.window);
}

// True when every (row, column) of the kv tile [k0, k0 + n) is visible to
// every query position of the block, so the tile needs no mask.
__device__ __forceinline__ bool tile_unmasked(const Args& a, const Tile& t,
                                              int k0, int n) {
  bool ok = k0 + n <= a.T;
  if (a.causal) ok = ok && k0 + n - 1 <= t.q0;
  if (a.window > 0) ok = ok && k0 > t.q_last - a.window;
  return ok;
}

// ------------------------------------------------------------------ bf16 path

constexpr int kRows = 64;      // flattened (position, group) rows per block
constexpr int kBN = 64;        // kv rows per tile
constexpr int kWarps = 4;      // 16 rows each
constexpr int kThreads = kWarps * 32;

template <int DP>
__global__ void __launch_bounds__(kThreads)
fa_fwd_bf16_kernel(Args a) {
  constexpr int LD = DP + 8;               // padding: conflict-free fragments
  constexpr int KSTEPS = DP / 16;          // k-steps of S = Q K^T
  constexpr int NT_S = kBN / 8;            // n-tiles of S
  constexpr int NT_O = DP / 8;             // n-tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + kRows * LD;     // [2][kBN][LD]
  __nv_bfloat16* sV = sK + 2 * kBN * LD;   // [2][kBN][LD]

  const int kh = blockIdx.y, b = blockIdx.z;
  const Tile t = tile_of(a, kRows);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g4 = lane / 4, t4 = lane % 4;   // mma fragment coordinates

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v);
  const int rows_used = t.bq * a.G;

  auto q_row = [&](int r) -> const __nv_bfloat16* {
    const int s = t.q0 + r / a.G;
    if (r >= rows_used || s >= a.S) return nullptr;
    return q + ((((size_t)b * a.S + s) * a.K + kh) * a.G + r % a.G) * a.D;
  };
  auto kv_loader = [&](const __nv_bfloat16* base, int k0) {
    return [=](int r) -> const __nv_bfloat16* {
      const int s = k0 + r;
      if (s >= t.kv_hi) return nullptr;
      return base + (((size_t)b * a.T + s) * a.K + kh) * a.D;
    };
  };

  const int n_tiles = t.kv_hi > t.kv_lo ? (t.kv_hi - t.kv_lo + kBN - 1) / kBN
                                        : 0;

  load_rows<DP, LD, kThreads>(sQ, kRows, a.D, q, q_row);
  if (n_tiles > 0) {
    load_rows<DP, LD, kThreads>(sK, kBN, a.D, k, kv_loader(k, t.kv_lo));
    load_rows<DP, LD, kThreads>(sV, kBN, a.D, v, kv_loader(v, t.kv_lo));
  }
  cp_async_commit();

  // rows of this thread: r0 = 16*warp + g4 and r0 + 8
  const int r0 = warp * 16 + g4;
  const int qpos0 = t.q0 + r0 / a.G, qpos1 = t.q0 + (r0 + 8) / a.G;

  uint32_t qf[KSTEPS][4];
  float o[NT_O][4];
#pragma unroll
  for (int i = 0; i < NT_O; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;       // running max, log2 units
  float l0 = 0.f, l1 = 0.f;               // this thread's share of the sums
  const float sl2 = a.scale * kLog2e;

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    const int k0 = t.kv_lo + j * kBN;
    if (j + 1 < n_tiles) {
      const int nb = buf ^ 1;
      load_rows<DP, LD, kThreads>(sK + nb * kBN * LD, kBN, a.D, k,
                        kv_loader(k, k0 + kBN));
      load_rows<DP, LD, kThreads>(sV + nb * kBN * LD, kBN, a.D, v,
                        kv_loader(v, k0 + kBN));
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const __nv_bfloat16* p0 = sQ + r0 * LD + kk * 16 + 2 * t4;
        const __nv_bfloat16* p1 = p0 + 8 * LD;
        qf[kk][0] = *reinterpret_cast<const uint32_t*>(p0);
        qf[kk][1] = *reinterpret_cast<const uint32_t*>(p1);
        qf[kk][2] = *reinterpret_cast<const uint32_t*>(p0 + 8);
        qf[kk][3] = *reinterpret_cast<const uint32_t*>(p1 + 8);
      }
    }

    const __nv_bfloat16* tK = sK + buf * kBN * LD;
    const __nv_bfloat16* tV = sV + buf * kBN * LD;

    // S = Q K^T for this warp's 16 rows x kBN columns
    float s[NT_S][4];
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kr = tK + (nt * 8 + g4) * LD + 2 * t4;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kk * 16);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(kr + kk * 16 + 8);
        mma16816(s[nt], qf[kk], b0, b1);
      }
    }

    // scale (log2 units) and mask
    const bool full = tile_unmasked(a, t, k0, kBN);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nt][e] * sl2;
        if (!full) {
          const int kpos = k0 + nt * 8 + 2 * t4 + (e & 1);
          if (!visible(a, e < 2 ? qpos0 : qpos1, kpos)) x = kNegInf;
        }
        s[nt][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = exp2f(m0 - mn0), c1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mn0);
      s[nt][1] = exp2f(s[nt][1] - mn0);
      s[nt][2] = exp2f(s[nt][2] - mn1);
      s[nt][3] = exp2f(s[nt][3] - mn1);
      ls0 += s[nt][0] + s[nt][1];
      ls1 += s[nt][2] + s[nt][3];
    }
    l0 = l0 * c0 + ls0;
    l1 = l1 * c1 + ls1;
#pragma unroll
    for (int i = 0; i < NT_O; ++i) {
      o[i][0] *= c0;
      o[i][1] *= c0;
      o[i][2] *= c1;
      o[i][3] *= c1;
    }

    // O += P V: the S accumulators of two n-tiles form one A fragment
#pragma unroll
    for (int ks = 0; ks < kBN / 16; ++ks) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * ks][0], s[2 * ks][1]);
      pa[1] = pack_bf16(s[2 * ks][2], s[2 * ks][3]);
      pa[2] = pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
      pa[3] = pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]);
      const __nv_bfloat16* vr =
          tV + (ks * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
      for (int dp = 0; dp < NT_O / 2; ++dp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vr + dp * 16);
        mma16816(o[2 * dp], pa, vb[0], vb[1]);
        mma16816(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();   // this buffer is refilled two iterations on
  }
  cp_async_wait<0>();  // no tile visible: only Q was in flight

  // epilogue: reduce l over the quad, normalise, store out and lse
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + half * 8;
    const int s_pos = t.q0 + r / a.G;
    if (r >= rows_used || s_pos >= a.S) continue;
    const size_t row = (((size_t)b * a.S + s_pos) * a.K + kh) * a.G + r % a.G;
    const float inv = half ? inv1 : inv0;
#pragma unroll
    for (int i = 0; i < NT_O; ++i) {
      const int col = i * 8 + 2 * t4;
      if (col < a.D) {
        *reinterpret_cast<uint32_t*>(out + row * a.D + col) =
            pack_bf16(o[i][2 * half] * inv, o[i][2 * half + 1] * inv);
      }
    }
    if (t4 == 0) {
      const float m = half ? m1 : m0;
      const float l = half ? l1 : l0;
      a.lse[row] = m * kLn2 + logf(l);
    }
  }
}

template <int DP>
cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  constexpr int LD = DP + 8;
  const int smem = (kRows + 4 * kBN) * LD * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_bf16_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const int bq = kRows / a.G;
  dim3 grid((a.S + bq - 1) / bq, a.K, a.B);
  fa_fwd_bf16_kernel<DP><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ fp32 path

constexpr int kRowsF = 32;     // flattened rows per block, 4 threads per row
constexpr int kBNF = 32;       // kv rows per tile
constexpr int kDPF = 128;      // D padded
constexpr int kThreadsF = kRowsF * 4;

__global__ void __launch_bounds__(kThreadsF)
fa_fwd_f32_kernel(Args a) {
  constexpr int PER = kDPF / 4;           // dims per thread: d = t4 + 4*i
  __shared__ float sK[kBNF][kDPF];
  __shared__ float sV[kBNF][kDPF];

  const int kh = blockIdx.y, b = blockIdx.z;
  const Tile t = tile_of(a, kRowsF);
  const int r = threadIdx.x / 4, t4 = threadIdx.x % 4;
  const int rows_used = t.bq * a.G;
  const int qpos = t.q0 + r / a.G;
  const bool row_ok = r < rows_used && qpos < a.S;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const size_t row = (((size_t)b * a.S + qpos) * a.K + kh) * a.G + r % a.G;

  float qr[PER], acc[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int d = t4 + 4 * i;
    qr[i] = (row_ok && d < a.D) ? q[row * a.D + d] : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  for (int k0 = t.kv_lo; k0 < t.kv_hi; k0 += kBNF) {
    for (int c = threadIdx.x; c < kBNF * kDPF; c += kThreadsF) {
      const int rr = c / kDPF, d = c % kDPF;
      const int s = k0 + rr;
      const bool ok = s < t.kv_hi && d < a.D;
      const size_t off = (((size_t)b * a.T + s) * a.K + kh) * a.D + d;
      sK[rr][d] = ok ? k[off] : 0.f;
      sV[rr][d] = ok ? v[off] : 0.f;
    }
    __syncthreads();

    float sc[kBNF];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kBNF; ++j) {
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < PER; ++i) part = fmaf(qr[i], sK[j][t4 + 4 * i], part);
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      float x = part * a.scale;
      if (!visible(a, qpos, k0 + j)) x = kNegInf;
      sc[j] = x;
      mx = fmaxf(mx, x);
    }
    const float mn = fmaxf(m, mx);
    const float corr = expf(m - mn);
    m = mn;
    float ls = 0.f;
#pragma unroll
    for (int j = 0; j < kBNF; ++j) {
      sc[j] = expf(sc[j] - mn);
      ls += sc[j];
    }
    l = l * corr + ls;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      float x = acc[i] * corr;
#pragma unroll
      for (int j = 0; j < kBNF; ++j) x = fmaf(sc[j], sV[j][t4 + 4 * i], x);
      acc[i] = x;
    }
    __syncthreads();
  }

  if (!row_ok) return;
  l = fmaxf(l, 1e-30f);
  float* out = static_cast<float*>(a.o);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int d = t4 + 4 * i;
    if (d < a.D) out[row * a.D + d] = acc[i] / l;
  }
  if (t4 == 0) a.lse[row] = m + logf(l);
}

cudaError_t launch_f32(const Args& a, cudaStream_t stream) {
  const int bq = kRowsF / a.G;
  dim3 grid((a.S + bq - 1) / bq, a.K, a.B);
  fa_fwd_f32_kernel<<<grid, kThreadsF, 0, stream>>>(a);
  return cudaGetLastError();
}

Args make_args(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int S, int T, int K, int G, int D,
               float scale, int causal, int window) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse = static_cast<float*>(lse);
  a.B = B;
  a.S = S;
  a.T = T;
  a.K = K;
  a.G = G;
  a.D = D;
  a.scale = scale;
  a.causal = causal;
  a.window = window;
  return a;
}

}  // namespace

// The Python wrapper checks shapes, dtypes, contiguity, alignment and the
// limits below before calling: bf16 needs D % 8 == 0, D <= 128, G <= 64;
// fp32 needs D <= 128, G <= 32.
extern "C" int fa_fwd_bf16(const void* q, const void* k, const void* v,
                           void* o, void* lse, int B, int S, int T, int K,
                           int G, int D, float scale, int causal, int window,
                           void* stream) {
  const Args a = make_args(q, k, v, o, lse, B, S, T, K, G, D, scale, causal,
                           window);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(D <= 64 ? launch_bf16<64>(a, st)
                                  : launch_bf16<128>(a, st));
}

extern "C" int fa_fwd_f32(const void* q, const void* k, const void* v,
                          void* o, void* lse, int B, int S, int T, int K,
                          int G, int D, float scale, int causal, int window,
                          void* stream) {
  const Args a = make_args(q, k, v, o, lse, B, S, T, K, G, D, scale, causal,
                           window);
  return static_cast<int>(launch_f32(a, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* fa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
