// Chunkwise mLSTM forward (B4) for Hopper, sm_90a.
//
// Replaces repro/kernels/mlstm.py::_mlstm_kernel (the Pallas TPU kernel
// behind repro.kernels.ops.mlstm) and computes the same function: per
// (batch, head), walking the sequence in chunks of Q steps and carrying the
// matrix memory C (D x D), the normaliser n (D) and the stabiliser m in fp32,
//
//   F      = cumsum(log_sigmoid(f))                       (Q)
//   m_row  = max(F + m_prev, max_{t<=s} F_s - F_t + i_t)   (Q)
//   a[s,t] = (q_s . k_t / sqrt(D)) exp(F_s - F_t + i_t - m_row_s), t <= s
//   num    = a v + exp(F + m_prev - m_row) (q C)
//   den    = rowsum(a) + exp(F + m_prev - m_row) (q . n)
//   h      = num / max(|den|, exp(-m_row))
//   m_new  = max(F_Q + m_prev, max_t i_t + F_Q - F_t)
//   C      = exp(F_Q + m_prev - m_new) C + sum_t exp(i_t + F_Q - F_t - m_new)
//                                              (k_t / sqrt(D)) v_t^T
//   n      likewise with k_t alone; m starts at -1e30, C and n at 0.
// Every product is fp32 on the CUDA cores (no TF32: the reference's
// preferred_element_type=f32 and the 1e-4 / 2e-5 tolerances rule it out);
// bf16 / fp16 inputs are upcast at load and h is written in q's dtype.
//
// Layouts (contiguous): q, k, v, h (B, S, H, D); gates i, f (B, S, H) fp32.
// S % Q == 0 (the wrapper raises otherwise, as mlstm.py:100 asserts).
//
// What bounds it on an H100. At the xlstm-350m width (B=8, S=2048, H=4,
// D=512) the function needs at least B*H*S*(4*D^2 + 8*D) = 6.9e10 FLOP,
// its work at chunk 1 (the recurrent form: q C and the rank-one update of
// C each step), 1.03 ms at the fp32 CUDA-core peak of 67 TFLOP/s, against
// 5.4e8 bytes of q, k, v, h in fp32 (0.16 ms at 3.35 TB/s): it is bound by
// the fp32 operations. At a chunk of Q the causal q k^T and a v pairs
// take 2*(Q+1)*D per step in place of 4*D (1.09 ms at Q = 64, 1.16 ms at
// Q = 128). The design:
//
//  * The state does not fit a block: C is D*D*4 = 1 MiB per (b, h) at
//    D = 512, over the 227 KB of shared memory a block may hold. C is split
//    into column blocks of VB = 32 value columns: one CUDA block per
//    (b, h, column block) keeps its D x 32 slice of C (72 KB, rows padded)
//    in shared memory for the whole walk over the sequence. F, m, n, the row
//    stabilisers and the denominator do not depend on the value column, so
//    each of the D/32 blocks of a head recomputes them (n's update and
//    q . n are D-long dot products, small beside the D x 32 ones).
//  * The chunk's scores q k^T (Q x Q x D) would be D/32-fold redundant the
//    same way (16-fold at D = 512), so a first kernel (mlstm_scores) computes
//    them once per chunk, lower-triangular 64 x 64 tiles only, into an fp32
//    scratch (B*H, S/Q, Q, Q) that the second kernel (mlstm_chunk) reads:
//    33.5 MB at the full width and Q = 128, mostly from L2.
//  * q, k tiles do not fit either (Q x D fp32 is 512 KiB at Q = 256): the
//    chunk kernel streams q in tiles of 2048 elements (all Q rows, held
//    transposed) for q C, and k in tiles of 4 steps x 512 rows for the
//    state update, each double-buffered (fp32 through cp.async, so the next
//    tile is in flight while the current one is used); a comes in tiles of
//    32 steps. Only v's 32-column slice of the chunk (Q x 32) stays
//    resident beside C.
//  * Both D x 32 products are register-tiled (see the chunk kernel's
//    comment): each shared-memory load feeds 4 to 16 FMAs. Blocks are
//    capped at 128 registers a thread for Q <= 128, so two fit an SM.
//  * The sequence stays sequential inside the block (the TPU grid's minor
//    axis): the output of a chunk reads C before the chunk's update, with a
//    barrier between the two.
// Still SIMT, at several times the fp32 bound: every column block of a head
// reloads the head's q and k (16-fold at D = 512) and recomputes its gates.
// Tensor-core fp32 emulation (3xTF32), or C split across a thread-block
// cluster that shares the q and k tiles, are later work.
//
// C entry points return cudaGetLastError() after the launches; they launch
// on the given stream and do not synchronise.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "attention_common.cuh"   // cp.async helpers

namespace {

constexpr int kThreads = 256;
constexpr int kVB = 32;        // value columns per chunk-kernel block
constexpr int kTile = 64;      // score tile of the scores kernel
constexpr int kDK = 16;        // depth per step of the scores kernel

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
__device__ __forceinline__ void from_f32(__half* p, float x) {
  *p = __float2half(x);
}

// jax.nn.log_sigmoid(x) = -softplus(-x)
__device__ __forceinline__ float log_sigmoid(float x) {
  return -(log1pf(expf(-fabsf(x))) + fmaxf(-x, 0.f));
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ig;
  const float* fg;
  void* h;
  float* scores;   // (B*H, NC, Q, Q), lower-triangular tiles written
  int B, S, H, D, Q;
  float scale;
};

// ------------------------------------------------------------ scores kernel
// scores[bh, c, s, t] = scale * q_{cQ+s} . k_{cQ+t} for the 64 x 64 tiles
// with t-tile <= s-tile. grid (tile pairs, S/Q, B*H); 16 x 16 threads, each
// a 4 x 4 patch.
template <typename T>
__global__ void __launch_bounds__(kThreads) mlstm_scores_kernel(Args a) {
  __shared__ __align__(16) float sQ[kDK][kTile + 4];
  __shared__ __align__(16) float sK[kDK][kTile + 4];
  int si = 0, ti = blockIdx.x;                 // linear -> (si, ti <= si)
  while (ti > si) { ti -= si + 1; ++si; }
  const int c = blockIdx.y, bh = blockIdx.z;
  const int b = bh / a.H, hh = bh % a.H;
  const int NC = a.S / a.Q;
  const int base = c * a.Q;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int s0 = si * kTile, t0 = ti * kTile;

  float acc[4][4] = {};
  for (int e0 = 0; e0 < a.D; e0 += kDK) {
#pragma unroll
    for (int i = 0; i < (kTile * kDK) / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int row = idx / kDK, e = idx % kDK;
      const bool ok_e = e0 + e < a.D;
      const int s = s0 + row, t = t0 + row;
      sQ[e][row] = (ok_e && s < a.Q)
          ? to_f32(q[((size_t)(b * a.S + base + s) * a.H + hh) * a.D + e0 + e])
          : 0.f;
      sK[e][row] = (ok_e && t < a.Q)
          ? to_f32(k[((size_t)(b * a.S + base + t) * a.H + hh) * a.D + e0 + e])
          : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kDK; ++kk) {
      const float4 qa = *reinterpret_cast<const float4*>(&sQ[kk][ty * 4]);
      const float4 kb = *reinterpret_cast<const float4*>(&sK[kk][tx * 4]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[4] = {kb.x, kb.y, kb.z, kb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(qv[i], kv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* out = a.scores + ((size_t)bh * NC + c) * a.Q * a.Q;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = s0 + ty * 4 + i;
    if (s >= a.Q) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = t0 + tx * 4 + j;
      if (t < a.Q) out[(size_t)s * a.Q + t] = acc[i][j] * a.scale;
    }
  }
}

// ------------------------------------------------------------- chunk kernel
// One block per (value-column block, b*H + h), walking all S/Q chunks.
// Per chunk, with QP = 32 * RPT >= Q padded rows:
//   outputs (Q x 32): thread (rg = tid / 8, cg = tid % 8) owns rows
//     rg*RPT .. rg*RPT+RPT-1 and columns cg*4 .. cg*4+3, register-tiled:
//     a v streams a in 32-step tiles, q C streams q in tiles of QE = 64/RPT
//     columns held transposed, so one float4 of C and RPT values of q feed
//     4*RPT FMAs;
//   state (D x 32): thread (eg = tid % 64, sg = tid / 64) owns rows
//     eg*4 .. eg*4+3 and 256+eg*4 .. 256+eg*4+3 (of each 512-row pass; two
//     float4 that neighbouring threads read from neighbouring addresses)
//     and columns sg*8 .. sg*8+7: 64 accumulators over k tiles of 4 steps.
struct Smem {
  float* C;     // [D][CS]      the block's columns of C (padded rows)
  float* v;     // [QP][VB]     v of the chunk, the block's columns
  float* n;     // [D]
  float* u;     // union: a tile [QP][TT+1] | 2 q tiles [QE][QP+4] |
                //        2 k tiles [KT][KE+4]
  float* ig;    // [QP]
  float* F;     // [QP]
  float* mrow;  // [QP]
  float* ws;    // [QP]         exp(F + m_prev - m_row)
  float* inw;   // [QP]         exp(i + F_Q - F - m_new) * scale
  float* qn;    // [QP]         q . n per row
  float* misc;  // [4]          m_prev, m_new, carry_w
};

constexpr int kCS = kVB + 4;   // row stride of C in shared memory
constexpr int kTT = 32;        // steps per a tile
constexpr int kQE = 8;         // q columns per q tile at Q = 256 (QE = 64/RPT)
constexpr int kKT = 4;         // steps per k tile
constexpr int kKE = 512;       // state rows per pass

// One element of a T matrix into fp32 shared memory (0 where !pred). fp32
// goes through cp.async (4 bytes, no register, completes at the next
// cp_async_wait); other types load, convert and store synchronously.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, bool pred) {
  if constexpr (sizeof(T) == 4) {
    attn::cp_async4(dst, src, pred);
  } else {
    *dst = pred ? to_f32(*src) : 0.f;
  }
}

__host__ __device__ inline int padded_rows(int Q) {
  return Q <= 32 ? 32 : Q <= 64 ? 64 : Q <= 128 ? 128 : 256;
}

__host__ __device__ inline size_t union_floats(int QP) {
  const size_t a = (size_t)QP * (kTT + 1);
  const size_t qt = 2 * (size_t)(kQE * 256 / QP) * (QP + 4);   // 2 buffers
  const size_t kt = 2 * (size_t)kKT * (kKE + 4);
  size_t m = a > qt ? a : qt;
  return m > kt ? m : kt;
}

__host__ __device__ inline size_t chunk_smem_floats(int D, int Q) {
  const int QP = padded_rows(Q);
  return (size_t)D * kCS + (size_t)QP * kVB + D + union_floats(QP) + 3 +
         6 * (size_t)QP + 4;
}

__device__ inline Smem carve(float* p, int D, int QP) {
  Smem m;
  m.C = p;      p += (size_t)D * kCS;    // sizes keep float4 alignment
  m.v = p;      p += (size_t)QP * kVB;
  m.u = p;      p += union_floats(QP) + 3 & ~(size_t)3;
  m.n = p;      p += D;
  m.ig = p;     p += QP;
  m.F = p;      p += QP;
  m.mrow = p;   p += QP;
  m.ws = p;     p += QP;
  m.inw = p;    p += QP;
  m.qn = p;     p += QP;
  m.misc = p;
  return m;
}

template <int N>
__device__ __forceinline__ void ld_vec(float* out, const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(p + i);
      out[i] = x.x; out[i + 1] = x.y; out[i + 2] = x.z; out[i + 3] = x.w;
    }
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x; out[1] = x.y;
  } else {
    out[0] = p[0];
  }
}

template <typename T, int RPT>
__global__ void __launch_bounds__(kThreads, RPT < 8 ? 2 : 1)
mlstm_chunk_kernel(Args a) {
  constexpr int QP = 32 * RPT;
  constexpr int QE = kQE * 8 / RPT;            // q tiles of QP x QE = 2048
  extern __shared__ __align__(16) float smem[];
  const Smem sm = carve(smem, a.D, QP);
  const int j0 = blockIdx.x * kVB;
  const int bh = blockIdx.y, b = bh / a.H, hh = bh % a.H;
  const int D = a.D, Q = a.Q, NC = a.S / Q;
  const int tid = threadIdx.x;
  const int rg = tid >> 3, cg = tid & 7;       // outputs
  const int eg = tid & 63, sg = tid >> 6;      // state update
  const int r0 = rg * RPT;
  // this (b, hh)'s rows: element (s, e) at [s * rs + e], 32-bit offsets
  // (the wrapper checks S * H * D < 2^31)
  const size_t head = (size_t)b * a.S * a.H * D + (size_t)hh * D;
  const int rs = a.H * D;
  const T* q = static_cast<const T*>(a.q) + head;
  const T* k = static_cast<const T*>(a.k) + head;
  const T* v = static_cast<const T*>(a.v) + head;
  T* h = static_cast<T*>(a.h) + head;

  for (int i = tid; i < D * kCS; i += kThreads) sm.C[i] = 0.f;
  for (int i = tid; i < D; i += kThreads) sm.n[i] = 0.f;
  for (int i = tid; i < QP * kVB; i += kThreads) sm.v[i] = 0.f;
  if (tid == 0) sm.misc[0] = -1e30f;           // m
  __syncthreads();

  for (int c = 0; c < NC; ++c) {
    const int base = c * Q;
    // ---- gates: F, row stabilisers, state weights
    for (int t = tid; t < Q; t += kThreads) {
      const size_t g = (size_t)(b * a.S + base + t) * a.H + hh;
      sm.ig[t] = a.ig[g];
      sm.F[t] = log_sigmoid(a.fg[g]);
    }
    __syncthreads();
    if (tid == 0) {
      const float m_prev = sm.misc[0];
      float F = 0.f, pm = -INFINITY;
      for (int t = 0; t < Q; ++t) {            // cumsum, running max
        F += sm.F[t];
        sm.F[t] = F;
        pm = fmaxf(pm, sm.ig[t] - F);
        sm.mrow[t] = fmaxf(F + m_prev, F + pm);
      }
      float m_in = -INFINITY;
      for (int t = 0; t < Q; ++t) m_in = fmaxf(m_in, sm.ig[t] + F - sm.F[t]);
      const float m_new = fmaxf(F + m_prev, m_in);
      sm.misc[1] = m_new;
      sm.misc[2] = expf(F + m_prev - m_new);   // carry weight
    }
    __syncthreads();
    const float m_prev = sm.misc[0], m_new = sm.misc[1];
    const float Ftot = sm.F[Q - 1];
    for (int t = tid; t < Q; t += kThreads) {
      sm.ws[t] = expf(sm.F[t] + m_prev - sm.mrow[t]);
      sm.inw[t] = expf(sm.ig[t] + Ftot - sm.F[t] - m_new) * a.scale;
    }
    {                                          // v: all loads, then stores
      float buf[QP * kVB / kThreads];
#pragma unroll
      for (int m = 0; m < QP * kVB / kThreads; ++m) {
        const int i = tid + m * kThreads, t = i / kVB, jj = i % kVB;
        buf[m] = (t < Q && j0 + jj < D)
            ? to_f32(v[(base + t) * rs + j0 + jj]) : 0.f;
      }
#pragma unroll
      for (int m = 0; m < QP * kVB / kThreads; ++m)
        sm.v[tid + m * kThreads] = buf[m];
    }
    __syncthreads();

    // ---- outputs from the C of the previous chunk
    float num[RPT][4] = {}, inter[RPT][4] = {}, rsum[RPT] = {};
    const float* S_c = a.scores + ((size_t)bh * NC + c) * Q * Q;
    constexpr int lda = kTT + 1;
    for (int t0 = 0; t0 < Q; t0 += kTT) {      // intra: a v, 32 steps a tile
      float buf[QP * kTT / kThreads];          // all loads, then stores
#pragma unroll
      for (int m = 0; m < QP * kTT / kThreads; ++m) {
        const int i = tid + m * kThreads, r = i / kTT, t = t0 + i % kTT;
        buf[m] = (r < Q && t <= r) ? S_c[(size_t)r * Q + t] : 0.f;
      }
#pragma unroll
      for (int m = 0; m < QP * kTT / kThreads; ++m) {
        const int i = tid + m * kThreads, r = i / kTT, t = t0 + i % kTT;
        sm.u[r * lda + i % kTT] = (r < Q && t <= r)
            ? buf[m] * expf(sm.F[r] - sm.F[t] + sm.ig[t] - sm.mrow[r]) : 0.f;
      }
      __syncthreads();
      if (r0 + RPT - 1 >= t0) {                // rows above the tile: all 0
        const int nt = min(kTT, Q - t0);
        for (int t = 0; t < nt; ++t) {
          float vv[4];
          ld_vec<4>(vv, &sm.v[(t0 + t) * kVB + cg * 4]);
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            const float x = sm.u[(r0 + i) * lda + t];
            rsum[i] += x;
#pragma unroll
            for (int j = 0; j < 4; ++j) num[i][j] = fmaf(x, vv[j], num[i][j]);
          }
        }
      }
      __syncthreads();
    }
    constexpr int ldq = QP + 4;
    constexpr int qbuf = QE * ldq;
    // q tile e0 (QP rows x QE columns) into buffer `bf`, held transposed
    auto stage_q = [&](int e0, int bf) {
#pragma unroll
      for (int m = 0; m < QP * QE / kThreads; ++m) {
        const int i = tid + m * kThreads, r = i / QE, e = i % QE;
        const bool ok = r < Q && e0 + e < D;
        stage(&sm.u[bf * qbuf + e * ldq + r],
              q + (ok ? (base + r) * rs + e0 + e : 0), ok);
      }
      attn::cp_async_commit();
    };
    float qn = 0.f;                            // row tid's q . n
    stage_q(0, 0);
    for (int e0 = 0, bf = 0; e0 < D; e0 += QE, bf ^= 1) {   // inter: q C
      if (e0 + QE < D) {                       // next tile in flight
        stage_q(e0 + QE, bf ^ 1);
        attn::cp_async_wait<1>();
      } else {
        attn::cp_async_wait<0>();
      }
      __syncthreads();
      const float* qt = sm.u + bf * qbuf;
      const int ne = min(QE, D - e0);
      if (tid < Q)
        for (int e = 0; e < ne; ++e)
          qn = fmaf(qt[e * ldq + tid], sm.n[e0 + e], qn);
      for (int e = 0; e < ne; ++e) {
        float qv[RPT], cc[4];
        ld_vec<RPT>(qv, &qt[e * ldq + r0]);
        ld_vec<4>(cc, &sm.C[(e0 + e) * kCS + cg * 4]);
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            inter[i][j] = fmaf(qv[i], cc[j], inter[i][j]);
      }
      __syncthreads();
    }
    if (tid < Q) sm.qn[tid] = qn;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int s = r0 + i;
      if (s >= Q) continue;
      const float w = sm.ws[s];
      const float den = rsum[i] + w * sm.qn[s];
      const float inv = 1.f / fmaxf(fabsf(den), expf(-sm.mrow[s]));
      T* out = h + (size_t)(base + s) * rs;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = j0 + cg * 4 + j;
        if (col < D) from_f32(out + col, (num[i][j] + w * inter[i][j]) * inv);
      }
    }

    // ---- state update: C = carry C + (k * in_w)^T v, n likewise
    const float carry = sm.misc[2];
    constexpr int ldk = kKE + 4;
    constexpr int kbuf = kKT * ldk;
    for (int e0 = 0; e0 < D; e0 += kKE) {
      const int ne = min(kKE, D - e0);
      // k tile t0 (KT steps x KE rows) into buffer `bf`
      auto stage_k = [&](int t0, int bf) {
#pragma unroll
        for (int m = 0; m < kKT * kKE / kThreads; ++m) {
          const int i = tid + m * kThreads, t = i / kKE, e = i % kKE;
          const bool ok = t0 + t < Q && e < ne;
          stage(&sm.u[bf * kbuf + t * ldk + e],
                k + (ok ? (base + t0 + t) * rs + e0 + e : 0), ok);
        }
        attn::cp_async_commit();
      };
      float acc[8][8] = {}, nacc[8] = {};
      stage_k(0, 0);
      for (int t0 = 0, bf = 0; t0 < Q; t0 += kKT, bf ^= 1) {
        if (t0 + kKT < Q) {                    // next tile in flight
          stage_k(t0 + kKT, bf ^ 1);
          attn::cp_async_wait<1>();
        } else {
          attn::cp_async_wait<0>();
        }
        __syncthreads();
        const float* kt = sm.u + bf * kbuf;
        const int nt = min(kKT, Q - t0);
        for (int t = 0; t < nt; ++t) {
          float kv[8], vv[8];
          const float w = sm.inw[t0 + t];      // exp(...) * scale of step t
          ld_vec<4>(kv, &kt[t * ldk + eg * 4]);
          ld_vec<4>(kv + 4, &kt[t * ldk + kKE / 2 + eg * 4]);
          ld_vec<8>(vv, &sm.v[(t0 + t) * kVB + sg * 8]);
#pragma unroll
          for (int j = 0; j < 8; ++j) vv[j] *= w;
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            nacc[r] = fmaf(kv[r], w, nacc[r]);
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(kv[r], vv[j], acc[r][j]);
          }
        }
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int e = e0 + (r < 4 ? eg * 4 + r : kKE / 2 + eg * 4 + r - 4);
        if (e >= D) continue;
        float4* Cr = reinterpret_cast<float4*>(sm.C + e * kCS + sg * 8);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float4 x = Cr[j];
          x.x = fmaf(carry, x.x, acc[r][4 * j]);
          x.y = fmaf(carry, x.y, acc[r][4 * j + 1]);
          x.z = fmaf(carry, x.z, acc[r][4 * j + 2]);
          x.w = fmaf(carry, x.w, acc[r][4 * j + 3]);
          Cr[j] = x;
        }
        if (sg == 0) sm.n[e] = carry * sm.n[e] + nacc[r];
      }
    }
    if (tid == 0) sm.misc[0] = m_new;
    __syncthreads();
  }
}

template <typename T, int RPT>
cudaError_t launch_chunk(const Args& a, cudaStream_t st) {
  const size_t smem = chunk_smem_floats(a.D, a.Q) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_chunk_kernel<T, RPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  mlstm_chunk_kernel<T, RPT><<<dim3((a.D + kVB - 1) / kVB, a.B * a.H),
                               kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args& a, cudaStream_t st) {
  const int NC = a.S / a.Q;
  const int nt = (a.Q + kTile - 1) / kTile;
  mlstm_scores_kernel<T><<<dim3(nt * (nt + 1) / 2, NC, a.B * a.H), kThreads,
                           0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  switch (padded_rows(a.Q)) {
    case 32: return launch_chunk<T, 1>(a, st);
    case 64: return launch_chunk<T, 2>(a, st);
    case 128: return launch_chunk<T, 4>(a, st);
    default: return launch_chunk<T, 8>(a, st);
  }
}

Args make_args(const void* q, const void* k, const void* v, const float* ig,
               const float* fg, void* h, float* scores, int B, int S, int H,
               int D, int Q, float scale) {
  Args a;
  a.q = q; a.k = k; a.v = v; a.ig = ig; a.fg = fg; a.h = h;
  a.scores = scores;
  a.B = B; a.S = S; a.H = H; a.D = D; a.Q = Q; a.scale = scale;
  return a;
}

}  // namespace

#define MLSTM_ENTRY(NAME, TYPE)                                              \
  extern "C" int NAME(const void* q, const void* k, const void* v,          \
                      const float* ig, const float* fg, void* h,            \
                      float* scores, int B, int S, int H, int D, int Q,     \
                      float scale, void* stream) {                          \
    return static_cast<int>(launch<TYPE>(                                   \
        make_args(q, k, v, ig, fg, h, scores, B, S, H, D, Q, scale),        \
        static_cast<cudaStream_t>(stream)));                                \
  }

MLSTM_ENTRY(mlstm_fwd_f32, float)
MLSTM_ENTRY(mlstm_fwd_bf16, __nv_bfloat16)
MLSTM_ENTRY(mlstm_fwd_f16, __half)

// Bytes of dynamic shared memory the chunk kernel needs (the wrapper checks
// it against the card's limit before a launch).
extern "C" long long mlstm_smem_bytes(int D, int Q) {
  return (long long)(chunk_smem_floats(D, Q) * sizeof(float));
}

extern "C" const char* mlstm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
