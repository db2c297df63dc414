// Flash-attention backward (B2: dq, B3: dk and dv) for Hopper, sm_90a.
//
// Replaces repro/kernels/flash_attention_bwd.py::_dq_kernel (B2) and
// ::_dkv_kernel (B3), the Pallas TPU kernels behind
// repro.kernels.ops.flash_attention_fused, and computes the same function.
// From the forward's saved LSE and delta = rowsum(dO * O) (fp32, computed by
// the caller, as the reference computes it outside its kernels), for every
// visible (query, key) pair:
//   p  = exp(s * scale - lse),  s = q . k
//   ds = p * (dO . v - delta) * scale
//   dq = sum_k ds k,   dk = sum_q ds q,   dv = sum_q p dO
// with dk and dv summed over the G query heads of each kv head. Masks are
// causal, sliding window and kv_len (= T); a masked p is exactly 0.
//
// Layouts (contiguous): q, dO, dq (B, S, K, G, D); k, v, dk, dv (B, T, K, D);
// lse, delta (B, S, K, G) fp32. Query head (k, g) reads kv head k. Rows of
// the query side are flattened (position, head) pairs of one kv head: row f
// is position f / G, head f % G, so a tile of rows covers all G heads and any
// G is taken.
//
// What bounds them on an H100. At the train shape (B=4, S=T=2048, 16 q heads
// over 8 kv heads, D=128, bf16, causal: 2,098,176 visible pairs per
// (batch, head)) B2 runs three products per pair (S, dP, dQ: 6*D FLOP),
// 1.03e11 FLOP, 0.104 ms at 989 TFLOP/s, and moves q, k, v, dO, lse, delta
// and dq once, about 135 MB, 0.040 ms at 3.35 TB/s. B3 runs four (S, dP, dV,
// dK: 8*D FLOP), 1.38e11 FLOP, 0.139 ms, and moves about 135 MB. Both are
// bound by the tensor cores, so the design
//   * never writes a score, probability or dS to device memory: each is
//     recomputed tile by tile in registers from q, k and the saved LSE;
//   * runs every product on the tensor cores (mma.sync m16n8k16, bf16 in,
//     fp32 accumulate), handing P and dS from the accumulators straight to
//     the A operand of the next product, as B1 hands P to P V;
//   * B2: one block owns 64 flattened query rows of one (batch, kv head), so
//     a K/V tile (double-buffered with cp.async) is read once for the group;
//     the kv loop is clipped to the visible range and the longest causal
//     blocks launch first;
//   * B3: one block owns 64 kv rows of one (batch, kv head) and walks the
//     flattened query rows of all G heads, so the group sum happens in the
//     block, in fp32 registers, with no atomics: the result does not depend
//     on the order blocks run in. The query walk is clipped (from the tile's
//     first key when causal, up to the last key + window - 1, up to S);
//   * masks per element only on tiles that straddle the diagonal, the window
//     edge or the end of the rows.
// Where it rounds: the reference keeps p and ds in fp32 for p^T dO, ds^T q
// and ds k. Here p and ds are rounded to bf16 (round to nearest) as the A
// operand of those three products; every sum is fp32 and dq, dk, dv are
// rounded to the inputs' dtype once, at the end.
// Registers: B3 keeps two fp32 64x D accumulators (dk, dv) across four warps,
// 128 registers a thread at D = 128, besides the S and dP fragments of a
// 32-row query tile; ptxas's report (chip_smoke.py prints it) says whether
// that spills.
// wgmma, TMA and warp specialisation are left for a later change.
//
// fp32 inputs take separate SIMT kernels (fp32 FMA, no tensor cores), so an
// fp32 caller gets fp32 products and not TF32.
//
// C entry points return cudaGetLastError() after the launch; they launch on
// the given stream and do not synchronise.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace {

using namespace attn;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* out0;   // dq (B2) or dk (B3)
  void* out1;   // dv (B3)
  int B, S, T, K, G, D;
  float scale;
  int causal;
  int window;   // <= 0: no window
};

// Index of flattened query row f of (b, kv head kh) in a (B, S, K, G) array.
__device__ __forceinline__ size_t qrow(const Args& a, int b, int kh, int f) {
  return (((size_t)b * a.S + f / a.G) * a.K + kh) * a.G + f % a.G;
}

// Index of key position t of (b, kh) in a (B, T, K) array.
__device__ __forceinline__ size_t krow(const Args& a, int b, int kh, int t) {
  return ((size_t)b * a.T + t) * a.K + kh;
}

// Query rows [f0, f0 + rows) of one block (B2): its visible kv range.
struct QTile {
  int f0, f_end, kv_lo, kv_hi;
};

__device__ __forceinline__ QTile q_tile(const Args& a, int rows) {
  QTile t;
  t.f0 = (gridDim.x - 1 - blockIdx.x) * rows;       // longest causal first
  t.f_end = min(t.f0 + rows, a.S * a.G);
  const int p_first = t.f0 / a.G, p_last = (t.f_end - 1) / a.G;
  t.kv_hi = a.causal ? min(a.T, p_last + 1) : a.T;
  t.kv_lo = a.window > 0 ? max(0, p_first - a.window + 1) : 0;
  return t;
}

// Key rows [k0, k0 + rows) of one block (B3): the flattened query rows that
// can see one of them.
struct KTile {
  int k0, k_last, f_lo, f_hi;
};

__device__ __forceinline__ KTile k_tile(const Args& a, int rows) {
  KTile t;
  t.k0 = blockIdx.x * rows;                         // longest causal first
  t.k_last = min(t.k0 + rows, a.T) - 1;
  const int p_lo = a.causal ? t.k0 : 0;
  const int p_hi = a.window > 0 ? min(a.S, t.k_last + a.window) : a.S;
  t.f_lo = p_lo * a.G;
  t.f_hi = max(t.f_lo, p_hi * a.G);
  return t;
}

// Every (query row, key) pair of query positions [p0, p1] and keys
// [k0, k0 + n) is visible (the keys lie inside T).
__device__ __forceinline__ bool pairs_unmasked(const Args& a, int p0, int p1,
                                               int k0, int n) {
  bool ok = k0 + n <= a.T;
  if (a.causal) ok = ok && k0 + n - 1 <= p0;
  if (a.window > 0) ok = ok && k0 > p1 - a.window;
  return ok;
}

// ------------------------------------------------------------------ bf16 path

constexpr int kWarps = 4;          // 16 rows each
constexpr int kThreads = kWarps * 32;
constexpr int kRowsQ = 64;         // B2: flattened query rows per block
constexpr int kBN = 64;            // B2: kv rows per tile
constexpr int kRowsK = 64;         // B3: kv rows per block
constexpr int kBQ = 32;            // B3: flattened query rows per tile

template <int DP>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_bf16_kernel(Args a) {
  constexpr int LD = DP + 8;               // padding: conflict-free fragments
  constexpr int KSTEPS = DP / 16;          // k-steps of S = Q K^T, dP = dO V^T
  constexpr int NT_S = kBN / 8;            // n-tiles of S and dP
  constexpr int NT_O = DP / 8;             // n-tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sdO = sQ + kRowsQ * LD;
  __nv_bfloat16* sK = sdO + kRowsQ * LD;   // [2][kBN][LD]
  __nv_bfloat16* sV = sK + 2 * kBN * LD;   // [2][kBN][LD]

  const int kh = blockIdx.y, b = blockIdx.z;
  const QTile t = q_tile(a, kRowsQ);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g4 = lane / 4, t4 = lane % 4;   // mma fragment coordinates

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v);
  const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(a.dout);

  auto q_loader = [&](const __nv_bfloat16* base) {
    return [=](int r) -> const __nv_bfloat16* {
      const int f = t.f0 + r;
      return f < t.f_end ? base + qrow(a, b, kh, f) * a.D : nullptr;
    };
  };
  auto kv_loader = [&](const __nv_bfloat16* base, int k0) {
    return [=](int r) -> const __nv_bfloat16* {
      const int s = k0 + r;
      return s < t.kv_hi ? base + krow(a, b, kh, s) * a.D : nullptr;
    };
  };

  const int n_tiles = t.kv_hi > t.kv_lo ? (t.kv_hi - t.kv_lo + kBN - 1) / kBN
                                        : 0;
  load_rows<DP, LD, kThreads>(sQ, kRowsQ, a.D, q, q_loader(q));
  load_rows<DP, LD, kThreads>(sdO, kRowsQ, a.D, dout, q_loader(dout));
  if (n_tiles > 0) {
    load_rows<DP, LD, kThreads>(sK, kBN, a.D, k, kv_loader(k, t.kv_lo));
    load_rows<DP, LD, kThreads>(sV, kBN, a.D, v, kv_loader(v, t.kv_lo));
  }
  cp_async_commit();

  // rows of this thread: r0 = 16*warp + g4 and r0 + 8. A row past the end
  // gets lse = +inf, so its p is exp2(-inf) = 0, and delta = 0.
  const int r0 = warp * 16 + g4;
  int qpos[2];
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = t.f0 + r0 + 8 * h;
    const bool ok = f < t.f_end;
    qpos[h] = f / a.G;
    lse2[h] = ok ? a.lse[qrow(a, b, kh, f)] * kLog2e : INFINITY;
    dlt[h] = ok ? a.delta[qrow(a, b, kh, f)] : 0.f;
  }
  const int p_first = t.f0 / a.G, p_last = (t.f_end - 1) / a.G;
  const float sl2 = a.scale * kLog2e;

  float acc[NT_O][4];
#pragma unroll
  for (int i = 0; i < NT_O; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

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

    const __nv_bfloat16* tK = sK + buf * kBN * LD;
    const __nv_bfloat16* tV = sV + buf * kBN * LD;

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x kBN columns
    float s[NT_S][4], dp[NT_S][4];
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      dp[nt][0] = dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t qa[4], da[4];
      load_a_frag(qa, sQ, LD, warp * 16, kk * 16, g4, t4);
      load_a_frag(da, sdO, LD, warp * 16, kk * 16, g4, t4);
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt) {
        const __nv_bfloat16* kr = tK + (nt * 8 + g4) * LD + kk * 16 + 2 * t4;
        const __nv_bfloat16* vr = tV + (nt * 8 + g4) * LD + kk * 16 + 2 * t4;
        mma16816(s[nt], qa, ld32(kr), ld32(kr + 8));
        mma16816(dp[nt], da, ld32(vr), ld32(vr + 8));
      }
    }

    // p = exp(s * scale - lse), masked to 0; dS = p (dP - delta) scale
    const bool full = pairs_unmasked(a, p_first, p_last, k0, kBN);
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int kpos = k0 + nt * 8 + 2 * t4 + (e & 1);
        const bool vis =
            full || visible(qpos[h], kpos, a.T, a.causal, a.window);
        const float p = vis ? exp2f(fmaf(s[nt][e], sl2, -lse2[h])) : 0.f;
        s[nt][e] = p * (dp[nt][e] - dlt[h]) * a.scale;
      }
    }

    // dQ += dS K: the dS accumulators of two n-tiles form one A fragment
#pragma unroll
    for (int ks = 0; ks < kBN / 16; ++ks) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * ks][0], s[2 * ks][1]);
      pa[1] = pack_bf16(s[2 * ks][2], s[2 * ks][3]);
      pa[2] = pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
      pa[3] = pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]);
      const __nv_bfloat16* kr =
          tK + (ks * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
      for (int dd = 0; dd < NT_O / 2; ++dd) {
        uint32_t kb[4];
        ldmatrix_x4_trans(kb, kr + dd * 16);
        mma16816(acc[2 * dd], pa, kb[0], kb[1]);
        mma16816(acc[2 * dd + 1], pa, kb[2], kb[3]);
      }
    }
    __syncthreads();   // this buffer is refilled two iterations on
  }
  cp_async_wait<0>();  // no tile visible: only Q and dO were in flight

  __nv_bfloat16* dq = static_cast<__nv_bfloat16*>(a.out0);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = t.f0 + r0 + 8 * h;
    if (f >= t.f_end) continue;
    __nv_bfloat16* row = dq + qrow(a, b, kh, f) * a.D;
#pragma unroll
    for (int i = 0; i < NT_O; ++i) {
      const int col = i * 8 + 2 * t4;
      if (col < a.D) {
        *reinterpret_cast<uint32_t*>(row + col) =
            pack_bf16(acc[i][2 * h], acc[i][2 * h + 1]);
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkv_bf16_kernel(Args a) {
  constexpr int LD = DP + 8;
  constexpr int KSTEPS = DP / 16;          // k-steps of S^T = K Q^T
  constexpr int NT_S = kBQ / 8;            // n-tiles of S^T and dP^T
  constexpr int NT_O = DP / 8;             // n-tiles of dK and dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sV = sK + kRowsK * LD;
  __nv_bfloat16* sQ = sV + kRowsK * LD;    // [2][kBQ][LD]
  __nv_bfloat16* sdO = sQ + 2 * kBQ * LD;  // [2][kBQ][LD]
  float* sLse = reinterpret_cast<float*>(sdO + 2 * kBQ * LD);   // [2][kBQ]
  float* sDelta = sLse + 2 * kBQ;                               // [2][kBQ]

  const int kh = blockIdx.y, b = blockIdx.z;
  const KTile t = k_tile(a, kRowsK);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g4 = lane / 4, t4 = lane % 4;

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(a.v);
  const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(a.dout);

  auto kv_row = [&](const __nv_bfloat16* base) {
    return [=](int r) -> const __nv_bfloat16* {
      const int s = t.k0 + r;
      return s < a.T ? base + krow(a, b, kh, s) * a.D : nullptr;
    };
  };
  auto q_loader = [&](const __nv_bfloat16* base, int f0) {
    return [=](int r) -> const __nv_bfloat16* {
      const int f = f0 + r;
      return f < t.f_hi ? base + qrow(a, b, kh, f) * a.D : nullptr;
    };
  };
  // lse and delta of a query tile, copied with the tile (a row past the end
  // reads 0 and is masked)
  auto load_stats = [&](int nb, int f0) {
    for (int r = threadIdx.x; r < kBQ; r += kThreads) {
      const int f = f0 + r;
      const bool ok = f < t.f_hi;
      const size_t i = ok ? qrow(a, b, kh, f) : 0;
      cp_async4(sLse + nb * kBQ + r, a.lse + i, ok);
      cp_async4(sDelta + nb * kBQ + r, a.delta + i, ok);
    }
  };

  const int n_tiles = (t.f_hi - t.f_lo + kBQ - 1) / kBQ;
  load_rows<DP, LD, kThreads>(sK, kRowsK, a.D, k, kv_row(k));
  load_rows<DP, LD, kThreads>(sV, kRowsK, a.D, v, kv_row(v));
  if (n_tiles > 0) {
    load_rows<DP, LD, kThreads>(sQ, kBQ, a.D, q, q_loader(q, t.f_lo));
    load_rows<DP, LD, kThreads>(sdO, kBQ, a.D, dout, q_loader(dout, t.f_lo));
    load_stats(0, t.f_lo);
  }
  cp_async_commit();

  // kv rows of this thread: 16*warp + g4 and + 8
  const int kr0 = warp * 16 + g4;
  const int kpos[2] = {t.k0 + kr0, t.k0 + kr0 + 8};
  const float sl2 = a.scale * kLog2e;

  float dk[NT_O][4], dv[NT_O][4];
#pragma unroll
  for (int i = 0; i < NT_O; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    const int f0 = t.f_lo + j * kBQ;
    if (j + 1 < n_tiles) {
      const int nb = buf ^ 1;
      load_rows<DP, LD, kThreads>(sQ + nb * kBQ * LD, kBQ, a.D, q,
                                  q_loader(q, f0 + kBQ));
      load_rows<DP, LD, kThreads>(sdO + nb * kBQ * LD, kBQ, a.D, dout,
                                  q_loader(dout, f0 + kBQ));
      load_stats(nb, f0 + kBQ);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const __nv_bfloat16* tQ = sQ + buf * kBQ * LD;
    const __nv_bfloat16* tdO = sdO + buf * kBQ * LD;
    const float* tLse = sLse + buf * kBQ;
    const float* tDelta = sDelta + buf * kBQ;

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 kv rows x kBQ query rows
    float st[NT_S][4], dpt[NT_S][4];
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
      st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.f;
      dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t ka[4], va[4];
      load_a_frag(ka, sK, LD, warp * 16, kk * 16, g4, t4);
      load_a_frag(va, sV, LD, warp * 16, kk * 16, g4, t4);
#pragma unroll
      for (int nt = 0; nt < NT_S; ++nt) {
        const __nv_bfloat16* qr = tQ + (nt * 8 + g4) * LD + kk * 16 + 2 * t4;
        const __nv_bfloat16* dr =
            tdO + (nt * 8 + g4) * LD + kk * 16 + 2 * t4;
        mma16816(st[nt], ka, ld32(qr), ld32(qr + 8));
        mma16816(dpt[nt], va, ld32(dr), ld32(dr + 8));
      }
    }

    // P^T (masked to 0) and dS^T = P^T (dP^T - delta) scale
    const int rows = min(kBQ, t.f_hi - f0);         // query rows in the tile
    const int p0 = f0 / a.G, p1 = (f0 + rows - 1) / a.G;
    const bool full =
        rows == kBQ && pairs_unmasked(a, p0, p1, t.k0, kRowsK);
#pragma unroll
    for (int nt = 0; nt < NT_S; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * t4 + (e & 1);    // query row in the tile
        const bool vis =
            full || (c < rows && visible((f0 + c) / a.G, kpos[e >> 1], a.T,
                                         a.causal, a.window));
        const float p =
            vis ? exp2f(fmaf(st[nt][e], sl2, -tLse[c] * kLog2e)) : 0.f;
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - tDelta[c]) * a.scale;
      }
    }

    // dV += P^T dO and dK += dS^T Q over the tile's query rows
#pragma unroll
    for (int ks = 0; ks < kBQ / 16; ++ks) {
      uint32_t pa[4], da[4];
      pa[0] = pack_bf16(st[2 * ks][0], st[2 * ks][1]);
      pa[1] = pack_bf16(st[2 * ks][2], st[2 * ks][3]);
      pa[2] = pack_bf16(st[2 * ks + 1][0], st[2 * ks + 1][1]);
      pa[3] = pack_bf16(st[2 * ks + 1][2], st[2 * ks + 1][3]);
      da[0] = pack_bf16(dpt[2 * ks][0], dpt[2 * ks][1]);
      da[1] = pack_bf16(dpt[2 * ks][2], dpt[2 * ks][3]);
      da[2] = pack_bf16(dpt[2 * ks + 1][0], dpt[2 * ks + 1][1]);
      da[3] = pack_bf16(dpt[2 * ks + 1][2], dpt[2 * ks + 1][3]);
      const int off = (ks * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
      for (int dd = 0; dd < NT_O / 2; ++dd) {
        uint32_t ob[4], qb[4];
        ldmatrix_x4_trans(ob, tdO + off + dd * 16);
        mma16816(dv[2 * dd], pa, ob[0], ob[1]);
        mma16816(dv[2 * dd + 1], pa, ob[2], ob[3]);
        ldmatrix_x4_trans(qb, tQ + off + dd * 16);
        mma16816(dk[2 * dd], da, qb[0], qb[1]);
        mma16816(dk[2 * dd + 1], da, qb[2], qb[3]);
      }
    }
    __syncthreads();   // this buffer is refilled two iterations on
  }
  cp_async_wait<0>();  // no query tile: only K and V were in flight

  __nv_bfloat16* dk_out = static_cast<__nv_bfloat16*>(a.out0);
  __nv_bfloat16* dv_out = static_cast<__nv_bfloat16*>(a.out1);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (kpos[h] >= a.T) continue;
    const size_t row = krow(a, b, kh, kpos[h]) * a.D;
#pragma unroll
    for (int i = 0; i < NT_O; ++i) {
      const int col = i * 8 + 2 * t4;
      if (col < a.D) {
        *reinterpret_cast<uint32_t*>(dk_out + row + col) =
            pack_bf16(dk[i][2 * h], dk[i][2 * h + 1]);
        *reinterpret_cast<uint32_t*>(dv_out + row + col) =
            pack_bf16(dv[i][2 * h], dv[i][2 * h + 1]);
      }
    }
  }
}

template <int DP>
cudaError_t launch_dq_bf16(const Args& a, cudaStream_t stream) {
  constexpr int LD = DP + 8;
  const int smem = (2 * kRowsQ + 4 * kBN) * LD * (int)sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dq_bf16_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.S * a.G + kRowsQ - 1) / kRowsQ, a.K, a.B);
  fa_bwd_dq_bf16_kernel<DP><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkv_bf16(const Args& a, cudaStream_t stream) {
  constexpr int LD = DP + 8;
  const int smem = (2 * kRowsK + 4 * kBQ) * LD * (int)sizeof(__nv_bfloat16) +
                   4 * kBQ * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dkv_bf16_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.T + kRowsK - 1) / kRowsK, a.K, a.B);
  fa_bwd_dkv_bf16_kernel<DP><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ fp32 path

constexpr int kRowsF = 32;     // rows per block, 4 threads per row
constexpr int kTileF = 32;     // rows of the walked tile
constexpr int kDPF = 128;      // D padded
constexpr int kThreadsF = kRowsF * 4;
constexpr int kPerF = kDPF / 4;   // dims per thread: d = t4 + 4*i

// Sum over the 4 lanes that share a row.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

__global__ void __launch_bounds__(kThreadsF)
fa_bwd_dq_f32_kernel(Args a) {
  __shared__ float sK[kTileF][kDPF];
  __shared__ float sV[kTileF][kDPF];

  const int kh = blockIdx.y, b = blockIdx.z;
  const QTile t = q_tile(a, kRowsF);
  const int r = threadIdx.x / 4, t4 = threadIdx.x % 4;
  const int f = t.f0 + r;
  const bool row_ok = f < t.f_end;
  const int qpos = f / a.G;
  const size_t row = row_ok ? qrow(a, b, kh, f) : 0;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);

  float qr[kPerF], dor[kPerF], acc[kPerF];
#pragma unroll
  for (int i = 0; i < kPerF; ++i) {
    const int d = t4 + 4 * i;
    const bool ok = row_ok && d < a.D;
    qr[i] = ok ? q[row * a.D + d] : 0.f;
    dor[i] = ok ? dout[row * a.D + d] : 0.f;
    acc[i] = 0.f;
  }
  const float lse = row_ok ? a.lse[row] : INFINITY;
  const float dlt = row_ok ? a.delta[row] : 0.f;

  for (int k0 = t.kv_lo; k0 < t.kv_hi; k0 += kTileF) {
    for (int c = threadIdx.x; c < kTileF * kDPF; c += kThreadsF) {
      const int rr = c / kDPF, d = c % kDPF;
      const int s = k0 + rr;
      const bool ok = s < t.kv_hi && d < a.D;
      const size_t off = krow(a, b, kh, s) * a.D + d;
      sK[rr][d] = ok ? k[off] : 0.f;
      sV[rr][d] = ok ? v[off] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTileF; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < kPerF; ++i) {
        s = fmaf(qr[i], sK[j][t4 + 4 * i], s);
        dp = fmaf(dor[i], sV[j][t4 + 4 * i], dp);
      }
      s = quad_sum(s);
      dp = quad_sum(dp);
      const bool vis = visible(qpos, k0 + j, a.T, a.causal, a.window);
      const float p = vis ? expf(s * a.scale - lse) : 0.f;
      const float ds = p * (dp - dlt) * a.scale;
#pragma unroll
      for (int i = 0; i < kPerF; ++i) acc[i] = fmaf(ds, sK[j][t4 + 4 * i], acc[i]);
    }
    __syncthreads();
  }

  if (!row_ok) return;
  float* dq = static_cast<float*>(a.out0);
#pragma unroll
  for (int i = 0; i < kPerF; ++i) {
    const int d = t4 + 4 * i;
    if (d < a.D) dq[row * a.D + d] = acc[i];
  }
}

__global__ void __launch_bounds__(kThreadsF)
fa_bwd_dkv_f32_kernel(Args a) {
  __shared__ float sQ[kTileF][kDPF];
  __shared__ float sdO[kTileF][kDPF];
  __shared__ float sLse[kTileF];
  __shared__ float sDelta[kTileF];

  const int kh = blockIdx.y, b = blockIdx.z;
  const KTile t = k_tile(a, kRowsF);
  const int r = threadIdx.x / 4, t4 = threadIdx.x % 4;
  const int kpos = t.k0 + r;
  const bool k_ok = kpos < a.T;
  const size_t row = k_ok ? krow(a, b, kh, kpos) : 0;
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);

  float kr[kPerF], vr[kPerF], dk[kPerF], dv[kPerF];
#pragma unroll
  for (int i = 0; i < kPerF; ++i) {
    const int d = t4 + 4 * i;
    const bool ok = k_ok && d < a.D;
    kr[i] = ok ? k[row * a.D + d] : 0.f;
    vr[i] = ok ? v[row * a.D + d] : 0.f;
    dk[i] = dv[i] = 0.f;
  }

  for (int f0 = t.f_lo; f0 < t.f_hi; f0 += kTileF) {
    for (int c = threadIdx.x; c < kTileF * kDPF; c += kThreadsF) {
      const int rr = c / kDPF, d = c % kDPF;
      const int f = f0 + rr;
      const bool ok = f < t.f_hi && d < a.D;
      const size_t off = ok ? qrow(a, b, kh, f) * a.D + d : 0;
      sQ[rr][d] = ok ? q[off] : 0.f;
      sdO[rr][d] = ok ? dout[off] : 0.f;
    }
    for (int rr = threadIdx.x; rr < kTileF; rr += kThreadsF) {
      const int f = f0 + rr;
      const bool ok = f < t.f_hi;
      sLse[rr] = ok ? a.lse[qrow(a, b, kh, f)] : INFINITY;
      sDelta[rr] = ok ? a.delta[qrow(a, b, kh, f)] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kTileF; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < kPerF; ++i) {
        s = fmaf(kr[i], sQ[j][t4 + 4 * i], s);
        dp = fmaf(vr[i], sdO[j][t4 + 4 * i], dp);
      }
      s = quad_sum(s);
      dp = quad_sum(dp);
      const bool vis = visible((f0 + j) / a.G, kpos, a.T, a.causal, a.window);
      const float p = vis ? expf(s * a.scale - sLse[j]) : 0.f;
      const float ds = p * (dp - sDelta[j]) * a.scale;
#pragma unroll
      for (int i = 0; i < kPerF; ++i) {
        dv[i] = fmaf(p, sdO[j][t4 + 4 * i], dv[i]);
        dk[i] = fmaf(ds, sQ[j][t4 + 4 * i], dk[i]);
      }
    }
    __syncthreads();
  }

  if (!k_ok) return;
  float* dk_out = static_cast<float*>(a.out0);
  float* dv_out = static_cast<float*>(a.out1);
#pragma unroll
  for (int i = 0; i < kPerF; ++i) {
    const int d = t4 + 4 * i;
    if (d < a.D) {
      dk_out[row * a.D + d] = dk[i];
      dv_out[row * a.D + d] = dv[i];
    }
  }
}

cudaError_t launch_dq_f32(const Args& a, cudaStream_t stream) {
  dim3 grid((a.S * a.G + kRowsF - 1) / kRowsF, a.K, a.B);
  fa_bwd_dq_f32_kernel<<<grid, kThreadsF, 0, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t launch_dkv_f32(const Args& a, cudaStream_t stream) {
  dim3 grid((a.T + kRowsF - 1) / kRowsF, a.K, a.B);
  fa_bwd_dkv_f32_kernel<<<grid, kThreadsF, 0, stream>>>(a);
  return cudaGetLastError();
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* out0, void* out1,
               int B, int S, int T, int K, int G, int D, float scale,
               int causal, int window) {
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.out0 = out0;
  a.out1 = out1;
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
// limits below before calling: bf16 needs D % 8 == 0 and D <= 128; fp32
// needs D <= 128. Every entry point takes the same arguments; dq (B2) writes
// out0 and ignores out1, dk and dv (B3) write out0 and out1.
typedef cudaError_t (*Launch)(const Args&, cudaStream_t);

static int run(Launch launch, const void* q, const void* k, const void* v,
               const void* dout, const void* lse, const void* delta,
               void* out0, void* out1, int B, int S, int T, int K, int G,
               int D, float scale, int causal, int window, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, out0, out1, B, S, T, K,
                           G, D, scale, causal, window);
  return static_cast<int>(launch(a, static_cast<cudaStream_t>(stream)));
}

extern "C" int fa_bwd_dq_bf16(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* out0, void* out1,
                              int B, int S, int T, int K, int G, int D,
                              float scale, int causal, int window,
                              void* stream) {
  return run(D <= 64 ? &launch_dq_bf16<64> : &launch_dq_bf16<128>, q, k, v,
             dout, lse, delta, out0, out1, B, S, T, K, G, D, scale, causal,
             window, stream);
}

extern "C" int fa_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* out0, void* out1,
                               int B, int S, int T, int K, int G, int D,
                               float scale, int causal, int window,
                               void* stream) {
  return run(D <= 64 ? &launch_dkv_bf16<64> : &launch_dkv_bf16<128>, q, k, v,
             dout, lse, delta, out0, out1, B, S, T, K, G, D, scale, causal,
             window, stream);
}

extern "C" int fa_bwd_dq_f32(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* out0, void* out1,
                             int B, int S, int T, int K, int G, int D,
                             float scale, int causal, int window,
                             void* stream) {
  return run(launch_dq_f32, q, k, v, dout, lse, delta, out0, out1, B, S, T,
             K, G, D, scale, causal, window, stream);
}

extern "C" int fa_bwd_dkv_f32(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* out0, void* out1,
                              int B, int S, int T, int K, int G, int D,
                              float scale, int causal, int window,
                              void* stream) {
  return run(launch_dkv_f32, q, k, v, dout, lse, delta, out0, out1, B, S, T,
             K, G, D, scale, causal, window, stream);
}

extern "C" const char* fa_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
