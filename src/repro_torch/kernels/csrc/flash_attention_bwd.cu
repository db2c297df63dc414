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
// the query side are flattened (position, head) pairs of one kv head.
//
// What bounds them on an H100. At the train shape (B=4, S=T=2048, 16 q heads
// over 8 kv heads, D=128, bf16, causal: 2,098,176 visible pairs per
// (batch, head)) B2 runs three products per pair (S, dP, dQ: 6*D FLOP),
// 1.03e11 FLOP, 0.104 ms at 989 TFLOP/s, and moves q, k, v, dO, lse, delta
// and dq once, about 135 MB, 0.040 ms at 3.35 TB/s. B3 runs four (S, dP, dV,
// dK: 8*D FLOP), 1.38e11 FLOP, 0.139 ms, and moves about 135 MB. Both are
// bound by the tensor cores. Neither writes a score, probability or dS to
// device memory: each is recomputed tile by tile in registers from q, k and
// the saved LSE. Loops are clipped to the visible range and mask per
// element only on tiles that straddle the diagonal, the window edge or the
// end of the rows.
//
// B2 (wgmma, TMA, warp specialisation): one block of three warpgroups owns
// 128 flattened query rows of one (batch, kv head), Pb positions x Gb heads
// (Gb = min(G, 128), Pb = 128 / Gb; with G > 128 the grid also steps over
// blocks of 128 heads), so each K/V tile is read once for the group and
// feeds 128 rows. The longest causal blocks launch first.
//   * A producer warp (warpgroup 2) loads Q and dO once by TMA, with the
//     rows' lse and delta by cp.async on the same mbarrier (their rows are 4
//     bytes, not 16-byte aligned), then K and V tiles of 64 rows by TMA
//     through a ring of two stages with full and empty mbarriers. TMA writes
//     zeros past S, T and G and in columns D..DP-1; the rows of Q and dO
//     past Pb x Gb are zeroed once.
//   * Warpgroups 0 and 1 own 64 rows each. Per kv tile: S = Q K^T and
//     dP = dO V^T are two wgmma chains (m64n64k16, Q and dO the
//     shared-memory A operand, K and V K-major), committed one after the
//     other, so the fp32 P = exp2(S scale log2e - lse log2e) runs while dP
//     is still in the tensor cores; dS = P (dP - delta) scale is rounded once
//     to bf16 as the register A operand of dQ += dS K (m64nDPk16, K
//     MN-major). Masks only on tiles that straddle the diagonal, the window
//     edge or T, under one branch a tile.
//   * Registers set the 64-row kv tile: each consumer thread holds dQ (64
//     fp32 at D = 128), S and dP (32 each), within the 168 registers a
//     384-thread block gets at launch (ptxas of CUDA 12.8 allocates within
//     that bound whatever setmaxnreg asks for, so neither kernel uses it).
//
// B3 (wgmma, TMA, warp specialisation): one block of three warpgroups owns
// 64 kv rows of one (batch, kv head) and walks the query side in tiles of
// Pb positions x Gb heads (Gb = min(G, 64), Pb = 64 / Gb; with G > 64 it
// also walks the blocks of 64 heads), so the GQA group sum happens in the
// block, in fp32 registers, with no atomics: the result does not depend on
// the order blocks run in. The walk starts at the block's first key when
// causal and ends at its last key + window - 1 or S.
//   * A producer warp (warpgroup 2) loads K and V once by TMA, then the Q
//     and dO tiles by TMA through a ring of two stages with full and empty
//     mbarriers, and each tile's lse and delta by cp.async (their rows are 4
//     bytes, not 16-byte aligned), which completes on the same full
//     barrier. The copies of the next tile run under the products of this
//     one. TMA writes zeros outside q and dO; the rows Pb x Gb..63 it never
//     writes are zeroed once, since the products sum over them.
//   * Warpgroup 0 owns dV: per tile S^T = K Q^T (wgmma m64n64k16, K the
//     shared-memory A operand, Q K-major), P^T = exp(S^T scale - lse) in
//     fp32 registers, then dV += P^T dO (m64nDPk16, P^T in bf16 as the
//     register A operand, dO MN-major). It hands P^T (fp32) to warpgroup 1
//     through a double-buffered shared-memory slot and a pair of mbarriers.
//   * Warpgroup 1 owns dK: per tile dP^T = V dO^T (m64n64k16, V the A
//     operand, dO K-major), dS^T = P^T (dP^T - delta) scale with warpgroup
//     0's P^T, then dK += dS^T Q (dS^T in bf16 registers, Q MN-major). The
//     two warpgroups' products run side by side; neither computes S^T or
//     dP^T twice.
//   * Registers set this split. Each consumer thread holds one 64 x DP fp32
//     accumulator (64 registers at D = 128) and one 64 x 64 product (32), so
//     both fit the 168 registers a 384-thread block gets at launch. Holding
//     dK and dV in one warpgroup (128 + 64 registers) spilled: ptxas of
//     CUDA 12.8 allocates within that launch bound even under setmaxnreg
//     240, and a smaller block (288 threads) is held to the same 168.
// Head dim 256 (recurrentgemma-9b: MQA, G = 16, window 2048). The 64 x 256
// fp32 accumulators take 128 registers a thread, past the 168 of a
// 384-thread block once a 64 x 64 product sits beside them:
//   * B2 (DqPlan) runs ONE consumer warpgroup of 64 query rows beside the
//     producer warpgroup (256 threads, up to 255 registers a thread); dQ +=
//     dS K is one m64n256k16 chain. Shared memory: Q and dO 64 KB, K and V
//     2 x 64 KB, 192 KB in all;
//   * B3 (DkvPlan) keeps its two consumer warpgroups and gives each block
//     128 of the 256 columns of dK and dV: the grid has two blocks per kv
//     tile (blockIdx.y = kv head x 2 + half), each computing S^T and dP^T
//     over all of D and its half of dV += P^T dO and dK += dS^T Q. That
//     costs 1.5x the products (S^T and dP^T twice), and doubles the grid,
//     which at MQA (K = 1) has only T / 64 blocks a batch row. Shared
//     memory: K, V, and 2 stages of Q and dO at 32 KB each, P^T 2 x 16 KB:
//     231,752 bytes of the 232,448 a block may have.
// D = 129 to 255 is padded to 256 by the TMA boxes' zero fill. The fp32
// kernels at D > 128 give each row 8 threads (32 dims each) and walk tiles
// of 16 rows, within static shared memory.
//
// Where they round: the reference keeps p and ds in fp32 for p^T dO, ds^T q
// and ds k. Here p and ds are rounded to bf16 (round to nearest) as the A
// operand of those three products; every sum is fp32 and dq, dk, dv are
// rounded to the inputs' dtype once, at the end. Left for a later change:
// overlapping a tile's dQ, dV or dK product with the next tile's products,
// and persistent blocks.
//
// fp32 inputs take separate SIMT kernels (fp32 FMA, no tensor cores), so an
// fp32 caller gets fp32 products and not TF32.
//
// C entry points return cudaGetLastError() after the launch (or the error
// of encoding a TMA map); they launch on the given stream and do not
// synchronise.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "hopper.cuh"

namespace {

using namespace attn;
using namespace hopper;

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

constexpr int kWsThreads = 384;      // B3: warpgroups 0, 1 consume; 2 produces
constexpr int kStages = 2;           // B2: K / V ring; B3: Q / dO ring
constexpr int kBox64 = 64 * 128;     // bytes of a 64-row box of 64 columns
constexpr int kSmemMax = 232448;     // dynamic shared memory a block may have

// B2: dq. One block owns kRows flattened query rows (pb positions x gb
// heads of one (batch, kv head)): up to DP = 128 warpgroups 0 and 1 own 64
// of 128 each, at DP = 256 warpgroup 0 owns all 64 (see the header); the
// first warp of the next warpgroup is the producer.
template <int DP>
struct DqPlan {
  static constexpr int kConsumers = DP <= 128 ? 2 : 1;
  static constexpr int kRows = 64 * kConsumers;   // query rows a block
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kQBox = kRows * 128;   // bytes of a Q or dO box
};
constexpr int kDqBN = 64;            // kv rows a tile

template <int DP>
constexpr int dq_smem_bytes() {
  using P = DqPlan<DP>;
  return (DP / 64) * (2 * P::kQBox + 2 * kStages * kBox64) +
         2 * P::kRows * 4 + 8 * (1 + 2 * kStages) + 1024;
}

// gb heads x pb positions make the block's rows: gb = min(G, kRows),
// pb = kRows / gb; with G > kRows the grid also steps over blocks of kRows
// heads.
template <int DP>
__global__ void __launch_bounds__(DqPlan<DP>::kThreads, 1)
fa_bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_do,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v, Args a,
                      int gb, int pb) {
  using P = DqPlan<DP>;
  constexpr int kDqRows = P::kRows;
  constexpr int kQTile = (DP / 64) * P::kQBox;  // bytes of the Q or dO tile
  constexpr int kKTile = (DP / 64) * kBox64;    // bytes of a K or V tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sQ = align_1024(smem_raw);
  unsigned char* sdO = sQ + kQTile;
  unsigned char* sK = sdO + kQTile;             // [kStages]
  unsigned char* sV = sK + kStages * kKTile;    // [kStages]
  float* sLse = reinterpret_cast<float*>(sV + kStages * kKTile);
  float* sDelta = sLse + kDqRows;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sDelta + kDqRows);
  uint64_t* full = q_full + 1;                  // [kStages] K, V
  uint64_t* empty = full + kStages;             // [kStages]

  const int kh = blockIdx.y, b = blockIdx.z;
  const int n_hb = (a.G + gb - 1) / gb;         // head blocks
  const int n_pb = (a.S + pb - 1) / pb;         // position blocks
  const int p0 = (n_pb - 1 - (int)blockIdx.x / n_hb) * pb;   // longest first
  const int g0 = (blockIdx.x % n_hb) * gb;
  const int used = pb * gb;                     // loaded rows
  const int p_last = min(p0 + pb, a.S) - 1;
  const int kv_hi = a.causal ? min(a.T, p_last + 1) : a.T;
  const int kv_lo = a.window > 0 ? max(0, p0 - a.window + 1) : 0;
  const int n_tiles = kv_hi > kv_lo ? (kv_hi - kv_lo + kDqBN - 1) / kDqBN : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1 + 32);          // the TMA arrival, 32 cp.async lanes
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * P::kConsumers);   // one per consumer warp
    }
    fence_mbar_init();
  }
  // Rows used..kDqRows-1 of Q and dO are never loaded; the products read
  // them, so they must hold finite values: zeros.
  const int pad = kDqRows - used;
  for (int i = threadIdx.x; i < 2 * (DP / 64) * pad * 8; i += P::kThreads) {
    const int box = i / (pad * 8), c = i % (pad * 8);
    *reinterpret_cast<uint4*>(sQ + box * P::kQBox + (used + c / 8) * 128 +
                              (c % 8) * 16) = make_uint4(0, 0, 0, 0);
  }
  fence_proxy_async();
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == P::kConsumers) {
    // ------------------------------------------------------ producer warp
    if (threadIdx.x >= 128 * P::kConsumers + 32) return;
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, 2 * (DP / 64) * 128 * used);
      for (int h = 0; h < DP / 64; ++h) {
        tma_load_5d(sQ + h * P::kQBox, &tm_q, q_full, 64 * h, g0, kh, p0, b);
        tma_load_5d(sdO + h * P::kQBox, &tm_do, q_full, 64 * h, g0, kh, p0,
                    b);
      }
    }
    // lse and delta: (B, S, K, G) fp32 rows need not be 16-byte aligned, so
    // cp.async, 4 bytes each (zeros outside the tensor); rows lane + 32 i
#pragma unroll
    for (int i = 0; i < kDqRows / 32; ++i) {
      const int r = lane + 32 * i;
      const int p = p0 + r / gb, g = g0 + r % gb;
      const bool ok = r < used && p < a.S && g < a.G;
      const size_t idx = ok ? (((size_t)b * a.S + p) * a.K + kh) * a.G + g : 0;
      cp_async4(sLse + r, a.lse + idx, ok);
      cp_async4(sDelta + r, a.delta + idx, ok);
    }
    mbar_arrive_cp_async(q_full);
    if (lane == 0) {
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        const int k0 = kv_lo + j * kDqBN;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * kKTile);
        for (int h = 0; h < DP / 64; ++h) {
          tma_load_4d(sK + s * kKTile + h * kBox64, &tm_k, &full[s], 64 * h,
                      kh, k0, b);
          tma_load_4d(sV + s * kKTile + h * kBox64, &tm_v, &full[s], 64 * h,
                      kh, k0, b);
        }
      }
    }
    return;
  }

  // --------------------------------------------------------------- consumers
  // dq[4 i + 2 h + e] is row r[h], column 8 i + 2 t4 + e; the products' sc
  // and dp (64 rows x 64 keys) follow the same pattern with keys for
  // columns.
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g4 = lane / 4, t4 = lane % 4;      // accumulator coordinates
  const unsigned char* myQ = sQ + wg * 64 * 128;
  const unsigned char* mydO = sdO + wg * 64 * 128;
  int r[2], lo[2], hi[2];
  bool row_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    r[h] = wg * 64 + warp * 16 + g4 + 8 * h;
    const int p = p0 + r[h] / gb;
    row_ok[h] = r[h] < used && p < a.S && g0 + r[h] % gb < a.G;
    // keys lo..hi are visible to the row's position (causal, window, T)
    lo[h] = a.window > 0 ? p - a.window + 1 : 0;
    hi[h] = a.causal ? min(p, a.T - 1) : a.T - 1;
  }
  float dq[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
  mbar_wait(q_full, 0);
  // a row outside the tensor gets lse = +inf, so its p is 0
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    lse2[h] = row_ok[h] ? sLse[r[h]] * kLog2e : INFINITY;
    dlt[h] = sDelta[r[h]];
  }
  const float sl2 = a.scale * kLog2e;

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const int k0 = kv_lo + j * kDqBN;
    const unsigned char* tK = sK + s * kKTile;
    const unsigned char* tV = sV + s * kKTile;
    mbar_wait(&full[s], (j / kStages) & 1);

    // S = Q K^T and dP = dO V^T (K, V K-major): two chains, S's first, so
    // that the softmax of S runs while dP is still in the tensor cores
    float sc[kDqBN / 2], dp[kDqBN / 2];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int oq = (kk / 4) * P::kQBox + (kk % 4) * 32;
      const int okv = (kk / 4) * kBox64 + (kk % 4) * 32;
      wgmma_ss<0>(sc, desc_k(myQ + oq), desc_k(tK + okv), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int oq = (kk / 4) * P::kQBox + (kk % 4) * 32;
      const int okv = (kk / 4) * kBox64 + (kk % 4) * 32;
      wgmma_ss<0>(dp, desc_k(mydO + oq), desc_k(tV + okv), kk > 0);
    }
    wgmma_commit();
    fence_regs(dp);
    wgmma_wait<1>();
    fence_regs(sc);

    // p = exp(s scale - lse), masked to exactly 0: one branch for the whole
    // tile, masked scores become -inf; sc[4 n + 2 h + e] is key
    // k0 + 8 n + 2 t4 + e of row r[h]
    if (!pairs_unmasked(a, p0, p_last, k0, kDqBN)) {
#pragma unroll
      for (int n = 0; n < kDqBN / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e / 2, kpos = k0 + 8 * n + 2 * t4 + (e & 1);
          const bool vis = kpos >= lo[h] && kpos <= hi[h];
          sc[4 * n + e] = vis ? sc[4 * n + e] : -INFINITY;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kDqBN / 2; ++i)
      sc[i] = exp2_ftz(fmaf(sc[i], sl2, -lse2[(i / 2) % 2]));

    // dS = p (dP - delta) scale, in bf16 as the register A operand of
    // dQ += dS K (elements 8 ks .. 8 ks + 7 are its k16 step ks; K MN-major,
    // 16 kv rows, 2048 bytes, a step; N = DP)
    wgmma_wait<0>();
    fence_regs(dp);
    uint32_t da[kDqBN / 16][4];
#pragma unroll
    for (int ks = 0; ks < kDqBN / 16; ++ks)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int e0 = 8 * ks + 2 * q, h = q % 2;
        da[ks][q] = pack_bf16(sc[e0] * (dp[e0] - dlt[h]) * a.scale,
                              sc[e0 + 1] * (dp[e0 + 1] - dlt[h]) * a.scale);
      }
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kDqBN / 16; ++ks)
      wgmma_rs<1>(dq, da[ks], desc_mn(tK + ks * 16 * 128, kBox64), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);     // this warp is done with s
  }

  // dq, rounded once
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out0);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!row_ok[h]) continue;
    const size_t row = (((size_t)b * a.S + p0 + r[h] / gb) * a.K + kh) * a.G +
                       g0 + r[h] % gb;
#pragma unroll
    for (int i = 0; i < DP / 8; ++i) {
      const int col = i * 8 + 2 * t4;
      if (col < a.D) {
        *reinterpret_cast<uint32_t*>(out + row * a.D + col) =
            pack_bf16(dq[4 * i + 2 * h], dq[4 * i + 2 * h + 1]);
      }
    }
  }
}

// B3: dk and dv. One block owns 64 kv rows: warpgroup 0 computes their dV,
// warpgroup 1 their dK, and the first warp of warpgroup 2 is the producer.
constexpr int kWsRowsK = 64;         // kv rows a block
constexpr int kWsBQ = 64;            // rows of a query tile (Pb x Gb used)
constexpr int kPBytes = kWsRowsK * kWsBQ * 4;   // P^T of a tile, fp32

// The columns of dK and dV a block computes: all of DP up to 128, one half
// of 256 at DP = 256 (see the header); kSplit blocks share a kv tile.
template <int DP>
struct DkvPlan {
  static constexpr int kDN = DP <= 128 ? DP : 128;
  static constexpr int kSplit = DP / kDN;
};

template <int DP>
constexpr int dkv_smem_bytes() {
  return (2 + 2 * kStages) * (DP / 64) * kBox64 + kStages * kPBytes +
         2 * kStages * kWsBQ * 4 + kWsBQ * 4 + 8 * (1 + 4 * kStages) + 1024;
}

// gb heads x pb positions make a query tile: gb = min(G, 64), pb = 64 / gb;
// with G > 64 the walk also steps over blocks of 64 heads.
template <int DP>
__global__ void __launch_bounds__(kWsThreads, 1)
fa_bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_do,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, Args a,
                       int gb, int pb) {
  constexpr int kTile = (DP / 64) * kBox64;    // bytes of a K, V, Q or dO tile
  constexpr int kDN = DkvPlan<DP>::kDN;         // accumulator columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sK = align_1024(smem_raw);
  unsigned char* sV = sK + kTile;
  unsigned char* sQ = sV + kTile;              // [kStages]
  unsigned char* sdO = sQ + kStages * kTile;   // [kStages]
  float* sP = reinterpret_cast<float*>(sdO + kStages * kTile);  // [kStages]
  float* sLse = sP + kStages * kPBytes / 4;                     // [kStages]
  float* sDelta = sLse + kStages * kWsBQ;                       // [kStages]
  int* sRow = reinterpret_cast<int*>(sDelta + kStages * kWsBQ);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sRow + kWsBQ);
  uint64_t* full = kv_full + 1;                // [kStages] Q, dO, lse, delta
  uint64_t* empty = full + kStages;            // [kStages]
  uint64_t* p_full = empty + kStages;          // [kStages] P^T handed over
  uint64_t* p_empty = p_full + kStages;        // [kStages]

  // this block's kv head, and its columns c0 .. c0 + kDN - 1 of dK and dV
  // (box c0 / 64 of the Q and dO tiles)
  const int kh = blockIdx.y / DkvPlan<DP>::kSplit, b = blockIdx.z;
  const int c0 = (blockIdx.y % DkvPlan<DP>::kSplit) * kDN;
  const KTile t = k_tile(a, kWsRowsK);
  const int p_lo = t.f_lo / a.G, p_hi = t.f_hi / a.G;
  const int n_hb = (a.G + gb - 1) / gb;         // head blocks
  const int n_tiles = (p_hi - p_lo + pb - 1) / pb * n_hb;
  const int used = pb * gb;                     // loaded rows of a tile

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1 + 32);    // the TMA arrival, 32 cp.async lanes
      mbar_init(&empty[s], 8);        // one per consumer warp
      mbar_init(&p_full[s], 128);     // every thread of the dV warpgroup
      mbar_init(&p_empty[s], 128);    // every thread of the dK warpgroup
    }
    fence_mbar_init();
  }
  // Row r of every query tile is position p0 + r / gb, head g0 + r % gb:
  // sRow[r] = (r / gb) << 8 | r % gb, or -1 past the loaded rows.
  if (threadIdx.x < kWsBQ) {
    const int r = threadIdx.x;
    sRow[r] = r < used ? (r / gb) << 8 | (r % gb) : -1;
  }
  // Rows used..63 of the Q and dO buffers are never loaded. The products
  // sum over them (with p = 0), so they must hold finite values: zeros.
  const int pad = kWsBQ - used;
  for (int i = threadIdx.x; i < 2 * kStages * (DP / 64) * pad * 8;
       i += kWsThreads) {
    const int box = i / (pad * 8), c = i % (pad * 8);
    *reinterpret_cast<uint4*>(sQ + box * kBox64 + (used + c / 8) * 128 +
                              (c % 8) * 16) = make_uint4(0, 0, 0, 0);
  }
  fence_proxy_async();
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ------------------------------------------------------ producer warp
    if (threadIdx.x >= 256 + 32) return;
    const int lane = threadIdx.x % 32;
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * kTile);
      for (int h = 0; h < DP / 64; ++h) {
        tma_load_4d(sK + h * kBox64, &tm_k, kv_full, 64 * h, kh, t.k0, b);
        tma_load_4d(sV + h * kBox64, &tm_v, kv_full, 64 * h, kh, t.k0, b);
      }
    }
    // this lane copies the lse and delta of tile rows lane and lane + 32
    const int row0 = sRow[lane], row1 = sRow[lane + 32];
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const int p0 = p_lo + (i / n_hb) * pb, g0 = (i % n_hb) * gb;
      mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], 2 * (DP / 64) * 128 * used);
        for (int h = 0; h < DP / 64; ++h) {
          tma_load_5d(sQ + s * kTile + h * kBox64, &tm_q, &full[s], 64 * h,
                      g0, kh, p0, b);
          tma_load_5d(sdO + s * kTile + h * kBox64, &tm_do, &full[s], 64 * h,
                      g0, kh, p0, b);
        }
      }
      // lse and delta: (B, S, K, G) fp32 rows need not be 16-byte aligned,
      // so cp.async, 4 bytes each (zeros outside the tensor)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rc = h ? row1 : row0;
        const int p = p0 + (rc >> 8), g = g0 + (rc & 255);
        const bool ok = rc >= 0 && p < a.S && g < a.G;
        const size_t idx =
            ok ? (((size_t)b * a.S + p) * a.K + kh) * a.G + g : 0;
        const int r = lane + 32 * h;
        cp_async4(sLse + s * kWsBQ + r, a.lse + idx, ok);
        cp_async4(sDelta + s * kWsBQ + r, a.delta + idx, ok);
      }
      mbar_arrive_cp_async(&full[s]);
    }
    return;
  }

  // ------------------------------------------------------------- consumers
  // acc is this warpgroup's dV (warpgroup 0) or dK (1): 64 kv rows x kDN
  // columns from c0. acc[4 i + 2 h + e] is kv row kpos[h], column
  // c0 + 8 i + 2 t4 + e; the
  // products' accumulators st / dpt (64 kv rows x 64 query rows) follow the
  // same pattern with query rows for columns. P^T goes from warpgroup 0 to
  // warpgroup 1 through shared memory, in fp32, thread by thread:
  // sP[s][e][tid] is element e of thread tid.
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g4 = lane / 4, t4 = lane % 4;      // accumulator coordinates
  const int kpos[2] = {t.k0 + warp * 16 + g4, t.k0 + warp * 16 + g4 + 8};
  float acc[kDN / 2];
#pragma unroll
  for (int i = 0; i < kDN / 2; ++i) acc[i] = 0.f;
  mbar_wait(kv_full, 0);

  if (wg == 0) {
    // ----------------------------------- dV += P^T dO, P^T = exp(S^T - lse)
    // query positions p_min..p_max see key kpos[h] (causal, window, T)
    int p_min[2], p_max[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      p_min[h] = kpos[h] >= a.T ? INT_MAX : a.causal ? kpos[h] : INT_MIN;
      p_max[h] = a.window > 0 ? kpos[h] + a.window - 1 : INT_MAX;
    }
    const float sl2 = a.scale * kLog2e;
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const uint32_t ph = (i / kStages) & 1;
      const int p0 = p_lo + (i / n_hb) * pb, g0 = (i % n_hb) * gb;
      const unsigned char* tQ = sQ + s * kTile;
      const unsigned char* tdO = sdO + s * kTile;
      const float* tLse = sLse + s * kWsBQ;
      mbar_wait(&full[s], ph);

      // S^T = K Q^T: K the shared-memory A operand, Q K-major
      float st[kWsBQ / 2];
#pragma unroll
      for (int e = 0; e < kWsBQ / 2; ++e) st[e] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int off = (kk / 4) * kBox64 + (kk % 4) * 32;
        wgmma_ss<0>(st, desc_k(sK + off), desc_k(tQ + off), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);

      // P^T = exp(S^T scale - lse), masked to exactly 0: one branch for the
      // whole tile, masked scores become -inf; st[4 j + e] is query row
      // 8 j + 2 t4 + e % 2
      const bool full_tile =
          used == kWsBQ && p0 + pb <= a.S && g0 + gb <= a.G &&
          pairs_unmasked(a, p0, p0 + pb - 1, t.k0, kWsRowsK);
      if (!full_tile) {
#pragma unroll
        for (int j = 0; j < kWsBQ / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int rc = sRow[8 * j + 2 * t4 + e];
            const int p = p0 + (rc >> 8), g = g0 + (rc & 255);
            const bool row_ok = rc >= 0 && p < a.S && g < a.G;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const bool vis = row_ok && p >= p_min[h] && p <= p_max[h];
              st[4 * j + 2 * h + e] = vis ? st[4 * j + 2 * h + e] : -INFINITY;
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kWsBQ / 8; ++j) {
        const float2 lse =
            *reinterpret_cast<const float2*>(tLse + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float l2 = ((e & 1) ? lse.y : lse.x) * kLog2e;
          st[4 * j + e] = exp2_ftz(fmaf(st[4 * j + e], sl2, -l2));
        }
      }

      // hand P^T to the dK warpgroup
      mbar_wait(&p_empty[s], ph ^ 1);
      float* pt = sP + s * (kPBytes / 4) + tid;
#pragma unroll
      for (int e = 0; e < kWsBQ / 2; ++e) pt[e * 128] = st[e];
      mbar_arrive(&p_full[s]);

      // dV += P^T dO: P^T in bf16 as the register A operand (elements
      // 8 ks .. 8 ks + 7 are its k16 step ks), dO MN-major (16 query rows,
      // 2048 bytes, a step) from column c0
      uint32_t pa[kWsBQ / 16][4];
#pragma unroll
      for (int ks = 0; ks < kWsBQ / 16; ++ks)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          pa[ks][q] = pack_bf16(st[8 * ks + 2 * q], st[8 * ks + 2 * q + 1]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kWsBQ / 16; ++ks)
        wgmma_rs<1>(acc, pa[ks],
                    desc_mn(tdO + (c0 / 64) * kBox64 + ks * 16 * 128, kBox64),
                    1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);   // this warp is done with s
    }
  } else {
    // ------------------------- dK += dS^T Q, dS^T = P^T (dP^T - delta) scale
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const uint32_t ph = (i / kStages) & 1;
      const unsigned char* tQ = sQ + s * kTile;
      const unsigned char* tdO = sdO + s * kTile;
      const float* tDelta = sDelta + s * kWsBQ;
      mbar_wait(&full[s], ph);

      // dP^T = V dO^T: V the shared-memory A operand, dO K-major
      float dpt[kWsBQ / 2];
#pragma unroll
      for (int e = 0; e < kWsBQ / 2; ++e) dpt[e] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int off = (kk / 4) * kBox64 + (kk % 4) * 32;
        wgmma_ss<0>(dpt, desc_k(sV + off), desc_k(tdO + off), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dpt);

      // dS^T from the dV warpgroup's P^T, in bf16 as the register A operand
      // of dK += dS^T Q (elements 8 ks + 2 q, + 1 are query rows
      // 16 ks + 8 (q / 2) + 2 t4, + 1)
      mbar_wait(&p_full[s], ph);
      const float* pt = sP + s * (kPBytes / 4) + tid;
      uint32_t da[kWsBQ / 16][4];
#pragma unroll
      for (int ks = 0; ks < kWsBQ / 16; ++ks) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int e0 = 8 * ks + 2 * q;
          const float2 dl = *reinterpret_cast<const float2*>(
              tDelta + 16 * ks + 8 * (q / 2) + 2 * t4);
          da[ks][q] = pack_bf16(pt[e0 * 128] * (dpt[e0] - dl.x) * a.scale,
                                pt[(e0 + 1) * 128] * (dpt[e0 + 1] - dl.y) *
                                    a.scale);
        }
      }
      mbar_arrive(&p_empty[s]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kWsBQ / 16; ++ks)
        wgmma_rs<1>(acc, da[ks],
                    desc_mn(tQ + (c0 / 64) * kBox64 + ks * 16 * 128, kBox64),
                    1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);   // this warp is done with s
    }
  }

  // dV (warpgroup 0) or dK (1), rounded once
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(wg == 0 ? a.out1 : a.out0);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (kpos[h] >= a.T) continue;
    const size_t row = krow(a, b, kh, kpos[h]) * a.D;
#pragma unroll
    for (int i = 0; i < kDN / 8; ++i) {
      const int col = c0 + i * 8 + 2 * t4;
      if (col < a.D) {
        *reinterpret_cast<uint32_t*>(out + row + col) =
            pack_bf16(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
      }
    }
  }
}

template <int DP>
cudaError_t launch_dq_bf16(const Args& a, cudaStream_t stream) {
  using P = DqPlan<DP>;
  static_assert(dq_smem_bytes<DP>() <= kSmemMax, "shared memory");
  const int gb = min(a.G, P::kRows), pb = P::kRows / gb;
  CUtensorMap tm_q, tm_do, tm_k, tm_v;
  cudaError_t err = map_q(&tm_q, a.q, a.B, a.S, a.K, a.G, a.D, gb, pb);
  if (err == cudaSuccess)
    err = map_q(&tm_do, a.dout, a.B, a.S, a.K, a.G, a.D, gb, pb);
  if (err == cudaSuccess) err = map_kv(&tm_k, a.k, a.B, a.T, a.K, a.D, kDqBN);
  if (err == cudaSuccess) err = map_kv(&tm_v, a.v, a.B, a.T, a.K, a.D, kDqBN);
  if (err != cudaSuccess) return err;
  const int smem = dq_smem_bytes<DP>();
  err = cudaFuncSetAttribute(fa_bwd_dq_bf16_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const int n_hb = (a.G + gb - 1) / gb;
  dim3 grid((a.S + pb - 1) / pb * n_hb, a.K, a.B);
  fa_bwd_dq_bf16_kernel<DP><<<grid, P::kThreads, smem, stream>>>(
      tm_q, tm_do, tm_k, tm_v, a, gb, pb);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkv_bf16(const Args& a, cudaStream_t stream) {
  static_assert(dkv_smem_bytes<DP>() <= kSmemMax, "shared memory");
  const int gb = min(a.G, 64), pb = kWsBQ / gb;
  CUtensorMap tm_q, tm_do, tm_k, tm_v;
  cudaError_t err = map_q(&tm_q, a.q, a.B, a.S, a.K, a.G, a.D, gb, pb);
  if (err == cudaSuccess)
    err = map_q(&tm_do, a.dout, a.B, a.S, a.K, a.G, a.D, gb, pb);
  if (err == cudaSuccess)
    err = map_kv(&tm_k, a.k, a.B, a.T, a.K, a.D, kWsRowsK);
  if (err == cudaSuccess)
    err = map_kv(&tm_v, a.v, a.B, a.T, a.K, a.D, kWsRowsK);
  if (err != cudaSuccess) return err;
  const int smem = dkv_smem_bytes<DP>();
  err = cudaFuncSetAttribute(fa_bwd_dkv_bf16_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.T + kWsRowsK - 1) / kWsRowsK, a.K * DkvPlan<DP>::kSplit, a.B);
  fa_bwd_dkv_bf16_kernel<DP><<<grid, kWsThreads, smem, stream>>>(
      tm_q, tm_do, tm_k, tm_v, a, gb, pb);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ fp32 path

constexpr int kThreadsF = 128;

// The fp32 kernels' tiles: D padded to DPF, LPR threads a row (each holding
// dims d = t4 + LPR * i), rows kThreadsF / LPR a block, TILE rows of the
// walked side a step. <128, 4, 32> up to D = 128, <256, 8, 16> above.
template <int DPF, int LPR, int TILE>
struct F32Plan {
  static constexpr int kRows = kThreadsF / LPR;
  static constexpr int kPer = DPF / LPR;
};

// Sum over the LPR lanes that share a row.
template <int LPR>
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 1; o < LPR; o *= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int DPF, int LPR, int TILE>
__global__ void __launch_bounds__(kThreadsF)
fa_bwd_dq_f32_kernel(Args a) {
  constexpr int kRowsF = F32Plan<DPF, LPR, TILE>::kRows;
  constexpr int kPerF = F32Plan<DPF, LPR, TILE>::kPer;
  constexpr int kTileF = TILE, kDPF = DPF;
  __shared__ float sK[kTileF][kDPF];
  __shared__ float sV[kTileF][kDPF];

  const int kh = blockIdx.y, b = blockIdx.z;
  const QTile t = q_tile(a, kRowsF);
  const int r = threadIdx.x / LPR, t4 = threadIdx.x % LPR;
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
    const int d = t4 + LPR * i;
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
        s = fmaf(qr[i], sK[j][t4 + LPR * i], s);
        dp = fmaf(dor[i], sV[j][t4 + LPR * i], dp);
      }
      s = row_sum<LPR>(s);
      dp = row_sum<LPR>(dp);
      const bool vis = visible(qpos, k0 + j, a.T, a.causal, a.window);
      const float p = vis ? expf(s * a.scale - lse) : 0.f;
      const float ds = p * (dp - dlt) * a.scale;
#pragma unroll
      for (int i = 0; i < kPerF; ++i)
        acc[i] = fmaf(ds, sK[j][t4 + LPR * i], acc[i]);
    }
    __syncthreads();
  }

  if (!row_ok) return;
  float* dq = static_cast<float*>(a.out0);
#pragma unroll
  for (int i = 0; i < kPerF; ++i) {
    const int d = t4 + LPR * i;
    if (d < a.D) dq[row * a.D + d] = acc[i];
  }
}

template <int DPF, int LPR, int TILE>
__global__ void __launch_bounds__(kThreadsF)
fa_bwd_dkv_f32_kernel(Args a) {
  constexpr int kRowsF = F32Plan<DPF, LPR, TILE>::kRows;
  constexpr int kPerF = F32Plan<DPF, LPR, TILE>::kPer;
  constexpr int kTileF = TILE, kDPF = DPF;
  __shared__ float sQ[kTileF][kDPF];
  __shared__ float sdO[kTileF][kDPF];
  __shared__ float sLse[kTileF];
  __shared__ float sDelta[kTileF];

  const int kh = blockIdx.y, b = blockIdx.z;
  const KTile t = k_tile(a, kRowsF);
  const int r = threadIdx.x / LPR, t4 = threadIdx.x % LPR;
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
    const int d = t4 + LPR * i;
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
        s = fmaf(kr[i], sQ[j][t4 + LPR * i], s);
        dp = fmaf(vr[i], sdO[j][t4 + LPR * i], dp);
      }
      s = row_sum<LPR>(s);
      dp = row_sum<LPR>(dp);
      const bool vis = visible((f0 + j) / a.G, kpos, a.T, a.causal, a.window);
      const float p = vis ? expf(s * a.scale - sLse[j]) : 0.f;
      const float ds = p * (dp - sDelta[j]) * a.scale;
#pragma unroll
      for (int i = 0; i < kPerF; ++i) {
        dv[i] = fmaf(p, sdO[j][t4 + LPR * i], dv[i]);
        dk[i] = fmaf(ds, sQ[j][t4 + LPR * i], dk[i]);
      }
    }
    __syncthreads();
  }

  if (!k_ok) return;
  float* dk_out = static_cast<float*>(a.out0);
  float* dv_out = static_cast<float*>(a.out1);
#pragma unroll
  for (int i = 0; i < kPerF; ++i) {
    const int d = t4 + LPR * i;
    if (d < a.D) {
      dk_out[row * a.D + d] = dk[i];
      dv_out[row * a.D + d] = dv[i];
    }
  }
}

template <int DPF, int LPR, int TILE>
cudaError_t launch_dq_f32(const Args& a, cudaStream_t stream) {
  constexpr int rows = F32Plan<DPF, LPR, TILE>::kRows;
  dim3 grid((a.S * a.G + rows - 1) / rows, a.K, a.B);
  fa_bwd_dq_f32_kernel<DPF, LPR, TILE><<<grid, kThreadsF, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int DPF, int LPR, int TILE>
cudaError_t launch_dkv_f32(const Args& a, cudaStream_t stream) {
  constexpr int rows = F32Plan<DPF, LPR, TILE>::kRows;
  dim3 grid((a.T + rows - 1) / rows, a.K, a.B);
  fa_bwd_dkv_f32_kernel<DPF, LPR, TILE><<<grid, kThreadsF, 0, stream>>>(a);
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
// limits below before calling: bf16 needs D % 8 == 0 and D <= 256; fp32
// needs D <= 256. Every entry point takes the same arguments; dq (B2) writes
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
  return run(D <= 64    ? &launch_dq_bf16<64>
             : D <= 128 ? &launch_dq_bf16<128>
                        : &launch_dq_bf16<256>,
             q, k, v, dout, lse, delta, out0, out1, B, S, T, K, G, D, scale,
             causal, window, stream);
}

extern "C" int fa_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                               const void* dout, const void* lse,
                               const void* delta, void* out0, void* out1,
                               int B, int S, int T, int K, int G, int D,
                               float scale, int causal, int window,
                               void* stream) {
  return run(D <= 64    ? &launch_dkv_bf16<64>
             : D <= 128 ? &launch_dkv_bf16<128>
                        : &launch_dkv_bf16<256>,
             q, k, v, dout, lse, delta, out0, out1, B, S, T, K, G, D, scale,
             causal, window, stream);
}

extern "C" int fa_bwd_dq_f32(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* out0, void* out1,
                             int B, int S, int T, int K, int G, int D,
                             float scale, int causal, int window,
                             void* stream) {
  return run(D <= 128 ? &launch_dq_f32<128, 4, 32>
                      : &launch_dq_f32<256, 8, 16>,
             q, k, v, dout, lse, delta, out0, out1, B, S, T, K, G, D, scale,
             causal, window, stream);
}

extern "C" int fa_bwd_dkv_f32(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* out0, void* out1,
                              int B, int S, int T, int K, int G, int D,
                              float scale, int causal, int window,
                              void* stream) {
  return run(D <= 128 ? &launch_dkv_f32<128, 4, 32>
                      : &launch_dkv_f32<256, 8, 16>,
             q, k, v, dout, lse, delta, out0, out1, B, S, T, K, G, D, scale,
             causal, window, stream);
}

extern "C" const char* fa_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
