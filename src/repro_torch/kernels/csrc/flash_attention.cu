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
// Tiles (the reference's q_block / kv_block). A block owns q_block
// FLATTENED (position, head) rows of one (batch, kv head) and walks the
// kv side in tiles of kv_block rows. Because the kernel packs the G query
// heads of a kv head into one block, q_block counts rows, not positions:
// a block holds q_block / G positions x G heads. At G = 1 that is the
// reference's q_block positions. Each (q_block, kv_block) pair is its own
// compiled plan; the set, per dtype and padded head dim, is
//   bf16, D <= 128: q_block in {64, 128} (one or two consumer warpgroups of
//                   64 rows) x kv_block in {64, 128};
//   bf16, D = 256:  q_block 64 x kv_block in {32, 64};
//   fp32, D <= 128: q_block 32 x kv_block in {16, 32};
//   fp32, D = 256:  q_block 32 x kv_block 16.
// The launcher dispatches on the pair; a pair outside the set returns
// cudaErrorInvalidValue and launches nothing. The wrapper's default, when
// no find-db row names a pair, is the plan this kernel had before it took
// tiles: (128, 128) up to D = 128, (64, 64) at 256 in bf16; (32, 32) and
// (32, 16) in fp32.
//
// What bounds it on an H100. At the serve shape (B=8, S=T=2048, 16 q heads
// over 8 kv heads, D=128, causal) the two products need about
// 4*B*S^2*H*D/2 = 1.375e11 FLOP, 0.139 ms at 989 TFLOP/s bf16, while q, k,
// v, out and lse move about 2.0e8 bytes, 0.060 ms at 3.35 TB/s: it is bound
// by the tensor cores, whose full rate only wgmma reaches. The bf16 design:
//   * one block owns q_block flattened (position, head) rows of ONE
//     (batch, kv head): Pb = q_block / G positions x all G heads, so each
//     K/V tile is read once for the group and feeds q_block query rows;
//   * a producer warp (warpgroup 2, cut to 24 registers by setmaxnreg)
//     issues every load by TMA: the Q tile once, then K and V tiles of
//     kv_block rows through a ring of two stages with full and empty mbarriers, so
//     the copies of the next tile run under the products of this one and
//     no consumer spends an instruction or a register on them. TMA writes
//     zeros past T, past S and in columns D..DP-1 (D = 40 or 72), so nothing
//     is masked by hand on the way in;
//   * q_block / 64 consumer warpgroups own 64 rows each (with two,
//     setmaxnreg 240; ptxas of CUDA 12.8 still allocates within the launch
//     bound of 168 registers, which S, O and P fit). Per kv tile S = Q K^T
//     is one wgmma chain (m64n{kv_block}k16, Q and K read from
//     128B-swizzled shared memory, K
//     K-major), the online softmax runs in fp32 registers (exp2, masks only
//     on tiles that straddle the diagonal, the window edge or T, under one
//     branch a tile: a branch per element bloats the unrolled loop past the
//     instruction cache), and P, rounded to bf16 in registers, is the
//     register A operand of O += P V (m64nDPk16, V MN-major). A consumer
//     frees a stage through its empty barrier once its P V has completed;
//   * the kv loop is clipped to the visible range (up to the diagonal when
//     causal, from q_start - window + 1 with a window) and the longest
//     causal tiles launch first.
// Shared memory at D = 128 and the default (128, 128): Q 32 KB + 2 x (K
// 32 KB + V 32 KB) = 160 KB, one block an SM. Where it rounds: P to bf16 as the operand of P V (as the
// reference's kernel does); S, the softmax statistics and O are fp32, and
// out is rounded once. Left for a later change: overlapping one consumer's
// softmax with the other's products (ping-pong), a persistent scheduler,
// and fp8.
//
// Head dim 256 (recurrentgemma-9b: MQA, G = 16, window 2048): O is 64 rows
// x 256 fp32, 128 registers a thread, which with S and P does not fit the
// 168 registers ptxas gives a thread of a 384-thread block. So q_block is
// 64: ONE consumer warpgroup and the producer warpgroup (256 threads, up
// to 255 registers a thread), kv tiles are 64 or 32 rows (S is 32 or 16
// registers), and O += P V is one m64n256k16 chain. Shared memory: Q 32 KB
// + 2 x (K 32 KB + V 32 KB) = 160 KB at kv_block 64. D = 129
// to 255 is padded to 256 by the TMA boxes' zero fill. The price: one
// consumer warpgroup an SM, with nothing to overlap its softmax with.
//
// fp32 inputs take a separate SIMT kernel (fp32 FMA, no tensor cores), so an
// fp32 caller gets fp32 products and not TF32: 32 rows a block, 4 threads a
// row. At D > 128 its kv tile is 16 rows, so that K and V stay within the
// 48 KB of static shared memory.
//
// C entry points return cudaGetLastError() after the launch (or the error
// of encoding a TMA map); they launch on the given stream and do not
// synchronise.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
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

constexpr int kStages = 2;       // K/V ring

// The bf16 kernel's plan for a padded head dim DP: ROWS (q_block)
// flattened (position, head) rows a block in ROWS / 64 consumer
// warpgroups, and BN (kv_block) kv rows a tile (see the header). The
// producer is the warpgroup after the consumers.
template <int DP, int ROWS, int BN>
struct FwdPlan {
  static_assert(ROWS == 64 || ROWS == 128, "64 rows a consumer warpgroup");
  static_assert(BN == 32 || BN == 64 || BN == 128, "a wgmma N of S = Q K^T");
  static constexpr int kConsumers = ROWS / 64;
  static constexpr int kRows = ROWS;          // flattened rows a block
  static constexpr int kBN = BN;              // kv rows a tile
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kQBox = kRows * 128;   // bytes of a Q box (64 columns)
  static constexpr int kKVBox = kBN * 128;    // bytes of a K or V box
};

template <int DP, int ROWS, int BN>
constexpr int fwd_smem_bytes() {
  using P = FwdPlan<DP, ROWS, BN>;
  return (DP / 64) * (P::kQBox + 2 * kStages * P::kKVBox) +
         8 * (1 + 2 * kStages) + 1024;
}

template <int DP, int ROWS, int BN>
__global__ void __launch_bounds__(FwdPlan<DP, ROWS, BN>::kThreads, 1)
fa_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, Args a) {
  using P = FwdPlan<DP, ROWS, BN>;
  constexpr int kBN = P::kBN;
  constexpr int kQTile = (DP / 64) * P::kQBox;    // bytes of the Q tile
  constexpr int kKVTile = (DP / 64) * P::kKVBox;  // bytes of a K or V tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sQ = align_1024(smem_raw);
  unsigned char* sK = sQ + kQTile;               // [kStages]
  unsigned char* sV = sK + kStages * kKVTile;    // [kStages]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + kStages * kKVTile);
  uint64_t* full = q_full + 1;                   // [kStages]
  uint64_t* empty = full + kStages;              // [kStages]

  const int kh = blockIdx.y, b = blockIdx.z;
  const Tile t = tile_of(a, P::kRows);
  const int n_tiles = t.kv_hi > t.kv_lo ? (t.kv_hi - t.kv_lo + kBN - 1) / kBN
                                        : 0;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * P::kConsumers);   // one per consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == P::kConsumers) {
    // ------------------------------------------------------------ producer
    if constexpr (P::kConsumers == 2) setmaxnreg_dec<24>();
    if (threadIdx.x == 128 * P::kConsumers) {
      mbar_arrive_expect_tx(q_full, (DP / 64) * 128 * a.G * t.bq);
      for (int h = 0; h < DP / 64; ++h)
        tma_load_5d(sQ + h * P::kQBox, &tm_q, q_full, 64 * h, 0, kh, t.q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        const int k0 = t.kv_lo + j * kBN;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * kKVTile);
        for (int h = 0; h < DP / 64; ++h) {
          tma_load_4d(sK + s * kKVTile + h * P::kKVBox, &tm_k, &full[s],
                      64 * h, kh, k0, b);
          tma_load_4d(sV + s * kKVTile + h * P::kKVBox, &tm_v, &full[s],
                      64 * h, kh, k0, b);
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    if constexpr (P::kConsumers == 2) setmaxnreg_inc<240>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g4 = lane / 4, t4 = lane % 4;    // accumulator coordinates
    const int r0 = wg * 64 + warp * 16 + g4;   // this thread's rows: r0, +8
    const int qpos0 = t.q0 + r0 / a.G, qpos1 = t.q0 + (r0 + 8) / a.G;
    // keys lo..hi are visible to the rows' positions (causal, window, T)
    const int lo0 = a.window > 0 ? qpos0 - a.window + 1 : 0;
    const int lo1 = a.window > 0 ? qpos1 - a.window + 1 : 0;
    const int hi0 = a.causal ? min(qpos0, a.T - 1) : a.T - 1;
    const int hi1 = a.causal ? min(qpos1, a.T - 1) : a.T - 1;
    const unsigned char* myQ = sQ + wg * 64 * 128;

    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf;         // running max, log2 units
    float l0 = 0.f, l1 = 0.f;                 // this thread's share of sums
    const float sl2 = a.scale * kLog2e;

    mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      const int k0 = t.kv_lo + j * kBN;
      const unsigned char* tK = sK + s * kKVTile;
      const unsigned char* tV = sV + s * kKVTile;
      mbar_wait(&full[s], (j / kStages) & 1);

      // S = Q K^T: 64 rows x kBN columns, k16 steps over DP
      float sc[kBN / 2];
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) sc[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int in_box = (kk % 4) * 32;
        wgmma_ss<0>(sc, desc_k(myQ + (kk / 4) * P::kQBox + in_box),
                    desc_k(tK + (kk / 4) * P::kKVBox + in_box), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // scale (log2 units) and mask; sc[4 nt + e] is row r0 + 8 (e / 2),
      // column k0 + 8 nt + 2 t4 + e % 2. One branch for the whole tile:
      // a branch per element would bloat the unrolled loop past the
      // instruction cache
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) sc[i] *= sl2;
      if (!tile_unmasked(a, t, k0, kBN)) {
#pragma unroll
        for (int nt = 0; nt < kBN / 8; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + nt * 8 + 2 * t4 + (e & 1);
            const bool ok = e < 2 ? kpos >= lo0 && kpos <= hi0
                                  : kpos >= lo1 && kpos <= hi1;
            sc[4 * nt + e] = ok ? sc[4 * nt + e] : kNegInf;
          }
        }
      }
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int nt = 0; nt < kBN / 8; ++nt) {
        mx0 = fmaxf(mx0, fmaxf(sc[4 * nt], sc[4 * nt + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[4 * nt + 2], sc[4 * nt + 3]));
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
      for (int nt = 0; nt < kBN / 8; ++nt) {
        sc[4 * nt] = exp2_ftz(sc[4 * nt] - mn0);
        sc[4 * nt + 1] = exp2_ftz(sc[4 * nt + 1] - mn0);
        sc[4 * nt + 2] = exp2_ftz(sc[4 * nt + 2] - mn1);
        sc[4 * nt + 3] = exp2_ftz(sc[4 * nt + 3] - mn1);
        ls0 += sc[4 * nt] + sc[4 * nt + 1];
        ls1 += sc[4 * nt + 2] + sc[4 * nt + 3];
      }
      l0 = l0 * c0 + ls0;
      l1 = l1 * c1 + ls1;
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
        o[4 * i] *= c0;
        o[4 * i + 1] *= c0;
        o[4 * i + 2] *= c1;
        o[4 * i + 3] *= c1;
      }

      // O += P V: P's accumulators of n-tiles 2 ks and 2 ks + 1 are the A
      // fragment of k16 step ks; V is MN-major, a step 16 rows on; N = DP
      uint32_t pa[kBN / 16][4];
#pragma unroll
      for (int ks = 0; ks < kBN / 16; ++ks) {
        pa[ks][0] = pack_bf16(sc[8 * ks], sc[8 * ks + 1]);
        pa[ks][1] = pack_bf16(sc[8 * ks + 2], sc[8 * ks + 3]);
        pa[ks][2] = pack_bf16(sc[8 * ks + 4], sc[8 * ks + 5]);
        pa[ks][3] = pack_bf16(sc[8 * ks + 6], sc[8 * ks + 7]);
      }
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kBN / 16; ++ks)
        wgmma_rs<1>(o, pa[ks], desc_mn(tV + ks * 16 * 128, P::kKVBox), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);   // this warp is done with s
    }

    // epilogue: reduce l over the quad, normalise, store out and lse
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    l0 = fmaxf(l0, 1e-30f);
    l1 = fmaxf(l1, 1e-30f);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    const int rows_used = t.bq * a.G;

    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + half * 8;
      const int s_pos = t.q0 + r / a.G;
      if (r >= rows_used || s_pos >= a.S) continue;   // padding rows
      const size_t row =
          (((size_t)b * a.S + s_pos) * a.K + kh) * a.G + r % a.G;
      const float inv = half ? inv1 : inv0;
#pragma unroll
      for (int i = 0; i < DP / 8; ++i) {
        const int col = i * 8 + 2 * t4;
        if (col < a.D) {
          *reinterpret_cast<uint32_t*>(out + row * a.D + col) =
              pack_bf16(o[4 * i + 2 * half] * inv,
                        o[4 * i + 2 * half + 1] * inv);
        }
      }
      if (t4 == 0) {
        const float m = half ? m1 : m0;
        const float l = half ? l1 : l0;
        a.lse[row] = m * kLn2 + logf(l);
      }
    }
  }
}

template <int DP, int ROWS, int BN>
cudaError_t launch_bf16(const Args& a, cudaStream_t stream) {
  using P = FwdPlan<DP, ROWS, BN>;
  static_assert(fwd_smem_bytes<DP, ROWS, BN>() <= 232448, "shared memory");
  const int bq = P::kRows / a.G;               // positions a block
  CUtensorMap tm_q, tm_k, tm_v;
  cudaError_t err = map_q(&tm_q, a.q, a.B, a.S, a.K, a.G, a.D, a.G, bq);
  if (err == cudaSuccess) err = map_kv(&tm_k, a.k, a.B, a.T, a.K, a.D, P::kBN);
  if (err == cudaSuccess) err = map_kv(&tm_v, a.v, a.B, a.T, a.K, a.D, P::kBN);
  if (err != cudaSuccess) return err;
  const int smem = fwd_smem_bytes<DP, ROWS, BN>();
  err = cudaFuncSetAttribute(fa_fwd_bf16_kernel<DP, ROWS, BN>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.S + bq - 1) / bq, a.K, a.B);
  fa_fwd_bf16_kernel<DP, ROWS, BN><<<grid, P::kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, a);
  return cudaGetLastError();
}

// The compiled plan of (q_block, kv_block) at DP, or cudaErrorInvalidValue.
template <int DP>
cudaError_t launch_plan_bf16(const Args& a, int qb, int kb,
                             cudaStream_t st) {
  if constexpr (DP <= 128) {
    if (qb == 64 && kb == 64) return launch_bf16<DP, 64, 64>(a, st);
    if (qb == 64 && kb == 128) return launch_bf16<DP, 64, 128>(a, st);
    if (qb == 128 && kb == 64) return launch_bf16<DP, 128, 64>(a, st);
    if (qb == 128 && kb == 128) return launch_bf16<DP, 128, 128>(a, st);
  } else {
    if (qb == 64 && kb == 32) return launch_bf16<DP, 64, 32>(a, st);
    if (qb == 64 && kb == 64) return launch_bf16<DP, 64, 64>(a, st);
  }
  return cudaErrorInvalidValue;
}

// ------------------------------------------------------------------ fp32 path

constexpr int kRowsF = 32;     // flattened rows per block, 4 threads per row
constexpr int kThreadsF = kRowsF * 4;

// DPF: D padded (128 or 256); BNF: kv rows a tile (kv_block: 16 or 32 at
// DPF = 128, 16 at DPF = 256, where K and V then take 32 KB of static
// shared memory). q_block is kRowsF.
template <int DPF, int BNF>
__global__ void __launch_bounds__(kThreadsF)
fa_fwd_f32_kernel(Args a) {
  constexpr int PER = DPF / 4;            // dims per thread: d = t4 + 4*i
  __shared__ float sK[BNF][DPF];
  __shared__ float sV[BNF][DPF];

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

  for (int k0 = t.kv_lo; k0 < t.kv_hi; k0 += BNF) {
    for (int c = threadIdx.x; c < BNF * DPF; c += kThreadsF) {
      const int rr = c / DPF, d = c % DPF;
      const int s = k0 + rr;
      const bool ok = s < t.kv_hi && d < a.D;
      const size_t off = (((size_t)b * a.T + s) * a.K + kh) * a.D + d;
      sK[rr][d] = ok ? k[off] : 0.f;
      sV[rr][d] = ok ? v[off] : 0.f;
    }
    __syncthreads();

    float sc[BNF];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < BNF; ++j) {
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
    for (int j = 0; j < BNF; ++j) {
      sc[j] = expf(sc[j] - mn);
      ls += sc[j];
    }
    l = l * corr + ls;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      float x = acc[i] * corr;
#pragma unroll
      for (int j = 0; j < BNF; ++j) x = fmaf(sc[j], sV[j][t4 + 4 * i], x);
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

// The compiled plan of (q_block, kv_block), or cudaErrorInvalidValue.
cudaError_t launch_f32(const Args& a, int qb, int kb, cudaStream_t stream) {
  const int bq = kRowsF / a.G;
  dim3 grid((a.S + bq - 1) / bq, a.K, a.B);
  if (qb != kRowsF) return cudaErrorInvalidValue;
  if (a.D <= 128 && kb == 32)
    fa_fwd_f32_kernel<128, 32><<<grid, kThreadsF, 0, stream>>>(a);
  else if (a.D <= 128 && kb == 16)
    fa_fwd_f32_kernel<128, 16><<<grid, kThreadsF, 0, stream>>>(a);
  else if (a.D > 128 && kb == 16)
    fa_fwd_f32_kernel<256, 16><<<grid, kThreadsF, 0, stream>>>(a);
  else
    return cudaErrorInvalidValue;
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

// The Python wrapper checks shapes, dtypes, contiguity, alignment, the
// plan and the limits below before calling: bf16 needs D % 8 == 0,
// D <= 256, G <= 64; fp32 needs D <= 256, G <= 32. q_block and kv_block
// name the plan (see the header).
extern "C" int fa_fwd_bf16(const void* q, const void* k, const void* v,
                           void* o, void* lse, int B, int S, int T, int K,
                           int G, int D, float scale, int causal, int window,
                           int q_block, int kv_block, void* stream) {
  const Args a = make_args(q, k, v, o, lse, B, S, T, K, G, D, scale, causal,
                           window);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int qb = q_block, kb = kv_block;
  return static_cast<int>(D <= 64    ? launch_plan_bf16<64>(a, qb, kb, st)
                          : D <= 128 ? launch_plan_bf16<128>(a, qb, kb, st)
                                     : launch_plan_bf16<256>(a, qb, kb, st));
}

extern "C" int fa_fwd_f32(const void* q, const void* k, const void* v,
                          void* o, void* lse, int B, int S, int T, int K,
                          int G, int D, float scale, int causal, int window,
                          int q_block, int kv_block, void* stream) {
  const Args a = make_args(q, k, v, o, lse, B, S, T, K, G, D, scale, causal,
                           window);
  return static_cast<int>(launch_f32(a, q_block, kv_block,
                                     static_cast<cudaStream_t>(stream)));
}

extern "C" const char* fa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
