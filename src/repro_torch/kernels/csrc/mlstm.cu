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
//    in shared memory for the whole walk over the sequence.
//  * The column blocks of a head run as thread-block clusters. Every block
//    needs all of its head's q and k, so a producer warp of the cluster's
//    rank 0 loads them once for the cluster, in tiles of 4096 elements
//    (q: all Q rows x 4096 / Q columns; k: 8 steps x 512 rows), by TMA
//    multicast into the same offset of every block's shared memory, through
//    a ring of four stages: it arms every block's full mbarrier with the
//    tile's bytes, and each consumer warp gives a stage back by one plain
//    arrival on rank 0's empty mbarrier (no block barrier per tile). No
//    consumer thread spends an instruction on a load.
//  * The cluster size is the largest power of two up to 8 (the portable
//    size) whose launch needs the fewest waves of resident clusters, as the
//    card reports them (cudaOccupancyMaxActiveClusters): a block fills an
//    SM and a cluster's blocks share a GPC, so on an H100 SXM clusters of 4
//    or 8 leave SMs idle and took 1.25x as long as clusters of 2, which
//    were as fast as no cluster (the reload of q and k was never what held
//    the kernel: its blocks waited on tiles for 2-7% of their time). At
//    D = 512 that is 2: q and k are read 8-fold, not 16-fold.
//  * The gates (F, m, the row stabilisers, the state weights), q . n and
//    n's update do not depend on the value column: rank 0 computes them
//    once for the cluster and stores them into every block's shared memory
//    (distributed shared memory), then arrives on that block's mbarrier.
//    The gates depend on the carried m alone, so the producer warp computes
//    those of the next chunk between its loads (two slots, handed back
//    through an mbarrier on rank 0); F is summed in step order, as the plain
//    version sums it. Rank 0's consumers compute q . n while they read the
//    q tiles and update n.
//  * The chunk's scores q k^T (Q x Q x D) are computed once per chunk by a
//    first kernel (mlstm_scores), lower-triangular 64 x 64 tiles only, into
//    an fp32 scratch (B*H, S/Q, Q, Q) that the chunk kernel reads: 33.5 MB
//    at the full width and Q = 128, mostly from L2.
//  * Both D x 32 products are register-tiled (see the chunk kernel's
//    comment): each shared-memory load feeds 4 to 16 FMAs. One block an SM
//    (179 KiB of shared memory at Q = 128, 219 KiB at Q = 256) with 8
//    consumer warps, where the earlier design ran two blocks an SM; q C is
//    bound by shared-memory wavefronts (a thread's 4 x 4 outputs per 8
//    loads).
//  * The sequence stays sequential inside the block (the TPU grid's minor
//    axis): the output of a chunk reads C before the chunk's update, with a
//    barrier between the two.
// Still SIMT: tensor-core fp32 emulation (3xTF32) is later work. The
// wrapper needs D * itemsize to be a multiple of 16 bytes (TMA strides).
//
// C entry points return cudaGetLastError() after the launches; they launch
// on the given stream and do not synchronise.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "hopper.cuh"             // clusters, mbarriers, TMA

namespace {

constexpr int kThreads = 256;  // the scores kernel's block
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
// One block per (value-column block, b*H + h), walking all S/Q chunks; the
// blocks of a head's column blocks form clusters (column blocks past D
// compute on zero v and store nothing). Warps 0-7 consume;
// warp 8 of the cluster's rank 0 produces. Per chunk, with QP = 32 * RPT >=
// Q padded rows:
//   outputs (Q x 32): thread (rg = tid / 8, cg = tid % 8) owns rows
//     rg*RPT .. rg*RPT+RPT-1 and columns cg*4 .. cg*4+3, register-tiled:
//     a v streams a in 32-step tiles (the next tile's scores in flight under
//     this tile's products); q C reads each q tile (all Q rows x QE columns,
//     row-major as TMA lands it) four columns at a time, so RPT loads of q
//     and four float4 of C feed 16*RPT FMAs;
//   state (D x 32): thread (eg = tid % 64, sg = tid / 64) owns rows
//     eg*4 .. eg*4+3 and 256+eg*4 .. 256+eg*4+3 (of each 512-row pass; two
//     4-vectors that neighbouring threads read from neighbouring addresses)
//     and columns sg*8 .. sg*8+7: 64 accumulators over k tiles of 8 steps.
// The producer warp loads every tile of q (Q x QE, QE = 4096 / QP) and k
// (8 x 512, two boxes of 256 columns) once for the cluster by TMA multicast
// into a ring of kStages stages, arming every block's full barrier with the
// tile's bytes; each consumer warp releases a stage by one arrival on rank
// 0's empty barrier, which counts the cluster's consumer warps. Between
// tiles it computes the gates of the next chunk (they depend on the carried
// m alone) and stores them into every block's double-buffered gate slot,
// then arrives on each block's gate_full barrier; each block gives the slot
// back through rank 0's gate_empty barrier when its chunk is done. Rank 0's
// consumers compute q . n and store it into every block's qn slot the same
// way (qn_full).
constexpr int kCluster = 8;    // column blocks a cluster (portable size)
constexpr int kConsumers = 256;
constexpr int kChunkThreads = kConsumers + 32;   // + the producer warp
constexpr int kStages = 4;     // q / k ring
constexpr int kTileElems = 4096;   // elements of a ring tile
constexpr int kCS = kVB + 4;   // row stride of C in shared memory
constexpr int kTT = 32;        // steps per a tile
constexpr int kKT = 8;         // steps per k tile
constexpr int kKE = 512;       // state rows per pass (two boxes of 256)

__host__ __device__ inline int padded_rows(int Q) {
  return Q <= 32 ? 32 : Q <= 64 ? 64 : Q <= 128 ? 128 : 256;
}

// Floats of one gate slot: ig, F, m_row, ws = exp(F + m_prev - m_row),
// inw = exp(i + F_Q - F - m_new) * scale (QP each), then m_new, carry.
__host__ __device__ inline int gate_floats(int QP) { return 5 * QP + 4; }

// Byte offsets of the chunk kernel's shared memory (from a 128-byte aligned
// base): the ring, C, v, the a tile, two gate slots, n, two q . n slots, the
// barriers.
struct Layout {
  size_t ring, C, v, a, gate, n, qn, bars, total;
};

__host__ __device__ inline Layout layout(int D, int Q) {
  const int QP = padded_rows(Q);
  Layout l;
  l.ring = 0;
  l.C = l.ring + (size_t)kStages * kTileElems * 4;   // fp32 at most
  l.v = l.C + (size_t)D * kCS * 4;
  l.a = l.v + (size_t)(QP + 4) * kVB * 4;     // + 4 zero rows for a v
  l.gate = l.a + (size_t)QP * (kTT + 4) * 4;
  l.n = l.gate + 2 * (size_t)gate_floats(QP) * 4;
  l.qn = l.n + ((size_t)D + 3) / 4 * 16;
  l.bars = l.qn + 2 * (size_t)QP * 4;
  l.total = l.bars + (2 * kStages + 6) * 8 + 128;   // + alignment of base
  return l;
}

struct Gates {
  const float *ig, *F, *mrow, *ws, *inw, *misc;
};

__device__ inline Gates gates_at(const float* g, int QP) {
  return Gates{g, g + QP, g + 2 * QP, g + 3 * QP, g + 4 * QP, g + 5 * QP};
}

// Four elements of a tile in shared memory, as fp32.
__device__ __forceinline__ void ld4(float* out, const float* p) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}
__device__ __forceinline__ void ld4(float* out, const __nv_bfloat16* p) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&x.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&x.y));
  out[0] = lo.x; out[1] = lo.y; out[2] = hi.x; out[3] = hi.y;
}
__device__ __forceinline__ void ld4(float* out, const __half* p) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __half22float2(*reinterpret_cast<const __half2*>(&x.x));
  const float2 hi = __half22float2(*reinterpret_cast<const __half2*>(&x.y));
  out[0] = lo.x; out[1] = lo.y; out[2] = hi.x; out[3] = hi.y;
}

// The 256 consumer threads (not the producer warp) meet.
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// The ring's tiles in the order every block reads them: per chunk, the q
// tiles (e0 = 0, QE, ...) then, per 512-row pass, the k tiles of 8 steps.
struct TileSeq {
  int nq, nk_t, per_chunk, QE;
  __device__ TileSeq(int D, int Q, int QP) {
    QE = kTileElems / QP;
    nq = (D + QE - 1) / QE;
    nk_t = (Q + kKT - 1) / kKT;
    per_chunk = nq + (D + kKE - 1) / kKE * nk_t;
  }
};

// The producer warp: the gates of the chunk at `base` from i, f and the
// carried m (updated to m_new), stored into slot `g` of every block of the
// cluster. Lane l owns steps l*GPL .. l*GPL+GPL-1. The cumsum of
// log_sigmoid(f) is carried from lane to lane in step order, as the plain
// version sums it; the running maxima are warp scans.
template <int GPL>
__device__ void gate_pass(const Args& a, int b, int hh, int base, float& m,
                          float* g, int cluster) {
  const int lane = threadIdx.x % 32;
  const int Q = a.Q, QP = 32 * GPL;
  float lf[GPL], ig[GPL], f[GPL];
#pragma unroll
  for (int i = 0; i < GPL; ++i) {
    const int t = lane * GPL + i;
    const size_t gi = (size_t)(b * a.S + base + min(t, Q - 1)) * a.H + hh;
    ig[i] = t < Q ? a.ig[gi] : -INFINITY;
    lf[i] = t < Q ? log_sigmoid(a.fg[gi]) : 0.f;
  }
  float carry = 0.f;
  for (int l = 0; l < 32; ++l) {
    if (lane == l) {
#pragma unroll
      for (int i = 0; i < GPL; ++i) {
        carry += lf[i];
        f[i] = carry;
      }
    }
    carry = __shfl_sync(0xffffffffu, carry, l);
  }
  float pm[GPL], lm = -INFINITY;              // running max of i - F
#pragma unroll
  for (int i = 0; i < GPL; ++i) {
    lm = fmaxf(lm, ig[i] - f[i]);
    pm[i] = lm;
  }
  float mx = lm;                              // inclusive max over lanes
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const float y = __shfl_up_sync(0xffffffffu, mx, d);
    if (lane >= d) mx = fmaxf(mx, y);
  }
  float mx_ex = __shfl_up_sync(0xffffffffu, mx, 1);
  if (lane == 0) mx_ex = -INFINITY;
  float mine = f[0];                          // F of step Q-1: F_Q
#pragma unroll
  for (int i = 1; i < GPL; ++i)
    if (i == (Q - 1) % GPL) mine = f[i];
  const float Fq = __shfl_sync(0xffffffffu, mine, (Q - 1) / GPL);
  float mi = -INFINITY;                       // max_t i_t + F_Q - F_t
#pragma unroll
  for (int i = 0; i < GPL; ++i)
    if (lane * GPL + i < Q) mi = fmaxf(mi, ig[i] + Fq - f[i]);
#pragma unroll
  for (int d = 16; d > 0; d /= 2)
    mi = fmaxf(mi, __shfl_xor_sync(0xffffffffu, mi, d));
  const float m_prev = m;
  const float m_new = fmaxf(Fq + m_prev, mi);
  float val[5][GPL];
#pragma unroll
  for (int i = 0; i < GPL; ++i) {
    const bool ok = lane * GPL + i < Q;
    const float mrow = fmaxf(f[i] + m_prev, f[i] + fmaxf(mx_ex, pm[i]));
    val[0][i] = ok ? ig[i] : 0.f;
    val[1][i] = ok ? f[i] : 0.f;
    val[2][i] = ok ? mrow : 0.f;
    val[3][i] = ok ? expf(f[i] + m_prev - mrow) : 0.f;
    val[4][i] = ok ? expf(ig[i] + Fq - f[i] - m_new) * a.scale : 0.f;
  }
  const float carry_w = expf(Fq + m_prev - m_new);
  for (int r = 0; r < cluster; ++r) {
#pragma unroll
    for (int k = 0; k < 5; ++k)
#pragma unroll
      for (int i = 0; i < GPL; ++i)
        hopper::st_dsmem(hopper::mapa(g + k * QP + lane * GPL + i, r),
                         val[k][i]);
    if (lane == 0) {
      hopper::st_dsmem(hopper::mapa(g + 5 * QP, r), m_new);
      hopper::st_dsmem(hopper::mapa(g + 5 * QP + 1, r), carry_w);
    }
  }
  m = m_new;
}

template <typename T, int RPT>
__global__ void __launch_bounds__(kChunkThreads, 1)
mlstm_chunk_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k, Args a,
                   int cluster) {
  constexpr int QP = 32 * RPT;
  const int GF = gate_floats(QP);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* sp =
      smem_raw + ((128u - (hopper::smem_u32(smem_raw) & 127u)) & 127u);
  const Layout L = layout(a.D, a.Q);
  const T* ring = reinterpret_cast<const T*>(sp + L.ring);
  float* C = reinterpret_cast<float*>(sp + L.C);
  float* vs = reinterpret_cast<float*>(sp + L.v);
  float* at = reinterpret_cast<float*>(sp + L.a);
  float* gate = reinterpret_cast<float*>(sp + L.gate);   // [2][GF]
  float* n = reinterpret_cast<float*>(sp + L.n);         // rank 0's
  float* qn = reinterpret_cast<float*>(sp + L.qn);       // [2][QP]
  uint64_t* full = reinterpret_cast<uint64_t*>(sp + L.bars);   // [kStages]
  uint64_t* empty = full + kStages;            // [kStages], on rank 0
  uint64_t* gate_full = empty + kStages;       // [2]
  uint64_t* gate_empty = gate_full + 2;        // [2], on rank 0
  uint64_t* qn_full = gate_empty + 2;          // [2]

  const bool lead = hopper::cluster_rank() == 0;
  const int j0 = blockIdx.x * kVB;
  const int bh = blockIdx.y, b = bh / a.H, hh = bh % a.H;
  const int D = a.D, Q = a.Q, NC = a.S / Q;
  const int tid = threadIdx.x;
  const TileSeq seq(D, Q, QP);
  const int QE = seq.QE;

  for (int i = tid; i < D * kCS; i += kChunkThreads) C[i] = 0.f;
  for (int i = tid; i < D; i += kChunkThreads) n[i] = 0.f;
  for (int i = tid; i < 4 * kVB; i += kChunkThreads) vs[QP * kVB + i] = 0.f;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], cluster * kConsumers / 32);   // per warp
    }
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(&gate_full[i], 1);
      hopper::mbar_init(&gate_empty[i], cluster);
      hopper::mbar_init(&qn_full[i], 1);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();
  hopper::cluster_sync();                      // barriers ready cluster-wide

  if (tid >= kConsumers) {
    // ---------------------------------------------- producer warp (rank 0)
    if (lead) {
      const int lane = tid % 32;
      const int n_tiles = NC * seq.per_chunk;
      const uint16_t mask = (uint16_t)((1u << cluster) - 1);
      float m = -1e30f;                        // the carried stabiliser
      auto gates = [&](int c) {                // chunk c into slot c % 2
        if (c >= 2)
          hopper::mbar_wait_cluster(&gate_empty[c % 2], (c / 2 - 1) & 1);
        gate_pass<RPT>(a, b, hh, c * Q, m, gate + (c % 2) * GF, cluster);
        __syncwarp();
        if (lane < cluster)
          hopper::mbar_arrive_remote_release(&gate_full[c % 2], lane);
      };
      gates(0);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        const int c = t / seq.per_chunk, w = t % seq.per_chunk;
        if (t >= kStages)
          hopper::mbar_wait_cluster(&empty[s], (t / kStages - 1) & 1);
        int e0 = 0, t0 = c * Q, boxes = 1;     // k tile: rows e0.., steps t0..
        if (w >= seq.nq) {
          e0 = (w - seq.nq) / seq.nk_t * kKE;
          t0 += (w - seq.nq) % seq.nk_t * kKT;
          boxes = e0 + 256 < D ? 2 : 1;
        }
        const uint32_t bytes = w < seq.nq ? Q * QE * sizeof(T)
                                          : boxes * kKT * 256 * sizeof(T);
        if (lane < cluster)                    // arm every block's full[s]
          hopper::mbar_arrive_expect_tx_remote(&full[s], lane, bytes);
        __syncwarp();
        if (lane == 0) {
          T* dst = const_cast<T*>(ring) + (size_t)s * kTileElems;
          if (w < seq.nq) {
            hopper::tma_load_4d_multicast(dst, &tm_q, &full[s], mask, w * QE,
                                          hh, c * Q, b);
          } else {
            for (int x = 0; x < boxes; ++x)
              hopper::tma_load_4d_multicast(dst + x * kKT * 256, &tm_k,
                                            &full[s], mask, e0 + 256 * x, hh,
                                            t0, b);
          }
        }
        __syncwarp();
        if (w == 0 && c + 1 < NC) gates(c + 1);   // one chunk ahead
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    const int rg = tid >> 3, cg = tid & 7;     // outputs
    const int eg = tid & 63, sg = tid >> 6;    // state update
    const int r0 = rg * RPT;
    // this (b, hh)'s rows of v and h: element (s, e) at [s * rs + e],
    // 32-bit offsets (the wrapper checks S * H * D < 2^31)
    const size_t head = (size_t)b * a.S * a.H * D + (size_t)hh * D;
    const int rs = a.H * D;
    const T* v = static_cast<const T*>(a.v) + head;
    T* h = static_cast<T*>(a.h) + head;

    // Ring tile t: wait for it (the producer armed this block's full
    // barrier with its bytes); each warp gives it back to rank 0's producer
    // on its own, so that warps do not wait for each other tile by tile.
    const int lane = tid % 32;
    auto acquire = [&](int t) -> const T* {
      hopper::mbar_wait(&full[t % kStages], (t / kStages) & 1);
      return ring + (size_t)(t % kStages) * kTileElems;
    };
    auto release = [&](int t) {
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive_remote(&empty[t % kStages], 0);
    };

    int t_next = 0;                            // next ring tile
    for (int c = 0; c < NC; ++c) {
      const int base = c * Q, slot = c % 2;
      const uint32_t ph = (c / 2) & 1;
      const Gates gt = gates_at(gate + slot * GF, QP);
      {                                        // v: all loads, then stores
        float buf[QP * kVB / kConsumers];
#pragma unroll
        for (int m = 0; m < QP * kVB / kConsumers; ++m) {
          const int i = tid + m * kConsumers, t = i / kVB, jj = i % kVB;
          buf[m] = (t < Q && j0 + jj < D)
              ? to_f32(v[(base + t) * rs + j0 + jj]) : 0.f;
        }
#pragma unroll
        for (int m = 0; m < QP * kVB / kConsumers; ++m)
          vs[tid + m * kConsumers] = buf[m];
      }
      hopper::mbar_wait_cluster(&gate_full[slot], ph);   // rank 0's gates
      consumer_sync();

      // ---- outputs from the C of the previous chunk
      float num[RPT][4] = {}, inter[RPT][4] = {}, rsum[RPT] = {};
      const float* S_c = a.scores + ((size_t)bh * NC + c) * Q * Q;
      constexpr int lda = kTT + 4;             // rows 16-byte aligned
      constexpr int kPer = QP * kTT / kConsumers;
      float sbuf[kPer];                        // scores of an a tile
      auto load_scores = [&](int t0) {
#pragma unroll
        for (int m = 0; m < kPer; ++m) {
          const int i = tid + m * kConsumers, r = i / kTT, t = t0 + i % kTT;
          sbuf[m] = (r < Q && t <= r) ? S_c[(size_t)r * Q + t] : 0.f;
        }
      };
      load_scores(0);
      for (int t0 = 0; t0 < Q; t0 += kTT) {    // intra: a v, 32 steps a tile
#pragma unroll
        for (int m = 0; m < kPer; ++m) {
          const int i = tid + m * kConsumers, r = i / kTT, t = t0 + i % kTT;
          at[r * lda + i % kTT] = (r < Q && t <= r)
              ? sbuf[m] * expf(gt.F[r] - gt.F[t] + gt.ig[t] - gt.mrow[r])
              : 0.f;
        }
        consumer_sync();
        if (t0 + kTT < Q) load_scores(t0 + kTT);   // in flight below
        if (r0 + RPT - 1 >= t0) {              // rows above the tile: all 0
          const int nt = min(kTT, Q - t0);     // steps past Q hold zeros
          for (int t = 0; t < nt; t += 4) {
            float vv[4][4];
#pragma unroll
            for (int u = 0; u < 4; ++u)
              ld4(vv[u], &vs[(t0 + t + u) * kVB + cg * 4]);
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
              float x[4];
              ld4(x, &at[(r0 + i) * lda + t]);
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                rsum[i] += x[u];
#pragma unroll
                for (int j = 0; j < 4; ++j)
                  num[i][j] = fmaf(x[u], vv[u][j], num[i][j]);
              }
            }
          }
        }
        consumer_sync();
      }
      float qn_row = 0.f;                      // rank 0: row tid's q . n
      for (int w = 0; w < seq.nq; ++w, ++t_next) {   // inter: q C
        const T* qt = acquire(t_next);
        const int e0 = w * QE, ne = min(QE, D - e0);
        if (lead && tid < Q) {
          for (int e = 0; e < ne; e += 4) {
            float x[4];
            ld4(x, qt + tid * QE + e);
#pragma unroll
            for (int k = 0; k < 4; ++k)
              qn_row = fmaf(x[k], n[e0 + e + k], qn_row);
          }
        }
        for (int e = 0; e < ne; e += 4) {
          float cc[4][4];
#pragma unroll
          for (int k = 0; k < 4; ++k)
            ld4(cc[k], &C[(e0 + e + k) * kCS + cg * 4]);
#pragma unroll
          for (int i = 0; i < RPT; ++i) {
            float qv[4];
            ld4(qv, qt + (r0 + i) * QE + e);
#pragma unroll
            for (int k = 0; k < 4; ++k)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                inter[i][j] = fmaf(qv[k], cc[k][j], inter[i][j]);
          }
        }
        release(t_next);
      }
      if (lead) {                              // q . n into every block
        if (tid < Q)
          for (int r = 0; r < cluster; ++r)
            hopper::st_dsmem(hopper::mapa(qn + slot * QP + tid, r), qn_row);
        consumer_sync();
        if (tid < cluster)
          hopper::mbar_arrive_remote_release(&qn_full[slot], tid);
      }
      hopper::mbar_wait_cluster(&qn_full[slot], ph);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int s = r0 + i;
        if (s >= Q) continue;
        const float w = gt.ws[s];
        const float den = rsum[i] + w * qn[slot * QP + s];
        const float inv = 1.f / fmaxf(fabsf(den), expf(-gt.mrow[s]));
        T* out = h + (size_t)(base + s) * rs;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = j0 + cg * 4 + j;
          if (col < D)
            from_f32(out + col, (num[i][j] + w * inter[i][j]) * inv);
        }
      }

      // ---- state update: C = carry C + (k * in_w)^T v; n likewise (rank 0)
      const float carry = gt.misc[1];
      for (int e0 = 0; e0 < D; e0 += kKE) {
        float acc[8][8] = {}, nacc[8] = {};
        for (int tt = 0; tt < seq.nk_t; ++tt, ++t_next) {
          const T* kt = acquire(t_next);
          const int t0 = tt * kKT, nt = min(kKT, Q - t0);
          for (int t = 0; t < nt; ++t) {
            float kv[8], vv[8];
            const float w = gt.inw[t0 + t];    // exp(...) * scale of step t
            ld4(kv, kt + t * 256 + eg * 4);
            ld4(kv + 4, kt + kKT * 256 + t * 256 + eg * 4);
            ld4(vv, &vs[(t0 + t) * kVB + sg * 8]);
            ld4(vv + 4, &vs[(t0 + t) * kVB + sg * 8 + 4]);
#pragma unroll
            for (int j = 0; j < 8; ++j) vv[j] *= w;
#pragma unroll
            for (int r = 0; r < 8; ++r) {
              nacc[r] = fmaf(kv[r], w, nacc[r]);
#pragma unroll
              for (int j = 0; j < 8; ++j)
                acc[r][j] = fmaf(kv[r], vv[j], acc[r][j]);
            }
          }
          release(t_next);
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int e = e0 + (r < 4 ? eg * 4 + r : 256 + eg * 4 + r - 4);
          if (e >= D) continue;
          float4* Cr = reinterpret_cast<float4*>(C + e * kCS + sg * 8);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float4 x = Cr[j];
            x.x = fmaf(carry, x.x, acc[r][4 * j]);
            x.y = fmaf(carry, x.y, acc[r][4 * j + 1]);
            x.z = fmaf(carry, x.z, acc[r][4 * j + 2]);
            x.w = fmaf(carry, x.w, acc[r][4 * j + 3]);
            Cr[j] = x;
          }
          if (lead && sg == 0) n[e] = carry * n[e] + nacc[r];
        }
      }
      consumer_sync();                         // the chunk's gates are done
      if (tid == 0) hopper::mbar_arrive_remote_release(&gate_empty[slot], 0);
    }
  }
  hopper::cluster_sync();   // no block leaves while the cluster uses it
}

template <typename T> struct TmaType;
template <> struct TmaType<float> {
  static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <> struct TmaType<__nv_bfloat16> {
  static constexpr CUtensorMapDataType value =
      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <> struct TmaType<__half> {
  static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
};

// q or k (B, S, H, D) as (D, H, S, B), unswizzled boxes of `cols` x 1 x
// `rows` x 1.
template <typename T>
cudaError_t map_rows(CUtensorMap* map, const void* base, const Args& a,
                     int cols, int rows) {
  const uint64_t dims[4] = {(uint64_t)a.D, (uint64_t)a.H, (uint64_t)a.S,
                            (uint64_t)a.B};
  const uint64_t strides[3] = {(uint64_t)a.D, (uint64_t)a.H * a.D,
                               (uint64_t)a.S * a.H * a.D};
  const uint32_t box[4] = {(uint32_t)cols, 1, (uint32_t)rows, 1};
  return hopper::encode(map, TmaType<T>::value, sizeof(T), base, 4, dims,
                        strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
}

// The chunk kernel's launch at `cluster` column blocks a cluster (the grid
// rounded up to whole clusters).
template <typename T, int RPT>
struct ChunkLaunch {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  ChunkLaunch(const Args& a, int cluster, cudaStream_t st) : cfg() {
    const int nb = (a.D + kVB - 1) / kVB;      // column blocks of a head
    cfg.gridDim = dim3((nb + cluster - 1) / cluster * cluster, a.B * a.H);
    cfg.blockDim = dim3(kChunkThreads);
    cfg.dynamicSmemBytes = layout(a.D, a.Q).total;
    cfg.stream = st;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// The cluster size: the largest power of two up to kCluster (and up to the
// head's column blocks) whose launch needs the fewest waves of resident
// clusters on this card. A cluster's blocks must share a GPC, and a block
// fills an SM, so larger clusters can leave SMs of a GPC idle; the card's
// own count (cudaOccupancyMaxActiveClusters) decides. Returns 0 on error.
template <typename T, int RPT>
int cluster_size(const Args& a) {
  if (cudaFuncSetAttribute(mlstm_chunk_kernel<T, RPT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)layout(a.D, a.Q).total) != cudaSuccess)
    return 0;
  const int nb = (a.D + kVB - 1) / kVB;
  int best = 0;
  long long best_waves = 0;
  for (int c = 1; c <= kCluster && c < 2 * nb; c *= 2) {
    ChunkLaunch<T, RPT> l(a, c, 0);
    int active = 0;
    if (cudaOccupancyMaxActiveClusters(&active, mlstm_chunk_kernel<T, RPT>,
                                       &l.cfg) != cudaSuccess ||
        active == 0)
      continue;
    const long long blocks = (long long)l.cfg.gridDim.x * l.cfg.gridDim.y;
    const long long waves = (blocks + (long long)active * c - 1) /
                            ((long long)active * c);
    if (best == 0 || waves <= best_waves) {
      best = c;
      best_waves = waves;
    }
  }
  cudaGetLastError();                          // a refused size is no error
  return best;
}

template <typename T, int RPT>
cudaError_t launch_chunk(const Args& a, cudaStream_t st) {
  constexpr int QP = 32 * RPT;
  CUtensorMap tm_q, tm_k;
  cudaError_t err = map_rows<T>(&tm_q, a.q, a, kTileElems / QP, a.Q);
  if (err == cudaSuccess) err = map_rows<T>(&tm_k, a.k, a, 256, kKT);
  if (err != cudaSuccess) return err;
  int cluster = cluster_size<T, RPT>(a);
  if (cluster == 0) return cudaErrorInvalidConfiguration;
  ChunkLaunch<T, RPT> l(a, cluster, st);
  err = cudaLaunchKernelEx(&l.cfg, mlstm_chunk_kernel<T, RPT>, tm_q, tm_k, a,
                           cluster);
  if (err != cudaSuccess) return err;
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
  return (long long)layout(D, Q).total;
}

// The cluster size the chunk kernel launches with for these shapes and
// q's element size (4, 2 for bf16, 3 for fp16); 0 on error.
extern "C" int mlstm_cluster_size(int B, int S, int H, int D, int Q,
                                  int dtype) {
  const Args a = make_args(nullptr, nullptr, nullptr, nullptr, nullptr,
                           nullptr, nullptr, B, S, H, D, Q, 1.f);
  const int rpt = padded_rows(Q) / 32;
  auto pick = [&](auto tag) {
    using T = decltype(tag);
    switch (rpt) {
      case 1: return cluster_size<T, 1>(a);
      case 2: return cluster_size<T, 2>(a);
      case 4: return cluster_size<T, 4>(a);
      default: return cluster_size<T, 8>(a);
    }
  };
  return dtype == 4 ? pick(float()) : dtype == 2 ? pick(__nv_bfloat16())
                                                 : pick(__half());
}

extern "C" const char* mlstm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
