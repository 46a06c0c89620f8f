// Flash attention backward, hand-written for Hopper (sm_90a): the dq kernel
// and the dk/dv kernel.
//
// Replaces the TPU kernels distributed_training_guide_tpu/ops/
// flash_attention.py `_dq_kernel` (K2, :297) and `_dkv_kernel` (K3, :341),
// both launched by `flash_bwd_with_stats`. Both rebuild each probability
// tile from the caller's logsumexp instead of storing the [S, S] attention
// matrix:
//   s = (q . k) * scale [-> t = tanh(s / cap), s = t * cap]
//   p = exp(s - lse) on live pairs, 0 on masked ones
//   ds = p * (dO . v - delta) [* (1 - t^2)] * scale
//   dq = ds k          (K2)
//   dv = p^T dO, dk = ds^T q, summed over the GQA group   (K3)
// with delta = rowsum(dO * O) computed by the caller. The band, scale and
// softcap contract is the forward's (flash_fwd.cu). Masked pairs give
// exactly 0, also on a row with no live key (lse = -1e30), where the TPU
// kernel's exp(NEG_INF - lse) would give 1: the kernel's gradient there is
// 0, the gradient of the constant output.
//
// Grid. On the TPU the dq grid (batch, head, q-block, kv-block) and the
// dk/dv grid (batch, kv-head, kv-block, group member, q-block) carry their
// accumulators across the inner steps in VMEM. Here K2 gives each block one
// (q tile, b * Hq + h) and loops over the live kv tiles; K3 gives each block
// one (kv tile, b * Hkv + kv head) and loops over the group's query heads
// and, per head, the live q tiles. So dk and dv sum over the group inside
// one block, in a fixed order: no atomics, bitwise the same from run to
// run. The tile is the grid's slow axis, ordered so that causal blocks
// launch heaviest first (K2 the last q tile, K3 the first kv tile).
//
// Bound on H100: the operations. Per live (query, key) pair K2 does 3
// products and K3 4, each of 2 x D operations, against 989 TFLOP/s of bf16
// tensor cores; the bytes (each input read once) are a tenth of that time
// at S 2048. Which body runs depends on the dtype and D alone (`body_for`,
// exported as `flash_bwd_body`):
// - bf16, D 64 and 128 (`flash_dq_hopper_kernel`, `flash_dkv_hopper_kernel`):
//   a block of one consumer warpgroup (64 rows) and one producer warpgroup
//   that gives up its registers (`setmaxnreg`), two blocks per SM, whose
//   wgmma batches and p / ds passes interleave. One producer thread feeds
//   every operand tile by TMA (4-D tensor maps over [B, S, H, D] with the
//   caller's strides, 128-byte swizzle, rows past S zero-filled) into a
//   ring of shared-memory stages, each with a full and an empty
//   `mbarrier`; in K3 the producer warp's 32 lanes also copy each q tile's
//   64 lse and delta values into its stage (plain loads: a TMA copy would
//   need them on 16 bytes, which a ragged Sq breaks). Every product is a
//   `wgmma` m64n64k16 with fp32 accumulators in registers. K2 holds its Q
//   and dO rows resident, computes S = Q K^T and dP = dO V^T with both
//   operands in shared memory, forms p and ds in the accumulators' own
//   layout (each register's row and column known from its index), rounds
//   ds to bf16 A-fragments in registers (the m64nNk16 accumulator of
//   columns 16 kk .. 16 kk + 15 is the A operand of k step kk) and adds
//   dS K with the same K tile read N-major. K3 holds its K and V rows
//   resident and computes S^T = K Q^T and dP^T = V dO^T, so that kv rows
//   are the M dimension: P^T and dS^T come out of the accumulators as the
//   register A operands of dV += P^T dO and dK += dS^T Q, with lse and
//   delta indexed by column. The products of one tile are issued in the
//   same wgmma batch as the next tile's scores, so the tensor cores see
//   one batch per tile and the warpgroup one wait (K3 at D 128 excepted:
//   its two 64 x 128 accumulators leave no registers for a second tile's
//   fragments). Nothing between the loads and the outputs touches shared
//   memory; dq, dk and dv leave through the warpgroup's own dead operand
//   rows and 16-byte stores. p and ds are rounded to bf16 before the
//   products that follow, as flash attention does on GPUs.
// - bf16, D 256 (`flash_dq_tc_kernel`, `flash_dkv_tc_kernel`): the WMMA
//   bodies of the first port, S and dP staged through shared memory in
//   fp32. K3's two 64 x 256 fp32 accumulators would not fit one
//   warpgroup's registers; redesigning it is later work.
// - fp32 (`flash_dq_kernel`, `flash_dkv_kernel`): tiles as fp32 rows padded
//   by one float, register-blocked FMA on the CUDA cores, the accumulators
//   in registers: full fp32.
// A barrier that never completes traps after 10 s instead of hanging.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"  // barriers, TMA, wgmma, tensor maps

namespace {

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // a 16 x 16 thread grid

enum DType { kF32 = 0, kBF16 = 1 };

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // [B, Hq, Sq]
  const float* delta;  // [B, Hq, Sq]
  void* dq;            // [B, Sq, Hq, D] contiguous, q's dtype
  void* dk;            // [B, Sk, Hkv, D] contiguous, k's dtype
  void* dv;
  int B, Sq, Sk, Hq, Hkv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;  // dO's strides
  int causal, window, q_off, k_off;
  float scale, softcap;
  int vec;  // every tile row starts 16-byte aligned: copy 8 bf16 at a time
};

template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long row_stride, int rows,
                                          int valid) {
  for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    dst[r * (D + 1) + d] = r < valid ? src[r * row_stride + d] : 0.f;
  }
}

template <int RA, int RC, int D>
__device__ __forceinline__ void tile_dot(const float* A, const float* Bm,
                                         int ty, int tx, float (&s)[RA][RC]) {
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int c = 0; c < RC; ++c) s[a][c] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[RA], bv[RC];
#pragma unroll
    for (int a = 0; a < RA; ++a) av[a] = A[(ty + 16 * a) * (D + 1) + d];
#pragma unroll
    for (int c = 0; c < RC; ++c) bv[c] = Bm[(tx + 16 * c) * (D + 1) + d];
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int c = 0; c < RC; ++c) s[a][c] = fmaf(av[a], bv[c], s[a][c]);
  }
}

// (p, ds) of one score from its q.k and dO.v products
struct ProbGrad {
  float p, ds;
};

__device__ __forceinline__ ProbGrad prob_grad(const BwdParams& p, float qk,
                                              float dov, bool live, float lse,
                                              float delta) {
  float x = qk * p.scale;
  float cap_grad = 1.f;
  if (p.softcap > 0.f) {
    const float t = tanhf(x / p.softcap);
    x = t * p.softcap;
    cap_grad = 1.f - t * t;
  }
  const float pr = live ? expf(x - lse) : 0.f;
  return {pr, pr * (dov - delta) * cap_grad * p.scale};
}

// ------------------------------------------- K2: dq, the fp32 body (FMA)

template <int D, int BQ, int BK>
constexpr int dq_smem_bytes() {
  return ((2 * BQ + 2 * BK) * (D + 1) + BQ * (BK + 1)) * 4;
}

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(const BwdParams p) {
  constexpr int RA = BQ / 16;
  constexpr int RC = BK / 16;
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                   // [BQ][D + 1]
  float* dOs = Qs + BQ * (D + 1);     // [BQ][D + 1]
  float* Ks = dOs + BQ * (D + 1);     // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);      // [BK][D + 1]
  float* dSs = Vs + BK * (D + 1);     // [BQ][BK + 1]

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int n_qt = (p.Sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.y)) * BQ;
  const int b = blockIdx.x / p.Hq;
  const int h = blockIdx.x % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const int q_valid = min(BQ, p.Sq - q0);
  load_tile<D>(Qs, static_cast<const float*>(p.q) + b * p.q_sb +
                          q0 * p.q_ss + h * p.q_sh, p.q_ss, BQ, q_valid);
  load_tile<D>(dOs, static_cast<const float*>(p.dout) + b * p.o_sb +
                           q0 * p.o_ss + h * p.o_sh, p.o_ss, BQ, q_valid);
  const long long stat = (static_cast<long long>(b) * p.Hq + h) * p.Sq + q0;
  float lse_r[RA], delta_r[RA];
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int r = ty + 16 * a;
    lse_r[a] = r < q_valid ? p.lse[stat + r] : 0.f;
    delta_r[a] = r < q_valid ? p.delta[stat + r] : 0.f;
  }

  long long j_lo = 0, j_hi = p.Sk - 1;
  if (p.causal) {
    j_hi = min(j_hi, static_cast<long long>(q0) + BQ - 1 + p.q_off - p.k_off);
    j_lo = max(j_lo, static_cast<long long>(q0) + p.q_off - p.k_off -
                         p.window + 1);
  }
  const int t_lo = static_cast<int>(j_lo / BK);
  const int t_hi = j_hi < j_lo ? t_lo - 1 : static_cast<int>(j_hi / BK);

  float acc[RA][DC];
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[a][c] = 0.f;

  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();
    load_tile<D>(Ks, kg + k0 * p.k_ss, p.k_ss, BK, min(BK, p.Sk - k0));
    load_tile<D>(Vs, vg + k0 * p.v_ss, p.v_ss, BK, min(BK, p.Sk - k0));
    __syncthreads();
    float s[RA][RC], dp[RA][RC];
    tile_dot<RA, RC, D>(Qs, Ks, ty, tx, s);
    tile_dot<RA, RC, D>(dOs, Vs, ty, tx, dp);
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int c = 0; c < RC; ++c) {
        const bool live = pair_live(p, q0 + ty + 16 * a, k0 + tx + 16 * c);
        dSs[(ty + 16 * a) * (BK + 1) + tx + 16 * c] =
            prob_grad(p, s[a][c], dp[a][c], live, lse_r[a], delta_r[a]).ds;
      }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float dsv[RA], kv[DC];
#pragma unroll
      for (int a = 0; a < RA; ++a) dsv[a] = dSs[(ty + 16 * a) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = Ks[j * (D + 1) + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[a][c] = fmaf(dsv[a], kv[c], acc[a][c]);
    }
  }

  float* dqg = static_cast<float*>(p.dq);
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int row = q0 + ty + 16 * a;
    if (row >= p.Sq) continue;
    const long long base =
        ((static_cast<long long>(b) * p.Sq + row) * p.Hq + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) dqg[base + tx + 16 * c] = acc[a][c];
  }
}

// -------------------------------------- K3: dk / dv, the fp32 body (FMA)

template <int D, int BQ, int BK>
constexpr int dkv_smem_bytes() {
  return ((2 * BQ + 2 * BK) * (D + 1) + 2 * BQ * (BK + 1) + 2 * BQ) * 4;
}

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const BwdParams p) {
  constexpr int RQ = BQ / 16;  // query rows per thread in a score tile
  constexpr int RC = BK / 16;  // kv rows per thread (score tile and dk/dv)
  constexpr int DC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;                   // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);      // [BK][D + 1]
  float* Qs = Vs + BK * (D + 1);      // [BQ][D + 1]
  float* dOs = Qs + BQ * (D + 1);     // [BQ][D + 1]
  float* Ps = dOs + BQ * (D + 1);     // [BQ][BK + 1]
  float* dSs = Ps + BQ * (BK + 1);    // [BQ][BK + 1]
  float* Ls = dSs + BQ * (BK + 1);    // [BQ]
  float* Dl = Ls + BQ;                // [BQ]

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int k0 = blockIdx.y * BK;
  const int b = blockIdx.x / p.Hkv;
  const int hk = blockIdx.x % p.Hkv;
  const int groups = p.Hq / p.Hkv;
  const int k_valid = min(BK, p.Sk - k0);
  load_tile<D>(Ks, static_cast<const float*>(p.k) + b * p.k_sb + k0 * p.k_ss +
                          hk * p.k_sh, p.k_ss, BK, k_valid);
  load_tile<D>(Vs, static_cast<const float*>(p.v) + b * p.v_sb + k0 * p.v_ss +
                          hk * p.v_sh, p.v_ss, BK, k_valid);

  // live q rows of this kv tile: the band's edges for its oldest and newest
  // keys
  long long i_lo = 0, i_hi = p.Sq - 1;
  if (p.causal) {
    i_lo = max(i_lo, static_cast<long long>(k0) + p.k_off - p.q_off);
    i_hi = min(i_hi, static_cast<long long>(k0) + BK - 1 + p.k_off - p.q_off +
                         p.window - 1);
  }
  const int t_lo = static_cast<int>(i_lo / BQ);
  const int t_hi = i_hi < i_lo ? t_lo - 1 : static_cast<int>(i_hi / BQ);

  float dk[RC][DC], dv[RC][DC];
#pragma unroll
  for (int c = 0; c < RC; ++c)
#pragma unroll
    for (int e = 0; e < DC; ++e) dk[c][e] = dv[c][e] = 0.f;

  for (int g = 0; g < groups; ++g) {
    const int h = hk * groups + g;
    const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
    const float* og =
        static_cast<const float*>(p.dout) + b * p.o_sb + h * p.o_sh;
    const long long stat = (static_cast<long long>(b) * p.Hq + h) * p.Sq;
    for (int t = t_lo; t <= t_hi; ++t) {
      const int q0 = t * BQ;
      const int q_valid = min(BQ, p.Sq - q0);
      __syncthreads();  // the previous tile's reads are done
      load_tile<D>(Qs, qg + q0 * p.q_ss, p.q_ss, BQ, q_valid);
      load_tile<D>(dOs, og + q0 * p.o_ss, p.o_ss, BQ, q_valid);
      for (int r = threadIdx.x; r < BQ; r += kThreads) {
        Ls[r] = r < q_valid ? p.lse[stat + q0 + r] : 0.f;
        Dl[r] = r < q_valid ? p.delta[stat + q0 + r] : 0.f;
      }
      __syncthreads();
      float s[RQ][RC], dp[RQ][RC];
      tile_dot<RQ, RC, D>(Qs, Ks, ty, tx, s);
      tile_dot<RQ, RC, D>(dOs, Vs, ty, tx, dp);
#pragma unroll
      for (int a = 0; a < RQ; ++a) {
        const int r = ty + 16 * a;
#pragma unroll
        for (int c = 0; c < RC; ++c) {
          const bool live = pair_live(p, q0 + r, k0 + tx + 16 * c);
          const ProbGrad pg = prob_grad(p, s[a][c], dp[a][c], live, Ls[r],
                                        Dl[r]);
          Ps[r * (BK + 1) + tx + 16 * c] = pg.p;
          dSs[r * (BK + 1) + tx + 16 * c] = pg.ds;
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int r = 0; r < BQ; ++r) {
        float pv[RC], dsv[RC], dov[DC], qv[DC];
#pragma unroll
        for (int c = 0; c < RC; ++c) {
          pv[c] = Ps[r * (BK + 1) + ty + 16 * c];
          dsv[c] = dSs[r * (BK + 1) + ty + 16 * c];
        }
#pragma unroll
        for (int e = 0; e < DC; ++e) {
          dov[e] = dOs[r * (D + 1) + tx + 16 * e];
          qv[e] = Qs[r * (D + 1) + tx + 16 * e];
        }
#pragma unroll
        for (int c = 0; c < RC; ++c)
#pragma unroll
          for (int e = 0; e < DC; ++e) {
            dv[c][e] = fmaf(pv[c], dov[e], dv[c][e]);
            dk[c][e] = fmaf(dsv[c], qv[e], dk[c][e]);
          }
      }
    }
  }

  float* dkg = static_cast<float*>(p.dk);
  float* dvg = static_cast<float*>(p.dv);
#pragma unroll
  for (int c = 0; c < RC; ++c) {
    const int row = k0 + ty + 16 * c;
    if (row >= p.Sk) continue;
    const long long base =
        ((static_cast<long long>(b) * p.Sk + row) * p.Hkv + hk) * D;
#pragma unroll
    for (int e = 0; e < DC; ++e) {
      dkg[base + tx + 16 * e] = dk[c][e];
      dvg[base + tx + 16 * e] = dv[c][e];
    }
  }
}

// ----------------------- WMMA bodies (bf16, D 256: the first port's design)

template <int D>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* src,
                                               long long row_stride, int rows,
                                               int valid, bool vec) {
  constexpr int LD = D + 8;
  if (vec) {
    constexpr int V = D / 8;  // 16-byte vectors per row
    for (int idx = threadIdx.x; idx < rows * V; idx += kThreads) {
      const int r = idx / V;
      const int c = (idx - r * V) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r < valid)
        val = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
      *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * D; idx += kThreads) {
      const int r = idx / D;
      const int d = idx - r * D;
      dst[r * LD + d] = r < valid ? src[r * row_stride + d]
                                  : __float2bfloat16(0.f);
    }
  }
}

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBt = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                              wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

constexpr int kLds = 64 + 4;  // fp32 score rows
constexpr int kLdp = 64 + 8;  // bf16 probability rows

// S = A B^T and dP = A2 B2^T over D for this warp's blocks (rb, cb) and
// (rb, cb + 1) of a 64 x 64 tile, stored to Ss / dPs (row stride kLds)
template <int D>
__device__ __forceinline__ void two_score_tiles(
    const bf16* A, const bf16* Bm, const bf16* A2, const bf16* B2, float* Ss,
    float* dPs, int rb, int cb) {
  constexpr int LDT = D + 8;
  FragC s0, s1, d0, d1;
  wmma::fill_fragment(s0, 0.f);
  wmma::fill_fragment(s1, 0.f);
  wmma::fill_fragment(d0, 0.f);
  wmma::fill_fragment(d1, 0.f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    FragA a, a2;
    FragBt b0, b1;
    wmma::load_matrix_sync(a, A + rb * 16 * LDT + kk, LDT);
    wmma::load_matrix_sync(b0, Bm + cb * 16 * LDT + kk, LDT);
    wmma::load_matrix_sync(b1, Bm + (cb + 1) * 16 * LDT + kk, LDT);
    wmma::mma_sync(s0, a, b0, s0);
    wmma::mma_sync(s1, a, b1, s1);
    wmma::load_matrix_sync(a2, A2 + rb * 16 * LDT + kk, LDT);
    wmma::load_matrix_sync(b0, B2 + cb * 16 * LDT + kk, LDT);
    wmma::load_matrix_sync(b1, B2 + (cb + 1) * 16 * LDT + kk, LDT);
    wmma::mma_sync(d0, a2, b0, d0);
    wmma::mma_sync(d1, a2, b1, d1);
  }
  wmma::store_matrix_sync(Ss + rb * 16 * kLds + cb * 16, s0, kLds,
                          wmma::mem_row_major);
  wmma::store_matrix_sync(Ss + rb * 16 * kLds + (cb + 1) * 16, s1, kLds,
                          wmma::mem_row_major);
  wmma::store_matrix_sync(dPs + rb * 16 * kLds + cb * 16, d0, kLds,
                          wmma::mem_row_major);
  wmma::store_matrix_sync(dPs + rb * 16 * kLds + (cb + 1) * 16, d1, kLds,
                          wmma::mem_row_major);
}

template <int D>
struct DqTcSmem {
  static constexpr int kLdt = D + 8;
  static constexpr int q = 0;
  static constexpr int o = q + 64 * kLdt * 2;  // dO
  static constexpr int k = o + 64 * kLdt * 2;
  static constexpr int v = k + 64 * kLdt * 2;
  static constexpr int s = v + 64 * kLdt * 2;
  static constexpr int dp = s + 64 * kLds * 4;
  static constexpr int ds = dp + 64 * kLds * 4;
  static constexpr int bytes = ds + 64 * kLdp * 2;
  // the fp32 dq tile [64][D + 4] reuses the bytes from 0 after the loop
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_tc_kernel(const BwdParams p) {
  using L = DqTcSmem<D>;
  constexpr int BQ = 64, BK = 64, RA = 4, RC = 4;
  constexpr int NC = D / 32;  // 16-wide dq column blocks per warp
  constexpr int LDO = D + 4;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw + L::q);
  bf16* dOs = reinterpret_cast<bf16*>(smem_raw + L::o);
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw + L::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem_raw + L::v);
  float* Ss = reinterpret_cast<float*>(smem_raw + L::s);
  float* dPs = reinterpret_cast<float*>(smem_raw + L::dp);
  bf16* dSs = reinterpret_cast<bf16*>(smem_raw + L::ds);

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int warp = threadIdx.x / 32;
  const int rb = warp / 2;
  const int n_qt = (p.Sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.y)) * BQ;
  const int b = blockIdx.x / p.Hq;
  const int h = blockIdx.x % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const int q_valid = min(BQ, p.Sq - q0);
  load_tile_bf16<D>(Qs, static_cast<const bf16*>(p.q) + b * p.q_sb +
                            q0 * p.q_ss + h * p.q_sh,
                    p.q_ss, BQ, q_valid, p.vec);
  load_tile_bf16<D>(dOs, static_cast<const bf16*>(p.dout) + b * p.o_sb +
                             q0 * p.o_ss + h * p.o_sh,
                    p.o_ss, BQ, q_valid, p.vec);
  const long long stat = (static_cast<long long>(b) * p.Hq + h) * p.Sq + q0;
  float lse_r[RA], delta_r[RA];
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int r = ty + 16 * a;
    lse_r[a] = r < q_valid ? p.lse[stat + r] : 0.f;
    delta_r[a] = r < q_valid ? p.delta[stat + r] : 0.f;
  }

  long long j_lo = 0, j_hi = p.Sk - 1;
  if (p.causal) {
    j_hi = min(j_hi, static_cast<long long>(q0) + BQ - 1 + p.q_off - p.k_off);
    j_lo = max(j_lo, static_cast<long long>(q0) + p.q_off - p.k_off -
                         p.window + 1);
  }
  const int t_lo = static_cast<int>(j_lo / BK);
  const int t_hi = j_hi < j_lo ? t_lo - 1 : static_cast<int>(j_hi / BK);

  const int cb_dq = (warp % 2) * NC;
  FragC dq[NC];
#pragma unroll
  for (int n = 0; n < NC; ++n) wmma::fill_fragment(dq[n], 0.f);

  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();
    load_tile_bf16<D>(Ks, kg + k0 * p.k_ss, p.k_ss, BK, min(BK, p.Sk - k0),
                      p.vec);
    load_tile_bf16<D>(Vs, vg + k0 * p.v_ss, p.v_ss, BK, min(BK, p.Sk - k0),
                      p.vec);
    __syncthreads();
    two_score_tiles<D>(Qs, Ks, dOs, Vs, Ss, dPs, rb, 2 * (warp % 2));
    __syncthreads();
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      const int r = ty + 16 * a;
#pragma unroll
      for (int c = 0; c < RC; ++c) {
        const int col = tx + 16 * c;
        const bool live = pair_live(p, q0 + r, k0 + col);
        dSs[r * kLdp + col] = __float2bfloat16(
            prob_grad(p, Ss[r * kLds + col], dPs[r * kLds + col], live,
                      lse_r[a], delta_r[a]).ds);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {  // dq += dS K
      FragA a;
      wmma::load_matrix_sync(a, dSs + rb * 16 * kLdp + kk, kLdp);
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        FragB kb;
        wmma::load_matrix_sync(kb, Ks + kk * L::kLdt + (cb_dq + n) * 16,
                               L::kLdt);
        wmma::mma_sync(dq[n], a, kb, dq[n]);
      }
    }
  }

  __syncthreads();  // the tiles are dead: stage dq through their bytes
  float* stage = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int n = 0; n < NC; ++n)
    wmma::store_matrix_sync(stage + rb * 16 * LDO + (cb_dq + n) * 16, dq[n],
                            LDO, wmma::mem_row_major);
  __syncthreads();
  bf16* dqg = static_cast<bf16*>(p.dq);
  for (int idx = threadIdx.x; idx < q_valid * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    dqg[((static_cast<long long>(b) * p.Sq + q0 + r) * p.Hq + h) * D + d] =
        __float2bfloat16(stage[r * LDO + d]);
  }
}

template <int D>
struct DkvTcSmem {
  static constexpr int kLdt = D + 8;
  static constexpr int k = 0;
  static constexpr int v = k + 64 * kLdt * 2;
  static constexpr int q = v + 64 * kLdt * 2;
  static constexpr int o = q + 64 * kLdt * 2;  // dO
  static constexpr int s = o + 64 * kLdt * 2;
  static constexpr int dp = s + 64 * kLds * 4;
  static constexpr int pp = dp + 64 * kLds * 4;
  static constexpr int ds = pp + 64 * kLdp * 2;
  static constexpr int ls = ds + 64 * kLdp * 2;
  static constexpr int dl = ls + 64 * 4;
  static constexpr int bytes = dl + 64 * 4;
  // the fp32 dk and dv tiles [64][D + 4] reuse the bytes from 0 at the end
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_tc_kernel(const BwdParams p) {
  using L = DkvTcSmem<D>;
  constexpr int BQ = 64, BK = 64, RA = 4, RC = 4;
  constexpr int NC = D / 32;  // 16-wide dk / dv column blocks per warp
  constexpr int LDO = D + 4;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw + L::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem_raw + L::v);
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw + L::q);
  bf16* dOs = reinterpret_cast<bf16*>(smem_raw + L::o);
  float* Ss = reinterpret_cast<float*>(smem_raw + L::s);
  float* dPs = reinterpret_cast<float*>(smem_raw + L::dp);
  bf16* Pt = reinterpret_cast<bf16*>(smem_raw + L::pp);   // P^T [kv][q]
  bf16* dSt = reinterpret_cast<bf16*>(smem_raw + L::ds);  // dS^T [kv][q]
  float* Ls = reinterpret_cast<float*>(smem_raw + L::ls);
  float* Dl = reinterpret_cast<float*>(smem_raw + L::dl);

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int warp = threadIdx.x / 32;
  const int rb = warp / 2;  // q rows of S / dP; kv rows of dk / dv
  const int k0 = blockIdx.y * BK;
  const int b = blockIdx.x / p.Hkv;
  const int hk = blockIdx.x % p.Hkv;
  const int groups = p.Hq / p.Hkv;
  const int k_valid = min(BK, p.Sk - k0);
  load_tile_bf16<D>(Ks, static_cast<const bf16*>(p.k) + b * p.k_sb +
                            k0 * p.k_ss + hk * p.k_sh,
                    p.k_ss, BK, k_valid, p.vec);
  load_tile_bf16<D>(Vs, static_cast<const bf16*>(p.v) + b * p.v_sb +
                            k0 * p.v_ss + hk * p.v_sh,
                    p.v_ss, BK, k_valid, p.vec);

  long long i_lo = 0, i_hi = p.Sq - 1;
  if (p.causal) {
    i_lo = max(i_lo, static_cast<long long>(k0) + p.k_off - p.q_off);
    i_hi = min(i_hi, static_cast<long long>(k0) + BK - 1 + p.k_off - p.q_off +
                         p.window - 1);
  }
  const int t_lo = static_cast<int>(i_lo / BQ);
  const int t_hi = i_hi < i_lo ? t_lo - 1 : static_cast<int>(i_hi / BQ);

  const int cb_kv = (warp % 2) * NC;
  FragC dk[NC], dv[NC];
#pragma unroll
  for (int n = 0; n < NC; ++n) {
    wmma::fill_fragment(dk[n], 0.f);
    wmma::fill_fragment(dv[n], 0.f);
  }

  for (int g = 0; g < groups; ++g) {
    const int h = hk * groups + g;
    const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
    const bf16* og =
        static_cast<const bf16*>(p.dout) + b * p.o_sb + h * p.o_sh;
    const long long stat = (static_cast<long long>(b) * p.Hq + h) * p.Sq;
    for (int t = t_lo; t <= t_hi; ++t) {
      const int q0 = t * BQ;
      const int q_valid = min(BQ, p.Sq - q0);
      __syncthreads();
      load_tile_bf16<D>(Qs, qg + q0 * p.q_ss, p.q_ss, BQ, q_valid, p.vec);
      load_tile_bf16<D>(dOs, og + q0 * p.o_ss, p.o_ss, BQ, q_valid, p.vec);
      for (int r = threadIdx.x; r < BQ; r += kThreads) {
        Ls[r] = r < q_valid ? p.lse[stat + q0 + r] : 0.f;
        Dl[r] = r < q_valid ? p.delta[stat + q0 + r] : 0.f;
      }
      __syncthreads();
      two_score_tiles<D>(Qs, Ks, dOs, Vs, Ss, dPs, rb, 2 * (warp % 2));
      __syncthreads();
#pragma unroll
      for (int a = 0; a < RA; ++a) {
        const int r = ty + 16 * a;
#pragma unroll
        for (int c = 0; c < RC; ++c) {
          const int col = tx + 16 * c;
          const bool live = pair_live(p, q0 + r, k0 + col);
          const ProbGrad pg = prob_grad(p, Ss[r * kLds + col],
                                        dPs[r * kLds + col], live, Ls[r],
                                        Dl[r]);
          Pt[col * kLdp + r] = __float2bfloat16(pg.p);
          dSt[col * kLdp + r] = __float2bfloat16(pg.ds);
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BQ; kk += 16) {  // dv += P^T dO, dk += dS^T Q
        FragA pt, dst;
        wmma::load_matrix_sync(pt, Pt + rb * 16 * kLdp + kk, kLdp);
        wmma::load_matrix_sync(dst, dSt + rb * 16 * kLdp + kk, kLdp);
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          FragB ob, qb;
          wmma::load_matrix_sync(ob, dOs + kk * L::kLdt + (cb_kv + n) * 16,
                                 L::kLdt);
          wmma::load_matrix_sync(qb, Qs + kk * L::kLdt + (cb_kv + n) * 16,
                                 L::kLdt);
          wmma::mma_sync(dv[n], pt, ob, dv[n]);
          wmma::mma_sync(dk[n], dst, qb, dk[n]);
        }
      }
    }
  }

  __syncthreads();  // the tiles are dead: stage dk, dv through their bytes
  float* sk = reinterpret_cast<float*>(smem_raw);
  float* sv = sk + BK * LDO;
#pragma unroll
  for (int n = 0; n < NC; ++n) {
    wmma::store_matrix_sync(sk + rb * 16 * LDO + (cb_kv + n) * 16, dk[n], LDO,
                            wmma::mem_row_major);
    wmma::store_matrix_sync(sv + rb * 16 * LDO + (cb_kv + n) * 16, dv[n], LDO,
                            wmma::mem_row_major);
  }
  __syncthreads();
  bf16* dkg = static_cast<bf16*>(p.dk);
  bf16* dvg = static_cast<bf16*>(p.dv);
  for (int idx = threadIdx.x; idx < k_valid * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    const long long o =
        ((static_cast<long long>(b) * p.Sk + k0 + r) * p.Hkv + hk) * D + d;
    dkg[o] = __float2bfloat16(sk[r * LDO + d]);
    dvg[o] = __float2bfloat16(sv[r * LDO + d]);
  }
}

// ------------------------------ Hopper bodies (bf16, D 64 and 128): wgmma

// Tensor maps of the operands (dO as `o`), then the scalars.
struct TmaArgs {
  CUtensorMap q, k, v, o;
  BwdParams p;
};

// (p, ds) of one score from q.k and dO.v, with lse given as lse * log2(e);
// CAP: the tanh softcap, MASK: test the pair (a tile that is live
// throughout skips it). A masked pair gives exactly 0.
template <bool CAP, bool MASK>
__device__ __forceinline__ ProbGrad grad_of(const BwdParams& p, float qk,
                                            float dov, float lse_l2,
                                            float delta, int row, int col) {
  float pr, cap_grad = 1.f;
  if (CAP) {
    const float t = tanhf(qk * p.scale * (1.f / p.softcap));
    pr = ex2(fmaf(t * p.softcap, kLog2e, -lse_l2));
    cap_grad = 1.f - t * t;
  } else {
    pr = ex2(fmaf(qk, p.scale * kLog2e, -lse_l2));
  }
  if (MASK && !pair_live(p, row, col)) pr = 0.f;
  float g = pr * (dov - delta);
  if (CAP) g *= cap_grad;
  return {pr, g * p.scale};
}

// K2's ds of a 64 x 64 score tile in the accumulator layout, rounded to
// bf16 A-fragments: ds[2 j + i] holds row row_a + 8 i, columns
// col_a + 8 j + {0, 1}
template <bool CAP, bool MASK>
__device__ __forceinline__ void dq_grads(const BwdParams& p,
                                         const float (&s)[32],
                                         const float (&dp)[32],
                                         const float (&lse_l2)[2],
                                         const float (&delta)[2], int row_a,
                                         int col_a, uint32_t (&ds)[16]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float g[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * j + 2 * i + e;
        g[e] = grad_of<CAP, MASK>(p, s[x], dp[x], lse_l2[i], delta[i],
                                  row_a + 8 * i, col_a + 8 * j + e).ds;
      }
      ds[2 * j + i] = pack_bf16(g[0], g[1]);
    }
}

// K3's p^T and ds^T of a 64 x 64 transposed score tile (rows kv, columns
// q) as bf16 A-fragments, lse * log2(e) and delta of each column from the
// stage
template <bool CAP, bool MASK>
__device__ __forceinline__ void dkv_grads(const BwdParams& p,
                                          const float (&st)[32],
                                          const float (&dpt)[32],
                                          const float* ls, const float* dl,
                                          int kv_a, int q_a, int col_a,
                                          uint32_t (&pt)[16],
                                          uint32_t (&dst)[16]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 lse2 = *reinterpret_cast<const float2*>(ls + 8 * j + col_a);
    const float2 dl2 = *reinterpret_cast<const float2*>(dl + 8 * j + col_a);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float pv[2], gv[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * j + 2 * i + e;
        const ProbGrad pg = grad_of<CAP, MASK>(
            p, st[x], dpt[x], e ? lse2.y : lse2.x,
            e ? dl2.y : dl2.x, q_a + 8 * j + e, kv_a + 8 * i);
        pv[e] = pg.p;
        gv[e] = pg.ds;
      }
      pt[2 * j + i] = pack_bf16(pv[0], pv[1]);
      dst[2 * j + i] = pack_bf16(gv[0], gv[1]);
    }
  }
}


template <int D, int STAGES>
struct DqHopperSmem {
  static constexpr int half = 64 * 128;               // bytes per 64 columns
  static constexpr int q = 0;                         // [D / 64][64][64]
  static constexpr int o = q + 64 * D * 2;            // dO
  static constexpr int kv = o + 64 * D * 2;           // stages: K then V
  static constexpr int stage = 2 * 64 * D * 2;
  static constexpr int bars = kv + STAGES * stage;    // full, empty, resident
  static constexpr int bytes = bars + 8 * (2 * STAGES + 1) + 1024;
};

template <int D, int STAGES>
__global__ void __launch_bounds__(kThreadsTma, 2)
    flash_dq_hopper_kernel(const __grid_constant__ TmaArgs a) {
  using L = DqHopperSmem<D, STAGES>;
  const BwdParams& p = a.p;
  extern __shared__ __align__(1024) unsigned char smem_tma[];
  unsigned char* smem =
      smem_tma + ((1024 - (smem_u32(smem_tma) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + L::bars;
  const uint32_t empty = full + 8 * STAGES;
  const uint32_t resident = empty + 8 * STAGES;

  const int n_qt = (p.Sq + 63) / 64;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.y)) * 64;
  const int b = blockIdx.x / p.Hq;
  const int h = blockIdx.x % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  long long j_lo = 0, j_hi = p.Sk - 1;
  if (p.causal) {
    j_hi = min(j_hi, static_cast<long long>(q0) + 63 + p.q_off - p.k_off);
    j_lo = max(j_lo, static_cast<long long>(q0) + p.q_off - p.k_off -
                         p.window + 1);
  }
  const int t_lo = static_cast<int>(j_lo / 64);
  const int t_hi = j_hi < j_lo ? t_lo - 1 : static_cast<int>(j_hi / 64);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4);
    }
    mbar_init(resident, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 128) {
      mbar_expect_tx(resident, 2 * 64 * D * 2);
      for (int hf = 0; hf < D / 64; ++hf) {
        tma_load_4d(base + L::q + hf * L::half, &a.q, resident, hf * 64, h,
                    q0, b);
        tma_load_4d(base + L::o + hf * L::half, &a.o, resident, hf * 64, h,
                    q0, b);
      }
      int stage = 0, phase = 0;
      for (int t = t_lo; t <= t_hi; ++t) {
        mbar_wait(empty + 8 * stage, phase ^ 1);
        const uint32_t st = base + L::kv + stage * L::stage;
        mbar_expect_tx(full + 8 * stage, L::stage);
        for (int hf = 0; hf < D / 64; ++hf) {
          tma_load_4d(st + hf * L::half, &a.k, full + 8 * stage, hf * 64,
                      hk, t * 64, b);
          tma_load_4d(st + 64 * D * 2 + hf * L::half, &a.v, full + 8 * stage,
                      hf * 64, hk, t * 64, b);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {  // the consumer warpgroup
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int row_a = q0 + 16 * warp + lane / 4;            // + 8 i
    const int col_a = 2 * (lane % 4);                       // + 8 j + e
    const long long stat = (static_cast<long long>(b) * p.Hq + h) * p.Sq;
    float lse_l2[2], delta[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row_a + 8 * i;
      lse_l2[i] = r < p.Sq ? p.lse[stat + r] * kLog2e : 0.f;
      delta[i] = r < p.Sq ? p.delta[stat + r] : 0.f;
    }
    float dq[D / 64][32];
#pragma unroll
    for (int nh = 0; nh < D / 64; ++nh)
#pragma unroll
      for (int x = 0; x < 32; ++x) dq[nh][x] = 0.f;
    mbar_wait(resident, 0);
    // dS K of tile t is issued with the scores of tile t + 1, so the
    // tensor cores see one batch per tile; its stage is released after
    uint32_t ds[16];  // ds[2 j + i]: row + 8 i, columns 8 j + col_a + e
    int stage = 0, phase = 0, prev = -1;
    uint32_t prev_ka = 0;
    for (int t = t_lo; t <= t_hi; ++t) {
      const int k0 = t * 64;
      mbar_wait(full + 8 * stage, phase);
      const uint32_t ka = base + L::kv + stage * L::stage;
      const uint32_t va = ka + 64 * D * 2;
      float s[32], dp[32];
#pragma unroll
      for (int x = 0; x < 32; ++x) s[x] = dp[x] = 0.f;
      wg_fence();
      if (prev >= 0) rs_product<D>(dq, ds, prev_ka);
      scores<D>(s, base + L::q, ka);
      scores<D>(dp, base + L::o, va);
      wg_commit();
      wg_wait0();
      fence_regs(s);
      fence_regs(dp);
#pragma unroll
      for (int nh = 0; nh < D / 64; ++nh) fence_regs(dq[nh]);
      if (prev >= 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * prev);
      }
      const bool masked = !block_live(p, q0, q0 + 63, k0, k0 + 63);
      const int col_k = k0 + col_a;
      if (p.softcap > 0.f) {
        if (masked)
          dq_grads<true, true>(p, s, dp, lse_l2, delta, row_a, col_k, ds);
        else
          dq_grads<true, false>(p, s, dp, lse_l2, delta, row_a, col_k, ds);
      } else if (masked) {
        dq_grads<false, true>(p, s, dp, lse_l2, delta, row_a, col_k, ds);
      } else {
        dq_grads<false, false>(p, s, dp, lse_l2, delta, row_a, col_k, ds);
      }
      prev = stage;
      prev_ka = ka;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    if (prev >= 0) {
      wg_fence();
      rs_product<D>(dq, ds, prev_ka);
      wg_commit();
      wg_wait0();
#pragma unroll
      for (int nh = 0; nh < D / 64; ++nh) fence_regs(dq[nh]);
    }
    store_tile<D>(dq, smem + L::q,
                  static_cast<bf16*>(p.dq) +
                      ((static_cast<long long>(b) * p.Sq + q0) * p.Hq + h) * D,
                  static_cast<long long>(p.Hq) * D, min(64, p.Sq - q0));
  }
}

template <int D, int STAGES>
struct DkvHopperSmem {
  static constexpr int half = 64 * 128;                // bytes per 64 columns
  static constexpr int k = 0;                          // [D / 64][64][64]
  static constexpr int v = k + 64 * D * 2;
  static constexpr int qo = v + 64 * D * 2;            // stages: Q then dO
  static constexpr int stage = 2 * 64 * D * 2;
  static constexpr int stat = qo + STAGES * stage;     // stages: lse, delta
  static constexpr int bars = stat + STAGES * 512;
  static constexpr int bytes = bars + 8 * (2 * STAGES + 1) + 1024;
};

// dv += P^T dO and dk += dS^T Q over one 64-row q tile: P^T and dS^T from
// registers, dO and Q read N-major
template <int D>
__device__ __forceinline__ void kv_products(float (&dk)[D / 64][32],
                                            float (&dv)[D / 64][32],
                                            const uint32_t (&pt)[16],
                                            const uint32_t (&dst)[16],
                                            uint32_t qs, uint32_t os) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int nh = 0; nh < D / 64; ++nh) {
      wgmma_rs(dv[nh], pt[4 * kk], pt[4 * kk + 1], pt[4 * kk + 2],
               pt[4 * kk + 3], sw128_desc(os + nh * 64 * 128 + kk * 2048));
      wgmma_rs(dk[nh], dst[4 * kk], dst[4 * kk + 1], dst[4 * kk + 2],
               dst[4 * kk + 3], sw128_desc(qs + nh * 64 * 128 + kk * 2048));
    }
}

// OVERLAP: the dk / dv products of q tile t go with the scores of tile
// t + 1, as in K2; without it (D 128, where the two 64 x 128 accumulators
// leave no registers for a second tile's fragments) each tile's products
// are issued and waited for in turn.
template <int D, int STAGES, bool OVERLAP>
__global__ void __launch_bounds__(kThreadsTma, 2)
    flash_dkv_hopper_kernel(const __grid_constant__ TmaArgs a) {
  using L = DkvHopperSmem<D, STAGES>;
  const BwdParams& p = a.p;
  extern __shared__ __align__(1024) unsigned char smem_tma[];
  unsigned char* smem =
      smem_tma + ((1024 - (smem_u32(smem_tma) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + L::bars;
  const uint32_t empty = full + 8 * STAGES;
  const uint32_t resident = empty + 8 * STAGES;

  const int k0 = blockIdx.y * 64;
  const int b = blockIdx.x / p.Hkv;
  const int hk = blockIdx.x % p.Hkv;
  const int groups = p.Hq / p.Hkv;
  long long i_lo = 0, i_hi = p.Sq - 1;
  if (p.causal) {
    i_lo = max(i_lo, static_cast<long long>(k0) + p.k_off - p.q_off);
    i_hi = min(i_hi, static_cast<long long>(k0) + 63 + p.k_off - p.q_off +
                         p.window - 1);
  }
  const int t_lo = static_cast<int>(i_lo / 64);
  const int t_hi = i_hi < i_lo ? t_lo - 1 : static_cast<int>(i_hi / 64);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 33);  // the TMA thread's and 32 stat lanes'
      mbar_init(empty + 8 * s, 4);
    }
    mbar_init(resident, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    // its first warp: lane 0 issues the TMA copies, the 32 lanes copy the
    // q tile's lse (times log2(e)) and delta (any Sq: no alignment to meet)
    if (threadIdx.x < 128 + 32) {
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        mbar_expect_tx(resident, 2 * 64 * D * 2);
        for (int hf = 0; hf < D / 64; ++hf) {
          tma_load_4d(base + L::k + hf * L::half, &a.k, resident, hf * 64, hk,
                      k0, b);
          tma_load_4d(base + L::v + hf * L::half, &a.v, resident, hf * 64, hk,
                      k0, b);
        }
      }
      int stage = 0, phase = 0;
      for (int g = 0; g < groups; ++g) {
        const int h = hk * groups + g;
        const long long stat = (static_cast<long long>(b) * p.Hq + h) * p.Sq;
        for (int t = t_lo; t <= t_hi; ++t) {
          mbar_wait(empty + 8 * stage, phase ^ 1);
          const uint32_t bar = full + 8 * stage;
          if (lane == 0) {
            const uint32_t st = base + L::qo + stage * L::stage;
            mbar_expect_tx(bar, L::stage);
            for (int hf = 0; hf < D / 64; ++hf) {
              tma_load_4d(st + hf * L::half, &a.q, bar, hf * 64, h, t * 64,
                          b);
              tma_load_4d(st + 64 * D * 2 + hf * L::half, &a.o, bar, hf * 64,
                          h, t * 64, b);
            }
          }
          float* ls = reinterpret_cast<float*>(smem + L::stat + stage * 512);
#pragma unroll
          for (int i = lane; i < 64; i += 32) {
            const int r = t * 64 + i;
            ls[i] = r < p.Sq ? p.lse[stat + r] * kLog2e : 0.f;
            ls[64 + i] = r < p.Sq ? p.delta[stat + r] : 0.f;
          }
          mbar_arrive(bar);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {  // the consumer warpgroup
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int kv_a = k0 + 16 * warp + lane / 4;            // + 8 i
    const int col_a = 2 * (lane % 4);                      // + 8 j + e
    float dk[D / 64][32], dv[D / 64][32];
#pragma unroll
    for (int nh = 0; nh < D / 64; ++nh)
#pragma unroll
      for (int x = 0; x < 32; ++x) dk[nh][x] = dv[nh][x] = 0.f;
    mbar_wait(resident, 0);
    uint32_t pt[16], dst[16];  // [2 j + i]: kv row + 8 i, q 8 j + col_a + e
    int stage = 0, phase = 0, prev = -1;
    uint32_t prev_qs = 0;
    for (int g = 0; g < groups; ++g) {
      for (int t = t_lo; t <= t_hi; ++t) {
        const int q0 = t * 64;
        mbar_wait(full + 8 * stage, phase);
        const uint32_t qs = base + L::qo + stage * L::stage;
        const uint32_t os = qs + 64 * D * 2;
        const float* ls =
            reinterpret_cast<const float*>(smem + L::stat + stage * 512);
        const float* dl = ls + 64;
        float st[32], dpt[32];  // S^T, dP^T: rows kv, columns q
#pragma unroll
        for (int x = 0; x < 32; ++x) st[x] = dpt[x] = 0.f;
        wg_fence();
        if (OVERLAP && prev >= 0)
          kv_products<D>(dk, dv, pt, dst, prev_qs, prev_qs + 64 * D * 2);
        scores<D>(st, base + L::k, qs);
        scores<D>(dpt, base + L::v, os);
        wg_commit();
        wg_wait0();
        fence_regs(st);
        fence_regs(dpt);
        if (OVERLAP && prev >= 0) {
#pragma unroll
          for (int nh = 0; nh < D / 64; ++nh) {
            fence_regs(dk[nh]);
            fence_regs(dv[nh]);
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + 8 * prev);
        }
        const bool masked = !block_live(p, q0, q0 + 63, k0, k0 + 63);
        const int q_a = q0 + col_a;
        if (p.softcap > 0.f) {
          if (masked)
            dkv_grads<true, true>(p, st, dpt, ls, dl, kv_a, q_a, col_a, pt,
                                  dst);
          else
            dkv_grads<true, false>(p, st, dpt, ls, dl, kv_a, q_a, col_a, pt,
                                   dst);
        } else if (masked) {
          dkv_grads<false, true>(p, st, dpt, ls, dl, kv_a, q_a, col_a, pt,
                                 dst);
        } else {
          dkv_grads<false, false>(p, st, dpt, ls, dl, kv_a, q_a, col_a, pt,
                                  dst);
        }
        if (!OVERLAP) {
          wg_fence();
          kv_products<D>(dk, dv, pt, dst, qs, os);
          wg_commit();
          wg_wait0();
#pragma unroll
          for (int nh = 0; nh < D / 64; ++nh) {
            fence_regs(dk[nh]);
            fence_regs(dv[nh]);
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + 8 * stage);
        }
        prev = stage;
        prev_qs = qs;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    if (OVERLAP && prev >= 0) {
      wg_fence();
      kv_products<D>(dk, dv, pt, dst, prev_qs, prev_qs + 64 * D * 2);
      wg_commit();
      wg_wait0();
#pragma unroll
      for (int nh = 0; nh < D / 64; ++nh) {
        fence_regs(dk[nh]);
        fence_regs(dv[nh]);
      }
    }
    const long long out =
        ((static_cast<long long>(b) * p.Sk + k0) * p.Hkv + hk) * D;
    const int valid = min(64, p.Sk - k0);
    store_tile<D>(dk, smem + L::k, static_cast<bf16*>(p.dk) + out,
                  static_cast<long long>(p.Hkv) * D, valid);
    store_tile<D>(dv, smem + L::v, static_cast<bf16*>(p.dv) + out,
                  static_cast<long long>(p.Hkv) * D, valid);
  }
}

// ----------------------------------------------------------- launches


template <int D, int BQ, int BK>
int launch_fp32(bool dkv, const BwdParams& p, cudaStream_t stream) {
  if (dkv)
    return launch_kernel(flash_dkv_kernel<D, BQ, BK>,
                         dkv_smem_bytes<D, BQ, BK>(),
                         dim3(p.B * p.Hkv, (p.Sk + BK - 1) / BK), kThreads, p,
                         stream);
  return launch_kernel(flash_dq_kernel<D, BQ, BK>, dq_smem_bytes<D, BQ, BK>(),
                       dim3(p.B * p.Hq, (p.Sq + BQ - 1) / BQ), kThreads, p,
                       stream);
}

template <int D>
int launch_wmma(bool dkv, const BwdParams& p, cudaStream_t stream) {
  if (dkv)
    return launch_kernel(flash_dkv_tc_kernel<D>, DkvTcSmem<D>::bytes,
                         dim3(p.B * p.Hkv, (p.Sk + 63) / 64), kThreads, p,
                         stream);
  return launch_kernel(flash_dq_tc_kernel<D>, DqTcSmem<D>::bytes,
                       dim3(p.B * p.Hq, (p.Sq + 63) / 64), kThreads, p,
                       stream);
}


// The Hopper bodies' ring depth and whether K3 overlaps a tile's products
// with the next tile's scores, by D. Both keep two blocks per SM (at most
// 113 KB each). At D 128 a stage holds 32 KB, so the ring has 2; and K3
// does not overlap: its two 64 x 128 fp32 accumulators leave no registers
// for a second tile's fragments.
template <int D>
struct HopperShape {
  static constexpr int stages = D == 64 ? 4 : 2;
  static constexpr bool dkv_overlap = D == 64;
};

template <int D>
int launch_wgmma(bool dkv, const BwdParams& p, cudaStream_t stream) {
  using H = HopperShape<D>;
  if (encode_tiled() == nullptr) return kNoTensorMap;
  TmaArgs a;
  memset(&a, 0, sizeof(a));
  a.p = p;
  if (!(map_bshd(&a.q, p.q, p.B, p.Sq, p.Hq, D, p.q_sb, p.q_ss, p.q_sh) &&
        map_bshd(&a.o, p.dout, p.B, p.Sq, p.Hq, D, p.o_sb, p.o_ss, p.o_sh) &&
        map_bshd(&a.k, p.k, p.B, p.Sk, p.Hkv, D, p.k_sb, p.k_ss, p.k_sh) &&
        map_bshd(&a.v, p.v, p.B, p.Sk, p.Hkv, D, p.v_sb, p.v_ss, p.v_sh)))
    return kNoTensorMap;
  if (dkv)
    return launch_hopper(
        flash_dkv_hopper_kernel<D, H::stages, H::dkv_overlap>,
        DkvHopperSmem<D, H::stages>::bytes,
        dim3(p.B * p.Hkv, (p.Sk + 63) / 64), a, stream);
  return launch_hopper(flash_dq_hopper_kernel<D, H::stages>,
                       DqHopperSmem<D, H::stages>::bytes,
                       dim3(p.B * p.Hq, (p.Sq + 63) / 64), a, stream);
}

// The body of each (dtype, D), the one table of it: `launch` runs what it
// names, and ops/flash_attention.py holds its `_bwd_plan` against
// `flash_bwd_body` when it loads this library.
enum Body { kFma = 0, kWmma = 1, kWgmma = 2 };

int body_for(bool bf16_in, int D) {
  if (D != 64 && D != 128 && D != 256) return -1;
  if (!bf16_in) return kFma;
  return D == 256 ? kWmma : kWgmma;
}

int launch(bool bf16_in, bool dkv, int D, const BwdParams& p,
           cudaStream_t stream) {
  switch (body_for(bf16_in, D)) {
    case kWgmma:
      return D == 64 ? launch_wgmma<64>(dkv, p, stream)
                     : launch_wgmma<128>(dkv, p, stream);
    case kWmma:
      return launch_wmma<256>(dkv, p, stream);
    case kFma:
      if (D == 64) return launch_fp32<64, 64, 64>(dkv, p, stream);
      if (D == 128) return launch_fp32<128, 64, 64>(dkv, p, stream);
      return dkv ? launch_fp32<256, 32, 32>(true, p, stream)
                 : launch_fp32<256, 64, 32>(false, p, stream);
    default:
      return -1;
  }
}

int launch_dtype(bool dkv, int dtype, int D, const BwdParams& p,
                 void* stream) {
  if (p.B < 0 || p.Sq < 0 || p.Sk < 0 || p.Hkv < 1 || p.Hq % p.Hkv != 0 ||
      p.window < 1 ||
      ((dkv ? p.Sk : p.Sq) + 31) / 32 > 65535) {
    return -1;
  }
  if (p.B == 0 || p.Hq == 0 || (dkv ? p.Sk : p.Sq) == 0) return 0;
  if (dtype != kF32 && dtype != kBF16) return -1;
  return launch(dtype == kBF16, dkv, D, p, static_cast<cudaStream_t>(stream));
}

BwdParams make_params(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, void* dk, void* dv, int B, int Sq, int Sk,
                      int Hq, int Hkv, const long long* strides, int causal,
                      int window, int q_off, int k_off, float scale,
                      float softcap) {
  BwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.B = B;
  p.Sq = Sq;
  p.Sk = Sk;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.q_sb = strides[0];
  p.q_ss = strides[1];
  p.q_sh = strides[2];
  p.k_sb = strides[3];
  p.k_ss = strides[4];
  p.k_sh = strides[5];
  p.v_sb = strides[6];
  p.v_ss = strides[7];
  p.v_sh = strides[8];
  p.o_sb = strides[9];
  p.o_ss = strides[10];
  p.o_sh = strides[11];
  p.causal = causal;
  p.window = window;
  p.q_off = q_off;
  p.k_off = k_off;
  p.scale = scale;
  p.softcap = softcap;
  p.vec = 1;
  for (const void* ptr : {q, k, v, dout})
    p.vec &= (reinterpret_cast<uintptr_t>(ptr) % 16) == 0;
  for (int i = 0; i < 12; ++i) p.vec &= (strides[i] % 8) == 0;
  return p;
}

}  // namespace

// Plain C entry points for ctypes. q / dO [B, Sq, Hq, D] and k / v
// [B, Sk, Hkv, D] are read through element strides, 12 int64 in `strides`:
// (b, s, h) of q, k, v, dO in that order, head_dim contiguous. lse / delta
// [B, Hq, Sq] fp32. Outputs are contiguous, allocated by the caller, in the
// inputs' dtype: dq [B, Sq, Hq, D] (flash_bwd_dq); dk, dv [B, Sk, Hkv, D]
// (flash_bwd_dkv). Each returns 0, the cudaError_t of its launch, or -1
// for a shape or dtype the kernel does not take.
// The body that K2 and K3 run for `dtype` (0 fp32, 1 bf16) and head_dim
// `D`: 0 the FMA body, 1 WMMA, 2 wgmma; -1 for a pair they do not take.
extern "C" int flash_bwd_body(int dtype, int D) {
  if (dtype != kF32 && dtype != kBF16) return -1;
  return body_for(dtype == kBF16, D);
}

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, void* dq, int B, int Sq, int Sk,
                            int Hq, int Hkv, int D, const long long* strides,
                            int dtype, int causal, int window, int q_off,
                            int k_off, float scale, float softcap,
                            void* stream) {
  const BwdParams p =
      make_params(q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, Sq, Sk,
                  Hq, Hkv, strides, causal, window, q_off, k_off, scale,
                  softcap);
  return launch_dtype(false, dtype, D, p, stream);
}

extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dk, void* dv, int B,
                             int Sq, int Sk, int Hq, int Hkv, int D,
                             const long long* strides, int dtype, int causal,
                             int window, int q_off, int k_off, float scale,
                             float softcap, void* stream) {
  const BwdParams p =
      make_params(q, k, v, dout, lse, delta, nullptr, dk, dv, B, Sq, Sk, Hq,
                  Hkv, strides, causal, window, q_off, k_off, scale, softcap);
  return launch_dtype(true, dtype, D, p, stream);
}
