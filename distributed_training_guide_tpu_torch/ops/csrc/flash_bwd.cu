// Flash attention backward, hand-written for Hopper (sm_90a): the dq kernel
// and the dk/dv kernel.
//
// Replaces the TPU kernels distributed_training_guide_tpu/ops/
// flash_attention.py `_dq_kernel` (K2) and `_dkv_kernel` (K3), both launched
// by `flash_bwd_with_stats`. Both rebuild each probability tile from the
// caller's logsumexp instead of storing the [S, S] attention matrix:
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
// Design. On the TPU the dq grid (batch, head, q-block, kv-block) and the
// dk/dv grid (batch, kv-head, kv-block, group member, q-block) carry their
// accumulators across the inner steps in VMEM. Here K2 gives each block one
// (q tile of 64 rows, b * Hq + h) and loops over the live kv tiles; K3 gives
// each block one (kv tile, b * Hkv + kv head) and loops over the group's
// query heads and, per head, the live q tiles. So dk and dv sum over the
// group inside one block, in a fixed order: no atomics, deterministic
// results, and the GQA reduction stays on-chip as in the TPU kernel. The
// strided [B, S, H, D] reads are those of the forward, and so is the grid:
// the tile is its slow axis, ordered so that causal blocks launch heaviest
// first (K2 the last q tile, K3 the first kv tile). Two bodies each:
// - bf16 inputs (`flash_dq_tc_kernel`, `flash_dkv_tc_kernel`): tiles in
//   dynamic shared memory as bf16, all products on the tensor cores (WMMA
//   16x16x16, bf16 in, fp32 accumulate). The 8 warps each take two 16 x 16
//   blocks of S = Q K^T and dP = dO V^T, staged through shared memory to a
//   16 x 16 thread grid that forms p and ds; p and ds are rounded to bf16
//   for the products that follow, as flash attention does on GPUs. The
//   dq (K2) and dk / dv (K3) accumulators stay in the warps' WMMA
//   fragments for the whole loop (no rescaling is needed in backward) and
//   go through shared memory once, at the end.
// - fp32 inputs (`flash_dq_kernel`, `flash_dkv_kernel`): tiles as fp32 rows
//   padded by one float, register-blocked FMA on the CUDA cores, the
//   accumulators in registers: full fp32.
//
// Bound on H100: the operations (3 products for dq, 4 for dk/dv, each
// 2 x D per live pair) against the 989 TFLOP/s bf16 tensor-core peak.
// WMMA (mma.sync) staged through shared memory reaches a fraction of it;
// wgmma with TMA is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

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

__device__ __forceinline__ bool pair_live(const BwdParams& p, int row,
                                          int col) {
  const int qpos = row + p.q_off;
  const int kpos = col + p.k_off;
  return row < p.Sq && col < p.Sk &&
         (!p.causal || (qpos >= kpos && qpos - kpos < p.window));
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

// ------------------------------------------ tensor-core bodies (bf16 in)

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

// ----------------------------------------------------------- launches

template <typename K>
int launch_kernel(K kernel, int smem, dim3 grid, const BwdParams& p,
                  cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int BQ, int BK>
int launch_fp32(bool dkv, const BwdParams& p, cudaStream_t stream) {
  if (dkv)
    return launch_kernel(flash_dkv_kernel<D, BQ, BK>,
                         dkv_smem_bytes<D, BQ, BK>(),
                         dim3(p.B * p.Hkv, (p.Sk + BK - 1) / BK), p, stream);
  return launch_kernel(flash_dq_kernel<D, BQ, BK>,
                       dq_smem_bytes<D, BQ, BK>(),
                       dim3(p.B * p.Hq, (p.Sq + BQ - 1) / BQ), p, stream);
}

template <int D>
int launch_bf16(bool dkv, const BwdParams& p, cudaStream_t stream) {
  if (dkv)
    return launch_kernel(flash_dkv_tc_kernel<D>, DkvTcSmem<D>::bytes,
                         dim3(p.B * p.Hkv, (p.Sk + 63) / 64), p, stream);
  return launch_kernel(flash_dq_tc_kernel<D>, DqTcSmem<D>::bytes,
                       dim3(p.B * p.Hq, (p.Sq + 63) / 64), p, stream);
}

int launch(bool bf16_in, bool dkv, int D, const BwdParams& p,
           cudaStream_t stream) {
  switch (D) {
    case 64:
      return bf16_in ? launch_bf16<64>(dkv, p, stream)
                     : launch_fp32<64, 64, 64>(dkv, p, stream);
    case 128:
      return bf16_in ? launch_bf16<128>(dkv, p, stream)
                     : launch_fp32<128, 64, 64>(dkv, p, stream);
    case 256:
      return bf16_in ? launch_bf16<256>(dkv, p, stream)
                     : (dkv ? launch_fp32<256, 32, 32>(true, p, stream)
                            : launch_fp32<256, 64, 32>(false, p, stream));
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
