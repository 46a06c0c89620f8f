// Flash attention forward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel distributed_training_guide_tpu/ops/flash_attention.py
// `_fwd_kernel` (K1, launched by `_flash_fwd`): blockwise online-softmax
// attention with grouped-query heads, a causal / sliding-window band with
// absolute offsets, a score scale and a tanh logit cap, returning O and the
// per-row logsumexp that the backward kernels (flash_bwd.cu) rebuild the
// probabilities from.
//
// What it computes, per batch b and query head h (kv head h / (Hq / Hkv)):
// query row i sits at position i + q_off, key row j at j + k_off. Under
// `causal` the pair is live when 0 <= qpos - kpos < window (window = 2**30
// means no band); without it every key below Sk is live. Scores are
// (q . k) * scale, then tanh(s / softcap) * softcap when softcap > 0, before
// the mask. Masked scores take -1e30 in the running max and contribute
// p = 0. A row with no live key finishes with l = 0 -> safe_l = 1: o = 0 and
// lse = m + log(1) = -1e30, as the TPU kernel gives.
//
// Design. On the TPU the (batch, head, q-block, kv-block) grid runs in order
// and carries m / l / acc across kv-block steps in VMEM. Here each block owns
// one (tile of 64 query rows, b * Hq + h) and loops itself over the kv tiles
// inside the band (the TPU's `_band_live` skip becomes the loop's bounds),
// so blocks are independent: no atomics, no second pass. Tiles are read from
// [B, S, H, D] through the caller's strides (head_dim contiguous), so the
// public function needs no transposes. The q tile is the grid's slow axis,
// reversed, so under causal masking the blocks launch heaviest first (every
// head's last tile before any head's next-to-last), which keeps the tail
// short. Which body runs depends on the dtype and D alone (`body_for`,
// exported as `flash_fwd_body`):
// - bf16, D 64 and 128 (`flash_fwd_hopper_kernel`): the shape of K2's
//   Hopper body (flash_bwd.cu). A block is one consumer warpgroup (64 query
//   rows) and one producer warpgroup that gives up its registers
//   (`setmaxnreg`), two blocks per SM. The Q tile is loaded once by TMA and
//   stays; one producer thread feeds the K and V tiles (4-D tensor maps
//   over [B, S, H, D], 128-byte swizzle, rows past S zero-filled) into a
//   ring of shared-memory stages under full / empty `mbarrier`s. S = Q K^T
//   is one wgmma batch (m64n64k16, both operands in shared memory, fp32
//   accumulators in registers); the online softmax runs in the
//   accumulator's own layout (each register's row and column known from
//   its index, a row's max and sum two quad shuffles), the band mask and
//   the softcap specialised per tile (only tiles on the band's edges test
//   pairs); p is rounded to bf16 into A fragments in registers and
//   O += P V runs as `wgmma` with A from registers and V read N-major from
//   the same stage, issued in the same batch as the next tile's scores.
//   m, l and O stay in registers; O leaves through the dead Q tile and
//   16-byte stores. Scores are exponentiated in base 2 with the scale
//   folded in.
// - bf16, D 256 (`flash_fwd_tc_kernel`): the WMMA body of the first port
//   (8 warps as a 16 x 16 thread grid, S and P V staged through shared
//   memory), as K2 / K3 keep at D 256.
// - fp32 (`flash_fwd_kernel`): the tiles sit in shared memory as fp32 (rows
//   padded by one float against bank conflicts) and both products are
//   register-blocked FMA on the CUDA cores: full fp32, for references and
//   fp32 training.
// The bf16 bodies round p to bf16 for P V, as flash attention does on
// GPUs; the row sums use p unrounded.
//
// Bound on H100: the operations (2 products x 2 x D per live pair) against
// the 989 TFLOP/s bf16 tensor-core peak; the bytes (q, k, v read, o and lse
// written once) are a few percent of it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"  // barriers, TMA, wgmma, tensor maps

namespace {

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kThreads = 256;      // a 16 x 16 thread grid
constexpr unsigned kFull = 0xffffffffu;

enum DType { kF32 = 0, kBF16 = 1 };

struct FwdParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;      // [B, Sq, Hq, D] contiguous, q's dtype
  float* lse;   // [B, Hq, Sq]
  int B, Sq, Sk, Hq, Hkv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int causal, window, q_off, k_off;
  float scale, softcap;
  int vec;  // every tile row starts 16-byte aligned: copy 8 bf16 at a time
};

// ---- the fp32 body (FMA on the CUDA cores)

// rows [0, rows) of a [rows, D] tile into shared memory (row stride D + 1),
// zero past `valid` rows
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

// s[a][c] = sum_d A[ty + 16 a][d] * B[tx + 16 c][d], row strides D + 1
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

// reductions over the 16 lanes (one half-warp) that share a row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

template <int D, int BQ, int BK>
constexpr int fwd_smem_bytes() {
  return ((BQ + 2 * BK) * (D + 1) + BQ * (BK + 1)) * 4;
}

template <int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const FwdParams p) {
  constexpr int RA = BQ / 16;  // query rows per thread
  constexpr int RC = BK / 16;  // key columns per thread
  constexpr int DC = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                       // [BQ][D + 1]
  float* Ks = Qs + BQ * (D + 1);          // [BK][D + 1]
  float* Vs = Ks + BK * (D + 1);          // [BK][D + 1]
  float* Ps = Vs + BK * (D + 1);          // [BQ][BK + 1]

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int n_qt = (p.Sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.y)) * BQ;
  const int b = blockIdx.x / p.Hq;
  const int h = blockIdx.x % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const float* qg =
      static_cast<const float*>(p.q) + b * p.q_sb + q0 * p.q_ss + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh;

  load_tile<D>(Qs, qg, p.q_ss, BQ, min(BQ, p.Sq - q0));

  // live kv rows of this q tile: the band's edges for its newest and
  // oldest rows (the TPU kernel's _band_live skip, as loop bounds)
  long long j_lo = 0, j_hi = p.Sk - 1;
  if (p.causal) {
    j_hi = min(j_hi, static_cast<long long>(q0) + BQ - 1 + p.q_off - p.k_off);
    j_lo = max(j_lo, static_cast<long long>(q0) + p.q_off - p.k_off -
                         p.window + 1);
  }
  const int t_lo = static_cast<int>(j_lo / BK);
  const int t_hi = j_hi < j_lo ? t_lo - 1 : static_cast<int>(j_hi / BK);

  float m_run[RA], l_run[RA], acc[RA][DC];
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    m_run[a] = kNegInf;
    l_run[a] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[a][c] = 0.f;
  }

  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's K / V / P reads are done
    load_tile<D>(Ks, kg + k0 * p.k_ss, p.k_ss, BK, min(BK, p.Sk - k0));
    load_tile<D>(Vs, vg + k0 * p.v_ss, p.v_ss, BK, min(BK, p.Sk - k0));
    __syncthreads();

    float s[RA][RC];
    tile_dot<RA, RC, D>(Qs, Ks, ty, tx, s);
    bool live[RA][RC];
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      const int qpos = q0 + ty + 16 * a + p.q_off;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < RC; ++c) {
        const int col = k0 + tx + 16 * c;
        const int kpos = col + p.k_off;
        float x = s[a][c] * p.scale;
        if (p.softcap > 0.f) x = tanhf(x / p.softcap) * p.softcap;
        live[a][c] = col < p.Sk && (!p.causal || (qpos >= kpos &&
                                                  qpos - kpos < p.window));
        s[a][c] = live[a][c] ? x : kNegInf;
        mx = fmaxf(mx, s[a][c]);
      }
      const float m_new = fmaxf(m_run[a], row_max(mx));
      const float alpha = expf(m_run[a] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < RC; ++c) {
        const float pr = live[a][c] ? expf(s[a][c] - m_new) : 0.f;
        Ps[(ty + 16 * a) * (BK + 1) + tx + 16 * c] = pr;
        rs += pr;
      }
      l_run[a] = l_run[a] * alpha + row_sum(rs);
      m_run[a] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[a][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[RA], vv[DC];
#pragma unroll
      for (int a = 0; a < RA; ++a) pv[a] = Ps[(ty + 16 * a) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = Vs[j * (D + 1) + tx + 16 * c];
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[a][c] = fmaf(pv[a], vv[c], acc[a][c]);
    }
  }

  float* og = static_cast<float*>(p.o);
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int row = q0 + ty + 16 * a;
    if (row >= p.Sq) continue;
    const float safe_l = l_run[a] == 0.f ? 1.f : l_run[a];
    const long long base =
        ((static_cast<long long>(b) * p.Sq + row) * p.Hq + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      og[base + tx + 16 * c] = acc[a][c] / safe_l;
    if (tx == 0)
      p.lse[(static_cast<long long>(b) * p.Hq + h) * p.Sq + row] =
          m_run[a] + logf(safe_l);
  }
}

// ---- the bf16 body (WMMA on the tensor cores)

// rows [0, rows) of a [rows, D] bf16 tile into shared memory (row stride
// D + 8), zero past `valid` rows
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

// byte offsets of the tensor-core kernel's shared memory (64 x 64 tiles;
// every region 32-byte aligned, as WMMA loads and stores need)
template <int D>
struct FwdTcSmem {
  static constexpr int kLdt = D + 8;   // bf16 q / k / v rows
  static constexpr int kLds = 64 + 4;  // fp32 score rows
  static constexpr int kLdp = 64 + 8;  // bf16 probability rows
  static constexpr int kLdo = D + 4;   // fp32 P V rows
  static constexpr int q = 0;
  static constexpr int k = q + 64 * kLdt * 2;
  static constexpr int v = k + 64 * kLdt * 2;
  static constexpr int s = v + 64 * kLdt * 2;
  static constexpr int p = s + 64 * kLds * 4;
  static constexpr int o = p + 64 * kLdp * 2;
  static constexpr int bytes = o + 64 * kLdo * 4;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_tc_kernel(const FwdParams p) {
  using L = FwdTcSmem<D>;
  constexpr int BQ = 64, BK = 64;
  constexpr int RA = 4, RC = 4;  // score rows / columns per thread
  constexpr int DC = D / 16;     // output columns per thread
  constexpr int NC = D / 32;     // 16-wide P V column blocks per warp
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw + L::q);
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw + L::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem_raw + L::v);
  float* Ss = reinterpret_cast<float*>(smem_raw + L::s);
  bf16* Ps = reinterpret_cast<bf16*>(smem_raw + L::p);
  float* Os = reinterpret_cast<float*>(smem_raw + L::o);

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int warp = threadIdx.x / 32;
  const int rb = warp / 2;  // this warp's 16-row block of S and P V
  const int n_qt = (p.Sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.y)) * BQ;
  const int b = blockIdx.x / p.Hq;
  const int h = blockIdx.x % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  load_tile_bf16<D>(Qs, static_cast<const bf16*>(p.q) + b * p.q_sb +
                            q0 * p.q_ss + h * p.q_sh,
                    p.q_ss, BQ, min(BQ, p.Sq - q0), p.vec);

  long long j_lo = 0, j_hi = p.Sk - 1;
  if (p.causal) {
    j_hi = min(j_hi, static_cast<long long>(q0) + BQ - 1 + p.q_off - p.k_off);
    j_lo = max(j_lo, static_cast<long long>(q0) + p.q_off - p.k_off -
                         p.window + 1);
  }
  const int t_lo = static_cast<int>(j_lo / BK);
  const int t_hi = j_hi < j_lo ? t_lo - 1 : static_cast<int>(j_hi / BK);

  float m_run[RA], l_run[RA], alpha[RA], acc[RA][DC];
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    m_run[a] = kNegInf;
    l_run[a] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[a][c] = 0.f;
  }

  for (int t = t_lo; t <= t_hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's reads are done
    load_tile_bf16<D>(Ks, kg + k0 * p.k_ss, p.k_ss, BK, min(BK, p.Sk - k0),
                      p.vec);
    load_tile_bf16<D>(Vs, vg + k0 * p.v_ss, p.v_ss, BK, min(BK, p.Sk - k0),
                      p.vec);
    __syncthreads();
    {  // S = Q K^T: blocks (rb, 2 (warp % 2)) and (rb, 2 (warp % 2) + 1)
      const int cb = 2 * (warp % 2);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c0, c1;
      wmma::fill_fragment(c0, 0.f);
      wmma::fill_fragment(c1, 0.f);
#pragma unroll
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b0,
            b1;
        wmma::load_matrix_sync(a, Qs + rb * 16 * L::kLdt + kk, L::kLdt);
        wmma::load_matrix_sync(b0, Ks + cb * 16 * L::kLdt + kk, L::kLdt);
        wmma::load_matrix_sync(b1, Ks + (cb + 1) * 16 * L::kLdt + kk,
                               L::kLdt);
        wmma::mma_sync(c0, a, b0, c0);
        wmma::mma_sync(c1, a, b1, c1);
      }
      wmma::store_matrix_sync(Ss + rb * 16 * L::kLds + cb * 16, c0, L::kLds,
                              wmma::mem_row_major);
      wmma::store_matrix_sync(Ss + rb * 16 * L::kLds + (cb + 1) * 16, c1,
                              L::kLds, wmma::mem_row_major);
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < RA; ++a) {
      const int r = ty + 16 * a;
      const int qpos = q0 + r + p.q_off;
      float s[RC];
      bool live[RC];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < RC; ++c) {
        const int col = k0 + tx + 16 * c;
        const int kpos = col + p.k_off;
        float x = Ss[r * L::kLds + tx + 16 * c] * p.scale;
        if (p.softcap > 0.f) x = tanhf(x / p.softcap) * p.softcap;
        live[c] = col < p.Sk && (!p.causal || (qpos >= kpos &&
                                               qpos - kpos < p.window));
        s[c] = live[c] ? x : kNegInf;
        mx = fmaxf(mx, s[c]);
      }
      const float m_new = fmaxf(m_run[a], row_max(mx));
      alpha[a] = expf(m_run[a] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < RC; ++c) {
        const float pr = live[c] ? expf(s[c] - m_new) : 0.f;
        Ps[r * L::kLdp + tx + 16 * c] = __float2bfloat16(pr);
        rs += pr;
      }
      l_run[a] = l_run[a] * alpha[a] + row_sum(rs);
      m_run[a] = m_new;
    }
    __syncthreads();
    {  // P V: rows rb, column blocks (warp % 2) NC .. + NC - 1
      const int cb = (warp % 2) * NC;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[NC];
#pragma unroll
      for (int n = 0; n < NC; ++n) wmma::fill_fragment(c[n], 0.f);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, Ps + rb * 16 * L::kLdp + kk, L::kLdp);
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> v;
          wmma::load_matrix_sync(v, Vs + kk * L::kLdt + (cb + n) * 16,
                                 L::kLdt);
          wmma::mma_sync(c[n], a, v, c[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < NC; ++n)
        wmma::store_matrix_sync(Os + rb * 16 * L::kLdo + (cb + n) * 16, c[n],
                                L::kLdo, wmma::mem_row_major);
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int c = 0; c < DC; ++c)
        acc[a][c] = fmaf(acc[a][c], alpha[a],
                         Os[(ty + 16 * a) * L::kLdo + tx + 16 * c]);
  }

  bf16* og = static_cast<bf16*>(p.o);
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int row = q0 + ty + 16 * a;
    if (row >= p.Sq) continue;
    const float safe_l = l_run[a] == 0.f ? 1.f : l_run[a];
    const long long base =
        ((static_cast<long long>(b) * p.Sq + row) * p.Hq + h) * D;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      og[base + tx + 16 * c] = __float2bfloat16(acc[a][c] / safe_l);
    if (tx == 0)
      p.lse[(static_cast<long long>(b) * p.Hq + h) * p.Sq + row] =
          m_run[a] + logf(safe_l);
  }
}

// ---- the Hopper body (bf16, D 64 and 128): TMA ring, wgmma

// Tensor maps of q, k and v, then the scalars.
struct FwdTmaArgs {
  CUtensorMap q, k, v;
  FwdParams p;
};

template <int D, int STAGES>
struct FwdHopperSmem {
  static constexpr int half = 64 * 128;               // bytes per 64 columns
  static constexpr int q = 0;                         // [D / 64][64][64]
  static constexpr int kv = q + 64 * D * 2;           // stages: K then V
  static constexpr int stage = 2 * 64 * D * 2;
  static constexpr int bars = kv + STAGES * stage;    // full, empty, resident
  static constexpr int bytes = bars + 8 * (2 * STAGES + 1) + 1024;
};

// One 64 x 64 score tile in the accumulator layout (s[4 j + 2 i + e]: row
// row_a + 8 i, column col_k + 8 j + e) into probabilities. The running
// max m2 (in units of log2: score x scale x log2(e)) moves to the tile's
// row max, o and l rescale by exp2(m2_old - m2_new), and p = exp2(s - m2)
// leaves as bf16 A fragments (pf[2 j + i]: row + 8 i, columns 8 j + e);
// l sums p unrounded, per thread (its quad's four parts are added at the
// end). CAP: the tanh softcap; MASK: test each pair (a tile that is live
// throughout skips it). Masked pairs give p = 0, also on a row that has
// seen no live key yet (its m2 still -1e30).
template <int D, bool CAP, bool MASK>
__device__ __forceinline__ void softmax_tile(const FwdParams& p,
                                             float (&s)[32], float (&m2)[2],
                                             float (&l)[2],
                                             float (&o)[D / 64][32],
                                             uint32_t (&pf)[16], int row_a,
                                             int col_k) {
  float mx[2] = {m2[0], m2[1]};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 4 * j + 2 * i + e;
        float v;
        if (CAP)
          v = tanhf(s[x] * p.scale * (1.f / p.softcap)) * p.softcap * kLog2e;
        else
          v = s[x] * (p.scale * kLog2e);
        if (MASK && !pair_live(p, row_a + 8 * i, col_k + 8 * j + e))
          v = kNegInf;
        s[x] = v;
        mx[i] = fmaxf(mx[i], v);
      }
  float alpha[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
    alpha[i] = ex2(m2[i] - mx[i]);
    m2[i] = mx[i];
    l[i] *= alpha[i];
  }
#pragma unroll
  for (int nh = 0; nh < D / 64; ++nh)
#pragma unroll
    for (int x = 0; x < 32; ++x) o[nh][x] *= alpha[(x / 2) % 2];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float pr[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        pr[e] = ex2(s[4 * j + 2 * i + e] - m2[i]);
        if (MASK && m2[i] == kNegInf) pr[e] = 0.f;
      }
      l[i] += pr[0] + pr[1];
      pf[2 * j + i] = pack_bf16(pr[0], pr[1]);
    }
}

// BLOCKS per SM; the consumer warpgroup's registers after setmaxnreg are
// CREGS (at launch 65536 / (256 BLOCKS), rounded down to 8, a thread; the
// producer's 24 go to the consumer)
template <int D, int STAGES, int BLOCKS, int CREGS>
__global__ void __launch_bounds__(kThreadsTma, BLOCKS)
    flash_fwd_hopper_kernel(const __grid_constant__ FwdTmaArgs a) {
  using L = FwdHopperSmem<D, STAGES>;
  const FwdParams& p = a.p;
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
      mbar_expect_tx(resident, 64 * D * 2);
      for (int hf = 0; hf < D / 64; ++hf)
        tma_load_4d(base + L::q + hf * L::half, &a.q, resident, hf * 64, h,
                    q0, b);
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
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CREGS));
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const int row_a = q0 + 16 * warp + lane / 4;            // + 8 i
    const int col_a = 2 * (lane % 4);                       // + 8 j + e
    float o[D / 64][32];
#pragma unroll
    for (int nh = 0; nh < D / 64; ++nh)
#pragma unroll
      for (int x = 0; x < 32; ++x) o[nh][x] = 0.f;
    float m2[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    mbar_wait(resident, 0);
    // P V of tile t is issued with the scores of tile t + 1, so the tensor
    // cores see one batch per tile; its stage is released after
    uint32_t pf[16];  // pf[2 j + i]: row + 8 i, columns 8 j + col_a + e
    int stage = 0, phase = 0, prev = -1;
    uint32_t prev_va = 0;
    for (int t = t_lo; t <= t_hi; ++t) {
      const int k0 = t * 64;
      mbar_wait(full + 8 * stage, phase);
      const uint32_t ka = base + L::kv + stage * L::stage;
      float s[32];
#pragma unroll
      for (int x = 0; x < 32; ++x) s[x] = 0.f;
      wg_fence();
      if (prev >= 0) rs_product<D>(o, pf, prev_va);
      scores<D>(s, base + L::q, ka);
      wg_commit();
      wg_wait0();
      fence_regs(s);
#pragma unroll
      for (int nh = 0; nh < D / 64; ++nh) fence_regs(o[nh]);
      if (prev >= 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * prev);
      }
      const bool masked = !block_live(p, q0, q0 + 63, k0, k0 + 63);
      const int col_k = k0 + col_a;
      if (p.softcap > 0.f) {
        if (masked)
          softmax_tile<D, true, true>(p, s, m2, l, o, pf, row_a, col_k);
        else
          softmax_tile<D, true, false>(p, s, m2, l, o, pf, row_a, col_k);
      } else if (masked) {
        softmax_tile<D, false, true>(p, s, m2, l, o, pf, row_a, col_k);
      } else {
        softmax_tile<D, false, false>(p, s, m2, l, o, pf, row_a, col_k);
      }
      prev = stage;
      prev_va = ka + 64 * D * 2;
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    if (prev >= 0) {
      wg_fence();
      rs_product<D>(o, pf, prev_va);
      wg_commit();
      wg_wait0();
#pragma unroll
      for (int nh = 0; nh < D / 64; ++nh) fence_regs(o[nh]);
    }
    // o / l and lse = m + log(l) per row; a row with no live key (l = 0)
    // gives o = 0 and lse = -1e30
    float inv[2];
    const long long stat = (static_cast<long long>(b) * p.Hq + h) * p.Sq;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(kFull, l[i], 1);
      l[i] += __shfl_xor_sync(kFull, l[i], 2);
      inv[i] = l[i] == 0.f ? 1.f : 1.f / l[i];
      const int row = row_a + 8 * i;
      if (lane % 4 == 0 && row < p.Sq)
        p.lse[stat + row] =
            l[i] == 0.f ? kNegInf : m2[i] * kLn2 + logf(l[i]);
    }
#pragma unroll
    for (int nh = 0; nh < D / 64; ++nh)
#pragma unroll
      for (int x = 0; x < 32; ++x) o[nh][x] *= inv[(x / 2) % 2];
    store_tile<D>(o, smem + L::q,
                  static_cast<bf16*>(p.o) +
                      ((static_cast<long long>(b) * p.Sq + q0) * p.Hq + h) * D,
                  static_cast<long long>(p.Hq) * D, min(64, p.Sq - q0));
  }
}

template <int D, int BQ, int BK>
int launch_fp32(const FwdParams& p, cudaStream_t stream) {
  return launch_kernel(flash_fwd_kernel<D, BQ, BK>, fwd_smem_bytes<D, BQ, BK>(),
                       dim3(p.B * p.Hq, (p.Sq + BQ - 1) / BQ), kThreads, p,
                       stream);
}

template <int D>
int launch_bf16(const FwdParams& p, cudaStream_t stream) {
  return launch_kernel(flash_fwd_tc_kernel<D>, FwdTcSmem<D>::bytes,
                       dim3(p.B * p.Hq, (p.Sq + 63) / 64), kThreads, p,
                       stream);
}

// The Hopper body's shape by D. D 64: three blocks per SM (73 KB each, 136
// registers a consumer thread: o, s and p fit), a 4-deep ring. D 128: two
// (the 64 x 128 accumulator needs more registers), at most 113 KB each, so
// with 32 KB stages the ring has 2.
template <int D>
struct FwdShape {
  static constexpr int stages = D == 64 ? 4 : 2;
  static constexpr int blocks = D == 64 ? 3 : 2;
  static constexpr int cregs = D == 64 ? 136 : kConsumerRegs;
};

template <int D>
int launch_wgmma(const FwdParams& p, cudaStream_t stream) {
  using S = FwdShape<D>;
  if (encode_tiled() == nullptr) return kNoTensorMap;
  FwdTmaArgs a;
  memset(&a, 0, sizeof(a));
  a.p = p;
  if (!(map_bshd(&a.q, p.q, p.B, p.Sq, p.Hq, D, p.q_sb, p.q_ss, p.q_sh) &&
        map_bshd(&a.k, p.k, p.B, p.Sk, p.Hkv, D, p.k_sb, p.k_ss, p.k_sh) &&
        map_bshd(&a.v, p.v, p.B, p.Sk, p.Hkv, D, p.v_sb, p.v_ss, p.v_sh)))
    return kNoTensorMap;
  return launch_hopper<S::cregs>(
      flash_fwd_hopper_kernel<D, S::stages, S::blocks, S::cregs>,
      FwdHopperSmem<D, S::stages>::bytes, dim3(p.B * p.Hq, (p.Sq + 63) / 64),
      a, stream);
}

// The body of each (dtype, D), the one table of it: `launch` runs what it
// names, and ops/flash_attention.py holds its `_fwd_plan` against
// `flash_fwd_body` when it loads this library.
enum Body { kFma = 0, kWmma = 1, kWgmma = 2 };

int body_for(bool bf16_in, int D) {
  if (D != 64 && D != 128 && D != 256) return -1;
  if (!bf16_in) return kFma;
  return D == 256 ? kWmma : kWgmma;
}

int launch(bool bf16_in, int D, const FwdParams& p, cudaStream_t stream) {
  switch (body_for(bf16_in, D)) {
    case kWgmma:
      return D == 64 ? launch_wgmma<64>(p, stream)
                     : launch_wgmma<128>(p, stream);
    case kWmma:
      return launch_bf16<256>(p, stream);
    case kFma:
      if (D == 64) return launch_fp32<64, 64, 64>(p, stream);
      if (D == 128) return launch_fp32<128, 64, 64>(p, stream);
      return launch_fp32<256, 64, 32>(p, stream);
    default:
      return -1;
  }
}

}  // namespace

// Plain C entry points for ctypes.
// The body that K1 runs for `dtype` (0 fp32, 1 bf16) and head_dim `D`: 0
// the FMA body, 1 WMMA, 2 wgmma; -1 for a pair it does not take.
extern "C" int flash_fwd_body(int dtype, int D) {
  if (dtype != kF32 && dtype != kBF16) return -1;
  return body_for(dtype == kBF16, D);
}

// K1: q [B, Sq, Hq, D], k / v [B, Sk, Hkv, D]
// read through element strides, 9 int64 in `strides`: (b, s, h) of q, k, v
// in that order, head_dim contiguous; o [B, Sq, Hq, D] contiguous in q's
// dtype and lse [B, Hq, Sq] fp32, both allocated by the caller. Returns 0,
// the cudaError_t of the launch, -2 for a tensor map the driver refused,
// -3 for too few registers at launch for `setmaxnreg`, or -1 for a shape or
// dtype the kernel does not take.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int Sq, int Sk, int Hq, int Hkv,
                         int D, const long long* strides, int dtype,
                         int causal, int window, int q_off, int k_off,
                         float scale, float softcap, void* stream) {
  if (B < 0 || Sq < 0 || Sk < 0 || Hkv < 1 || Hq % Hkv != 0 || window < 1 ||
      (Sq + 31) / 32 > 65535) {
    return -1;
  }
  if (B == 0 || Sq == 0 || Hq == 0) return 0;
  FwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
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
  p.causal = causal;
  p.window = window;
  p.q_off = q_off;
  p.k_off = k_off;
  p.scale = scale;
  p.softcap = softcap;
  p.vec = 1;
  for (const void* ptr : {q, k, v})
    p.vec &= (reinterpret_cast<uintptr_t>(ptr) % 16) == 0;
  for (int i = 0; i < 9; ++i) p.vec &= (strides[i] % 8) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != kF32 && dtype != kBF16) return -1;
  return launch(dtype == kBF16, D, p, st);
}
