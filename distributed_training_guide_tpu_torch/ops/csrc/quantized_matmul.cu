// Block-dequant matmul for int8 serve weights, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernel of distributed_training_guide_tpu/ops/
// quantized_matmul.py, `_dequant_matmul_kernel` (K7, launched by
// `_matmul_pallas`), as `qmm`:
//   out[m, n] = sum_k x[m, k] * (float(q[k, n]) * scale[k, n / bs])
// summed in fp32, with x [M, K] fp32 or bf16, q [K, N] int8, scale
// [K, nb] fp32 (nb = ceil(N / bs)), out [M, N] fp32 or bf16 (rounded once
// from the fp32 sum). Any bs >= 1, a short last block (columns past N are
// neither read nor written), any K and M.
//
// Design. The TPU kernel runs one grid step per column block with the
// whole [M, K] activation and the [K, bs] int8 block in VMEM, dequantizes
// the block there and makes one MXU product. Here two bodies, by the
// operands' dtypes, strides and alignment alone (`body_for`, exported as
// `qmm_body`):
// - The tensor-core body (`qmm_tc_kernel`: bf16 x, and q, x and scale
//   that tensor maps can read: every base and row on 16 bytes). It
//   computes out^T = W^T x^T, as the public mixed-input kernels (Marlin,
//   Machete) swap their operands: the weights are wgmma's A, from
//   registers, and the tokens its N, so a decode step (8 tokens) runs
//   m64n8k16 and wastes no tensor work, and shared memory carries one
//   byte per weight. A block is a producer warp and two consumer
//   warpgroups, each with one 64-row A tile (64 weight columns): 128
//   columns times T tokens (8 to 128, the least that holds M, else
//   128-token tiles), the x tile shared by both. The producer
//   streams 64-deep k chunks of q (int8, [64 k][128 n]), of x (bf16, [T][64
//   k], read by wgmma as a K-major B) and of the chunk's scales by TMA into
//   a ring. A consumer reads each weight from shared memory, forms w =
//   float(q) * s in fp32 as the plain version does, splits it into w_hi =
//   bf16(w) and w_lo = bf16(w - w_hi) (the A fragments) and issues two
//   products per k step of 16, hi then lo, into the chunk's accumulator;
//   at the chunk's end that is added to an fp32 register sum, rounded to
//   nearest (the tensor cores' own sum over k steps truncates, and over
//   thousands of k would drift past an fp32 sum's error:
//   `chip_smoke.py:tc_sum_drift`). bf16 x is exact;
//   the split is not: w_hi + w_lo misses w by at most 2**-16 |w| (about
//   2**-18 typically, a few 1e-6 relative L2 of an output), against the
//   2**-24 rounding of the plain fp32 product. The fragments of a k step
//   are built while the previous step's products run; the two sums in
//   registers (64 a thread each at T = 128) cap a warpgroup's A tile at 64
//   columns.
// - The FMA body (`qmm_kernel`: fp32 x, which is not exact in bf16, and
//   operands no tensor map reads, e.g. N % 16 != 0): a block of 8 warps
//   owns an 8-row x 128-column output tile (4 columns per lane, 8 rows per
//   thread: 32 sums in registers). Each warp walks one piece of K: it
//   stages its 8 rows of x for 32 k at a time in shared memory as fp32,
//   loads 16 (8 with per-column scales) int8 rows of its 4 columns ahead
//   with their scales, dequantizes them in registers and accumulates by
//   FMA, one fmaf per k in ascending order; the block sums its 8 warps'
//   partials through shared memory in warp order.
// In both, G blocks (blockIdx.z) share a tile's sum over K, each one piece
// of K in order, G from (K, N) and the body alone (`qmm_splits`): enough
// blocks to fill the card at decode, where a 1024-wide projection has only
// 8 column tiles. With G = 1 a block writes the output, else its fp32
// partial goes to a workspace [G, M, N] and `qmm_reduce_kernel` sums the G
// partials in order and rounds once. The order of every output's sum
// therefore depends on (K, N) and the body only: no sum crosses a token,
// the k steps run in one order whatever the tile, and there are no
// atomics. A row's result is bitwise the same in a product of any M
// (batch invariance of the serve engine), and a bf16 output is the
// rounding of the fp32 one.
//
// Bound on H100. At decode (M = 8) a product moves its int8 weight and
// fp32 scales once (1.125 bytes per weight at bs = 32): bytes over 3.35
// TB/s bound it. The tensor-core body spends about 7 instructions a
// weight on the dequantize and split while a deep ring keeps 8 KB loads
// in flight per stage; the FMA body does 16 fp32 operations a weight. At
// prefill sizes (M in the hundreds and more) operations bound it: two bf16
// passes against 989 TFLOP/s on the tensor cores (the FMA body: one fp32
// pass against 67 on the CUDA cores); blockIdx.x is the token tile, so the
// token tiles of one column tile run together and re-read its weights
// from L2.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <string.h>

#include <algorithm>

#include "hopper.cuh"  // barriers, TMA, wgmma, tensor maps

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;          // output rows per block, whatever M is
constexpr int kCols = 128;        // output columns per block: 4 per lane
constexpr int kChunk = 32;        // k of x staged per warp at a time
constexpr int kMinPiece = 64;     // k-rows a piece has at least
constexpr int kTargetBlocks = 4 * 132;  // four blocks per SM of an H100

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

struct QmmParams {
  const void* x;       // [M, K] contiguous, fp32 or bf16
  const int8_t* q;     // [K, N] contiguous
  const float* scale;  // [K, nb] contiguous
  void* out;           // [M, N] contiguous, the output dtype
  float* ws;           // [G, M, N] fp32 partials when G > 1
  int M, K, N, nb, bs, G;
  int piece;           // k-rows per piece: ceil(K / (8 G))
};

// kVec: N % 4 == 0 and q 4-byte aligned, so a lane's 4 columns are one
// 32-bit load (and all in range or all out). kOneScale: kVec and bs % 4 ==
// 0, so the 4 columns share one scale. kUnroll: weight rows loaded ahead.
template <typename XT, typename OT, bool kVec, bool kOneScale, int kUnroll>
__global__ void __launch_bounds__(kThreads)
qmm_kernel(const QmmParams p) {
  __shared__ __align__(16) float xs[kWarps][kChunk][kRows];
  __shared__ __align__(16) float red[kWarps][kRows][kCols];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * kRows;
  const int n0 = blockIdx.y * kCols + lane * 4;  // this lane's 4 columns
  const int piece = blockIdx.z * kWarps + warp;
  const int kb = min(piece * p.piece, p.K);
  const int ke = min(kb + p.piece, p.K);
  const XT* x = static_cast<const XT*>(p.x);

  bool live[4];
  int sidx[4];  // each column's scale block
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    live[j] = n0 + j < p.N;
    sidx[j] = live[j] ? (n0 + j) / p.bs : 0;
  }
  float acc[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;

  for (int c0 = kb; c0 < ke; c0 += kChunk) {
    const int cn = min(kChunk, ke - c0);
    __syncwarp();  // the previous chunk's reads of xs are done
    for (int i = lane; i < kChunk * kRows; i += 32) {
      const int r = i / kChunk;
      const int kk = i - r * kChunk;
      const int row = m0 + r;
      xs[warp][kk][r] = (row < p.M && kk < cn)
                            ? to_f32(x[static_cast<long long>(row) * p.K +
                                       c0 + kk])
                            : 0.f;
    }
    __syncwarp();
    for (int u0 = 0; u0 < cn; u0 += kUnroll) {
      // kUnroll weight rows of this lane's 4 columns, with their scales
      char4 qv[kUnroll];
      float sv[kUnroll][kOneScale ? 1 : 4];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = c0 + u0 + u;
        const bool in = u0 + u < cn;
        const int8_t* qrow = p.q + static_cast<long long>(k) * p.N + n0;
        const float* srow = p.scale + static_cast<long long>(k) * p.nb;
        if constexpr (kVec) {
          qv[u] = (in && live[0]) ? __ldg(reinterpret_cast<const char4*>(qrow))
                                  : make_char4(0, 0, 0, 0);
        } else {
          qv[u] = make_char4(in && live[0] ? __ldg(qrow) : 0,
                             in && live[1] ? __ldg(qrow + 1) : 0,
                             in && live[2] ? __ldg(qrow + 2) : 0,
                             in && live[3] ? __ldg(qrow + 3) : 0);
        }
        if constexpr (kOneScale) {
          sv[u][0] = (in && live[0]) ? __ldg(srow + sidx[0]) : 0.f;
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            sv[u][j] = (in && live[j]) ? __ldg(srow + sidx[j]) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (u0 + u >= cn) break;
        const float s0 = sv[u][0];
        const float s1 = sv[u][kOneScale ? 0 : 1];
        const float s2 = sv[u][kOneScale ? 0 : 2];
        const float s3 = sv[u][kOneScale ? 0 : 3];
        const float w0 = static_cast<float>(qv[u].x) * s0;
        const float w1 = static_cast<float>(qv[u].y) * s1;
        const float w2 = static_cast<float>(qv[u].z) * s2;
        const float w3 = static_cast<float>(qv[u].w) * s3;
        const float4 xa = *reinterpret_cast<const float4*>(&xs[warp][u0 + u][0]);
        const float4 xb = *reinterpret_cast<const float4*>(&xs[warp][u0 + u][4]);
        const float xr[kRows] = {xa.x, xa.y, xa.z, xa.w,
                                 xb.x, xb.y, xb.z, xb.w};
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          acc[r][0] = fmaf(xr[r], w0, acc[r][0]);
          acc[r][1] = fmaf(xr[r], w1, acc[r][1]);
          acc[r][2] = fmaf(xr[r], w2, acc[r][2]);
          acc[r][3] = fmaf(xr[r], w3, acc[r][3]);
        }
      }
    }
  }

  // the block's sum: warp partials added in warp order
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    *reinterpret_cast<float4*>(&red[warp][r][lane * 4]) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  for (int e = threadIdx.x; e < kRows * kCols; e += kThreads) {
    const int r = e / kCols;
    const int c = e - r * kCols;
    const int row = m0 + r;
    const int col = blockIdx.y * kCols + c;
    if (row >= p.M || col >= p.N) continue;
    float s = red[0][r][c];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[w][r][c];
    const long long idx = static_cast<long long>(row) * p.N + col;
    if (p.G == 1)
      static_cast<OT*>(p.out)[idx] = from_f32<OT>(s);
    else
      p.ws[static_cast<long long>(blockIdx.z) * p.M * p.N + idx] = s;
  }
}

// out[i] = ws[0][i] + ws[1][i] + ... + ws[G-1][i], in that order
template <typename OT>
__global__ void __launch_bounds__(kThreads)
qmm_reduce_kernel(const float* ws, OT* out, long long mn, int G) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < mn; i += stride) {
    float s = ws[i];
    for (int g = 1; g < G; ++g) s += ws[g * mn + i];
    out[i] = from_f32<OT>(s);
  }
}

// ---- the tensor-core body

constexpr int kTcCols = 128;          // weight columns a block owns
constexpr int kTcThreads = 256 + 32;  // two consumer warpgroups, a producer
constexpr int kTcMaxStages = 8;
constexpr int kTcMinPiece = 4;        // 64-deep k chunks a piece has at least
constexpr int kTcTargetBlocks = 132;  // the SMs of an H100

// Tensor maps of q [K, N] (int8, boxes of 64 k x 128 n), x [M, K] (bf16,
// 64 k x T tokens) and scale [K, nb] (fp32, 64 k x sb blocks, no swizzle),
// the scalars, and the ring's layout: a stage holds the q tile at 0, the x
// tile at x_off and the scale tile at s_off, stage_bytes apart.
struct QmmTcArgs {
  CUtensorMap q, x, s;
  QmmParams p;
  int chunks, piece;          // 64-deep k chunks in all, per block
  int sb;                     // scale blocks a column tile's tile holds
  int stages, stage_bytes, x_off, s_off;
  int out_bf16;               // G = 1: the output dtype
};

// Block (token tile, column tile, z): columns n0 .. n0 + 127, tokens m0 ..
// m0 + T - 1, k chunks z * piece on. Consumer warpgroup wg owns the 64
// columns n0 + 64 wg on (its A tile), and its thread (warp w, lane l) the
// two columns n0 + 64 wg + 16 w + 2 (l / 4) + {0, 1}: column i of them is
// row 16 w + l / 4 + 8 i of the A tile, so that one 16-bit load of a q row
// gives a thread its two weights, and the epilogue writes two neighbouring
// columns of a token at once. Per k step of 16 the thread needs rows
// 2 (l % 4) + {0, 1, 8, 9} (A's k columns). Both warpgroups read the one x
// tile (wgmma's B), so a block reads each weight and each token once.
// ONE_SCALE: bs is even, so a thread's two columns share a block.
template <int T, bool ONE_SCALE>
__global__ void __launch_bounds__(kTcThreads, 1)
    qmm_tc_kernel(const __grid_constant__ QmmTcArgs a) {
  const QmmParams& p = a.p;
  extern __shared__ __align__(1024) unsigned char smem_tma[];
  unsigned char* smem =
      smem_tma + ((1024 - (smem_u32(smem_tma) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + a.stages * a.stage_bytes;
  const uint32_t empty = full + 8 * a.stages;
  const int m0 = blockIdx.x * T;
  const int n0 = blockIdx.y * kTcCols;
  // the scale tile's first block: the tile's first, rounded down to 16
  // bytes (a box whose start is off 16 bytes never completes)
  const int b0 = n0 / p.bs & ~3;
  const int c0 = blockIdx.z * a.piece;
  const int c1 = min(c0 + a.piece, a.chunks);
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // the producer warp: one thread issues
    if (threadIdx.x != 256) return;
    const uint32_t bytes = 64 * kTcCols + T * 128 + a.sb * 64 * 4;
    int stage = 0, phase = 0;
    for (int c = c0; c < c1; ++c) {
      mbar_wait(empty + 8 * stage, phase ^ 1);
      const uint32_t st = base + stage * a.stage_bytes;
      const uint32_t bar = full + 8 * stage;
      mbar_expect_tx(bar, bytes);
      tma_load_2d(st, &a.q, bar, n0, c * 64);
      tma_load_2d(st + a.x_off, &a.x, bar, c * 64, m0);
      tma_load_2d(st + a.s_off, &a.s, bar, b0, c * 64);
      if (++stage == a.stages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int quad = lane % 4;
  const int nl = 64 * wg + 16 * warp + 2 * (lane / 4);  // its first column
  int blk[ONE_SCALE ? 1 : 2];                           // their blocks - b0
#pragma unroll
  for (int j = 0; j < (ONE_SCALE ? 1 : 2); ++j)
    blk[j] = (n0 + nl + j) / p.bs - b0;
  // acc: the fp32 sum over the chunks so far; part: this chunk's, from
  // the tensor cores, added to acc (rounded to nearest) at the chunk's end
  float acc[T / 2], part[T / 2];
#pragma unroll
  for (int x = 0; x < T / 2; ++x) acc[x] = part[x] = 0.f;
  // A fragments of two k steps: [step % 2][4 part + r], part 0 hi
  uint32_t frag[2][8];
  int stage = 0, phase = 0;
  for (int c = c0; c < c1; ++c) {
    mbar_wait(full + 8 * stage, phase);
    const unsigned char* qs = smem + stage * a.stage_bytes;
    const float* ss = reinterpret_cast<const float*>(qs + a.s_off);
    const uint32_t xs = base + stage * a.stage_bytes + a.x_off;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t(&f)[8] = frag[kk % 2];
      float w[4][2];  // [k row v][column j]
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int kr = 16 * kk + 2 * quad + (v & 1) + 8 * (v >> 1);
        const uint32_t u =
            *reinterpret_cast<const uint16_t*>(qs + sw128(kr, nl)) ^ 0x8080u;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          // int8 b as a float: the bits 0x4B000000 | (b + 128) are
          // 2**23 + b + 128, exactly
          const float qf =
              __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + j)) -
              8388736.f;
          w[v][j] = qf * ss[kr * a.sb + blk[ONE_SCALE ? 0 : j]];
        }
      }
      split_bf16(w[0][0], w[1][0], f[0], f[4]);
      split_bf16(w[0][1], w[1][1], f[1], f[5]);
      split_bf16(w[2][0], w[3][0], f[2], f[6]);
      split_bf16(w[2][1], w[3][1], f[3], f[7]);
      wg_fence();
      const uint64_t db = sw128_desc(xs + kk * 32);
      wgmma_rs_k(part, f[0], f[1], f[2], f[3], db, kk > 0);
      wgmma_rs_k(part, f[4], f[5], f[6], f[7], db, 1);
      wg_commit();
      if (kk == 1 || kk == 2) {  // step kk - 1 is done: its fragments free
        wg_wait1();
        fence_regs(part);
        fence_regs(frag[(kk + 1) % 2]);
      }
    }
    wg_wait0();
    fence_regs(part);
    fence_regs(frag[0]);
    fence_regs(frag[1]);
#pragma unroll
    for (int x = 0; x < T / 2; ++x) acc[x] += part[x];
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * stage);
    if (++stage == a.stages) {
      stage = 0;
      phase ^= 1;
    }
  }

  // acc[4 j + 2 i + e]: column n0 + nl + i, token m0 + 8 j + 2 (l % 4) + e;
  // N % 16 == 0, so the two columns are both in or both out
  const int n = n0 + nl;
  if (n >= p.N) return;
#pragma unroll
  for (int j = 0; j < T / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * j + 2 * quad + e;
      if (m >= p.M) continue;
      const float2 v = make_float2(acc[4 * j + e], acc[4 * j + 2 + e]);
      const long long idx = static_cast<long long>(m) * p.N + n;
      if (p.G > 1) {
        *reinterpret_cast<float2*>(
            p.ws + static_cast<long long>(blockIdx.z) * p.M * p.N + idx) = v;
      } else if (a.out_bf16) {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.out) + idx) =
            __floats2bfloat162_rn(v.x, v.y);
      } else {
        *reinterpret_cast<float2*>(static_cast<float*>(p.out) + idx) = v;
      }
    }
}

// ---- launches

enum Body { kFmaBody = 0, kWgmmaBody = 1 };

// G and the k-rows of a piece, from (K, N) and the body alone
int splits(int K, int N, int body) {
  if (body == kWgmmaBody) {
    const int chunks = (K + 63) / 64;
    const int tiles = std::max(1, (N + kTcCols - 1) / kTcCols);
    const int want = (kTcTargetBlocks + tiles - 1) / tiles;
    const int most = std::max(1, chunks / kTcMinPiece);
    const int g = std::max(1, std::min(want, most));
    const int piece = std::max(1, (chunks + g - 1) / g);
    return std::max(1, (chunks + piece - 1) / piece);
  }
  const int col_tiles = std::max(1, (N + kCols - 1) / kCols);
  const int want = (kTargetBlocks + col_tiles - 1) / col_tiles;
  const int most = std::max(1, K / (kWarps * kMinPiece));
  return std::max(1, std::min(want, most));
}

// the G partials summed in order into out, when G > 1
template <typename OT>
int reduce(const QmmParams& p, cudaStream_t stream) {
  if (p.G == 1) return 0;
  const long long mn = static_cast<long long>(p.M) * p.N;
  const long long blocks = (mn + kThreads - 1) / kThreads;
  const int nblk = static_cast<int>(blocks < 132 * 8 ? blocks : 132 * 8);
  qmm_reduce_kernel<OT><<<nblk, kThreads, 0, stream>>>(
      p.ws, static_cast<OT*>(p.out), mn, p.G);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT, typename OT, bool kVec, bool kOneScale, int kUnroll>
int launch(const QmmParams& p, cudaStream_t stream) {
  const dim3 grid((p.M + kRows - 1) / kRows, (p.N + kCols - 1) / kCols, p.G);
  qmm_kernel<XT, OT, kVec, kOneScale, kUnroll>
      <<<grid, kThreads, 0, stream>>>(p);
  const int rc = static_cast<int>(cudaGetLastError());
  return rc != 0 ? rc : reduce<OT>(p, stream);
}

template <typename XT, typename OT>
int dispatch(const QmmParams& p, bool vec, cudaStream_t stream) {
  if (vec && p.bs % 4 == 0) return launch<XT, OT, true, true, 16>(p, stream);
  if (vec) return launch<XT, OT, true, false, 8>(p, stream);
  return launch<XT, OT, false, false, 8>(p, stream);
}

template <int T, bool ONE_SCALE>
int launch_tc(QmmParams p, int out_bf16, cudaStream_t stream) {
  QmmTcArgs a;
  memset(&a, 0, sizeof(a));
  a.p = p;
  a.out_bf16 = out_bf16;
  a.chunks = (p.K + 63) / 64;
  a.piece = (a.chunks + p.G - 1) / p.G;
  // the blocks that a tile's 128 columns span from a first block rounded
  // down to a multiple of 4 (up to 3 more), rounded up to 16 bytes
  a.sb = ((kTcCols - 1) / p.bs + 2 + 3 + 3) / 4 * 4;
  a.x_off = 64 * kTcCols;
  a.s_off = a.x_off + T * 128;
  a.stage_bytes = (a.s_off + a.sb * 64 * 4 + 1023) / 1024 * 1024;
  // a block's registers at T >= 64 leave one block per SM, which takes a
  // deeper ring; smaller tiles run two or three blocks per SM
  const int budget = (T >= 64 ? 200 : 100) * 1024;
  a.stages = std::max(2, std::min(kTcMaxStages, budget / a.stage_bytes));
  const long long q_dims[2] = {p.N, p.K}, x_dims[2] = {p.K, p.M},
                  s_dims[2] = {p.nb, p.K};
  const long long q_st = p.N, x_st = p.K, s_st = p.nb;
  const int q_box[2] = {kTcCols, 64}, x_box[2] = {64, T},
            s_box[2] = {a.sb, 64};
  if (encode_tiled() == nullptr ||
      !map_i8(&a.q, p.q, 2, q_dims, &q_st, q_box) ||
      !map_bf16(&a.x, p.x, 2, x_dims, &x_st, x_box) ||
      !map_tiled(&a.s, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, p.scale, 2, s_dims,
                 &s_st, s_box, CU_TENSOR_MAP_SWIZZLE_NONE))
    return kNoTensorMap;
  const dim3 grid((p.M + T - 1) / T, (p.N + kTcCols - 1) / kTcCols, p.G);
  const int bytes = a.stages * (a.stage_bytes + 16) + 1024;
  const int rc = launch_kernel(qmm_tc_kernel<T, ONE_SCALE>, bytes, grid,
                               kTcThreads, a, stream);
  if (rc != 0) return rc;
  return out_bf16 ? reduce<bf16>(p, stream) : reduce<float>(p, stream);
}

// the token tile: the least of 8 .. 128 that holds M, else 128
template <bool ONE_SCALE>
int tc_tokens(const QmmParams& p, int out_bf16, cudaStream_t stream) {
  if (p.M <= 8) return launch_tc<8, ONE_SCALE>(p, out_bf16, stream);
  if (p.M <= 16) return launch_tc<16, ONE_SCALE>(p, out_bf16, stream);
  if (p.M <= 32) return launch_tc<32, ONE_SCALE>(p, out_bf16, stream);
  if (p.M <= 64) return launch_tc<64, ONE_SCALE>(p, out_bf16, stream);
  return launch_tc<128, ONE_SCALE>(p, out_bf16, stream);
}

bool valid_dtype(int dt) { return dt == kF32 || dt == kBF16; }

// The body of each operand set, the one table of it: `qmm` runs what it
// names, and ops/quantized_matmul.py holds its `_qmm_plan` against
// `qmm_body` when it loads this library. bf16 x with q, x and scale that
// tensor maps can read (each base on 16 bytes, and each row: K % 8 == 0,
// N % 16 == 0, nb % 4 == 0) runs the tensor-core body, anything else FMA.
int body_for(int x_dt, const void* x, int K, const void* q, int N,
             const void* scale, int nb) {
  const bool tma = on16(x) && (K * 2) % 16 == 0 && on16(q) && N % 16 == 0 &&
                   on16(scale) && (nb * 4) % 16 == 0;
  return x_dt == kBF16 && tma ? kWgmmaBody : kFmaBody;
}

}  // namespace

// Plain C entry points for ctypes.
//
// qmm_body: the body that qmm runs for these operands (its arguments as qmm
// takes them): 0 FMA, 1 the tensor-core body.
extern "C" int qmm_body(int x_dtype, const void* x, int K, const void* q,
                        int N, const void* scale, int nb) {
  return body_for(x_dtype, x, K, q, N, scale, nb);
}

// qmm_splits: G, the number of blocks sharing an output tile's sum over K,
// for a [K, N] weight through `body`; the caller sizes the workspace [G, M,
// N] fp32 from it when G > 1.
extern "C" int qmm_splits(int K, int N, int body) {
  return splits(K, N, body);
}

// qmm (K7): x [M, K], q [K, N] int8, scale [K, nb] fp32 (bs = the block
// size, nb = ceil(N / bs)), out [M, N], workspace [G, M, N] fp32 (ignored
// when G = 1), all contiguous on the device and allocated by the caller.
// Dtype codes: 0 fp32, 1 bf16. Returns 0, the cudaError_t of a launch, -2
// for a tensor map the driver refused, or -1 for shapes or dtypes the
// kernels do not take.
extern "C" int qmm(const void* x, const void* q, const void* scale, void* out,
                   void* workspace, int M, int K, int N, int nb, int bs,
                   int x_dtype, int out_dtype, void* stream) {
  if (M < 0 || K < 0 || N < 0 || bs < 1 || nb != (N + bs - 1) / bs ||
      !valid_dtype(x_dtype) || !valid_dtype(out_dtype) ||
      (N + kCols - 1) / kCols > 65535) {
    return -1;
  }
  if (M == 0 || N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K == 0)  // an empty sum: zeros in either dtype
    return static_cast<int>(cudaMemsetAsync(
        out, 0, static_cast<size_t>(M) * N * (out_dtype == kF32 ? 4 : 2),
        st));
  QmmParams p;
  p.x = x;
  p.q = static_cast<const int8_t*>(q);
  p.scale = static_cast<const float*>(scale);
  p.out = out;
  p.ws = static_cast<float*>(workspace);
  p.M = M;
  p.K = K;
  p.N = N;
  p.nb = nb;
  p.bs = bs;
  const int body = body_for(x_dtype, x, K, q, N, scale, nb);
  p.G = splits(K, N, body);
  p.piece = (K + kWarps * p.G - 1) / (kWarps * p.G);
  if (body == kWgmmaBody)
    return bs % 2 == 0 ? tc_tokens<true>(p, out_dtype == kBF16, st)
                       : tc_tokens<false>(p, out_dtype == kBF16, st);
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 4 == 0;
  if (x_dtype == kF32)
    return out_dtype == kF32 ? dispatch<float, float>(p, vec, st)
                             : dispatch<float, bf16>(p, vec, st);
  return out_dtype == kF32 ? dispatch<bf16, float>(p, vec, st)
                           : dispatch<bf16, bf16>(p, vec, st);
}
