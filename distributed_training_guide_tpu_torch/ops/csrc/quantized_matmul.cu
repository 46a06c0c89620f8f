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
// the block there and makes one MXU product. Here the unit is a block of
// 8 warps owning an 8-row x 128-column output tile (4 columns per lane, 8
// rows per thread: 32 sums in registers), with the tile's sum over K cut
// into pieces:
// - G blocks (blockIdx.z) share the tile, and each block's 8 warps take
//   one piece of K each: G * 8 pieces of ceil(K / (8 G)) rows in order.
//   G comes from (K, N) alone (`qmm_splits`): enough blocks to fill the
//   card at decode (M = 8), where a 1024-wide projection has only 8
//   column tiles, and no piece under 64 rows.
// - A warp walks its piece: it stages its 8 rows of x for 32 k at a time
//   in its own shared memory as fp32, loads 16 (8 with per-column scales)
//   int8 rows of its 4 columns ahead with their scales, dequantizes them
//   in registers and accumulates by FMA, one fmaf per k in ascending
//   order. The weights go from device memory straight to registers.
// - The block sums its 8 warps' partials through shared memory in warp
//   order; with G = 1 it writes the output, else its fp32 partial goes to
//   a workspace [G, M, N] and `qmm_reduce_kernel` sums the G partials in
//   order and rounds once.
// The order of every output's sum therefore depends on (K, N) only: the
// row tile is 8 whatever M is, and there are no atomics. A row's result is
// bitwise the same in a product of any M (batch invariance of the serve
// engine).
//
// Bound on H100. At decode (M = 8) a product moves its int8 weight and
// fp32 scales once (1.125 bytes per weight at bs = 32) and does 16 fp32
// operations per weight: bytes over 3.35 TB/s bound it, with the fp32
// work at ~70% of that time, so loads are issued 16 rows ahead of the FMAs
// and 4-8 blocks of 8 warps stay resident per SM. At prefill sizes (M in
// the hundreds and more) the fp32 FMAs bound it against 67 TFLOP/s; every
// row tile re-reads the weight tile (from L2 when the row tiles of one
// column tile run together, which blockIdx.x = row tile arranges). A
// tensor-core body (x * scale split into bf16 hi and lo against q, exact)
// with wgmma and TMA is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace {

using bf16 = __nv_bfloat16;

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

int splits(int K, int N) {
  const int col_tiles = std::max(1, (N + kCols - 1) / kCols);
  const int want = (kTargetBlocks + col_tiles - 1) / col_tiles;
  const int most = std::max(1, K / (kWarps * kMinPiece));
  return std::max(1, std::min(want, most));
}

template <typename XT, typename OT, bool kVec, bool kOneScale, int kUnroll>
int launch(const QmmParams& p, cudaStream_t stream) {
  const dim3 grid((p.M + kRows - 1) / kRows, (p.N + kCols - 1) / kCols, p.G);
  qmm_kernel<XT, OT, kVec, kOneScale, kUnroll>
      <<<grid, kThreads, 0, stream>>>(p);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0 || p.G == 1) return rc;
  const long long mn = static_cast<long long>(p.M) * p.N;
  const long long blocks = (mn + kThreads - 1) / kThreads;
  const int nblk = static_cast<int>(blocks < 132 * 8 ? blocks : 132 * 8);
  qmm_reduce_kernel<OT><<<nblk, kThreads, 0, stream>>>(
      p.ws, static_cast<OT*>(p.out), mn, p.G);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT, typename OT>
int dispatch(const QmmParams& p, bool vec, cudaStream_t stream) {
  if (vec && p.bs % 4 == 0) return launch<XT, OT, true, true, 16>(p, stream);
  if (vec) return launch<XT, OT, true, false, 8>(p, stream);
  return launch<XT, OT, false, false, 8>(p, stream);
}

bool valid_dtype(int dt) { return dt == kF32 || dt == kBF16; }

}  // namespace

// Plain C entry points for ctypes.
//
// qmm_splits: G, the number of blocks sharing an output tile's sum over K,
// for a [K, N] weight; the caller sizes the workspace [G, M, N] fp32 from
// it when G > 1.
extern "C" int qmm_splits(int K, int N) { return splits(K, N); }

// qmm (K7): x [M, K], q [K, N] int8, scale [K, nb] fp32 (bs = the block
// size, nb = ceil(N / bs)), out [M, N], workspace [G, M, N] fp32 (ignored
// when G = 1), all contiguous on the device and allocated by the caller.
// Dtype codes: 0 fp32, 1 bf16. Returns 0, the cudaError_t of a launch, or
// -1 for shapes or dtypes the kernel does not take.
extern "C" int qmm(const void* x, const void* q, const void* scale, void* out,
                   void* workspace, int M, int K, int N, int nb, int bs,
                   int x_dtype, int out_dtype, void* stream) {
  if (M < 0 || K < 0 || N < 0 || bs < 1 || nb != (N + bs - 1) / bs ||
      !valid_dtype(x_dtype) || !valid_dtype(out_dtype) ||
      (N + kCols - 1) / kCols > 65535) {
    return -1;
  }
  if (M == 0 || N == 0) return 0;
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
  p.G = splits(K, N);
  p.piece = (K + kWarps * p.G - 1) / (kWarps * p.G);
  const bool vec = N % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 4 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32)
    return out_dtype == kF32 ? dispatch<float, float>(p, vec, st)
                             : dispatch<float, bf16>(p, vec, st);
  return out_dtype == kF32 ? dispatch<bf16, float>(p, vec, st)
                           : dispatch<bf16, bf16>(p, vec, st);
}
