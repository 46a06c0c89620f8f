// Grouped (ragged) matmul and its transposed form, hand-written for Hopper
// (sm_90a).
//
// Replaces the TPU kernels of distributed_training_guide_tpu/ops/
// grouped_matmul.py:
// - `_gmm_kernel` (K5, launched by `_pallas_gmm_raw`) as `gmm`:
//   out[r] = lhs[r] @ rhs[g(r)] for the rows r < total of the group-sorted
//   buffer, where group g owns rows offs[g] .. offs[g+1] and
//   offs = cumsum(group_sizes), total = offs[G]; rows >= total come out 0.
//   The sum over K is fp32.
// - `_tgmm_kernel` (K6, launched by `_pallas_tgmm_raw`) as `tgmm`:
//   d_rhs[g] = lhs_g^T @ dy_g, an fp32 sum over the group's rows; an empty
//   group gives zeros, rows >= total contribute nothing.
//
// Design. On the TPU the grid walks a precomputed (group, row tile) work
// list in order and carries the fp32 accumulator across consecutive items
// of one tile in VMEM. Here blocks run in parallel and in no order, so no
// work list is built and nothing comes from the host: every block computes
// the group offsets itself (a block-wide scan of group_sizes, G <= 1024,
// into shared memory).
// - K5: block (column tile, row tile, z) owns the rows of its row tile that
//   belong to the groups g_first + z, g_first + z + Z, ... intersecting the
//   tile (g_first: the group of the tile's first row), and block z = 0 also
//   owns the rows >= total, which it writes as zeros. Every row has exactly
//   one owner, so there are no atomics, and a row's sum over K runs in one
//   fixed order whatever else shares its tile or how Z and the tile sizes
//   were chosen: the result is deterministic and batch-invariant. For each
//   of its groups the block loops over K in chunks through shared memory,
//   with the rows of other groups zeroed, and accumulates in registers (a
//   zero row adds exact zeros to rows it does not own). Z, the number of
//   blocks sharing a row tile, is chosen on the host from M and G alone (a
//   row tile of a small M spans many groups), which keeps the grid static.
//   rhs is read through three strides, so the same kernel takes rhs^T for
//   the backward's d_lhs product. Three bodies, by the operands' dtypes,
//   strides and alignment alone (`body_for`, exported as `gmm_body`):
//   * bf16 lhs and rhs that a tensor map can read (rhs N-contiguous, both
//     bases and the other strides on 16 bytes; `gmm_hopper_kernel`): no
//     block spans two groups. Every block scans group_sizes into the group
//     offsets and, a second time, into each group's count of BM-row tiles;
//     the static grid of ceil(M / BM) + G row slots per 128-column tile
//     then names each tile (group g, rows offs[g] + i BM on) with no work
//     list from the host, and the slots past the live tiles zero the rows
//     from the total up, BM to a slot. No row needs zeroing and no product
//     multiplies another group's zeros. Persistent blocks (one per SM)
//     walk the slots; a producer warp streams lhs (2-D map) and rhs (3-D
//     map over [G, K, N]) tiles by TMA into a ring of 64-deep K chunks,
//     and one or two consumer warpgroups run wgmma m64n64k16 with both
//     operands in shared memory and the fp32 accumulators in registers,
//     writing the tile's rows of g straight from them. Decode (M <= 256)
//     takes 64-row tiles and a deeper ring, so that each live group's
//     weights stream through many loads in flight; larger M 128-row tiles.
//   * other bf16 lhs and rhs (`gmm_tc_kernel`, a transposed rhs or rows off
//     16 bytes): tiles in shared memory as bf16, products on the tensor
//     cores (WMMA 16x16x16, bf16 in, fp32 accumulate); a warp skips the
//     fragments that hold no row of the current group. The fp32 fragments
//     are staged through shared memory per warp and only owned rows are
//     written, in the output dtype.
//   * anything else (`gmm_fma_kernel`): operands converted to fp32 as they
//     are loaded (bf16 rhs^T is read as it lies, with no fp32 copy), FMA on
//     the CUDA cores, full fp32: the backward's d_lhs = dy @ rhs^T and fp32
//     references.
//   The WMMA and FMA bodies use the z split above.
// - K6: the reduction over a group's rows stays on the chip, in one order
//   per output, with no atomics. Two bodies, by the operands' dtypes,
//   strides and alignment alone (`tgmm_body_for`, exported as
//   `tgmm_body`):
//   * bf16 lhs against fp32 dy that tensor maps can read, into output rows
//     on 16 bytes (the backward's d_rhs; `tgmm_split_kernel`): out[g]^T =
//     dy_g^T lhs_g on the tensor cores, dy split in registers into bf16 hi
//     and lo A fragments, lhs the N-major B from a TMA ring, 64-row chunks
//     counted from the group's first row, each chunk's sum added to an
//     fp32 register sum; persistent blocks over a static grid of G x K /
//     128 x N / 128 tiles, group-major; every tile leaves by TMA stores.
//     Rows outside the group are zeroed in both operands, so a group's
//     result is bitwise the same whatever the other groups hold.
//   * anything else (`tgmm_kernel`: fp32 lhs, operand or output rows off
//     16 bytes): block (column tile, K tile, group) loops over its group's
//     rows in chunks of 8 through shared memory, FMA in fp32; bf16
//     operands are converted as they are loaded.
//
// Bound on H100. K5 at decode (64 rows over 128 experts, mostly 0-1 rows
// each) moves the weight slices of the non-empty groups and little else:
// bytes over 3.35 TB/s bound it, and each non-empty group gets its own
// tiles so that many weight streams are in flight. K5 in training (32768
// rows, ~256 per group) moves lhs once per column tile and is bound by its
// bytes at these widths, near its operations. The fp32-dy products (K5's
// d_lhs, K6's d_rhs) are 1.03e11 operations at qwen3-30b-a3b's training
// shape: 1.54 ms on the CUDA cores' 67 TFLOP/s, 0.208 ms as two bf16
// passes at 989 TFLOP/s, so the split bodies run them on the tensor cores.
// Their tiles re-read the group's rows from L2 once per column tile (K6:
// 768 bytes a row a tile, ~2.4 GB in all at that shape), which the tensor
// cores' time does not cover; a cluster sharing tiles by TMA multicast
// would halve it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"  // barriers, TMA, wgmma, tensor maps

namespace {

namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kMaxGroups = 1024;
constexpr unsigned kFull = 0xffffffffu;

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

// out[0] = 0 and out[g + 1] = out[g] + value(g) for g = 0 .. n - 1
// (n <= kMaxGroups), by all NT threads of the block; ends with a barrier
template <int NT, typename F>
__device__ void exclusive_scan(F value, int n, int* out) {
  constexpr int kPer = (kMaxGroups + NT - 1) / NT;
  __shared__ int warp_total[NT / 32];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  int v[kPer];
  int local = 0;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = t * kPer + i;
    v[i] = idx < n ? value(idx) : 0;
    local += v[i];
  }
  int x = local;  // inclusive scan of `local` over the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_total[warp] = x;
  __syncthreads();
  int run = x - local;
  for (int w = 0; w < warp; ++w) run += warp_total[w];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int idx = t * kPer + i;
    run += v[i];
    if (idx < n) out[idx + 1] = run;
  }
  if (t == 0) out[0] = 0;
  __syncthreads();
}

// offs[g] = sum of sizes[0 .. g) for g = 0 .. G (negative sizes count as 0),
// by all kThreads threads of the block; ends with a barrier
__device__ void group_offsets(const int* sizes, int G, int* offs) {
  exclusive_scan<kThreads>([&](int g) { return max(sizes[g], 0); }, G, offs);
}

// the group owning row r: the first g with offs[g + 1] > r (G past them all)
__device__ __forceinline__ int group_of(const int* offs, int G, int r) {
  int lo = 0, hi = G;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (offs[mid + 1] > r)
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

struct GmmParams {
  const void* lhs;   // [M, K], row stride l_sm, unit column stride
  const void* rhs;   // [G, K, N] through strides (r_sg, r_sk, r_sn)
  const int* sizes;  // [G] int32
  void* out;         // [M, N] contiguous, the output dtype
  int M, K, N, G, Z;
  long long l_sm, r_sg, r_sk, r_sn;
  int vec_a, vec_b;  // 16-byte loads of 8 bf16 are aligned and in bounds
};

// What one K5 block does: its row tile [m0, m1), the groups g_first ..
// g_last intersecting it (it takes every Z-th from g_first + z), and
// whether it also owns the rows >= total.
struct TilePlan {
  int m0, m1, total, g_first, g_last;
  bool tail;
};

__device__ __forceinline__ TilePlan plan_tile(const GmmParams& p,
                                              const int* offs, int BM) {
  TilePlan t;
  t.m0 = blockIdx.y * BM;
  t.m1 = min(t.m0 + BM, p.M);
  t.total = min(offs[p.G], p.M);
  if (t.m0 < t.total) {
    t.g_first = group_of(offs, p.G, t.m0);
    t.g_last = group_of(offs, p.G, min(t.m1, t.total) - 1);
  } else {
    t.g_first = p.G;
    t.g_last = p.G - 1;
  }
  t.tail = blockIdx.z == 0 && t.m1 > t.total;
  return t;
}

// own[r] for the rows of the tile: this block writes row m0 + r
__device__ __forceinline__ void mark_owned_rows(const GmmParams& p,
                                                const int* offs,
                                                const TilePlan& t, int BM,
                                                unsigned char* own) {
  const int z = blockIdx.z;
  for (int r = threadIdx.x; r < BM; r += kThreads) {
    const int row = t.m0 + r;
    bool mine = false;
    if (row < t.m1) {
      if (row >= t.total)
        mine = z == 0;
      else
        mine = (group_of(offs, p.G, row) - t.g_first) % p.Z == z;
    }
    own[r] = mine;
  }
  __syncthreads();
}

// ---- register blocking shared by the fp32 bodies (K5 FMA, K6)

// Thread lane16 (0..15) of a 16 x 16 grid owns R entries of a tile axis:
// with R a multiple of 4, four consecutive entries in each 64-wide half
// (read as one float4), else entries lane16 + 16 a.
template <int R>
__device__ __forceinline__ int owned(int lane16, int a) {
  if constexpr (R % 4 == 0)
    return (a / 4) * 64 + lane16 * 4 + (a % 4);
  else
    return lane16 + 16 * a;
}

// the R entries thread lane16 owns of one shared-memory row
template <int R>
__device__ __forceinline__ void read_owned(const float* row, int lane16,
                                           float (&v)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int h = 0; h < R / 4; ++h) {
      const float4 x =
          *reinterpret_cast<const float4*>(row + h * 64 + lane16 * 4);
      v[4 * h] = x.x;
      v[4 * h + 1] = x.y;
      v[4 * h + 2] = x.z;
      v[4 * h + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int a = 0; a < R; ++a) v[a] = row[lane16 + 16 * a];
  }
}

// ---- K5, the fp32 body (FMA on the CUDA cores)

// One block: a BM x BN tile of out, BK-deep chunks of K. Each thread keeps
// (BM / 16) x (BN / 16) sums in registers and loads the next chunk into
// registers while it computes the current one. A row's sum runs over
// k = 0 .. K-1 in order (one fmaf each), whatever the tile sizes.
template <int BM, int BN, int BK, typename AT, typename BT, typename OT>
__global__ void __launch_bounds__(kThreads)
gmm_fma_kernel(const GmmParams p) {
  constexpr int RA = BM / 16;  // rows per thread
  constexpr int RC = BN / 16;  // columns per thread
  constexpr int LA = BM * BK / kThreads;  // staged lhs values per thread
  constexpr int LB = BK * BN / kThreads;  // staged rhs values per thread
  static_assert(LA * kThreads == BM * BK && LB * kThreads == BK * BN, "");
  __shared__ int offs[kMaxGroups + 1];
  __shared__ unsigned char own[BM];
  __shared__ __align__(16) float As[BK][BM + 4];  // k-major, padded
  __shared__ __align__(16) float Bs[BK][BN + 4];
  group_offsets(p.sizes, p.G, offs);
  const TilePlan t = plan_tile(p, offs, BM);
  const int z = blockIdx.z;
  if (t.g_first + z > t.g_last && !t.tail) return;
  mark_owned_rows(p, offs, t, BM, own);

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int n0 = blockIdx.x * BN;
  const AT* lhs = static_cast<const AT*>(p.lhs);
  const bool rows_of_rhs = p.r_sn == 1;  // else neighbours run along K
  float acc[RA][RC];
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int c = 0; c < RC; ++c) acc[a][c] = 0.f;

  for (int g = t.g_first + z; g <= t.g_last; g += p.Z) {
    const int ga = max(offs[g], t.m0);
    const int gb = min(offs[g + 1], t.m1);
    if (ga >= gb) continue;  // an empty group (the same for every thread)
    const BT* rg = static_cast<const BT*>(p.rhs) + g * p.r_sg;
    float ra[LA], rb[LB];
    // chunk k0 into registers: lhs rows of group g (others 0), rhs[g]
    auto fetch = [&](int k0) {
#pragma unroll
      for (int i = 0; i < LA; ++i) {
        const int idx = threadIdx.x + i * kThreads;
        const int r = idx / BK;
        const int k = idx - r * BK;
        const int row = t.m0 + r;
        ra[i] = (row >= ga && row < gb && k0 + k < p.K)
                    ? to_f32(lhs[row * p.l_sm + k0 + k])
                    : 0.f;
      }
#pragma unroll
      for (int i = 0; i < LB; ++i) {
        const int idx = threadIdx.x + i * kThreads;
        int k, n;
        if (rows_of_rhs) {
          k = idx / BN;
          n = idx - k * BN;
        } else {
          n = idx / BK;
          k = idx - n * BK;
        }
        rb[i] = (k0 + k < p.K && n0 + n < p.N)
                    ? to_f32(rg[(k0 + k) * p.r_sk + (n0 + n) * p.r_sn])
                    : 0.f;
      }
    };
    fetch(0);
    for (int k0 = 0; k0 < p.K; k0 += BK) {
      __syncthreads();  // the previous chunk's reads are done
#pragma unroll
      for (int i = 0; i < LA; ++i) {
        const int idx = threadIdx.x + i * kThreads;
        const int r = idx / BK;
        As[idx - r * BK][r] = ra[i];
      }
#pragma unroll
      for (int i = 0; i < LB; ++i) {
        const int idx = threadIdx.x + i * kThreads;
        if (rows_of_rhs)
          Bs[idx / BN][idx % BN] = rb[i];
        else
          Bs[idx % BK][idx / BK] = rb[i];
      }
      __syncthreads();
      if (k0 + BK < p.K) fetch(k0 + BK);
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        float av[RA], bv[RC];
        read_owned<RA>(As[k], ty, av);
        read_owned<RC>(Bs[k], tx, bv);
#pragma unroll
        for (int a = 0; a < RA; ++a)
#pragma unroll
          for (int c = 0; c < RC; ++c) acc[a][c] = fmaf(av[a], bv[c], acc[a][c]);
      }
    }
  }

  OT* out = static_cast<OT*>(p.out);
#pragma unroll
  for (int a = 0; a < RA; ++a) {
    const int r = owned<RA>(ty, a);
    const int row = t.m0 + r;
    if (!own[r]) continue;
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      const int col = n0 + owned<RC>(tx, c);
      if (col < p.N)
        out[static_cast<long long>(row) * p.N + col] =
            from_f32<OT>(row >= t.total ? 0.f : acc[a][c]);
    }
  }
}

// ---- K5, the bf16 body (WMMA on the tensor cores)

template <int BM, int BN>
struct TcSmem {
  static constexpr int kBK = 32;
  static constexpr int kLda = kBK + 8;  // bf16 A rows
  static constexpr int kLdb = BN + 8;   // bf16 B rows
  static constexpr int kLdc = 16 + 4;   // fp32 rows of a warp's staged fragment
  static constexpr int a = 0;
  static constexpr int b = a + BM * kLda * 2;
  static constexpr int tiles = b + kBK * kLdb * 2;
  static constexpr int stage = (kThreads / 32) * 16 * kLdc * 4;
  static constexpr int bytes = tiles > stage ? tiles : stage;
};

template <int BM, int BN, int WM, int WN, typename OT>
__global__ void __launch_bounds__(kThreads)
gmm_tc_kernel(const GmmParams p) {
  using L = TcSmem<BM, BN>;
  constexpr int BK = L::kBK;
  constexpr int FM = WM / 16;  // fragments per warp along M
  constexpr int FN = WN / 16;  // ... along N
  constexpr int WARPS_N = BN / WN;
  static_assert((BM / WM) * (BN / WN) == kThreads / 32, "8 warps");
  __shared__ int offs[kMaxGroups + 1];
  __shared__ unsigned char own[BM];
  __shared__ __align__(128) unsigned char smem[L::bytes];
  bf16* As = reinterpret_cast<bf16*>(smem + L::a);
  bf16* Bs = reinterpret_cast<bf16*>(smem + L::b);

  group_offsets(p.sizes, p.G, offs);
  const TilePlan t = plan_tile(p, offs, BM);
  const int z = blockIdx.z;
  if (t.g_first + z > t.g_last && !t.tail) return;
  mark_owned_rows(p, offs, t, BM, own);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wr = warp / WARPS_N;  // this warp's rows: wr * WM .. + WM
  const int wc = warp % WARPS_N;  // ... columns: wc * WN .. + WN
  const int n0 = blockIdx.x * BN;
  const bf16* lhs = static_cast<const bf16*>(p.lhs);
  const bf16 zero = __float2bfloat16(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int fm = 0; fm < FM; ++fm)
#pragma unroll
    for (int fn = 0; fn < FN; ++fn) wmma::fill_fragment(acc[fm][fn], 0.f);

  for (int g = t.g_first + z; g <= t.g_last; g += p.Z) {
    const int ga = max(offs[g], t.m0);
    const int gb = min(offs[g + 1], t.m1);
    if (ga >= gb) continue;  // an empty group (the same for every thread)
    // which of this warp's fragment rows hold a row of group g
    bool live[FM];
#pragma unroll
    for (int fm = 0; fm < FM; ++fm) {
      const int f0 = t.m0 + wr * WM + fm * 16;
      live[fm] = f0 < gb && f0 + 16 > ga;
    }
    const bf16* rg = static_cast<const bf16*>(p.rhs) + g * p.r_sg;
    for (int k0 = 0; k0 < p.K; k0 += BK) {
      __syncthreads();  // the previous chunk's fragment loads are done
      if (p.vec_a) {
        for (int idx = threadIdx.x; idx < BM * (BK / 8); idx += kThreads) {
          const int r = idx / (BK / 8);
          const int c = (idx - r * (BK / 8)) * 8;
          const int row = t.m0 + r;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (row >= ga && row < gb && k0 + c < p.K)
            v = *reinterpret_cast<const uint4*>(lhs + row * p.l_sm + k0 + c);
          *reinterpret_cast<uint4*>(As + r * L::kLda + c) = v;
        }
      } else {
        for (int idx = threadIdx.x; idx < BM * BK; idx += kThreads) {
          const int r = idx / BK;
          const int k = idx - r * BK;
          const int row = t.m0 + r;
          As[r * L::kLda + k] = (row >= ga && row < gb && k0 + k < p.K)
                                    ? lhs[row * p.l_sm + k0 + k]
                                    : zero;
        }
      }
      if (p.vec_b) {
        for (int idx = threadIdx.x; idx < BK * (BN / 8); idx += kThreads) {
          const int k = idx / (BN / 8);
          const int c = (idx - k * (BN / 8)) * 8;
          uint4 v = make_uint4(0u, 0u, 0u, 0u);
          if (k0 + k < p.K && n0 + c < p.N)
            v = *reinterpret_cast<const uint4*>(rg + (k0 + k) * p.r_sk + n0 +
                                                c);
          *reinterpret_cast<uint4*>(Bs + k * L::kLdb + c) = v;
        }
      } else {
        for (int idx = threadIdx.x; idx < BK * BN; idx += kThreads) {
          const int k = idx / BN;
          const int n = idx - k * BN;
          Bs[k * L::kLdb + n] =
              (k0 + k < p.K && n0 + n < p.N)
                  ? rg[(k0 + k) * p.r_sk + (n0 + n) * p.r_sn]
                  : zero;
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
            bfrag[FN];
#pragma unroll
        for (int fn = 0; fn < FN; ++fn)
          wmma::load_matrix_sync(bfrag[fn],
                                 Bs + kk * L::kLdb + wc * WN + fn * 16,
                                 L::kLdb);
#pragma unroll
        for (int fm = 0; fm < FM; ++fm) {
          if (!live[fm]) continue;
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
              afrag;
          wmma::load_matrix_sync(
              afrag, As + (wr * WM + fm * 16) * L::kLda + kk, L::kLda);
#pragma unroll
          for (int fn = 0; fn < FN; ++fn)
            wmma::mma_sync(acc[fm][fn], afrag, bfrag[fn], acc[fm][fn]);
        }
      }
    }
  }

  // epilogue: each warp stages one fragment at a time in its own corner of
  // the (now free) tile memory and writes the rows this block owns
  __syncthreads();
  float* stage = reinterpret_cast<float*>(smem) + warp * 16 * L::kLdc;
  OT* out = static_cast<OT*>(p.out);
#pragma unroll
  for (int fm = 0; fm < FM; ++fm) {
#pragma unroll
    for (int fn = 0; fn < FN; ++fn) {
      wmma::store_matrix_sync(stage, acc[fm][fn], L::kLdc,
                              wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int i = e / 16;
        const int j = e - i * 16;
        const int r = wr * WM + fm * 16 + i;
        const int row = t.m0 + r;
        const int col = n0 + wc * WN + fn * 16 + j;
        if (r < BM && own[r] && col < p.N)
          out[static_cast<long long>(row) * p.N + col] =
              from_f32<OT>(row >= t.total ? 0.f : stage[i * L::kLdc + j]);
      }
      __syncwarp();
    }
  }
}

// ---- K5, the Hopper body (bf16 lhs and rhs, rhs N-contiguous): wgmma

// Tensor maps of lhs [M, K] and rhs [G, K, N], the scalars, and the static
// tile grid: `n_tiles` column tiles times `row_slots` = ceil(M / BM) + G row
// slots, which bounds the live row tiles plus the tail's zero tiles.
struct GmmTmaArgs {
  CUtensorMap lhs, rhs;
  GmmParams p;
  int n_tiles, row_slots;
};

// CW consumer warpgroups of 64 rows each (BM = 64 CW rows per tile), BN
// output columns per tile, and a ring of STAGES stages, each one 64-deep
// chunk of K: the lhs rows [BM][64] and the rhs [64][BN] as BN / 64
// [64][64] parts, all 128-byte swizzled
template <int CW, int BN, int STAGES>
struct GmmHopperSmem {
  static constexpr int BM = 64 * CW;
  static constexpr int half = 64 * 128;  // one [64][64] part
  static constexpr int a = 0;
  static constexpr int b = BM * 128;
  static constexpr int stage = b + (BN / 64) * half;
  static constexpr int bars = STAGES * stage;  // full, then empty
  static constexpr int bytes = bars + 8 * 2 * STAGES + 1024;
};

// One tile of the static grid: rows [r0, r1) of group g times columns
// [n0, n0 + BN), g = -1 for rows at or past the total (written as 0), and
// r0 >= r1 for a slot past the tiles.
struct GmmTile {
  int g, r0, r1, n0;
};

// Slot s of the grid: column tile s % n_tiles, row slot r = s / n_tiles.
// The live tiles come first: row slot r < live is tile i = r - toffs[g] of
// the group g with toffs[g] <= r < toffs[g + 1], rows offs[g] + i BM on
// (clipped to the group's end and to M). The rows from the total up follow,
// BM to a slot. toffs[g] = the sum of ceil(rows of group h / BM) over h < g.
__device__ __forceinline__ GmmTile gmm_tile(const GmmParams& p,
                                            const int* offs, const int* toffs,
                                            int n_tiles, int BM, int BN,
                                            int s) {
  const int r = s / n_tiles;
  const int live = toffs[p.G];
  GmmTile t;
  t.n0 = (s % n_tiles) * BN;
  if (r < live) {
    t.g = group_of(toffs, p.G, r);
    t.r0 = min(offs[t.g], p.M) + (r - toffs[t.g]) * BM;
    t.r1 = min(t.r0 + BM, min(offs[t.g + 1], p.M));
  } else {
    t.g = -1;
    t.r0 = min(offs[p.G], p.M) + (r - live) * BM;
    t.r1 = min(t.r0 + BM, p.M);
  }
  return t;
}

template <typename OT>
__device__ __forceinline__ void store_pair(OT* dst, float x0, float x1,
                                           bool two, bool paired) {
  if (two && paired) {
    if constexpr (sizeof(OT) == 2)
      *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x0, x1);
    else
      *reinterpret_cast<float2*>(dst) = make_float2(x0, x1);
  } else {
    dst[0] = from_f32<OT>(x0);
    if (two) dst[1] = from_f32<OT>(x1);
  }
}

// A persistent block walks the slots blockIdx.x, + gridDim.x, ...: it scans
// group_sizes into offs and toffs once, then its producer warp streams each
// live tile's K chunks through the ring (lhs by a 2-D map at the tile's
// first row: rows of the next group are loaded but never stored; rhs by a
// 3-D map at (n, k, g), only the 64-column parts inside N) while the
// consumer warpgroups run the products, each its 64 rows: per chunk 4 k
// steps of one wgmma m64n256k16 (BN 256) or BN / 64 of m64n64k16, both
// operands in shared memory, fp32 accumulators in registers, one batch
// left in flight while the previous chunk's stage is released. A tile
// past N's edge multiplies its unloaded parts too (their columns are
// never stored): a product under a per-part branch makes ptxas serialize
// every wgmma. The epilogue writes the tile's rows of g (or zeros) from
// the registers, in the output dtype. A row's sum over K runs over the
// same chunks and k steps in the same order wherever the row sits in its
// tile, so rows are bitwise the same at any M and any CW.
template <int CW, int BN, int STAGES, typename OT>
__global__ void __launch_bounds__(CW * 128 + 32, 1)
    gmm_hopper_kernel(const __grid_constant__ GmmTmaArgs a) {
  using L = GmmHopperSmem<CW, BN, STAGES>;
  constexpr int NP = BN / 64;  // 64-column parts of a tile
  constexpr int NT = CW * 128 + 32;
  constexpr int BM = L::BM;
  const GmmParams& p = a.p;
  __shared__ int offs[kMaxGroups + 1];
  __shared__ int toffs[kMaxGroups + 1];
  extern __shared__ __align__(1024) unsigned char smem_tma[];
  unsigned char* smem =
      smem_tma + ((1024 - (smem_u32(smem_tma) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + L::bars;
  const uint32_t empty = full + 8 * STAGES;

  exclusive_scan<NT>([&](int g) { return max(p.sizes[g], 0); }, p.G, offs);
  exclusive_scan<NT>(
      [&](int g) {
        return (min(offs[g + 1], p.M) - min(offs[g], p.M) + BM - 1) / BM;
      },
      p.G, toffs);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * CW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int slots = a.n_tiles * a.row_slots;
  const int chunks = (p.K + 63) / 64;
  if (threadIdx.x >= CW * 128) {  // the producer warp: one thread issues
    if (threadIdx.x != CW * 128) return;
    int stage = 0, phase = 0;
    for (int s = blockIdx.x; s < slots; s += gridDim.x) {
      const GmmTile t = gmm_tile(p, offs, toffs, a.n_tiles, BM, BN, s);
      if (t.g < 0 || t.r0 >= t.r1) continue;
      const int parts = min(NP, (p.N - t.n0 + 63) / 64);
      for (int c = 0; c < chunks; ++c) {
        mbar_wait(empty + 8 * stage, phase ^ 1);
        const uint32_t st = base + stage * L::stage;
        const uint32_t bar = full + 8 * stage;
        mbar_expect_tx(bar, BM * 128 + parts * L::half);
        tma_load_2d(st + L::a, &a.lhs, bar, c * 64, t.r0);
        for (int hf = 0; hf < parts; ++hf)
          tma_load_3d(st + L::b + hf * L::half, &a.rhs, bar,
                      t.n0 + hf * 64, c * 64, t.g);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // the consumer warpgroups
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const bool paired = p.N % 2 == 0;  // a column pair is one aligned store
  OT* out = static_cast<OT*>(p.out);
  int stage = 0, phase = 0;
  for (int s = blockIdx.x; s < slots; s += gridDim.x) {
    GmmTile t = gmm_tile(p, offs, toffs, a.n_tiles, BM, BN, s);
    // the same for every thread, but read from shared memory: broadcast
    // from lane 0, so that the compiler can see that the branches around
    // the products are uniform
    t.g = __shfl_sync(kFull, t.g, 0);
    t.r0 = __shfl_sync(kFull, t.r0, 0);
    t.r1 = __shfl_sync(kFull, t.r1, 0);
    if (t.r0 >= t.r1) continue;
    float acc[NP][32];
#pragma unroll
    for (int hf = 0; hf < NP; ++hf)
#pragma unroll
      for (int x = 0; x < 32; ++x) acc[hf][x] = 0.f;
    if (t.g >= 0) {
      int prev = -1;
      for (int c = 0; c < chunks; ++c) {
        mbar_wait(full + 8 * stage, phase);
        const uint32_t st = base + stage * L::stage;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t da =
              sw128_desc(st + L::a + wg * 64 * 128 + kk * 32);
          if constexpr (NP == 4) {  // one m64n256k16 over the tile
            wgmma_ss_n256(acc, da,
                          sw128_desc_parts(st + L::b + kk * 2048, L::half));
          } else {
#pragma unroll
            for (int hf = 0; hf < NP; ++hf)
              wgmma_ss_n(acc[hf], da,
                         sw128_desc(st + L::b + hf * L::half + kk * 2048));
          }
        }
        wg_commit();
        wg_wait1();  // the previous chunk's products are done
#pragma unroll
        for (int hf = 0; hf < NP; ++hf) fence_regs(acc[hf]);
        if (prev >= 0) {
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + 8 * prev);
        }
        prev = stage;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      wg_wait0();
#pragma unroll
      for (int hf = 0; hf < NP; ++hf) fence_regs(acc[hf]);
      if (prev >= 0) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * prev);
      }
    }
    // acc[hf][4 j + 2 i + e]: row r0 + 64 wg + 16 warp + lane / 4 + 8 i,
    // column n0 + 64 hf + 8 j + 2 (lane % 4) + e
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = t.r0 + wg * 64 + 16 * warp + lane / 4 + 8 * i;
      if (row >= t.r1) continue;
      OT* dst = out + static_cast<long long>(row) * p.N;
#pragma unroll
      for (int hf = 0; hf < NP; ++hf)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = t.n0 + 64 * hf + 8 * j + 2 * (lane % 4);
          if (col < p.N)
            store_pair<OT>(dst + col, acc[hf][4 * j + 2 * i],
                           acc[hf][4 * j + 2 * i + 1], col + 1 < p.N, paired);
        }
    }
  }
}

// ---- K5, the split body (fp32 lhs against K-major bf16 rhs): wgmma

// CW consumer warpgroups of 64 rows each, BN output columns per tile, a
// ring of STAGES stages, each one 64-deep chunk of K: the fp32 lhs rows
// [BM][64] as two [BM][32] boxes and the rhs [BN][64] (N rows of K), all
// 128-byte swizzled
template <int CW, int BN, int STAGES>
struct GmmSplitSmem {
  static constexpr int BM = 64 * CW;
  static constexpr int a = 0;
  static constexpr int b = BM * 256;
  static constexpr int stage = b + BN * 128;
  static constexpr int bars = STAGES * stage;  // full, then empty
  static constexpr int bytes = bars + 8 * 2 * STAGES + 1024;
};

// The backward's d_lhs = dy @ rhs^T with fp32 dy: as gmm_hopper_kernel
// (persistent blocks over the static grid of group-aligned row tiles, a
// producer warp feeding a TMA ring), but lhs comes in as fp32 and is split
// by the consumer into hi = bf16(x) and lo = bf16(x - hi) A fragments in
// registers, and rhs (K-contiguous: rhs^T, a view of the [G, N, K] stack)
// is wgmma's K-major B, read by a 3-D map at (k, n, g) with no copy. Per
// k step of 16 the tile takes two products, hi then lo, m64n{BN}k16, into
// the chunk's accumulator, which is added to an fp32 register sum at the
// chunk's end (the tensor cores' own sum truncates:
// `chip_smoke.py:tc_sum_drift`); the fragments of a step are built while
// the previous step's products run.
// The rhs is exact in bf16, so the result misses the fp32 product by the
// split's 2**-16 |x| a term at most, and by fp32 summation order. Rows sum
// over the same chunks and k steps in the same order whatever tile holds
// them.
template <int CW, int BN, int STAGES, typename OT>
__global__ void __launch_bounds__(CW * 128 + 32, 1)
    gmm_split_kernel(const __grid_constant__ GmmTmaArgs a) {
  using L = GmmSplitSmem<CW, BN, STAGES>;
  constexpr int NT = CW * 128 + 32;
  constexpr int BM = L::BM;
  const GmmParams& p = a.p;
  __shared__ int offs[kMaxGroups + 1];
  __shared__ int toffs[kMaxGroups + 1];
  extern __shared__ __align__(1024) unsigned char smem_tma[];
  unsigned char* smem =
      smem_tma + ((1024 - (smem_u32(smem_tma) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + L::bars;
  const uint32_t empty = full + 8 * STAGES;

  exclusive_scan<NT>([&](int g) { return max(p.sizes[g], 0); }, p.G, offs);
  exclusive_scan<NT>(
      [&](int g) {
        return (min(offs[g + 1], p.M) - min(offs[g], p.M) + BM - 1) / BM;
      },
      p.G, toffs);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * CW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int slots = a.n_tiles * a.row_slots;
  const int chunks = (p.K + 63) / 64;
  if (threadIdx.x >= CW * 128) {  // the producer warp: one thread issues
    if (threadIdx.x != CW * 128) return;
    int stage = 0, phase = 0;
    for (int s = blockIdx.x; s < slots; s += gridDim.x) {
      const GmmTile t = gmm_tile(p, offs, toffs, a.n_tiles, BM, BN, s);
      if (t.g < 0 || t.r0 >= t.r1) continue;
      for (int c = 0; c < chunks; ++c) {
        mbar_wait(empty + 8 * stage, phase ^ 1);
        const uint32_t st = base + stage * L::stage;
        const uint32_t bar = full + 8 * stage;
        mbar_expect_tx(bar, BM * 256 + BN * 128);
        tma_load_2d(st + L::a, &a.lhs, bar, c * 64, t.r0);
        tma_load_2d(st + L::a + BM * 128, &a.lhs, bar, c * 64 + 32, t.r0);
        tma_load_3d(st + L::b, &a.rhs, bar, c * 64, t.n0, t.g);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // the consumer warpgroups
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int quad = lane % 4;
  const int row = 64 * wg + 16 * warp + lane / 4;  // and row + 8, in a tile
  const bool paired = p.N % 2 == 0;  // a column pair is one aligned store
  OT* out = static_cast<OT*>(p.out);
  int stage = 0, phase = 0;
  for (int s = blockIdx.x; s < slots; s += gridDim.x) {
    GmmTile t = gmm_tile(p, offs, toffs, a.n_tiles, BM, BN, s);
    // uniform, but read from shared memory: broadcast from lane 0, so that
    // the compiler can see that the branches around the products are
    t.g = __shfl_sync(kFull, t.g, 0);
    t.r0 = __shfl_sync(kFull, t.r0, 0);
    t.r1 = __shfl_sync(kFull, t.r1, 0);
    if (t.r0 >= t.r1) continue;
    // acc: the fp32 sum over the chunks so far; part: this chunk's, from
    // the tensor cores, added to acc (rounded to nearest) at its end
    float acc[BN / 2], part[BN / 2];
#pragma unroll
    for (int x = 0; x < BN / 2; ++x) acc[x] = part[x] = 0.f;
    if (t.g >= 0) {
      // A fragments of two k steps: [step % 2][4 part + r], part 0 hi
      uint32_t frag[2][8];
      for (int c = 0; c < chunks; ++c) {
        mbar_wait(full + 8 * stage, phase);
        const unsigned char* st = smem + stage * L::stage;
        const uint32_t bt = base + stage * L::stage + L::b;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t(&f)[8] = frag[kk % 2];
          // the box of k 32 (kk / 2) on; columns 2 (l % 4) + {0, 1} and + 8
          // of the step, rows `row` and row + 8
          const unsigned char* box = st + L::a + (kk / 2) * BM * 128;
          const int col = 4 * (16 * (kk % 2) + 2 * quad);  // bytes
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const float2 v = *reinterpret_cast<const float2*>(
                  box + sw128(row + 8 * i, col + 32 * h));
              split_bf16(v.x, v.y, f[2 * h + i], f[4 + 2 * h + i]);
            }
          wg_fence();
          const uint64_t db = sw128_desc(bt + kk * 32);
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
        for (int x = 0; x < BN / 2; ++x) acc[x] += part[x];
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * stage);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    // acc[4 j + 2 i + e]: row r0 + row + 8 i, column n0 + 8 j + 2 (l % 4)
    // + e
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = t.r0 + row + 8 * i;
      if (r >= t.r1) continue;
      OT* dst = out + static_cast<long long>(r) * p.N;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = t.n0 + 8 * j + 2 * quad;
        if (col < p.N)
          store_pair<OT>(dst + col, acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1],
                         col + 1 < p.N, paired);
      }
    }
  }
}

// ---- K6 (FMA on the CUDA cores, fp32)

struct TgmmParams {
  const void* lhs;   // [M, K], row stride l_sm, unit column stride
  const void* dy;    // [M, N], row stride d_sm, unit column stride
  const int* sizes;  // [G] int32
  void* out;         // [G, K, N] contiguous, the output dtype
  int M, K, N, G;
  long long l_sm, d_sm;
};

// One block: a BKT x BN tile of d_rhs[g]; its group's rows in chunks of BR,
// the next chunk loaded into registers while the current one is summed.
// Each output sums over the group's rows in order (one fmaf each).
template <typename AT, typename BT, typename OT>
__global__ void __launch_bounds__(kThreads)
tgmm_kernel(const TgmmParams p) {
  constexpr int BKT = 128;  // rows of d_rhs[g] (the K axis) per block
  constexpr int BN = 128;   // columns (the N axis) per block
  constexpr int BR = 8;     // rows of the group per chunk
  constexpr int R = 8;      // K rows and N columns per thread
  constexpr int LL = BR * BKT / kThreads;
  constexpr int LD = BR * BN / kThreads;
  __shared__ int offs[kMaxGroups + 1];
  __shared__ __align__(16) float Ls[BR][BKT + 4];
  __shared__ __align__(16) float Ds[BR][BN + 4];
  group_offsets(p.sizes, p.G, offs);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int n0 = blockIdx.x * BN;
  const int k0 = blockIdx.y * BKT;
  const int g = blockIdx.z;
  const int ra = min(offs[g], p.M);
  const int rb = min(offs[g + 1], p.M);
  const AT* lhs = static_cast<const AT*>(p.lhs);
  const BT* dy = static_cast<const BT*>(p.dy);
  float acc[R][R];
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < R; ++c) acc[a][c] = 0.f;

  float rl[LL], rd[LD];
  auto fetch = [&](int r0) {
#pragma unroll
    for (int i = 0; i < LL; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / BKT;
      const int k = idx - r * BKT;
      const int row = r0 + r;
      rl[i] = (row < rb && k0 + k < p.K) ? to_f32(lhs[row * p.l_sm + k0 + k])
                                          : 0.f;
    }
#pragma unroll
    for (int i = 0; i < LD; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx / BN;
      const int n = idx - r * BN;
      const int row = r0 + r;
      rd[i] = (row < rb && n0 + n < p.N) ? to_f32(dy[row * p.d_sm + n0 + n])
                                          : 0.f;
    }
  };
  if (ra < rb) fetch(ra);
  for (int r0 = ra; r0 < rb; r0 += BR) {
    __syncthreads();  // the previous chunk's reads are done
#pragma unroll
    for (int i = 0; i < LL; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      Ls[idx / BKT][idx % BKT] = rl[i];
    }
#pragma unroll
    for (int i = 0; i < LD; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      Ds[idx / BN][idx % BN] = rd[i];
    }
    __syncthreads();
    if (r0 + BR < rb) fetch(r0 + BR);
#pragma unroll
    for (int r = 0; r < BR; ++r) {
      float av[R], bv[R];
      read_owned<R>(Ls[r], ty, av);
      read_owned<R>(Ds[r], tx, bv);
#pragma unroll
      for (int a = 0; a < R; ++a)
#pragma unroll
        for (int c = 0; c < R; ++c) acc[a][c] = fmaf(av[a], bv[c], acc[a][c]);
    }
  }

  OT* out = static_cast<OT*>(p.out) + static_cast<long long>(g) * p.K * p.N;
#pragma unroll
  for (int a = 0; a < R; ++a) {
    const int k = k0 + owned<R>(ty, a);
    if (k >= p.K) continue;
#pragma unroll
    for (int c = 0; c < R; ++c) {
      const int n = n0 + owned<R>(tx, c);
      if (n < p.N)
        out[static_cast<long long>(k) * p.N + n] = from_f32<OT>(acc[a][c]);
    }
  }
}

// ---- K6, the split body (bf16 lhs, fp32 dy): wgmma

// Two consumer warpgroups and a producer warpgroup; registers at launch 168
// a thread (64K / 384), then 24 for the producer and 240 for the consumers
// (24 + 2 x 240 = 3 x 168)
constexpr int kTgmmThreads = 384;
constexpr int kTgmmConsumerRegs = 240;

// Tensor maps of lhs [M, K] and dy [M, N], the scalars, and the static
// tile grid: G groups x k_tiles x n_tiles tiles of 128 K rows x 128 N
// columns of d_rhs[g], group-major.
struct TgmmTmaArgs {
  CUtensorMap lhs, dy, out;
  TgmmParams p;
  int k_tiles, n_tiles;
};

// A ring of STAGES stages, each one 64-row chunk of a group: dy [64][128 n]
// fp32 as four [64][32] boxes (the first two warpgroup 0's columns, the
// last two warpgroup 1's) and lhs [64][128 k] bf16 as two [64][64] parts,
// all 128-byte swizzled, 48 KB a stage; then 16 KB of zeros, which an
// empty group's tiles store
template <int STAGES>
struct TgmmSplitSmem {
  static constexpr int box = 64 * 128;
  static constexpr int dy = 0;
  static constexpr int lhs = 4 * box;
  static constexpr int stage = 6 * box;
  static constexpr int zero = STAGES * stage;
  static constexpr int bars = zero + 2 * box;  // full, then empty
  static constexpr int bytes = bars + 8 * 2 * STAGES + 1024;
};

// Tile s of the grid: group g, K rows [k0, k0 + 128), N columns [n0, n0 +
// 128), over the group's rows [r0, r1) (clipped to M)
struct TgmmTile {
  int g, k0, n0, r0, r1;
};

__device__ __forceinline__ TgmmTile tgmm_tile(const TgmmTmaArgs& a,
                                              const int* offs, int s) {
  const int per = a.k_tiles * a.n_tiles;
  TgmmTile t;
  t.g = s / per;
  t.k0 = (s % per) / a.n_tiles * 128;
  t.n0 = (s % per) % a.n_tiles * 128;
  t.r0 = min(offs[t.g], a.p.M);
  t.r1 = min(offs[t.g + 1], a.p.M);
  return t;
}

// The backward's d_rhs[g] = lhs_g^T dy_g with bf16 lhs and fp32 dy, as
// out[g]^T = dy_g^T lhs_g: persistent blocks walk the static grid
// group-major (a group's rows stay in L2 while its tiles run); one thread
// of a producer warpgroup streams each tile's 64-row chunks, counted from
// the group's first row, through a TMA ring (48 KB a stage, four stages),
// and two consumer warpgroups each compute 64 N
// columns x 128 K rows. wgmma's A is dy_g^T from registers: each thread
// reads its fp32 values of the chunk (columns of the swizzled dy boxes,
// conflict-free: a warp's 8 columns x 4 rows span all 32 banks) and splits
// them into bf16 hi and lo fragments; B is lhs_g read N-major (k
// contiguous) from the ring. Per k step of 16 rows two products, hi then
// lo, m64n128k16, into the chunk's accumulator, added to an fp32 register
// sum at the chunk's end (the tensor cores' own sum truncates:
// `chip_smoke.py:tc_sum_drift`). No row outside the group reaches a
// product: the group's last chunk skips the k steps past its end and
// zeroes that chunk's rows past it, in both operands, in shared memory (0
// x NaN is NaN, and the tail past the total may hold anything). So
// d_rhs[g] depends on the group's own rows alone, summed over the same
// chunks and k steps whatever the other groups hold and wherever the
// group starts: bitwise the same, with no atomics. The epilogue stages a
// warpgroup's tile, transposed by stmatrix (bf16), in its own dy boxes of
// the last chunk's stage, which it holds until then, and one thread
// stores it by TMA (clipped at K and N) while the warpgroup goes on to
// its next tile; the stage goes back once the store has read it. An empty
// group's tiles store a zero tile by TMA. Tiles past K or N multiply their
// unloaded parts too (never stored): a product under a per-part branch
// makes ptxas serialize every wgmma. The tensor cores' two passes bound it; variants
// measured on the H100 (PERF.md) put most of the rest into building the A
// fragments (shared-memory reads and the split) and into each chunk's
// register sum, while the tile's staging and store overlap the next
// tile.
template <int STAGES, typename OT>
__global__ void __launch_bounds__(kTgmmThreads, 1)
    tgmm_split_kernel(const __grid_constant__ TgmmTmaArgs a) {
  using L = TgmmSplitSmem<STAGES>;
  constexpr int NT = kTgmmThreads;
  const TgmmParams& p = a.p;
  __shared__ int offs[kMaxGroups + 1];
  extern __shared__ __align__(1024) unsigned char smem_tma[];
  unsigned char* smem =
      smem_tma + ((1024 - (smem_u32(smem_tma) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  const uint32_t full = base + L::bars;
  const uint32_t empty = full + 8 * STAGES;

  exclusive_scan<NT>([&](int g) { return max(p.sizes[g], 0); }, p.G, offs);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int i = threadIdx.x; i < 2 * L::box / 16; i += NT)
    reinterpret_cast<uint4*>(smem + L::zero)[i] = make_uint4(0, 0, 0, 0);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  const int slots = p.G * a.k_tiles * a.n_tiles;
  if (threadIdx.x >= 256) {  // the producer warpgroup: one thread issues
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x != 256) return;
    int stage = 0, phase = 0;
    for (int s = blockIdx.x; s < slots; s += gridDim.x) {
      const TgmmTile t = tgmm_tile(a, offs, s);
      const int dy_boxes = min(4, (p.N - t.n0 + 31) / 32);
      const int lhs_parts = min(2, (p.K - t.k0 + 63) / 64);
      for (int r = t.r0; r < t.r1; r += 64) {
        mbar_wait(empty + 8 * stage, phase ^ 1);
        const uint32_t st = base + stage * L::stage;
        const uint32_t bar = full + 8 * stage;
        mbar_expect_tx(bar, (dy_boxes + lhs_parts) * L::box);
        for (int b = 0; b < dy_boxes; ++b)
          tma_load_2d(st + L::dy + b * L::box, &a.dy, bar, t.n0 + 32 * b, r);
        for (int h = 0; h < lhs_parts; ++h)
          tma_load_2d(st + L::lhs + h * L::box, &a.lhs, bar, t.k0 + 64 * h,
                      r);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // the consumer warpgroups
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kTgmmConsumerRegs));
  const int wg = threadIdx.x / 128;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = threadIdx.x % 32;
  const int quad = lane % 4;
  // this thread's A rows: N columns 64 wg + 16 warp + lane / 4 (+ 8) of the
  // tile, in dy box 2 wg + warp / 2 at these bytes (+ 32)
  const int wg_dy = L::dy + 2 * wg * L::box;  // this warpgroup's dy boxes
  const int dbox = wg_dy + warp / 2 * L::box;
  const int dcol = 4 * (16 * (warp % 2) + lane / 4);
  constexpr int PASSES = sizeof(OT) / 2;  // staged K rows: 128 / PASSES
  constexpr int KP = 128 / PASSES;
  int stage = 0, phase = 0;
  int pending = -1;  // warp 0: a stage that its thread 0's stores still read
  for (int s = blockIdx.x; s < slots; s += gridDim.x) {
    TgmmTile t = tgmm_tile(a, offs, s);
    // uniform, but read from shared memory: broadcast from lane 0, so that
    // the compiler can see that the branches around the products are
    t.r0 = __shfl_sync(kFull, t.r0, 0);
    t.r1 = __shfl_sync(kFull, t.r1, 0);
    // acc: the fp32 sum over the chunks so far; part: this chunk's, from
    // the tensor cores, added to acc (rounded to nearest) at its end
    float acc[64], part[64];
#pragma unroll
    for (int x = 0; x < 64; ++x) acc[x] = part[x] = 0.f;
    int held = -1;  // the stage of the tile's last chunk, kept for staging
    for (int r = t.r0; r < t.r1; r += 64) {
      mbar_wait(full + 8 * stage, phase);
      const int valid = min(64, t.r1 - r);  // rows of the group here
      const int steps = (valid + 15) / 16;  // k steps that hold any
      unsigned char* st = smem + stage * L::stage;
      const unsigned char* dys = st + dbox;
      const uint32_t lt = base + stage * L::stage + L::lhs;
      // A fragments of two k steps: [step % 2][4 part + r], part 0 hi
      uint32_t frag[2][8];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk >= steps) break;
        if (kk == steps - 1 && valid < 16 * steps) {
          // the rows of this last k step past the group's end to 0 (later
          // steps are skipped), while the earlier steps' products run: in
          // the lhs parts, for the async proxy to read, and in this
          // warpgroup's dy boxes. Each warpgroup zeroes all the lhs rows
          // and waits for its own threads only: the other may be writing
          // the same zeros, which changes nothing that a product reads.
          for (int idx = tid; idx < (16 * steps - valid) * 32; idx += 128) {
            const int box = idx % 32 / 8;  // lhs 0, 1; own dy boxes 2, 3
            *reinterpret_cast<uint4*>(
                st + (box < 2 ? L::lhs : wg_dy - 2 * L::box) +
                box * L::box + (valid + idx / 32) * 128 + idx % 8 * 16) =
                make_uint4(0, 0, 0, 0);
          }
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");
        }
        uint32_t(&f)[8] = frag[kk % 2];
        // rows 16 kk + 2 (l % 4) + {0, 1} and + 8 (h) of columns n, n + 8
        // (i); f[2 h + i] hi, f[4 + 2 h + i] lo
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = 16 * kk + 2 * quad + 8 * h;
            const float x0 =
                *reinterpret_cast<const float*>(dys + sw128(row, dcol + 32 * i));
            const float x1 = *reinterpret_cast<const float*>(
                dys + sw128(row + 1, dcol + 32 * i));
            split_bf16(x0, x1, f[2 * h + i], f[4 + 2 * h + i]);
          }
        wg_fence();
        const uint64_t db = sw128_desc_parts(lt + kk * 2048, L::box);
        wgmma_rs_n(part, f[0], f[1], f[2], f[3], db, kk > 0);
        wgmma_rs_n(part, f[4], f[5], f[6], f[7], db, 1);
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
      for (int x = 0; x < 64; ++x) acc[x] += part[x];
      if (r + 64 < t.r1) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * stage);
      } else {
        held = stage;
      }
      if (pending >= 0) {  // the previous tile's stores have read it
        if (tid == 0) {
          bulk_wait_read();
          mbar_arrive(empty + 8 * pending);
        }
        pending = -1;
      }
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    // a warpgroup's tile of out[g] leaves by TMA stores (clipped at K and
    // N) of KP K rows x 64 columns a pass: one box (bf16) or two 32-column
    // boxes (fp32)
    auto store_pass = [&](uint32_t src, int pass) {
#pragma unroll
      for (int part = 0; part < PASSES; ++part)
        tma_store_3d(&a.out, src + part * (2 * L::box / PASSES),
                     t.n0 + 64 * wg + part * (64 / PASSES), t.k0 + pass * KP,
                     t.g);
      bulk_commit();
    };
    if (held < 0) {  // an empty group's tile: the zero tile, stored
      if (tid == 0)
        for (int pass = 0; pass < PASSES; ++pass)
          store_pass(base + L::zero, pass);
      continue;
    }
    // acc[4 j + 2 i + e]: N column 64 wg + 16 warp + lane / 4 + 8 i, K row
    // 8 j + 2 (l % 4) + e of the tile. Staged in this warpgroup's two dy
    // boxes of the held stage (16 KB), KP K rows a pass: row (part, k) of
    // 128 bytes holds the part's columns of K row k, in the 128-byte
    // swizzle of TMA's tiles (bf16: one stmatrix per four 8 x 8 blocks;
    // fp32: a warp's writes of one value span 4 rows x 8 columns, no bank
    // conflict)
    unsigned char* stg = smem + held * L::stage + wg_dy;
    auto stage_pass = [&](int pass) {
      if constexpr (sizeof(OT) == 2) {
        // the blocks (i, j), (i + 1, j), (i, j + 1), (i + 1, j + 1):
        // lane 8 t + c addresses K row 8 (j + t / 2) + c at columns 16
        // warp + 8 (t % 2)
        const uint32_t sbase = smem_u32(stg);
        const int t = lane / 8;
#pragma unroll
        for (int j = 0; j < 16; j += 2)
          stmatrix_x4_trans(
              sbase + sw128(8 * (j + t / 2) + lane % 8,
                            32 * warp + 16 * (t % 2)),
              pack_bf16(acc[4 * j], acc[4 * j + 1]),
              pack_bf16(acc[4 * j + 2], acc[4 * j + 3]),
              pack_bf16(acc[4 * j + 4], acc[4 * j + 5]),
              pack_bf16(acc[4 * j + 6], acc[4 * j + 7]));
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (j / 8 != pass) continue;
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int k = 8 * j + 2 * quad + e - pass * KP;
              const int byte = (16 * warp + lane / 4 + 8 * i) * sizeof(OT);
              *reinterpret_cast<OT*>(stg + sw128(byte / 128 * KP + k,
                                                 byte % 128)) =
                  from_f32<OT>(acc[4 * j + 2 * i + e]);
            }
        }
      }
    };
    // warp 0 gives the stage back once the stores have read it, after the
    // next chunk
#pragma unroll
    for (int pass = 0; pass < PASSES; ++pass) {
      if (pass > 0) {  // the previous pass's stores have read the staging
        if (tid == 0) bulk_wait_read();
        asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");
      }
      stage_pass(pass);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("bar.sync %0, 128;" ::"r"(2 + wg) : "memory");
      if (tid == 0) store_pass(smem_u32(stg), pass);
    }
    if (warp == 0) {
      pending = held;
    } else {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * held);
    }
  }
  if (pending >= 0 && tid == 0) mbar_arrive(empty + 8 * pending);
  if (tid == 0) bulk_wait();  // the last tiles' stores are written
}

// ---- launches

// blocks sharing one row tile: about the number of group indices a tile of
// BM rows spans when M rows spread over G groups, plus one for a boundary
int z_split(int BM, int M, int G) {
  const long long span = (static_cast<long long>(BM) * G + M - 1) / M + 1;
  return static_cast<int>(span < G ? span : (G > 0 ? G : 1));
}

template <int BM, int BN, int BK, typename AT, typename BT, typename OT>
int launch_fma(GmmParams p, cudaStream_t stream) {
  p.Z = z_split(BM, p.M, p.G);
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, p.Z);
  gmm_fma_kernel<BM, BN, BK, AT, BT, OT><<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN, int BK, typename AT, typename BT>
int fma_out(const GmmParams& p, int out_dt, cudaStream_t stream) {
  return out_dt == kBF16 ? launch_fma<BM, BN, BK, AT, BT, bf16>(p, stream)
                         : launch_fma<BM, BN, BK, AT, BT, float>(p, stream);
}

template <int BM, int BN, int BK>
int fma_dispatch(const GmmParams& p, int a_dt, int b_dt, int out_dt,
                 cudaStream_t stream) {
  if (a_dt == kF32 && b_dt == kF32)
    return fma_out<BM, BN, BK, float, float>(p, out_dt, stream);
  if (a_dt == kF32 && b_dt == kBF16)
    return fma_out<BM, BN, BK, float, bf16>(p, out_dt, stream);
  if (a_dt == kBF16 && b_dt == kF32)
    return fma_out<BM, BN, BK, bf16, float>(p, out_dt, stream);
  return fma_out<BM, BN, BK, bf16, bf16>(p, out_dt, stream);
}

template <int BM, int BN, int WM, int WN, typename OT>
int launch_tc(GmmParams p, cudaStream_t stream) {
  p.Z = z_split(BM, p.M, p.G);
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, p.Z);
  gmm_tc_kernel<BM, BN, WM, WN, OT><<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, int BN, int WM, int WN>
int tc_out(const GmmParams& p, int out_dt, cudaStream_t stream) {
  return out_dt == kBF16 ? launch_tc<BM, BN, WM, WN, bf16>(p, stream)
                         : launch_tc<BM, BN, WM, WN, float>(p, stream);
}

template <typename AT, typename BT>
int tgmm_out(const TgmmParams& p, int out_dt, cudaStream_t stream) {
  const dim3 grid((p.N + 127) / 128, (p.K + 127) / 128, p.G);
  if (out_dt == kBF16)
    tgmm_kernel<AT, BT, bf16><<<grid, kThreads, 0, stream>>>(p);
  else
    tgmm_kernel<AT, BT, float><<<grid, kThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool valid_dtype(int dt) { return dt == kF32 || dt == kBF16; }

// the SMs of the current device: one persistent block each
int sm_count() {
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 1;
  }();
  return sms;
}

// row tiles of at most this many rows take the small-tile bodies (decode)
constexpr int kSmallM = 256;

template <int CW, int BN, int STAGES, typename OT>
int launch_wgmma(const GmmParams& p, cudaStream_t stream) {
  using L = GmmHopperSmem<CW, BN, STAGES>;
  GmmTmaArgs a;
  memset(&a, 0, sizeof(a));
  a.p = p;
  a.n_tiles = (p.N + BN - 1) / BN;
  a.row_slots = (p.M + L::BM - 1) / L::BM + p.G;
  const long long slots = static_cast<long long>(a.n_tiles) * a.row_slots;
  if (slots > (1ll << 30)) return -1;
  if (p.K > 0 && p.G > 0) {  // else no tile loads anything
    const long long lhs_dims[2] = {p.K, p.M}, rhs_dims[3] = {p.N, p.K, p.G};
    const long long rhs_strides[2] = {p.r_sk, p.r_sg};
    const int lhs_box[2] = {64, L::BM}, rhs_box[3] = {64, 64, 1};
    if (encode_tiled() == nullptr ||
        !map_bf16(&a.lhs, p.lhs, 2, lhs_dims, &p.l_sm, lhs_box) ||
        !map_bf16(&a.rhs, p.rhs, 3, rhs_dims, rhs_strides, rhs_box))
      return kNoTensorMap;
  }
  const int sms = sm_count();
  const int grid = static_cast<int>(slots < sms ? slots : sms);
  return launch_kernel(gmm_hopper_kernel<CW, BN, STAGES, OT>, L::bytes,
                       dim3(grid), CW * 128 + 32, a, stream);
}

// The Hopper body's tile. Up to kSmallM rows (decode: a group holds 1-2
// rows, and every live group's weights stream through its own tiles): one
// consumer warpgroup, 64 x 128 tiles, a 6-deep ring, so that the tiles
// spread over the SMs. Above it two, 128 x 256 tiles (each lhs row and
// each rhs slice crosses from L2 to an SM fewer times), a 4-deep ring.
template <typename OT>
int wgmma_rows(const GmmParams& p, cudaStream_t stream) {
  return p.M <= kSmallM ? launch_wgmma<1, 128, 6, OT>(p, stream)
                        : launch_wgmma<2, 256, 4, OT>(p, stream);
}

template <int CW, int BN, int STAGES, typename OT>
int launch_split(const GmmParams& p, cudaStream_t stream) {
  using L = GmmSplitSmem<CW, BN, STAGES>;
  GmmTmaArgs a;
  memset(&a, 0, sizeof(a));
  a.p = p;
  a.n_tiles = (p.N + BN - 1) / BN;
  a.row_slots = (p.M + L::BM - 1) / L::BM + p.G;
  const long long slots = static_cast<long long>(a.n_tiles) * a.row_slots;
  if (slots > (1ll << 30)) return -1;
  if (p.K > 0 && p.G > 0) {  // else no tile loads anything
    // rhs^T [G, K, N] with K contiguous: the map runs over (k, n, g)
    const long long lhs_dims[2] = {p.K, p.M}, rhs_dims[3] = {p.K, p.N, p.G};
    const long long rhs_strides[2] = {p.r_sn, p.r_sg};
    const int lhs_box[2] = {32, L::BM}, rhs_box[3] = {64, BN, 1};
    if (encode_tiled() == nullptr ||
        !map_f32(&a.lhs, p.lhs, 2, lhs_dims, &p.l_sm, lhs_box) ||
        !map_bf16(&a.rhs, p.rhs, 3, rhs_dims, rhs_strides, rhs_box))
      return kNoTensorMap;
  }
  const int sms = sm_count();
  const int grid = static_cast<int>(slots < sms ? slots : sms);
  return launch_kernel(gmm_split_kernel<CW, BN, STAGES, OT>, L::bytes,
                       dim3(grid), CW * 128 + 32, a, stream);
}

// The split body's tile, as wgmma_rows: up to kSmallM rows one consumer
// warpgroup, 64 x 128 tiles, a 6-deep ring; above it two, 128 x 128 tiles
// (128 columns: a chunk's sum and the running sum both sit in registers),
// a 4-deep ring (48 KB a stage).
template <typename OT>
int split_rows(const GmmParams& p, cudaStream_t stream) {
  return p.M <= kSmallM ? launch_split<1, 128, 6, OT>(p, stream)
                        : launch_split<2, 128, 4, OT>(p, stream);
}

template <typename OT>
int launch_tgmm_split(const TgmmParams& p, cudaStream_t stream) {
  constexpr int kStages = 4;
  cudaFuncAttributes attr;  // registers at launch cover what setmaxnreg gives
  cudaError_t err = cudaFuncGetAttributes(&attr, tgmm_split_kernel<kStages, OT>);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (attr.numRegs * kTgmmThreads <
      (kProducerRegs + 2 * kTgmmConsumerRegs) * 128)
    return kFewRegisters;
  using L = TgmmSplitSmem<kStages>;
  TgmmTmaArgs a;
  memset(&a, 0, sizeof(a));
  a.p = p;
  a.k_tiles = (p.K + 127) / 128;
  a.n_tiles = (p.N + 127) / 128;
  const long long slots =
      static_cast<long long>(p.G) * a.k_tiles * a.n_tiles;
  if (slots > (1ll << 30)) return -1;
  if (encode_tiled() == nullptr) return kNoTensorMap;
  if (p.M > 0) {  // else no tile loads anything
    const long long lhs_dims[2] = {p.K, p.M}, dy_dims[2] = {p.N, p.M};
    const int lhs_box[2] = {64, 64}, dy_box[2] = {32, 64};
    if (!map_bf16(&a.lhs, p.lhs, 2, lhs_dims, &p.l_sm, lhs_box) ||
        !map_f32(&a.dy, p.dy, 2, dy_dims, &p.d_sm, dy_box))
      return kNoTensorMap;
  }
  // out [G, K, N] (rows on 16 bytes: tgmm_body_for) by TMA stores of a
  // warpgroup's staged 128 K rows x 64 columns (fp32: two 32-column boxes
  // of 64 rows a pass)
  const long long out_dims[3] = {p.N, p.K, p.G};
  const long long out_strides[2] = {p.N, static_cast<long long>(p.K) * p.N};
  const int out_box[3] = {128 / static_cast<int>(sizeof(OT)),
                          sizeof(OT) == 2 ? 128 : 64, 1};
  if (!(sizeof(OT) == 2
            ? map_bf16(&a.out, p.out, 3, out_dims, out_strides, out_box)
            : map_f32(&a.out, p.out, 3, out_dims, out_strides, out_box)))
    return kNoTensorMap;
  const int sms = sm_count();
  const int grid = static_cast<int>(slots < sms ? slots : sms);
  return launch_kernel(tgmm_split_kernel<kStages, OT>, L::bytes, dim3(grid),
                       kTgmmThreads, a, stream);
}

// The body of each operand set, the one table of it: `gmm` runs what it
// names, and ops/grouped_matmul.py holds its `_gmm_plan` against `gmm_body`
// when it loads this library. bf16 x bf16 whose tiles a tensor map can
// read (rhs N-contiguous; both bases and every other stride on 16 bytes)
// runs wgmma, other bf16 x bf16 WMMA; fp32 lhs against bf16 rhs that tensor
// maps read as the split body takes them (rhs K-contiguous, as rhs^T is;
// both bases and every other stride on 16 bytes) runs the split body;
// anything else FMA.
enum Body { kFmaBody = 0, kWmmaBody = 1, kWgmmaBody = 2, kSplitBody = 3 };

int body_for(int lhs_dt, int rhs_dt, const void* lhs, long long l_sm,
             const void* rhs, const long long* rs) {
  if (lhs_dt == kF32 && rhs_dt == kBF16) {
    const bool tma = on16(lhs) && (l_sm * 4) % 16 == 0 && on16(rhs) &&
                     rs[1] == 1 && (rs[0] * 2) % 16 == 0 &&
                     (rs[2] * 2) % 16 == 0;
    return tma ? kSplitBody : kFmaBody;
  }
  if (lhs_dt != kBF16 || rhs_dt != kBF16) return kFmaBody;
  const bool tma = on16(lhs) && (l_sm * 2) % 16 == 0 && on16(rhs) &&
                   rs[2] == 1 && (rs[0] * 2) % 16 == 0 &&
                   (rs[1] * 2) % 16 == 0;
  return tma ? kWgmmaBody : kWmmaBody;
}

// K6's table, as body_for: bf16 lhs against fp32 dy that tensor maps can
// read (unit column strides, both bases and row strides on 16 bytes), into
// output rows of N values on 16 bytes (the output is allocated contiguous
// by the caller), runs the split body, anything else FMA. Strides: {row,
// column}.
enum TgmmBody { kTgmmFmaBody = 0, kTgmmSplitBody = 1 };

int tgmm_body_for(int lhs_dt, int dy_dt, int out_dt, int N, const void* lhs,
                  const long long* ls, const void* dy, const long long* ds) {
  const bool tma = lhs_dt == kBF16 && dy_dt == kF32 && on16(lhs) &&
                   on16(dy) && ls[1] == 1 && ds[1] == 1 &&
                   (ls[0] * 2) % 16 == 0 && (ds[0] * 4) % 16 == 0 &&
                   (static_cast<long long>(N) * (out_dt == kBF16 ? 2 : 4)) %
                           16 == 0;
  return tma ? kTgmmSplitBody : kTgmmFmaBody;
}

}  // namespace

// Plain C entry points for ctypes. Each launch returns 0, the cudaError_t
// of the launch, -2 for a tensor map the driver refused, or -1 for a shape
// or dtype the kernels do not take. Dtype codes: 0 fp32, 1 bf16.
//
// gmm_body: the body that gmm runs for these operands (its arguments as
// gmm takes them): 0 FMA, 1 WMMA, 2 wgmma, 3 the split body.
extern "C" int gmm_body(int lhs_dtype, int rhs_dtype, const void* lhs,
                        long long lhs_row_stride, const void* rhs,
                        const long long* rhs_strides) {
  return body_for(lhs_dtype, rhs_dtype, lhs, lhs_row_stride, rhs,
                  rhs_strides);
}
//
// gmm (K5): lhs [M, K] (row stride lhs_row_stride, columns contiguous), rhs
// [G, K, N] read at g * rhs_strides[0] + k * rhs_strides[1] + n *
// rhs_strides[2], group_sizes [G] int32, out [M, N] contiguous, all on the
// device and allocated by the caller.
extern "C" int gmm(const void* lhs, const void* rhs, const void* group_sizes,
                   void* out, int M, int K, int N, int G,
                   long long lhs_row_stride, const long long* rhs_strides,
                   int lhs_dtype, int rhs_dtype, int out_dtype, void* stream) {
  if (M < 0 || K < 0 || N < 0 || G < 0 || G > kMaxGroups ||
      !valid_dtype(lhs_dtype) || !valid_dtype(rhs_dtype) ||
      !valid_dtype(out_dtype) || (M + 15) / 16 > 65535) {
    return -1;
  }
  if (M == 0 || N == 0) return 0;
  GmmParams p;
  p.lhs = lhs;
  p.rhs = rhs;
  p.sizes = static_cast<const int*>(group_sizes);
  p.out = out;
  p.M = M;
  p.K = K;
  p.N = N;
  p.G = G;
  p.Z = 1;
  p.l_sm = lhs_row_stride;
  p.r_sg = rhs_strides[0];
  p.r_sk = rhs_strides[1];
  p.r_sn = rhs_strides[2];
  p.vec_a = (reinterpret_cast<uintptr_t>(lhs) % 16) == 0 &&
            lhs_row_stride % 8 == 0 && K % 8 == 0;
  p.vec_b = (reinterpret_cast<uintptr_t>(rhs) % 16) == 0 && p.r_sn == 1 &&
            p.r_sg % 8 == 0 && p.r_sk % 8 == 0 && N % 8 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool small = M <= kSmallM;
  switch (body_for(lhs_dtype, rhs_dtype, lhs, lhs_row_stride, rhs,
                   rhs_strides)) {
    case kWgmmaBody:
      return out_dtype == kBF16 ? wgmma_rows<bf16>(p, st)
                                : wgmma_rows<float>(p, st);
    case kSplitBody:
      return out_dtype == kBF16 ? split_rows<bf16>(p, st)
                                : split_rows<float>(p, st);
    case kWmmaBody:
      return small ? tc_out<16, 128, 16, 16>(p, out_dtype, st)
                   : tc_out<128, 128, 32, 64>(p, out_dtype, st);
    default:
      return small ? fma_dispatch<16, 64, 16>(p, lhs_dtype, rhs_dtype,
                                              out_dtype, st)
                   : fma_dispatch<128, 128, 8>(p, lhs_dtype, rhs_dtype,
                                               out_dtype, st);
  }
}

// tgmm_body: the body that tgmm runs for these operands and this output
// (dtype, N columns), strides {row, column} in elements: 0 FMA, 1 the
// split body.
extern "C" int tgmm_body(int lhs_dtype, int dy_dtype, int out_dtype, int n,
                         const void* lhs, const long long* lhs_strides,
                         const void* dy, const long long* dy_strides) {
  return tgmm_body_for(lhs_dtype, dy_dtype, out_dtype, n, lhs, lhs_strides,
                       dy, dy_strides);
}
//
// tgmm (K6): lhs [M, K] and dy [M, N] (row strides given, columns
// contiguous), group_sizes [G] int32, out [G, K, N] contiguous.
extern "C" int tgmm(const void* lhs, const void* dy, const void* group_sizes,
                    void* out, int M, int K, int N, int G,
                    long long lhs_row_stride, long long dy_row_stride,
                    int lhs_dtype, int dy_dtype, int out_dtype, void* stream) {
  if (M < 0 || K < 0 || N < 0 || G < 0 || G > kMaxGroups ||
      (K + 127) / 128 > 65535 || !valid_dtype(lhs_dtype) ||
      !valid_dtype(dy_dtype) || !valid_dtype(out_dtype)) {
    return -1;
  }
  if (G == 0 || K == 0 || N == 0) return 0;
  TgmmParams p;
  p.lhs = lhs;
  p.dy = dy;
  p.sizes = static_cast<const int*>(group_sizes);
  p.out = out;
  p.M = M;
  p.K = K;
  p.N = N;
  p.G = G;
  p.l_sm = lhs_row_stride;
  p.d_sm = dy_row_stride;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long ls[2] = {lhs_row_stride, 1}, ds[2] = {dy_row_stride, 1};
  if (tgmm_body_for(lhs_dtype, dy_dtype, out_dtype, N, lhs, ls, dy, ds) ==
      kTgmmSplitBody)
    return out_dtype == kBF16 ? launch_tgmm_split<bf16>(p, st)
                              : launch_tgmm_split<float>(p, st);
  if (lhs_dtype == kF32 && dy_dtype == kF32)
    return tgmm_out<float, float>(p, out_dtype, st);
  if (lhs_dtype == kF32 && dy_dtype == kBF16)
    return tgmm_out<float, bf16>(p, out_dtype, st);
  if (lhs_dtype == kBF16 && dy_dtype == kF32)
    return tgmm_out<bf16, float>(p, out_dtype, st);
  return tgmm_out<bf16, bf16>(p, out_dtype, st);
}
