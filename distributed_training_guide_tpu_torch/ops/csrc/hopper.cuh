// Hopper (sm_90a) building blocks shared by the flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu), the grouped matmul (grouped_matmul.cu) and
// the block-dequant matmul (quantized_matmul.cu):
// mbarrier rings, TMA tile copies, wgmma on 128-byte swizzled tiles, and
// the host side of tensor maps.
//
// - Barriers: `mbar_*` over 64-bit mbarriers in shared memory; `mbar_wait`
//   spins on a phase's parity and traps after 10 s, so that a barrier that
//   never completes ends the kernel with "illegal instruction" instead of
//   hanging the card.
// - Copies: `tma_load_{2,3,4}d` issue one TMA tile copy that completes on
//   a barrier's transaction count; `tma_store_3d` copies a tile out,
//   tracked by bulk groups.
// - Products: `wgmma_ss` (A, B both K-major in shared memory), `wgmma_ss_n`
//   (B N-major), `wgmma_rs` (A from registers, B N-major), m64n64k16 bf16
//   in, `wgmma_ss_n256` (m64n256k16, B N-major), `wgmma_rs_k` (A from
//   registers, B K-major, m64nNk16 for N = 8 to 128) and `wgmma_rs_n` (A
//   from registers, B N-major, m64n128k16), fp32 accumulators in
//   registers, with `wg_fence` / `wg_commit` /
//   `wg_wait0` / `wg_wait1` around them and `fence_regs` to pin the
//   accumulators across an asynchronous batch. An m64nNk16 accumulator of
//   16 columns is the A fragment of the next product's k step: `pack_bf16`
//   rounds a pair into one register of it, `split_bf16` splits an fp32 pair
//   into a hi and a lo register (two products stand for one fp32 operand).
//   `sw128` addresses an element of a swizzled tile; `stmatrix_x4_trans`
//   stores four 8 x 8 bf16 accumulator blocks transposed.
// - Attention tiles: `scores` (S = A B^T over D for two 64-row tiles),
//   `rs_product` (acc += A B, A from registers: P V, dS K), `pair_live` /
//   `block_live` (the band), `ex2`, `store_tile` (an fp32 accumulator out
//   through a dead operand tile and 16-byte stores).
// - Host: `encode_tiled` looks cuTensorMapEncodeTiled up in the driver the
//   process already runs on (dlopen, no link flag), `map_tiled` encodes a
//   tensor map (`map_bf16`, `map_i8`, `map_f32`, `map_bshd` for the
//   128-byte swizzle), `launch_hopper` launches a producer /
//   consumer block after checking that its registers at launch cover what
//   `setmaxnreg` hands out.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the driver call is looked up
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kProducerRegs = 24;
constexpr float kLog2e = 1.4426950408889634f;

// A block is one consumer warpgroup of 64 rows and one producer
// warpgroup, two blocks per SM: 128 registers a thread at launch, then 24
// for the producer and 232 for the consumer (24 + 232 = 2 x 128). Two
// blocks interleave their wgmma batches and p / ds passes; two consumer
// warpgroups of one block run in step and leave the tensor cores idle in
// each other's p / ds pass.
constexpr int kThreadsTma = 256;
constexpr int kConsumerRegs = 232;

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t start = 0;
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = global_ns();
    } else if (global_ns() - start > 10000000000ull) {
      __trap();
    }
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// Matrix descriptor of a tile in the 128-byte swizzle that TMA writes: rows
// of 128 bytes, 8-row atoms of 1024 bytes. Read K-major (k step = 32 bytes
// along a row) the leading offset is unused; read N-major (k step = 16
// rows) with n = 64 one swizzle atom spans N, so only the stride between
// 8-row groups is read. Both offsets are 1024 bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// The descriptor of an N-major operand of several 64-column parts in that
// swizzle, `part` bytes apart (the leading offset; 8-row groups 1024 bytes
// apart, as in sw128_desc)
__device__ __forceinline__ uint64_t sw128_desc_parts(uint32_t addr,
                                                     uint32_t part) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(part >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// every batch but the last one committed is done
__device__ __forceinline__ void wg_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}

// Keep the compiler from moving accumulator reads or writes across an
// asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (+)= A B^T over one k step of 16, A [64 x 16] and B [64 x 16] both
// K-major in shared memory. Accumulator of thread t of the warpgroup (warp
// w, lane l): d[4 j + 2 i + e] is row 16 w + l / 4 + 8 i, column
// 8 j + 2 (l % 4) + e.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B over one k step of 16: A [64 x 16] bf16 from registers (a[0]:
// row 16 w + l / 4, columns 2 (l % 4) + {0, 1}; a[1]: row + 8; a[2], a[3]:
// the same at columns + 8), B [16 x 64] N-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// d += A B over one k step of 16, A [64 x 16] K-major and B [16 x 64]
// N-major, both in shared memory (a row-major [K, N] operand, read as the
// N-major B of wgmma_rs)
__device__ __forceinline__ void wgmma_ss_n(float (&d)[32], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// d += A B over one k step of 16, A [64 x 16] K-major and B [16 x 256]
// N-major, both in shared memory: d[hf] holds columns 64 hf .. 64 hf + 63
// in wgmma_ss's layout. B's descriptor (`sw128_desc_parts`) spans its four
// 64-column parts.
__device__ __forceinline__ void wgmma_ss_n256(float (&d)[4][32], uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[0][4]), "+f"(d[0][5]), "+f"(d[0][6]), "+f"(d[0][7]),
        "+f"(d[0][8]), "+f"(d[0][9]), "+f"(d[0][10]), "+f"(d[0][11]),
        "+f"(d[0][12]), "+f"(d[0][13]), "+f"(d[0][14]), "+f"(d[0][15]),
        "+f"(d[0][16]), "+f"(d[0][17]), "+f"(d[0][18]), "+f"(d[0][19]),
        "+f"(d[0][20]), "+f"(d[0][21]), "+f"(d[0][22]), "+f"(d[0][23]),
        "+f"(d[0][24]), "+f"(d[0][25]), "+f"(d[0][26]), "+f"(d[0][27]),
        "+f"(d[0][28]), "+f"(d[0][29]), "+f"(d[0][30]), "+f"(d[0][31]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[1][4]), "+f"(d[1][5]), "+f"(d[1][6]), "+f"(d[1][7]),
        "+f"(d[1][8]), "+f"(d[1][9]), "+f"(d[1][10]), "+f"(d[1][11]),
        "+f"(d[1][12]), "+f"(d[1][13]), "+f"(d[1][14]), "+f"(d[1][15]),
        "+f"(d[1][16]), "+f"(d[1][17]), "+f"(d[1][18]), "+f"(d[1][19]),
        "+f"(d[1][20]), "+f"(d[1][21]), "+f"(d[1][22]), "+f"(d[1][23]),
        "+f"(d[1][24]), "+f"(d[1][25]), "+f"(d[1][26]), "+f"(d[1][27]),
        "+f"(d[1][28]), "+f"(d[1][29]), "+f"(d[1][30]), "+f"(d[1][31]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[2][4]), "+f"(d[2][5]), "+f"(d[2][6]), "+f"(d[2][7]),
        "+f"(d[2][8]), "+f"(d[2][9]), "+f"(d[2][10]), "+f"(d[2][11]),
        "+f"(d[2][12]), "+f"(d[2][13]), "+f"(d[2][14]), "+f"(d[2][15]),
        "+f"(d[2][16]), "+f"(d[2][17]), "+f"(d[2][18]), "+f"(d[2][19]),
        "+f"(d[2][20]), "+f"(d[2][21]), "+f"(d[2][22]), "+f"(d[2][23]),
        "+f"(d[2][24]), "+f"(d[2][25]), "+f"(d[2][26]), "+f"(d[2][27]),
        "+f"(d[2][28]), "+f"(d[2][29]), "+f"(d[2][30]), "+f"(d[2][31]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[3][4]), "+f"(d[3][5]), "+f"(d[3][6]), "+f"(d[3][7]),
        "+f"(d[3][8]), "+f"(d[3][9]), "+f"(d[3][10]), "+f"(d[3][11]),
        "+f"(d[3][12]), "+f"(d[3][13]), "+f"(d[3][14]), "+f"(d[3][15]),
        "+f"(d[3][16]), "+f"(d[3][17]), "+f"(d[3][18]), "+f"(d[3][19]),
        "+f"(d[3][20]), "+f"(d[3][21]), "+f"(d[3][22]), "+f"(d[3][23]),
        "+f"(d[3][24]), "+f"(d[3][25]), "+f"(d[3][26]), "+f"(d[3][27]),
        "+f"(d[3][28]), "+f"(d[3][29]), "+f"(d[3][30]), "+f"(d[3][31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// d += A B over one k step of 16: A [64 x 16] bf16 from registers (as in
// wgmma_rs), B [16 x N] K-major in shared memory (N rows of 128-byte
// swizzled k, `sw128_desc`), N = 8, 16, 32, 64 or 128 picked by the size
// of d (N / 2 accumulators a thread, d[4 j + 2 i + e]: row 16 w + l / 4
// + 8 i, column 8 j + 2 (l % 4) + e); d = A B when `accumulate` is 0. The
// tensor cores' fp32 sum over k steps truncates (one accumulator over K
// 8192 drifts ~1e-5 toward zero: `chip_smoke.py:tc_sum_drift`), so where
// fp32 accuracy is the point the caller sums a few k steps at a time and
// adds each piece to an fp32 register sum, rounded to nearest. A's
// registers are read
// asynchronously: they must hold until a wait covers the product
// (`fence_regs` on them after it keeps the compiler from reusing them).
__device__ __forceinline__ void wgmma_rs_k(float (&d)[4], uint32_t a0,
                                           uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_k(float (&d)[8], uint32_t a0,
                                           uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_k(float (&d)[16], uint32_t a0,
                                           uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_k(float (&d)[32], uint32_t a0,
                                           uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate));
}

// m64n128k16 with A from registers, B K-major (TRANS_B 0: wgmma_rs_k) or
// N-major (1: wgmma_rs_n); d = A B when `accumulate` is 0
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs_128(float (&d)[64], uint32_t a0,
                                             uint32_t a1, uint32_t a2,
                                             uint32_t a3, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(accumulate),
        "n"(TRANS_B));
}

__device__ __forceinline__ void wgmma_rs_k(float (&d)[64], uint32_t a0,
                                           uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint64_t db,
                                           int accumulate) {
  wgmma_rs_128<0>(d, a0, a1, a2, a3, db, accumulate);
}

// d (+)= A B over one k step of 16: A [64 x 16] bf16 from registers (as in
// wgmma_rs), B [16 x 128] N-major in shared memory: two [16 x 64] parts of
// the 128-byte swizzle, `sw128_desc_parts(addr, part bytes)`; d[4 j + 2 i +
// e]: row 16 w + l / 4 + 8 i, column 8 j + 2 (l % 4) + e. As wgmma_rs_k:
// d = A B when `accumulate` is 0, and A's registers are read
// asynchronously.
__device__ __forceinline__ void wgmma_rs_n(float (&d)[64], uint32_t a0,
                                           uint32_t a1, uint32_t a2,
                                           uint32_t a3, uint64_t db,
                                           int accumulate) {
  wgmma_rs_128<1>(d, a0, a1, a2, a3, db, accumulate);
}

// An fp32 pair split into two bf16 pairs, hi = bf16(x) and lo = bf16(x -
// hi), packed as A-fragment registers (the first value in the low half).
// x - hi is exact in fp32, and hi + lo misses x by at most 2**-16 |x| (each
// part keeps 8 significant bits; about 2**-18 |x| typically): two products
// on the tensor cores, summed in fp32, stand for one fp32 product to about
// that, not exactly.
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  lo = pack_bf16(x0 - __uint_as_float(hi << 16),
                 x1 - __uint_as_float(hi & 0xffff0000u));
}

// Four 8 x 8 bf16 matrices out of registers into shared memory,
// transposed: r[t] holds matrix t as an m16n8 accumulator pair holds it
// (row l / 4, columns 2 (l % 4) + {0, 1}, packed by `pack_bf16`), and lane
// 8 t + c gives the address of the 16 bytes that receive column c of
// matrix t (its 8 rows).
__device__ __forceinline__ void stmatrix_x4_trans(uint32_t addr, uint32_t r0,
                                                  uint32_t r1, uint32_t r2,
                                                  uint32_t r3) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, "
      "%4};" ::"r"(addr),
      "r"(r0), "r"(r1), "r"(r2), "r"(r3)
      : "memory");
}

// One TMA tile store from shared memory (tracked by the issuing thread's
// bulk groups: `bulk_commit`, then `bulk_wait_read` before the tile's
// shared memory is written again, `bulk_wait` for the writes themselves)
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Byte offset of (row, byte column) in a tile of 128-byte rows in the
// 128-byte swizzle that TMA writes (the tile 1024-byte aligned).
__device__ __forceinline__ uint32_t sw128(int row, int col) {
  return row * 128 + ((((col >> 4) ^ row) & 7) << 4) + (col & 15);
}

// s = A B^T over D for two 64-row tiles A and B (Q K^T, or K Q^T in K3):
// D 128 keeps columns 64..127 in a second 64-row half 8 KB on
template <int D>
__device__ __forceinline__ void scores(float (&s)[32], uint32_t a,
                                       uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss(s, sw128_desc(a + (kk / 4) * 64 * 128 + (kk % 4) * 32),
             sw128_desc(b + (kk / 4) * 64 * 128 + (kk % 4) * 32), kk > 0);
}

// acc += A B over one 64-row tile of B (K2: dq += dS K; K1: o += P V): A
// [64 x 64] bf16 from registers (a[4 kk .. 4 kk + 3]: k step kk, as
// wgmma_rs takes it), B [64 x D] read N-major from its swizzled tile
template <int D>
__device__ __forceinline__ void rs_product(float (&acc)[D / 64][32],
                                           const uint32_t (&a)[16],
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int nh = 0; nh < D / 64; ++nh)
      wgmma_rs(acc[nh], a[4 * kk], a[4 * kk + 1], a[4 * kk + 2],
               a[4 * kk + 3], sw128_desc(b + nh * 64 * 128 + kk * 2048));
}

// the pair (query row, key column) is live (P as for block_live)
template <typename P>
__device__ __forceinline__ bool pair_live(const P& p, int row, int col) {
  const int qpos = row + p.q_off;
  const int kpos = col + p.k_off;
  return row < p.Sq && col < p.Sk &&
         (!p.causal || (qpos >= kpos && qpos - kpos < p.window));
}

// every pair of rows [r0, r1] x columns [c0, c1] is live (P: the kernel's
// parameters, with Sq, Sk and the band)
template <typename P>
__device__ __forceinline__ bool block_live(const P& p, int r0, int r1, int c0,
                                           int c1) {
  if (r1 >= p.Sq || c1 >= p.Sk) return false;
  if (!p.causal) return true;
  const long long lo = static_cast<long long>(r0) + p.q_off - c1 - p.k_off;
  const long long hi = static_cast<long long>(r1) + p.q_off - c0 - p.k_off;
  return lo >= 0 && hi < p.window;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The warpgroup's 64 x D fp32 accumulator, rounded to bf16, into the
// 64-row swizzled tile it read an operand from (dead by now), then out to
// `dst` rows [B, S, H, D] with 16-byte stores, rows from `valid` on dropped
template <int D>
__device__ __forceinline__ void store_tile(float (&acc)[D / 64][32],
                                           unsigned char* tile, bf16* dst,
                                           long long row_stride, int valid) {
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
#pragma unroll
  for (int nh = 0; nh < D / 64; ++nh)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 16 * warp + lane / 4 + 8 * i;
        *reinterpret_cast<uint32_t*>(tile + nh * 64 * 128 + r * 128 +
                                     ((j ^ (r % 8)) * 16) + (lane % 4) * 4) =
            pack_bf16(acc[nh][4 * j + 2 * i], acc[nh][4 * j + 2 * i + 1]);
      }
  asm volatile("bar.sync 1, 128;" ::: "memory");  // the consumers only
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  for (int idx = tid; idx < 64 * kChunks; idx += 128) {
    const int r = idx / kChunks;
    const int c = idx % kChunks;
    if (r >= valid) break;
    const uint4 val = *reinterpret_cast<const uint4*>(
        tile + (c / 8) * 64 * 128 + r * 128 + (((c % 8) ^ (r % 8)) * 16));
    *reinterpret_cast<uint4*>(dst + r * row_stride + c * 8) = val;
  }
}

// the base of a tensor that a tensor map can read
inline bool on16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

template <typename K, typename A>
int launch_kernel(K kernel, int smem, dim3 grid, int threads, const A& args,
                  cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, stream>>>(args);
  return static_cast<int>(cudaGetLastError());
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver that the process already runs on
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(
                                dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// A tensor of `rank` dimensions (innermost first, that one contiguous) of
// `bytes`-byte elements of type `type`, strides of the others in elements,
// boxes `box`, the given swizzle, reads past an edge as 0
bool map_tiled(CUtensorMap* map, CUtensorMapDataType type, int bytes,
               const void* ptr, int rank, const long long* dims,
               const long long* strides, const int* box,
               CUtensorMapSwizzle swizzle) {
  cuuint64_t d[5], s[4];
  cuuint32_t bx[5], one[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = static_cast<cuuint64_t>(dims[i]);
    bx[i] = static_cast<cuuint32_t>(box[i]);
    one[i] = 1;
    if (i > 0) s[i - 1] = static_cast<cuuint64_t>(strides[i - 1]) * bytes;
  }
  return encode_tiled()(map, type, rank, const_cast<void*>(ptr), d, s, bx,
                        one, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// bf16, int8 and fp32 tensors in the 128-byte swizzle (a box's innermost
// extent at most 128 bytes)
bool map_bf16(CUtensorMap* map, const void* ptr, int rank,
              const long long* dims, const long long* strides,
              const int* box) {
  return map_tiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, rank, dims,
                   strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}
bool map_i8(CUtensorMap* map, const void* ptr, int rank, const long long* dims,
            const long long* strides, const int* box) {
  return map_tiled(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, ptr, rank, dims,
                   strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}
bool map_f32(CUtensorMap* map, const void* ptr, int rank, const long long* dims,
             const long long* strides, const int* box) {
  return map_tiled(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ptr, rank, dims,
                   strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// bf16 [B, S, H, D] through element strides (sb, ss, sh), boxes of 64
// columns x 64 rows of one head, 128-byte swizzle, rows past S read as 0
bool map_bshd(CUtensorMap* map, const void* ptr, int B, int S, int H, int D,
              long long sb, long long ss, long long sh) {
  const long long dims[4] = {D, H, S, B}, strides[3] = {sh, ss, sb};
  const int box[4] = {64, 1, 64, 1};
  return map_bf16(map, ptr, 4, dims, strides, box);
}

constexpr int kNoTensorMap = -2;     // the driver refused a tensor map
constexpr int kFewRegisters = -3;    // setmaxnreg would wait forever

// CONSUMER_REGS: what the kernel's consumer warpgroup asks `setmaxnreg` for
template <int CONSUMER_REGS = kConsumerRegs, typename K, typename A>
int launch_hopper(K kernel, int smem, dim3 grid, const A& args,
                  cudaStream_t stream) {
  // the block's registers at launch must cover what setmaxnreg hands out
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (attr.numRegs * kThreadsTma < (kProducerRegs + CONSUMER_REGS) * 128)
    return kFewRegisters;
  return launch_kernel(kernel, smem, grid, kThreadsTma, args, stream);
}

}  // namespace
