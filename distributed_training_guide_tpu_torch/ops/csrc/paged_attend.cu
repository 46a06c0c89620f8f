// Paged flash attention over block tables, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel distributed_training_guide_tpu/ops/paged_decode.py:107
// `_attend_kernel` (launched by `paged_flash_attend`): one kernel family for
// every paged forward of the serve plane, at query tile T (decode T = 1,
// chunked prefill T = chunk, speculative verify T = k + 1).
//
// What it computes, per slot s and kv-head h: the query rows
// r = t * groups + g (token t of the slot, query head h * groups + g) sit at
// absolute position lengths[s] + t and attend every key position k_pos of
// the slot's block table with q_pos >= k_pos && q_pos - k_pos < window
// (window = 2**30 means none). Scores are (q . k) * scale, then
// tanh(s / softcap) * softcap when softcap > 0, before the mask. Masked keys
// contribute p = 0. A fully masked row finishes with l = 0 -> safe_l = 1 and
// outputs 0. int8 pages are multiplied by their per-(position, kv-head) fp32
// scale on the way in; no float pool is ever materialised. The output has
// q's dtype.
//
// Design. On the TPU the (slot, kv-head, page) grid runs in order and carries
// m / l / acc across page steps in VMEM. Here blocks run in parallel, so the
// slot's context is cut into splits of a fixed number of pages (the caller's
// plan, `ops/paged_decode.py:_plan`, which depends on neither the batch nor
// the lengths): one block owns one (slot, kv-head, split, tile of folded
// query rows), reads lengths[s] and tables[s, m] itself, walks only the
// split's pages inside its rows' band and leaves its online-softmax state
// (m, l, un-normalised acc, fp32) as a partial. A second launch,
// `paged_attend_combine_kernel`, merges each row's partials in split order
// and writes every output, one split included, so a body has one epilogue.
// Split edges never move and the merge order is fixed, so every output row
// is bitwise the same whatever the batch and the other slots' lengths. The
// combine is a second launch rather than a merge by the last block through
// an ordered ticket: it needs no counter that the kernel must reset, no
// atomics and no spin, and it adds one launch per call from the same host
// call.
//
// Two bodies, chosen by the plan:
// - `paged_attend_split_kernel` (CUDA cores): decode, short verify tiles and
//   every fp32 call. Bound by bytes: the live pages cross HBM once. The row
//   tile is the GQA group (4 rows, or 8), so a decode step launches
//   slots x kv-heads x splits blocks instead of one block per head. A lane
//   holds 8 head-dim elements of a key (16-byte loads of bf16, 8-byte of
//   int8; fp32 takes 4 or 8 elements), D / 8 lanes share a key, and each
//   lane group loads KC keys at a time and the next KC before it uses
//   these, so two steps of pages are in flight per lane. The split's page
//   ids are staged in shared memory and a key's page is a multiply-high,
//   so no load waits on a table read or an integer division. Scores are
//   reduced over the lane group with shuffles; one max update per KC keys.
//   The lane groups and the four warps are merged through registers and
//   shared memory at the end.
// - `paged_attend_mma_kernel` (tensor cores): bf16 q over bf16 or int8
//   pools when T * groups >= 64 (the prefill chunk, a long verify). Bound by
//   operations. A FlashAttention-2 tile of 64 folded rows (one warp per 16
//   rows), all sharing the kv-head, against 32-key tiles gathered key by
//   key through the block table with cp.async into a three-stage
//   shared-memory ring (two tiles in flight; 70 KB at head_dim 128, so
//   three blocks share an SM); q's fragments stay in registers up to
//   head_dim 128. An int8 tile is dequantised in shared memory to bf16 as
//   round_bf16(k * scale), as the plain version does. S = Q K^T and
//   O += P V are mma.sync.m16n8k16 (bf16 in, fp32 accumulate) fed by
//   ldmatrix; S and P never leave registers (the C fragment of S is the A
//   fragment of P V). The softmax is fp32, in two passes over the key
//   tiles: the first (k only, a third of the products) gives each row's
//   max and sum, the second rounds p / sum to bf16 for P V, where the
//   plain version rounds its probabilities, so the two differ by fp32
//   summation order, not by bf16 rounding. Only tiles that cross a row's
//   causal or window edge are masked; pages past the tile's newest row
//   are never loaded. mma.sync and not wgmma: wgmma needs its B tile in the
//   canonical swizzled shared-memory layout, which a key-by-key gather
//   through the block table would have to produce by hand; mma.sync reads
//   any padded layout through ldmatrix. wgmma is later work.
//
// Shapes: head_dim 64, 96, 128 or 256 (96 = 6 x 16 tiles the tensor-core
// body's k steps and its 8-column fragments; the split body puts 16 lanes
// on a key there, 6 elements each), and any page of 1 to 256 positions:
// both bodies walk key positions, not pages, so a page's size enters only
// through page_of and the staged page ids of a split.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF
constexpr int kThreads = 128;      // four warps, every kernel
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPps = 64;        // pages per split, at most
constexpr int kMaxPage = 256;      // positions per page, at most
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };
enum Body { kSplitBody = 0, kMmaBody = 1 };

struct Params {
  const void* q;          // [S, T, Hq, D]
  const void* k;          // [P, page, Hkv, D]
  const void* v;
  const float* k_scale;   // [P, page, Hkv] (int8 pools)
  const float* v_scale;
  const int* tables;      // [S, M]
  const int* lengths;     // [S]
  void* out;              // [S, T, Hq, D], q's dtype
  float* part_m;          // [splits, S, T, Hq]
  float* part_l;          // [splits, S, T, Hq]
  float* part_acc;        // [splits, S, T, Hq, D]
  int S, T, Hq, Hkv, P, page, M, window, pps, splits;
  float scale, softcap;
  unsigned page_magic;    // ceil(2**32 / page): see page_of
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

// the largest power of two, at most 16, that divides n bytes
__host__ __device__ constexpr int vec_align(int n) {
  return n % 16 == 0 ? 16 : n % 8 == 0 ? 8 : n % 4 == 0 ? 4 : n % 2 == 0 ? 2 : 1;
}

// E contiguous elements, loaded as aligned vectors (one of 16 bytes where
// E elements fill it; head_dim 96 gives rows of 6 or 3 elements, loaded
// 2 to 8 bytes at a time)
template <typename T, int E>
struct alignas(vec_align(sizeof(T) * E)) Vec {
  T v[E];
};

template <typename T, int E>
__device__ __forceinline__ Vec<T, E> load_vec(const T* p) {
  return *reinterpret_cast<const Vec<T, E>*>(p);
}

// kpos / page for 0 <= kpos < 2**32 / page (2**24 at page 256, far past
// any slot's capacity): a multiply-high by ceil(2**32 / page) is exact
// there, where an integer division costs ~20 instructions per key. A page
// of one position has no 32-bit magic (page_magic 0): kpos is its page.
__device__ __forceinline__ int page_of(const Params& p, int kpos) {
  return p.page_magic == 0u
             ? kpos
             : static_cast<int>(__umulhi(static_cast<unsigned>(kpos),
                                         p.page_magic));
}

// The pages [lo, hi] of the table that query positions [qmin, qmax] can
// see: from the oldest position's window edge to the newest position.
// lo > hi when there is none. The bodies cut it to their split; the
// combine reads a row's splits by the same rule, so it reads exactly the
// partials that were written.
__device__ __forceinline__ void band_pages(int qmin, int qmax,
                                           const Params& p, int& lo,
                                           int& hi) {
  const int oldest = qmin - p.window + 1;
  lo = oldest <= 0 ? 0 : page_of(p, oldest);
  hi = min(p.M - 1, page_of(p, qmax));
}

// The block's pages [lo, hi] (at most kMaxPps) staged in shared memory
// from tables[s], each entry clamped into the pool; ends with a barrier.
__device__ __forceinline__ void stage_pages(const Params& p, int s, int lo,
                                            int hi, int* s_pid) {
  for (int i = threadIdx.x; i <= hi - lo; i += kThreads)
    s_pid[i] = min(max(p.tables[static_cast<size_t>(s) * p.M + lo + i], 0),
                   p.P - 1);
  __syncthreads();
}

// flat index of key position kpos (on the staged pages from lo) of
// kv-head h in the [P, page, Hkv] vector grid
__device__ __forceinline__ size_t key_vec(const Params& p, const int* s_pid,
                                          int lo, int h, int kpos) {
  const int pg = page_of(p, kpos);
  return (static_cast<size_t>(s_pid[pg - lo]) * p.page + kpos - pg * p.page) *
             p.Hkv + h;
}

__device__ __forceinline__ size_t out_row(const Params& p, int s, int h,
                                          int groups, int row) {
  const int t = row / groups;
  return (static_cast<size_t>(s) * p.T + t) * p.Hq + h * groups +
         row % groups;
}

// ---- the split-context body (CUDA cores)

// three 4-row blocks per SM: a short split's fixed costs (staging its
// pages, the merge) hide behind the other blocks' loads. 8-row blocks hold
// twice the q and acc registers and are left unbounded (bounded to three,
// they spill ~450 bytes a thread).
// Lanes that share a key: D / VE (VE elements of a 16-byte load) where
// that is a power of two, at most 32; 16 at head_dim 96 (6 elements a lane,
// loaded 4 bytes at a time for bf16, 8 for fp32), so the score's shuffle
// reduction and the lane-group merge stay over powers of two. (8 lanes of
// 12 elements spilled 0.8-1.1 KB a thread under the 4-row block's bound.)
template <typename KV, int D>
__host__ __device__ constexpr int lanes_per_key() {
  constexpr int VE = std::is_same<KV, float>::value ? 4 : 8;
  constexpr int n = D / VE;
  return (n & (n - 1)) == 0 ? (n < 32 ? n : 32) : 16;
}

template <typename QT, typename KV, int D, int RT>
__global__ void __launch_bounds__(kThreads, RT <= 4 ? 3 : 1)
paged_attend_split_kernel(const Params p) {
  constexpr int LPK = lanes_per_key<KV, D>();
  static_assert(D % LPK == 0 && 32 % LPK == 0, "lanes must tile a row");
  constexpr int E = D / LPK;                      // elements per lane
  constexpr int KPW = 32 / LPK;                   // keys a warp takes at once
  constexpr int KC = RT <= 4 ? 4 : 2;             // keys per lane group/step
  constexpr int STEP = kWarps * KPW * KC;         // keys per block step
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;

  const int groups = p.Hq / p.Hkv;
  const int R = p.T * groups;
  const int row_tiles = (R + RT - 1) / RT;
  const int tile = blockIdx.x % row_tiles;
  const int sp = blockIdx.x / row_tiles;
  const int h = blockIdx.y;
  const int s = blockIdx.z;
  const int r0 = tile * RT;
  const int r_end = min(r0 + RT, R);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int grp = lane / LPK;
  const int sub = lane % LPK;
  const int len = p.lengths[s];

  int lo, hi;
  band_pages(len + r0 / groups, len + (r_end - 1) / groups, p, lo, hi);
  lo = max(lo, sp * p.pps);
  hi = min(hi, sp * p.pps + p.pps - 1);
  if (lo > hi) return;               // no partial of this split is read
  const int k_begin = lo * p.page;
  const int k_end = (hi + 1) * p.page;
  __shared__ int s_pid[kMaxPps];
  stage_pages(p, s, lo, hi, s_pid);

  const QT* q = static_cast<const QT*>(p.q);
  const KV* kp = static_cast<const KV*>(p.k);
  const KV* vp = static_cast<const KV*>(p.v);

  // this tile's query rows; rows past R get q_pos -1 and never match a key
  float qr[RT][E];
  int qpos[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int row = r0 + r;
    if (row < R) {
      const Vec<QT, E> qv =
          load_vec<QT, E>(q + out_row(p, s, h, groups, row) * D + sub * E);
#pragma unroll
      for (int e = 0; e < E; ++e) qr[r][e] = to_f32(qv.v[e]);
      qpos[r] = len + row / groups;
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) qr[r][e] = 0.f;
      qpos[r] = -1;
    }
  }

  float m_run[RT], l_run[RT], acc[RT][E];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    m_run[r] = kNegInf;
    l_run[r] = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[r][e] = 0.f;
  }

  // this lane group's KC keys from k0; a key past k_end reads the first
  // live key again and is masked
  auto load_keys = [&](int k0, Vec<KV, E>(&kr)[KC], Vec<KV, E>(&vr)[KC],
                       float(&ks)[KC], float(&vs)[KC]) {
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      const size_t vec =
          key_vec(p, s_pid, lo, h, k0 + c < k_end ? k0 + c : k_begin);
      kr[c] = load_vec<KV, E>(kp + vec * D + sub * E);
      vr[c] = load_vec<KV, E>(vp + vec * D + sub * E);
      if constexpr (kQuant) {
        ks[c] = p.k_scale[vec];
        vs[c] = p.v_scale[vec];
      }
    }
  };

  // the loop is uniform across the block: every lane takes part in the
  // shuffles. The next step's keys are loaded before this step's are
  // used, so a lane keeps two steps of pages in flight.
  const int mine = (warp * KPW + grp) * KC;
  Vec<KV, E> kr[KC], vr[KC];
  float ks[KC], vs[KC];
  if (k_begin < k_end) load_keys(k_begin + mine, kr, vr, ks, vs);
  for (int base = k_begin; base < k_end; base += STEP) {
    const int k0 = base + mine;
    Vec<KV, E> nkr[KC], nvr[KC];
    float nks[KC], nvs[KC];
    if (base + STEP < k_end) load_keys(k0 + STEP, nkr, nvr, nks, nvs);
    float x[KC][RT];
    float vf[KC][E];
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      float kf[E];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        kf[e] = to_f32(kr[c].v[e]);
        vf[c][e] = to_f32(vr[c].v[e]);
        if constexpr (kQuant) {
          kf[e] *= ks[c];
          vf[c][e] *= vs[c];
        }
      }
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) part = fmaf(qr[r][e], kf[e], part);
        x[c][r] = part;
      }
    }
#pragma unroll
    for (int off = LPK / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int c = 0; c < KC; ++c)
#pragma unroll
        for (int r = 0; r < RT; ++r)
          x[c][r] += __shfl_xor_sync(kFull, x[c][r], off);
    }
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const int kpos = k0 + c;
        float xs = x[c][r] * p.scale;
        if (p.softcap > 0.f) xs = tanhf(xs / p.softcap) * p.softcap;
        const bool live = kpos < k_end && qpos[r] >= kpos &&
                          qpos[r] - kpos < p.window;
        x[c][r] = live ? xs : kNegInf;
        mx = fmaxf(mx, x[c][r]);
      }
      const float m_new = fmaxf(m_run[r], mx);
      const float alpha = expf(m_run[r] - m_new);
      float pc[KC];
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        pc[c] = x[c][r] == kNegInf ? 0.f : expf(x[c][r] - m_new);
        psum += pc[c];
      }
      l_run[r] = fmaf(l_run[r], alpha, psum);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        float a = acc[r][e] * alpha;
#pragma unroll
        for (int c = 0; c < KC; ++c) a = fmaf(pc[c], vf[c][e], a);
        acc[r][e] = a;
      }
      m_run[r] = m_new;
    }
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      kr[c] = nkr[c];
      vr[c] = nvr[c];
      ks[c] = nks[c];
      vs[c] = nvs[c];
    }
  }

  // merge the lane groups of each warp (same head-dim slice, other keys)
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      const float mo = __shfl_xor_sync(kFull, m_run[r], off);
      const float lo_ = __shfl_xor_sync(kFull, l_run[r], off);
      const float mn = fmaxf(m_run[r], mo);
      const float a = expf(m_run[r] - mn);
      const float b = expf(mo - mn);
      l_run[r] = l_run[r] * a + lo_ * b;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float ao = __shfl_xor_sync(kFull, acc[r][e], off);
        acc[r][e] = acc[r][e] * a + ao * b;
      }
      m_run[r] = mn;
    }
  }

  // then the warps, in order, through shared memory
  __shared__ float sm_m[kWarps][RT];
  __shared__ float sm_l[kWarps][RT];
  __shared__ float sm_acc[kWarps][RT][D];
  if (grp == 0) {
#pragma unroll
    for (int r = 0; r < RT; ++r) {
      if (sub == 0) {
        sm_m[warp][r] = m_run[r];
        sm_l[warp][r] = l_run[r];
      }
#pragma unroll
      for (int e = 0; e < E; ++e) sm_acc[warp][r][sub * E + e] = acc[r][e];
    }
  }
  __syncthreads();
  const size_t rows_all = static_cast<size_t>(p.S) * p.T * p.Hq;
  for (int idx = threadIdx.x; idx < RT * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx % D;
    const int row = r0 + r;
    if (row >= R) continue;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w][r]);
    float l_tot = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float a = expf(sm_m[w][r] - mx);
      l_tot = fmaf(sm_l[w][r], a, l_tot);
      o = fmaf(sm_acc[w][r][d], a, o);
    }
    const size_t prow =
        static_cast<size_t>(sp) * rows_all + out_row(p, s, h, groups, row);
    if (d == 0) {
      p.part_m[prow] = mx;
      p.part_l[prow] = l_tot;
    }
    p.part_acc[prow * D + d] = o;
  }
}

// ---- the tensor-core body (mma.sync, bf16 q)

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared; zero-filled when !pred (src must stay valid)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* ptr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(ptr)));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as bf16x2, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <typename KV, int D>
struct MmaCfg {
  static constexpr int BR = 64;                  // folded query rows
  static constexpr int BK = 32;                  // keys per tile
  static constexpr int LD = D + 8;               // bf16 row stride (smem)
  static constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  static constexpr int LDR = kQuant ? D + 16 : LD;  // raw row stride
  static constexpr int kStages = 3;              // tiles in the ring
  static constexpr bool kQRegs = D <= 128;        // q fragments in registers
  static constexpr size_t q_bytes = size_t(BR) * LD * 2;
  static constexpr size_t raw_bytes = size_t(BK) * LDR * sizeof(KV);
  static constexpr size_t conv_bytes = kQuant ? 2 * size_t(BK) * LD * 2 : 0;
  static constexpr size_t scale_bytes = kQuant ? kStages * 2 * BK * 4 : 0;
  static constexpr size_t smem =
      q_bytes + kStages * 2 * raw_bytes + conv_bytes + scale_bytes;
};

template <typename KV, int D>
__global__ void __launch_bounds__(kThreads)
paged_attend_mma_kernel(const Params p) {
  using C = MmaCfg<KV, D>;
  constexpr int BR = C::BR, BK = C::BK, LD = C::LD, LDR = C::LDR;
  constexpr bool kQuant = C::kQuant;
  constexpr int KV_PER_16B = 16 / sizeof(KV);

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  KV* sRaw = reinterpret_cast<KV*>(smem + C::q_bytes);  // [stage][k|v][BK][LDR]
  bf16* sConv = reinterpret_cast<bf16*>(smem + C::q_bytes +
                                        C::kStages * 2 * C::raw_bytes);
  float* sScale = reinterpret_cast<float*>(
      smem + C::q_bytes + C::kStages * 2 * C::raw_bytes + C::conv_bytes);

  const int groups = p.Hq / p.Hkv;
  const int R = p.T * groups;
  const int row_tiles = (R + BR - 1) / BR;
  const int tile = blockIdx.x % row_tiles;
  const int sp = blockIdx.x / row_tiles;
  const int h = blockIdx.y;
  const int s = blockIdx.z;
  const int r0 = tile * BR;
  const int r_end = min(r0 + BR, R);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int len = p.lengths[s];
  const int qmin = len + r0 / groups;
  const int qmax = len + (r_end - 1) / groups;

  int lo, hi;
  band_pages(qmin, qmax, p, lo, hi);
  lo = max(lo, sp * p.pps);
  hi = min(hi, sp * p.pps + p.pps - 1);
  if (lo > hi) return;               // no partial of this split is read
  const int k_begin = lo * p.page;
  const int k_end = (hi + 1) * p.page;
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;
  __shared__ int s_pid[kMaxPps];
  stage_pages(p, s, lo, hi, s_pid);

  const bf16* q = static_cast<const bf16*>(p.q);
  const KV* kp = static_cast<const KV*>(p.k);
  const KV* vp = static_cast<const KV*>(p.v);

  // the q tile: rows past R are zeros
  constexpr int QCH = D / 8;
  for (int idx = threadIdx.x; idx < BR * QCH; idx += kThreads) {
    const int r = idx / QCH, c = idx % QCH;
    const int row = r0 + r;
    const bf16* src = row < R ? q + out_row(p, s, h, groups, row) * D + c * 8
                              : q;
    cp_async16(sQ + r * LD + c * 8, src, row < R);
  }

  // gather the k (and v) of keys [kb, kb + BK) through the block table
  auto load_tile = [&](int kb, int stage, bool with_v) {
    constexpr int CH = D / KV_PER_16B;
    KV* dk = sRaw + (stage * 2) * BK * LDR;
    KV* dv = dk + BK * LDR;
    for (int idx = threadIdx.x; idx < BK * CH; idx += kThreads) {
      const int j = idx / CH, c = idx % CH;
      const int kpos = kb + j;
      const bool ok = kpos < k_end;
      const size_t vec = key_vec(p, s_pid, lo, h, ok ? kpos : k_begin);
      cp_async16(dk + j * LDR + c * KV_PER_16B, kp + vec * D + c * KV_PER_16B,
                 ok);
      if (with_v)
        cp_async16(dv + j * LDR + c * KV_PER_16B,
                   vp + vec * D + c * KV_PER_16B, ok);
    }
    if constexpr (kQuant) {
      for (int j = threadIdx.x; j < BK; j += kThreads) {
        const int kpos = kb + j;
        const bool ok = kpos < k_end;
        const size_t vec = key_vec(p, s_pid, lo, h, ok ? kpos : k_begin);
        cp_async4(sScale + (stage * 2) * BK + j, p.k_scale + vec, ok);
        if (with_v)
          cp_async4(sScale + (stage * 2 + 1) * BK + j, p.v_scale + vec, ok);
      }
    }
  };

  // this thread's two rows of its warp's 16 (C-fragment layout)
  const int rA = r0 + warp * 16 + lane / 4;
  const int qp[2] = {rA < R ? len + rA / groups : -1,
                     rA + 8 < R ? len + (rA + 8) / groups : -1};
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};
  float m_l2[2], inv_l[2];           // m * log2(e) and 1 / l, for pass 2

  // Two passes over the key tiles: the first (k only) gives each row's max
  // and sum, the second rounds the normalised p / l to bf16 for P V, which
  // is where the plain version rounds it. A single pass would round the
  // un-normalised p and divide after: the same error bound, but a bf16
  // output then lands an ulp away from the plain one wherever the two fp32
  // values straddle a rounding edge, one ulp being 2**-5 from |o| = 4.
  // Step i reads key tile i mod n_tiles (k only while i < n_tiles) from
  // ring stage i mod kStages; the tiles of the next kStages - 1 steps are
  // in flight meanwhile.
  constexpr int NS = C::kStages;
  const int n_iter = 2 * n_tiles;
  auto tile_at = [&](int i) {
    return k_begin + (i >= n_tiles ? i - n_tiles : i) * BK;
  };
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    if (i < n_iter) load_tile(tile_at(i), i, i >= n_tiles);
    cp_async_commit();               // the first group carries q too
  }
  uint32_t qa[C::kQRegs ? D / 16 : 1][4];
  for (int it = 0; it < n_iter; ++it) {
    const bool second = it >= n_tiles;
    const int kb = tile_at(it);
    const int st = it % NS;
    const int ahead = it + NS - 1;
    if (ahead < n_iter) load_tile(tile_at(ahead), ahead % NS, ahead >= n_tiles);
    cp_async_commit();
    cp_async_wait<NS - 1>();
    __syncthreads();
    if constexpr (C::kQRegs) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          ldmatrix_x4(qa[kk], sQ + (warp * 16 + lane % 16) * LD + kk * 16 +
                                  (lane / 16) * 8);
      }
    }
    const bf16* tk;
    const bf16* tv;
    if constexpr (kQuant) {
      // dequantise the stage to bf16: round_bf16(int8 * scale)
      const int8_t* rk = reinterpret_cast<const int8_t*>(sRaw) +
                         (st * 2) * BK * LDR;
      const int n_conv = (second ? 2 : 1) * BK * (D / 8);
      for (int idx = threadIdx.x; idx < n_conv; idx += kThreads) {
        const int kv = idx / (BK * (D / 8));
        const int j = (idx / (D / 8)) % BK;
        const int c = idx % (D / 8);
        const Vec<int8_t, 8> raw =
            load_vec<int8_t, 8>(rk + (kv * BK + j) * LDR + c * 8);
        const float sc = sScale[(st * 2 + kv) * BK + j];
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[e] = pack_bf16(static_cast<float>(raw.v[2 * e]) * sc,
                           static_cast<float>(raw.v[2 * e + 1]) * sc);
        *reinterpret_cast<uint4*>(sConv + (kv * BK + j) * LD + c * 8) =
            make_uint4(w[0], w[1], w[2], w[3]);
      }
      __syncthreads();
      tk = sConv;
      tv = sConv + BK * LD;
    } else {
      tk = reinterpret_cast<const bf16*>(sRaw) + (st * 2) * BK * LDR;
      tv = tk + BK * LDR;
    }

    // S = Q K^T for this warp's 16 rows: 16 x BK in registers
    float sc[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      if constexpr (C::kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qa[kk][e];
      } else {
        ldmatrix_x4(a, sQ + (warp * 16 + lane % 16) * LD + kk * 16 +
                           (lane / 16) * 8);
      }
#pragma unroll
      for (int n2 = 0; n2 < BK / 16; ++n2) {
        uint32_t b[4];
        ldmatrix_x4(b, tk + (n2 * 16 + (lane / 16) * 8 + lane % 8) * LD +
                           kk * 16 + ((lane / 8) % 2) * 8);
        mma_bf16(sc[2 * n2], a, b[0], b[1]);
        mma_bf16(sc[2 * n2 + 1], a, b[2], b[3]);
      }
    }

    // scale, cap and mask in fp32; only tiles across an edge are masked
    const bool need_mask = kb + BK > k_end || kb + BK - 1 > qmin ||
                           kb < qmax - p.window + 1;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[n][e] * p.scale;
        if (p.softcap > 0.f) x = tanhf(x / p.softcap) * p.softcap;
        if (need_mask) {
          const int kpos = kb + n * 8 + (lane % 4) * 2 + (e & 1);
          const int qpos = qp[e / 2];
          const bool live = kpos < k_end && qpos >= kpos &&
                            qpos - kpos < p.window;
          x = live ? x : kNegInf;
        }
        sc[n][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    }

    if (!second) {
      // first pass: the online max and sum (the four lanes of a row hold
      // its columns; their sums are added after the pass)
      float psum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(kFull, mx[i], 2));
        const float m_new = fmaxf(m_r[i], mx[i]);
        l_r[i] *= exp2f((m_r[i] - m_new) * kLog2e);
        m_r[i] = m_new;
        m_l2[i] = m_new * kLog2e;
      }
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = sc[n][e];
          psum[e / 2] +=
              x == kNegInf ? 0.f : exp2f(fmaf(x, kLog2e, -m_l2[e / 2]));
        }
      l_r[0] += psum[0];
      l_r[1] += psum[1];
      if (it + 1 == n_tiles) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          l_r[i] += __shfl_xor_sync(kFull, l_r[i], 1);
          l_r[i] += __shfl_xor_sync(kFull, l_r[i], 2);
          inv_l[i] = l_r[i] > 0.f ? 1.f / l_r[i] : 0.f;
        }
      }
    } else {
      // second pass: O += bf16(p / l) V; the C fragments of S are the A
      // fragments of P
#pragma unroll
      for (int n = 0; n < BK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = sc[n][e];
          sc[n][e] = x == kNegInf ? 0.f
                                  : exp2f(fmaf(x, kLog2e, -m_l2[e / 2])) *
                                        inv_l[e / 2];
        }
#pragma unroll
      for (int kc = 0; kc < BK / 16; ++kc) {
        const uint32_t a[4] = {
            pack_bf16(sc[2 * kc][0], sc[2 * kc][1]),
            pack_bf16(sc[2 * kc][2], sc[2 * kc][3]),
            pack_bf16(sc[2 * kc + 1][0], sc[2 * kc + 1][1]),
            pack_bf16(sc[2 * kc + 1][2], sc[2 * kc + 1][3])};
#pragma unroll
        for (int n2 = 0; n2 < D / 16; ++n2) {
          uint32_t b[4];
          ldmatrix_x4_trans(
              b, tv + (kc * 16 + ((lane / 8) % 2) * 8 + lane % 8) * LD +
                     n2 * 16 + (lane / 16) * 8);
          mma_bf16(o[2 * n2], a, b[0], b[1]);
          mma_bf16(o[2 * n2 + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();                 // the stage is refilled next round
  }
  cp_async_wait<0>();

  // o is normalised; a partial carries the un-normalised acc = o * l
  const size_t rows_all = static_cast<size_t>(p.S) * p.T * p.Hq;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = rA + 8 * i;
    if (row >= R) continue;
    const size_t prow =
        static_cast<size_t>(sp) * rows_all + out_row(p, s, h, groups, row);
    const int col = (lane % 4) * 2;
    if (lane % 4 == 0) {
      p.part_m[prow] = m_r[i];
      p.part_l[prow] = l_r[i];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(p.part_acc + prow * D + n * 8 + col) =
          make_float2(o[n][2 * i] * l_r[i], o[n][2 * i + 1] * l_r[i]);
  }
}

// ---- the combine pass: one warp per output row, partials in split order

template <typename QT, int D>
__global__ void __launch_bounds__(kThreads)
paged_attend_combine_kernel(const Params p) {
  constexpr int E = D / 32;
  const int rows = p.S * p.T * p.Hq;
  const int orow = blockIdx.x * kWarps + threadIdx.x / 32;
  if (orow >= rows) return;          // a whole warp: no shuffle is left out
  const int lane = threadIdx.x % 32;
  const int s = orow / (p.T * p.Hq);
  const int qpos = p.lengths[s] + (orow / p.Hq) % p.T;
  // the splits that hold a key of this row's band (the rest were skipped)
  int lo, hi;
  band_pages(qpos, qpos, p, lo, hi);
  const int sp_lo = lo / p.pps;
  const int sp_hi = lo > hi ? sp_lo - 1 : hi / p.pps;
  // lane i takes splits sp_lo + i, + 32 + i, ...: the max, then each
  // split's weight; acc is summed in split order
  float mx = kNegInf;
  for (int sp = sp_lo + lane; sp <= sp_hi; sp += 32)
    mx = fmaxf(mx, p.part_m[static_cast<size_t>(sp) * rows + orow]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
  float l = 0.f, o[E];
#pragma unroll
  for (int e = 0; e < E; ++e) o[e] = 0.f;
  for (int sp0 = sp_lo; sp0 <= sp_hi; sp0 += 32) {
    const int sp = sp0 + lane;
    float a = 0.f, lw = 0.f;
    if (sp <= sp_hi) {
      const size_t prow = static_cast<size_t>(sp) * rows + orow;
      a = expf(p.part_m[prow] - mx);
      lw = p.part_l[prow] * a;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      lw += __shfl_xor_sync(kFull, lw, off);
    l += lw;
    const int n = min(32, sp_hi - sp0 + 1);
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float aj = __shfl_sync(kFull, a, j);
      const Vec<float, E> acc = load_vec<float, E>(
          p.part_acc + (static_cast<size_t>(sp0 + j) * rows + orow) * D +
          lane * E);
#pragma unroll
      for (int e = 0; e < E; ++e) o[e] = fmaf(acc.v[e], aj, o[e]);
    }
  }
  const float safe_l = l == 0.f ? 1.f : l;
  QT* out = static_cast<QT*>(p.out) + static_cast<size_t>(orow) * D + lane * E;
#pragma unroll
  for (int e = 0; e < E; ++e) out[e] = from_f32<QT>(o[e] / safe_l);
}

// ---- launches

dim3 body_grid(const Params& p, int rows) {
  const int row_tiles = (p.T * (p.Hq / p.Hkv) + rows - 1) / rows;
  return dim3(row_tiles * p.splits, p.Hkv, p.S);
}

template <typename QT, typename KV, int D>
int launch_split(const Params& p, int rows, cudaStream_t st) {
  if (rows == 4) {
    paged_attend_split_kernel<QT, KV, D, 4>
        <<<body_grid(p, 4), kThreads, 0, st>>>(p);
  } else if (rows == 8) {
    paged_attend_split_kernel<QT, KV, D, 8>
        <<<body_grid(p, 8), kThreads, 0, st>>>(p);
  } else {
    return -1;
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename KV, int D>
int launch_mma(const Params& p, cudaStream_t st) {
  constexpr size_t smem = MmaCfg<KV, D>::smem;
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_attend_mma_kernel<KV, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  paged_attend_mma_kernel<KV, D>
      <<<body_grid(p, MmaCfg<KV, D>::BR), kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, int D>
int launch_combine(const Params& p, cudaStream_t st) {
  const int rows = p.S * p.T * p.Hq;
  paged_attend_combine_kernel<QT, D>
      <<<(rows + kWarps - 1) / kWarps, kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KV>
int launch_body_kv(const Params& p, int body, int rows, int D,
                   cudaStream_t st) {
  if (body == kSplitBody) {
    switch (D) {
      case 64: return launch_split<QT, KV, 64>(p, rows, st);
      case 96: return launch_split<QT, KV, 96>(p, rows, st);
      case 128: return launch_split<QT, KV, 128>(p, rows, st);
      case 256: return launch_split<QT, KV, 256>(p, rows, st);
      default: return -1;
    }
  }
  if constexpr (std::is_same<QT, bf16>::value &&
                !std::is_same<KV, float>::value) {
    if (body == kMmaBody && rows == MmaCfg<KV, 64>::BR) {
      switch (D) {
        case 64: return launch_mma<KV, 64>(p, st);
        case 96: return launch_mma<KV, 96>(p, st);
        case 128: return launch_mma<KV, 128>(p, st);
        case 256: return launch_mma<KV, 256>(p, st);
        default: return -1;
      }
    }
  }
  return -1;
}

template <typename QT>
int launch_body(const Params& p, int kv_dtype, int body, int rows, int D,
                cudaStream_t st) {
  switch (kv_dtype) {
    case kF32: return launch_body_kv<QT, float>(p, body, rows, D, st);
    case kBF16: return launch_body_kv<QT, bf16>(p, body, rows, D, st);
    case kI8: return launch_body_kv<QT, int8_t>(p, body, rows, D, st);
    default: return -1;
  }
}

int combine(const Params& p, int q_dtype, int D, cudaStream_t st) {
  switch (q_dtype * 1000 + D) {
    case kF32 * 1000 + 64: return launch_combine<float, 64>(p, st);
    case kF32 * 1000 + 96: return launch_combine<float, 96>(p, st);
    case kF32 * 1000 + 128: return launch_combine<float, 128>(p, st);
    case kF32 * 1000 + 256: return launch_combine<float, 256>(p, st);
    case kBF16 * 1000 + 64: return launch_combine<bf16, 64>(p, st);
    case kBF16 * 1000 + 96: return launch_combine<bf16, 96>(p, st);
    case kBF16 * 1000 + 128: return launch_combine<bf16, 128>(p, st);
    case kBF16 * 1000 + 256: return launch_combine<bf16, 256>(p, st);
    default: return -1;
  }
}

// ceil(2**32 / page); 0 for a page of one position (page_of's case)
unsigned page_magic(int page) {
  return page == 1 ? 0u
                   : static_cast<unsigned>(((1ull << 32) + page - 1) / page);
}

bool shape_ok(int S, int T, int Hq, int Hkv, int D, int P, int page, int M,
              int window, int pps, int splits) {
  return S >= 0 && T >= 0 && Hkv >= 1 && Hq % Hkv == 0 && P >= 1 && M >= 1 &&
         page >= 1 && page <= kMaxPage && window >= 1 &&
         (D == 64 || D == 96 || D == 128 || D == 256) && pps >= 1 &&
         pps <= kMaxPps &&
         splits == (M + pps - 1) / pps;
}

}  // namespace

// Plain C entry points for ctypes. Pools are [P, page, Hkv, D], scales
// [P, page, Hkv] fp32 (int8 pools only, else null), q / out [S, T, Hq, D],
// tables [S, M] int32, lengths [S] int32, partials m / l [splits, S, T, Hq]
// and acc [splits, S, T, Hq, D] fp32, all contiguous on the device. The
// caller's plan names the body (0 split-context, 1 tensor-core), its rows
// per block, the pages per split and the splits (ceil(M / pps)). The body
// writes partials and, with `do_combine`, the combine pass then writes out.
// Returns 0, the cudaError_t of a launch, or -1 for a shape, dtype or plan
// the kernels do not take.
extern "C" int paged_attend(const void* q, const void* k_pages,
                            const void* v_pages, const void* k_scale,
                            const void* v_scale, const void* tables,
                            const void* lengths, void* out, void* part_m,
                            void* part_l, void* part_acc, int S, int T,
                            int Hq, int Hkv, int D, int P, int page, int M,
                            int q_dtype, int kv_dtype, int window, int body,
                            int rows, int pps, int splits, int do_combine,
                            float scale, float softcap, void* stream) {
  if (!shape_ok(S, T, Hq, Hkv, D, P, page, M, window, pps, splits)) return -1;
  if ((kv_dtype == kI8) != (k_scale != nullptr && v_scale != nullptr)) {
    return -1;
  }
  if (!part_m || !part_l || !part_acc || (do_combine && !out)) return -1;
  if (S == 0 || T == 0) return 0;
  const Params p{q, k_pages, v_pages,
                 static_cast<const float*>(k_scale),
                 static_cast<const float*>(v_scale),
                 static_cast<const int*>(tables),
                 static_cast<const int*>(lengths), out,
                 static_cast<float*>(part_m), static_cast<float*>(part_l),
                 static_cast<float*>(part_acc), S, T, Hq, Hkv, P, page, M,
                 window, pps, splits, scale, softcap, page_magic(page)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  switch (q_dtype) {
    case kF32: rc = launch_body<float>(p, kv_dtype, body, rows, D, st); break;
    case kBF16: rc = launch_body<bf16>(p, kv_dtype, body, rows, D, st); break;
    default: return -1;
  }
  if (rc != 0 || !do_combine) return rc;
  return combine(p, q_dtype, D, st);
}

// The combine pass alone, over partials laid out as above: out [S, T, Hq, D]
// in fp32. Reads only the splits that hold a key of each row's band, as the
// bodies write only those.
extern "C" int paged_attend_combine(const void* part_m, const void* part_l,
                                    const void* part_acc,
                                    const void* lengths, void* out, int S,
                                    int T, int Hq, int D, int page, int M,
                                    int window, int pps, int splits,
                                    void* stream) {
  if (!shape_ok(S, T, Hq, 1, D, 1, page, M, window, pps, splits)) return -1;
  if (S == 0 || T == 0) return 0;
  Params p{};
  p.lengths = static_cast<const int*>(lengths);
  p.out = out;
  p.part_m = static_cast<float*>(const_cast<void*>(part_m));
  p.part_l = static_cast<float*>(const_cast<void*>(part_l));
  p.part_acc = static_cast<float*>(const_cast<void*>(part_acc));
  p.S = S;
  p.T = T;
  p.Hq = Hq;
  p.Hkv = 1;
  p.page = page;
  p.M = M;
  p.window = window;
  p.pps = pps;
  p.splits = splits;
  p.page_magic = page_magic(page);
  return combine(p, kF32, D, static_cast<cudaStream_t>(stream));
}
