// Paged flash attention over block tables, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel distributed_training_guide_tpu/ops/paged_decode.py
// `_attend_kernel` (launched by `paged_flash_attend`): one kernel for every
// paged forward of the serve plane, at query tile T (decode T = 1, chunked
// prefill T = chunk, speculative verify T = k + 1).
//
// What it computes, per slot s and kv-head h: the query rows
// r = t * groups + g (token t of the slot, query head h * groups + g) sit at
// absolute position lengths[s] + t and attend every key position k_pos of
// the slot's block table with q_pos >= k_pos && q_pos - k_pos < window
// (window = 2**30 means none). Scores are (q . k) * scale, then
// tanh(s / softcap) * softcap when softcap > 0, before the mask. Masked keys
// contribute p = 0. A fully masked row finishes with l = 0 -> safe_l = 1 and
// outputs 0. int8 pages are multiplied by their per-(position, kv-head) fp32
// scale inside the loop; no float pool is ever materialised. The output has
// q's dtype.
//
// Design. On the TPU the (slot, kv-head, page) grid runs in order and carries
// m / l / acc across page steps in VMEM. Here blocks run in parallel, so each
// block owns one (slot, kv-head, tile of RT query rows), reads lengths[s] and
// tables[s, m] itself and walks the slot's live pages: warp w takes pages
// m_lo + w, m_lo + w + WARPS, ... and keeps its own online-softmax state
// (m, l, acc in fp32 registers) for all RT rows. Lane i holds head-dim
// elements [i * D/32, (i + 1) * D/32) of each query row and of each key and
// value it loads, so a score is a per-lane partial dot followed by a warp
// butterfly sum. At the end the WARPS partial states are merged through
// shared memory, the same rescale the online softmax does between pages.
// Only pages inside some row's band are visited: the loop runs from the
// oldest row's window edge to the newest row's position, so a decode step
// reads O(live context), not O(max_len).
//
// Bound on H100: the bytes of the live pages read from HBM (plus q and out)
// at 3.35 TB/s for decode; for a long prefill chunk the QK and PV products,
// which this simple kernel does on the CUDA cores rather than with wgmma.
// Loads are D/32 contiguous elements per lane (8 to 32 bytes), KC keys of K
// and V are requested before any is used to keep loads in flight, and every
// block is independent, so no atomics and no second pass are needed.
// wgmma, TMA and a split over pages across blocks for long contexts are
// left for later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's NEG_INF
constexpr int kWarps = 8;          // warps per block, each a stride of pages
constexpr unsigned kFull = 0xffffffffu;

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// E contiguous elements, loaded as one aligned vector.
template <typename T, int E>
struct alignas(sizeof(T) * E) Vec {
  T v[E];
};

template <typename T, int E>
__device__ __forceinline__ Vec<T, E> load_vec(const T* p) {
  return *reinterpret_cast<const Vec<T, E>*>(p);
}

template <typename QT, typename KV, int D, int RT>
__global__ void __launch_bounds__(kWarps * 32)
paged_attend_kernel(const QT* __restrict__ q, const KV* __restrict__ k_pages,
                    const KV* __restrict__ v_pages,
                    const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ tables,
                    const int* __restrict__ lengths, QT* __restrict__ out,
                    int T, int Hq, int Hkv, int P, int page, int M, int window,
                    float scale, float softcap) {
  constexpr int E = D / 32;             // head-dim elements per lane
  constexpr int KC = E <= 4 ? 8 : 4;    // keys loaded ahead per step
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;

  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int r0 = blockIdx.z * RT;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int groups = Hq / Hkv;
  const int R = T * groups;
  const int len = lengths[s];

  // this tile's query rows; rows past R get q_pos -1 and never match a key
  float qr[RT][E];
  int qpos[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int row = r0 + r;
    if (row < R) {
      const int t = row / groups;
      const int head = h * groups + row % groups;
      const Vec<QT, E> qv = load_vec<QT, E>(
          q + ((static_cast<size_t>(s) * T + t) * Hq + head) * D + lane * E);
#pragma unroll
      for (int e = 0; e < E; ++e) qr[r][e] = to_f32(qv.v[e]);
      qpos[r] = len + t;
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

  // pages inside some row's band: from the oldest row's window edge to the
  // newest row's own position (a page outside every band is skipped)
  const int q_min = len + r0 / groups;
  const int q_max = len + (min(r0 + RT, R) - 1) / groups;
  const int m_hi = min(M - 1, q_max / page);
  const int oldest_key = q_min - window + 1;
  const int m_lo = oldest_key <= 0 ? 0 : oldest_key / page;

  for (int mi = m_lo + warp; mi <= m_hi; mi += kWarps) {
    // entries past a slot's pages are 0 (the trash page); clamp so that no
    // table entry can send the loads past the pool
    const int pid = min(max(tables[static_cast<size_t>(s) * M + mi], 0),
                        P - 1);
    // flat index of (pid, 0, h) in the [P, page, Hkv] vector grid
    const size_t base = static_cast<size_t>(pid) * page * Hkv + h;
    for (int j0 = 0; j0 < page; j0 += KC) {
      Vec<KV, E> kr[KC], vr[KC];
      float ks[KC], vs[KC];
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const size_t vec = base + static_cast<size_t>(j0 + c) * Hkv;
        kr[c] = load_vec<KV, E>(k_pages + vec * D + lane * E);
        vr[c] = load_vec<KV, E>(v_pages + vec * D + lane * E);
        if constexpr (kQuant) {
          ks[c] = k_scale[vec];
          vs[c] = v_scale[vec];
        }
      }
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        float kf[E], vf[E];
#pragma unroll
        for (int e = 0; e < E; ++e) {
          kf[e] = to_f32(kr[c].v[e]);
          vf[e] = to_f32(vr[c].v[e]);
          if constexpr (kQuant) {
            kf[e] *= ks[c];
            vf[e] *= vs[c];
          }
        }
        float sc[RT];
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < E; ++e) part = fmaf(qr[r][e], kf[e], part);
          sc[r] = part;
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
          for (int r = 0; r < RT; ++r) sc[r] += __shfl_xor_sync(kFull, sc[r], off);
        }
        const int kpos = mi * page + j0 + c;
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          float x = sc[r] * scale;
          if (softcap > 0.f) x = tanhf(x / softcap) * softcap;
          // warp-uniform: every lane holds the same score and positions
          if (qpos[r] >= kpos && qpos[r] - kpos < window) {
            const float m_new = fmaxf(m_run[r], x);
            const float alpha = expf(m_run[r] - m_new);
            const float p = expf(x - m_new);
            l_run[r] = l_run[r] * alpha + p;
#pragma unroll
            for (int e = 0; e < E; ++e) acc[r][e] = fmaf(p, vf[e], acc[r][e] * alpha);
            m_run[r] = m_new;
          }
        }
      }
    }
  }

  // merge the warps' partial states, then finalize with safe_l
  __shared__ float sm_m[kWarps][RT];
  __shared__ float sm_l[kWarps][RT];
  __shared__ float sm_acc[kWarps][RT][D];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    if (lane == 0) {
      sm_m[warp][r] = m_run[r];
      sm_l[warp][r] = l_run[r];
    }
#pragma unroll
    for (int e = 0; e < E; ++e) sm_acc[warp][r][lane * E + e] = acc[r][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < RT * D; idx += kWarps * 32) {
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
    const float safe_l = l_tot == 0.f ? 1.f : l_tot;
    const int t = row / groups;
    const int head = h * groups + row % groups;
    out[((static_cast<size_t>(s) * T + t) * Hq + head) * D + d] =
        from_f32<QT>(o / safe_l);
  }
}

template <typename QT, typename KV, int D>
int launch(const void* q, const void* kp, const void* vp, const void* ks,
           const void* vs, const void* tables, const void* lengths, void* out,
           int S, int T, int Hq, int Hkv, int P, int page, int M, int window,
           float scale, float softcap, cudaStream_t stream) {
  constexpr int RT = D <= 128 ? 8 : 4;
  const int rows = T * (Hq / Hkv);
  const dim3 grid(S, Hkv, (rows + RT - 1) / RT);
  paged_attend_kernel<QT, KV, D, RT><<<grid, kWarps * 32, 0, stream>>>(
      static_cast<const QT*>(q), static_cast<const KV*>(kp),
      static_cast<const KV*>(vp), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<QT*>(out), T, Hq, Hkv, P,
      page, M, window, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KV>
int launch_d(int D, const void* q, const void* kp, const void* vp,
             const void* ks, const void* vs, const void* tables,
             const void* lengths, void* out, int S, int T, int Hq, int Hkv,
             int P, int page, int M, int window, float scale, float softcap,
             cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<QT, KV, 64>(q, kp, vp, ks, vs, tables, lengths, out, S,
                                T, Hq, Hkv, P, page, M, window, scale,
                                softcap, stream);
    case 128:
      return launch<QT, KV, 128>(q, kp, vp, ks, vs, tables, lengths, out, S,
                                 T, Hq, Hkv, P, page, M, window, scale,
                                 softcap, stream);
    case 256:
      return launch<QT, KV, 256>(q, kp, vp, ks, vs, tables, lengths, out, S,
                                 T, Hq, Hkv, P, page, M, window, scale,
                                 softcap, stream);
    default:
      return -1;
  }
}

template <typename QT>
int launch_kv(int kv_dtype, int D, const void* q, const void* kp,
              const void* vp, const void* ks, const void* vs,
              const void* tables, const void* lengths, void* out, int S,
              int T, int Hq, int Hkv, int P, int page, int M, int window,
              float scale, float softcap, cudaStream_t stream) {
  switch (kv_dtype) {
    case kF32:
      return launch_d<QT, float>(D, q, kp, vp, ks, vs, tables, lengths, out,
                                 S, T, Hq, Hkv, P, page, M, window, scale,
                                 softcap, stream);
    case kBF16:
      return launch_d<QT, __nv_bfloat16>(D, q, kp, vp, ks, vs, tables,
                                         lengths, out, S, T, Hq, Hkv, P, page,
                                         M, window, scale, softcap, stream);
    case kI8:
      return launch_d<QT, int8_t>(D, q, kp, vp, ks, vs, tables, lengths, out,
                                  S, T, Hq, Hkv, P, page, M, window, scale,
                                  softcap, stream);
    default:
      return -1;
  }
}

}  // namespace

// Plain C entry point for ctypes. Pools are [P, page, Hkv, D], scales
// [P, page, Hkv] fp32 (int8 pools only, else null), q / out [S, T, Hq, D],
// tables [S, M] int32, lengths [S] int32, all contiguous on the device.
// Returns 0, the cudaError_t of the launch, or -1 for a shape or dtype the
// kernel does not take.
extern "C" int paged_attend(const void* q, const void* k_pages,
                            const void* v_pages, const void* k_scale,
                            const void* v_scale, const void* tables,
                            const void* lengths, void* out, int S, int T,
                            int Hq, int Hkv, int D, int P, int page, int M,
                            int q_dtype, int kv_dtype, int window, float scale,
                            float softcap, void* stream) {
  if (S < 0 || T < 0 || Hkv < 1 || Hq % Hkv != 0 || P < 1 || M < 1 ||
      page < 8 || page > 64 || page % 8 != 0 || window < 1) {
    return -1;
  }
  if ((kv_dtype == kI8) != (k_scale != nullptr && v_scale != nullptr)) {
    return -1;
  }
  if (S == 0 || T == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case kF32:
      return launch_kv<float>(kv_dtype, D, q, k_pages, v_pages, k_scale,
                              v_scale, tables, lengths, out, S, T, Hq, Hkv, P,
                              page, M, window, scale, softcap, st);
    case kBF16:
      return launch_kv<__nv_bfloat16>(kv_dtype, D, q, k_pages, v_pages,
                                      k_scale, v_scale, tables, lengths, out,
                                      S, T, Hq, Hkv, P, page, M, window, scale,
                                      softcap, st);
    default:
      return -1;
  }
}
