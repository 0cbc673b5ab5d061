// Paged attention over the serving engine's block-paged KV pool, for
// Hopper (sm_90a), behind a plain C interface loaded with ctypes
// (kubeflow_tpu_torch/native/build.py). Two kernels, each in two storage
// variants:
//
//   paged_decode_kernel  replaces kubeflow_tpu/ops/paged_attention.py
//                        `_kernel` (the s == 1 one-token decode step that
//                        every generated token runs, once per layer).
//   paged_window_kernel  replaces kubeflow_tpu/ops/paged_attention.py
//                        `_mq_kernel` (an s > 1 query window: chunk
//                        prefill, where row j sits at cursor + j).
//
// The storage type KV is a template parameter beside the compute dtype T:
// KV == T reads a pool in the compute dtype; KV == int8_t reads the int8
// pool of `serving.quantize=int8` (the `quantized=True` branches of
// `_kernel` and `_mq_kernel`), with one bf16 scale per (token, head)
// vector in a [P, page_size, H, 1] sibling array. Each loaded int8
// element is dequantized as `dequant_kv` does it: f32(value) * f32(scale),
// rounded once to T; from there the arithmetic is the full-width one.
//
// Both compute, for slot b and head h,
//   softmax(q_b · K_bᵀ / sqrt(D)) · V_b
// where K_b/V_b are the slot's logical rows read page by page through
// page_table[b] out of the pool [P, page_size, H, D], keys past the row's
// position masked. A slot whose cursor lies past the window (the engine
// parks idle and retired slots at max_len) is never read: its output is
// zeros and its blocks load nothing, so an idle slot costs no bytes.
// They keep the JAX package's roundings: each q·k dot is
// accumulated in f32 and rounded to the compute dtype, divided by sqrt(D)
// in the compute dtype, and the softmax runs in f32. The window kernel
// rounds the normalised probabilities to the compute dtype before P·V; the
// decode kernel's one-pass softmax sums un-normalised f32 probabilities
// times V and divides once at the end (a reordering that ROADMAP's parity
// contract (c) allows: the same in f32 up to summation order, within one
// bf16 rounding of p in bf16). Both accumulate in f32 and round once.
//
// What bounds them: bytes. Each step reads every live K and V vector of
// every slot once (2 · n_keys · H · D elements per slot; D + 2 bytes a
// vector in int8, 2D in bf16) and does 4 flops per element read (5 with
// the dequant), far below the ~295 flops per byte the H100 needs before
// its arithmetic is the limit: the bound is the live vectors' bytes over
// 3.35 TB/s, 1.8 us for gpt_small's 8-slot decode step of one layer. Both
// walk only the pages up to a row's last visible position (a page-table
// entry past it may be stale and is never dereferenced) and read each
// live vector once per (slot, head). At ~2 us of bytes the walk is bound
// by latency, not bandwidth, and the decode kernel is built against
// that:
// 1. One block per (slot, head) gave 96 blocks on 132 SMs, and the one
//    long row walked its 1024 keys alone in 32 dependent rounds: the
//    decode grid is (slot, head, split), a split being a fixed run of
//    pages of 128 keys (kSplitKeys), sized from max_pages on the host and
//    never from the cursors (a split past its row's last key exits at
//    once), so a long row spreads over as many blocks as it has splits.
// 2. A page-table read sat in every load's chain: a block reads its
//    split's page ids into shared memory once, beside the cursor, and then
//    every lane group issues all its keys' K and V loads (up to 8 of each,
//    16 bytes a lane) before it computes, none of them behind a table
//    read.
// 3. Three block-wide barriers and reductions over a max_len score row in
//    shared memory (which capped the context it served): each lane group
//    keeps its own running max, sum and P·V (online softmax), the block
//    folds its groups once, and the splits are folded by the row's last
//    split to finish (a ticket per row in a workspace the wrapper
//    allocates and the kernel leaves zeroed), in split order, so the
//    result does not depend on which block finishes first. Shared memory
//    is static and small; the context is capped by nothing in the kernel.
// The window kernel keeps the first design (one block per (slot, head,
// 8 query rows), scores in shared memory, kUnroll loads in flight per lane
// group); it waits for its own redesign (split over pages, wgmma at s = 64).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// query rows one window block serves (one softmax warp each); its score
// tile is kRows x max_len f32
constexpr int kRows = kWarps;
// keys each lane group loads before it computes: loads in flight
constexpr int kUnroll = 2;
constexpr int kDefaultSmem = 48 * 1024;

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// round an f32 value to the compute dtype T and back
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

// one 16-byte load: N elements of T as f32 (the wrapper checks that
// every tensor is 16-byte aligned; D * sizeof(T) is a multiple of 16)
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ __forceinline__ static void load(const float* p, float* f) {
    unpack(*reinterpret_cast<const uint4*>(p), f);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& v, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* f) {
    unpack(*reinterpret_cast<const uint4*>(p), f);
  }
};

// the N elements of T at p as f32, in 16-byte loads (N a multiple of
// Vec<T>::N; p 16-byte aligned)
template <typename T, int N>
__device__ __forceinline__ void load_n(const T* p, float* f) {
#pragma unroll
  for (int j = 0; j < N / Vec<T>::N; ++j) Vec<T>::load(p + j * Vec<T>::N, f + j * Vec<T>::N);
}

// one 16-byte load of a K/V vector slice as the compute dtype T holds it:
// a pool in T itself (the scale pointer is unused) ...
template <typename T, typename KV>
struct Kv {
  static constexpr int N = Vec<T>::N;
  __device__ __forceinline__ static void load(const KV* p, const __nv_bfloat16*,
                                              float* f) {
    Vec<T>::load(p, f);
  }
};
// ... or an int8 pool: 16 values, each dequantized with the vector's bf16
// scale as `dequant_kv` does it (f32 multiply, one rounding to T)
template <typename T>
struct Kv<T, int8_t> {
  static constexpr int N = 16;
  __device__ __forceinline__ static void unpack(const uint4& v, __nv_bfloat16 scale,
                                                float* f) {
    const float sc = __bfloat162float(scale);
    const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = round_to<T>(static_cast<float>(b[i]) * sc);
  }
  __device__ __forceinline__ static void load(const int8_t* p,
                                              const __nv_bfloat16* scale, float* f) {
    unpack(*reinterpret_cast<const uint4*>(p), *scale, f);
  }
};

// A K/V vector slice's 16 bytes (and an int8 vector's scale) held in
// registers: loaded now and unpacked (dequantized) later, so that a
// thread keeps many loads in flight before it computes. Unpacking gives
// exactly what Kv<T, KV>::load gives.
template <typename T, typename KV>
struct KvRaw {
  uint4 bits;
  __device__ __forceinline__ void load(const KV* p, const __nv_bfloat16*) {
    bits = *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ void clear() { bits = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ void unpack(float* f) const { Vec<T>::unpack(bits, f); }
};
template <typename T>
struct KvRaw<T, int8_t> {
  uint4 bits;
  __nv_bfloat16 scale;
  __device__ __forceinline__ void load(const int8_t* p, const __nv_bfloat16* sc) {
    bits = *reinterpret_cast<const uint4*>(p);
    scale = *sc;
  }
  __device__ __forceinline__ void clear() {
    bits = make_uint4(0u, 0u, 0u, 0u);
    scale = __float2bfloat16_rn(0.f);
  }
  __device__ __forceinline__ void unpack(float* f) const { Kv<T, int8_t>::unpack(bits, scale, f); }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// sum over the `lanes` neighbouring lanes that hold one key's vectors
template <int lanes>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = lanes / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// position t of slot b, head h -> index of its vector in the pool viewed
// as [P * page_size * H] vectors: its values start at row * D, its int8
// scale (if any) is scale[row]. The page id is clamped into
// [0, num_pages) so a corrupt table entry can never fault; the engine
// never hands the kernel one.
__device__ __forceinline__ size_t kv_row(const int* pt, int t, int page_size,
                                         int num_pages, int H, int h) {
  int page = pt[t / page_size];
  page = page < 0 ? 0 : (page >= num_pages ? num_pages - 1 : page);
  return (static_cast<size_t>(page) * page_size + t % page_size) * H + h;
}

// Thread layout of both kernels: a key's D elements are read as
// LPK = D / N 16-byte vectors by LPK neighbouring lanes (a "lane group";
// N = Kv<T, KV>::N elements a load: 4 f32, 8 bf16, 16 int8);
// the block's G = threads / LPK lane groups each take one key, and each
// loads several keys before computing (the window kernel kUnroll, the
// decode kernel DecodeGeo::U). Loops step a block-uniform base so every
// lane of a warp runs the same iterations (the shuffles need it).

// ---------------------------------------------------------------------------
// s == 1: split over pages (flash-decoding). Block (slot b, head h, split)
// walks the split's run of pages_per_split pages (kSplitKeys keys, at least
// one page) of the row's n_keys = min(cursor, L - 1) + 1 visible keys, in
// one pass: each lane group keeps a running max, sum and un-normalised
// P·V over the keys it loads (U at a time, all in flight), the block folds
// its groups into the split's (m_i, l_i, o_i) (each warp's groups by
// shuffles, then the warps), and the row's last live split to finish (a
// ticket per row) folds the splits in split order with a running max:
//   m' = max(m, m_i), l' = l·exp(m − m') + l_i·exp(m_i − m'), o' likewise,
//   out = o / l.
// A row that one split covers writes o_i / l_i itself.
// ---------------------------------------------------------------------------
constexpr int kDecThreads = 256;
constexpr int kDecWarps = kDecThreads / 32;
// keys a split walks (whole pages: 128 / page_size of them, at least one)
constexpr int kSplitKeys = 128;

int decode_pages_per_split(int page_size) {
  return page_size >= kSplitKeys ? 1 : kSplitKeys / page_size;
}

int decode_splits(int page_size, int max_pages) {
  const int pps = decode_pages_per_split(page_size);
  return (max_pages + pps - 1) / pps;
}

// the ticket's old value after adding 1; a release of what the block wrote
// before it (its threads' writes precede it through the block barrier)
// and an acquire of what the row's other splits released with theirs
__device__ __forceinline__ int take_ticket(int* ticket) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(ticket)
               : "memory");
  return old;
}

template <typename T, typename KV, int D>
struct DecodeGeo {
  static constexpr int N = Kv<T, KV>::N;    // elements a 16-byte load
  static constexpr int LPK = D / N;         // lanes a key
  static constexpr int G = kDecThreads / LPK;  // lane groups a block
  // keys a lane group loads before it computes (each a K and a V load)
  static constexpr int U = kSplitKeys / G < 1 ? 1 : (kSplitKeys / G > 8 ? 8 : kSplitKeys / G);
};

template <typename T, typename KV, int D>
__global__ void __launch_bounds__(kDecThreads)
paged_decode_kernel(const T* __restrict__ q, const KV* __restrict__ pool_k,
                    const KV* __restrict__ pool_v,
                    const __nv_bfloat16* __restrict__ k_scale,
                    const __nv_bfloat16* __restrict__ v_scale,
                    const int* __restrict__ page_table,
                    const int* __restrict__ cursors, T* __restrict__ out,
                    float* __restrict__ part_o, float2* __restrict__ part_ml,
                    int* __restrict__ tickets, int page_size, int max_pages,
                    int num_pages, int pages_per_split, float scale) {
  using Geo = DecodeGeo<T, KV, D>;
  constexpr int N = Geo::N, LPK = Geo::LPK, G = Geo::G, U = Geo::U;
  __shared__ int pages[kSplitKeys];     // the split's page ids
  __shared__ float wpart[kDecWarps * D];  // the warps' un-normalised P·V
  __shared__ float wm[kDecWarps], wl[kDecWarps];
  __shared__ int last;

  const int b = blockIdx.x, h = blockIdx.y, split = blockIdx.z;
  const int H = gridDim.y, n_splits = gridDim.z, row = b * H + h;
  const int tid = threadIdx.x, li = tid % LPK, g = tid / LPK;
  const size_t qo = static_cast<size_t>(row) * D;
  const int p0 = split * pages_per_split;
  // the split's page ids, read beside the cursor: no table read sits in a
  // K/V load's chain. An id past the row's last live page may be stale; it
  // is read here (clamped into the pool) but never dereferenced.
  if (tid < pages_per_split && p0 + tid < max_pages) {
    const int page = page_table[static_cast<size_t>(b) * max_pages + p0 + tid];
    pages[tid] = page < 0 ? 0 : (page >= num_pages ? num_pages - 1 : page);
  }
  int cur = cursors[b];
  cur = cur < 0 ? 0 : cur;
  // a parked row (cursor past the window: an idle or retired slot) is
  // never read; its first split writes zeros
  if (cur >= max_pages * page_size) {
    if (split == 0)
      for (int d = tid; d < D; d += kDecThreads) out[qo + d] = from_f<T>(0.f);
    return;
  }
  const int n_keys = cur + 1;
  const int kps = pages_per_split * page_size;
  const int k_begin = split * kps;
  if (k_begin >= n_keys) return;  // a split past the row's last key
  const int k_end = min(k_begin + kps, n_keys);
  float qv[N];
  load_n<T, N>(q + qo + li * N, qv);
  __syncthreads();

  float m = -CUDART_INF_F, l = 0.f, acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
  for (int c0 = k_begin; c0 < k_end; c0 += G * U) {
    KvRaw<T, KV> kr[U], vr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = c0 + u * G + g;
      if (t < k_end) {
        const size_t r =
            (static_cast<size_t>(pages[(t - k_begin) / page_size]) * page_size + t % page_size) *
                H + h;
        kr[u].load(pool_k + r * D + li * N, k_scale + r);
        vr[u].load(pool_v + r * D + li * N, v_scale + r);
      } else {
        kr[u].clear();
        vr[u].clear();
      }
    }
    // scores as the JAX kernel rounds them: the f32 dot rounded to T, then
    // divided by sqrt(D) in T
    float s[U];
    float mx = m;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[N];
      kr[u].unpack(kf);
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < N; ++i) dot += qv[i] * kf[i];
      dot = group_sum<LPK>(dot);
      s[u] = c0 + u * G + g < k_end ? round_to<T>(round_to<T>(dot) / scale) : -CUDART_INF_F;
      mx = fmaxf(mx, s[u]);
    }
    if (mx > -CUDART_INF_F) {  // the group has a key in this chunk
      const float alpha = expf(m - mx);
      l *= alpha;
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = expf(s[u] - mx);
        float vf[N];
        vr[u].unpack(vf);
        l += p;
#pragma unroll
        for (int i = 0; i < N; ++i) acc[i] += p * vf[i];
      }
      m = mx;
    }
  }

  // the split's (m_i, l_i, o_i): each warp's lane groups folded by
  // shuffles across groups (offsets >= LPK keep a lane's slice of D), a
  // group without keys weighing 0; then the warps, in warp order
  float mw = m;
#pragma unroll
  for (int o = 16; o >= LPK; o >>= 1) mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, o));
  const float f = m == -CUDART_INF_F ? 0.f : expf(m - mw);
  l *= f;
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] *= f;
#pragma unroll
  for (int o = 16; o >= LPK; o >>= 1) {
    l += __shfl_xor_sync(0xffffffffu, l, o);
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
  }
  const int warp = tid >> 5, lane = tid & 31;
  if (lane < LPK) {
#pragma unroll
    for (int i = 0; i < N; ++i) wpart[warp * D + lane * N + i] = acc[i];
    if (lane == 0) {
      wm[warp] = mw;
      wl[warp] = l;
    }
  }
  __syncthreads();
  float m_i = -CUDART_INF_F;
#pragma unroll
  for (int w = 0; w < kDecWarps; ++w) m_i = fmaxf(m_i, wm[w]);
  float l_i = 0.f, o_i = 0.f;
#pragma unroll
  for (int w = 0; w < kDecWarps; ++w) {
    const float fw = wm[w] == -CUDART_INF_F ? 0.f : expf(wm[w] - m_i);
    l_i += fw * wl[w];
    if (tid < D) o_i += fw * wpart[w * D + tid];
  }
  const int n_live = (n_keys + kps - 1) / kps;
  if (n_live == 1) {
    if (tid < D) out[qo + tid] = from_f<T>(o_i / l_i);
    return;
  }
  const size_t slot = static_cast<size_t>(row) * n_splits;
  if (tid < D) part_o[(slot + split) * D + tid] = o_i;
  if (tid == 0) part_ml[slot + split] = make_float2(m_i, l_i);
  __syncthreads();
  if (tid == 0) last = take_ticket(tickets + row) == n_live - 1;
  __syncthreads();
  if (!last) return;
  // the row's last live split: every split's partial is written; fold
  // them in split order with a running max (reads bypass L1, which may
  // hold stale lines)
  if (tid < D) {
    float mm = -CUDART_INF_F, ll = 0.f, oo = 0.f;
#pragma unroll 4
    for (int j = 0; j < n_live; ++j) {
      const float2 ml = __ldcg(part_ml + slot + j);
      const float o_j = __ldcg(part_o + (slot + j) * D + tid);
      const float m_new = fmaxf(mm, ml.x);
      const float a = expf(mm - m_new), fj = expf(ml.x - m_new);
      ll = ll * a + ml.y * fj;
      oo = oo * a + o_j * fj;
      mm = m_new;
    }
    out[qo + tid] = from_f<T>(oo / ll);
  }
  if (tid == 0) tickets[row] = 0;  // ready for the next launch
}

// ---------------------------------------------------------------------------
// s > 1: one block per (slot, head, tile of kRows query rows). Row j sits
// at position cursor + j and sees keys <= cursor + j; the block walks the
// pages up to its last row's position (the JAX kernel's live-page gate is
// cursor + s - 1 for the whole window). Each K/V vector the block needs
// is loaded once and used by all its rows.
// ---------------------------------------------------------------------------
template <typename T, typename KV, int D>
__global__ void __launch_bounds__(kThreads)
paged_window_kernel(const T* __restrict__ q, const KV* __restrict__ pool_k,
                    const KV* __restrict__ pool_v,
                    const __nv_bfloat16* __restrict__ k_scale,
                    const __nv_bfloat16* __restrict__ v_scale,
                    const int* __restrict__ page_table,
                    const int* __restrict__ cursors, T* __restrict__ out,
                    int S, int page_size, int max_pages, int num_pages,
                    float scale) {
  constexpr int N = Kv<T, KV>::N;
  constexpr int LPK = D / N;
  constexpr int KPW = 32 / LPK;
  constexpr int G = kThreads / LPK;
  extern __shared__ float smem[];
  const int view_len = max_pages * page_size;
  float* scores = smem;                    // [kRows][view_len]
  float* q_s = scores + kRows * view_len;  // [kRows][D]
  float* part = q_s + kRows * D;           // [G][D], one row at a time

  const int b = blockIdx.x, h = blockIdx.y, H = gridDim.y;
  const int j0 = blockIdx.z * kRows;
  const int rows = min(kRows, S - j0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane / LPK, li = tid % LPK, g = tid / LPK;
  int cur = cursors[b];
  cur = cur < 0 ? 0 : cur;
  // a parked row's window is never read: zeros, no walk
  if (cur >= view_len) {
    for (int i = tid; i < rows * D; i += kThreads)
      out[((static_cast<size_t>(b) * S + j0 + i / D) * H + h) * D + i % D] =
          from_f<T>(0.f);
    return;
  }
  const int* pt = page_table + static_cast<size_t>(b) * max_pages;
  // visible keys of the block's last row: the keys (and pages) it walks
  const int n_max = min(cur + j0 + rows - 1, view_len - 1) + 1;

  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    q_s[i] = r < rows
        ? to_f<T>(q[((static_cast<size_t>(b) * S + j0 + r) * H + h) * D + d])
        : 0.f;
  }
  __syncthreads();

  for (int base = warp * KPW; base < n_max; base += G * kUnroll) {
    float kf[kUnroll][N];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + sub + u * G;
      if (t < n_max) {
        const size_t row = kv_row(pt, t, page_size, num_pages, H, h);
        Kv<T, KV>::load(pool_k + row * D + li * N, k_scale + row, kf[u]);
      } else {
#pragma unroll
        for (int i = 0; i < N; ++i) kf[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + sub + u * G;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < N; ++i) acc += q_s[r * D + li * N + i] * kf[u][i];
        acc = group_sum<LPK>(acc);
        if (li == 0 && t < n_max)
          scores[r * view_len + t] = round_to<T>(round_to<T>(acc) / scale);
      }
    }
  }
  __syncthreads();

  // f32 softmax per row, one warp per row
  if (warp < rows) {
    float* row = scores + warp * view_len;
    const int n_r = min(cur + j0 + warp, view_len - 1) + 1;
    float m = -CUDART_INF_F;
    for (int t = lane; t < n_r; t += 32) m = fmaxf(m, row[t]);
    m = warp_max(m);
    float s = 0.f;
    for (int t = lane; t < n_r; t += 32) {
      const float e = expf(row[t] - m);
      row[t] = e;
      s += e;
    }
    s = warp_sum(s);
    for (int t = lane; t < n_r; t += 32) row[t] = round_to<T>(row[t] / s);
  }
  __syncthreads();

  float acc[kRows][N];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int i = 0; i < N; ++i) acc[r][i] = 0.f;
  }
  for (int base = warp * KPW; base < n_max; base += G * kUnroll) {
    float vf[kUnroll][N];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + sub + u * G;
      if (t < n_max) {
        const size_t row = kv_row(pt, t, page_size, num_pages, H, h);
        Kv<T, KV>::load(pool_v + row * D + li * N, v_scale + row, vf[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + sub + u * G;
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        // keys past row r's own position are masked: skipped
        if (r < rows && t < n_max && t <= cur + j0 + r) {
          const float p = scores[r * view_len + t];
#pragma unroll
          for (int i = 0; i < N; ++i) acc[r][i] += p * vf[u][i];
        }
      }
    }
  }
  for (int r = 0; r < rows; ++r) {
#pragma unroll
    for (int i = 0; i < N; ++i) part[g * D + li * N + i] = acc[r][i];
    __syncthreads();
    for (int d = tid; d < D; d += kThreads) {
      float o = 0.f;
#pragma unroll 8
      for (int gg = 0; gg < G; ++gg) o += part[gg * D + d];
      out[((static_cast<size_t>(b) * S + j0 + r) * H + h) * D + d] = from_f<T>(o);
    }
    __syncthreads();
  }
}

// dynamic shared memory of a window launch; n = elements per 16-byte K/V
// load (the decode kernel's is static and does not grow with the window)
size_t window_smem(int view_len, int D, int n) {
  return sizeof(float) *
         (static_cast<size_t>(kRows) * view_len + kRows * D + kThreads * n);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The decode kernel's workspace, one buffer: a ticket per (slot, head)
// row (int32, zero between launches: the row's last split resets it), then
// each split's (m_i, l_i) (float2) and un-normalised o_i (D f32).
struct DecodeWorkspace {
  size_t ml, o, bytes;  // byte offsets of the stats and partials; the size
};

DecodeWorkspace decode_workspace(int B, int H, int D, int page_size, int max_pages) {
  const size_t rows = static_cast<size_t>(B) * H;
  const size_t parts = rows * decode_splits(page_size, max_pages);
  DecodeWorkspace w;
  w.ml = (4 * rows + 15) / 16 * 16;
  w.o = w.ml + 8 * parts;
  w.bytes = w.o + 4 * parts * D;
  return w;
}

struct Args {
  const void* q;
  const void* pk;
  const void* pv;
  const __nv_bfloat16* ks;
  const __nv_bfloat16* vs;
  const int* pt;
  const int* cur;
  void* out;
  int B, S, H, ps, mp, np;
  float scale;
  void* workspace;
  cudaStream_t stream;
};

template <typename T, typename KV, int D>
cudaError_t launch(const Args& a) {
  const int view_len = a.ps * a.mp;
  constexpr int n = Kv<T, KV>::N;
  cudaError_t err;
  if (a.S == 1) {
    // the grid follows max_pages, never the cursors: no host read, so the
    // launch can be captured in a CUDA graph
    if (a.workspace == nullptr) return cudaErrorInvalidValue;
    const DecodeWorkspace w = decode_workspace(a.B, a.H, D, a.ps, a.mp);
    unsigned char* ws = static_cast<unsigned char*>(a.workspace);
    paged_decode_kernel<T, KV, D>
        <<<dim3(a.B, a.H, decode_splits(a.ps, a.mp)), kDecThreads, 0, a.stream>>>(
            static_cast<const T*>(a.q), static_cast<const KV*>(a.pk),
            static_cast<const KV*>(a.pv), a.ks, a.vs, a.pt, a.cur, static_cast<T*>(a.out),
            reinterpret_cast<float*>(ws + w.o), reinterpret_cast<float2*>(ws + w.ml),
            reinterpret_cast<int*>(ws), a.ps, a.mp, a.np, decode_pages_per_split(a.ps),
            a.scale);
  } else {
    const size_t smem = window_smem(view_len, D, n);
    if ((err = allow_smem(paged_window_kernel<T, KV, D>, smem)) != cudaSuccess) return err;
    paged_window_kernel<T, KV, D>
        <<<dim3(a.B, a.H, (a.S + kRows - 1) / kRows), kThreads, smem, a.stream>>>(
            static_cast<const T*>(a.q), static_cast<const KV*>(a.pk),
            static_cast<const KV*>(a.pv), a.ks, a.vs, a.pt, a.cur,
            static_cast<T*>(a.out), a.S, a.ps, a.mp, a.np, a.scale);
  }
  return cudaGetLastError();
}

template <typename T, typename KV>
cudaError_t dispatch_d(int D, const Args& a) {
  switch (D) {
    case 16: return launch<T, KV, 16>(a);
    case 64: return launch<T, KV, 64>(a);
    case 128: return launch<T, KV, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

// elements of one 16-byte K/V load for (compute dtype, storage) codes
int kv_elems(int dtype, int kv_dtype) {
  if (kv_dtype == 2) return Kv<float, int8_t>::N;
  return dtype == 1 ? Vec<__nv_bfloat16>::N : Vec<float>::N;
}

}  // namespace

extern "C" {

// dtype (the compute dtype of q and out): 0 = float32, 1 = bfloat16.
// kv_dtype (the pools' storage): 0 = float32, 1 = bfloat16 (each equal to
// dtype), 2 = int8 with bf16 scales k_scale/v_scale [num_pages,
// page_size, H, 1] (null otherwise). q/out [B, S, H, D]; pools
// [num_pages, page_size, H, D]; page_table [B, max_pages] int32; cursors
// [B] int32; all contiguous on the current device. `scale` is sqrt(D)
// rounded to the compute dtype. S == 1 launches paged_decode_kernel, which
// needs `workspace`: kft_paged_attention_workspace bytes on the device,
// zeroed before its first launch and left zeroed by every launch (null at
// S > 1). S > 1 launches paged_window_kernel. Returns cudaGetLastError()
// after the launch; neither allocates or synchronises.
int kft_paged_attention(const void* q, const void* pool_k, const void* pool_v,
                        const void* k_scale, const void* v_scale,
                        const void* page_table, const void* cursors, void* out,
                        int B, int S, int H, int D, int page_size, int max_pages,
                        int num_pages, int dtype, int kv_dtype, float scale,
                        void* stream, void* workspace) {
  const Args a{q, pool_k, pool_v,
               static_cast<const __nv_bfloat16*>(k_scale),
               static_cast<const __nv_bfloat16*>(v_scale),
               static_cast<const int*>(page_table), static_cast<const int*>(cursors),
               out, B, S, H, page_size, max_pages, num_pages, scale, workspace,
               static_cast<cudaStream_t>(stream)};
  if (kv_dtype == 2) {
    if (k_scale == nullptr || v_scale == nullptr) return cudaErrorInvalidValue;
    if (dtype == 0) return dispatch_d<float, int8_t>(D, a);
    if (dtype == 1) return dispatch_d<__nv_bfloat16, int8_t>(D, a);
    return cudaErrorInvalidValue;
  }
  if (kv_dtype != dtype) return cudaErrorInvalidValue;
  if (dtype == 0) return dispatch_d<float, float>(D, a);
  if (dtype == 1) return dispatch_d<__nv_bfloat16, __nv_bfloat16>(D, a);
  return cudaErrorInvalidValue;
}

// dynamic shared memory (bytes) a launch needs, for the wrapper's check
// (0 at S == 1: the decode kernel's shared memory is static)
size_t kft_paged_attention_smem(int S, int view_len, int D, int dtype, int kv_dtype) {
  return S == 1 ? 0 : window_smem(view_len, D, kv_elems(dtype, kv_dtype));
}

// workspace bytes an S-row launch needs (0 at S > 1)
size_t kft_paged_attention_workspace(int S, int B, int H, int D, int page_size,
                                     int max_pages) {
  return S == 1 ? decode_workspace(B, H, D, page_size, max_pages).bytes : 0;
}

const char* kft_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
