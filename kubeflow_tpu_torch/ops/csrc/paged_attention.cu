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
//                        prefill, the prefix-hit tail and the K+1 verify
//                        window, where row j sits at cursor + j).
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
// They keep the JAX package's score roundings: each q·k dot is
// accumulated in f32 and rounded to the compute dtype, divided by sqrt(D)
// in the compute dtype, and the softmax runs in f32. Both split a row's
// keys over blocks and carry un-normalised probabilities: each split sums
// exp(s − m_split) (f32) and its product with V, and the splits are folded
// with a running max and divided by the sum once at the end. The JAX
// kernels round the normalised probabilities to the compute dtype before
// P·V; this is the reordering ROADMAP's parity contract (c) allows (the
// same in f32 up to summation order; in bf16 the window kernel rounds the
// un-normalised p to bf16 for its tensor-core product, the decode kernel
// keeps it in f32). Both accumulate in f32 and round once.
//
// What bounds them: bytes. A call reads every live K and V vector of every
// slot once (2 · n_keys · H · D elements per slot; D + 2 bytes a vector in
// int8, 2D in bf16) and does 4 flops per (query row, key, element) (plus
// the dequant), far below the ~295 flops per byte the H100 needs before its
// arithmetic is the limit: the bound is the live vectors' bytes over
// 3.35 TB/s, 1.8 us for gpt_small's 8-slot decode step of one layer and
// ~0.5 us for one 64-row chunk window. Both walk only the pages up to a
// row's last visible position (a page-table entry past it may be stale and
// is never dereferenced) and read each live vector once per (slot, head,
// block). At a few us of bytes a walk is bound by latency, not bandwidth,
// and both kernels are built against that:
// 1. One block per (slot, head) gave 96 blocks on 132 SMs, and a long row
//    walked its keys alone in dependent rounds: the grid is split over
//    pages, a split being a fixed run of whole pages of 128 keys
//    (kSplitKeys), sized from max_pages on the host and never from the
//    cursors (a split past its rows' last key exits at once), so a long
//    row spreads over as many blocks as it has splits and the launch reads
//    nothing on the host.
// 2. A page-table read sat in every load's chain: a block reads its
//    split's page ids once, beside the cursor, and then issues all its
//    K and V loads (decode: up to 8 of each per lane group, 16 bytes a
//    lane; window: one TMA box per page, or 16-byte loads by every thread)
//    before it computes, none of them behind a table read.
// 3. Block-wide reductions over a score row of the whole view in shared
//    memory (which capped the context the window kernel served at ~7,000
//    positions): each block keeps only its split's running max, sum and
//    P·V, and the splits are folded by the row's (decode) or query tile's
//    (window) last live split to finish (a ticket in a workspace the
//    wrapper allocates and the kernel leaves zeroed), in split order, so
//    the result does not depend on which block finishes first. Shared
//    memory does not grow with the view; the context is capped by nothing
//    in either kernel.
// The window kernel's products run on the tensor cores (wgmma, bf16): a
// 64-row query tile against a 128-key split is one m64n128 chain for S and
// one m64nD chain for P·V. A short window (the s = 5 verify window) fills
// 5 of the tile's 64 rows; the tensor-core work it wastes costs nothing
// next to the call's bytes and latency.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

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

// sum over the `lanes` neighbouring lanes that hold one key's vectors
template <int lanes>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = lanes / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Thread layout of the decode kernel: a key's D elements are read as
// LPK = D / N 16-byte vectors by LPK neighbouring lanes (a "lane group";
// N = Kv<T, KV>::N elements a load: 4 f32, 8 bf16, 16 int8);
// the block's G = threads / LPK lane groups each take one key, and each
// loads DecodeGeo::U keys before computing. Loops step a block-uniform
// base so every lane of a warp runs the same iterations (the shuffles
// need it).

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

__host__ __device__ inline int decode_pages_per_split(int page_size) {
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
// s > 1: split over pages, 64 query rows a block. Block (split, query tile,
// slot b · H + head h) takes query rows [64·tile, 64·tile + 64) of the
// window (row j at position cursor + j, seeing keys <= cursor + j) and the
// split's run of keys [k0, k0 + kps): whole pages of at most 128 keys, as
// the decode kernel cuts them (a page over 128 keys is cut into parts of
// 128). A split past its tile's last visible position exits at once; the
// others compute each row's (m_i, l_i, o_i) over the split's keys, and the
// tile's last live split to finish (a ticket per tile) folds them in split
// order, as the decode kernel does. A tile that one split covers writes
// o_i / l_i itself.
//
// bf16 (one warpgroup): Q [64][D] and the split's K and V [128][D] tiles in
// shared memory in the swizzled layout wgmma reads; S = Q·Kᵀ is a chain of
// wgmma m64n128k16 from shared memory; the scores are rounded as the JAX
// kernel rounds them, masked, and exponentiated against the row's split
// max (un-normalised p, f32 sum l); P·V is a wgmma with P (rounded to bf16)
// as the register A operand and V read MN-major. A block takes one split,
// so its ring has two stages used once each, K's and V's: at full width
// each page (one head's page_size × D rows) is one TMA box of the 2-D view
// [num_pages · page_size, H · D] landing on K's or V's mbarrier (issued by
// the lanes of warp 0, a page a lane), so S and the softmax run while V's
// pages are in flight; a page of fewer than 8
// rows (under the swizzle atom) and the int8 pool are read by the
// warpgroup's threads in 16-byte loads (int8 dequantized on the way) and
// written in the same layout, V's while S is in flight. Rows of the tile
// no page fills are zeros (stale shared memory may hold NaN, and p = 0
// does not clear it in P·V).
//
// f32 (the parity path): the same grid, split and fold, the tiles in
// shared memory as f32 and the products on the CUDA cores (scalar FMA, 8
// rows × 8 keys a thread for S, 8 rows × D / 16 columns for P·V).
//
// A 64-row chunk window at gpt_small's widths needs ~0.5 us of bytes and
// less of the tensor cores: the call is a chain of dependent steps (launch,
// cursor and page ids, the page copies, two products, the partials' write,
// the ticket, the fold's reads), and the fold of a tile's splits is its
// longest link (PERF.md).
// ---------------------------------------------------------------------------
constexpr int kWinThreads = kWarpGroup;  // one warpgroup a block
constexpr int kWinRows = 64;             // query rows a block (a tile)
constexpr int kWinKeys = kSplitKeys;     // tile rows of K and V: keys a split at most
constexpr float kBigNeg = -1e30f;        // a row max before any visible key

// keys a window split walks (decode_pages_per_split whole pages, or a
// 128-key part of a larger page) and rows of one copy (a page or a part)
__host__ __device__ inline int window_split_keys(int ps) {
  return ps <= kWinKeys ? decode_pages_per_split(ps) * ps : kWinKeys;
}
__host__ __device__ inline int window_box_rows(int ps) { return ps < kWinKeys ? ps : kWinKeys; }

int window_splits(int ps, int max_pages) {
  const int kps = window_split_keys(ps);
  return (max_pages * ps + kps - 1) / kps;
}

// shared memory of a window block: bf16 Q | K | V tiles (1024-byte aligned)
// | two mbarriers | the split's page ids; f32 Q, K, V [rows][D + 1] | P
// [64][kPStride] | page ids
template <typename T, int D>
struct WinSmem {
  static constexpr bool kBf16 = sizeof(T) == 2;
  static constexpr uint32_t kQ = kWinRows * D * 2, kKV = kWinKeys * D * 2;  // bf16 tiles
  // f32 row strides, padded against bank conflicts
  static constexpr int kLd = D + 1, kPStride = kWinKeys + 1;
  static constexpr size_t kBytes =
      kBf16 ? 1024 + kQ + 2 * kKV + 16 + 4 * kWinKeys
            : 4 * (static_cast<size_t>(kWinRows + 2 * kWinKeys) * kLd + kWinRows * kPStride +
                   kWinKeys);
};

// What one window block works on, from its indices and the slot's cursor.
struct WinBlock {
  int b, h, bh, tile, split, j0, rows;  // rows [j0, j0 + rows) of slot b, head h
  int cur, view_len, k0, n_keys;        // the split's first key and its keys the tile sees
  int n_live;                           // live splits of the tile
  bool parked;                          // cursor past the window: zeros, nothing read

  __device__ __forceinline__ WinBlock(const int* cursors, int S, int H, int page_size,
                                      int max_pages) {
    split = blockIdx.x;
    tile = blockIdx.y;
    bh = blockIdx.z;
    b = bh / H;
    h = bh % H;
    j0 = tile * kWinRows;
    rows = min(kWinRows, S - j0);
    cur = max(cursors[b], 0);
    view_len = max_pages * page_size;
    parked = cur >= view_len;
    // the tile's last visible position: its last row's, inside the view
    const int last = min(cur + j0 + rows - 1, view_len - 1);
    const int kps = window_split_keys(page_size);
    k0 = split * kps;
    n_keys = parked ? 0 : min(kps, last + 1 - k0);
    n_live = last / kps + 1;
  }
  // the last key of the split that query row r of the tile sees (< 0: none)
  __device__ __forceinline__ int last_key(int r) const {
    return min(cur + j0 + r, view_len - 1) - k0;
  }
  __device__ __forceinline__ size_t out_row(int S, int H, int D, int r) const {
    return ((static_cast<size_t>(b) * S + j0 + r) * H + h) * D;
  }
  // index of (this tile, this split)'s partials: kWinRows rows of them
  __device__ __forceinline__ size_t part(int split_j) const {
    return (static_cast<size_t>(bh) * gridDim.y + tile) * gridDim.x + split_j;
  }
};

// a parked slot's tile (written by split 0): zeros
template <typename T, int D>
__device__ __forceinline__ void window_zeros(const WinBlock& w, T* out, int S, int H) {
  for (int i = threadIdx.x; i < w.rows * D; i += kWinThreads)
    out[w.out_row(S, H, D, i / D) + i % D] = from_f<T>(0.f);
}

// The id of the page (or page part) holding copy `threadIdx.x` of the
// block's split, clamped into the pool (the engine never hands the kernel
// one outside it), read before the cursor is known, so that no table read
// waits for it; -1 past the split or the table. An id past the tile's last
// live page may be stale: it is read but never dereferenced.
__device__ __forceinline__ int window_page_id(const int* page_table, int H, int page_size,
                                              int max_pages, int num_pages) {
  const int kps = window_split_keys(page_size), bs = window_box_rows(page_size);
  const int i = threadIdx.x, p = (blockIdx.x * kps + i * bs) / page_size;
  if (i * bs >= kps || p >= max_pages) return -1;
  const int page = page_table[static_cast<size_t>(blockIdx.z / H) * max_pages + p];
  return page < 0 ? 0 : (page >= num_pages ? num_pages - 1 : page);
}

// pool vector index (values at index · D, int8 scale at index) of the
// split's key c, head h
__device__ __forceinline__ size_t window_vector(const int* pages, const WinBlock& w, int c,
                                                int page_size, int H) {
  const int bs = window_box_rows(page_size);
  return (static_cast<size_t>(pages[c / bs]) * page_size + (w.k0 + c) % page_size) * H + w.h;
}

// The tile's last live split: every split's (m, l, o) of each of its rows,
// folded in split order with a running max (kLog2: m in the exp2 domain),
// out = o / l. Thread t folds half a row (row t / 2). Reads bypass L1,
// which may hold stale lines.
template <typename T, int D, bool kLog2>
__device__ __forceinline__ void window_fold(const WinBlock& w, const float* part_o,
                                            const float2* part_ml, T* out, int S, int H) {
  constexpr int kHalf = D / 2;
  constexpr int kInFlight = D <= 64 ? 4 : 2;  // splits whose loads go out together
  const int r = threadIdx.x >> 1, c0 = (threadIdx.x & 1) * kHalf;
  if (r >= w.rows) return;
  float mm = -CUDART_INF_F, ll = 0.f, oo[kHalf];
#pragma unroll
  for (int i = 0; i < kHalf; ++i) oo[i] = 0.f;
#pragma unroll kInFlight
  for (int j = 0; j < w.n_live; ++j) {
    const size_t p = w.part(j) * kWinRows + r;
    const float2 ml = __ldcg(part_ml + p);
    const float4* src = reinterpret_cast<const float4*>(part_o + p * D + c0);
    const float m_new = fmaxf(mm, ml.x);
    const float a = kLog2 ? exp2f(mm - m_new) : expf(mm - m_new);
    const float f = kLog2 ? exp2f(ml.x - m_new) : expf(ml.x - m_new);
    ll = ll * a + ml.y * f;
#pragma unroll
    for (int i = 0; i < kHalf / 4; ++i) {
      const float4 v = __ldcg(src + i);
      oo[4 * i] = oo[4 * i] * a + v.x * f;
      oo[4 * i + 1] = oo[4 * i + 1] * a + v.y * f;
      oo[4 * i + 2] = oo[4 * i + 2] * a + v.z * f;
      oo[4 * i + 3] = oo[4 * i + 3] * a + v.w * f;
    }
    mm = m_new;
  }
  T* dst = out + w.out_row(S, H, D, r) + c0;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) dst[i] = from_f<T>(oo[i] / ll);
}

// After a block wrote its partials: take the tile's ticket; the last live
// split folds every split and resets the ticket for the next launch.
template <typename T, int D, bool kLog2>
__device__ __forceinline__ void window_finish(const WinBlock& w, const float* part_o,
                                              const float2* part_ml, int* tickets, T* out,
                                              int S, int H) {
  __shared__ int last;
  int* ticket = tickets + static_cast<size_t>(w.bh) * gridDim.y + w.tile;
  __syncthreads();
  if (threadIdx.x == 0) last = take_ticket(ticket) == w.n_live - 1;
  __syncthreads();
  if (!last) return;
  window_fold<T, D, kLog2>(w, part_o, part_ml, out, S, H);
  if (threadIdx.x == 0) *ticket = 0;
}

// A K or V tile of the bf16 kernel filled by the block's threads: key c <
// n_keys from the pool (int8 dequantized as dequant_kv does it), zeros past
// it; every load is issued before any store.
template <typename KV, int D>
__device__ __forceinline__ void window_fill(unsigned char* tile, const KV* pool,
                                            const bf16* scale, const int* pages,
                                            const WinBlock& w, int page_size, int H) {
  using W = Swz<D>;
  constexpr int N = Kv<bf16, KV>::N;                // elements a 16-byte load
  constexpr int LPK = D / N;                        // loads a key
  constexpr int U = kWinKeys * LPK / kWinThreads;  // loads a thread
  KvRaw<bf16, KV> raw[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = threadIdx.x + u * kWinThreads, c = i / LPK, li = i % LPK;
    if (c < w.n_keys) {
      const size_t v = window_vector(pages, w, c, page_size, H);
      raw[u].load(pool + v * D + li * N, scale + v);
    } else {
      raw[u].clear();
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int i = threadIdx.x + u * kWinThreads, c = i / LPK, li = i % LPK;
    float f[N];
    raw[u].unpack(f);
#pragma unroll
    for (int h8 = 0; h8 < N / 8; ++h8) {
      const uint4 chunk = make_uint4(pack_bf16(f[8 * h8], f[8 * h8 + 1]),
                                     pack_bf16(f[8 * h8 + 2], f[8 * h8 + 3]),
                                     pack_bf16(f[8 * h8 + 4], f[8 * h8 + 5]),
                                     pack_bf16(f[8 * h8 + 6], f[8 * h8 + 7]));
      *reinterpret_cast<uint4*>(tile + W::offset(kWinKeys, c, li * N + 8 * h8)) = chunk;
    }
  }
}

// (f32) a K or V tile [kWinKeys][D + 1] filled by the block's threads: key
// c < n_keys from the pool (int8 dequantized), zeros past it
template <typename KV, int D>
__device__ __forceinline__ void window_fill_f32(float* tile, const KV* pool, const bf16* scale,
                                                const int* pages, const WinBlock& w,
                                                int page_size, int H) {
  constexpr int N = Kv<float, KV>::N, LPK = D / N, kLd = D + 1;
  for (int i = threadIdx.x; i < kWinKeys * LPK; i += kWinThreads) {
    const int c = i / LPK, li = i % LPK;
    float f[N];
    if (c < w.n_keys) {
      const size_t v = window_vector(pages, w, c, page_size, H);
      Kv<float, KV>::load(pool + v * D + li * N, scale + v, f);
    } else {
#pragma unroll
      for (int e = 0; e < N; ++e) f[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < N; ++e) tile[c * kLd + li * N + e] = f[e];
  }
}

// round(round(x) / scale) in bf16 (the JAX kernel's score), dividing
// exactly: a power-of-two scale (D = 16, 64) by its reciprocal
__device__ __forceinline__ float window_score(float x, float scale, float inv, bool pow2) {
  x = round_to<bf16>(x);
  return round_to<bf16>(pow2 ? x * inv : x / scale);
}

template <typename T, typename KV, int D>
__global__ void __launch_bounds__(kWinThreads)
paged_window_kernel(const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const T* __restrict__ q,
                    const KV* __restrict__ pool_k, const KV* __restrict__ pool_v,
                    const bf16* __restrict__ k_scale, const bf16* __restrict__ v_scale,
                    const int* __restrict__ page_table, const int* __restrict__ cursors,
                    T* __restrict__ out, float* __restrict__ part_o,
                    float2* __restrict__ part_ml, int* __restrict__ tickets, int S, int H,
                    int page_size, int max_pages, int num_pages, int use_tma, float scale) {
  using G = WinSmem<T, D>;
  extern __shared__ unsigned char smem[];
  if (G::kBf16 && use_tma && threadIdx.x == 0) {
    tma_prefetch(&tm_k);
    tma_prefetch(&tm_v);
  }
  const int page = window_page_id(page_table, H, page_size, max_pages, num_pages);
  const WinBlock w(cursors, S, H, page_size, max_pages);
  if (w.parked) {
    if (w.split == 0) window_zeros<T, D>(w, out, S, H);
    return;
  }
  if (w.n_keys <= 0) return;  // a split past the tile's last visible key
  const int tid = threadIdx.x;

  if constexpr (G::kBf16) {
    using W = Swz<D>;
    const uint32_t base = align1024(smem_addr(smem));
    unsigned char* gen = smem + (base - smem_addr(smem));  // base as a generic pointer
    const uint32_t sq = base, sk = sq + G::kQ, sv = sk + G::kKV, bar_k = sv + G::kKV,
                   bar_v = bar_k + 8;
    int* pages = reinterpret_cast<int*>(gen + (bar_v + 8 - base));
    if (page >= 0) pages[tid] = page;
    if (use_tma && tid == 0) {
      mbar_init(bar_k, 1);
      mbar_init(bar_v, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    const int bs = window_box_rows(page_size), boxes = (w.n_keys + bs - 1) / bs;
    if (use_tma) {
      // warp 0: one copy per page (or page part) of K, then of V
      if (tid < 32) {
        if (tid == 0) {
          mbar_arrive_tx(bar_k, boxes * bs * D * 2);
          mbar_arrive_tx(bar_v, boxes * bs * D * 2);
        }
        __syncwarp();
        for (int i = tid; i < boxes; i += 32) {
          const int row = pages[i] * page_size + (w.k0 + i * bs) % page_size;
#pragma unroll
          for (int box = 0; box < W::kBoxes; ++box)
            tma_load_2d(sk + box * kWinKeys * W::kRow + i * bs * W::kRow, &tm_k, bar_k,
                        w.h * D + box * W::kCols, row);
        }
        for (int i = tid; i < boxes; i += 32) {
          const int row = pages[i] * page_size + (w.k0 + i * bs) % page_size;
#pragma unroll
          for (int box = 0; box < W::kBoxes; ++box)
            tma_load_2d(sv + box * kWinKeys * W::kRow + i * bs * W::kRow, &tm_v, bar_v,
                        w.h * D + box * W::kCols, row);
        }
      }
      // V rows no copy fills: zeros
      const int filled = boxes * bs;
      constexpr int kChunks = W::kRow / 16;  // 16-byte chunks of a box row
      for (int i = tid; i < (kWinKeys - filled) * kChunks * W::kBoxes; i += kWinThreads) {
        const int box = i / ((kWinKeys - filled) * kChunks);
        const int rest = i % ((kWinKeys - filled) * kChunks);
        *reinterpret_cast<uint4*>(gen + (sv - base) + box * kWinKeys * W::kRow +
                                  (filled + rest / kChunks) * W::kRow + (rest % kChunks) * 16) =
            make_uint4(0u, 0u, 0u, 0u);
      }
    } else {
      window_fill<KV, D>(gen + (sk - base), pool_k, k_scale, pages, w, page_size, H);
    }
    // Q's rows of the tile (zeros past S)
    {
      constexpr int LPK = D / 8, U = kWinRows * LPK / kWinThreads;
      uint4 qv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = tid + u * kWinThreads, r = i / LPK, li = i % LPK;
        qv[u] = r < w.rows ? *reinterpret_cast<const uint4*>(q + w.out_row(S, H, D, r) + li * 8)
                           : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = tid + u * kWinThreads, r = i / LPK, li = i % LPK;
        *reinterpret_cast<uint4*>(gen + W::offset(kWinRows, r, li * 8)) = qv[u];
      }
    }
    fence_proxy_async();
    __syncthreads();
    if (use_tma) mbar_wait(bar_k, 0);

    float s[kWinKeys / 2];  // S = Q·Kᵀ: rows r0, r0 + 8 of the tile (wgmma layout)
#pragma unroll
    for (int i = 0; i < kWinKeys / 2; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<kWinKeys>::ss(s, W::k_major(sq, kWinRows, 0, kk), W::k_major(sk, kWinKeys, 0, kk), kk);
    wgmma_commit();
    if (!use_tma) {  // V's tile while S is in flight
      window_fill<KV, D>(gen + (sv - base), pool_v, v_scale, pages, w, page_size, H);
      fence_proxy_async();
      __syncthreads();
    }
    wgmma_wait<0>();
    fence_regs<kWinKeys / 2>(s);

    const int lane = tid & 31, t = lane & 3;
    const int r0 = (tid >> 5) * 16 + (lane >> 2);  // this thread's rows r0, r0 + 8
    const int vis[2] = {w.last_key(r0), w.last_key(r0 + 8)};
    const float inv = 1.f / scale;
    const bool pow2 = (__float_as_uint(scale) & 0x7fffffu) == 0;
    float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
    for (int i = 0; i < kWinKeys / 2; ++i) {
      const int c = 8 * (i >> 2) + 2 * t + (i & 1), rr = (i >> 1) & 1;
      s[i] = c <= vis[rr] ? window_score(s[i], scale, inv, pow2) : -CUDART_INF_F;
      mx[rr] = fmaxf(mx[rr], s[i]);
    }
    float m2[2], l[2] = {0.f, 0.f};  // the split's row max (exp2 domain) and sum
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) m2[rr] = fmaxf(quad_max(mx[rr]) * kLog2e, kBigNeg);
#pragma unroll
    for (int i = 0; i < kWinKeys / 2; ++i) {
      s[i] = fast_exp2(fmaf(s[i], kLog2e, -m2[(i >> 1) & 1]));
      l[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) l[rr] = quad_sum(l[rr]);
    // a tile that one split covers knows its rows' sums now: it rounds the
    // normalised p, as the JAX kernel does, and its P·V is the output
    const bool single = w.n_live == 1;
    if (single) {
      const float il[2] = {1.f / l[0], 1.f / l[1]};
#pragma unroll
      for (int i = 0; i < kWinKeys / 2; ++i) s[i] *= il[(i >> 1) & 1];
    }
    uint32_t p[kWinKeys / 4];  // P in bf16: the A operand of 8 k-steps
#pragma unroll
    for (int i = 0; i < kWinKeys / 4; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
    if (use_tma) mbar_wait(bar_v, 0);
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWinKeys / 16; ++kk)
      Wgmma<D>::rs_t(acc, p + 4 * kk, W::mn_major(sv, kWinKeys, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<D / 2>(acc);
    fence_regs<kWinKeys / 4>(p);

    const size_t pidx = w.part(w.split) * kWinRows;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = r0 + 8 * rr;
      if (r >= w.rows) continue;
      if (single) {
        T* dst = out + w.out_row(S, H, D, r) + 2 * t;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<uint32_t*>(dst + 8 * j) =
              pack_bf16(acc[4 * j + 2 * rr], acc[4 * j + 2 * rr + 1]);
      } else {
        float* dst = part_o + (pidx + r) * D + 2 * t;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<float2*>(dst + 8 * j) =
              make_float2(acc[4 * j + 2 * rr], acc[4 * j + 2 * rr + 1]);
        if (t == 0) part_ml[pidx + r] = make_float2(m2[rr], l[rr]);
      }
    }
    if (single) return;
    window_finish<T, D, true>(w, part_o, part_ml, tickets, out, S, H);
  } else {
    constexpr int kLd = G::kLd, kPs = G::kPStride, DC = D / 16;
    float* qs = reinterpret_cast<float*>(smem);  // [64][kLd]
    float* ks = qs + kWinRows * kLd;             // [128][kLd]
    float* vs = ks + kWinKeys * kLd;             // [128][kLd]
    float* ps = vs + kWinKeys * kLd;             // [64][kPs]: P
    int* pages = reinterpret_cast<int*>(ps + kWinRows * kPs);
    if (page >= 0) pages[tid] = page;
    __syncthreads();
    window_fill_f32<KV, D>(ks, pool_k, k_scale, pages, w, page_size, H);
    window_fill_f32<KV, D>(vs, pool_v, v_scale, pages, w, page_size, H);
    for (int i = tid; i < kWinRows * D / 4; i += kWinThreads) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      float f[4] = {0.f, 0.f, 0.f, 0.f};
      if (r < w.rows)
        Vec<float>::load(reinterpret_cast<const float*>(q) + w.out_row(S, H, D, r) + c, f);
#pragma unroll
      for (int e = 0; e < 4; ++e) qs[r * kLd + c + e] = f[e];
    }
    __syncthreads();
    // S: rows 8·tr + i, keys tc + 16·u
    const int tr = tid >> 4, tc = tid & 15;
    float sc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int u = 0; u < 8; ++u) sc[i][u] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[8], kv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) qv[i] = qs[(8 * tr + i) * kLd + d];
#pragma unroll
      for (int u = 0; u < 8; ++u) kv[u] = ks[(tc + 16 * u) * kLd + d];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int u = 0; u < 8; ++u) sc[i][u] = fmaf(qv[i], kv[u], sc[i][u]);
    }
    float m[8], l[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int vis = w.last_key(8 * tr + i);
      float mx = -CUDART_INF_F;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        sc[i][u] = tc + 16 * u <= vis ? sc[i][u] / scale : -CUDART_INF_F;
        mx = fmaxf(mx, sc[i][u]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      m[i] = fmaxf(mx, kBigNeg);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const float e = expf(sc[i][u] - m[i]);
        ps[(8 * tr + i) * kPs + tc + 16 * u] = e;
        sum += e;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = sum;
    }
    __syncthreads();
    // O = P·V: rows 8·tr + i, columns tc + 16·e
    float o[8][DC];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < DC; ++e) o[i][e] = 0.f;
    for (int c = 0; c < kWinKeys; ++c) {
      float pv[8], vv[DC];
#pragma unroll
      for (int i = 0; i < 8; ++i) pv[i] = ps[(8 * tr + i) * kPs + c];
#pragma unroll
      for (int e = 0; e < DC; ++e) vv[e] = vs[c * kLd + tc + 16 * e];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < DC; ++e) o[i][e] = fmaf(pv[i], vv[e], o[i][e]);
    }
    const bool single = w.n_live == 1;
    const size_t pidx = w.part(w.split) * kWinRows;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = 8 * tr + i;
      if (r >= w.rows) continue;
      if (single) {
        T* dst = out + w.out_row(S, H, D, r);
#pragma unroll
        for (int e = 0; e < DC; ++e) dst[tc + 16 * e] = from_f<T>(o[i][e] / l[i]);
      } else {
#pragma unroll
        for (int e = 0; e < DC; ++e) part_o[(pidx + r) * D + tc + 16 * e] = o[i][e];
        if (tc == 0) part_ml[pidx + r] = make_float2(m[i], l[i]);
      }
    }
    if (single) return;
    window_finish<T, D, false>(w, part_o, part_ml, tickets, out, S, H);
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// A kernel's workspace, one buffer: a ticket per row the splits fold into
// (int32, zero between launches: the last split resets it), then each
// split's (m_i, l_i) (float2) and un-normalised o_i (D f32) of every row.
// The decode kernel's rows are (slot, head).
struct Workspace {
  size_t ml, o, bytes;  // byte offsets of the stats and partials; the size
};

Workspace decode_workspace(int B, int H, int D, int page_size, int max_pages) {
  const size_t rows = static_cast<size_t>(B) * H;
  const size_t parts = rows * decode_splits(page_size, max_pages);
  Workspace w;
  w.ml = (4 * rows + 15) / 16 * 16;
  w.o = w.ml + 8 * parts;
  w.bytes = w.o + 4 * parts * D;
  return w;
}

// The window kernel's: a ticket per (slot, head, query tile), partials
// per (tile, split, query row).
Workspace window_workspace(int B, int S, int H, int D, int page_size, int max_pages) {
  const size_t tiles = static_cast<size_t>(B) * H * ((S + kWinRows - 1) / kWinRows);
  const size_t parts = tiles * window_splits(page_size, max_pages) * kWinRows;
  Workspace w;
  w.ml = (4 * tiles + 15) / 16 * 16;
  w.o = w.ml + 8 * parts;
  w.bytes = w.o + 4 * parts * D;
  return w;
}

// A 2-D map over a pool [num_pages, page_size, H, D] of bf16 viewed as
// [num_pages · page_size, H · D], whose box is `rows` rows of one head
// (Swz<D>::kCols columns), swizzled as Swz<D> reads it.
template <int D>
cudaError_t pool_map(CUtensorMap* map, const void* pool, int num_pages, int page_size, int H,
                     int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(H) * D,
                              static_cast<cuuint64_t>(num_pages) * page_size};
  const cuuint64_t strides[1] = {2ull * H * D};  // bytes
  const cuuint32_t box[2] = {Swz<D>::kCols, static_cast<cuuint32_t>(rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(pool), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      D == 16 ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
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
  // both grids follow S and max_pages, never the cursors: no host read, so
  // a launch can be captured in a CUDA graph
  if (a.workspace == nullptr) return cudaErrorInvalidValue;
  unsigned char* ws = static_cast<unsigned char*>(a.workspace);
  if (a.S == 1) {
    const Workspace w = decode_workspace(a.B, a.H, D, a.ps, a.mp);
    paged_decode_kernel<T, KV, D>
        <<<dim3(a.B, a.H, decode_splits(a.ps, a.mp)), kDecThreads, 0, a.stream>>>(
            static_cast<const T*>(a.q), static_cast<const KV*>(a.pk),
            static_cast<const KV*>(a.pv), a.ks, a.vs, a.pt, a.cur, static_cast<T*>(a.out),
            reinterpret_cast<float*>(ws + w.o), reinterpret_cast<float2*>(ws + w.ml),
            reinterpret_cast<int*>(ws), a.ps, a.mp, a.np, decode_pages_per_split(a.ps),
            a.scale);
    return cudaGetLastError();
  }
  // a page over 128 keys is cut into 128-key parts: it must hold whole ones
  if (a.ps > kWinKeys && a.ps % kWinKeys) return cudaErrorInvalidValue;
  const Workspace w = window_workspace(a.B, a.S, a.H, D, a.ps, a.mp);
  CUtensorMap tk{}, tv{};
  int use_tma = 0;
  cudaError_t err;
  // full-width bf16 pages come by TMA, one box a page (or page part), when
  // a box is whole swizzle atoms (8 rows)
  if constexpr (sizeof(T) == 2 && sizeof(KV) == 2) {
    const int rows = window_box_rows(a.ps);
    if (rows % 8 == 0) {
      if ((err = pool_map<D>(&tk, a.pk, a.np, a.ps, a.H, rows)) != cudaSuccess ||
          (err = pool_map<D>(&tv, a.pv, a.np, a.ps, a.H, rows)) != cudaSuccess)
        return err;
      use_tma = 1;
    }
  }
  const size_t smem = WinSmem<T, D>::kBytes;
  if ((err = allow_smem(paged_window_kernel<T, KV, D>, smem)) != cudaSuccess) return err;
  const dim3 grid(window_splits(a.ps, a.mp), (a.S + kWinRows - 1) / kWinRows, a.B * a.H);
  paged_window_kernel<T, KV, D><<<grid, kWinThreads, smem, a.stream>>>(
      tk, tv, static_cast<const T*>(a.q), static_cast<const KV*>(a.pk),
      static_cast<const KV*>(a.pv), a.ks, a.vs, a.pt, a.cur, static_cast<T*>(a.out),
      reinterpret_cast<float*>(ws + w.o), reinterpret_cast<float2*>(ws + w.ml),
      reinterpret_cast<int*>(ws), a.S, a.H, a.ps, a.mp, a.np, use_tma, a.scale);
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

}  // namespace

extern "C" {

// dtype (the compute dtype of q and out): 0 = float32, 1 = bfloat16.
// kv_dtype (the pools' storage): 0 = float32, 1 = bfloat16 (each equal to
// dtype), 2 = int8 with bf16 scales k_scale/v_scale [num_pages,
// page_size, H, 1] (null otherwise). q/out [B, S, H, D]; pools
// [num_pages, page_size, H, D]; page_table [B, max_pages] int32; cursors
// [B] int32; all contiguous and 16-byte aligned on the current device.
// `scale` is sqrt(D) rounded to the compute dtype. S == 1 launches
// paged_decode_kernel, S > 1 paged_window_kernel (a page_size over 128
// must be a multiple of 128); both need `workspace`:
// kft_paged_attention_workspace bytes on the device, zeroed before the
// first launch that uses it and left zeroed by every launch, used by one
// stream at a time. Returns cudaGetLastError() after the launch; neither
// allocates or synchronises.
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

// workspace bytes an S-row launch needs
size_t kft_paged_attention_workspace(int S, int B, int H, int D, int page_size,
                                     int max_pages) {
  return S == 1 ? decode_workspace(B, H, D, page_size, max_pages).bytes
                : window_workspace(B, S, H, D, page_size, max_pages).bytes;
}

const char* kft_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
