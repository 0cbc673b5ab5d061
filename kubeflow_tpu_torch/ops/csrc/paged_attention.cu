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
// in the compute dtype, the softmax runs in f32 and the probabilities are
// rounded to the compute dtype before P·V (f32 accumulation, one final
// rounding).
//
// What bounds them: decode is bound by bytes. Each step reads every live
// K and V vector of every slot once (2 · n_keys · H · D elements per slot;
// D + 2 bytes a vector in int8, 2D in bf16) and does 4 flops per element
// read (5 with the dequant), far below the ~295 flops per byte
// the H100 needs before its arithmetic is the limit. The design reads
// each live vector exactly once per (slot, head) block, walks only the
// pages up to the row's last visible position (a page-table entry past
// it may be stale and is never dereferenced), and keeps the row's scores
// in shared memory (max_len f32, 4 KB at 1024) instead of device memory.
// Since a walk is a chain of dependent loads (table entry, then vector),
// what the design does about the bytes is keep many of them in flight:
// each key is read as 16-byte vectors by a few neighbouring lanes, so a
// 256-thread block walks 8 to 256 keys at once (32 at bf16, D=64; 64 at
// int8, D=64, where four lanes hold a key), with kUnroll loads in flight
// for each. An int8 key costs one more 2-byte load per lane: its scale.
//
// What this simple design leaves on the table (later work): one block
// per (slot, head) gives B·H blocks, 96 at 8 slots x 12 heads, fewer than
// the 132 SMs, and one long row serializes its whole walk in one block;
// split-K over pages with a combine pass (flash-decoding) would spread
// it over the card. Nothing overlaps the page loads with compute beyond
// kUnroll (no cp.async/TMA pipeline). The window kernel does its products
// on CUDA cores; wgmma would serve it at s = 64.

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
  __device__ __forceinline__ static void load(const float* p, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* f) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
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
  __device__ __forceinline__ static void load(const int8_t* p,
                                              const __nv_bfloat16* scale, float* f) {
    const float sc = __bfloat162float(*scale);
    const int4 v = *reinterpret_cast<const int4*>(p);
    const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
    for (int i = 0; i < N; ++i) f[i] = round_to<T>(static_cast<float>(b[i]) * sc);
  }
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

// block-wide reductions through `red` [kWarps]; every thread gets the result
__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) r = fmaxf(r, red[i]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) r += red[i];
  __syncthreads();
  return r;
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

// Thread layout shared by both kernels: a key's D elements are read as
// LPK = D / N 16-byte vectors by LPK neighbouring lanes (a "lane group";
// N = Kv<T, KV>::N elements a load: 4 f32, 8 bf16, 16 int8);
// the block's G = kThreads / LPK lane groups each take one key, and each
// loads kUnroll keys before computing. Loops step a warp-uniform base so
// every lane of a warp runs the same iterations (the shuffles need it).

// ---------------------------------------------------------------------------
// s == 1: one block per (slot, head). Three phases over the row's
// n_keys = min(cursor, L - 1) + 1 visible keys: scores, f32 softmax, P·V.
// ---------------------------------------------------------------------------
template <typename T, typename KV, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const KV* __restrict__ pool_k,
                    const KV* __restrict__ pool_v,
                    const __nv_bfloat16* __restrict__ k_scale,
                    const __nv_bfloat16* __restrict__ v_scale,
                    const int* __restrict__ page_table,
                    const int* __restrict__ cursors, T* __restrict__ out,
                    int page_size, int max_pages, int num_pages, float scale) {
  constexpr int N = Kv<T, KV>::N;
  constexpr int LPK = D / N;
  constexpr int KPW = 32 / LPK;      // lane groups per warp
  constexpr int G = kThreads / LPK;  // lane groups per block
  extern __shared__ float smem[];
  const int view_len = max_pages * page_size;
  float* scores = smem;             // [view_len]
  float* part = scores + view_len;  // [G][D]
  __shared__ float red[kWarps];

  const int b = blockIdx.x, h = blockIdx.y, H = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int sub = (tid & 31) / LPK, li = tid % LPK, g = tid / LPK;
  int cur = cursors[b];
  cur = cur < 0 ? 0 : cur;
  const size_t qo = (static_cast<size_t>(b) * H + h) * D;
  // a parked row (cursor past the window: an idle or retired slot) is
  // never read; it writes zeros and walks nothing
  if (cur >= view_len) {
    for (int d = tid; d < D; d += kThreads) out[qo + d] = from_f<T>(0.f);
    return;
  }
  const int n_keys = cur + 1;
  const int* pt = page_table + static_cast<size_t>(b) * max_pages;

  float qv[N];
  load_n<T, N>(q + qo + li * N, qv);

  for (int base = warp * KPW; base < n_keys; base += G * kUnroll) {
    float kf[kUnroll][N];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + sub + u * G;
      if (t < n_keys) {
        const size_t row = kv_row(pt, t, page_size, num_pages, H, h);
        Kv<T, KV>::load(pool_k + row * D + li * N, k_scale + row, kf[u]);
      } else {
#pragma unroll
        for (int i = 0; i < N; ++i) kf[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < N; ++i) acc += qv[i] * kf[u][i];
      acc = group_sum<LPK>(acc);
      const int t = base + sub + u * G;
      if (li == 0 && t < n_keys) scores[t] = round_to<T>(round_to<T>(acc) / scale);
    }
  }
  __syncthreads();

  float m = -CUDART_INF_F;
  for (int t = tid; t < n_keys; t += kThreads) m = fmaxf(m, scores[t]);
  m = block_max(m, red);
  float s = 0.f;
  for (int t = tid; t < n_keys; t += kThreads) {
    const float e = expf(scores[t] - m);
    scores[t] = e;
    s += e;
  }
  s = block_sum(s, red);
  for (int t = tid; t < n_keys; t += kThreads)
    scores[t] = round_to<T>(scores[t] / s);
  __syncthreads();

  float acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
  for (int base = warp * KPW; base < n_keys; base += G * kUnroll) {
    float vf[kUnroll][N];
    float p[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + sub + u * G;
      p[u] = 0.f;
      if (t < n_keys) {
        p[u] = scores[t];
        const size_t row = kv_row(pt, t, page_size, num_pages, H, h);
        Kv<T, KV>::load(pool_v + row * D + li * N, v_scale + row, vf[u]);
      } else {
#pragma unroll
        for (int i = 0; i < N; ++i) vf[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int i = 0; i < N; ++i) acc[i] += p[u] * vf[u][i];
    }
  }
#pragma unroll
  for (int i = 0; i < N; ++i) part[g * D + li * N + i] = acc[i];
  __syncthreads();
  for (int d = tid; d < D; d += kThreads) {
    float o = 0.f;
#pragma unroll 8
    for (int gg = 0; gg < G; ++gg) o += part[gg * D + d];
    out[qo + d] = from_f<T>(o);
  }
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

// dynamic shared memory of a launch; n = elements per 16-byte K/V load
size_t decode_smem(int view_len, int n) {
  return sizeof(float) * (static_cast<size_t>(view_len) + kThreads * n);
}

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
  cudaStream_t stream;
};

template <typename T, typename KV, int D>
cudaError_t launch(const Args& a) {
  const int view_len = a.ps * a.mp;
  constexpr int n = Kv<T, KV>::N;
  cudaError_t err;
  if (a.S == 1) {
    const size_t smem = decode_smem(view_len, n);
    if ((err = allow_smem(paged_decode_kernel<T, KV, D>, smem)) != cudaSuccess) return err;
    paged_decode_kernel<T, KV, D><<<dim3(a.B, a.H), kThreads, smem, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const KV*>(a.pk),
        static_cast<const KV*>(a.pv), a.ks, a.vs, a.pt, a.cur,
        static_cast<T*>(a.out), a.ps, a.mp, a.np, a.scale);
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
// rounded to the compute dtype. S == 1 launches paged_decode_kernel,
// S > 1 paged_window_kernel. Returns cudaGetLastError() after the launch.
int kft_paged_attention(const void* q, const void* pool_k, const void* pool_v,
                        const void* k_scale, const void* v_scale,
                        const void* page_table, const void* cursors, void* out,
                        int B, int S, int H, int D, int page_size, int max_pages,
                        int num_pages, int dtype, int kv_dtype, float scale,
                        void* stream) {
  const Args a{q, pool_k, pool_v,
               static_cast<const __nv_bfloat16*>(k_scale),
               static_cast<const __nv_bfloat16*>(v_scale),
               static_cast<const int*>(page_table), static_cast<const int*>(cursors),
               out, B, S, H, page_size, max_pages, num_pages, scale,
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
size_t kft_paged_attention_smem(int S, int view_len, int D, int dtype, int kv_dtype) {
  const int n = kv_elems(dtype, kv_dtype);
  return S == 1 ? decode_smem(view_len, n) : window_smem(view_len, D, n);
}

const char* kft_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
