// Flash attention forward and backward for Hopper (sm_90a), behind a plain
// C interface loaded with ctypes (kubeflow_tpu_torch/native/build.py).
// Three kernels, one per TPU kernel body of kubeflow_tpu/ops/flash_attention.py:
//
//   flash_fwd      replaces `_fwd_kernel` (blockwise online-softmax
//                  attention: o in the input dtype, f32 lse = m + log l)
//   flash_bwd_dq   replaces `_bwd_dq_kernel` (dQ = scale · Σ_k dS·K)
//   flash_bwd_dkv  replaces `_bwd_dkv_kernel` (dV = Σ_q Pᵀ·dO,
//                  dK = scale · Σ_q dSᵀ·Q)
//
// each in a bf16 version on the tensor cores and an f32 version on the CUDA
// cores.
//
// Semantics (the Pallas kernels', not their tiling): scores are q·kᵀ
// accumulated in f32 and multiplied by `scale` in f32, never rounded to the
// compute dtype; a masked score (key-padding mask, causal triangle, or a key
// past S) contributes p = 0 exactly; o = acc / max(l, 1e-30) and
// lse = m + log(max(l, 1e-30)), so a row with no visible key gives o = 0 and
// lse ≈ -1e30. p is rounded to v's dtype before P·V; dS is rounded to k's
// dtype before dS·K and to q's dtype before dSᵀ·Q; P to dO's dtype before
// Pᵀ·dO. Every accumulator is f32; outputs are in the input dtype. The
// backward recomputes P = exp(scale·q·kᵀ − lse) from the forward's lse and
// takes delta = rowsum(dO∘O) − dlse precomputed by the wrapper.
//
// Layout: q, k, v, o, dO, dQ, dK, dV are contiguous [B, S, H, D] and are
// read in place (row (b, s, h) at ((b·S + s)·H + h)·D), so the model's
// projections need no transpose copy; lse and delta are [B, H, S] f32; the
// optional key mask is [B, S] int32. Any S works: keys and queries past S
// are masked inside the kernels, so nothing is padded to a tile multiple.
//
// Design. One block of 4 warps per (tile, b·h). The forward and dQ
// kernels own a tile of q rows and walk the k tiles up to the diagonal
// under causal (the skipped tiles cost neither loads nor math); the dK/dV
// kernel owns a tile of keys and walks the q tiles from the first one that
// sees it. This is the TPU kernels' two-kernel split: no atomics,
// deterministic gradients. Causal q tiles launch heaviest first. Tiles are
// copied with 16-byte vectors into padded shared memory. `causal` and the
// key mask are runtime flags (warp-uniform branches), so nvcc builds 6
// instances per kernel, not 24.
//
// - bf16 (the training path): 64-row tiles, each warp owning a strip of 16
//   rows. Products run as mma.sync m16n8k16 (bf16 in, f32 accumulate) with
//   the accumulators in registers: the strip's scores, its probabilities
//   (re-packed from the accumulator layout straight into the next
//   product's A operand, never stored), its online-softmax state (two rows
//   a thread, reduced over the 4 threads of a quad) and its output or
//   gradient accumulators. Shared memory holds only the q/k/v/dO tiles;
//   the walked ones are double-buffered, the next tile streaming in with
//   cp.async while the current one is computed.
// - f32: 32-row tiles on the CUDA cores (a register tile of outputs per
//   thread), scores and accumulators staged in shared memory.
//
// What bounds it: at gpt_small's training shapes (B = 2, H = 12, S = 4096,
// D = 64, causal) the work is bound by operations, not bytes: the forward
// does ½·4·B·H·S²·D = 51.5 GFLOP on 25 MB of q/k/v/o (~2000 flops a byte,
// far past the H100's ~295). What this design leaves on the table: wgmma
// (the only path to the card's full bf16 rate; mma.sync reaches a fraction
// of it), TMA with a deeper mbarrier pipeline and warp specialisation (here
// one tile in flight, and every warp both loads and computes), and a
// persistent schedule that balances the causal triangle's uneven tiles
// across SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kBigNeg = -1e30f;  // the Pallas kernels' BIG_NEG
constexpr int kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// over the 4 threads of a quad (the threads holding one accumulator row)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// Copy rows [row0, row0 + BT) of one (b, h) slice of a [B, S, H, D] tensor
// into shared memory ([BT][LD]); rows past S are zeros.
template <typename T, int D, int BT, int LD>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int row0, int S,
                                          int row_stride) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < BT * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < S)
      val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// whether key kj of batch row b exists and is not padding
__device__ __forceinline__ int key_valid(const int* mask, int b, int kj, int S) {
  return kj < S && (mask == nullptr || mask[static_cast<size_t>(b) * S + kj] != 0);
}

// Which keys of the tile at k0 exist and are not padding: keymask[c] = 1.
template <int BT>
__device__ __forceinline__ void load_key_mask(int* keymask, const int* mask, int b, int k0,
                                              int S) {
  for (int c = threadIdx.x; c < BT; c += kThreads) keymask[c] = key_valid(mask, b, k0 + c, S);
}

// cp.async: 16 bytes global → shared without a register round trip,
// zero-filled when `valid` is false (rows past S)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most one committed group (the newest) is still in flight
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// load_rows with cp.async (the caller commits and waits)
template <int D, int BT, int LD>
__device__ __forceinline__ void load_rows_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                int row0, int S, int row_stride) {
  constexpr int kPerRow = D / 8;
  for (int i = threadIdx.x; i < BT * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * 8;
    const bool valid = row0 + r < S;
    cp_async16(dst + r * LD + c,
               src + (valid ? static_cast<size_t>(row0 + r) * row_stride + c : 0), valid);
  }
}

// per-(b, h, row) f32 values ([B, H, S]) of rows [row0, row0 + BT); 0 past S
template <int BT>
__device__ __forceinline__ void load_row_values(float* dst, const float* src, int bh,
                                                int row0, int S) {
  for (int r = threadIdx.x; r < BT; r += kThreads)
    dst[r] = row0 + r < S ? src[static_cast<size_t>(bh) * S + row0 + r] : 0.f;
}

// ===========================================================================
// bf16: mma.sync m16n8k16 with register accumulators
// ===========================================================================
//
// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16; g = lane / 4, t = lane % 4):
//   A 16×16: a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g, 2t+8..), a3 = (g+8, 2t+8..)
//   B 16×8:  b0 = (k 2t..2t+1, n g), b1 = (k 2t+8..2t+9, n g)
//   C 16×8:  c0, c1 = (g, 2t), (g, 2t+1); c2, c3 = (g+8, 2t), (g+8, 2t+1)
// Each 32-bit register holds two bf16, the lower index in the low half.

constexpr int kTile16 = 64;  // rows of a bf16 tile: 4 warps × 16

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ldmatrix: each of the first 8·N lanes gives the shared address of one
// 8-element row (lanes 8i..8i+7: matrix i); lane l receives matrix i's
// elements (l / 4, 2·(l % 4)..+1), or with .trans (2·(l % 4)..+1, l / 4)
__device__ __forceinline__ uint32_t smem_addr(const bf16* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// A operand: rows [r0, r0 + 16) × k columns [16·kk, 16·kk + 16) of a
// row-major shared tile X[·][LD]; matrices (rows +0/+8) × (cols +0/+8) in
// the order a0..a3
template <int LD>
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* X, int r0, int kk) {
  const int lane = threadIdx.x & 31, i = lane >> 3;
  ldmatrix_x4(a, X + (r0 + (lane & 7) + 8 * (i & 1)) * LD + 16 * kk + 8 * (i >> 1));
}

// B operands of n-blocks j and j+1 with B(k, n) = Y[n][k] (the transposed
// side of a q·kᵀ-type product), k rows [16·kk, 16·kk + 16): b[0..1] for
// n-block j, b[2..3] for j + 1
template <int LD>
__device__ __forceinline__ void load_b_rows2(uint32_t* b, const bf16* Y, int j, int kk) {
  const int lane = threadIdx.x & 31, i = lane >> 3;
  ldmatrix_x4(b, Y + (8 * (j + (i >> 1)) + (lane & 7)) * LD + 16 * kk + 8 * (i & 1));
}

// B operands of n-blocks j and j+1 with B(k, n) = Z[k][n] (a P·V-type
// product), k rows [16·kk, 16·kk + 16): b[0..1] for j, b[2..3] for j + 1
template <int LD>
__device__ __forceinline__ void load_b_cols2(uint32_t* b, const bf16* Z, int kk, int j) {
  const int lane = threadIdx.x & 31, i = lane >> 3;
  ldmatrix_x4_trans(b, Z + (16 * kk + 8 * (i & 1) + (lane & 7)) * LD + 8 * (j + (i >> 1)));
}

// acc[NB][4] = strip(A rows r0..r0+15 of X) · Yᵀ over K = D (Y has 8·NB rows)
template <int D, int NB, int LD>
__device__ __forceinline__ void strip_abt(float (*acc)[4], const bf16* X, int r0,
                                          const bf16* Y) {
#pragma unroll
  for (int j = 0; j < NB; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    load_a<LD>(a, X, r0, kk);
#pragma unroll
    for (int j = 0; j < NB; j += 2) {
      uint32_t b[4];
      load_b_rows2<LD>(b, Y, j, kk);
      mma_bf16(acc[j], a, b);
      mma_bf16(acc[j + 1], a, b + 2);
    }
  }
}

// out[D/8][4] += P · Z, where P (16 × 8·NB, f32 accumulator layout) is
// rounded to bf16 and re-packed as A operands, Z = Z[k][d] in shared memory
template <int D, int NB, int LD>
__device__ __forceinline__ void strip_pv(float (*out)[4], float (*p)[4], const bf16* Z) {
#pragma unroll
  for (int kk = 0; kk < NB / 2; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    a[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    a[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
    for (int j = 0; j < D / 8; j += 2) {
      uint32_t b[4];
      load_b_cols2<LD>(b, Z, kk, j);
      mma_bf16(out[j], a, b);
      mma_bf16(out[j + 1], a, b + 2);
    }
  }
}

// write a strip's accumulator rows (times mul, or divided per row) as bf16
// rows `rows[0..1]` of one (b, h) slice
template <int D>
__device__ __forceinline__ void store_strip(bf16* dst, float (*acc)[4], const int* rows,
                                            int S, int row_stride, const float* mul) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= S) continue;
    bf16* row = dst + static_cast<size_t>(rows[r]) * row_stride + 2 * t;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j) =
          pack_bf16(acc[j][2 * r] * mul[r], acc[j][2 * r + 1] * mul[r]);
  }
}

// The walked tiles are double-buffered: tile i + 1 streams in (cp.async)
// while tile i is computed.
template <int D>
struct Geo16 {
  static constexpr int LD = D + 8;  // 16 bytes of padding a row
  static constexpr size_t kTile = sizeof(bf16) * kTile16 * LD;
  static constexpr size_t kRow = sizeof(float) * kTile16;
  static constexpr size_t kFwdSmem = 5 * kTile + 2 * kRow;  // Q, K×2, V×2 | keymask×2
  static constexpr size_t kDqSmem = 6 * kTile + 2 * kRow;   // Q, dO, K×2, V×2 | keymask×2
  // K, V, Q×2, dO×2 | lse×2, delta×2, keymask
  static constexpr size_t kDkvSmem = 6 * kTile + 5 * kRow;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const int* __restrict__ mask,
               bf16* __restrict__ o, float* __restrict__ lse, int S, int H, float scale,
               int causal) {
  constexpr int BT = kTile16, LD = Geo16<D>::LD, NB = BT / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Kbuf = Qs + BT * LD;        // [2][BT][LD]
  bf16* Vbuf = Kbuf + 2 * BT * LD;  // [2][BT][LD]
  int* kmbuf = reinterpret_cast<int*>(Vbuf + 2 * BT * LD);  // [2][BT]

  const int n_tiles = (S + BT - 1) / BT;
  const int qt = n_tiles - 1 - static_cast<int>(blockIdx.x);  // heaviest first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = qt * BT, row_stride = H * D;
  const size_t base = (static_cast<size_t>(b) * S * H + h) * D;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;
  const int rows[2] = {q0 + r0 + g, q0 + r0 + g + 8};

  load_rows_async<D, BT, LD>(Qs, q + base, q0, S, row_stride);
  load_rows_async<D, BT, LD>(Kbuf, k + base, 0, S, row_stride);
  load_rows_async<D, BT, LD>(Vbuf, v + base, 0, S, row_stride);
  cp_async_commit();
  load_key_mask<BT>(kmbuf, mask, b, 0, S);
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m[2] = {kBigNeg, kBigNeg}, l[2] = {0.f, 0.f};
  const int n_kt = causal ? qt + 1 : n_tiles;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BT, cur = kt & 1;
    const bool more = kt + 1 < n_kt;
    int km_next = 0;
    if (more) {  // the next tile streams in while this one is computed
      load_rows_async<D, BT, LD>(Kbuf + (cur ^ 1) * BT * LD, k + base, k0 + BT, S, row_stride);
      load_rows_async<D, BT, LD>(Vbuf + (cur ^ 1) * BT * LD, v + base, k0 + BT, S, row_stride);
      if (threadIdx.x < BT) km_next = key_valid(mask, b, k0 + BT + threadIdx.x, S);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const bf16* Ks = Kbuf + cur * BT * LD;
    const bf16* Vs = Vbuf + cur * BT * LD;
    const int* keymask = kmbuf + cur * BT;
    float s[NB][4];
    strip_abt<D, NB, LD>(s, Qs, r0, Ks);  // S = Q·Kᵀ
    uint32_t live = 0;  // bit 4·j + e: score (j, e) is visible
    float mx[2] = {kBigNeg, kBigNeg};
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        const bool vis = keymask[c] && (!causal || k0 + c <= rows[e >> 1]);
        live |= static_cast<uint32_t>(vis) << (4 * j + e);
        s[j][e] = vis ? s[j][e] * scale : kBigNeg;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = (live >> (4 * j + e)) & 1u ? expf(s[j][e] - m[e >> 1]) : 0.f;
        sum[e >> 1] += s[j][e];
      }
    }
    // per-thread partial row sums: alpha is the same on the whole quad
    l[0] = l[0] * alpha[0] + sum[0];
    l[1] = l[1] * alpha[1] + sum[1];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[0];
      acc[j][2] *= alpha[1];
      acc[j][3] *= alpha[1];
    }
    strip_pv<D, NB, LD>(acc, s, Vs);  // O += P·V
    if (more && threadIdx.x < BT) kmbuf[(cur ^ 1) * BT + threadIdx.x] = km_next;
    __syncthreads();  // buffer `cur` is free for tile kt + 2
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = fmaxf(quad_sum(l[r]), 1e-30f);
    if (t == 0 && rows[r] < S) lse[static_cast<size_t>(bh) * S + rows[r]] = m[r] + logf(lr);
    // o = acc / l, divided as the Pallas kernel divides
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][2 * r] /= lr;
      acc[j][2 * r + 1] /= lr;
    }
  }
  const float one[2] = {1.f, 1.f};
  store_strip<D>(o + base, acc, rows, S, row_stride, one);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const int* __restrict__ mask,
                  const bf16* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, bf16* __restrict__ dq, int S, int H,
                  float scale, int causal) {
  constexpr int BT = kTile16, LD = Geo16<D>::LD, NB = BT / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + BT * LD;
  bf16* Kbuf = dOs + BT * LD;       // [2][BT][LD]
  bf16* Vbuf = Kbuf + 2 * BT * LD;  // [2][BT][LD]
  int* kmbuf = reinterpret_cast<int*>(Vbuf + 2 * BT * LD);  // [2][BT]

  const int n_tiles = (S + BT - 1) / BT;
  const int qt = n_tiles - 1 - static_cast<int>(blockIdx.x);
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = qt * BT, row_stride = H * D;
  const size_t base = (static_cast<size_t>(b) * S * H + h) * D;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;
  const int rows[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = rows[r] < S;
    row_lse[r] = in ? lse[static_cast<size_t>(bh) * S + rows[r]] : 0.f;
    row_delta[r] = in ? delta[static_cast<size_t>(bh) * S + rows[r]] : 0.f;
  }

  load_rows_async<D, BT, LD>(Qs, q + base, q0, S, row_stride);
  load_rows_async<D, BT, LD>(dOs, dout + base, q0, S, row_stride);
  load_rows_async<D, BT, LD>(Kbuf, k + base, 0, S, row_stride);
  load_rows_async<D, BT, LD>(Vbuf, v + base, 0, S, row_stride);
  cp_async_commit();
  load_key_mask<BT>(kmbuf, mask, b, 0, S);
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const int n_kt = causal ? qt + 1 : n_tiles;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BT, cur = kt & 1;
    const bool more = kt + 1 < n_kt;
    int km_next = 0;
    if (more) {  // the next tile streams in while this one is computed
      load_rows_async<D, BT, LD>(Kbuf + (cur ^ 1) * BT * LD, k + base, k0 + BT, S, row_stride);
      load_rows_async<D, BT, LD>(Vbuf + (cur ^ 1) * BT * LD, v + base, k0 + BT, S, row_stride);
      if (threadIdx.x < BT) km_next = key_valid(mask, b, k0 + BT + threadIdx.x, S);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const bf16* Ks = Kbuf + cur * BT * LD;
    const bf16* Vs = Vbuf + cur * BT * LD;
    const int* keymask = kmbuf + cur * BT;
    float s[NB][4], dp[NB][4];
    strip_abt<D, NB, LD>(s, Qs, r0, Ks);    // S = Q·Kᵀ
    strip_abt<D, NB, LD>(dp, dOs, r0, Vs);  // dP = dO·Vᵀ
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1), r = e >> 1;
        const bool vis = rows[r] < S && keymask[c] && (!causal || k0 + c <= rows[r]);
        const float p = vis ? expf(s[j][e] * scale - row_lse[r]) : 0.f;
        s[j][e] = p * (dp[j][e] - row_delta[r]);  // dS
      }
    }
    strip_pv<D, NB, LD>(acc, s, Ks);  // dQ += dS·K
    if (more && threadIdx.x < BT) kmbuf[(cur ^ 1) * BT + threadIdx.x] = km_next;
    __syncthreads();  // buffer `cur` is free for tile kt + 2
  }
  const float mul[2] = {scale, scale};
  store_strip<D>(dq + base, acc, rows, S, row_stride, mul);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const int* __restrict__ mask,
                   const bf16* __restrict__ dout, const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dk,
                   bf16* __restrict__ dv, int S, int H, float scale, int causal) {
  constexpr int BT = kTile16, LD = Geo16<D>::LD, NB = BT / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + BT * LD;
  bf16* Qbuf = Vs + BT * LD;          // [2][BT][LD]
  bf16* dObuf = Qbuf + 2 * BT * LD;   // [2][BT][LD]
  float* lse_buf = reinterpret_cast<float*>(dObuf + 2 * BT * LD);  // [2][BT]
  float* dl_buf = lse_buf + 2 * BT;                                  // [2][BT]
  int* keymask = reinterpret_cast<int*>(dl_buf + 2 * BT);

  const int n_tiles = (S + BT - 1) / BT;
  const int kt = blockIdx.x;  // low k tiles see the most q tiles: first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = kt * BT, row_stride = H * D;
  const size_t base = (static_cast<size_t>(b) * S * H + h) * D;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r0 = (threadIdx.x >> 5) * 16;
  const int keys[2] = {k0 + r0 + g, k0 + r0 + g + 8};  // this thread's key rows

  const int first = causal ? kt : 0;
  load_rows_async<D, BT, LD>(Ks, k + base, k0, S, row_stride);
  load_rows_async<D, BT, LD>(Vs, v + base, k0, S, row_stride);
  load_rows_async<D, BT, LD>(Qbuf, q + base, first * BT, S, row_stride);
  load_rows_async<D, BT, LD>(dObuf, dout + base, first * BT, S, row_stride);
  cp_async_commit();
  load_key_mask<BT>(keymask, mask, b, k0, S);
  load_row_values<BT>(lse_buf, lse, bh, first * BT, S);
  load_row_values<BT>(dl_buf, delta, bh, first * BT, S);
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    dk_acc[j][0] = dk_acc[j][1] = dk_acc[j][2] = dk_acc[j][3] = 0.f;
    dv_acc[j][0] = dv_acc[j][1] = dv_acc[j][2] = dv_acc[j][3] = 0.f;
  }
  for (int qt = first; qt < n_tiles; ++qt) {
    const int q0 = qt * BT, cur = (qt - first) & 1;
    const bool more = qt + 1 < n_tiles;
    float lse_next = 0.f, dl_next = 0.f;
    if (more) {  // the next tile streams in while this one is computed
      load_rows_async<D, BT, LD>(Qbuf + (cur ^ 1) * BT * LD, q + base, q0 + BT, S, row_stride);
      load_rows_async<D, BT, LD>(dObuf + (cur ^ 1) * BT * LD, dout + base, q0 + BT, S,
                                 row_stride);
      const int qn = q0 + BT + threadIdx.x;
      if (threadIdx.x < BT && qn < S) {
        lse_next = lse[static_cast<size_t>(bh) * S + qn];
        dl_next = delta[static_cast<size_t>(bh) * S + qn];
      }
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    const bf16* Qs = Qbuf + cur * BT * LD;
    const bf16* dOs = dObuf + cur * BT * LD;
    const float* lse_s = lse_buf + cur * BT;
    const float* dl_s = dl_buf + cur * BT;
    const bool key_ok[2] = {keymask[r0 + g] != 0, keymask[r0 + g + 8] != 0};
    // transposed scores: rows are this strip's keys, columns the tile's queries
    float p[NB][4];
    strip_abt<D, NB, LD>(p, Ks, r0, Qs);  // Sᵀ = K·Qᵀ
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1), r = e >> 1;
        const bool vis = q0 + c < S && key_ok[r] && (!causal || keys[r] <= q0 + c);
        p[j][e] = vis ? expf(p[j][e] * scale - lse_s[c]) : 0.f;
      }
    }
    strip_pv<D, NB, LD>(dv_acc, p, dOs);  // dV += Pᵀ·dO
    float ds[NB][4];
    strip_abt<D, NB, LD>(ds, Vs, r0, dOs);  // dPᵀ = V·dOᵀ
#pragma unroll
    for (int j = 0; j < NB; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        ds[j][e] = p[j][e] * (ds[j][e] - dl_s[c]);  // dSᵀ
      }
    }
    strip_pv<D, NB, LD>(dk_acc, ds, Qs);  // dK += dSᵀ·Q
    if (more && threadIdx.x < BT) {
      lse_buf[(cur ^ 1) * BT + threadIdx.x] = lse_next;
      dl_buf[(cur ^ 1) * BT + threadIdx.x] = dl_next;
    }
    __syncthreads();  // buffer `cur` is free for tile qt + 2
  }
  const float mul_k[2] = {scale, scale}, mul_v[2] = {1.f, 1.f};
  store_strip<D>(dk + base, dk_acc, keys, S, row_stride, mul_k);
  store_strip<D>(dv + base, dv_acc, keys, S, row_stride, mul_v);
}

// ===========================================================================
// f32: CUDA cores, scores and accumulators in shared memory
// ===========================================================================

// Shared-memory geometry of one head dim. Rows are padded by 4 floats
// against bank conflicts.
template <int D>
struct Geo32 {
  static constexpr int BT = 32;      // rows per q/k tile
  static constexpr int LD = D + 4;   // q/k/v/dO and accumulator rows
  static constexpr int LS = BT + 4;  // score and P/dS rows
  static constexpr size_t kTileD = sizeof(float) * BT * LD;
  static constexpr size_t kTileS = sizeof(float) * BT * LS;
  static constexpr size_t kRow = sizeof(float) * BT;
  // fwd: Q K V | S P | O | m l keymask
  static constexpr size_t kFwdSmem = 4 * kTileD + 2 * kTileS + 3 * kRow;
  // dq: Q dO K V | S dP dS | dQ | lse delta keymask
  static constexpr size_t kDqSmem = 5 * kTileD + 3 * kTileS + 3 * kRow;
  // dkv: K V Q dO | S dP P dS | dK dV | lse delta keymask
  static constexpr size_t kDkvSmem = 6 * kTileD + 4 * kTileS + 3 * kRow;
};

// C[M][N] (row stride ldc) = or += A·B, all f32 in shared memory. A is
// M×K: A(m, k) = A[m·lda + k], or A[k·lda + m] when A_T (A given
// transposed). B is K×N: B(k, n) = B[k·ldb + n], or B[n·ldb + k] when B_T.
// Each thread owns an (M/16)×(N/8) register tile on interleaved rows and
// columns.
template <int M, int N, int K, bool A_T, bool B_T, bool ACC>
__device__ __forceinline__ void gemm_f32(const float* A, int lda, const float* B, int ldb,
                                         float* C, int ldc) {
  constexpr int RG = 16, CG = kThreads / RG;
  constexpr int TM = M / RG, TN = N / CG;
  static_assert(TM * RG == M && TN * CG == N, "tile does not divide the thread grid");
  const int rg = threadIdx.x / CG, cg = threadIdx.x % CG;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = ACC ? C[(rg + i * RG) * ldc + cg + j * CG] : 0.f;
  }
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int m = rg + i * RG;
      a[i] = A_T ? A[k * lda + m] : A[m * lda + k];
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = cg + j * CG;
      b[j] = B_T ? B[n * ldb + k] : B[k * ldb + n];
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) C[(rg + i * RG) * ldc + cg + j * CG] = acc[i][j];
  }
}

// Write an f32 [BT][LD] accumulator tile (times `mul`) as rows [row0, ...)
// of one (b, h) slice of a [B, S, H, D] tensor; rows past S are skipped.
template <int D, int BT, int LD>
__device__ __forceinline__ void store_rows_f32(float* dst, const float* src, int row0, int S,
                                               int row_stride, float mul) {
  for (int i = threadIdx.x; i < BT * D; i += kThreads) {
    const int r = i / D, c = i % D;
    if (row0 + r < S) dst[static_cast<size_t>(row0 + r) * row_stride + c] = src[r * LD + c] * mul;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int* __restrict__ mask,
              float* __restrict__ o, float* __restrict__ lse, int S, int H, float scale,
              int causal) {
  using G = Geo32<D>;
  constexpr int BT = G::BT, LD = G::LD, LS = G::LS;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + BT * LD;
  float* Vs = Ks + BT * LD;
  float* Os = Vs + BT * LD;
  float* Ss = Os + BT * LD;
  float* Ps = Ss + BT * LS;
  float* m_s = Ps + BT * LS;
  float* l_s = m_s + BT;
  int* keymask = reinterpret_cast<int*>(l_s + BT);

  const int n_tiles = (S + BT - 1) / BT;
  const int qt = n_tiles - 1 - static_cast<int>(blockIdx.x);  // heaviest first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = qt * BT, row_stride = H * D;
  const size_t base = (static_cast<size_t>(b) * S * H + h) * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  load_rows<float, D, BT, LD>(Qs, q + base, q0, S, row_stride);
  for (int i = threadIdx.x; i < BT * LD; i += kThreads) Os[i] = 0.f;
  for (int i = threadIdx.x; i < BT; i += kThreads) {
    m_s[i] = kBigNeg;
    l_s[i] = 0.f;
  }
  const int n_kt = causal ? qt + 1 : n_tiles;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BT;
    load_rows<float, D, BT, LD>(Ks, k + base, k0, S, row_stride);
    load_rows<float, D, BT, LD>(Vs, v + base, k0, S, row_stride);
    load_key_mask<BT>(keymask, mask, b, k0, S);
    __syncthreads();
    gemm_f32<BT, BT, D, false, true, false>(Qs, LD, Ks, LD, Ss, LS);  // S = Q·Kᵀ
    __syncthreads();
    // online softmax, one warp per row (one column a lane): p, the row max
    // and sum, and the accumulator row rescaled by exp(m_prev - m_new)
    for (int r = warp; r < BT; r += kWarps) {
      const bool live = keymask[lane] && (!causal || k0 + lane <= q0 + r);
      const float s = live ? Ss[r * LS + lane] * scale : kBigNeg;
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = live ? expf(s - m_new) : 0.f;
      const float sum = warp_sum(p);
      Ps[r * LS + lane] = p;
      const float alpha = expf(m_prev - m_new);
      for (int c = lane; c < D; c += 32) Os[r * LD + c] *= alpha;
      __syncwarp();
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
      }
    }
    __syncthreads();
    gemm_f32<BT, D, BT, false, false, true>(Ps, LS, Vs, LD, Os, LD);  // O += P·V
    __syncthreads();
  }
  for (int r = warp; r < BT; r += kWarps) {
    const int qi = q0 + r;
    if (qi >= S) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
    if (lane == 0) lse[static_cast<size_t>(bh) * S + qi] = m_s[r] + logf(l);
    float* orow = o + base + static_cast<size_t>(qi) * row_stride;
    for (int c = lane; c < D; c += 32) orow[c] = Os[r * LD + c] / l;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const int* __restrict__ mask,
                 const float* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq, int S, int H,
                 float scale, int causal) {
  using G = Geo32<D>;
  constexpr int BT = G::BT, LD = G::LD, LS = G::LS;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + BT * LD;
  float* Ks = dOs + BT * LD;
  float* Vs = Ks + BT * LD;
  float* dQs = Vs + BT * LD;
  float* Ss = dQs + BT * LD;
  float* dPs = Ss + BT * LS;
  float* dSs = dPs + BT * LS;
  float* lse_s = dSs + BT * LS;
  float* dl_s = lse_s + BT;
  int* keymask = reinterpret_cast<int*>(dl_s + BT);

  const int n_tiles = (S + BT - 1) / BT;
  const int qt = n_tiles - 1 - static_cast<int>(blockIdx.x);
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = qt * BT, row_stride = H * D;
  const size_t base = (static_cast<size_t>(b) * S * H + h) * D;

  load_rows<float, D, BT, LD>(Qs, q + base, q0, S, row_stride);
  load_rows<float, D, BT, LD>(dOs, dout + base, q0, S, row_stride);
  for (int i = threadIdx.x; i < BT * LD; i += kThreads) dQs[i] = 0.f;
  load_row_values<BT>(lse_s, lse, bh, q0, S);
  load_row_values<BT>(dl_s, delta, bh, q0, S);
  const int n_kt = causal ? qt + 1 : n_tiles;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BT;
    load_rows<float, D, BT, LD>(Ks, k + base, k0, S, row_stride);
    load_rows<float, D, BT, LD>(Vs, v + base, k0, S, row_stride);
    load_key_mask<BT>(keymask, mask, b, k0, S);
    __syncthreads();
    gemm_f32<BT, BT, D, false, true, false>(Qs, LD, Ks, LD, Ss, LS);    // S = Q·Kᵀ
    gemm_f32<BT, BT, D, false, true, false>(dOs, LD, Vs, LD, dPs, LS);  // dP = dO·Vᵀ
    __syncthreads();
    for (int i = threadIdx.x; i < BT * BT; i += kThreads) {
      const int r = i / BT, c = i % BT, qi = q0 + r;
      const bool live = qi < S && keymask[c] && (!causal || k0 + c <= qi);
      const float p = live ? expf(Ss[r * LS + c] * scale - lse_s[r]) : 0.f;
      dSs[r * LS + c] = p * (dPs[r * LS + c] - dl_s[r]);
    }
    __syncthreads();
    gemm_f32<BT, D, BT, false, false, true>(dSs, LS, Ks, LD, dQs, LD);  // dQ += dS·K
    __syncthreads();
  }
  store_rows_f32<D, BT, LD>(dq + base, dQs, q0, S, row_stride, scale);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const int* __restrict__ mask,
                  const float* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ delta, float* __restrict__ dk,
                  float* __restrict__ dv, int S, int H, float scale, int causal) {
  using G = Geo32<D>;
  constexpr int BT = G::BT, LD = G::LD, LS = G::LS;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + BT * LD;
  float* Qs = Vs + BT * LD;
  float* dOs = Qs + BT * LD;
  float* dKs = dOs + BT * LD;
  float* dVs = dKs + BT * LD;
  float* Ss = dVs + BT * LD;
  float* dPs = Ss + BT * LS;
  float* Ps = dPs + BT * LS;
  float* dSs = Ps + BT * LS;
  float* lse_s = dSs + BT * LS;
  float* dl_s = lse_s + BT;
  int* keymask = reinterpret_cast<int*>(dl_s + BT);

  const int n_tiles = (S + BT - 1) / BT;
  const int kt = blockIdx.x;  // low k tiles see the most q tiles: first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = kt * BT, row_stride = H * D;
  const size_t base = (static_cast<size_t>(b) * S * H + h) * D;

  load_rows<float, D, BT, LD>(Ks, k + base, k0, S, row_stride);
  load_rows<float, D, BT, LD>(Vs, v + base, k0, S, row_stride);
  load_key_mask<BT>(keymask, mask, b, k0, S);
  for (int i = threadIdx.x; i < BT * LD; i += kThreads) {
    dKs[i] = 0.f;
    dVs[i] = 0.f;
  }
  for (int qt = causal ? kt : 0; qt < n_tiles; ++qt) {
    const int q0 = qt * BT;
    load_rows<float, D, BT, LD>(Qs, q + base, q0, S, row_stride);
    load_rows<float, D, BT, LD>(dOs, dout + base, q0, S, row_stride);
    load_row_values<BT>(lse_s, lse, bh, q0, S);
    load_row_values<BT>(dl_s, delta, bh, q0, S);
    __syncthreads();
    gemm_f32<BT, BT, D, false, true, false>(Qs, LD, Ks, LD, Ss, LS);    // S = Q·Kᵀ
    gemm_f32<BT, BT, D, false, true, false>(dOs, LD, Vs, LD, dPs, LS);  // dP = dO·Vᵀ
    __syncthreads();
    for (int i = threadIdx.x; i < BT * BT; i += kThreads) {
      const int r = i / BT, c = i % BT, qi = q0 + r;
      const bool live = qi < S && keymask[c] && (!causal || k0 + c <= qi);
      const float p = live ? expf(Ss[r * LS + c] * scale - lse_s[r]) : 0.f;
      Ps[r * LS + c] = p;
      dSs[r * LS + c] = p * (dPs[r * LS + c] - dl_s[r]);
    }
    __syncthreads();
    gemm_f32<BT, D, BT, true, false, true>(Ps, LS, dOs, LD, dVs, LD);  // dV += Pᵀ·dO
    gemm_f32<BT, D, BT, true, false, true>(dSs, LS, Qs, LD, dKs, LD);  // dK += dSᵀ·Q
    __syncthreads();
  }
  store_rows_f32<D, BT, LD>(dk + base, dKs, k0, S, row_stride, scale);
  store_rows_f32<D, BT, LD>(dv + base, dVs, k0, S, row_stride, 1.f);
}

// ===========================================================================
// launch
// ===========================================================================

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

struct Args {
  const void *q, *k, *v, *mask, *dout, *lse, *delta;
  void *o, *lse_out, *dq, *dk, *dv;
  int B, S, H;
  float scale;
  int causal;
  cudaStream_t stream;
};

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename KernelFwd, typename KernelDq, typename KernelDkv, typename T>
cudaError_t launch(Which which, const Args& a, int tile, KernelFwd fwd, size_t fwd_smem,
                   KernelDq dq, size_t dq_smem, KernelDkv dkv, size_t dkv_smem) {
  const dim3 grid((a.S + tile - 1) / tile, a.B * a.H);
  const int* mask = static_cast<const int*>(a.mask);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  cudaError_t err;
  if (which == kFwd) {
    if ((err = allow_smem(fwd, fwd_smem)) != cudaSuccess) return err;
    fwd<<<grid, kThreads, fwd_smem, a.stream>>>(q, k, v, mask, static_cast<T*>(a.o),
                                                static_cast<float*>(a.lse_out), a.S, a.H,
                                                a.scale, a.causal);
  } else if (which == kDq) {
    if ((err = allow_smem(dq, dq_smem)) != cudaSuccess) return err;
    dq<<<grid, kThreads, dq_smem, a.stream>>>(
        q, k, v, mask, static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<T*>(a.dq), a.S, a.H, a.scale,
        a.causal);
  } else {
    if ((err = allow_smem(dkv, dkv_smem)) != cudaSuccess) return err;
    dkv<<<grid, kThreads, dkv_smem, a.stream>>>(
        q, k, v, mask, static_cast<const T*>(a.dout), static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<T*>(a.dk), static_cast<T*>(a.dv),
        a.S, a.H, a.scale, a.causal);
  }
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(Which which, const Args& a) {
  using G = Geo16<D>;
  return launch<decltype(&flash_fwd_bf16<D>), decltype(&flash_bwd_dq_bf16<D>),
                decltype(&flash_bwd_dkv_bf16<D>), bf16>(
      which, a, kTile16, flash_fwd_bf16<D>, G::kFwdSmem, flash_bwd_dq_bf16<D>, G::kDqSmem,
      flash_bwd_dkv_bf16<D>, G::kDkvSmem);
}

template <int D>
cudaError_t launch_f32(Which which, const Args& a) {
  using G = Geo32<D>;
  return launch<decltype(&flash_fwd_f32<D>), decltype(&flash_bwd_dq_f32<D>),
                decltype(&flash_bwd_dkv_f32<D>), float>(
      which, a, G::BT, flash_fwd_f32<D>, G::kFwdSmem, flash_bwd_dq_f32<D>, G::kDqSmem,
      flash_bwd_dkv_f32<D>, G::kDkvSmem);
}

cudaError_t dispatch(Which which, int D, int dtype, const Args& a) {
  if (a.B * a.H == 0 || a.S == 0) return cudaSuccess;
  if (dtype == 0) {
    switch (D) {
      case 16: return launch_f32<16>(which, a);
      case 64: return launch_f32<64>(which, a);
      case 128: return launch_f32<128>(which, a);
    }
  } else if (dtype == 1) {
    switch (D) {
      case 16: return launch_bf16<16>(which, a);
      case 64: return launch_bf16<64>(which, a);
      case 128: return launch_bf16<128>(which, a);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. q/k/v/o/dout/dq/dk/dv contiguous
// [B, S, H, D]; lse/delta [B, H, S] f32; mask [B, S] int32 or NULL (no
// padding); all on the current device. Each returns cudaGetLastError()
// after its launch (0 = launched); none synchronises or allocates.
int kft_flash_fwd(const void* q, const void* k, const void* v, const void* mask, void* o,
                  void* lse, int B, int S, int H, int D, int dtype, int causal, float scale,
                  void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.mask = mask; a.o = o; a.lse_out = lse;
  a.B = B; a.S = S; a.H = H; a.scale = scale; a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(kFwd, D, dtype, a);
}

int kft_flash_bwd_dq(const void* q, const void* k, const void* v, const void* mask,
                     const void* dout, const void* lse, const void* delta, void* dq, int B,
                     int S, int H, int D, int dtype, int causal, float scale, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.mask = mask; a.dout = dout; a.lse = lse; a.delta = delta;
  a.dq = dq; a.B = B; a.S = S; a.H = H; a.scale = scale; a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(kDq, D, dtype, a);
}

int kft_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* mask,
                      const void* dout, const void* lse, const void* delta, void* dk, void* dv,
                      int B, int S, int H, int D, int dtype, int causal, float scale,
                      void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.mask = mask; a.dout = dout; a.lse = lse; a.delta = delta;
  a.dk = dk; a.dv = dv; a.B = B; a.S = S; a.H = H; a.scale = scale; a.causal = causal;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch(kDkv, D, dtype, a);
}

const char* kft_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
