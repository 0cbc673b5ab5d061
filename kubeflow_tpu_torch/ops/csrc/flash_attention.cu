// Flash attention forward and backward for Hopper (sm_90a), behind a plain
// C interface loaded with ctypes (kubeflow_tpu_torch/native/build.py).
// Three kernels, one per TPU kernel body of kubeflow_tpu/ops/flash_attention.py:
//
//   flash_fwd      replaces `_fwd_kernel` (kubeflow_tpu/ops/flash_attention.py:169;
//                  blockwise online-softmax attention: o in the input
//                  dtype, f32 lse = m + log l)
//   flash_bwd_dq   replaces `_bwd_dq_kernel` (:276; dQ = scale · Σ_k dS·K)
//   flash_bwd_dkv  replaces `_bwd_dkv_kernel` (:331; dV = Σ_q Pᵀ·dO,
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
// Common to all: the forward and dQ kernels own a tile of q rows and walk
// the k tiles up to the diagonal under causal (tiles above it are never
// loaded); the dK/dV kernel owns a tile of keys and walks the q tiles from
// the first one that sees it. This is the TPU kernels' two-kernel split:
// no atomics, deterministic gradients. Causal q tiles launch heaviest
// first. `causal` and the key mask are runtime flags (uniform branches), so
// nvcc builds one instance per kernel and D.
//
// What bounds them: at gpt_small's training shapes (B = 2, H = 12,
// S = 4096, D = 64, causal) operations, not bytes: the forward does
// ½·4·B·H·S²·D = 51.5 GFLOP on 25 MB of q/k/v/o (~2000 flops a byte, far
// past the H100's ~295), dK/dV twice that. At D = 64 a score costs 2·D
// tensor-core flops per product against one exponential, so the
// exponential unit (16 a clock per SM) is a co-limit beside the tensor
// cores. dQ does three products per (query, key) pair (S, dP, dS·K): at
// the same shape 77 GFLOP, bound 0.078 ms on the tensor cores.
//
// bf16 forward, dQ and dK/dV (the training path): designed for Hopper.
// What held the mma.sync design back, and what this one does about it:
// 1. mma.sync m16n8k16 reaches a fraction of the bf16 rate: the products
//    are wgmma (m64nNk16), B read by the tensor cores straight from
//    shared memory, and for the score products A too. dQ reads K both
//    ways from one tile: K-major as the B of S = Q·Kᵀ, MN-major as the B
//    of dS·K.
// 2. 64-row tiles of 16 rows a warp, A fragments reloaded from shared
//    memory for every walked tile: a block's tile is 128 rows, two
//    consumer warpgroups of 64 rows sharing each K/V (or Q/dO) tile, and
//    no ldmatrix at all. Probabilities (and dS, dSᵀ) go from the f32
//    accumulator layout straight into the next product's register A
//    operand. dQ keeps each row's lse·log2(e) and delta in registers.
// 3. Every mask on every tile: the causal compare runs on the diagonal
//    tile only, the ragged-tail compare on the last tile only, the key mask
//    only when one is given (the forward and dQ read it as 128 or 64 bits
//    a tile that the producer warp packs with ballots). A masked score
//    becomes -inf before its exponential, which then gives p = 0 exactly.
//    Tiles above the diagonal are never loaded (dQ's warpgroup 0 hands
//    back, unread, the one tile above its own diagonal).
// 4. Precise expf per score: the softmax runs in the exp2 domain,
//    scale·log2(e) folded into one FMA per score and ex2.approx; lse is
//    written back in natural-log units.
// 5. One tile in flight and loads on the math warps: a producer warpgroup
//    (24 registers a thread after setmaxnreg; the consumers get 240), in
//    which one warp works and its lane 0 issues every TMA copy, keeps a
//    ring of 2-4 stages full, guarded by full and empty mbarriers; there is
//    no __syncthreads() in the main loop. Tensor maps are 4-D (D, H, S, B)
//    over the [B, S, H, D] tensors; TMA zero-fills rows past S, and its
//    swizzle (128 B for D = 64, two 64-column boxes for D = 128, 32 B for
//    D = 16) is the one the wgmma descriptors name. The two consumer
//    warpgroups overlap each other's softmax and products; inside one, the
//    forward issues the next tile's S right behind this tile's P·V, and
//    dQ the next tile's S and dP behind this tile's dS·K (one wait for
//    both; not at D = 128, for registers). Overlapping a warpgroup's
//    softmax with its own product in flight is not done: ptxas (CUDA 12.8)
//    serialises the products when registers of an in-flight wgmma group
//    are read.
//
// f32 (the parity path): 32-row tiles on the CUDA cores (a register tile
// of outputs per thread), scores and accumulators staged in shared memory.

#include <cuda.h>  // CUtensorMap and its enums only: no driver library is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

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

// per-(b, h, row) f32 values ([B, H, S]) of rows [row0, row0 + BT); 0 past S
template <int BT>
__device__ __forceinline__ void load_row_values(float* dst, const float* src, int bh,
                                                int row0, int S) {
  for (int r = threadIdx.x; r < BT; r += kThreads)
    dst[r] = row0 + r < S ? src[static_cast<size_t>(bh) * S + row0 + r] : 0.f;
}

// ===========================================================================
// bf16 forward, dQ and dK/dV for Hopper: TMA, mbarriers, wgmma, warp
// specialisation
// ===========================================================================
//
// A block is three warpgroups: two consumers (first, as wgmma wants them
// warpgroup-aligned), each owning 64 rows of the block's 128-row tile, and
// a producer warpgroup, of which one warp works: its lane 0 issues the TMA
// copies, and all its lanes pack the forward's and dQ's key-mask bits or
// write the dK/dV kernel's lse and delta rows. The mbarrier, TMA and wgmma
// helpers, and the accumulator layout they rely on, are hopper.cuh's.

// write a warpgroup's accumulator rows `rows[0..1]` of this thread (the
// m64nD layout of hopper.cuh, as [D / 8][4]; times mul[r]) as bf16 rows of one
// (b, h) slice; rows past S are skipped
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

constexpr int kConsumers = 2;  // consumer warpgroups a block
constexpr int kConsumerThreads = kConsumers * kWarpGroup;
constexpr int kHopThreads = kConsumerThreads + kWarpGroup;  // + the producer warpgroup
// registers a thread after setmaxnreg: 24·128 + 240·256 = the 168·384 a
// block of 384 threads starts with
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
// rows [row0, row0 + rows) of head h, batch row b, into the tile at `dst`
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int rows, int row0, int h, int b) {
#pragma unroll
  for (int box = 0; box < Swz<D>::kBoxes; ++box)
    tma_load(dst + box * rows * Swz<D>::kRow, map, bar, box * Swz<D>::kCols, h, row0, b);
}

// Forward: Q (128 rows) once, then K and V tiles of 128 keys through a
// ring, with a key mask's 128 bits beside each; shared memory is Q |
// K × stages | V × stages | mask words × stages | barriers.
template <int D>
struct FwdHop {
  static constexpr int kRows = 128;
  static constexpr int kStages = D == 128 ? 2 : 3;
  // the next tile's S is issued behind this tile's P·V, except at D = 128,
  // where S, O and P in flight together do not fit in registers
  static constexpr bool kNextSBehindPv = D < 128;
  static constexpr uint32_t kTile = kRows * D * 2;
  static constexpr uint32_t kOffK = kTile;
  static constexpr uint32_t kOffV = kOffK + kStages * kTile;
  static constexpr uint32_t kOffMask = kOffV + kStages * kTile;  // 4 words a stage
  static constexpr uint32_t kOffBar = kOffMask + 16 * kStages;  // Q full, full × stages, empty × stages
  static constexpr size_t kSmem = kOffBar + 8 * (1 + 2 * kStages) + 1024;  // + alignment slack
};

template <int D>
__global__ void __launch_bounds__(kHopThreads, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, const int* __restrict__ mask,
               bf16* __restrict__ o, float* __restrict__ lse, int S, int H, float scale,
               int causal) {
  using G = FwdHop<D>;
  using W = Swz<D>;
  constexpr int BT = G::kRows;
  extern __shared__ unsigned char smem[];
  const uint32_t base = align1024(smem_addr(smem));
  uint32_t* mask_words =
      reinterpret_cast<uint32_t*>(smem + (base - smem_addr(smem)) + G::kOffMask);
  const uint32_t bar_q = base + G::kOffBar;
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_full + 8 * G::kStages;

  const int n_tiles = (S + BT - 1) / BT;
  const int qt = n_tiles - 1 - static_cast<int>(blockIdx.x);  // heaviest first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int n_kt = causal ? qt + 1 : n_tiles;
  const int wg = warpgroup_index();

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < G::kStages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer: one warp; its lane 0 issues every copy and, with a key
    // mask, writes the stage's 128 mask bits (one ballot of the warp per
    // 32 keys; keys past S are 0)
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x / 32 == kConsumerThreads / 32) {
      const int lane = threadIdx.x & 31;
      if (lane == 0) {
        mbar_arrive_tx(bar_q, G::kTile);
        tma_tile<D>(base, &tm_q, bar_q, BT, qt * BT, h, b);
      }
      for (int j = 0; j < n_kt; ++j) {
        const int st = j % G::kStages;
        if (j >= G::kStages) mbar_wait(bar_empty + 8 * st, ring_parity<G::kStages>(j) ^ 1u);
        if (mask != nullptr) {
#pragma unroll
          for (int w = 0; w < BT / 32; ++w) {
            const int key = j * BT + 32 * w + lane;
            const uint32_t bits = __ballot_sync(
                0xffffffffu, key < S && mask[static_cast<size_t>(b) * S + key] != 0);
            if (lane == 0) mask_words[st * (BT / 32) + w] = bits;
          }
        }
        if (lane == 0) {
          mbar_arrive_tx(bar_full + 8 * st, 2 * G::kTile);
          tma_tile<D>(base + G::kOffK + st * G::kTile, &tm_k, bar_full + 8 * st, BT, j * BT, h, b);
          tma_tile<D>(base + G::kOffV + st * G::kTile, &tm_v, bar_full + 8 * st, BT, j * BT, h, b);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns q rows [64·wg, 64·wg + 64) of the tile
    setmaxnreg_inc<kConsumerRegs>();
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int r0 = wg * 64 + (threadIdx.x % kWarpGroup >> 5) * 16 + g;
    const int rows[2] = {qt * BT + r0, qt * BT + r0 + 8};
    const float c = scale * kLog2e;  // scores in the exp2 domain
    float acc[D / 2], s[BT / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) s[i] = 0.f;
    float m2[2] = {kBigNeg, kBigNeg}, l[2] = {0.f, 0.f};  // running max (·c) and sum
    // S = Q·K_jᵀ of the tile at ring use j into s
    auto issue_s = [&](int j) {
      const int st = j % G::kStages;
      const uint32_t qb = opaque(base);
      mbar_wait(bar_full + 8 * st, ring_parity<G::kStages>(j));
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<BT>::ss(s, W::k_major(qb, BT, wg * 64, kk),
                      W::k_major(qb + G::kOffK + st * G::kTile, BT, 0, kk), kk);
      wgmma_commit();
    };
    mbar_wait(bar_q, 0);
    for (int j = 0; j < n_kt; ++j) {
      // the softmax of tile j, then its P·V and (where registers allow) the
      // next tile's S issued back to back: one wait covers both
      const int st = j % G::kStages, k0 = j * BT;
      if (!G::kNextSBehindPv || j == 0) {
        wgmma_fence();
        issue_s(j);
        wgmma_wait<0>();
        fence_regs<BT / 2>(s);
      }
      if ((causal && j == qt) || k0 + BT > S || mask != nullptr) {
        uint4 kw = make_uint4(~0u, ~0u, ~0u, ~0u);  // the stage's mask bits
        if (mask != nullptr) kw = *reinterpret_cast<const uint4*>(mask_words + st * (BT / 32));
        const uint32_t words[4] = {kw.x, kw.y, kw.z, kw.w};
#pragma unroll
        for (int i = 0; i < BT / 2; ++i) {
          const int c = 8 * (i >> 2) + 2 * t + (i & 1), col = k0 + c;
          const bool vis = col < S && (!causal || col <= rows[(i >> 1) & 1]) &&
                           (words[i >> 4] >> (c & 31) & 1u);  // word c / 32
          if (!vis) s[i] = neg_inf();
        }
      }
      float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
      for (int i = 0; i < BT / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m2[r], quad_max(mx[r]) * c);
        alpha[r] = fast_exp2(m2[r] - m_new);
        m2[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < BT / 2; ++i) {
        s[i] = fast_exp2(fmaf(s[i], c, -m2[(i >> 1) & 1]));
        sum[(i >> 1) & 1] += s[i];
      }
      // per-thread partial row sums: alpha is the same on the whole quad
      l[0] = l[0] * alpha[0] + sum[0];
      l[1] = l[1] * alpha[1] + sum[1];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      uint32_t p[BT / 4];  // P in bf16 as the A operand of 8 k-steps
#pragma unroll
      for (int i = 0; i < BT / 4; ++i) p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
      wgmma_fence();  // O += P·V, then S of the next tile
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk)
        Wgmma<D>::rs_t(acc, p + 4 * kk, W::mn_major(opaque(base) + G::kOffV + st * G::kTile, BT, kk));
      wgmma_commit();
      if (G::kNextSBehindPv && j + 1 < n_kt) issue_s(j + 1);
      wgmma_wait<0>();
      fence_regs<D / 2>(acc);
      fence_regs<BT / 4>(p);
      if (G::kNextSBehindPv) fence_regs<BT / 2>(s);
      mbar_arrive(bar_empty + 8 * st);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float lr = quad_sum(l[r]), ld = fmaxf(lr, 1e-30f);
      if (t == 0 && rows[r] < S)
        lse[static_cast<size_t>(bh) * S + rows[r]] = (lr > 0.f ? m2[r] * kLn2 : kBigNeg) + logf(ld);
#pragma unroll
      for (int i = 0; i < D / 2; ++i)
        if (((i >> 1) & 1) == r) acc[i] /= ld;  // o = acc / l, as the Pallas kernel divides
    }
    const float one[2] = {1.f, 1.f};
    store_strip<D>(o + (static_cast<size_t>(b) * S * H + h) * D,
                   reinterpret_cast<float(*)[4]>(acc), rows, S, H * D, one);
  }
}

// dK/dV: K and V (128 keys) once, then Q and dO tiles of 64 queries, with
// their lse·log2(e) and delta rows, through a ring; shared memory is K | V |
// Q × stages | dO × stages | rows × stages | barriers. The producer warp
// writes the rows with plain loads, not bulk copies: a [B, H, S] row of
// 64 floats starts 16-byte aligned, as bulk copies need, only when S % 4 == 0.
template <int D>
struct DkvHop {
  static constexpr int kKeys = 128, kQRows = 64, kStages = 3;
  static constexpr int kWalks = D == 128 ? 2 : 1;  // see DkvWalk
  static constexpr uint32_t kKV = kKeys * D * 2;
  static constexpr uint32_t kQ = kQRows * D * 2;
  static constexpr uint32_t kOffV = kKV;
  static constexpr uint32_t kOffQ = 2 * kKV;
  static constexpr uint32_t kOffDo = kOffQ + kStages * kQ;
  static constexpr uint32_t kOffRows = kOffDo + kStages * kQ;  // [stage][lse·log2e 64 | delta 64]
  static constexpr uint32_t kOffBar = kOffRows + kStages * 2 * kQRows * 4;  // KV full, full, empty
  static constexpr size_t kSmem = kOffBar + 8 * (1 + 2 * kStages) + 1024;
};

// What one walk of a dK/dV consumer over the q tiles accumulates: both
// gradients, or, at D = 128 (where dK and dV alone fill 128 registers a
// thread and the score products would then spill), dV in a first walk and
// dK in a second that recomputes Sᵀ.
enum DkvWalk { kBoth, kOnlyDv, kOnlyDk };

// One consumer warpgroup of the dK/dV kernel: it owns keys
// [wkey0, wkey0 + 64); its scores are transposed (rows are keys, columns
// the tile's queries).
template <int D>
struct DkvConsumer {
  using G = DkvHop<D>;
  using W = Swz<D>;
  static constexpr int QR = G::kQRows;
  uint32_t base, bar_full, bar_empty;
  const float* rows_s;
  const int* mask;
  int wg, t, wkey0, first, n_qt, S, causal;
  int key;          // this thread's first key row; its second is key + 8
  uint32_t key_ok;  // bit r: key + 8·r exists and is not padding
  float c;          // scale·log2(e)

  // walk the q tiles once, the ring at its i0-th use when the walk starts
  template <DkvWalk kWalk>
  __device__ __forceinline__ void walk(float* dv_acc, float* dk_acc, int i0) const {
    constexpr bool kDv = kWalk != kOnlyDk, kDk = kWalk != kOnlyDv;
    float s[QR / 2], dp[QR / 2];
#pragma unroll
    for (int e = 0; e < QR / 2; ++e) s[e] = dp[e] = 0.f;
    for (int j = 0; first + j < n_qt; ++j) {
      const int i = i0 + j, st = i % G::kStages, q0 = (first + j) * QR;
      mbar_wait(bar_full + 8 * st, ring_parity<G::kStages>(i));
      if (causal && q0 + QR <= wkey0) {  // every query precedes every key here
        mbar_arrive(bar_empty + 8 * st);
        continue;
      }
      const uint32_t kb = opaque(base);
      const uint32_t qs = kb + G::kOffQ + st * G::kQ, dos = kb + G::kOffDo + st * G::kQ;
      const float* lse_s = rows_s + st * 2 * QR;
      const float* dl_s = lse_s + QR;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)  // Sᵀ = K·Qᵀ
        Wgmma<QR>::ss(s, W::k_major(kb, G::kKeys, wg * 64, kk), W::k_major(qs, QR, 0, kk), kk);
      if constexpr (kDk) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)  // dPᵀ = V·dOᵀ
          Wgmma<QR>::ss(dp, W::k_major(kb + G::kOffV, G::kKeys, wg * 64, kk),
                        W::k_major(dos, QR, 0, kk), kk);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<QR / 2>(s);
      if constexpr (kDk) fence_regs<QR / 2>(dp);
      if ((causal && q0 < wkey0 + 64) || q0 + QR > S || mask != nullptr) {
#pragma unroll
        for (int e = 0; e < QR / 2; ++e) {
          const int col = q0 + 8 * (e >> 2) + 2 * t + (e & 1), r = (e >> 1) & 1;
          if (!((key_ok >> r & 1u) && col < S && (!causal || key + 8 * r <= col))) s[e] = neg_inf();
        }
      }
      // Pᵀ = exp2(Sᵀ·scale·log2e − lse·log2e) and dSᵀ = Pᵀ∘(dPᵀ − delta),
      // each straight into bf16 A operands (register e: columns
      // 8·(e / 2) + 2t, +1 of row g + 8·(e % 2))
      uint32_t pa[QR / 4], da[QR / 4];
#pragma unroll
      for (int e = 0; e < QR / 4; ++e) {
        const int col = 8 * (e >> 1) + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
        const float p0 = fast_exp2(fmaf(s[2 * e], c, -l2.x));
        const float p1 = fast_exp2(fmaf(s[2 * e + 1], c, -l2.y));
        if constexpr (kDv) pa[e] = pack_bf16(p0, p1);
        if constexpr (kDk) {
          const float2 dl = *reinterpret_cast<const float2*>(dl_s + col);
          da[e] = pack_bf16(p0 * (dp[2 * e] - dl.x), p1 * (dp[2 * e + 1] - dl.y));
        }
      }
      wgmma_fence();
      if constexpr (kDv) {
#pragma unroll
        for (int kk = 0; kk < QR / 16; ++kk)  // dV += Pᵀ·dO
          Wgmma<D>::rs_t(dv_acc, pa + 4 * kk, W::mn_major(dos, QR, kk));
      }
      if constexpr (kDk) {
#pragma unroll
        for (int kk = 0; kk < QR / 16; ++kk)  // dK += dSᵀ·Q
          Wgmma<D>::rs_t(dk_acc, da + 4 * kk, W::mn_major(qs, QR, kk));
      }
      wgmma_commit();
      wgmma_wait<0>();
      if constexpr (kDv) {
        fence_regs<D / 2>(dv_acc);
        fence_regs<QR / 4>(pa);
      }
      if constexpr (kDk) {
        fence_regs<D / 2>(dk_acc);
        fence_regs<QR / 4>(da);
      }
      mbar_arrive(bar_empty + 8 * st);
    }
  }
};

template <int D>
__global__ void __launch_bounds__(kHopThreads, 1)
flash_bwd_dkv_bf16(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do, const int* __restrict__ mask,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H, float scale,
                   int causal) {
  using G = DkvHop<D>;
  constexpr int QR = G::kQRows;
  extern __shared__ unsigned char smem[];
  const uint32_t base = align1024(smem_addr(smem));
  float* rows_s = reinterpret_cast<float*>(smem + (base - smem_addr(smem)) + G::kOffRows);
  const uint32_t bar_kv = base + G::kOffBar;
  const uint32_t bar_full = bar_kv + 8, bar_empty = bar_full + 8 * G::kStages;

  const int kt = blockIdx.x;  // low k tiles see the most q tiles: first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = kt * G::kKeys;
  const int n_qt = (S + QR - 1) / QR;
  const int first = causal ? k0 / QR : 0;  // the first q tile that sees key k0
  const int wg = warpgroup_index();

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int st = 0; st < G::kStages; ++st) {
      mbar_init(bar_full + 8 * st, 32);  // the producer warp's lanes
      mbar_init(bar_empty + 8 * st, kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer: its first warp writes each stage's lse·log2(e) and delta
    // rows (one per query; 0 past S), lane 0 issues every copy
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x / 32 == kConsumerThreads / 32) {
      const int lane = threadIdx.x & 31;
      const float* lse_bh = lse + static_cast<size_t>(bh) * S;
      const float* delta_bh = delta + static_cast<size_t>(bh) * S;
      if (lane == 0) {
        mbar_arrive_tx(bar_kv, 2 * G::kKV);
        tma_tile<D>(base, &tm_k, bar_kv, G::kKeys, k0, h, b);
        tma_tile<D>(base + G::kOffV, &tm_v, bar_kv, G::kKeys, k0, h, b);
      }
      const int n_walk = n_qt - first;
      for (int i = 0; i < G::kWalks * n_walk; ++i) {
        const int st = i % G::kStages, q0 = (first + i % n_walk) * QR;
        if (i >= G::kStages) mbar_wait(bar_empty + 8 * st, ring_parity<G::kStages>(i) ^ 1u);
        float* row_vals = rows_s + st * 2 * QR;
#pragma unroll
        for (int r = lane; r < QR; r += 32) {
          const bool in = q0 + r < S;
          row_vals[r] = in ? lse_bh[q0 + r] * kLog2e : 0.f;
          row_vals[QR + r] = in ? delta_bh[q0 + r] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_tx(bar_full + 8 * st, 2 * G::kQ);
          tma_tile<D>(base + G::kOffQ + st * G::kQ, &tm_q, bar_full + 8 * st, QR, q0, h, b);
          tma_tile<D>(base + G::kOffDo + st * G::kQ, &tm_do, bar_full + 8 * st, QR, q0, h, b);
        } else {
          mbar_arrive(bar_full + 8 * st);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns keys [k0 + 64·wg, k0 + 64·wg + 64)
    setmaxnreg_inc<kConsumerRegs>();
    const int lane = threadIdx.x & 31, g = lane >> 2;
    const int r0 = wg * 64 + (threadIdx.x % kWarpGroup >> 5) * 16 + g;
    const int key = k0 + r0;
    uint32_t key_ok = 3u;
    if (mask != nullptr) {
      key_ok = 0u;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int kr = key + 8 * r;
        key_ok |= static_cast<uint32_t>(kr < S && mask[static_cast<size_t>(b) * S + kr] != 0) << r;
      }
    }
    const DkvConsumer<D> cons{base, bar_full, bar_empty, rows_s, mask, wg, lane & 3, k0 + wg * 64,
                              first, n_qt, S, causal, key, key_ok, scale * kLog2e};
    const int keys[2] = {key, key + 8};
    const size_t out = (static_cast<size_t>(b) * S * H + h) * D;
    const float mul_k[2] = {scale, scale}, mul_v[2] = {1.f, 1.f};
    mbar_wait(bar_kv, 0);
    if constexpr (G::kWalks == 2) {
      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      cons.template walk<kOnlyDv>(acc, nullptr, 0);
      store_strip<D>(dv + out, reinterpret_cast<float(*)[4]>(acc), keys, S, H * D, mul_v);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      cons.template walk<kOnlyDk>(nullptr, acc, n_qt - first);
      store_strip<D>(dk + out, reinterpret_cast<float(*)[4]>(acc), keys, S, H * D, mul_k);
    } else {
      float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
      cons.template walk<kBoth>(dv_acc, dk_acc, 0);
      store_strip<D>(dk + out, reinterpret_cast<float(*)[4]>(dk_acc), keys, S, H * D, mul_k);
      store_strip<D>(dv + out, reinterpret_cast<float(*)[4]>(dv_acc), keys, S, H * D, mul_v);
    }
  }
}

// dQ: Q and dO (128 rows) once, then K and V tiles of 64 keys through a
// ring, with the key mask's 64 bits beside each; shared memory is Q | dO |
// K × stages | V × stages | mask words × stages | barriers. Key tiles are
// 64, not the forward's 128: a consumer thread holds S and dP (N/2 f32
// each), the dQ accumulator (D/2) and dS as bf16 pairs (N/4), 112
// registers at D = 64 and N = 64 (144 at D = 128), where N = 128 would
// take 192 before addresses.
template <int D>
struct DqHop {
  static constexpr int kRows = 128, kKeys = 64;
  static constexpr int kStages = D == 128 ? 3 : 4;
  // the next tile's S and dP are issued behind this tile's dS·K, except at
  // D = 128, where the registers of all three in flight would not fit
  static constexpr bool kNextBehindDq = D < 128;
  static constexpr uint32_t kQ = kRows * D * 2;   // a Q or dO tile
  static constexpr uint32_t kKV = kKeys * D * 2;  // a K or V tile
  static constexpr uint32_t kOffDo = kQ;
  static constexpr uint32_t kOffK = 2 * kQ;
  static constexpr uint32_t kOffV = kOffK + kStages * kKV;
  static constexpr uint32_t kOffMask = kOffV + kStages * kKV;  // 2 words a stage
  static constexpr uint32_t kOffBar = kOffMask + 8 * kStages;  // Q full, full × stages, empty × stages
  static constexpr size_t kSmem = kOffBar + 8 * (1 + 2 * kStages) + 1024;  // + alignment slack
};

template <int D>
__global__ void __launch_bounds__(kHopThreads, 1)
flash_bwd_dq_bf16(const __grid_constant__ CUtensorMap tm_q,
                  const __grid_constant__ CUtensorMap tm_k,
                  const __grid_constant__ CUtensorMap tm_v,
                  const __grid_constant__ CUtensorMap tm_do, const int* __restrict__ mask,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  bf16* __restrict__ dq, int S, int H, float scale, int causal) {
  using G = DqHop<D>;
  using W = Swz<D>;
  constexpr int BT = G::kRows, KN = G::kKeys;
  extern __shared__ unsigned char smem[];
  const uint32_t base = align1024(smem_addr(smem));
  uint32_t* mask_words =
      reinterpret_cast<uint32_t*>(smem + (base - smem_addr(smem)) + G::kOffMask);
  const uint32_t bar_q = base + G::kOffBar;
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_full + 8 * G::kStages;

  const int n_tiles = (S + BT - 1) / BT;
  const int qt = n_tiles - 1 - static_cast<int>(blockIdx.x);  // heaviest first
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int n_ktiles = (S + KN - 1) / KN;
  // key tiles up to the block's diagonal; none above it is loaded
  const int n_kt = causal ? min(n_ktiles, (qt * BT + BT - 1) / KN + 1) : n_ktiles;
  const int wg = warpgroup_index();

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < G::kStages; ++st) {
      mbar_init(bar_full + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers) {
    // producer: one warp; its lane 0 issues every copy and, with a key
    // mask, writes the stage's 64 mask bits (one ballot of the warp per 32
    // keys; keys past S are 0)
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x / 32 == kConsumerThreads / 32) {
      const int lane = threadIdx.x & 31;
      if (lane == 0) {
        mbar_arrive_tx(bar_q, 2 * G::kQ);
        tma_tile<D>(base, &tm_q, bar_q, BT, qt * BT, h, b);
        tma_tile<D>(base + G::kOffDo, &tm_do, bar_q, BT, qt * BT, h, b);
      }
      for (int j = 0; j < n_kt; ++j) {
        const int st = j % G::kStages;
        if (j >= G::kStages) mbar_wait(bar_empty + 8 * st, ring_parity<G::kStages>(j) ^ 1u);
        if (mask != nullptr) {
#pragma unroll
          for (int w = 0; w < KN / 32; ++w) {
            const int key = j * KN + 32 * w + lane;
            const uint32_t bits = __ballot_sync(
                0xffffffffu, key < S && mask[static_cast<size_t>(b) * S + key] != 0);
            if (lane == 0) mask_words[st * (KN / 32) + w] = bits;
          }
        }
        if (lane == 0) {
          mbar_arrive_tx(bar_full + 8 * st, 2 * G::kKV);
          tma_tile<D>(base + G::kOffK + st * G::kKV, &tm_k, bar_full + 8 * st, KN, j * KN, h, b);
          tma_tile<D>(base + G::kOffV + st * G::kKV, &tm_v, bar_full + 8 * st, KN, j * KN, h, b);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns q rows [64·wg, 64·wg + 64) of the tile
    setmaxnreg_inc<kConsumerRegs>();
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int wrow0 = qt * BT + wg * 64;  // the warpgroup's first row
    const int r0 = wg * 64 + (threadIdx.x % kWarpGroup >> 5) * 16 + g;
    const int rows[2] = {qt * BT + r0, qt * BT + r0 + 8};
    const float c = scale * kLog2e;  // scores in the exp2 domain
    // this thread's rows' lse·log2(e) and delta, fixed along the walk (0
    // past S: those rows are never stored)
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool in = rows[r] < S;
      lse2[r] = in ? lse[static_cast<size_t>(bh) * S + rows[r]] * kLog2e : 0.f;
      dl[r] = in ? delta[static_cast<size_t>(bh) * S + rows[r]] : 0.f;
    }
    // key tiles this warpgroup computes: under causal, up to its own
    // diagonal; the block's last tile lies above warpgroup 0's
    const int n_mine = causal ? min(n_kt, (wrow0 + 63) / KN + 1) : n_kt;
    float acc[D / 2], s[KN / 2], dp[KN / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < KN / 2; ++i) s[i] = dp[i] = 0.f;
    // S = Q·K_jᵀ and dP = dO·V_jᵀ of the tile at ring use j
    auto issue_sdp = [&](int j) {
      const int st = j % G::kStages;
      const uint32_t qb = opaque(base);
      mbar_wait(bar_full + 8 * st, ring_parity<G::kStages>(j));
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<KN>::ss(s, W::k_major(qb, BT, wg * 64, kk),
                      W::k_major(qb + G::kOffK + st * G::kKV, KN, 0, kk), kk);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        Wgmma<KN>::ss(dp, W::k_major(qb + G::kOffDo, BT, wg * 64, kk),
                      W::k_major(qb + G::kOffV + st * G::kKV, KN, 0, kk), kk);
      wgmma_commit();
    };
    mbar_wait(bar_q, 0);
    for (int j = 0; j < n_mine; ++j) {
      const int st = j % G::kStages, k0 = j * KN;
      if (!G::kNextBehindDq || j == 0) {
        wgmma_fence();
        issue_sdp(j);
        wgmma_wait<0>();
        fence_regs<KN / 2>(s);
        fence_regs<KN / 2>(dp);
      }
      // masks: the causal compare where the tile reaches past the
      // warpgroup's first row, the tail compare on the last tile, the key
      // mask when one is given; a masked score becomes -inf, so p = 0
      if ((causal && k0 + KN - 1 > wrow0) || k0 + KN > S || mask != nullptr) {
        uint2 kw = make_uint2(~0u, ~0u);  // the stage's mask bits
        if (mask != nullptr) kw = *reinterpret_cast<const uint2*>(mask_words + st * (KN / 32));
        const uint32_t words[2] = {kw.x, kw.y};
#pragma unroll
        for (int i = 0; i < KN / 2; ++i) {
          const int cc = 8 * (i >> 2) + 2 * t + (i & 1), col = k0 + cc;
          const bool vis = col < S && (!causal || col <= rows[(i >> 1) & 1]) &&
                           (words[i >> 4] >> (cc & 31) & 1u);  // word cc / 32
          if (!vis) s[i] = neg_inf();
        }
      }
      // P = exp2(S·scale·log2e − lse·log2e), dS = P∘(dP − delta), straight
      // into bf16 A operands (register e: columns 8·(e / 2) + 2t, +1 of row
      // g + 8·(e % 2))
      uint32_t ds[KN / 4];
#pragma unroll
      for (int e = 0; e < KN / 4; ++e) {
        const int r = e & 1;
        const float p0 = fast_exp2(fmaf(s[2 * e], c, -lse2[r]));
        const float p1 = fast_exp2(fmaf(s[2 * e + 1], c, -lse2[r]));
        ds[e] = pack_bf16(p0 * (dp[2 * e] - dl[r]), p1 * (dp[2 * e + 1] - dl[r]));
      }
      wgmma_fence();  // dQ += dS·K (K read MN-major from its K-major tile), then the next S, dP
#pragma unroll
      for (int kk = 0; kk < KN / 16; ++kk)
        Wgmma<D>::rs_t(acc, ds + 4 * kk, W::mn_major(opaque(base) + G::kOffK + st * G::kKV, KN, kk));
      wgmma_commit();
      if (G::kNextBehindDq && j + 1 < n_mine) issue_sdp(j + 1);
      wgmma_wait<0>();
      fence_regs<D / 2>(acc);
      fence_regs<KN / 4>(ds);
      if (G::kNextBehindDq) {
        fence_regs<KN / 2>(s);
        fence_regs<KN / 2>(dp);
      }
      mbar_arrive(bar_empty + 8 * st);
    }
    // tiles past this warpgroup's diagonal: hand them back once loaded
    for (int j = n_mine; j < n_kt; ++j) {
      const int st = j % G::kStages;
      mbar_wait(bar_full + 8 * st, ring_parity<G::kStages>(j));
      mbar_arrive(bar_empty + 8 * st);
    }
    const float mul[2] = {scale, scale};  // dQ = scale · Σ dS·K
    store_strip<D>(dq + (static_cast<size_t>(b) * S * H + h) * D,
                   reinterpret_cast<float(*)[4]>(acc), rows, S, H * D, mul);
  }
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

// the f32 kernels, one block of kThreads per (tile, b·h)
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

// A 4-D map (D, H, S, B) over a contiguous [B, S, H, D] bf16 tensor whose
// box is `rows` rows of one (b, h) and Swz<D>::kCols columns, swizzled as
// Swz<D> reads it; rows past S read as zeros.
template <int D>
cudaError_t rows_map(CUtensorMap* map, const void* ptr, const Args& a, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {D, static_cast<cuuint64_t>(a.H), static_cast<cuuint64_t>(a.S),
                              static_cast<cuuint64_t>(a.B)};
  const cuuint64_t strides[3] = {2 * D, 2ull * D * a.H, 2ull * D * a.H * a.S};  // bytes
  const cuuint32_t box[4] = {Swz<D>::kCols, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      D == 16 ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_bf16(Which which, const Args& a) {
  const int* mask = static_cast<const int*>(a.mask);
  cudaError_t err;
  if (which == kFwd) {
    using G = FwdHop<D>;
    CUtensorMap tq, tk, tv;
    if ((err = rows_map<D>(&tq, a.q, a, G::kRows)) != cudaSuccess ||
        (err = rows_map<D>(&tk, a.k, a, G::kRows)) != cudaSuccess ||
        (err = rows_map<D>(&tv, a.v, a, G::kRows)) != cudaSuccess ||
        (err = allow_smem(flash_fwd_bf16<D>, G::kSmem)) != cudaSuccess)
      return err;
    const dim3 grid((a.S + G::kRows - 1) / G::kRows, a.B * a.H);
    flash_fwd_bf16<D><<<grid, kHopThreads, G::kSmem, a.stream>>>(
        tq, tk, tv, mask, static_cast<bf16*>(a.o), static_cast<float*>(a.lse_out), a.S, a.H,
        a.scale, a.causal);
  } else if (which == kDkv) {
    using G = DkvHop<D>;
    CUtensorMap tq, tk, tv, tdo;
    if ((err = rows_map<D>(&tq, a.q, a, G::kQRows)) != cudaSuccess ||
        (err = rows_map<D>(&tdo, a.dout, a, G::kQRows)) != cudaSuccess ||
        (err = rows_map<D>(&tk, a.k, a, G::kKeys)) != cudaSuccess ||
        (err = rows_map<D>(&tv, a.v, a, G::kKeys)) != cudaSuccess ||
        (err = allow_smem(flash_bwd_dkv_bf16<D>, G::kSmem)) != cudaSuccess)
      return err;
    const dim3 grid((a.S + G::kKeys - 1) / G::kKeys, a.B * a.H);
    flash_bwd_dkv_bf16<D><<<grid, kHopThreads, G::kSmem, a.stream>>>(
        tq, tk, tv, tdo, mask, static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<bf16*>(a.dk), static_cast<bf16*>(a.dv),
        a.S, a.H, a.scale, a.causal);
  } else {
    using G = DqHop<D>;
    CUtensorMap tq, tk, tv, tdo;
    if ((err = rows_map<D>(&tq, a.q, a, G::kRows)) != cudaSuccess ||
        (err = rows_map<D>(&tdo, a.dout, a, G::kRows)) != cudaSuccess ||
        (err = rows_map<D>(&tk, a.k, a, G::kKeys)) != cudaSuccess ||
        (err = rows_map<D>(&tv, a.v, a, G::kKeys)) != cudaSuccess ||
        (err = allow_smem(flash_bwd_dq_bf16<D>, G::kSmem)) != cudaSuccess)
      return err;
    const dim3 grid((a.S + G::kRows - 1) / G::kRows, a.B * a.H);
    flash_bwd_dq_bf16<D><<<grid, kHopThreads, G::kSmem, a.stream>>>(
        tq, tk, tv, tdo, mask, static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<bf16*>(a.dq), a.S, a.H, a.scale,
        a.causal);
  }
  return cudaGetLastError();
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
