#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (kubeflow_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Device: raise unless CUDA is available; print the card's name and
   power limit as nvidia-smi reports them.
2. Build: nvcc builds every kernel under kubeflow_tpu_torch/ops/csrc into
   build/kernels/ (one nvcc per source, started together). ptxas's report
   must show no spill in any instance of the bf16 flash forward, dQ or
   dK/dV kernel or of the paged window kernel's bf16 (wgmma) instances,
   and no ignored setmaxnreg (C7508); their register counts are printed.
3. Kernels vs plain: each paged-attention kernel against its plain
   PyTorch version on the card, at gpt_small's serving shapes (8 slots,
   12 heads x 64, page 16, 64 pages a slot, 384 pool pages), bf16 and
   f32, with ragged cursors (0, 15, 16, 1023 and a parked 1024); the
   decode kernel also at cursors on its split edges (127, 128, 129;
   checked, not timed) and at one slot with cursor 1023 (one long row,
   the case the split over pages is for; timed); the window kernel also
   at s = 5 (the K+1 verify window of K = 4) and over a view of 8,192
   positions (512 pages a slot, past the old kernel's cap), both checked,
   not timed; then the window kernel at the batch-1 calls phase 5 makes
   (MAIN_WINDOWS), whose mean the kernels line reports; then both
   kernels at phase 11c's small-draft calls (4 heads x 16: the decode
   kernel at the 8 ragged cursors, the window kernel at MAIN_WINDOWS'
   cursors; bf16 and f32, checked, not timed). Times are
   medians over CUDA events with the L2 flushed before each launch.
4. Serve f32: gpt_small at full width (seeded init) behind the REST
   server on a real socket, paged_attention=kernel; two greedy
   `:generate` requests must equal the port's `generate()`.
5. Serve bf16 (the main path): the same server in bf16 with prefill
   buckets 8..256; concurrent requests of 5-120 tokens, one ~700-token
   prompt (head prefill + chunk windows through the window kernel) and
   one 300-token prompt sent twice (a prefix hit with copy-on-write).
   Every reply must be 200, every emitted token's f32 teacher-forced
   logit within DELTA of its position's max, and both kernels launched.

6. Flash kernels vs plain: the three flash-attention kernels (forward,
   dQ, dK/dV) against their plain PyTorch versions at the training
   microbatch shape (B=2, H=12, D=64, S=4096, causal, bf16) without and
   with a key mask, and in f32 at S=1024 (o, dQ, dK and dV each held row
   by row at its own scale in bf16: FLASH_REL); times as in phase 3, the
   bound from the visible (query, key) pairs, and
   scaled_dot_product_attention (forward; its autograd backward for the
   dQ + dK/dV pair) as the library yardstick.
7. Train f32: gpt_small at seq 1024, batch 2, f32, 3 steps of
   `Trainer.fit` from the same seeded init and batches, once through the
   flash kernels and once dense: per-step losses within rel 1e-5, the
   updates of a few q/k/MLP/head leaves within rel 1e-4 (L2), flash
   launches only in the flash run.
8. Train bf16 (the training main path): `run_training` of gpt_small at
   configs/gpt_longcontext_v5e16.yaml's one-card share (seq 4096, global
   batch 8 = 4 microbatches of 2, remat, loss_chunk 4096, full attention,
   AdamW lr 3e-4, wd 0.1) with attention_impl="flash", 6 steps: every
   loss finite, launch counts equal to the config's formula; the steady
   step is steps 2-6's wall time over 5, with one host sync at their end.
9. int8 kernels vs plain: the int8 variants of both paged kernels
   (int8 pools from `quantize_kv` of phase 3's seeded pools, bf16
   scales) against their plain version (gather, `dequant_kv`, dense
   core) at phase 3's calls, bf16 and f32 compute; the library yardstick
   is gather + `dequant_kv` + scaled_dot_product_attention, and the
   bound counts D + 2 bytes per live K and V vector.
10. Serve int8 (the int8 main path): gpt_small with quantize="int8"
   (int8 weights dequantized at use, int8 KV pages). f32: phase 4's two
   greedy prompts through the int8 kernels and through gather +
   `dequant_kv` must give the same tokens. bf16: phase 5's traffic; every
   reply 200, every emitted token's f32 teacher-forced logit within
   DELTA of its position's max under the f32 model of the same int8
   weights; only the int8 kernels launch, the window kernel once per
   layer for each of MAIN_WINDOWS; the auto-sized pool holds the int8
   capacity ratio times phase 5's pages in no more bytes; and
   `quantization_accuracy` of gpt_small (bf16 and f32, a seeded batch)
   stays within the JAX package's pinned limits (ACCURACY).
11. Serve with speculation (K = SPEC_K draft tokens, gpt_small at full
   width, 8 slots, page 16, paged_attention=kernel). 11a, f32: phase 4's
   two greedy prompts through a drafted engine must equal `generate()`,
   with the same weights as the draft and with a draft whose head is
   rolled one vocab row (it never proposes the target's argmax); the
   first must accept at least ACCEPT_SAME of its proposals, the second
   none; at quantize="int8" a drafted engine's tokens must equal the K = 0 int8
   engine's. 11b, bf16 over REST (the main path with speculation):
   `build_server(..., draft_model=<the model>, num_draft_tokens=K)` (the
   draft's seed-0 init is the target's) serves phase 5's traffic; every
   reply 200 and within DELTA; the decode kernel launches exactly
   verify_steps x (K+1) x the draft's layers (the target's one-token
   step never runs), the window kernel verify_steps x the target's
   layers plus the chunk windows of both models; pages_in_use returns to
   what the prefix index holds; one sampled request sent twice with one
   seed returns the same tokens. 11c, bf16 with a small draft (gpt_tiny's
   widths at gpt_small's vocabulary and window, SMALL_DRAFT: the decode
   kernel runs at D = 16 on the draft's pool): phase 5's traffic through
   the engine, the DELTA gate, the launch formula, pages given back by
   rewinds, no page leaked. Printed, not gated: each engine's accept
   rate, wall time per verify iteration and tokens per iteration, beside
   phase 5's K = 0 step time and tokens/s from the same call.

The last lines are the nvidia-smi line, a {"kernels": [...]} JSON line,
and {"ok": true, "device": {...}}. f32 matmuls run in full f32: TF32 is
turned off for matmuls and cuDNN below.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

# the H100's peaks, from the one table the port keeps
from kubeflow_tpu_torch.observability.mfu import (
    H100_HBM_BYTES_PER_S as HBM_BYTES_PER_S,
    H100_PEAK_OPS as PEAK_OPS,
)

# tolerances of each kernel against its plain version on the same inputs:
# f32 differs only in summation order; bf16 may also round a score,
# probability or output element one bf16 ulp apart (2^-8 relative)
ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
# a bf16 greedy token may differ from f32's argmax on a near-tie: each
# emitted token's f32 logit must be within DELTA of its position's max
DELTA = 0.25

# flash kernels against the plain versions. f32 (summation order only):
# absolute. bf16: each row (one head's D values at one position) within
# FLASH_REL of the larger of its own largest |value| and the tensor's
# median |value| — two bf16 ulps of the row's largest element, with
# margin — or within the f32 tolerance. A row's scale is its own, so a
# causal row late in the sequence (|values| ~ sqrt(e/S)) is held as
# tightly as an early one (|values| ~ 1). lse is f32 from exact bf16
# products: absolute.
FLASH_ATOL = {"float32": dict(o=1e-5, lse=1e-5, grad=1e-4),
              "bfloat16": dict(o=1e-5, lse=1e-3, grad=1e-4)}
FLASH_REL = 2e-2
# phase 7: f32 flash against dense, summation order only: per-step losses
# within TRAIN_LOSS_REL, and each checked leaf's 3-step update within
# TRAIN_UPDATE_REL of dense's (relative L2 norm). The leaves are ones
# whose gradient passes through attention's backward (q and k
# projections) or follows from its output; not the key bias, whose
# gradient is 0 up to rounding (softmax ignores a per-row shift), so
# that AdamW's per-element step there is noise in both runs.
TRAIN_LOSS_REL, TRAIN_UPDATE_REL = 1e-5, 1e-4
TRAIN_LEAVES = ("layers.0.attention.query.kernel",
                "layers.1.attention.key.kernel", "layers.1.mlp_wi.kernel",
                "head.kernel")
# the JAX package's pinned int8 accuracy gate (tests/test_quantize.py):
# logit max-abs-err and held-out next-token loss delta of the dequantized
# model against the full-width one
ACCURACY = {"logit_max_abs_err": 0.25, "loss_delta": 0.02}
# the training main path: configs/gpt_longcontext_v5e16.yaml at one card's
# share (each of its 16 chips holds 2 sequences x 4096 positions a
# microbatch)
TRAIN_CFG = dict(
    model="gpt_small", seq_len=4096, global_batch_size=8, accum_steps=4,
    remat=True, loss_chunk=4096, assume_full_attention=True,
    learning_rate=3e-4, warmup_steps=2, weight_decay=0.1, steps=6,
    dtype="bfloat16", attention_impl="flash",
)
# phase 6's kernel shapes: one microbatch of TRAIN_CFG, gpt_small heads
FB, FH, FD, FS = 2, 12, 64, 4096
# the kernels built on wgmma (the flash kernels with TMA and setmaxnreg too):
# phase 2 fails when ptxas reports that one of their instances spills or
# ignored setmaxnreg. The flash kernels' instances are named <kernel>ILi<D>E;
# the window kernel's bf16 instances by the storage they read, full-width
# bf16 pages (a repeated template argument, S<n>_) or int8 (a)
HOPPER_KERNELS = ("flash_fwd_bf16", "flash_bwd_dq_bf16", "flash_bwd_dkv_bf16")
WINDOW_HOPPER_KERNELS = {
    "paged_window_bf16": r"paged_window_kernelI13__nv_bfloat16S\d*_Li(?P<d>\d+)E",
    "paged_window_int8_bf16": r"paged_window_kernelI13__nv_bfloat16aLi(?P<d>\d+)E",
}

# gpt_small serving geometry (engine defaults: 8 slots, page 16)
B, H, D, PS, MP, NUM_PAGES = 8, 12, 64, 16, 64, 384
# ragged cursors of the 8-slot calls; 1024 = max_len is a parked slot
CURSORS = (0, 15, 16, 1023, 1024, 300, 517, 64)
# the decode kernel's split edges (a split is 128 keys at page 16) and its
# one-long-row call
SPLIT_EDGES, LONG_ROW = (127, 128, 129), (1023,)
# the K+1 verify window of K = 4 draft tokens
VERIFY = 5
# a long view (512 pages of 16 a slot): slots near its end, mid-way, on a
# split edge, and parked; pool pages for their live pages
LONG_MP, LONG_NUM_PAGES = 512, 1400
LONG_CURSORS = (8100, 4000, 128, LONG_MP * PS)

# phase 5's traffic: prefill buckets up to 256, chunk windows of 64 rows
# (the engine's chunk_len at page 16), one long prompt and one prompt
# sent twice
BUCKETS = "8,16,32,64,128,256"
CHUNK, LONG_LEN, HIT_LEN = 64, 700, 300
LARGEST = int(BUCKETS.split(",")[-1])
# the windows phase 5 hands the window kernel, each a batch-1 call at
# cursor = the window's first position: the long prompt's and the first
# 300-token prompt's windows after their head prefill, then the repeat's
# one window after its prefix hit (the whole prompt but its last token)
def main_windows(long_len=LONG_LEN, hit_len=HIT_LEN, largest=LARGEST,
                 chunk=CHUNK):
    """The chunk windows phase 5's traffic makes (each prompt but the
    long and the hit one fits a prefill bucket), by first position."""
    return (*range(largest, long_len, chunk), *range(largest, hit_len, chunk),
            hit_len - 1)


MAIN_WINDOWS = main_windows()
# phase 11: K draft tokens a verify iteration; 11c's draft has gpt_tiny's
# widths (head dim 16) at the target's vocabulary and window
SPEC_K = 4
SMALL_DRAFT = dict(hidden_size=64, num_layers=2, num_heads=4, mlp_dim=128)
SMALL_H = SMALL_DRAFT["num_heads"]
SMALL_D = SMALL_DRAFT["hidden_size"] // SMALL_H
# 11a: a draft with the target's own weights, f32, accepts at least this
# share of its proposals (one-token steps and the K+1 verify window differ
# only in summation order)
ACCEPT_SAME = 0.99


def hopper_kernel_report(log, kernels=HOPPER_KERNELS):
    """{(kernel, D): (registers, spill store bytes, spill load bytes)} of
    each instance of `kernels` in a ptxas report (nvcc -Xptxas -v); raises
    when one spills, when ptxas ignored a setmaxnreg (C7508), or when an
    instance is missing. `kernels` names kernels whose instances are
    <kernel>ILi<D>E, or maps a label to a pattern of its instances' names
    with D as the group `d`."""
    if "C7508" in log or "setmaxnreg ignored" in log:
        raise AssertionError("ptxas ignored a setmaxnreg (C7508):\n" + "\n".join(
            line for line in log.splitlines() if "C7508" in line or "setmaxnreg" in line))
    if not isinstance(kernels, dict):
        kernels = {k: re.escape(k) + r"ILi(?P<d>\d+)E" for k in kernels}
    report = {}
    for chunk in log.split("Compiling entry function '")[1:]:
        name = chunk.split("'", 1)[0]
        found = next(((k, m) for k, pat in kernels.items()
                      if (m := re.search(pat, name))), None)
        if found is None:
            continue
        kernel, d = found[0], int(found[1].group("d"))
        regs = re.search(r"Used (\d+) registers", chunk)
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", chunk)
        if regs is None or spills is None:
            raise AssertionError(f"no ptxas register report for {name}")
        report[(kernel, d)] = (int(regs.group(1)), int(spills.group(1)),
                               int(spills.group(2)))
    want = {(k, d) for k in kernels for d in (16, 64, 128)}
    if set(report) != want:
        raise AssertionError(f"ptxas reported {sorted(report)}, not {sorted(want)}")
    spilled = {key: r for key, r in report.items() if r[1] or r[2]}
    if spilled:
        raise AssertionError(f"spills (registers, store bytes, load bytes): {spilled}")
    return report


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def kernel_inputs(torch, dtype, s, dev, cursors=CURSORS, seed=0, mp=MP,
                  num_pages=NUM_PAGES, h=H, d=D):
    """q, pools, page table and cursors at the serving shapes (or `mp`
    pages a slot in a pool of `num_pages`, `h` heads of `d`): each slot
    owns distinct pages up to its last live one; entries past it are
    stale (random) and must never be read."""
    g = torch.Generator().manual_seed(seed)
    b = len(cursors)
    q = torch.randn((b, s, h, d), generator=g).to(dtype)
    pool_k = torch.randn((num_pages, PS, h, d), generator=g).to(dtype)
    pool_v = torch.randn((num_pages, PS, h, d), generator=g).to(dtype)
    perm = torch.randperm(num_pages, generator=g).tolist()
    table = torch.randint(0, num_pages, (b, mp), generator=g, dtype=torch.int32)
    for row, cur in enumerate(cursors):
        live = min((cur + s - 1) // PS, mp - 1) + 1
        table[row, :live] = torch.tensor(perm[:live], dtype=torch.int32)
        perm = perm[live:]
    cursors = torch.tensor(cursors, dtype=torch.int32)
    return [t.to(dev) for t in (q, pool_k, pool_v, table, cursors)]


def work_bounds(cursors, itemsize, s, quantized=False, h=H, d=D):
    """(bytes, ops) this call needs: each live K/V vector read once (D
    elements of `itemsize`, or D int8 values and a 2-byte scale), the
    live rows' q read once, every output row written once, the live
    pages' table entries and the cursors read; 4 ops per live (query
    row, key, element) — QK^T and PV — plus, in int8, one dequant
    multiply per live K/V element. A parked row (cursor past the window)
    needs only its output written."""
    view_len = MP * PS
    kv_keys, pairs, live_rows, pages = 0, 0, 0, 0
    for cur in cursors:
        if cur >= view_len:
            continue
        n = min(cur + s - 1, view_len - 1) + 1
        kv_keys += n
        pages += -(-n // PS)
        pairs += sum(min(cur + j, view_len - 1) + 1 for j in range(s))
        live_rows += 1
    vector_bytes = d + 2 if quantized else d * itemsize
    nbytes = 2 * kv_keys * h * vector_bytes
    nbytes += (live_rows + len(cursors)) * s * h * d * itemsize
    nbytes += 4 * (pages + len(cursors))
    ops = 4 * pairs * h * d + (2 * kv_keys * h * d if quantized else 0)
    return nbytes, ops


def bound_of(name, cursors, itemsize, s, quantized=False, h=H, d=D):
    """(bound_ms, bound_by, bytes, ops) of one call on the H100."""
    nbytes, ops = work_bounds(cursors, itemsize, s, quantized, h, d)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[name] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, ops)


def time_ms(torch, fn, flush, iters=30, warmup=3):
    """Median device time of fn() over CUDA events, L2 flushed before
    every launch (the serving loop meets each layer's pool cold). The
    flush (a 2 GiB memset; phase 3 prints its time) also keeps the
    device busy while the host enqueues fn's launches, so a multi-launch
    fn is timed without the host's gaps between them."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def library_attention(torch, q, pool_k, pool_v, table, cursors, k_scale=None,
                      v_scale=None):
    """gather (+ `dequant_kv` of an int8 pool) + torch's
    scaled_dot_product_attention: a yardstick timed beside the kernels,
    never called by the port."""
    from kubeflow_tpu_torch.ops.attention import dequant_kv, paged_kv_view

    s = q.shape[1]
    k, v = paged_kv_view(pool_k, table), paged_kv_view(pool_v, table)
    if k_scale is not None:
        k = dequant_kv(k, paged_kv_view(k_scale, table), q.dtype)
        v = dequant_kv(v, paged_kv_view(v_scale, table), q.dtype)
    k, v = k.transpose(1, 2), v.transpose(1, 2)
    q_pos = cursors.long()[:, None] + torch.arange(s, device=q.device)
    mask = torch.arange(k.shape[2], device=q.device)[None, None, :] <= q_pos[:, :, None]
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k, v, attn_mask=mask[:, None]
    ).transpose(1, 2)


def measure(torch, pa, flush, dtype, s, cursors, quantized=False, timed=True,
            mp=MP, num_pages=NUM_PAGES, h=H, d=D):
    """One kernel call at (s, cursors) against its plain version (every
    row, parked ones included: both write zeros there) and the library
    yardstick (live rows), then their times and the call's bound. With
    `quantized`, the pools are `quantize_kv` of the same seeded pools and
    the call reads them through the kernel's int8 variant. Not `timed`:
    the check alone (the record carries the error only), which may take
    another view (`mp` pages a slot, `num_pages` in the pool) or another
    head geometry (`h` heads of `d`)."""
    from kubeflow_tpu_torch.ops.attention import quantize_kv

    name = str(dtype).replace("torch.", "")
    kname = pa.kernel_name(s, quantized)
    args = kernel_inputs(torch, dtype, s, "cuda", cursors=cursors, mp=mp,
                         num_pages=num_pages, h=h, d=d)
    kw = {}
    if quantized:
        (args[1], ks), (args[2], vs) = quantize_kv(args[1]), quantize_kv(args[2])
        kw = {"k_scale": ks, "v_scale": vs}
    out = pa.paged_attention(*args, dtype=dtype, **kw)
    ref = pa.paged_attention_reference(*args, dtype=dtype, **kw)
    lib = library_attention(torch, *args, **kw)
    torch.cuda.synchronize()
    live = args[4] < mp * PS
    err = (out.float() - ref.float()).abs().max().item()
    lib_err = (lib[live].float() - ref[live].float()).abs().max().item()
    label = (f"kernel {kname} {name} B={len(cursors)} s={s} cursors {list(cursors)}"
             + ("" if mp == MP else f" view {mp * PS}")
             + ("" if (h, d) == (H, D) else f" H={h} D={d}"))
    print(f"{label}: max_abs_err {err:.3e} (atol {ATOL[name]:g}); library "
          f"max_abs_err {lib_err:.3e}", flush=True)
    if not err <= ATOL[name]:
        raise AssertionError(f"{label} disagrees with its plain version: "
                             f"{err} > {ATOL[name]}")
    if not timed:
        return {"name": kname, "dtype": name, "max_abs_err": err}
    ms = time_ms(torch, lambda: pa.paged_attention(*args, dtype=dtype, **kw),
                 flush)
    plain_ms = time_ms(
        torch, lambda: pa.paged_attention_reference(*args, dtype=dtype, **kw),
        flush,
    )
    library_ms = time_ms(torch, lambda: library_attention(torch, *args, **kw),
                         flush)
    bound_ms, bound_by, nbytes, ops = bound_of(
        name, cursors, args[0].element_size(), s, quantized, h, d
    )
    print(f"{label}: ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
          f"{library_ms:.4f} bound_ms {bound_ms:.5f} ({bound_by}; {nbytes} B, "
          f"{ops} ops)", flush=True)
    return {
        "name": kname, "route": "cuda",
        "source": "kubeflow_tpu_torch/ops/csrc/paged_attention.cu",
        # the kernel function, or its quantized branch's dequant
        "replaces": "kubeflow_tpu/ops/paged_attention.py:" + (
            ("106" if s == 1 else "184") if quantized
            else ("71" if s == 1 else "143")
        ),
        "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        "dtype": name, "bytes": nbytes, "ops": ops,
        "shape": (f"B={len(cursors)} s={s} H={h} D={d} ps={PS} MP={mp} "
                  f"P={num_pages} cursors={list(cursors)}"),
    }


def phase_kernels(torch, quantized=False):
    """Each kernel (its int8 variant when `quantized`: phase 9) against
    its plain version: at the 8-slot decode shape and an 8-slot window
    (ragged cursors, a parked row) in both dtypes, at the batch-1
    windows the main path gives the window kernel, and at phase 11c's
    small-draft calls (SMALL_H heads of SMALL_D: the 8-slot draft step,
    the draft's chunk windows), checked, not timed."""
    from kubeflow_tpu_torch.ops import paged_attention as pa

    flush = torch.empty(2 << 30, dtype=torch.uint8, device="cuda")
    print(f"L2 flush: {time_ms(torch, flush.zero_, flush, iters=5):.4f} ms",
          flush=True)
    records = {}
    for dtype in (torch.bfloat16, torch.float32):
        for s in (1, CHUNK):
            rec = measure(torch, pa, flush, dtype, s, CURSORS, quantized)
            records[(rec["name"], rec["dtype"], "B8")] = rec
        measure(torch, pa, flush, dtype, 1, SPLIT_EDGES, quantized, timed=False)
        # the window kernel at the verify window and over a long view
        measure(torch, pa, flush, dtype, VERIFY, CURSORS, quantized, timed=False)
        for s in (VERIFY, CHUNK):
            measure(torch, pa, flush, dtype, s, LONG_CURSORS, quantized,
                    timed=False, mp=LONG_MP, num_pages=LONG_NUM_PAGES)
        # 11c's draft: its one-token steps (8 slots) and its chunk windows
        # (batch 1 at MAIN_WINDOWS' cursors) read a pool of D = 16 heads
        small = [measure(torch, pa, flush, dtype, 1, CURSORS, quantized,
                         timed=False, h=SMALL_H, d=SMALL_D)]
        small += [measure(torch, pa, flush, dtype, CHUNK, (c,), quantized,
                          timed=False, h=SMALL_H, d=SMALL_D)
                  for c in sorted(set(MAIN_WINDOWS))]
        for rec in small:
            key = (rec["name"], rec["dtype"], "small_draft")
            records[key] = {"max_abs_err": max(
                rec["max_abs_err"], records.get(key, {}).get("max_abs_err", 0.0))}
    # one long row: a slot at cursor 1023 walks 8 splits of 128 keys
    decode = pa.kernel_name(1, quantized)
    long_row = measure(torch, pa, flush, torch.bfloat16, 1, LONG_ROW, quantized)
    b8 = records[(decode, "bfloat16", "B8")]
    print(f"kernel {decode} bf16 one long row (B=1, cursor {LONG_ROW[0]}): ms "
          f"{long_row['ms']:.4f} bound_ms {long_row['bound_ms']:.5f} "
          f"({long_row['bound_ms'] / long_row['ms']:.1%} of bound); the B=8 "
          f"call {b8['ms']:.4f} ms ({b8['bound_ms'] / b8['ms']:.1%} of bound)",
          flush=True)
    # the main path's window calls (bf16, batch 1): each distinct cursor
    # measured once, then averaged over the calls phase 5 (10) makes
    window = pa.kernel_name(CHUNK, quantized)
    per_cursor = {
        c: measure(torch, pa, flush, torch.bfloat16, CHUNK, (c,), quantized)
        for c in sorted(set(MAIN_WINDOWS))
    }
    calls = [per_cursor[c] for c in MAIN_WINDOWS]
    main = dict(calls[0])
    for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
        main[key] = statistics.fmean(r[key] for r in calls)
    main["max_abs_err"] = max(r["max_abs_err"] for r in calls)
    main["bytes"] = sum(r["bytes"] for r in calls)
    main["ops"] = sum(r["ops"] for r in calls)
    main["bound_by"] = (
        "bytes" if main["bytes"] / HBM_BYTES_PER_S
        >= main["ops"] / PEAK_OPS["bfloat16"] else "operations"
    )
    main["shape"] = (f"B=1 s={CHUNK} H={H} D={D} ps={PS} MP={MP} "
                     f"P={NUM_PAGES}; mean over the main path's windows at "
                     f"cursors {list(MAIN_WINDOWS)}")
    print(f"kernel {window} bf16 main-path windows (mean of "
          f"{len(calls)} calls): ms {main['ms']:.4f} plain_ms "
          f"{main['plain_ms']:.4f} library_ms {main['library_ms']:.4f} "
          f"bound_ms {main['bound_ms']:.5f} ({main['bound_by']})", flush=True)
    records[(window, "bfloat16", "main")] = main
    del flush
    return records


def post(port, name, body, timeout=600):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/{name}:generate",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as resp:
        return resp.status, resp.read()


def serve(model, dtype, device, paged_attention="kernel", **knobs):
    from kubeflow_tpu_torch.api.wsgi import Server
    from kubeflow_tpu_torch.serving.main import build_server

    ms = build_server(model, device=device, dtype=dtype,
                      paged_attention=paged_attention, **knobs)
    httpd = Server(ms.app, port=0)
    httpd.start()
    return ms, httpd


def phase_serve_f32(torch, model="gpt_small", device="cuda", prompts=None,
                    max_new=16):
    from kubeflow_tpu_torch.ops import paged_attention as pa
    from kubeflow_tpu_torch.serving.generate import generate

    ms, httpd = serve(model, torch.float32, device, num_slots=8, page_size=16)
    try:
        rng = np.random.default_rng(1)
        lm = ms.lm(model)
        vocab = lm.model.cfg.vocab_size
        pa.reset_launch_counts()
        for n in prompts or (12, 37):
            prompt = rng.integers(0, vocab, n).tolist()
            status, out = post(httpd.port, model,
                               {"prompt_ids": [prompt], "max_new_tokens": max_new})
            if status != 200:
                raise AssertionError(f"f32 :generate answered {status}: {out}")
            want = generate(lm.model, [prompt], max_new)[0].tolist()
            got = out["sequences"][0]
            if got != want:
                raise AssertionError(
                    f"f32 engine tokens differ from generate(): "
                    f"{got[n:]} vs {want[n:]}"
                )
            print(f"serve f32: prompt {n} -> {max_new} tokens equal generate()",
                  flush=True)
        launches = dict(pa.launch_counts)
        kernel = ms.engine(model).stats()["attention_kernel"]
        print(f"serve f32: read path {kernel}, launches {launches}", flush=True)
        if kernel != "kernel" or (device == "cuda" and launches["paged_decode"] < 1):
            raise AssertionError(
                f"the f32 serve did not read through the decode kernel: "
                f"read path {kernel}, launches {launches}"
            )
        return lm.model
    finally:
        httpd.stop()
        ms.close()


def rescore(torch, f32_model, prompt, tokens):
    """Largest gap, over the emitted tokens, between a position's max f32
    logit and the emitted token's (teacher-forced, non-paged forward)."""
    seq = torch.tensor([prompt + tokens], device=f32_model.device)
    with torch.inference_mode():
        logits = f32_model(seq)[0]
    p = len(prompt)
    rows = logits[p - 1 : p - 1 + len(tokens)]
    picked = rows[torch.arange(len(tokens)), torch.tensor(tokens, device=rows.device)]
    return (rows.max(dim=-1).values - picked).max().item()


def phase_serve_bf16(torch, f32_model, model="gpt_small", device="cuda",
                     short=(5, 17, 33, 64, 120), long_len=LONG_LEN,
                     hit_len=HIT_LEN, max_new=32, buckets=BUCKETS,
                     quantize="none"):
    """Phase 5 (phase 10's bf16 half with quantize="int8"): `f32_model`
    rescores every emitted token."""
    from kubeflow_tpu_torch.ops import paged_attention as pa

    os.environ["KFT_SERVING_PREFILL_BUCKETS"] = buckets
    ms, httpd = serve(model, torch.bfloat16, device, num_slots=8, page_size=16,
                      quantize=quantize)
    tag = "bf16" if quantize == "none" else f"{quantize} bf16"
    try:
        vocab = f32_model.cfg.vocab_size
        rng = np.random.default_rng(2)
        prompts = [rng.integers(0, vocab, n).tolist()
                   for n in (*short, long_len, hit_len)]
        results = [None] * len(prompts)

        def run(i):
            results[i] = post(httpd.port, model,
                              {"prompt_ids": [prompts[i]], "max_new_tokens": max_new})

        # warm-up (not timed, not counted): the first bf16 call of each
        # shape pays CUDA's lazy module loading and library heuristics;
        # a prompt past the largest bucket runs both kernels once
        warm = rng.integers(0, vocab, int(buckets.split(",")[-1]) + 4).tolist()
        status, _ = post(httpd.port, model, {"prompt_ids": [warm],
                                             "max_new_tokens": 2})
        if status != 200:
            raise AssertionError(f"{tag} warm-up answered {status}")
        before = ms.engine(model).stats()
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        # the main path's run: every launch count starts at 0 here
        pa.reset_launch_counts()
        t0 = time.monotonic()
        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.monotonic() - t0
        # the 300-token prompt again: its pages are committed now, so it
        # maps them and copies the partially matched boundary page
        prompts.append(prompts[-1])
        results.append(post(httpd.port, model,
                            {"prompt_ids": [prompts[-1]], "max_new_tokens": max_new}))
        launches = dict(pa.launch_counts)
        stats = ms.engine(model).stats()
        # decode steps of this run only (the warm-up's are subtracted)
        steps = stats["decode_steps"] - before["decode_steps"]
        step_ms = (stats["decode_step_ms"] * stats["decode_steps"]
                   - before["decode_step_ms"] * before["decode_steps"]) / max(steps, 1)
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        worst = 0.0
        for prompt, res in zip(prompts, results):
            if res is None or res[0] != 200:
                raise AssertionError(f"{tag} :generate failed: {res}")
            tokens = res[1]["sequences"][0][len(prompt):]
            if len(tokens) != max_new:
                raise AssertionError(f"expected {max_new} tokens, got {len(tokens)}")
            worst = max(worst, rescore(torch, f32_model, prompt, tokens))
        status, body = get(httpd.port, "/healthz")
        if status != 200:
            raise AssertionError(f"/healthz answered {status}")
        status, body = get(httpd.port, "/metrics")
        if status != 200 or b"serving_decode_steps_total" not in body:
            raise AssertionError("/metrics lacks the engine's series")
        gen_tokens = max_new * (len(prompts) - 1)
        print(f"serve {tag}: {len(results)} requests answered 200; "
              f"{gen_tokens} tokens in {wall:.3f} s of concurrent load = "
              f"{gen_tokens / wall:.1f} tokens/s; decode_step_ms "
              f"{step_ms:.3f} over {steps} steps; "
              f"max_memory_allocated {peak} B", flush=True)
        print(f"serve {tag}: stats {json.dumps(stats)}", flush=True)
        print(f"serve {tag}: launches {launches}; worst f32 logit gap of an "
              f"emitted token {worst:.4f} (delta {DELTA})", flush=True)
        if stats["cow_copies"] < 1 or stats["prefix_hit_tokens"] < 1:
            raise AssertionError("the repeated prompt did not hit the prefix cache")
        if stats["attention_kernel"] != "kernel":
            raise AssertionError(f"read path {stats['attention_kernel']}")
        if not worst <= DELTA:
            raise AssertionError(f"an emitted token is {worst} below its "
                                 f"position's max f32 logit (> {DELTA})")
        # the K = 0 numbers phase 11 prints beside its own
        stats = dict(stats, load_tokens_per_s=gen_tokens / wall,
                     load_decode_step_ms=step_ms)
        return launches, stats, steps
    finally:
        os.environ.pop("KFT_SERVING_PREFILL_BUCKETS", None)
        httpd.stop()
        ms.close()


def phase_serve_int8(torch, bf16_stats, model="gpt_small", device="cuda",
                     f32_prompts=(12, 37), f32_max_new=16,
                     accuracy_shape=(4, 256), **traffic):
    """Phase 10: int8 serving (int8 weights, int8 KV pages). f32: the
    same greedy requests through the int8 kernels and through gather +
    dequant_kv must give the same tokens (phase 4's requests:
    `f32_prompts`, `f32_max_new`). bf16: phase 5's traffic
    (`traffic` overrides it, as for phase_serve_bf16), rescored by the f32
    model of the same int8 weights; the pool must hold the int8 capacity
    ratio times phase 5's pages (`bf16_stats`) in no more bytes; then the
    accuracy gate. Returns the bf16 run's (launches, stats, steps)."""
    from kubeflow_tpu_torch.checkpointing.quantize import (
        quantization_accuracy,
        quantize_params_int8,
    )
    from kubeflow_tpu_torch.models.gpt import int8_model
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.ops import paged_attention as pa
    from kubeflow_tpu_torch.serving.engine import (
        auto_num_pages,
        int8_page_capacity_ratio,
    )

    tokens = {}
    for impl in ("kernel", "gather"):
        ms, httpd = serve(model, torch.float32, device, paged_attention=impl,
                          num_slots=8, page_size=16, quantize="int8")
        try:
            rng = np.random.default_rng(1)
            f32_full = ms.lm(model).model  # the ServedLm stays full width
            eng = ms.engine(model)
            pa.reset_launch_counts()
            tokens[impl] = []
            for n in f32_prompts:
                prompt = rng.integers(0, f32_full.cfg.vocab_size, n).tolist()
                status, out = post(httpd.port, model, {
                    "prompt_ids": [prompt], "max_new_tokens": f32_max_new})
                if status != 200:
                    raise AssertionError(f"int8 f32 :generate answered {status}: {out}")
                tokens[impl].append(out["sequences"][0][n:])
            launches = dict(pa.launch_counts)
            stats = eng.stats()
            weights = (eng.model.weight_bytes(), f32_full.weight_bytes())
        finally:
            httpd.stop()
            ms.close()
        print(f"serve int8 f32 {impl}: tokens {tokens[impl]}; launches "
              f"{launches}; resident weights {weights[0]} B int8 against "
              f"{weights[1]} B f32", flush=True)
        if (stats["kv_pool_dtype"], stats["quantize"]) != ("int8", "int8"):
            raise AssertionError(f"the int8 engine's pool is not int8: {stats}")
        if (device == "cuda" and impl == "kernel"
                and (launches["paged_decode_int8"] < 1
                     or launches["paged_decode"] + launches["paged_window"])):
            raise AssertionError(f"the int8 f32 serve did not read through the "
                                 f"int8 decode kernel alone: {launches}")
    if tokens["kernel"] != tokens["gather"]:
        raise AssertionError(f"int8 f32 kernel tokens {tokens['kernel']} differ "
                             f"from gather's {tokens['gather']}")
    print("serve int8 f32: kernel tokens equal gather + dequant_kv tokens",
          flush=True)

    # the f32 model of the int8 weights: dequantized (into f32) at each use
    f32_int8 = int8_model(f32_full)
    launches, stats, steps = phase_serve_bf16(
        torch, f32_int8, model=model, device=device, quantize="int8", **traffic
    )
    cfg = f32_full.cfg
    ratio = int8_page_capacity_ratio(cfg.hidden_size // cfg.num_heads, 2)
    want_pages = int(auto_num_pages(8, cfg.max_len, 16) * ratio)
    print(f"serve int8 bf16: {stats['pages_total']} pool pages in "
          f"{stats['kv_pool_bytes']} B (int8 capacity ratio {ratio:.4f} x "
          f"phase 5's {bf16_stats['pages_total']} pages in "
          f"{bf16_stats['kv_pool_bytes']} B)", flush=True)
    if stats["kv_pool_dtype"] != "int8" or stats["pages_total"] != want_pages:
        raise AssertionError(f"int8 pool: {stats['kv_pool_dtype']} with "
                             f"{stats['pages_total']} pages, not {want_pages}")
    if stats["kv_pool_bytes"] > bf16_stats["kv_pool_bytes"]:
        raise AssertionError("the int8 pool takes more bytes than phase 5's")
    if device == "cuda" and (launches["paged_decode"] or launches["paged_window"]
                             or launches["paged_decode_int8"] < 1):
        raise AssertionError(f"int8 serving launched a full-width kernel or "
                             f"no int8 decode kernel: {launches}")

    ids = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, accuracy_shape)).to(device)
    del f32_int8
    for dtype, full in ((torch.bfloat16, get_model(model, device=device,
                                                   dtype=torch.bfloat16)),
                        (torch.float32, f32_full)):
        params = full.state_dict()
        acc = quantization_accuracy(full, params, quantize_params_int8(params), ids)
        print(f"int8 accuracy {str(dtype)[6:]} over {list(accuracy_shape)} "
              f"held-out tokens: {json.dumps(acc)} (limits {json.dumps(ACCURACY)})",
              flush=True)
        if not all(acc[k] <= ACCURACY[k] for k in ACCURACY):
            raise AssertionError(f"int8 accuracy {acc} above {ACCURACY}")
        del full, params
    return launches, stats, steps


def flash_case(torch, dtype, s, with_mask, dev="cuda", seed=0):
    """q/k/v/dO [FB, s, FH, FD]; with a mask, row 1 keeps its first 3/4."""
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn((FB, s, FH, FD), generator=g).to(dtype).to(dev)
                   for _ in range(4))
    mask = None
    if with_mask:
        mask = torch.ones((FB, s), dtype=torch.int32)
        mask[1, (3 * s) // 4:] = 0
        mask = mask.to(dev)
    return q, k, v, do, mask


def flash_err(torch, got, want, name, key):
    """(max_abs_err, worst, typical) of a flash kernel's output against
    its plain version's: `worst` is the largest, over rows (the last
    axis), of the row's max |got - want| over its limit (FLASH_ATOL in
    f32; in bf16 FLASH_REL x max(the row's max |want|, typical), at least
    FLASH_ATOL), so worst <= 1 passes; `typical` is the median |want|."""
    diff = (got.float() - want.float()).abs()
    ref = want.float().abs()
    typical = ref.median().item()
    floor = FLASH_ATOL[name][key]
    if name == "float32":
        limit = torch.full_like(ref[..., :1], floor)
    else:
        scale = ref.amax(-1, keepdim=True).clamp_min(typical)
        limit = (FLASH_REL * scale).clamp_min(floor)
    worst = (diff.amax(-1, keepdim=True) / limit).max().item()
    return diff.max().item(), worst, typical


def flash_bound(kname, mask, s, itemsize, dtype_name):
    """(bound_ms, bound_by, bytes, ops) of one causal call: ops = c·H·D per
    visible (query, key) pair, c = 4 (QKᵀ, PV), 6 (+dO·Vᵀ, dS·K) or 8
    (QKᵀ, dO·Vᵀ, Pᵀ·dO, dSᵀ·Q); bytes = each input read once and each
    output written once."""
    if mask is None:
        pairs = FB * s * (s + 1) // 2
    else:
        # key j is seen by queries j..s-1 when it is not padding
        m = mask.cpu().numpy()
        pairs = int(sum((s - np.arange(s))[m[b] != 0].sum() for b in range(FB)))
    elems = FB * s * FH * FD
    mask_bytes = 0 if mask is None else 4 * FB * s
    rows = 4 * FB * FH * s  # one f32 per (b, h, row): lse, delta
    c, n_in, n_out, f32_rows = {
        "flash_fwd": (4, 3, 1, 1),        # q k v → o, lse
        "flash_bwd_dq": (6, 4, 1, 2),     # q k v dO lse delta → dq
        "flash_bwd_dkv": (8, 4, 2, 2),    # q k v dO lse delta → dk dv
    }[kname]
    nbytes = (n_in + n_out) * elems * itemsize + f32_rows * rows + mask_bytes
    ops = c * pairs * FH * FD
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, ops)


def library_flash(torch, q, k, v):
    """scaled_dot_product_attention(is_causal=True) on [B, H, S, D]: a
    yardstick timed beside the kernels, never called by the port."""
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True
    ).transpose(1, 2)


def measure_flash(torch, fa, flush, dtype, s, with_mask):
    """The three flash kernels at (dtype, s, mask) against their plain
    versions on the same inputs, then their times, bounds and the library
    yardstick (no-mask calls only: the library's causal call takes no key
    mask)."""
    name = str(dtype).replace("torch.", "")
    tol = FLASH_ATOL[name]
    q, k, v, do, mask = flash_case(torch, dtype, s, with_mask)
    scale = fa.default_scale(FD)
    o, lse = fa.flash_fwd(q, k, v, mask, True, scale)
    ro, rlse = fa.flash_attention_reference(q, k, v, mask, True, scale)
    delta = fa.flash_attention_delta(ro, do)
    dq = fa.flash_bwd_dq(q, k, v, mask, do, rlse, delta, True, scale)
    dk, dv = fa.flash_bwd_dkv(q, k, v, mask, do, rlse, delta, True, scale)
    rdq = fa.flash_bwd_dq_reference(q, k, v, mask, do, rlse, delta, True, scale)
    rdk, rdv = fa.flash_bwd_dkv_reference(q, k, v, mask, do, rlse, delta, True,
                                          scale)
    torch.cuda.synchronize()
    label = f"{name} B={FB} S={s} H={FH} D={FD} causal mask={with_mask}"
    lse_err = (lse - rlse).abs().max().item()
    print(f"flash {label}: lse max_abs_err {lse_err:.3e} (atol {tol['lse']:g})",
          flush=True)
    if not lse_err <= tol["lse"]:
        raise AssertionError(f"flash_fwd lse {label}: {lse_err} > {tol['lse']}")
    errs = {}
    for kname, tname, got, want, key in (
            ("flash_fwd", "o", o, ro, "o"), ("flash_bwd_dq", "dq", dq, rdq, "grad"),
            ("flash_bwd_dkv", "dk", dk, rdk, "grad"),
            ("flash_bwd_dkv", "dv", dv, rdv, "grad")):
        e, worst, typical = flash_err(torch, got, want, name, key)
        limit = (f"atol {tol[key]:g}" if name == "float32" else
                 f"row limit {FLASH_REL:g} x max(row max |value|, median) or "
                 f"{tol[key]:g}; at the median row {FLASH_REL * typical:.3e}")
        print(f"flash {kname} {label}: {tname} max_abs_err {e:.3e}, median "
              f"|{tname}| {typical:.3e}, worst row err/limit {worst:.3f} "
              f"({limit})", flush=True)
        if not worst <= 1.0:
            raise AssertionError(f"{kname} {label} disagrees with its plain "
                                 f"version: {tname} row error {worst:.3f} "
                                 f"x its limit")
        errs[kname] = max(errs.get(kname, 0.0), e)
    calls = {
        "flash_fwd": (
            lambda: fa.flash_fwd(q, k, v, mask, True, scale),
            lambda: fa.flash_attention_reference(q, k, v, mask, True, scale)),
        "flash_bwd_dq": (
            lambda: fa.flash_bwd_dq(q, k, v, mask, do, rlse, delta, True, scale),
            lambda: fa.flash_bwd_dq_reference(q, k, v, mask, do, rlse, delta,
                                              True, scale)),
        "flash_bwd_dkv": (
            lambda: fa.flash_bwd_dkv(q, k, v, mask, do, rlse, delta, True, scale),
            lambda: fa.flash_bwd_dkv_reference(q, k, v, mask, do, rlse, delta,
                                               True, scale)),
    }
    library = {"flash_fwd": None, "flash_bwd_dq": None, "flash_bwd_dkv": None}
    if mask is None:
        library["flash_fwd"] = time_ms(torch, lambda: library_flash(torch, q, k, v),
                                       flush)
        qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
        out = library_flash(torch, qs, ks, vs)
        pair = time_ms(torch, lambda: torch.autograd.grad(
            out, (qs, ks, vs), do, retain_graph=True), flush)
        library["flash_bwd_dq"] = library["flash_bwd_dkv"] = pair
        del out
    records = {}
    for kname, (kernel, plain) in calls.items():
        ms = time_ms(torch, kernel, flush)
        plain_ms = time_ms(torch, plain, flush, iters=10)
        bound_ms, bound_by, nbytes, ops = flash_bound(kname, mask, s,
                                                      q.element_size(), name)
        lib_ms = library[kname]
        print(f"flash {kname} {label}: ms {ms:.4f} plain_ms {plain_ms:.4f} "
              f"library_ms {lib_ms if lib_ms is None else round(lib_ms, 4)} "
              f"bound_ms {bound_ms:.5f} ({bound_by}; {nbytes} B, {ops} ops); "
              f"{bound_ms / ms:.1%} of bound", flush=True)
        records[kname] = {
            "name": kname, "route": "cuda",
            "source": "kubeflow_tpu_torch/ops/csrc/flash_attention.cu",
            "replaces": {
                "flash_fwd": "kubeflow_tpu/ops/flash_attention.py:169",
                "flash_bwd_dq": "kubeflow_tpu/ops/flash_attention.py:276",
                "flash_bwd_dkv": "kubeflow_tpu/ops/flash_attention.py:331",
            }[kname],
            "launches": 0, "max_abs_err": errs[kname], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms, "dtype": name, "bytes": nbytes, "ops": ops,
            "shape": (f"B={FB} S={s} H={FH} D={FD} causal, "
                      f"{'key mask' if with_mask else 'no mask'}"
                      + ("; library_ms is SDPA's whole backward (dQ, dK, dV)"
                         if kname != "flash_fwd" and lib_ms is not None else "")),
        }
    return records


def phase_flash(torch):
    """Phase 6: each flash kernel against its plain version at the main
    path's microbatch shape (bf16, S=4096, no mask as the config runs, and
    with a key mask) and in f32 at S=1024."""
    from kubeflow_tpu_torch.ops import flash_attention as fa

    flush = torch.empty(2 << 30, dtype=torch.uint8, device="cuda")
    main = measure_flash(torch, fa, flush, torch.bfloat16, FS, False)
    measure_flash(torch, fa, flush, torch.bfloat16, FS, True)
    measure_flash(torch, fa, flush, torch.float32, 1024, False)
    measure_flash(torch, fa, flush, torch.float32, 1024, True)
    del flush
    torch.cuda.empty_cache()
    return main


def phase_train_f32(torch, model="gpt_small", seq=1024, device="cuda"):
    """Phase 7: the same 3 f32 steps (`Trainer.fit`) through the flash
    kernels and dense, from one seeded init on the same batches: per-step
    losses and the updates of TRAIN_LEAVES must agree."""
    from kubeflow_tpu_torch.config.platform import TrainingConfig
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.training.trainer import Trainer

    losses, launches, updates = {}, {}, {}
    for impl in ("flash", "dense"):
        cfg = TrainingConfig(
            model=model, seq_len=seq, global_batch_size=2, steps=3,
            learning_rate=3e-4, warmup_steps=1, weight_decay=0.1,
            dtype="float32", attention_impl=impl,
        )
        trainer = Trainer(cfg, device=device)
        state = trainer.init_state()
        init = {n: state.params[n].detach().clone() for n in TRAIN_LEAVES}
        fa.reset_launch_counts()
        trainer.fit(state=state, log_every=cfg.steps)
        launches[impl] = dict(fa.launch_counts)
        losses[impl] = [loss for _, loss in trainer.losses]
        updates[impl] = {n: state.params[n].detach() - init[n]
                         for n in TRAIN_LEAVES}
        print(f"train f32 {impl}: losses {losses[impl]} launches "
              f"{launches[impl]}", flush=True)
        del trainer, state, init
    worst = max(abs(a - b) / abs(b) for a, b in zip(losses["flash"], losses["dense"]))
    gaps = {n: ((updates["flash"][n] - updates["dense"][n]).norm()
                / updates["dense"][n].norm()).item() for n in TRAIN_LEAVES}
    print(f"train f32: worst relative loss gap flash vs dense {worst:.3e} "
          f"(rel {TRAIN_LOSS_REL:g}); relative gap of each leaf's 3-step "
          f"update {json.dumps(gaps)} (rel {TRAIN_UPDATE_REL:g}); update "
          f"norms {json.dumps({n: u.norm().item() for n, u in updates['dense'].items()})}",
          flush=True)
    if len(losses["flash"]) != 3 or not worst <= TRAIN_LOSS_REL:
        raise AssertionError(f"f32 flash and dense losses disagree: {losses}")
    if not all(g <= TRAIN_UPDATE_REL for g in gaps.values()):
        raise AssertionError(f"f32 flash and dense updates disagree: {gaps}")
    if device == "cuda" and (min(launches["flash"].values()) < 1
                             or any(launches["dense"].values())):
        raise AssertionError(f"flash launches wrong: {launches}")


def phase_train_bf16(torch, overrides=None, device="cuda"):
    """Phase 8, the training main path: run_training at TRAIN_CFG."""
    from kubeflow_tpu_torch.config.platform import TrainingConfig
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.ops import flash_attention as fa
    from kubeflow_tpu_torch.runtime.train_run import run_training

    cfg = TrainingConfig(**{**TRAIN_CFG, **(overrides or {})})
    layers = get_model(cfg.model, device="meta", max_len=1).cfg.num_layers
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    # the main path's run: every launch count starts at 0 here
    fa.reset_launch_counts()
    t0 = time.monotonic()
    # one log window after the first-step fence: steps 2..N are enqueued
    # back to back and the host syncs once, at the window's end (each
    # step's loss is read then)
    result = run_training(cfg, device=device, log_every=cfg.steps)
    wall = time.monotonic() - t0
    launches = dict(fa.launch_counts)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    losses = result["losses"]
    print(f"train bf16: per-step loss {losses}", flush=True)
    print(f"train bf16: {cfg.steps} steps in {wall:.3f} s; steady step "
          f"{result['step_time_s'] * 1e3:.3f} ms (wall time of steps 2-"
          f"{cfg.steps} over {cfg.steps - 1}, one host sync at their end); "
          f"{result['items_per_sec']:.1f} tokens/s; mfu {result.get('mfu')}; "
          f"compile_s {result.get('compile_s')}; max_memory_allocated {peak} B",
          flush=True)
    if [s for s, _ in losses] != list(range(1, cfg.steps + 1)):
        raise AssertionError(f"not every step's loss was read: {losses}")
    if not all(np.isfinite(loss) for _, loss in losses):
        raise AssertionError(f"a non-finite loss: {losses}")
    # per step: every layer's forward runs twice under remat (forward and
    # recompute), its backward once, in each microbatch
    a, r = cfg.accum_steps, 2 if cfg.remat else 1
    want = {"flash_fwd": cfg.steps * layers * a * r,
            "flash_bwd_dq": cfg.steps * layers * a,
            "flash_bwd_dkv": cfg.steps * layers * a}
    print(f"train bf16: launches {launches} (config's formula {want})", flush=True)
    if device == "cuda" and launches != want:
        raise AssertionError(f"launches {launches} != {want}")
    return launches, result


def rolled_draft(torch, target):
    """A copy of `target` whose head weight is rolled one vocab row: each
    logit row shifts by one, so its argmax is never the target's."""
    from kubeflow_tpu_torch.models.gpt import Gpt

    draft = Gpt(target.cfg, device=target.device)
    draft.load_state_dict(target.state_dict())
    with torch.no_grad():
        draft.head.kernel.copy_(torch.roll(target.head.kernel, 1, dims=-1))
    return draft


def spec_summary(stats, before=None, num_slots=8):
    """accept_rate, verify_steps, rewind_pages_returned, ms per verify
    iteration, and tokens per iteration (over all slots, and per slot it
    served) of a drafted engine's run (its stats less `before`'s)."""
    before = before or {}
    keys = ("verify_steps", "draft_proposed", "draft_accepted", "tokens",
            "rewind_pages_returned")
    run = {k: stats[k] - before.get(k, 0) for k in keys}
    total_ms = (stats["decode_step_ms"] * stats["decode_steps"]
                - before.get("decode_step_ms", 0.0)
                * before.get("decode_steps", 0))
    steps = max(run["verify_steps"], 1)
    # slot-iterations: each verify iteration once per slot it served
    slot_steps = (stats["mean_occupancy"] * stats["decode_steps"]
                  - before.get("mean_occupancy", 0.0)
                  * before.get("decode_steps", 0)) * num_slots
    run["accept_rate"] = run["draft_accepted"] / max(run["draft_proposed"], 1)
    run["verify_iteration_ms"] = total_ms / steps
    run["tokens_per_iteration"] = run["tokens"] / steps
    run["tokens_per_slot_iteration"] = run["tokens"] / max(slot_steps, 1e-9)
    return run


def phase_spec_f32(torch, model="gpt_small", device="cuda", prompts=(12, 37),
                   max_new=16, k=SPEC_K):
    """11a: phase 4's greedy prompts through drafted f32 engines (the
    target's own weights as the draft, then the rolled-head draft) must
    equal `generate()`; at int8 a drafted engine must equal the K = 0
    int8 engine."""
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.ops import paged_attention as pa
    from kubeflow_tpu_torch.serving.engine import DecodeEngine
    from kubeflow_tpu_torch.serving.generate import generate

    target = get_model(model, device=device, dtype=torch.float32)
    rng = np.random.default_rng(1)  # phase 4's prompts
    rows = [rng.integers(0, target.cfg.vocab_size, n) for n in prompts]
    want = [generate(target, r[None], max_new)[0, len(r):].tolist() for r in rows]

    def run(draft, kk, quantize="none"):
        eng = DecodeEngine("spec", target, device=device, num_slots=8,
                           page_size=16, paged_attention="kernel",
                           quantize=quantize, draft_model=draft,
                           num_draft_tokens=kk)
        try:
            futures = [eng.submit(r, max_new) for r in rows]
            return [f.wait(600)["tokens"] for f in futures], eng.stats()
        finally:
            eng.close()

    # the same weights accept every proposal (a draft pool out of lockstep
    # with the target's, or a wrong draft read, shows here and not in the
    # tokens); the rolled head proposes the target's argmax + 1, never it
    for label, draft, accept in (("same weights", target, ACCEPT_SAME),
                                 ("rolled head", rolled_draft(torch, target), 0.0)):
        pa.reset_launch_counts()
        got, stats = run(draft, k)
        launches = dict(pa.launch_counts)
        summary = spec_summary(stats)
        print(f"spec f32 ({label} draft, K={k}): {json.dumps(summary)}; "
              f"launches {launches}", flush=True)
        if got != want:
            raise AssertionError(f"f32 drafted tokens ({label}) differ from "
                                 f"generate(): {got} vs {want}")
        if not (summary["accept_rate"] >= accept if accept
                else summary["draft_accepted"] == 0):
            raise AssertionError(f"f32 {label} draft: accept_rate "
                                 f"{summary['accept_rate']} (want "
                                 f"{'>= ' if accept else ''}{accept})")
        if device == "cuda" and (launches["paged_decode"] < 1
                                 or launches["paged_window"] < 1):
            raise AssertionError(f"the f32 drafted serve missed a kernel: {launches}")
        del draft
    print(f"spec f32: both drafts' tokens equal generate() (prompts {list(prompts)}, "
          f"{max_new} new)", flush=True)
    k0, _ = run(None, 0, "int8")
    pa.reset_launch_counts()
    drafted, stats = run(target, k, "int8")
    launches = dict(pa.launch_counts)
    print(f"spec int8 f32 (K={k}): {json.dumps(spec_summary(stats))}; launches "
          f"{launches}", flush=True)
    if drafted != k0:
        raise AssertionError(f"int8 drafted tokens {drafted} differ from the K = 0 "
                             f"int8 engine's {k0}")
    if device == "cuda" and (launches["paged_decode_int8"] < 1
                             or launches["paged_window_int8"] < 1
                             or launches["paged_decode"] + launches["paged_window"]):
        raise AssertionError(f"the int8 drafted serve did not read through the "
                             f"int8 kernels alone: {launches}")
    print("spec int8 f32: drafted tokens equal the K = 0 int8 engine's", flush=True)
    return target


def check_spec_launches(tag, launches, run, device, windows, target_layers,
                        draft_layers, k=SPEC_K):
    """The drafted engine's launch formula: every one-token read is a draft
    step (K+1 an iteration, one per draft layer), every window read a
    verify (one per target layer) or a chunk window of either model."""
    want = {"paged_decode": run["verify_steps"] * (k + 1) * draft_layers,
            "paged_window": (run["verify_steps"] * target_layers
                             + len(windows) * (target_layers + draft_layers))}
    print(f"{tag}: launches {launches} (formula {want})", flush=True)
    if device == "cuda" and {n: launches[n] for n in want} != want:
        raise AssertionError(f"{tag}: launches {launches} != formula {want}")


def spec_traffic(f32_model, short, long_len, hit_len):
    """Phase 5's prompts (its seed, its lengths), then the hit prompt again."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, f32_model.cfg.vocab_size, n).tolist()
               for n in (*short, long_len, hit_len)]
    return prompts, rng


def phase_spec_serve(torch, f32_model, k0_stats, model="gpt_small", device="cuda",
                     short=(5, 17, 33, 64, 120), long_len=LONG_LEN,
                     hit_len=HIT_LEN, max_new=32, buckets=BUCKETS, k=SPEC_K):
    """11b: the drafted bf16 server (the draft is the registry model's
    seed-0 init, the target's) on phase 5's traffic over REST; phase 5's
    K = 0 tokens/s and step time (`k0_stats`) are printed beside. Returns
    the run's launches."""
    from kubeflow_tpu_torch.ops import paged_attention as pa

    os.environ["KFT_SERVING_PREFILL_BUCKETS"] = buckets
    ms, httpd = serve(model, torch.bfloat16, device, num_slots=8, page_size=16,
                      draft_model=model, num_draft_tokens=k)
    largest = int(buckets.split(",")[-1])
    try:
        eng = ms.engine(model)
        prompts, rng = spec_traffic(f32_model, short, long_len, hit_len)
        results = [None] * len(prompts)

        def run(i):
            results[i] = post(httpd.port, model,
                              {"prompt_ids": [prompts[i]], "max_new_tokens": max_new})

        warm = rng.integers(0, f32_model.cfg.vocab_size, largest + 4).tolist()
        status, _ = post(httpd.port, model, {"prompt_ids": [warm],
                                             "max_new_tokens": 2})
        if status != 200:
            raise AssertionError(f"spec bf16 warm-up answered {status}")
        before = eng.stats()
        # the main path's run with speculation: every count starts at 0 here
        pa.reset_launch_counts()
        t0 = time.monotonic()
        threads = [threading.Thread(target=run, args=(i,)) for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.monotonic() - t0
        prompts.append(prompts[-1])
        results.append(post(httpd.port, model,
                            {"prompt_ids": [prompts[-1]], "max_new_tokens": max_new}))
        launches = dict(pa.launch_counts)
        stats = eng.stats()
        run_stats = spec_summary(stats, before)
        worst = 0.0
        for prompt, res in zip(prompts, results):
            if res is None or res[0] != 200:
                raise AssertionError(f"spec bf16 :generate failed: {res}")
            tokens = res[1]["sequences"][0][len(prompt):]
            if len(tokens) != max_new:
                raise AssertionError(f"expected {max_new} tokens, got {len(tokens)}")
            worst = max(worst, rescore(torch, f32_model, prompt, tokens))
        gen_tokens = max_new * (len(prompts) - 1)
        print(f"spec bf16 (REST, same-weights draft, K={k}): {len(results)} "
              f"requests answered 200; {gen_tokens} tokens in {wall:.3f} s of "
              f"concurrent load = {gen_tokens / wall:.1f} tokens/s; "
              f"{json.dumps(run_stats)}; K = 0 (phase 5, this call): "
              f"{k0_stats['load_tokens_per_s']:.1f} tokens/s, decode_step_ms "
              f"{k0_stats['load_decode_step_ms']:.3f}", flush=True)
        print(f"spec bf16: stats {json.dumps(stats)}", flush=True)
        print(f"spec bf16: worst f32 logit gap of an emitted token {worst:.4f} "
              f"(delta {DELTA})", flush=True)
        layers = f32_model.cfg.num_layers
        check_spec_launches("spec bf16", launches, run_stats, device,
                            main_windows(long_len, hit_len, largest), layers, layers)
        if not worst <= DELTA:
            raise AssertionError(f"an emitted token is {worst} below its "
                                 f"position's max f32 logit (> {DELTA})")
        if stats["cow_copies"] < 1 or stats["decode_steps"] != stats["verify_steps"]:
            raise AssertionError(f"spec bf16: no prefix hit, or a one-token step "
                                 f"ran: {stats}")
        if stats["pages_in_use"] != stats["prefix_index_pages"]:
            raise AssertionError(f"spec bf16 leaked pages: {stats['pages_in_use']} "
                                 f"in use, {stats['prefix_index_pages']} in the "
                                 f"prefix index")
        sampled = {"prompt_ids": [prompts[2]], "max_new_tokens": max_new,
                   "temperature": 0.8, "top_k": 50, "seed": 1234}
        twice = [post(httpd.port, model, sampled) for _ in range(2)]
        if any(st != 200 for st, _ in twice) or twice[0][1] != twice[1][1]:
            raise AssertionError(f"a sampled request sent twice with one seed "
                                 f"differs: {twice}")
        print(f"spec bf16: a sampled request (temperature 0.8, top_k 50) sent "
              f"twice with one seed returned the same {max_new} tokens", flush=True)
        return launches
    finally:
        os.environ.pop("KFT_SERVING_PREFILL_BUCKETS", None)
        httpd.stop()
        ms.close()


def phase_spec_small_draft(torch, f32_model, model="gpt_small", device="cuda",
                           short=(5, 17, 33, 64, 120), long_len=LONG_LEN,
                           hit_len=HIT_LEN, max_new=32, buckets=BUCKETS,
                           k=SPEC_K):
    """11c: a bf16 engine whose draft has SMALL_DRAFT's widths on phase
    5's traffic (the hit prompt once more after the rest)."""
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.ops import paged_attention as pa
    from kubeflow_tpu_torch.serving.engine import DecodeEngine

    target = get_model(model, device=device, dtype=torch.bfloat16)
    draft = get_model(model, device=device, dtype=torch.bfloat16, **SMALL_DRAFT)
    eng = DecodeEngine("spec-small", target, device=device, num_slots=8,
                       page_size=16, paged_attention="kernel",
                       prefill_buckets=[int(b) for b in buckets.split(",")],
                       draft_model=draft, num_draft_tokens=k)
    try:
        prompts, rng = spec_traffic(f32_model, short, long_len, hit_len)
        largest = eng.prefill_buckets[-1]
        warm = rng.integers(0, f32_model.cfg.vocab_size, largest + 4)
        eng.generate_row(warm, 2, timeout=600)
        before = eng.stats()
        pa.reset_launch_counts()
        t0 = time.monotonic()
        futures = [eng.submit(p, max_new) for p in prompts]
        results = [f.wait(900)["tokens"] for f in futures]
        wall = time.monotonic() - t0
        prompts.append(prompts[-1])
        results.append(eng.generate_row(prompts[-1], max_new, timeout=600)["tokens"])
        launches = dict(pa.launch_counts)
        stats = eng.stats()
    finally:
        eng.close()
    run_stats = spec_summary(stats, before)
    worst = max(rescore(torch, f32_model, p, r) for p, r in zip(prompts, results))
    gen_tokens = max_new * (len(prompts) - 1)
    print(f"spec bf16 small draft ({draft.cfg.hidden_size}/{draft.cfg.num_layers}/"
          f"{draft.cfg.num_heads}/{draft.cfg.mlp_dim}, head dim "
          f"{draft.cfg.head_dim}, K={k}): {gen_tokens} tokens in {wall:.3f} s "
          f"= {gen_tokens / wall:.1f} tokens/s; {json.dumps(run_stats)}; worst f32 "
          f"logit gap {worst:.4f} (delta {DELTA})", flush=True)
    check_spec_launches("spec bf16 small draft", launches, run_stats, device,
                        main_windows(long_len, hit_len, largest),
                        target.cfg.num_layers, draft.cfg.num_layers)
    if any(len(r) != max_new for r in results) or not worst <= DELTA:
        raise AssertionError(f"small-draft serve: lengths "
                             f"{[len(r) for r in results]}, worst gap {worst}")
    if stats["rewind_pages_returned"] < 1:
        raise AssertionError("no rewind gave a page back")
    if stats["pages_in_use"] != stats["prefix_index_pages"]:
        raise AssertionError(f"small-draft serve leaked pages: {stats}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from kubeflow_tpu_torch.native.build import build_all, build_logs

    # f32 means f32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    print(f"device: {smi} | torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    t0 = time.monotonic()
    libs = build_all()
    print(f"build: {sorted(libs)} in {time.monotonic() - t0:.2f} s", flush=True)
    for name, log in build_logs.items():
        print(f"build log {name}:\n{log.strip()}", flush=True)
    report = hopper_kernel_report(build_logs["flash_attention"])
    report.update(hopper_kernel_report(build_logs["paged_attention"],
                                       WINDOW_HOPPER_KERNELS))
    print("ptxas, the Hopper kernels (registers a thread at launch; no spills, "
          "setmaxnreg honoured): " + ", ".join(
              f"{k} D={d} {r[0]}" for (k, d), r in sorted(report.items())),
          flush=True)

    records = phase_kernels(torch)
    f32_model = phase_serve_f32(torch)
    launches, bf16_stats, steps = phase_serve_bf16(torch, f32_model)
    layers = f32_model.cfg.num_layers
    del f32_model
    print(f"launches per decode step: "
          f"{launches['paged_decode'] / max(steps, 1):.2f} "
          f"(one per layer, {layers})", flush=True)
    # phase 3 timed the window kernel at the calls MAIN_WINDOWS lists:
    # one launch per layer for each
    if launches["paged_window"] != len(MAIN_WINDOWS) * layers:
        raise AssertionError(
            f"the main path made {launches['paged_window']} window launches, "
            f"not the {len(MAIN_WINDOWS)} windows x {layers} layers that "
            f"phase 3 measured"
        )
    kernels = []
    for key in (("paged_decode", "bfloat16", "B8"),
                ("paged_window", "bfloat16", "main")):
        rec = dict(records[key])
        rec["launches"] = launches[key[0]]
        if rec["launches"] < 1:
            raise AssertionError(f"the main path never launched {key[0]}")
        kernels.append(rec)
    torch.cuda.empty_cache()

    flash_records = phase_flash(torch)
    phase_train_f32(torch)
    torch.cuda.empty_cache()
    train_launches, _ = phase_train_bf16(torch)
    for kname, rec in flash_records.items():
        rec = dict(rec)
        rec["launches"] = train_launches[kname]
        if rec["launches"] < 1:
            raise AssertionError(f"the training main path never launched {kname}")
        kernels.append(rec)
    torch.cuda.empty_cache()

    int8_records = phase_kernels(torch, quantized=True)
    int8_launches, _, int8_steps = phase_serve_int8(torch, bf16_stats)
    print(f"int8 launches per decode step: "
          f"{int8_launches['paged_decode_int8'] / max(int8_steps, 1):.2f} "
          f"(one per layer, {layers})", flush=True)
    if int8_launches["paged_window_int8"] != len(MAIN_WINDOWS) * layers:
        raise AssertionError(
            f"the int8 path made {int8_launches['paged_window_int8']} window "
            f"launches, not the {len(MAIN_WINDOWS)} windows x {layers} layers "
            f"that phase 9 measured"
        )
    for key in (("paged_decode_int8", "bfloat16", "B8"),
                ("paged_window_int8", "bfloat16", "main")):
        rec = dict(int8_records[key])
        rec["launches"] = int8_launches[key[0]]
        if rec["launches"] < 1:
            raise AssertionError(f"the int8 main path never launched {key[0]}")
        kernels.append(rec)
    torch.cuda.empty_cache()

    f32_model = phase_spec_f32(torch)
    spec_launches = phase_spec_serve(torch, f32_model, bf16_stats)
    small_launches = phase_spec_small_draft(torch, f32_model)
    del f32_model
    small_shapes = {
        "paged_decode": f"B=8 s=1 H={SMALL_H} D={SMALL_D} cursors={list(CURSORS)}",
        "paged_window": (f"B=1 s={CHUNK} H={SMALL_H} D={SMALL_D} cursors="
                         f"{sorted(set(MAIN_WINDOWS))} (the draft's chunk "
                         f"windows); the target's verify at B=8 s={VERIFY} "
                         f"H={H} D={D}"),
    }
    for rec in kernels[:2]:
        # this slice's path: the drafted bf16 serve (11b), then 11c's,
        # whose draft calls run at D = 16 (phase 3 held them, not timed)
        rec["spec_launches"] = spec_launches[rec["name"]]
        rec["small_draft_launches"] = small_launches[rec["name"]]
        rec["small_draft_shape"] = small_shapes[rec["name"]]
        rec["small_draft_max_abs_err"] = records[
            (rec["name"], "bfloat16", "small_draft")]["max_abs_err"]
        if min(rec["spec_launches"], rec["small_draft_launches"]) < 1:
            raise AssertionError(f"the speculative path never launched {rec['name']}")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
