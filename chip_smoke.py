#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (kubeflow_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):

1. Device: raise unless CUDA is available; print the card's name and
   power limit as nvidia-smi reports them.
2. Build: nvcc builds every kernel under kubeflow_tpu_torch/ops/csrc into
   build/kernels/ (one nvcc per source, started together).
3. Kernels vs plain: each paged-attention kernel against its plain
   PyTorch version on the card, at gpt_small's serving shapes (8 slots,
   12 heads x 64, page 16, 64 pages a slot, 384 pool pages), bf16 and
   f32, with ragged cursors (0, 15, 16, 1023 and a parked 1024); then
   the window kernel at the batch-1 calls phase 5 makes (MAIN_WINDOWS),
   whose mean the kernels line reports. Times are medians over CUDA
   events with the L2 flushed before each launch.
4. Serve f32: gpt_small at full width (seeded init) behind the REST
   server on a real socket, paged_attention=kernel; two greedy
   `:generate` requests must equal the port's `generate()`.
5. Serve bf16 (the main path): the same server in bf16 with prefill
   buckets 8..256; concurrent requests of 5-120 tokens, one ~700-token
   prompt (head prefill + chunk windows through the window kernel) and
   one 300-token prompt sent twice (a prefix hit with copy-on-write).
   Every reply must be 200, every emitted token's f32 teacher-forced
   logit within DELTA of its position's max, and both kernels launched.

The last lines are the nvidia-smi line, a {"kernels": [...]} JSON line,
and {"ok": true, "device": {...}}. f32 matmuls run in full f32: TF32 is
turned off for matmuls and cuDNN below.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

# tolerances of each kernel against its plain version on the same inputs:
# f32 differs only in summation order; bf16 may also round a score,
# probability or output element one bf16 ulp apart (2^-8 relative)
ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
# a bf16 greedy token may differ from f32's argmax on a near-tie: each
# emitted token's f32 logit must be within DELTA of its position's max
DELTA = 0.25
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and dense ops/s by type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}

# gpt_small serving geometry (engine defaults: 8 slots, page 16)
B, H, D, PS, MP, NUM_PAGES = 8, 12, 64, 16, 64, 384
# ragged cursors of the 8-slot calls; 1024 = max_len is a parked slot
CURSORS = (0, 15, 16, 1023, 1024, 300, 517, 64)

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
MAIN_WINDOWS = (*range(LARGEST, LONG_LEN, CHUNK),
                *range(LARGEST, HIT_LEN, CHUNK), HIT_LEN - 1)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()


def kernel_inputs(torch, dtype, s, dev, cursors=CURSORS, seed=0):
    """q, pools, page table and cursors at the serving shapes: each slot
    owns distinct pages up to its last live one; entries past it are
    stale (random) and must never be read."""
    g = torch.Generator().manual_seed(seed)
    b = len(cursors)
    q = torch.randn((b, s, H, D), generator=g).to(dtype)
    pool_k = torch.randn((NUM_PAGES, PS, H, D), generator=g).to(dtype)
    pool_v = torch.randn((NUM_PAGES, PS, H, D), generator=g).to(dtype)
    perm = torch.randperm(NUM_PAGES, generator=g).tolist()
    table = torch.randint(0, NUM_PAGES, (b, MP), generator=g, dtype=torch.int32)
    for row, cur in enumerate(cursors):
        live = min((cur + s - 1) // PS, MP - 1) + 1
        table[row, :live] = torch.tensor(perm[:live], dtype=torch.int32)
        perm = perm[live:]
    cursors = torch.tensor(cursors, dtype=torch.int32)
    return [t.to(dev) for t in (q, pool_k, pool_v, table, cursors)]


def work_bounds(cursors, itemsize, s):
    """(bytes, ops) this call needs: each live K/V vector read once, the
    live rows' q read once, every output row written once, the live
    pages' table entries and the cursors read; 4 ops per live (query
    row, key, element) — QK^T and PV. A parked row (cursor past the
    window) needs only its output written."""
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
    nbytes = (2 * kv_keys + (live_rows + len(cursors)) * s) * H * D * itemsize
    nbytes += 4 * (pages + len(cursors))
    ops = 4 * pairs * H * D
    return nbytes, ops


def bound_of(name, cursors, itemsize, s):
    """(bound_ms, bound_by, bytes, ops) of one call on the H100."""
    nbytes, ops = work_bounds(cursors, itemsize, s)
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


def library_attention(torch, q, pool_k, pool_v, table, cursors):
    """gather + torch's scaled_dot_product_attention: a yardstick timed
    beside the kernels, never called by the port."""
    from kubeflow_tpu_torch.ops.attention import paged_kv_view

    s = q.shape[1]
    k = paged_kv_view(pool_k, table).transpose(1, 2)
    v = paged_kv_view(pool_v, table).transpose(1, 2)
    q_pos = cursors.long()[:, None] + torch.arange(s, device=q.device)
    mask = torch.arange(k.shape[2], device=q.device)[None, None, :] <= q_pos[:, :, None]
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k, v, attn_mask=mask[:, None]
    ).transpose(1, 2)


def measure(torch, pa, flush, dtype, s, cursors):
    """One kernel call at (s, cursors) against its plain version (every
    row, parked ones included: both write zeros there) and the library
    yardstick (live rows), then their times and the call's bound."""
    name = str(dtype).replace("torch.", "")
    kname = pa.kernel_name(s)
    args = kernel_inputs(torch, dtype, s, "cuda", cursors=cursors)
    out = pa.paged_attention(*args, dtype=dtype)
    ref = pa.paged_attention_reference(*args, dtype=dtype)
    lib = library_attention(torch, *args)
    torch.cuda.synchronize()
    live = args[4] < MP * PS
    err = (out.float() - ref.float()).abs().max().item()
    lib_err = (lib[live].float() - ref[live].float()).abs().max().item()
    label = f"kernel {kname} {name} B={len(cursors)} s={s} cursors {list(cursors)}"
    print(f"{label}: max_abs_err {err:.3e} (atol {ATOL[name]:g}); library "
          f"max_abs_err {lib_err:.3e}", flush=True)
    if not err <= ATOL[name]:
        raise AssertionError(f"{label} disagrees with its plain version: "
                             f"{err} > {ATOL[name]}")
    ms = time_ms(torch, lambda: pa.paged_attention(*args, dtype=dtype), flush)
    plain_ms = time_ms(
        torch, lambda: pa.paged_attention_reference(*args, dtype=dtype), flush
    )
    library_ms = time_ms(torch, lambda: library_attention(torch, *args), flush)
    bound_ms, bound_by, nbytes, ops = bound_of(name, cursors, args[0].element_size(), s)
    print(f"{label}: ms {ms:.4f} plain_ms {plain_ms:.4f} library_ms "
          f"{library_ms:.4f} bound_ms {bound_ms:.5f} ({bound_by}; {nbytes} B, "
          f"{ops} ops)", flush=True)
    return {
        "name": kname, "route": "cuda",
        "source": "kubeflow_tpu_torch/ops/csrc/paged_attention.cu",
        "replaces": (
            "kubeflow_tpu/ops/paged_attention.py:71" if s == 1
            else "kubeflow_tpu/ops/paged_attention.py:143"
        ),
        "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        "dtype": name, "bytes": nbytes, "ops": ops,
        "shape": (f"B={len(cursors)} s={s} H={H} D={D} ps={PS} MP={MP} "
                  f"P={NUM_PAGES} cursors={list(cursors)}"),
    }


def phase_kernels(torch):
    """Each kernel against its plain version: at the 8-slot decode shape
    and an 8-slot window (ragged cursors, a parked row) in both dtypes,
    and at the batch-1 windows the main path gives the window kernel."""
    from kubeflow_tpu_torch.ops import paged_attention as pa

    flush = torch.empty(2 << 30, dtype=torch.uint8, device="cuda")
    print(f"L2 flush: {time_ms(torch, flush.zero_, flush, iters=5):.4f} ms",
          flush=True)
    records = {}
    for dtype in (torch.bfloat16, torch.float32):
        for s in (1, CHUNK):
            rec = measure(torch, pa, flush, dtype, s, CURSORS)
            records[(rec["name"], rec["dtype"], "B8")] = rec
    # the main path's window calls (bf16, batch 1): each distinct cursor
    # measured once, then averaged over the calls phase 5 makes
    per_cursor = {
        c: measure(torch, pa, flush, torch.bfloat16, CHUNK, (c,))
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
    print(f"kernel paged_window bf16 main-path windows (mean of "
          f"{len(calls)} calls): ms {main['ms']:.4f} plain_ms "
          f"{main['plain_ms']:.4f} library_ms {main['library_ms']:.4f} "
          f"bound_ms {main['bound_ms']:.5f} ({main['bound_by']})", flush=True)
    records[("paged_window", "bfloat16", "main")] = main
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


def serve(model, dtype, device, **knobs):
    from kubeflow_tpu_torch.api.wsgi import Server
    from kubeflow_tpu_torch.serving.main import build_server

    ms = build_server(model, device=device, dtype=dtype,
                      paged_attention="kernel", **knobs)
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
                     hit_len=HIT_LEN, max_new=32, buckets=BUCKETS):
    from kubeflow_tpu_torch.ops import paged_attention as pa

    os.environ["KFT_SERVING_PREFILL_BUCKETS"] = buckets
    ms, httpd = serve(model, torch.bfloat16, device, num_slots=8, page_size=16)
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
            raise AssertionError(f"bf16 warm-up answered {status}")
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
                raise AssertionError(f"bf16 :generate failed: {res}")
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
        print(f"serve bf16: {len(results)} requests answered 200; "
              f"{gen_tokens} tokens in {wall:.3f} s of concurrent load = "
              f"{gen_tokens / wall:.1f} tokens/s; decode_step_ms "
              f"{step_ms:.3f} over {steps} steps; "
              f"max_memory_allocated {peak} B", flush=True)
        print(f"serve bf16: stats {json.dumps(stats)}", flush=True)
        print(f"serve bf16: launches {launches}; worst f32 logit gap of an "
              f"emitted token {worst:.4f} (delta {DELTA})", flush=True)
        if stats["cow_copies"] < 1 or stats["prefix_hit_tokens"] < 1:
            raise AssertionError("the repeated prompt did not hit the prefix cache")
        if stats["attention_kernel"] != "kernel":
            raise AssertionError(f"read path {stats['attention_kernel']}")
        if not worst <= DELTA:
            raise AssertionError(f"an emitted token is {worst} below its "
                                 f"position's max f32 logit (> {DELTA})")
        return launches, stats, steps
    finally:
        os.environ.pop("KFT_SERVING_PREFILL_BUCKETS", None)
        httpd.stop()
        ms.close()


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

    records = phase_kernels(torch)
    f32_model = phase_serve_f32(torch)
    launches, _, steps = phase_serve_bf16(torch, f32_model)
    layers = f32_model.cfg.num_layers
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
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
