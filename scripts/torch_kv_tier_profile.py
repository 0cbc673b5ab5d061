#!/usr/bin/env python3
"""Where the time to first token goes on the port's KV-tier paths:
a cold prefill, an HBM prefix hit and a host-tier hit, on the card.

    python3 scripts/torch_kv_tier_profile.py [--quantize none|int8]
        [--repeats N] [--trace]

Builds gpt_small (seeded weights; bf16, or int8 KV pages with f32
compute as chip_smoke.py 13a) behind the port's DecodeEngine (8 slots,
page 16, paged_attention=kernel) and sends chip_smoke.py 13a's traffic
(`spill_traffic`: a 512-token prefix with a tail, four 512-token fills,
the prefix with a new tail, the first request again), one request at a
time, to an always-resident engine (auto pool, no tier) and to a tiered
one (KV_POOL_PAGES pages over a host tier of KV_HOST_BYTES), `--repeats`
times, each in fresh engines. Prints every request's TTFT (the engine's
own clock) with the device programs each admission ran (wall ms, each
call bracketed by synchronize, so their sum is what the device path
costs the host) and the rest of the admission (host bookkeeping).
`--trace` also prints the host-tier hit's top ops by self CPU time
(torch.profiler over the scheduler's threads, CPU activity). Needs a
CUDA device.
"""

from __future__ import annotations

import collections
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

PROGRAMS = ("prefill", "insert", "chunk", "cow", "spill", "upload")


def timed_programs(torch, eng):
    """Wrap the engine's admission programs: each call is bracketed by
    synchronize and its wall time added to the returned counter."""
    spent = collections.Counter()
    calls = collections.Counter()
    for name in PROGRAMS:
        fn = getattr(eng.programs, name)

        def wrapped(*args, _fn=fn, _name=name, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*args, **kw)
            torch.cuda.synchronize()
            spent[_name] += (time.perf_counter() - t0) * 1e3
            calls[_name] += 1
            return out

        setattr(eng.programs, name, wrapped)
    return spent, calls


def main(argv=None) -> int:
    import argparse

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from kubeflow_tpu_torch.models import get_model
    from kubeflow_tpu_torch.serving.engine import DecodeEngine

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quantize", choices=("none", "int8"), default="none")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--trace", action="store_true",
                    help="also trace the tiered engine's host-tier hit with "
                    "torch.profiler and print its top ops by self CPU time")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_kv_tier_profile: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = torch.bfloat16 if args.quantize == "none" else torch.float32
    model = get_model("gpt_small", dtype=dtype)
    rows = chip_smoke.spill_traffic(model.cfg.vocab_size, chip_smoke.KV_SHARED,
                                    chip_smoke.KV_TAIL, chip_smoke.KV_FILLS)
    names = ["first (cold)"] + [f"fill {i}" for i in range(chip_smoke.KV_FILLS)] \
        + ["prefix, new tail", "first again"]
    print(f"device: {chip_smoke.smi_line()} | gpt_small "
          f"{str(dtype)[6:]} quantize={args.quantize}", flush=True)
    for rep in range(args.repeats):
        for kind in ("resident", "tiered"):
            knobs = ({"num_pages": chip_smoke.KV_POOL_PAGES,
                      "kv_host_bytes": chip_smoke.KV_HOST_BYTES}
                     if kind == "tiered" else {})
            eng = DecodeEngine("gpt_small", model, num_slots=8, page_size=16,
                               paged_attention="kernel",
                               quantize=args.quantize, **knobs)
            try:
                spent, calls = timed_programs(torch, eng)
                for name, row in zip(names, rows):
                    before = dict(spent)
                    before_calls = dict(calls)
                    # one token: the request's time is its admission
                    traced = (args.trace and kind == "tiered"
                              and name == "prefix, new tail")
                    if traced:
                        prof = profile(activities=[ProfilerActivity.CPU])
                        prof.__enter__()
                    out = eng.generate_row(row, 1, timeout=600)
                    if traced:
                        prof.__exit__(None, None, None)
                        print(prof.key_averages().table(
                            sort_by="self_cpu_time_total", row_limit=15),
                            flush=True)
                    ttft = out["ttft_s"] * 1e3
                    parts = {k: spent[k] - before.get(k, 0.0) for k in spent
                             if spent[k] - before.get(k, 0.0) > 0}
                    ncalls = {k: calls[k] - before_calls.get(k, 0)
                              for k in parts}
                    rest = ttft - sum(parts.values())
                    print(f"repeat {rep} {kind:8s} {name:17s} TTFT "
                          f"{ttft:8.3f} ms = " + ", ".join(
                              f"{k} {v:.3f} ({ncalls[k]})"
                              for k, v in sorted(parts.items()))
                          + f", other {rest:.3f}", flush=True)
            finally:
                eng.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
