#!/usr/bin/env python3
"""Where a decode step of the PyTorch port's serving engine spends its
time on the card: a torch.profiler window over steady-state decode.

    python3 scripts/torch_decode_profile.py [--quantize none|int8]
        [--draft-tokens K [--draft same|small]]

Builds gpt_small in bf16 (seeded weights) behind the port's DecodeEngine
(8 slots, page 16, paged_attention=kernel; `--quantize int8` serves int8
weights over int8 KV pages through the kernels' int8 variants) and fills
every slot with a 300-token prompt. Once all slots decode, it times a window of decode
steps unprofiled (the engine's own step clock), then profiles a second
window with CUDA activity only (kernel durations are the device's own;
the profiler slows the host side, so the step time comes from the
first window, and the traced steps are counted by the decode kernel's
launches, one per layer). Prints the step time, the device's busy time
a step (the sum of kernel times) and so its idle share, and the kernels
that take the most device time. Needs a CUDA device.

With `--draft-tokens K` the engine decodes speculatively (K+1 draft
steps and one K+1-row verify an iteration) with a draft that is the
target's own weights (`same`) or gpt_tiny's widths at gpt_small's
vocabulary (`small`, chip_smoke.py SMALL_DRAFT); the step is then a
verify iteration, the traced ones counted by the window kernel's
launches (one per target layer: no admission runs in the window).
"""

from __future__ import annotations

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SLOTS, PROMPT, MAX_NEW, WINDOW_S = 8, 300, 400, 1.0


def main(argv=None) -> int:
    import argparse

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from kubeflow_tpu_torch.models import get_model
    from kubeflow_tpu_torch.serving.engine import DecodeEngine

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quantize", choices=("none", "int8"), default="none")
    ap.add_argument("--draft-tokens", type=int, default=0)
    ap.add_argument("--draft", choices=("same", "small"), default="same")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_decode_profile: no CUDA device", file=sys.stderr)
        return 1
    model = get_model("gpt_small", dtype=torch.bfloat16)
    draft = None
    if args.draft_tokens > 0:
        draft = model if args.draft == "same" else get_model(
            "gpt_small", dtype=torch.bfloat16, hidden_size=64, num_layers=2,
            num_heads=4, mlp_dim=128)
    eng = DecodeEngine("gpt_small", model, num_slots=SLOTS, page_size=16,
                       paged_attention="kernel", quantize=args.quantize,
                       draft_model=draft, num_draft_tokens=args.draft_tokens)
    del model, draft  # an int8 engine holds its own int8 copies
    try:
        rng = np.random.default_rng(0)
        eng.generate_row(rng.integers(0, 50257, PROMPT), 4)  # warm-up
        futures = [eng.submit(rng.integers(0, 50257, PROMPT), MAX_NEW)
                   for _ in range(SLOTS)]
        while eng.stats()["admitted"] < SLOTS + 1:
            time.sleep(0.01)
        time.sleep(0.2)  # every slot is decoding now
        s0 = eng.stats()
        time.sleep(WINDOW_S)
        s1 = eng.stats()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(WINDOW_S)
            torch.cuda.synchronize()
        for f in futures:
            f.wait(600)
    finally:
        eng.close()
    steps = s1["decode_steps"] - s0["decode_steps"]
    ms = (s1["decode_step_ms"] * s1["decode_steps"]
          - s0["decode_step_ms"] * s0["decode_steps"]) / max(steps, 1)
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    step_kernel = ("paged_window_kernel" if args.draft_tokens
                   else "paged_decode_kernel")
    psteps = sum(e.count for e in events
                 if step_kernel in e.key) / eng.model.cfg.num_layers
    busy = sum(e.self_device_time_total for e in events) / 1e3 / max(psteps, 1)
    print(f"quantize={args.quantize}: kv pool {eng.stats()['kv_pool_dtype']}, "
          f"resident weights {eng.model.weight_bytes()} B")
    if args.draft_tokens:
        print(f"K={args.draft_tokens}, {args.draft} draft: accept_rate "
              f"{s1['accept_rate']:.4f}; in the unprofiled window "
              f"{(s1['tokens'] - s0['tokens']) / max(steps, 1):.3f} tokens "
              f"an iteration over {SLOTS} slots")
    print(f"unprofiled: {steps} decode steps, {ms:.3f} ms a step "
          f"(8 slots decoding, no admissions)")
    print(f"profiled: {psteps:.1f} traced decode steps, device busy "
          f"{busy:.3f} ms a step = {100 * busy / ms:.1f} % of an "
          f"unprofiled step (idle {100 - 100 * busy / ms:.1f} %)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / 1e3 / max(psteps, 1):8.4f} ms "
              f"a step {e.count / max(psteps, 1):6.1f}x  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
