#!/usr/bin/env python3
"""Where a training step of the PyTorch port spends its time on the card:
a torch.profiler window over steady-state train steps.

    python3 scripts/torch_train_profile.py

Builds the trainer chip_smoke.py's phase 8 drives (gpt_small in bf16 at
configs/gpt_longcontext_v5e16.yaml's one-card share: 8 × 4096 tokens a
step in 4 microbatches, remat, chunked loss, attention_impl="flash"),
takes two warm-up steps, times three steps unprofiled (host clock around
steps that end in a synchronize), then profiles two more with CUDA
activity only (kernel durations are the device's own; the profiler slows
the host side, so the step time comes from the unprofiled window).
Prints the step time, the device's busy time a step (the sum of kernel
times) and so its idle share, the flash kernels' share of the busy time,
and the kernels that take the most device time. Needs a CUDA device.
"""

from __future__ import annotations

import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

WARMUP, TIMED, PROFILED = 2, 3, 2


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import TRAIN_CFG, smi_line
    from kubeflow_tpu_torch.config.platform import TrainingConfig
    from kubeflow_tpu_torch.training.trainer import Trainer

    if not torch.cuda.is_available():
        print("torch_train_profile: no CUDA device", file=sys.stderr)
        return 1
    print(f"device: {smi_line()}")
    cfg = TrainingConfig(**TRAIN_CFG)
    trainer = Trainer(cfg)
    state = trainer.init_state()
    data = trainer.task.synthetic_data()
    step = 0

    def run(n):
        nonlocal state, step
        for _ in range(n):
            state, metrics = trainer.train_step(state, data.batch_at(step))
            step += 1
        torch.cuda.synchronize()
        return float(metrics["loss"])

    run(WARMUP)
    t0 = time.monotonic()
    loss = run(TIMED)
    step_ms = (time.monotonic() - t0) / TIMED * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run(PROFILED)
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e3 / PROFILED
    flash = sum(e.self_device_time_total for e in events
                if "flash_" in e.key) / 1e3 / PROFILED
    tokens = cfg.global_batch_size * cfg.seq_len
    print(f"unprofiled: {TIMED} steps, {step_ms:.3f} ms a step, "
          f"{tokens / step_ms * 1e3:.1f} tokens/s, loss {loss:.4f}")
    print(f"profiled: {PROFILED} steps, device busy {busy:.3f} ms a step = "
          f"{100 * busy / step_ms:.1f} % of an unprofiled step (idle "
          f"{100 - 100 * busy / step_ms:.1f} %); flash kernels {flash:.3f} ms "
          f"a step = {100 * flash / busy:.1f} % of device time")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"  {e.self_device_time_total / 1e3 / PROFILED:9.3f} ms a step "
              f"{e.count / PROFILED:7.1f}x  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
