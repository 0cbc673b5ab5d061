#!/usr/bin/env python3
"""What the data-parallel machinery costs a one-card ResNet-50 run on the
card: chip_smoke.py's GANG_RESNET_CFG (phase 15a's cell with `mesh:
{data: 1}`), cuDNN benchmark on, each run's last log window (steps
11-20), the variants in turns (ORDER):

- "in_process": `run_training` in this process, no group (the
  single-card step);
- "in_process_gang1": the same in a world-1 NCCL group joined in this
  process (the data-parallel step), with the host time of its all-reduce
  calls and of the gradient bucket (`Trainer._all_reduce_grads`) timed
  around the calls: their launch cost, no synchronize; the first step's
  communicator set-up is in the all-reduce average;
- "gang1": the launcher as a gang of one over NCCL (chip_smoke.py
  `run_gang`, phase 17a's run);
- "gang1_profiled": that gang with CUDA activity traced over steps 2-4
  (what a profiled window leaves behind in the same process).

    python3 scripts/torch_gang_overhead.py [--steps 20]

Prints the card's name and power limit, a line a run, and every run as
one JSON line. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

ORDER = ("in_process", "in_process_gang1", "gang1", "gang1_profiled",
         "gang1_profiled", "gang1", "in_process_gang1", "in_process")


def in_process_gang1(torch, spec):
    """`run_training` in a world-1 NCCL group joined in this process →
    (result, host ms a step in the all-reduce calls and in the gradient
    bucket)."""
    from kubeflow_tpu_torch.config.platform import TrainingConfig
    from kubeflow_tpu_torch.parallel import distributed as gd
    from kubeflow_tpu_torch.runtime.train_run import run_training
    from kubeflow_tpu_torch.training.trainer import Trainer

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    gd.initialize_from_env(gd.render_gang_env(
        "overhead", ["127.0.0.1"], coordinator_port=port)[0])
    host = {"all_reduce": 0.0, "bucket": 0.0}
    all_reduce, bucket = torch.distributed.all_reduce, Trainer._all_reduce_grads

    def timed(key, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                host[key] += time.perf_counter() - t0
        return call

    torch.distributed.all_reduce = timed("all_reduce", all_reduce)
    Trainer._all_reduce_grads = timed("bucket", bucket)
    try:
        res = run_training(TrainingConfig(**spec), device="cuda",
                           log_every=10)
        res["backend"] = torch.distributed.get_backend()
    finally:
        torch.distributed.all_reduce = all_reduce
        Trainer._all_reduce_grads = bucket
        gd.shutdown()
    return res, {k: v * 1e3 / spec["steps"] for k, v in host.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=None)
    args = ap.parse_args()
    import torch

    import chip_smoke as smoke
    from kubeflow_tpu_torch.config.platform import TrainingConfig
    from kubeflow_tpu_torch.runtime.train_run import run_training

    if not torch.cuda.is_available():
        print("torch_gang_overhead: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    spec = dict(smoke.GANG_RESNET_CFG,
                steps=args.steps or smoke.GANG_RESNET_CFG["steps"])
    card = smoke.smi_line()
    print(f"device: {card} | torch {torch.__version__}", flush=True)
    runs = {name: [] for name in dict.fromkeys(ORDER)}
    with tempfile.TemporaryDirectory(prefix="kft-overhead-") as root:
        for name in ORDER:
            host = None
            if name == "in_process":
                res = run_training(TrainingConfig(**spec), device="cuda",
                                   log_every=10)
                res["backend"] = None
            elif name == "in_process_gang1":
                res, host = in_process_gang1(torch, spec)
            else:
                (res, _), = smoke.run_gang(
                    torch, name, spec, 1, root=root, cudnn_benchmark=True,
                    profile=name == "gang1_profiled")
            torch.cuda.empty_cache()
            row = {"images_per_sec": res["items_per_sec"],
                   "step_ms": res["step_time_s"] * 1e3,
                   "grad_allreduces": res["grad_allreduces"],
                   "backend": res["backend"], "host_ms_a_step": host}
            runs[name].append(row)
            print(f"overhead {name} ({card}): {row['images_per_sec']:.1f} "
                  f"images/sec/card, step {row['step_ms']:.3f} ms (steps "
                  f"11-{spec['steps']}), backend {row['backend']}, gradient "
                  f"all-reduces {row['grad_allreduces']}; host ms a step in "
                  f"the all-reduce calls and the gradient bucket {host}",
                  flush=True)
    print(json.dumps({"card": card, "runs": runs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
