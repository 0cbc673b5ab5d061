#!/usr/bin/env python3
"""chip_smoke.py's phase 24 (the serving mesh) alone on the card.

    python3 scripts/torch_serving_mesh.py

Builds the kernels, runs the phase's four cells in `phase_gangs`' pair
(24a gpt_small on {tensor: 2} in bf16, 24b in int8) and quartet (24c
gpt_small on {tensor: 2, fsdp: 2}, 24d gpt_small_moe on {tensor: 2,
expert: 2}) of gloo ranks sharing the card, then serves each cell's 1×1
reference in this process and holds the cells against them
(`phase_serving_mesh`: tokens bit for bit, a rank's pool and weight
bytes, a step's gathers, rank 0's launches, rank 0's build and the
workers' peaks on the card against the formula). Prints each rank's seconds
a cell, the card's name and power limit, and the whole run's seconds.
Needs a CUDA device.
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    import torch

    import chip_smoke as smoke
    from kubeflow_tpu_torch.native.build import build_all

    if not torch.cuda.is_available():
        print("torch_serving_mesh: no CUDA device", file=sys.stderr)
        return 1
    t0 = time.monotonic()
    print(smoke.smi_line(), torch.__version__, torch.version.cuda, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    build_all()
    print(f"build {time.monotonic() - t0:.3f} s", flush=True)
    with tempfile.TemporaryDirectory() as root:
        t1 = time.monotonic()
        gangs = smoke.phase_gangs(torch, root, serve={})
        print(f"gangs {time.monotonic() - t1:.3f} s", flush=True)
        for (spec, _), reps in zip(gangs["serve"][1], gangs["serve"][2]):
            print(f"{spec['cell']} seconds a rank "
                  f"{[r['seconds']['run'] for r in reps]}", flush=True)
        smoke.phase_serving_mesh(torch, gangs["serve"])
    print(f"total {time.monotonic() - t0:.3f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
