#!/usr/bin/env python3
"""How long chip_smoke.py's gangs take on the card: `phase_gangs` of a
checkout with every phase's cells (the pair and the quartet of rank
processes, started at once, as `main` runs them), without the phases'
world-1 runs and gates.

    python3 scripts/torch_gang_timing.py [--root DIR]

`--root` names another checkout of this repository (for instance the
parent commit unpacked with `git archive` into a git-ignored directory),
whose package, kernel sources and chip_smoke.py are used instead; its
kernels build under its own build/. To compare two checkouts, run them
in turns in one command (parent, change, change, parent): the gangs are
the script's longest stretch and read the host's speed. Prints the card,
each gang's wall seconds (process start to exit), the gangs' wall, and
each run's rank-0 build and run seconds. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO, help="checkout to time")
    root = os.path.abspath(ap.parse_args().root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        print("torch_gang_timing: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = smoke
    spec.loader.exec_module(smoke)
    from kubeflow_tpu_torch.native.build import build_all

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"{smoke.smi_line()} | checkout {root}", flush=True)
    build_all()
    # every phase the checkout's phase_gangs knows, each with its own plan
    phases = [p for p in inspect.signature(smoke.phase_gangs).parameters
              if p not in ("torch", "root", "device")]
    with tempfile.TemporaryDirectory(prefix="kft-gangs-") as tmp:
        t0 = time.monotonic()
        gangs = smoke.phase_gangs(torch, tmp, **{p: {} for p in phases})
        print(f"gangs: {time.monotonic() - t0:.3f} s ({', '.join(phases)})",
              flush=True)
    for name, (_, plan, reports) in gangs.items():
        for i, reps in enumerate(reports):
            print(f"  {name}[{i}] mesh {plan[i][0].get('mesh')}: rank 0 "
                  f"{reps[0].get('seconds')}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
