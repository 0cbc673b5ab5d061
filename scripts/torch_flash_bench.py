#!/usr/bin/env python3
"""Time the flash-attention kernels of a checkout on the card, at the
training main path's shape (chip_smoke.py phase 6: B=2, H=12, S=4096,
D=64, causal, bf16, no key mask).

    python3 scripts/torch_flash_bench.py [--root DIR]

Runs `measure_flash` of the checkout's own chip_smoke.py: each kernel is
held against its plain version first, then timed (median over CUDA
events, the L2 flushed before every launch) beside its plain version,
its bound and scaled_dot_product_attention. `--root` names another
checkout of this repository (for instance the parent commit unpacked
with `git archive` into a git-ignored directory), whose package, kernel
sources and chip_smoke.py are used instead; its kernels build under its
own build/. To compare two checkouts, run them in turns in one command
(parent, change, change, parent). Prints the card and one JSON line per
kernel. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO, help="checkout to time")
    root = os.path.abspath(ap.parse_args().root)
    sys.path.insert(0, root)

    import torch

    if not torch.cuda.is_available():
        print("torch_flash_bench: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from kubeflow_tpu_torch.ops import flash_attention as fa

    if not fa.__file__.startswith(root):
        raise RuntimeError(f"imported {fa.__file__}, not the package under {root}")
    print(f"device: {smoke.smi_line()} | checkout {root}", flush=True)
    flush = torch.empty(2 << 30, dtype=torch.uint8, device="cuda")
    records = smoke.measure_flash(torch, fa, flush, torch.bfloat16, smoke.FS, False)
    for rec in records.values():
        print(json.dumps({"root": root, **{k: rec[k] for k in (
            "name", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "max_abs_err")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
