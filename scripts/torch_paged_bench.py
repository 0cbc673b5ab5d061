#!/usr/bin/env python3
"""Time the paged decode kernel of a checkout on the card, bf16 and int8,
at the serving main path's shapes (chip_smoke.py phases 3 and 9: 8 slots
at ragged cursors, and one slot at cursor 1023; H=12, D=64, page 16).

    python3 scripts/torch_paged_bench.py [--root DIR]

Runs `measure` of the checkout's own chip_smoke.py: each call is held
against the kernel's plain version first, then timed (median over CUDA
events, the L2 flushed before every launch) beside its plain version, its
bound and the library yardstick (gather + scaled_dot_product_attention).
`--root` names another checkout of this repository (for instance the
parent commit unpacked with `git archive` into a git-ignored directory),
whose package, kernel sources and chip_smoke.py are used instead; its
kernels build under its own build/. To compare two checkouts, run them in
turns in one command (parent, change, change, parent). Prints the card
and one JSON line per call. Needs a CUDA device.
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
        print("torch_paged_bench: no CUDA device", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from kubeflow_tpu_torch.ops import paged_attention as pa

    if not pa.__file__.startswith(root):
        raise RuntimeError(f"imported {pa.__file__}, not the package under {root}")
    print(f"device: {smoke.smi_line()} | checkout {root}", flush=True)
    flush = torch.empty(2 << 30, dtype=torch.uint8, device="cuda")
    for quantized in (False, True):
        for shape, cursors in (("B8", smoke.CURSORS), ("B1", (1023,))):
            rec = smoke.measure(torch, pa, flush, torch.bfloat16, 1, cursors,
                                quantized)
            print(json.dumps({"root": root, "shape": shape, **{k: rec[k] for k in (
                "name", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "max_abs_err")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
