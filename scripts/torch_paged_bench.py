#!/usr/bin/env python3
"""Time the paged-attention kernels of a checkout on the card, bf16 and
int8, at the serving main path's shapes (chip_smoke.py phases 3 and 9;
H=12, D=64, page 16): the decode kernel at 8 slots at ragged cursors and
at one slot with cursor 1023; the window kernel at the 8-slot s = 64
call, at the 8-slot s = 5 verify window, and at the batch-1 s = 64
windows the main path makes (MAIN_WINDOWS, each distinct cursor timed
once, the mean taken over the calls).

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
and one JSON line per shape. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import statistics
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("name", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
        "max_abs_err")


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

    def emit(shape, rec):
        print(json.dumps({"root": root, "shape": shape,
                          **{k: rec[k] for k in KEYS}}), flush=True)

    for quantized in (False, True):
        for shape, s, cursors in (("decode B8", 1, smoke.CURSORS),
                                  ("decode B1", 1, (1023,)),
                                  ("window B8 s64", smoke.CHUNK, smoke.CURSORS),
                                  ("window B8 s5", 5, smoke.CURSORS)):
            emit(shape, smoke.measure(torch, pa, flush, torch.bfloat16, s,
                                      cursors, quantized))
        per_cursor = {c: smoke.measure(torch, pa, flush, torch.bfloat16,
                                       smoke.CHUNK, (c,), quantized)
                      for c in sorted(set(smoke.MAIN_WINDOWS))}
        calls = [per_cursor[c] for c in smoke.MAIN_WINDOWS]
        mean = dict(calls[0])
        for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
            mean[key] = statistics.fmean(r[key] for r in calls)
        mean["max_abs_err"] = max(r["max_abs_err"] for r in calls)
        emit("window main (mean)", mean)
    return 0


if __name__ == "__main__":
    sys.exit(main())
