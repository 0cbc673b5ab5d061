#!/usr/bin/env python3
"""Where a paged window call spends its time on the card: the bf16 window
kernel of a checkout timed whole and cut short at successive points.

    python3 scripts/torch_window_breakdown.py [--root DIR]

Copies the checkout's package and chip_smoke.py into
build/window_breakdown/<cut>/ with `paged_window_kernel` returning early
(`cursor`: after the cursor and the page ids; `loads`: after Q, K and V
have landed; `softmax`: after S and the softmax; `pv`: after P·V; `whole`:
not cut, so the last step is the partials, the ticket and the fold),
builds every copy's paged-attention library (one nvcc each, all at
once), then times each in its own process with chip_smoke.py's
`time_ms` (median over CUDA events, the L2 flushed before every launch)
at the bf16 calls of chip_smoke's phase 3: the main path's batch-1 s = 64
windows (their mean), the 8-slot s = 64 call and the 8-slot s = 5 call.
A cut kernel's output is wrong and is not checked; only its time is
read. The whole kernel is timed first and last. Prints the card and one
JSON line per copy. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import shutil
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join("kubeflow_tpu_torch", "ops", "csrc", "paged_attention.cu")
# a cut: (line of the kernel after which it returns, what it runs first);
# each keeps what it computed alive with a store no input reaches
CUTS = {
    "cursor": ("  if (w.n_keys <= 0) return;  // a split past the tile's last visible key\n",
               "  if (page == -7) out[0] = from_f<T>(0.f);\n  return;\n"),
    "loads": ("    if (use_tma) mbar_wait(bar_k, 0);\n",
              "    if (use_tma) mbar_wait(bar_v, 0);\n    return;\n"),
    "softmax": ("    if (use_tma) mbar_wait(bar_v, 0);\n",
                "    if (p[0] == 0x12345u && p[kWinKeys / 4 - 1] == 0x54321u) "
                "out[0] = from_f<T>(0.f);\n    return;\n"),
    "pv": ("    fence_regs<kWinKeys / 4>(p);\n",
           "    if (acc[0] == 12345.f && acc[1] == 54321.f) out[0] = from_f<T>(0.f);\n"
           "    return;\n"),
}


def make_copies(root: str, out: str) -> dict:
    """{cut: directory} of the copies, `whole` uncut."""
    with open(os.path.join(root, SOURCE)) as f:
        text = f.read()
    copies = {}
    for cut in ("whole", *CUTS):
        dst = os.path.join(out, cut)
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(os.path.join(root, "kubeflow_tpu_torch"),
                        os.path.join(dst, "kubeflow_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        shutil.copy(os.path.join(root, "chip_smoke.py"), dst)
        if cut != "whole":
            anchor, insert = CUTS[cut]
            if text.count(anchor) != 1:
                raise RuntimeError(f"cut {cut}: its line is not once in {SOURCE}")
            with open(os.path.join(dst, SOURCE), "w") as f:
                f.write(text.replace(anchor, anchor + insert))
        copies[cut] = dst
    return copies


def time_copy(root: str) -> dict:
    """ms of the bf16 window calls through the package under `root` (run
    in a process of its own: each copy has the same module names)."""
    sys.path.insert(0, root)
    import torch

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from kubeflow_tpu_torch.ops import paged_attention as pa

    if not pa.__file__.startswith(root):
        raise RuntimeError(f"imported {pa.__file__}, not the package under {root}")
    flush = torch.empty(2 << 30, dtype=torch.uint8, device="cuda")

    def ms(s, cursors):
        args = smoke.kernel_inputs(torch, torch.bfloat16, s, "cuda", cursors=cursors)
        return smoke.time_ms(torch, lambda: pa.paged_attention(
            *args, dtype=torch.bfloat16), flush, iters=50)

    per = {c: ms(smoke.CHUNK, (c,)) for c in sorted(set(smoke.MAIN_WINDOWS))}
    return {"window main (mean)": statistics.fmean(per[c] for c in smoke.MAIN_WINDOWS),
            "window B8 s64": ms(smoke.CHUNK, smoke.CURSORS),
            "window B8 s5": ms(5, smoke.CURSORS)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO, help="checkout to cut")
    ap.add_argument("--time", help=argparse.SUPPRESS)  # one copy, in this process
    args = ap.parse_args()
    if args.time:
        print(json.dumps(time_copy(os.path.abspath(args.time))), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_window_breakdown: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(root, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    print(f"device: {smoke.smi_line()} | checkout {root}", flush=True)
    copies = make_copies(root, os.path.join(REPO, "build", "window_breakdown"))
    build = ("from kubeflow_tpu_torch.native.build import build_all; "
             "build_all(['paged_attention'])")
    procs = [subprocess.Popen([sys.executable, "-c", build], cwd=d) for d in copies.values()]
    if any(p.wait() for p in procs):
        raise RuntimeError("a copy's kernels did not build")
    for cut in ("whole", *CUTS, "whole"):
        out = subprocess.run([sys.executable, __file__, "--time", copies[cut]],
                             capture_output=True, text=True, check=True).stdout
        print(json.dumps({"cut": cut, **json.loads(out.strip().splitlines()[-1])}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
