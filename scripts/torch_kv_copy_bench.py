#!/usr/bin/env python3
"""How fast pages move between the port's KV pool on the card and host
memory, by the way the copy is made.

    python3 scripts/torch_kv_copy_bench.py [--pages 32] [--quantize none|int8]
        [--thread]

A gpt_small pool (12 layers, page 16, 12 heads x 64; bf16, or int8 with
bf16 scales) of 384 pages on the card. Each variant moves `--pages`
pages to the host and back, three times, and the host copies are kept
alive until the variant ends, as the host tier keeps them. Device→host:
one strided copy a page and pool tensor (`per_page`); one gather and one
copy into a pinned staging buffer a pool tensor, then a host clone a
page (`pinned_clone`); the same with each page a view of the staging
buffer (`pinned_views`, the engine's exports); one gather a pool tensor
and a copy a page into the slots of a preallocated pinned
`HostPageArena` (`arena`, the engine's host tier). Host→device, from
the arena's pages: one copy a page and pool tensor into its strided
pool page (`per_page`), one stack and copy then one indexed copy a pool
tensor (`batch`), and one asynchronous copy a page into a device block
then one indexed copy a pool tensor (`block`, the engine's
`scatter_pool_pages`).
`--thread` runs every variant on a worker thread in inference mode, as
the engine's scheduler runs a spill. Prints the median wall ms a page
over the repeats, with the card's name and power limit. Needs a CUDA
device.
"""

from __future__ import annotations

import os
import statistics
import sys
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None) -> int:
    import argparse

    import torch

    import chip_smoke
    from kubeflow_tpu_torch.models import get_model
    from kubeflow_tpu_torch.models.gpt import (
        gather_pool_pages,
        make_paged_pool,
        scatter_pool_pages,
    )
    from kubeflow_tpu_torch.serving.kv_tiers import HostPageArena

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pages", type=int, default=32)
    ap.add_argument("--quantize", choices=("none", "int8"), default="none")
    ap.add_argument("--thread", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_kv_copy_bench: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    cfg = get_model("gpt_small", dtype=torch.bfloat16, device="meta").cfg
    pool = make_paged_pool(cfg, 384, 16, dev, kv_quant=args.quantize)
    for t in pool.tensors():
        t.copy_(torch.randint(-100, 100, t.shape, device=dev).to(t.dtype))
    n = args.pages
    pages = list(range(7, 7 + 3 * n, 3))
    idx = torch.as_tensor(pages, device=dev)
    fields = pool.fields()
    page_bytes = sum(t[:, 0].numel() * t.element_size() for t in fields.values())

    def per_page():
        return [{k: t[:, p].to("cpu") for k, t in fields.items()} for p in pages]

    def staged():
        host = {}
        for k, t in fields.items():
            block = t.index_select(1, idx).transpose(0, 1)
            host[k] = torch.empty(block.shape, dtype=block.dtype,
                                  pin_memory=True)
            host[k].copy_(block)
        return host

    def pinned_clone():
        host = staged()
        return [{k: h[j].clone() for k, h in host.items()} for j in range(n)]

    def pinned_views():
        return gather_pool_pages(pool, pages, device="cpu")

    template = {k: t[:, 0].to("meta") for k, t in fields.items()}
    arena = HostPageArena(template, None, n, pin=True)
    slots = arena.alloc(n)

    def into_arena():
        return gather_pool_pages(pool, pages, device="cpu",
                                 out=[arena.pages(slot)[0] for slot in slots])

    held = into_arena()
    dsts = pages[::-1]

    def up_per_page():
        for page, d in zip(held, dsts):
            for k, t in fields.items():
                t[:, d].copy_(page[k])

    def up_batch():
        didx = torch.as_tensor(dsts, device=dev)
        for k, t in fields.items():
            block = torch.stack([page[k] for page in held]).to(dev)
            t.index_copy_(1, didx, block.transpose(0, 1))

    def up_block():
        scatter_pool_pages(pool, held, dsts)

    def timed(fn):
        out = []
        keep = []

        def body():
            with torch.inference_mode():
                for _ in range(3):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    keep.append(fn())
                    torch.cuda.synchronize()
                    out.append((time.perf_counter() - t0) * 1e3 / n)

        if args.thread:
            worker = threading.Thread(target=body)
            worker.start()
            worker.join()
        else:
            body()
        return statistics.median(out)

    rows = {
        "d2h per_page": timed(per_page),
        "d2h pinned_clone": timed(pinned_clone),
        "d2h pinned_views": timed(pinned_views),
        "d2h arena": timed(into_arena),
        "h2d per_page": timed(up_per_page),
        "h2d batch": timed(up_batch),
        "h2d block": timed(up_block),
    }
    print(f"device: {chip_smoke.smi_line()} | {n} pages of {page_bytes} B "
          f"(quantize={args.quantize}, "
          f"{'worker thread' if args.thread else 'main thread'})", flush=True)
    for name, ms in rows.items():
        print(f"{name:18s} {ms:.4f} ms a page "
              f"({page_bytes / ms / 1e6:.2f} GB/s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
