"""Model-server entrypoint (port of kubeflow_tpu/serving/main.py): build a
registry model on the card, attach the decode engine, serve REST.

Engine knobs default from the controller-rendered KFT_SERVING_* env (the
subset this port honours). `KFT_SERVING_PAGED_ATTENTION` takes
`gather | kernel`: `kernel` walks the page table in place through the
CUDA kernels on CUDA tensors (the counterpart of the JAX package's
`pallas`) and through their plain version on CPU tensors.
`KFT_SERVING_QUANTIZE` takes `none | int8`: int8 weights and int8 KV
pages (the engine), or int8 weights on the static path (num_slots=0).
`KFT_SERVING_DRAFT_MODEL` + `KFT_SERVING_DRAFT_TOKENS` turn on
speculative decoding (a registry draft model, K tokens drafted per
verify step). SIGTERM drains the engines before the process exits.

    python -m kubeflow_tpu_torch.serving.main --model gpt_small --port 8500
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Mapping, Optional

import torch

from kubeflow_tpu_torch.models.gpt import (
    PAGED_ATTENTION_IMPLS,
    QUANTIZE_CHOICES,
)
from kubeflow_tpu_torch.serving.engine import (
    DEFAULT_MAX_QUEUE,
    DEFAULT_NUM_SLOTS,
    DEFAULT_PAGE_SIZE,
    DEFAULT_PAGED_ATTENTION,
    DEFAULT_QUANTIZE,
)

def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    return int(raw) if raw.strip() else default


def engine_knobs_from_env() -> dict:
    """KFT_SERVING_NUM_SLOTS (0 disables the engine), _MAX_QUEUE,
    _PREFILL_BUCKETS (comma-separated powers of two; empty = auto),
    _PAGE_SIZE, _NUM_PAGES (0 = auto), _PREFIX_CACHE (0 = off),
    _PAGED_ATTENTION (gather | kernel), _QUANTIZE (none | int8),
    _DRAFT_MODEL + _DRAFT_TOKENS (speculative decoding: registry draft
    model and tokens drafted per verify step; 0 disables) and
    _DRAFT_CHECKPOINT_DIR (not ported: build_server raises when it
    would read it, at K > 0 without draft params)."""
    buckets_raw = os.environ.get("KFT_SERVING_PREFILL_BUCKETS", "")
    buckets = [int(b) for b in buckets_raw.split(",") if b.strip()]
    prefix_raw = os.environ.get("KFT_SERVING_PREFIX_CACHE", "").strip()
    return {
        "num_slots": _env_int("KFT_SERVING_NUM_SLOTS", DEFAULT_NUM_SLOTS),
        "max_queue": _env_int("KFT_SERVING_MAX_QUEUE", DEFAULT_MAX_QUEUE),
        "prefill_buckets": buckets or None,
        "page_size": _env_int("KFT_SERVING_PAGE_SIZE", DEFAULT_PAGE_SIZE),
        "num_pages": _env_int("KFT_SERVING_NUM_PAGES", 0),
        "prefix_cache": prefix_raw != "0",
        "paged_attention": (
            os.environ.get("KFT_SERVING_PAGED_ATTENTION", "").strip()
            or DEFAULT_PAGED_ATTENTION
        ),
        "quantize": (
            os.environ.get("KFT_SERVING_QUANTIZE", "").strip()
            or DEFAULT_QUANTIZE
        ),
        "draft_model": os.environ.get("KFT_SERVING_DRAFT_MODEL", "").strip(),
        "num_draft_tokens": _env_int("KFT_SERVING_DRAFT_TOKENS", 0),
        "draft_checkpoint_dir": os.environ.get(
            "KFT_SERVING_DRAFT_CHECKPOINT_DIR", ""
        ).strip(),
    }


def build_server(
    model: str,
    *,
    params: Optional[Mapping[str, torch.Tensor]] = None,
    device=None,
    dtype: Optional[torch.dtype] = None,
    num_slots: Optional[int] = None,
    max_queue: Optional[int] = None,
    prefill_buckets=None,
    page_size: Optional[int] = None,
    num_pages: Optional[int] = None,
    prefix_cache: Optional[bool] = None,
    paged_attention: Optional[str] = None,
    quantize: Optional[str] = None,
    draft_model: Optional[str] = None,
    num_draft_tokens: Optional[int] = None,
    draft_params: Optional[Mapping[str, torch.Tensor]] = None,
    draft_checkpoint_dir: Optional[str] = None,
):
    """Assemble the ModelServer for one registry model: the ServedLm
    plus (num_slots > 0) its continuous-batching DecodeEngine.

    `num_draft_tokens` K > 0 drafts with the registry model
    `draft_model`, built on the same device in the same dtype, with
    `draft_params` (a state dict) or, without them, its seed-0 init (a
    note says so: output stays right, acceptance is noise until trained
    draft weights come). Loading them from `draft_checkpoint_dir` is not
    ported yet (ROADMAP A12) and raises, where the reference would read
    it: K > 0 and no `draft_params`.

    `quantize="int8"` with the engine on serves int8 weights and int8 KV
    pages through the engine while the ServedLm stays full width; with
    num_slots=0 the ServedLm itself is int8 (the static int8 path).

    `params` is a state dict for the model (e.g. from
    models/convert.py `params_from_jax`); without one the model keeps
    its seed-0 init. `device` defaults to "cuda" and raises
    without CUDA unless "cpu" is asked for. Engine knobs default from
    `engine_knobs_from_env()`."""
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.serving.engine import DecodeEngine
    from kubeflow_tpu_torch.serving.generate import ServedLm
    from kubeflow_tpu_torch.serving.server import ModelServer
    from kubeflow_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    env = engine_knobs_from_env()
    num_slots = env["num_slots"] if num_slots is None else num_slots
    max_queue = env["max_queue"] if max_queue is None else max_queue
    if prefill_buckets is None:
        prefill_buckets = env["prefill_buckets"]
    page_size = env["page_size"] if page_size is None else page_size
    num_pages = env["num_pages"] if num_pages is None else num_pages
    if prefix_cache is None:
        prefix_cache = env["prefix_cache"]
    if paged_attention is None:
        paged_attention = env["paged_attention"]
    if quantize is None:
        quantize = env["quantize"]
    if draft_model is None:
        draft_model = env["draft_model"]
    if num_draft_tokens is None:
        num_draft_tokens = env["num_draft_tokens"]
    if draft_checkpoint_dir is None:
        draft_checkpoint_dir = env["draft_checkpoint_dir"]
    if num_draft_tokens > 0 and not draft_model:
        raise ValueError(
            "num_draft_tokens > 0 needs a draft model "
            "(--draft-model / KFT_SERVING_DRAFT_MODEL)"
        )
    if num_draft_tokens > 0 and num_slots < 1:
        raise ValueError(
            "num_draft_tokens > 0 needs num_slots >= 1: speculation lives "
            "inside the decode engine, and num_slots=0 disables it"
        )
    if num_draft_tokens > 0 and draft_params is None and draft_checkpoint_dir:
        raise ValueError(
            "draft params from a checkpoint (KFT_SERVING_DRAFT_CHECKPOINT_DIR"
            ") are not ported yet (ROADMAP A12: checkpointing/manager.py); "
            "pass draft_params"
        )
    if quantize not in QUANTIZE_CHOICES:
        raise ValueError(
            f"quantize {quantize!r} must be one of {QUANTIZE_CHOICES}"
        )
    if paged_attention not in PAGED_ATTENTION_IMPLS:
        raise ValueError(
            f"paged_attention {paged_attention!r} must be one of "
            f"{PAGED_ATTENTION_IMPLS}"
        )
    if num_slots < 1 and paged_attention != "gather":
        raise ValueError(
            "paged_attention=kernel needs num_slots >= 1: the kernel "
            "serves the engine, and num_slots=0 disables the engine"
        )
    kwargs = {"device": dev}
    if dtype is not None:
        kwargs["dtype"] = dtype
    lm_model = get_model(model, **kwargs)
    if params is not None:
        lm_model.load_state_dict(params, strict=True)
    server = ModelServer()
    lm = ServedLm(model, lm_model,
                  quantize=quantize if num_slots < 1 else "none")
    server.add_lm(lm)
    if num_slots > 0:
        draft = None
        if num_draft_tokens > 0:
            draft = get_model(draft_model, **kwargs)
            if draft_params is not None:
                draft.load_state_dict(draft_params, strict=True)
            else:
                print(f"note: draft model {draft_model} initialized from "
                      "seed 0 (no draft params given); output stays "
                      "correct, accept rate will be noise until trained "
                      "draft params are provided", flush=True)
        server.add_engine(
            DecodeEngine(
                lm.name, lm_model, device=dev,
                num_slots=num_slots, max_queue=max_queue,
                prefill_buckets=prefill_buckets,
                page_size=page_size or None, num_pages=num_pages or None,
                prefix_cache=prefix_cache, paged_attention=paged_attention,
                quantize=quantize, draft_model=draft,
                num_draft_tokens=num_draft_tokens,
            )
        )
    return server


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="kubeflow-tpu torch model server")
    ap.add_argument("--model", required=True, help="registry model name")
    ap.add_argument("--weights", default="",
                    help="torch.save'd state dict (default: seed-0 init)")
    ap.add_argument("--port", type=int, default=8500)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--num-slots", type=int, default=None)
    ap.add_argument("--max-queue", type=int, default=None)
    ap.add_argument("--page-size", type=int, default=None)
    ap.add_argument("--num-pages", type=int, default=None)
    ap.add_argument("--prefix-cache", type=int, choices=(0, 1), default=None)
    ap.add_argument("--paged-attention", choices=PAGED_ATTENTION_IMPLS,
                    default=None)
    ap.add_argument("--quantize", choices=QUANTIZE_CHOICES, default=None,
                    help="int8: int8 weights and int8 KV pages")
    ap.add_argument("--draft-model", default=None,
                    help="registry draft model for speculative decoding "
                    "(default from KFT_SERVING_DRAFT_MODEL; empty disables)")
    ap.add_argument("--draft-tokens", type=int, default=None,
                    help="tokens drafted per verify step (default from "
                    "KFT_SERVING_DRAFT_TOKENS, else 0)")
    args = ap.parse_args(argv)

    import signal
    import threading

    from kubeflow_tpu_torch.api.wsgi import Server

    params = None
    if args.weights:
        params = torch.load(args.weights, map_location="cpu",
                            weights_only=True)
    else:
        print(f"note: {args.model} serves its seed-0 init (no --weights "
              "given)", flush=True)
    server = build_server(
        args.model, params=params,
        num_slots=args.num_slots, max_queue=args.max_queue,
        page_size=args.page_size, num_pages=args.num_pages,
        prefix_cache=(
            None if args.prefix_cache is None else bool(args.prefix_cache)
        ),
        paged_attention=args.paged_attention, quantize=args.quantize,
        draft_model=args.draft_model, num_draft_tokens=args.draft_tokens,
    )
    httpd = Server(server.app, host=args.host, port=args.port)
    print(f"serving {args.model} on :{httpd.port}", flush=True)
    httpd.start()
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda signum, frame: stop.set())
    try:
        while not stop.wait(1.0):
            pass
        # scale-down: finish every accepted request, 429 + Retry-After
        # for new ones, before the process exits
        print("SIGTERM: draining engines", flush=True)
        drained = server.close(drain=True)
        print(f"drain {'complete' if drained else 'TIMED OUT'}", flush=True)
    except KeyboardInterrupt:
        server.close()
    finally:
        httpd.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
