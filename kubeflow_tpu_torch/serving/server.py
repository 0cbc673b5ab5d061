"""Model server speaking the TF-Serving-shaped REST contract (port of the
`:generate` part of kubeflow_tpu/serving/server.py).

Routes: `POST /v1/models/<name>:generate` (through the DecodeEngine when
one is attached, else the static ServedLm path), `GET /v1/models` and
`GET /v1/models/<name>` (model discovery, as the kft-router forwards
them), `GET /healthz` and `GET /metrics` (Prometheus text). The bodies
are the reference server's.

`restore_checkpoint_params` is the serving side's checkpoint load.

Draining shutdown: `close(drain=True)` drains every engine at once under
one deadline. While the server or any engine drains, `/healthz` answers
503 with `"draining": true` (readiness probes and the router tell
draining from dead), and `:generate` through a draining engine answers
429 with Retry-After; every request already accepted completes.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np

from kubeflow_tpu_torch.api.wsgi import (
    App,
    BadRequest,
    HttpError,
    NotFoundError,
    Response,
)
from kubeflow_tpu_torch.serving.engine import (
    EngineDrainingError,
    QueueFullError,
)
from kubeflow_tpu_torch.utils.logging import get_logger
from kubeflow_tpu_torch.utils.metrics import default_registry

log = get_logger(__name__)

# the drain budget close(drain=True) gives the engines by default (the
# reference's DEFAULT_DRAIN_DEADLINE_S)
DEFAULT_DRAIN_DEADLINE_S = 30.0


def restore_checkpoint_params(checkpoint_dir: Optional[str],
                              transform: str = ""):
    """Params from the latest committed platform checkpoint: the one
    restore every serving loader uses. It reads the manifest training
    saves through (checkpointing/), so a training run's checkpoints, the
    port's or the JAX package's, serve directly; uncommitted (torn) saves
    are invisible, and the shard layout that saved them is irrelevant.
    Returns the nested flax tree of CPU tensors, or with
    `transform="int8"` the JAX-shaped int8 envelope
    (checkpointing/manager.py `restore_params`)."""
    if checkpoint_dir is None:
        raise ValueError("need checkpoint_dir or params")
    from kubeflow_tpu_torch.checkpointing import restore_params

    return restore_params(checkpoint_dir, transform=transform)


class ModelServer:
    """Generative-model server: ServedLm models and their engines."""

    # generous bound: an engine request waits behind at most max_queue
    # admissions; a hung engine must surface as a 500, not a stuck socket
    ENGINE_WAIT_S = 600.0

    def __init__(self) -> None:
        self._lms: Dict[str, Any] = {}      # ServedLm (serving/generate.py)
        self._engines: Dict[str, Any] = {}  # DecodeEngine (serving/engine.py)
        # set as close(drain=True) starts, so /healthz reports the drain
        # from its first moment
        self._draining = False
        self.app = self._build()

    def add_lm(self, lm) -> None:
        self._lms[lm.name] = lm

    def add_engine(self, engine) -> None:
        """Attach a DecodeEngine: `:generate` requests for `engine.name`
        ride its token-level scheduler (same wire contract, plus
        X-TTFT-Ms; queue-full is 429)."""
        self._engines[engine.name] = engine

    def lm(self, name: str):
        return self._lms[name]

    def engine(self, name: str):
        return self._engines[name]

    def close(self, drain: bool = False,
              drain_deadline_s: float = DEFAULT_DRAIN_DEADLINE_S) -> bool:
        """Stop the engines' scheduler threads (the shutdown hook).

        `drain=True` is the scale-down/SIGTERM path: every engine stops
        admitting (new `:generate` requests get 429 + Retry-After) while
        everything already accepted runs to completion; what is still
        live at the deadline fails fast. Engines drain concurrently, so
        the whole shutdown is bounded by one deadline. Returns True when
        every engine drained in time (always True without `drain`)."""
        if not drain:
            for engine in self._engines.values():
                engine.close()
            return True
        self._draining = True
        results: Dict[str, bool] = {}

        def drain_one(name: str, engine) -> None:
            try:
                results[name] = engine.drain(drain_deadline_s)
            except Exception:
                # a drain that raised before its own close() would leave
                # the scheduler running and every accepted future hung
                log.exception("engine %s drain failed; closing", name)
                engine.close()

        workers = [
            threading.Thread(target=drain_one, args=(name, engine),
                             name=f"drain-{name}", daemon=True)
            for name, engine in self._engines.items()
        ]
        for w in workers:
            w.start()
        for w in workers:
            w.join()
        return all(results.get(name, False) for name in self._engines)

    def _generate_via_engine(self, engine, req, body, n: int):
        """One engine request per prompt row (row i seeded `seed + i`),
        admitted atomically. Rows that hit EOS early are padded with
        eos_id to keep the rectangular wire shape."""
        try:
            x = np.asarray(body["prompt_ids"], dtype=np.int64)
        except (ValueError, TypeError) as e:
            raise BadRequest(f"bad generate request: {e}")
        if x.ndim != 2:
            raise BadRequest(
                "bad generate request: prompt_ids must be [batch, prompt_len]"
            )
        mask = body.get("attention_mask")
        if mask is not None:
            mask = np.asarray(mask).astype(bool)
            if mask.shape != x.shape:
                raise BadRequest(
                    "bad generate request: attention_mask shape must "
                    "match prompt_ids"
                )
        else:
            mask = np.ones_like(x, dtype=bool)
        eos_id = body.get("eos_id")
        try:
            futures = engine.submit_batch(
                [x[i][mask[i]] for i in range(x.shape[0])],
                n,
                temperature=body.get("temperature", 0.0),
                top_k=body.get("top_k", 0),
                top_p=body.get("top_p", 1.0),
                eos_id=eos_id,
                seed=body.get("seed", 0),
            )
        except EngineDrainingError as e:
            # same 429 as queue-full, plus Retry-After: through the
            # Service the retry lands on a replica that stays up
            req.response_headers.append(
                ("Retry-After", str(max(1, math.ceil(e.retry_after_s))))
            )
            raise HttpError(429, str(e))
        except QueueFullError as e:
            raise HttpError(429, str(e))
        except (ValueError, TypeError) as e:
            # includes EngineCapacityError: prompt + n > max_len
            raise BadRequest(f"bad generate request: {e}")
        deadline = time.monotonic() + self.ENGINE_WAIT_S
        results = [
            f.wait(max(0.0, deadline - time.monotonic())) for f in futures
        ]
        sequences: List[List[int]] = []
        for i, r in enumerate(results):
            toks = r["tokens"]
            if len(toks) < n:
                toks = toks + [int(eos_id)] * (n - len(toks))
            sequences.append(x[i].tolist() + toks)
        ttft = max(r["ttft_s"] for r in results)
        req.response_headers.append(("X-TTFT-Ms", f"{ttft * 1e3:.2f}"))
        return {"sequences": sequences}

    def _build(self) -> App:
        app = App("model-server")

        @app.get("/healthz")
        def healthz(req):
            """{"ok", "draining", "models"}; 503 while the server or any
            engine drains, so readiness drops a draining replica that
            still answers (a dead one answers nothing)."""
            names = sorted(set(self._lms) | set(self._engines))
            draining = self._draining or any(
                e.draining for e in self._engines.values()
            )
            body = {"ok": True, "draining": draining, "models": names}
            return (body, 503) if draining else body

        @app.get("/v1/models")
        def list_models(req):
            """Every model, ServedLm ones first, then engine-only ones:
            each generative, with continuous batching when an engine
            serves it."""
            return {
                "models": [
                    {"name": lm.name, "version": "1", "generative": True,
                     "continuous_batching": lm.name in self._engines}
                    for lm in self._lms.values()
                ] + [
                    {"name": engine.name, "version": "1", "generative": True,
                     "continuous_batching": True}
                    for engine in self._engines.values()
                    if engine.name not in self._lms
                ]
            }

        @app.get("/v1/models/<name>")
        def model_status(req):
            name = req.params["name"]
            if name not in self._lms and name not in self._engines:
                raise NotFoundError(f"model {name} not loaded")
            return {
                "model_version_status": [{
                    "version": "1", "state": "AVAILABLE",
                    "status": {"error_code": "OK", "error_message": ""},
                }]
            }

        @app.get("/metrics")
        def metrics(req):
            return Response(
                default_registry().render(),
                "text/plain; version=0.0.4; charset=utf-8",
            )

        @app.post("/v1/models/<name>:generate")
        def generate(req):
            """Autoregressive continuation: body {"prompt_ids": [[...]],
            "max_new_tokens": N} plus optional "attention_mask",
            "temperature", "top_k", "top_p", "eos_id", "seed" →
            {"sequences": [[prompt + continuation]]}."""
            name = req.params["name"]
            lm = self._lms.get(name)
            engine = self._engines.get(name)
            if lm is None and engine is None:
                raise NotFoundError(f"generative model {name} not loaded")
            body = req.body or {}
            if not isinstance(body, dict):
                raise BadRequest("request body must be a JSON object")
            if body.get("prompt_ids") is None:
                raise BadRequest("request body must contain 'prompt_ids'")
            try:
                n = int(body.get("max_new_tokens", 16))
            except (ValueError, TypeError) as e:
                raise BadRequest(f"bad generate request: {e}")
            if engine is not None:
                return self._generate_via_engine(engine, req, body, n)
            try:
                sequences = lm.generate(
                    body["prompt_ids"], n,
                    prompt_mask=body.get("attention_mask"),
                    temperature=body.get("temperature", 0.0),
                    top_k=body.get("top_k", 0),
                    top_p=body.get("top_p", 1.0),
                    eos_id=body.get("eos_id"),
                    seed=body.get("seed", 0),
                )
            except (ValueError, TypeError) as e:
                raise BadRequest(f"bad generate request: {e}")
            return {"sequences": sequences.tolist()}

        return app
