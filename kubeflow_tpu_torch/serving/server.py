"""Model server speaking the TF-Serving-shaped REST contract (port of the
`:generate` part of kubeflow_tpu/serving/server.py).

Routes: `POST /v1/models/<name>:generate` (through the DecodeEngine when
one is attached, else the static ServedLm path), `GET /v1/models` and
`GET /v1/models/<name>` (model discovery, as the kft-router forwards
them), `GET /healthz` and `GET /metrics` (Prometheus text). The bodies
are the reference server's.

Observability (`statusz_enabled`, on by default): `GET /statusz` (the
models and engines sections: slot maps, pool, prefix cache, KV tiers,
the recent requests' queue/prefill/decode breakdown), `GET /debug/trace`
(the span ring as Chrome trace JSON, `?trace_id=` for one request) and
`GET /tracez` (the tail sampler's kept traces). Every engine request
carries a trace id: the trace-id half of an inbound `traceparent`, else
`X-Request-Id`, else a minted one; the reply echoes it as `X-Request-Id`.

`restore_checkpoint_params` is the serving side's checkpoint load.

Page handoff between replicas (the disaggregated prefill/decode fleet):
`POST /v1/kv/pages` admits an `encode_page_entries` envelope
(application/octet-stream) into the engine's pool and radix index (a
shipment of another page geometry is rejected whole with 400);
`POST /v1/models/<name>:prefill` prefills a prompt to page completion
and ships its committed chain to `handoff_url`; `POST /v1/kv/handoff`
ships each engine's hottest chains to each chain's first-page-key
rendezvous home among `peers` (the scale-down drain window). Pages go
out through `page_transport` (an HTTP POST by default).

Draining shutdown: `close(drain=True)` drains every engine at once under
one deadline. While the server or any engine drains, `/healthz` answers
503 with `"draining": true` (readiness probes and the router tell
draining from dead), and `:generate` through a draining engine answers
429 with Retry-After; every request already accepted completes.
"""

from __future__ import annotations

import json
import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from kubeflow_tpu_torch.api.wsgi import (
    App,
    BadRequest,
    HttpError,
    NotFoundError,
    Response,
)
from kubeflow_tpu_torch.config.platform import DisaggConfig
from kubeflow_tpu_torch.observability.http import (
    add_debug_routes,
    format_phase_row,
)
from kubeflow_tpu_torch.observability.trace import (
    TRACEPARENT_HEADER,
    default_tracer,
    parse_traceparent,
)
from kubeflow_tpu_torch.routing.affinity import (
    first_page_key,
    rendezvous_rank,
)
from kubeflow_tpu_torch.serving.engine import (
    EngineDrainingError,
    QueueFullError,
)
from kubeflow_tpu_torch.serving.kv_tiers import (
    decode_page_entries,
    encode_page_entries,
)
from kubeflow_tpu_torch.utils.logging import get_logger
from kubeflow_tpu_torch.utils.metrics import (
    default_registry,
    serving_kv_handoff_ms_counter,
    serving_kv_handoff_pages_counter,
)

log = get_logger(__name__)

# the drain budget close(drain=True) gives the engines by default (the
# reference's DEFAULT_DRAIN_DEADLINE_S)
DEFAULT_DRAIN_DEADLINE_S = 30.0

# one POST of committed pages to a peer replica: bounded well under the
# drain deadline, so a dead peer cannot eat the whole drain window
PAGE_SHIP_TIMEOUT_S = 60.0


def _default_page_transport(url: str, data: bytes):
    """POST one page envelope to a peer replica's /v1/kv/pages. Returns
    (status, body bytes). ModelServer takes another (tests, fleets in
    one process)."""
    import urllib.error
    import urllib.request

    request = urllib.request.Request(
        url, data=data, method="POST",
        headers={"Content-Type": "application/octet-stream"},
    )
    try:
        with urllib.request.urlopen(request,
                                    timeout=PAGE_SHIP_TIMEOUT_S) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _retry_after(req, e: EngineDrainingError) -> None:
    """429 + Retry-After for a draining engine: through the Service the
    retry lands on a replica that stays up."""
    req.response_headers.append(
        ("Retry-After", str(max(1, math.ceil(e.retry_after_s))))
    )


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

    def __init__(self, page_transport: Optional[
            Callable[[str, bytes], Tuple[int, bytes]]] = None,
            statusz_enabled: bool = True) -> None:
        self._lms: Dict[str, Any] = {}      # ServedLm (serving/generate.py)
        self._engines: Dict[str, Any] = {}  # DecodeEngine (serving/engine.py)
        # how this replica POSTs page envelopes to a peer's /v1/kv/pages
        self._page_transport = page_transport or _default_page_transport
        self._handoff_pages_m = serving_kv_handoff_pages_counter()
        self._handoff_ms_m = serving_kv_handoff_ms_counter()
        # set as close(drain=True) starts, so /healthz reports the drain
        # from its first moment
        self._draining = False
        self.app = self._build()
        if statusz_enabled:
            add_debug_routes(
                self.app,
                statusz_sections=[
                    ("models", self._statusz_models),
                    ("engines", self._statusz_engines),
                ],
                role="serving",
            )

    def _statusz_models(self) -> List[str]:
        lines = [
            f"  {lm.name} (generate, "
            f"{'engine' if lm.name in self._engines else 'static'})"
            for lm in self._lms.values()
        ]
        lines += [
            f"  {e.name} (generate, engine-only)"
            for e in self._engines.values()
            if e.name not in self._lms
        ]
        return lines or ["  <none>"]

    def _statusz_engines(self) -> List[str]:
        """The JAX server's engine lines (a dense engine has no MoE
        line there either)."""
        lines: List[str] = []
        for engine in self._engines.values():
            state = engine.debug_state()
            st = state["stats"]
            lines.append(
                f"  {state['name']}: queue={state['queue_depth']} "
                f"slots={sum(s is not None for s in state['slots'])}"
                f"/{state['num_slots']} steps={st['decode_steps']} "
                f"tokens={st['tokens']} "
                f"occupancy={st['mean_occupancy']:.3f}"
            )
            mesh = state["mesh"]
            windows = ",".join(
                f"{w}={v}" for w, v in st["paged_attention_windows"].items()
            ) or "-"
            lines.append(
                f"    kv pool: {state['pages_in_use']}"
                f"/{state['pages_total']} pages of {state['page_size']} "
                f"({st['kv_pool_dtype']}, {state['kv_pool_bytes']} B) | "
                f"mesh: tensor={mesh['tensor']} fsdp={mesh['fsdp']} "
                f"expert={mesh['expert']} "
                f"({state['kv_pool_bytes_per_chip']} B/chip) | "
                f"kernel: {st['attention_kernel']} windows: {windows}"
                f" quantize: {st['quantize']} | "
                f"prefix cache: {'on' if state['prefix_cache'] else 'off'} "
                f"nodes={state['prefix_nodes']} "
                f"hit_tokens={st['prefix_hit_tokens']} "
                f"hit_rate={st['prefix_cache_hit_rate']:.3f} "
                f"lookups={st['prefix_lookups']} "
                f"cow={st['cow_copies']} "
                f"first_page_hashes={st['first_page_hashes']}"
            )
            tier = state["kv_host_tier"]
            if tier is not None or state["kv_persist_dir"]:
                host = (f"{tier['entries']} entries "
                        f"{tier['bytes_in_use']}/{tier['budget_bytes']} B"
                        if tier is not None else "off")
                lines.append(
                    f"    kv tiers: host={host} "
                    f"spilled={st['kv_spill_pages']} "
                    f"spill_hits={st['kv_spill_hits']} | "
                    f"store={state['kv_persist_dir'] or 'off'} "
                    f"persisted_chains={st['kv_persisted_chains']}"
                )
            for s in state["slots"]:
                if s is not None:
                    lines.append(
                        f"    slot {s['slot']}: {s['trace_id']} "
                        f"prompt={s['prompt_len']} "
                        f"tokens={s['tokens']}/{s['max_new']} "
                        f"pages={s['pages']} (shared {s['shared_pages']})"
                    )
            if state["recent"]:
                lines.append("    recent requests (newest last):")
                lines.extend("  " + format_phase_row(r)
                             for r in state["recent"])
        return lines or ["  <none>"]

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
        # the request's trace id, in preference order: the trace-id half of
        # a `traceparent` (its span-id half names the caller's span as the
        # remote parent of every span recorded here), else X-Request-Id,
        # else a minted one; echoed so the client can find its trace
        tracer = default_tracer()
        trace_id = remote_parent = None
        if tracer.enabled:
            inbound = parse_traceparent(req.headers.get(TRACEPARENT_HEADER))
            if inbound is not None:
                trace_id, remote_parent = inbound
        if trace_id is None:
            trace_id = req.headers.get("x-request-id") or None
        if trace_id is None:
            trace_id = tracer.new_trace_id("req")
        req.response_headers.append(("X-Request-Id", trace_id))
        try:
            # the queue spans submit_batch opens on THIS thread inherit
            # the remote parent; the context is restored on exit, so a
            # reused handler thread never carries it into the next request
            with tracer.trace_context(trace_id, remote_parent):
                futures = engine.submit_batch(
                    [x[i][mask[i]] for i in range(x.shape[0])],
                    n,
                    temperature=body.get("temperature", 0.0),
                    top_k=body.get("top_k", 0),
                    top_p=body.get("top_p", 1.0),
                    eos_id=eos_id,
                    seed=body.get("seed", 0),
                    trace_id=trace_id,
                )
        except EngineDrainingError as e:
            _retry_after(req, e)
            raise HttpError(429, str(e))
        except QueueFullError as e:
            raise HttpError(429, str(e))
        except (ValueError, TypeError) as e:
            # includes EngineCapacityError: prompt + n > max_len
            raise BadRequest(f"bad generate request: {e}")
        t_admit = time.monotonic()
        deadline = t_admit + self.ENGINE_WAIT_S
        error = False
        try:
            results = [
                f.wait(max(0.0, deadline - time.monotonic())) for f in futures
            ]
        except RuntimeError as e:
            # a failed row (a decode iteration that raised, an injected
            # fault) 500s the request naming the engine's error; the tail
            # sampler always keeps its trace
            error = True
            raise HttpError(500, str(e)) from e
        except BaseException:
            error = True  # a hung row: the deadline passed
            raise
        finally:
            tracer.finish_trace(trace_id, error=error,
                                dur_s=time.monotonic() - t_admit)
        sequences: List[List[int]] = []
        for i, r in enumerate(results):
            toks = r["tokens"]
            if len(toks) < n:
                toks = toks + [int(eos_id)] * (n - len(toks))
            sequences.append(x[i].tolist() + toks)
        ttft = max(r["ttft_s"] for r in results)
        req.response_headers.append(("X-TTFT-Ms", f"{ttft * 1e3:.2f}"))
        # metric→trace exemplar: the TTFT series' worst recent requests
        # stay linked to their traces (/tracez)
        tracer.observe_exemplar(
            "serving_time_to_first_token_seconds", ttft, trace_id
        )
        return {"sequences": sequences}

    # -- page handoff between replicas -------------------------------------

    def _engine_for_handoff(self, model: str):
        """A shipment's engine: the manifest's model when loaded, else
        the server's only engine (a one-model replica needs no name
        match)."""
        engine = self._engines.get(model)
        if engine is None and len(self._engines) == 1:
            engine = next(iter(self._engines.values()))
        if engine is None:
            raise NotFoundError(
                f"no decode engine for handed-off model {model!r}"
            )
        return engine

    def _ship_pages(self, engine, entries, url: str) -> Dict[str, Any]:
        """Encode `entries` and POST them to a peer's /v1/kv/pages.
        Returns the peer's verdict; raises HttpError(502) when the peer
        is unreachable or rejects the shipment. Counts the pages out; the
        caller counts the milliseconds (export and every ship)."""
        data = encode_page_entries(entries, engine.page_size,
                                   engine.quantize, model=engine.name)
        try:
            status, raw = self._page_transport(url, data)
        except Exception as e:  # a dead peer is a 502
            raise HttpError(502, f"page handoff to {url} failed: {e}") from e
        try:
            doc = json.loads(raw.decode() if isinstance(raw, (bytes, bytearray))
                             else raw)
        except (ValueError, AttributeError, TypeError):
            doc = {}
        if not isinstance(doc, dict):
            doc = {}
        if status >= 400:
            raise HttpError(502, f"peer {url} rejected page handoff: "
                                 f"{status} {doc.get('log', '')}".strip())
        self._handoff_pages_m.inc(len(entries), model=engine.name,
                                  direction="out")
        return doc

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

        @app.post("/v1/kv/pages", binary=True)
        def kv_pages(req):
            """The receiving side of a handoff: the body is one
            `encode_page_entries` envelope (application/octet-stream);
            its pages are admitted into the engine's pool and radix index
            as committed chains, so the next request sharing the prefix
            is a prefix hit. The page geometry (page_size, quantize) must
            be the engine's: a mismatched shipment is rejected whole."""
            if not isinstance(req.body, (bytes, bytearray)):
                raise BadRequest(
                    "send an encode_page_entries envelope with "
                    "Content-Type: application/octet-stream"
                )
            try:
                manifest, entries = decode_page_entries(bytes(req.body))
            except ValueError as e:
                raise BadRequest(f"bad page envelope: {e}")
            engine = self._engine_for_handoff(str(manifest.get("model", "")))
            if int(manifest.get("page_size", 0)) != engine.page_size:
                raise BadRequest(
                    f"envelope page_size {manifest.get('page_size')} does "
                    f"not match engine page_size {engine.page_size}"
                )
            if str(manifest.get("quantize")) != str(engine.quantize):
                raise BadRequest(
                    f"envelope quantize {manifest.get('quantize')!r} does "
                    f"not match engine quantize {engine.quantize!r}"
                )
            try:
                admitted = engine.import_page_entries(entries)
            except ValueError as e:
                raise BadRequest(f"page envelope does not fit engine: {e}")
            return {"model": engine.name, "entries": len(entries),
                    "admitted": admitted}

        @app.post("/v1/models/<name>:prefill")
        def prefill(req):
            """The prefill replica's side of a handoff: body {"prompt_ids":
            [...]} plus an optional "handoff_url" (the decode home's
            /v1/kv/pages). Prefills the prompt to page completion (greedy,
            one token: prefill does not depend on sampling, so the
            committed pages are the bits any engine computes), exports
            its committed chain and ships it; the decode home then admits
            the request as a prefix hit."""
            name = req.params["name"]
            engine = self._engines.get(name)
            if engine is None:
                raise NotFoundError(f"no decode engine for model {name}")
            body = req.body or {}
            if not isinstance(body, dict):
                raise BadRequest("request body must be a JSON object")
            prompt = body.get("prompt_ids")
            if prompt is None:
                raise BadRequest("request body must contain 'prompt_ids'")
            try:
                row = np.asarray(prompt, dtype=np.int64)
            except (ValueError, TypeError) as e:
                raise BadRequest(f"bad prefill request: {e}")
            if row.ndim == 2 and row.shape[0] == 1:
                row = row[0]  # routers forward the :generate row shape
            if row.ndim != 1:
                raise BadRequest(
                    "bad prefill request: prompt_ids must be one row"
                )
            t0 = time.monotonic()
            try:
                future = engine.submit(row, 1, temperature=0.0)
            except EngineDrainingError as e:
                _retry_after(req, e)
                raise HttpError(429, str(e))
            except QueueFullError as e:
                raise HttpError(429, str(e))
            except (ValueError, TypeError) as e:
                raise BadRequest(f"bad prefill request: {e}")
            future.wait(self.ENGINE_WAIT_S)
            entries = engine.export_prefix_entries(row)
            shipped: Dict[str, Any] = {}
            url = body.get("handoff_url")
            if url and entries:
                shipped = self._ship_pages(engine, entries, str(url))
                self._handoff_ms_m.inc((time.monotonic() - t0) * 1e3,
                                       model=engine.name, direction="out")
            return {"model": engine.name, "pages": len(entries),
                    "handoff": shipped}

        @app.post("/v1/kv/handoff")
        def kv_handoff(req):
            """The scale-down side of a handoff: body {"peers":
            {replica_id: base_url}, "chains": N?}. Exports each engine's
            hottest committed chains (the pool's and the host tier's) and
            ships every chain to its first-page key's rendezvous home
            among `peers`: the replica the router sends that key to once
            this one is gone. Failures are reported per peer, never
            fatal: a drain window ships what it can."""
            body = req.body or {}
            if not isinstance(body, dict):
                raise BadRequest("request body must be a JSON object")
            peers = body.get("peers")
            if not isinstance(peers, dict) or not peers:
                raise BadRequest(
                    "request body must carry 'peers': {replica_id: url}"
                )
            try:
                chains = int(body.get("chains", 0))
            except (ValueError, TypeError) as e:
                raise BadRequest(f"bad handoff request: {e}")
            if chains <= 0:
                chains = DisaggConfig().handoff_chains
            verdicts: Dict[str, Any] = {}
            for engine in self._engines.values():
                t0 = time.monotonic()
                entries = engine.export_hot_entries(chains)
                groups: Dict[str, list] = {}
                for ent in entries:
                    key = first_page_key(ent[0], engine.page_size)
                    home = rendezvous_rank(key, list(peers))[0]
                    groups.setdefault(home, []).append(ent)
                for rid, ents in groups.items():
                    url = str(peers[rid]).rstrip("/") + "/v1/kv/pages"
                    verdict = verdicts.setdefault(
                        rid, {"pages": 0, "admitted": 0}
                    )
                    try:
                        doc = self._ship_pages(engine, ents, url)
                    except HttpError as e:
                        verdict["error"] = e.message
                        continue
                    verdict["pages"] += len(ents)
                    verdict["admitted"] += int(doc.get("admitted", 0))
                if entries:
                    self._handoff_ms_m.inc((time.monotonic() - t0) * 1e3,
                                           model=engine.name, direction="out")
            return {"peers": verdicts}

        return app
