"""Model server speaking the TF-Serving REST contract (port of
kubeflow_tpu/serving/server.py).

Routes: `POST /v1/models/<name>:predict` (JSON `{"instances": [...]}` →
`{"predictions": [...]}`) and `:predict_npy` (one .npy body each way,
with the latency decomposition headers) for `ServedModel`s;
`POST /v1/models/<name>:generate` (through the DecodeEngine when one is
attached, else the static ServedLm path); `GET /v1/models` and
`GET /v1/models/<name>` (model discovery, as the kft-router forwards
them), `GET /healthz` and `GET /metrics` (Prometheus text). The bodies
and error codes are the reference server's.

`ServedModel` serves any `apply_fn(params, x)` on the card: requests are
padded to the batch buckets (1, 2, 4 … 128), a request past the largest
is chunked through it, and with `batch_window_ms` > 0 concurrent
requests fuse into one device call a window (serving/batching.py). Its
device call runs under a lock (the batcher's thread and the WSGI
threads share the card) and reports its decomposition: transfer in,
device, transfer out, each closed by `torch.cuda.synchronize()` where
the reference blocks until ready.

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

import io
import json
import math
import threading
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

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
from kubeflow_tpu_torch.utils.device import DeviceLike, resolve_device
from kubeflow_tpu_torch.utils.metrics import (
    default_registry,
    serving_kv_handoff_ms_counter,
    serving_kv_handoff_pages_counter,
    serving_predict_histogram,
    serving_requests_counter,
)

log = get_logger(__name__)

# the drain budget close(drain=True) gives the engines by default (the
# reference's DEFAULT_DRAIN_DEADLINE_S)
DEFAULT_DRAIN_DEADLINE_S = 30.0

# one POST of committed pages to a peer replica: bounded well under the
# drain deadline, so a dead peer cannot eat the whole drain window
PAGE_SHIP_TIMEOUT_S = 60.0

# the padded batch sizes of a ServedModel's device calls
BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)


def bucket_for(n: int) -> int:
    for b in BATCH_BUCKETS:
        if n <= b:
            return b
    return BATCH_BUCKETS[-1]


def publish_kernel_launches() -> None:
    """Copy this process's paged-kernel launch counts
    (ops/paged_attention.py `launch_counts`) into the
    `serving_kernel_launches` gauge, read at each scrape of /metrics: a
    pod started from its rendered command shows there which kernels
    served it. The CPU path launches nothing, so its counts stay 0."""
    from kubeflow_tpu_torch.ops import paged_attention

    gauge = default_registry().gauge(
        "serving_kernel_launches",
        "CUDA kernel launches of this process", ["kernel"],
    )
    for kernel, n in paged_attention.launch_counts.items():
        gauge.set(n, kernel=kernel)


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


class ServedModel:
    """One named, versioned model: `apply_fn(params, x)` on the device over
    bucket-padded batches. `x` reaches it as a tensor on `device`
    (default "cuda"; raises without CUDA unless "cpu"); it returns the
    predictions [N, ...] as a tensor."""

    def __init__(self, name: str, apply_fn: Callable[[Any, torch.Tensor],
                                                     torch.Tensor],
                 params: Any, version: str = "1",
                 postprocess: Optional[Callable[[np.ndarray], Any]] = None,
                 batch_window_ms: float = 0.0, device: DeviceLike = None):
        self.name = name
        self.version = version
        self.params = params
        self.postprocess = postprocess
        self.device = resolve_device(device)
        self._apply = apply_fn
        self._lock = threading.Lock()
        self._latency = serving_predict_histogram()
        self._requests = serving_requests_counter()
        # concurrent requests fuse into one device call a window; 0 = off
        self._batcher = None
        if batch_window_ms > 0:
            from kubeflow_tpu_torch.serving.batching import MicroBatcher

            self._batcher = MicroBatcher(
                self._device_predict, max_rows=BATCH_BUCKETS[-1],
                window_ms=batch_window_ms, name=name,
            )

    def close(self) -> None:
        if self._batcher is not None:
            self._batcher.close()

    @classmethod
    def from_registry(cls, model_name: str,
                      checkpoint_dir: Optional[str] = None, params: Any = None,
                      served_name: Optional[str] = None,
                      batch_window_ms: float = 0.0, device: DeviceLike = None,
                      **model_kwargs) -> "ServedModel":
        """A registry model with params only, as the reference has it:
        `params` (a flax tree, nested as `restore_checkpoint_params`
        returns it, or a state dict), else the latest committed
        checkpoint in `checkpoint_dir`. A model with BatchNorm running
        averages cannot be served from params alone (the reference
        fails the same way at its first apply: flax finds no
        `batch_stats`): this raises ValueError naming them; serve such a
        model through `ServedModel(name, apply_fn, variables)`."""
        from kubeflow_tpu_torch.models.convert import (
            is_batch_stat,
            params_from_jax,
        )
        from kubeflow_tpu_torch.models.registry import get_model

        model = get_model(model_name, device=device, **model_kwargs)
        if params is None:
            params = restore_checkpoint_params(checkpoint_dir)
        if any(isinstance(v, Mapping) for v in params.values()):
            params = params_from_jax(params)
        missing, unexpected = model.load_state_dict(params, strict=False)
        stats = [k for k in missing if is_batch_stat(k)]
        if stats:
            raise ValueError(
                f"model {model_name} reads BatchNorm running averages "
                f"(batch_stats: {stats[:2]} and {len(stats) - 2} more) that "
                f"from_registry's params do not carry; serve it through "
                f"ServedModel(name, apply_fn, variables) with its batch_stats"
            )
        if missing or unexpected:
            raise ValueError(f"params do not match model {model_name}: "
                             f"missing {missing[:4]}, unexpected "
                             f"{unexpected[:4]}")

        def apply_fn(m, x):
            return m(x, train=False)

        return cls(served_name or model_name, apply_fn, model,
                   batch_window_ms=batch_window_ms, device=model.device)

    def predict_array(self, x: np.ndarray) -> np.ndarray:
        """Array in, array out: bucket pad, the device call, unpad (the
        :predict_npy path). With micro-batching on, concurrent calls fuse
        into one device batch a window."""
        return self.predict_array_with_decomp(x)[0]

    def predict_array_with_decomp(self, x: np.ndarray):
        """predict_array plus the decomposition of the device call THIS
        request rode (through the batcher's aux channel when batching),
        never a concurrent neighbour's."""
        n = x.shape[0]
        if n == 0:
            # a prediction-shaped empty reply: one padded row's shape
            y, _ = self._device_predict(np.zeros((1,) + x.shape[1:], x.dtype))
            return np.zeros((0,) + y.shape[1:], y.dtype), {}
        if n > BATCH_BUCKETS[-1]:
            # chunk through the largest bucket (the decomposition reported
            # is the last chunk's: one device call's worth)
            chunks = [self.predict_array_with_decomp(x[i:i + BATCH_BUCKETS[-1]])
                      for i in range(0, n, BATCH_BUCKETS[-1])]
            return np.concatenate([c[0] for c in chunks], axis=0), chunks[-1][1]
        self._requests.inc(model=self.name)
        with self._latency.time(model=self.name):
            if self._batcher is not None:
                y, decomp = self._batcher.submit_with_aux(x)
                return y, decomp or {}
            return self._device_predict(x)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _device_predict(self, x: np.ndarray):
        """Padded, locked device call(s) → (rows, decomposition); chunks
        past the largest bucket (a fused batch can exceed it when submits
        race the window)."""
        n = x.shape[0]
        if n > BATCH_BUCKETS[-1]:
            chunks = [self._device_predict(x[i:i + BATCH_BUCKETS[-1]])
                      for i in range(0, n, BATCH_BUCKETS[-1])]
            return np.concatenate([c[0] for c in chunks], axis=0), chunks[-1][1]
        padded_n = bucket_for(n)
        if padded_n != n:
            x = np.concatenate([x, np.repeat(x[:1], padded_n - n, axis=0)])
        with self._lock, torch.no_grad():
            t0 = time.monotonic()
            xd = torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
            self._sync()
            t1 = time.monotonic()
            y = self._apply(self.params, xd)
            self._sync()
            t2 = time.monotonic()
            out = y.cpu().numpy()
            t3 = time.monotonic()
            decomp = {
                "rows": float(padded_n),
                "transfer_in_ms": (t1 - t0) * 1e3,
                "device_ms": (t2 - t1) * 1e3,
                "transfer_out_ms": (t3 - t2) * 1e3,
            }
        return out[:n], decomp

    def warmup(self, element_shape: Sequence[int], dtype: Any = np.float32,
               max_rows: Optional[int] = None) -> None:
        """One device call at every bucket up to the one `max_rows` rows
        run on (all by default): the batcher fuses requests into buckets
        no single request hits, and an unwarmed bucket pays its library
        warm-up (cuDNN's algorithm choice) inside some client's request.
        With micro-batching on, the calls go through the batcher's thread,
        the thread that serves: PyTorch keeps cuDNN's chosen plans per
        thread, so a warm-up on another thread leaves the serving thread
        cold (measured on an H100: its first 64-row call then took 1.5 s
        with `cudnn.benchmark` on, later ones ~10 ms)."""
        limit = bucket_for(max_rows if max_rows is not None
                           else BATCH_BUCKETS[-1])
        run = (self._device_predict if self._batcher is None
               else self._batcher.submit)
        for b in BATCH_BUCKETS:
            if b > limit:
                break
            run(np.zeros((b,) + tuple(element_shape), dtype))

    def batch_stats(self) -> Dict[str, float]:
        """Micro-batcher evidence: device batches run and the mean rows a
        batch (proof that concurrent requests fused)."""
        if self._batcher is None:
            return {}
        hist = self._batcher._fused
        count = hist.count(model=self.name)
        return {
            "fused_batches": float(count),
            "fused_rows_mean": (hist.sum(model=self.name) / count
                                if count else 0.0),
        }

    def predict(self, instances: Sequence) -> List:
        if len(instances) == 0:
            return []
        y = self.predict_array(np.asarray(instances, dtype=np.float32))
        if self.postprocess is not None:
            return [self.postprocess(row) for row in y]
        return [row.tolist() for row in y]


class ModelServer:
    """Multi-model server: ServedModels (`:predict`), ServedLms and their
    engines (`:generate`)."""

    # generous bound: an engine request waits behind at most max_queue
    # admissions; a hung engine must surface as a 500, not a stuck socket
    ENGINE_WAIT_S = 600.0

    def __init__(self, page_transport: Optional[
            Callable[[str, bytes], Tuple[int, bytes]]] = None,
            statusz_enabled: bool = True) -> None:
        self._models: Dict[str, ServedModel] = {}
        self._lms: Dict[str, Any] = {}      # ServedLm (serving/generate.py)
        self._engines: Dict[str, Any] = {}  # DecodeEngine (serving/engine.py)
        # how this replica POSTs page envelopes to a peer's /v1/kv/pages
        self._page_transport = page_transport or _default_page_transport
        self._handoff_pages_m = serving_kv_handoff_pages_counter()
        self._handoff_ms_m = serving_kv_handoff_ms_counter()
        # set as close(drain=True) starts, so /healthz reports the drain
        # from its first moment
        self._draining = False
        # the SIGTERM drain budget close(drain=True) gives the engines
        # (serving/main.py sets it from KFT_SERVING_DRAIN_DEADLINE_S)
        self.drain_deadline_s = DEFAULT_DRAIN_DEADLINE_S
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
        lines = [f"  {m.name} (predict, version {m.version})"
                 for m in self._models.values()]
        lines += [
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
        """The JAX server's engine lines: an MoE engine's `moe:` line
        follows its kv pool line; a dense engine has none."""
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
            moe = st["moe"]
            if moe is not None:
                occ = " ".join(f"e{i}={v:g}"
                               for i, v in enumerate(moe["expert_tokens"]))
                lines.append(
                    f"    moe: routed={moe['routed_positions']:g} "
                    f"dropped={moe['dropped']:g} "
                    f"imbalance={moe['load_imbalance']:.3f} [{occ}]"
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

    def add(self, model: ServedModel) -> None:
        """Register a ServedModel for :predict and :predict_npy."""
        self._models[model.name] = model

    def remove(self, name: str) -> None:
        self._models.pop(name, None)
        self._lms.pop(name, None)
        engine = self._engines.pop(name, None)
        if engine is not None:
            engine.close()

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
              drain_deadline_s: Optional[float] = None) -> bool:
        """Stop the engines' scheduler threads (the shutdown hook).

        `drain=True` is the scale-down/SIGTERM path: every engine stops
        admitting (new `:generate` requests get 429 + Retry-After) while
        everything already accepted runs to completion; what is still
        live at the deadline fails fast. Engines drain concurrently, so
        the whole shutdown is bounded by one deadline (default
        `self.drain_deadline_s`). Returns True when every engine drained
        in time (always True without `drain`)."""
        if drain_deadline_s is None:
            drain_deadline_s = self.drain_deadline_s
        for model in self._models.values():
            model.close()
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

    def failed_engines(self) -> list:
        """Names of the engines that failed for good (`DecodeEngine.
        failed`)."""
        return sorted(n for n, e in self._engines.items()
                      if e.failed is not None)

    def _build(self) -> App:
        app = App("model-server")

        @app.get("/healthz")
        def healthz(req):
            """{"ok", "draining", "models"}; 503 while the server or any
            engine drains, so readiness drops a draining replica that
            still answers (a dead one answers nothing), and with "ok"
            false once an engine failed for good (a serving mesh out of
            step: `DecodeEngine.failed`)."""
            names = sorted(set(self._models) | set(self._lms)
                           | set(self._engines))
            draining = self._draining or any(
                e.draining for e in self._engines.values()
            )
            ok = not self.failed_engines()
            body = {"ok": ok, "draining": draining, "models": names}
            return (body, 503) if draining or not ok else body

        @app.get("/v1/models")
        def list_models(req):
            """Every model: ServedModels, then ServedLms, then
            engine-only ones; each generative one with continuous
            batching when an engine serves it."""
            return {
                "models": [
                    {"name": m.name, "version": m.version}
                    for m in self._models.values()
                ] + [
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
            model = self._models.get(name)
            if (model is None and name not in self._lms
                    and name not in self._engines):
                raise NotFoundError(f"model {name} not loaded")
            return {
                "model_version_status": [{
                    "version": model.version if model is not None else "1",
                    "state": "AVAILABLE",
                    "status": {"error_code": "OK", "error_message": ""},
                }]
            }

        @app.get("/metrics")
        def metrics(req):
            publish_kernel_launches()
            return Response(
                default_registry().render(),
                "text/plain; version=0.0.4; charset=utf-8",
            )

        @app.post("/v1/models/<name>:predict")
        def predict(req):
            model = self._models.get(req.params["name"])
            if model is None:
                raise NotFoundError(f"model {req.params['name']} not loaded")
            instances = (req.body or {}).get("instances")
            if instances is None:
                raise BadRequest("request body must contain 'instances'")
            try:
                predictions = model.predict(instances)
            except (ValueError, TypeError) as e:
                raise BadRequest(f"bad instances: {e}")
            return {"predictions": predictions}

        @app.post("/v1/models/<name>:predict_npy", binary=True)
        def predict_npy(req):
            """The binary path: the request body is one .npy array (the
            instances), the reply one .npy array of predictions, with the
            server's latency split in headers: parse, compute (transfer
            in, device, transfer out of the batch this request rode, and
            its padded rows) and serialize."""
            model = self._models.get(req.params["name"])
            if model is None:
                raise NotFoundError(f"model {req.params['name']} not loaded")
            if model.postprocess is not None:
                # per-row Python objects have no .npy encoding
                raise BadRequest(
                    f"model {model.name} has a postprocessor; use :predict")
            if not isinstance(req.body, (bytes, bytearray)):
                raise BadRequest(
                    "send the instances tensor as one .npy body with "
                    "Content-Type: application/octet-stream")
            t0 = time.monotonic()
            try:
                x = np.load(io.BytesIO(req.body), allow_pickle=False)
            except (ValueError, OSError, EOFError) as e:
                raise BadRequest(f"bad npy payload: {e}")
            if getattr(x, "ndim", 0) < 1:
                raise BadRequest("instances tensor must be at least rank 1")
            t1 = time.monotonic()
            try:
                y, decomp = model.predict_array_with_decomp(
                    np.asarray(x, dtype=np.float32))
            except (ValueError, TypeError) as e:
                raise BadRequest(f"bad instances: {e}")
            t2 = time.monotonic()
            buf = io.BytesIO()
            np.save(buf, y, allow_pickle=False)
            t3 = time.monotonic()
            headers = [
                ("X-Parse-Ms", f"{(t1 - t0) * 1e3:.2f}"),
                ("X-Compute-Ms", f"{(t2 - t1) * 1e3:.2f}"),
                ("X-Serialize-Ms", f"{(t3 - t2) * 1e3:.2f}"),
            ]
            for key, hdr in (("transfer_in_ms", "X-Transfer-In-Ms"),
                             ("device_ms", "X-Device-Ms"),
                             ("transfer_out_ms", "X-Transfer-Out-Ms"),
                             ("rows", "X-Device-Batch-Rows")):
                if key in decomp:
                    headers.append((hdr, f"{decomp[key]:.2f}"))
            req.response_headers.extend(headers)
            return Response(buf.getvalue(), "application/octet-stream")

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
