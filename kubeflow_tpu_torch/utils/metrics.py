"""Prometheus-style metrics registry (copy of the subset of
kubeflow_tpu/utils/metrics.py the port uses): counters, gauges and
histograms with labels, a registry, and a renderer in the Prometheus
text exposition format for `/metrics`. Thread-safe; no dependency."""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, Optional, Sequence, Tuple

LabelValues = Tuple[str, ...]


def _validate_labels(
    names: Sequence[str], labels: Dict[str, str]
) -> LabelValues:
    if set(labels) != set(names):
        raise ValueError(
            f"label mismatch: expected {sorted(names)}, got {sorted(labels)}"
        )
    return tuple(labels[n] for n in names)


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str, label_names: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.label_names = tuple(label_names)
        self._lock = threading.Lock()

    def _render_series(self) -> Iterable[str]:  # pragma: no cover - abstract
        raise NotImplementedError

    def render(self) -> str:
        lines = [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} {self.kind}",
        ]
        lines.extend(self._render_series())
        return "\n".join(lines)

    def _fmt_labels(self, values: LabelValues, extra: str = "") -> str:
        parts = [f'{n}="{v}"' for n, v in zip(self.label_names, values)]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""


class _ValueMetric(_Metric):
    """One float per label set: the shared body of Counter and Gauge."""

    def __init__(self, name: str, help: str, label_names: Sequence[str] = ()):
        super().__init__(name, help, label_names)
        self._values: Dict[LabelValues, float] = {}

    def _add(self, amount: float, labels: Dict[str, str]) -> None:
        key = _validate_labels(self.label_names, labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def value(self, **labels: str) -> float:
        key = _validate_labels(self.label_names, labels)
        with self._lock:
            return self._values.get(key, 0.0)

    def values_snapshot(self) -> Dict[LabelValues, float]:
        """Every labelled series, copied under the metric's lock: how a
        telemetry reader (serving/kv_tiers.py `pool_sizing_telemetry`)
        scans the series while the engine updates them."""
        with self._lock:
            return dict(self._values)

    def _render_series(self) -> Iterable[str]:
        with self._lock:
            items = sorted(self._values.items())
        if not items and not self.label_names:
            items = [((), 0.0)]
        for values, v in items:
            yield f"{self.name}{self._fmt_labels(values)} {v:g}"


class Counter(_ValueMetric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        self._add(amount, labels)


class Gauge(_ValueMetric):
    kind = "gauge"

    def set(self, value: float, **labels: str) -> None:
        key = _validate_labels(self.label_names, labels)
        with self._lock:
            self._values[key] = float(value)


DEFAULT_BUCKETS = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60,
    120, 300, 600,
)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(
        self,
        name: str,
        help: str,
        label_names: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ):
        super().__init__(name, help, label_names)
        self.buckets = tuple(sorted(buckets))
        self._counts: Dict[LabelValues, list] = {}
        self._sums: Dict[LabelValues, float] = {}
        self._totals: Dict[LabelValues, int] = {}

    def observe(self, value: float, **labels: str) -> None:
        key = _validate_labels(self.label_names, labels)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    def count(self, **labels: str) -> int:
        key = _validate_labels(self.label_names, labels)
        with self._lock:
            return self._totals.get(key, 0)

    def sum(self, **labels: str) -> float:
        key = _validate_labels(self.label_names, labels)
        with self._lock:
            return self._sums.get(key, 0.0)

    def time(self, **labels: str) -> "_Timer":
        return _Timer(self, labels)

    def _render_series(self) -> Iterable[str]:
        with self._lock:
            snapshot = [
                (k, list(self._counts[k]), self._sums[k], self._totals[k])
                for k in sorted(self._counts)
            ]
        for key, counts, s, total in snapshot:
            for b, c in zip(self.buckets, counts):
                extra = f'le="{b:g}"'
                yield f"{self.name}_bucket{self._fmt_labels(key, extra)} {c}"
            inf_label = 'le="+Inf"'
            yield f"{self.name}_bucket{self._fmt_labels(key, inf_label)} {total}"
            yield f"{self.name}_sum{self._fmt_labels(key)} {s:g}"
            yield f"{self.name}_count{self._fmt_labels(key)} {total}"


class _Timer:
    def __init__(self, hist: Histogram, labels: Dict[str, str]):
        self._hist = hist
        self._labels = labels

    def __enter__(self):
        self._start = time.monotonic()
        return self

    def __exit__(self, *exc):
        self._hist.observe(time.monotonic() - self._start, **self._labels)
        return False


class MetricsRegistry:
    """A named collection of metrics with a text exposition renderer."""

    def __init__(self) -> None:
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def counter(
        self, name: str, help: str = "", label_names: Sequence[str] = ()
    ) -> Counter:
        return self._get_or_create(Counter, name, help, label_names)

    def gauge(
        self, name: str, help: str = "", label_names: Sequence[str] = ()
    ) -> Gauge:
        return self._get_or_create(Gauge, name, help, label_names)

    def histogram(
        self,
        name: str,
        help: str = "",
        label_names: Sequence[str] = (),
        buckets: Sequence[float] = DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help, label_names, buckets=buckets
        )

    def _get_or_create(self, cls, name, help, label_names, **kwargs):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls):
                    raise ValueError(
                        f"{name} already registered as {existing.kind}"
                    )
                return existing
            m = cls(name, help, label_names, **kwargs)
            self._metrics[name] = m
            return m

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def render(self) -> str:
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        return "\n".join(m.render() for m in metrics) + (
            "\n" if metrics else ""
        )


_default_registry = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return _default_registry


# -- the training loop's series (Trainer.fit) ---------------------------------

HOST_WAIT_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1, 2.5, 5, 10,
)


def training_step_histogram() -> Histogram:
    """Steady-state train step wall time (first step fenced out)."""
    return default_registry().histogram(
        "training_step_seconds", "train step latency", ["model"]
    )


def training_items_gauge() -> Gauge:
    """Items (tokens for an LM) per second over the last log window."""
    return default_registry().gauge(
        "training_items_per_sec", "items (images/tokens) per second",
        ["model"],
    )


def host_wait_histogram() -> Histogram:
    """Time `Trainer.fit` blocks on host input each step: making the
    batch and enqueuing its copy to the device."""
    return default_registry().histogram(
        "training_host_wait_seconds",
        "seconds the train loop blocked waiting on host input per step",
        ["model"],
        buckets=HOST_WAIT_BUCKETS,
    )


def training_mfu_gauge() -> Gauge:
    """Model-FLOPs utilization of the train step: analytic model FLOPs
    over step wall time over the card's peak (observability/mfu.py)."""
    return default_registry().gauge(
        "training_model_flops_utilization",
        "train-step model-FLOPs utilization (achieved / per-chip peak)",
        ["model"],
    )


def training_eval_top1_gauge() -> Gauge:
    """Held-out top-1 accuracy of the last eval pass (`Trainer.fit`)."""
    return default_registry().gauge(
        "training_eval_top1", "held-out top-1 accuracy", ["model"]
    )


def training_goodput_gauge() -> Gauge:
    """Fraction of the training wall window spent feeding the device:
    1 minus the host input-wait share per logging window."""
    return default_registry().gauge(
        "training_goodput",
        "fraction of training wall time not lost to host-side overheads",
        ["model"],
    )


def prefetch_queue_depth_gauge() -> Gauge:
    """Device-ready batches sitting in the DevicePrefetcher's queue."""
    return default_registry().gauge(
        "training_prefetch_queue_depth",
        "device-ready batches buffered ahead of the train step",
        ["model"],
    )


# -- the :predict path (serving/server.py, serving/batching.py) ---------------

FUSED_BATCH_ROWS_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128)


def serving_predict_histogram() -> Histogram:
    """Wall seconds of one `ServedModel` predict call (a fused batch's
    wait included)."""
    return default_registry().histogram(
        "serving_predict_seconds", "predict latency", ["model"]
    )


def serving_requests_counter() -> Counter:
    """`ServedModel` predict calls (each chunk of a request past the
    largest bucket counts)."""
    return default_registry().counter(
        "serving_requests_total", "predict requests", ["model"]
    )


def serving_fused_rows_histogram() -> Histogram:
    """Rows of each device batch the micro-batcher fused."""
    return default_registry().histogram(
        "serving_fused_batch_rows", "rows per fused device batch", ["model"],
        buckets=FUSED_BATCH_ROWS_BUCKETS,
    )


# -- checkpointing (checkpointing/manager.py) ---------------------------------

# Blocked time spans µs (async enqueue) to seconds (sync save / full
# in-flight window); save wall time spans ms (tiny CI states) to minutes
# (multi-GB states on network volumes).
CHECKPOINT_SECONDS_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1, 2.5, 5, 10, 30, 60, 120, 300,
)


def checkpoint_save_histogram() -> Histogram:
    """End-to-end wall time of one checkpoint save: host snapshot through
    the committed manifest rename (the async writer's cost)."""
    return default_registry().histogram(
        "checkpoint_save_seconds",
        "wall seconds per checkpoint save (snapshot to committed manifest)",
        buckets=CHECKPOINT_SECONDS_BUCKETS,
    )


def checkpoint_blocked_histogram() -> Histogram:
    """Time the train loop itself blocked inside save(): the device→host
    copy of every leaf (and a wait for an in-flight slot when the window
    is full). Async saves keep the writes and the commit out of it."""
    return default_registry().histogram(
        "checkpoint_blocked_seconds",
        "seconds the train loop blocked in checkpoint save()",
        buckets=CHECKPOINT_SECONDS_BUCKETS,
    )


def checkpoint_bytes_counter() -> Counter:
    """Shard bytes this process persisted across all saves."""
    return default_registry().counter(
        "checkpoint_bytes_total", "checkpoint shard bytes written"
    )


def checkpoint_restores_counter() -> Counter:
    """Completed restores (full-state resumes, warm starts and serving
    loads all count: each is one manifest-driven assembly)."""
    return default_registry().counter(
        "checkpoint_restores_total", "checkpoint restores completed"
    )


# -- tiered KV and the page handoff (serving/kv_tiers.py) ---------------------
#
# Spill pages against spill hits is the host tier's economy: pages parked
# at eviction against pages whose re-admission skipped a prefill. Handoff
# pages against handoff milliseconds is the page handoff's: what moved
# between replicas against what the export, wire and upload cost.


def serving_kv_pool_bytes_per_chip_gauge() -> Gauge:
    """What one rank of the serving mesh holds of the pools:
    `serving_kv_pool_bytes / mesh_tensor` (the pools split on heads
    under `tensor` and are whole under `fsdp` and `expert`); the total
    on the 1×1 engine."""
    return default_registry().gauge(
        "serving_kv_pool_bytes_per_chip",
        "resident KV pool bytes per mesh chip",
        ["model"],
    )


def serving_kv_spill_pages_counter() -> Counter:
    """Pages parked in the host tier at radix eviction (copied
    device→host instead of dropped): the spill tier's write side."""
    return default_registry().counter(
        "serving_kv_spill_pages_total",
        "KV pages spilled to the host tier at eviction", ["model"],
    )


def serving_kv_spill_hits_counter() -> Counter:
    """Pages re-admitted from the host tier (a host→device upload
    instead of chunk-prefill compute)."""
    return default_registry().counter(
        "serving_kv_spill_hits_total",
        "KV pages re-admitted from the host tier", ["model"],
    )


def serving_kv_persisted_chains_gauge() -> Gauge:
    """Prefix pages in this engine's last committed on-disk generation
    (or preloaded at start): the warm-restart set a replica hands its
    successor."""
    return default_registry().gauge(
        "serving_kv_persisted_chains",
        "prefix pages in the last persisted generation", ["model"],
    )


def serving_kv_handoff_pages_counter() -> Counter:
    """KV pages moved between replicas, by direction: "out" (exported
    and shipped to a peer) and "in" (decoded off the wire and admitted
    into the pool and the radix index)."""
    return default_registry().counter(
        "serving_kv_handoff_pages_total",
        "KV pages handed off between replicas", ["model", "direction"],
    )


def serving_kv_handoff_ms_counter() -> Counter:
    """Milliseconds spent in page handoff, by direction: "out" covers the
    export (device→host reads) and the POST to the peer, "in" the wire
    decode, the host→device upload and the radix admission. A sum:
    ms a page is this over the pages counter."""
    return default_registry().counter(
        "serving_kv_handoff_ms",
        "milliseconds spent handing off KV pages", ["model", "direction"],
    )


# -- MoE serving (serving/engine.py on an MoE target) -------------------------
#
# Counts are router POSITIONS (idle decode slots and pad tails route
# too): the load-balance evidence, not token billing. Dense engines emit
# none of these series. The JAX package's names, labels and help text.


def serving_moe_expert_tokens_counter() -> Counter:
    """Positions the MoE router dispatched to each expert (summed over
    layers): the per-expert occupancy whose max/mean ratio is the
    load-imbalance gauge below."""
    return default_registry().counter(
        "serving_moe_expert_tokens_total",
        "router positions dispatched to each expert",
        ["model", "expert"],
    )


def serving_moe_capacity_overflow_counter() -> Counter:
    """Router (position, k) assignments dropped at the capacity-factor
    ceiling: each one is a token whose expert contribution was zeroed.
    Nonzero at decode steps would be a routing bug (s = 1 top-1 always
    fits); prefill overflow tracks the capacity_factor knob."""
    return default_registry().counter(
        "serving_moe_capacity_overflow_total",
        "router assignments dropped at the expert capacity ceiling",
        ["model"],
    )


def serving_moe_load_imbalance_gauge() -> Gauge:
    """Max/mean cumulative expert occupancy for this engine (1.0 =
    perfectly balanced routing; E = everything on one expert)."""
    return default_registry().gauge(
        "serving_moe_load_imbalance",
        "max/mean cumulative expert occupancy of the MoE router",
        ["model"],
    )


# -- observability and fault injection (observability/, chaos/) ---------------
#
# The engine's per-phase request accounting and its recoveries, the
# injected faults by point, the process identity line every /metrics
# page carries, and the tail sampler's keep/drop counters: the JAX
# package's series, names, labels and help text.

SERVING_TTFT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5,
    10, 30, 60,
)


def serving_phase_histogram() -> Histogram:
    """Wall seconds per request phase (phase ∈ queue|prefill|decode): the
    exact decomposition of a request's life — TTFT = queue + prefill, full
    latency = TTFT + decode."""
    return default_registry().histogram(
        "serving_request_phase_seconds",
        "wall seconds a request spent in each engine phase",
        ["model", "phase"],
        buckets=SERVING_TTFT_BUCKETS,
    )


def serving_engine_recoveries_counter() -> Counter:
    """Decode-engine scheduler recoveries: a decode iteration raised, the
    resident requests were failed fast and the KV pool(s) reset
    (engine._recover). A climbing rate is a sick device or an engine bug."""
    return default_registry().counter(
        "serving_engine_recoveries_total",
        "decode-engine scheduler recoveries (residents failed, pool rebuilt)",
        ["model"],
    )


def faults_injected_counter() -> Counter:
    """kft-chaos faults actually injected, per named injection point
    (chaos/core.py). Zero unless an operator armed a plan."""
    return default_registry().counter(
        "kft_faults_injected_total",
        "chaos faults injected at named platform injection points",
        ["point"],
    )


def instance_info_gauge() -> Gauge:
    """Identity series every per-process /metrics page carries (value is
    always 1): `instance` is the host/replica id (KFT_FLEET_INSTANCE,
    hostname-pid fallback), `role` is serving|training."""
    return default_registry().gauge(
        "kft_instance_info",
        "per-process identity marker (constant 1)",
        ["instance", "role"],
    )


def trace_kept_counter() -> Counter:
    """Completed request traces the tail sampler KEPT, by reason:
    "error", "tail" (slower than the rolling p99) or "sampled"."""
    return default_registry().counter(
        "kft_trace_kept_total",
        "request traces kept by the tail sampler",
        ["reason"],
    )


def trace_sampled_out_counter() -> Counter:
    """Completed request traces the tail sampler dropped (fast, healthy
    and unlucky against sample_prob)."""
    return default_registry().counter(
        "kft_trace_sampled_out_total",
        "request traces dropped by the tail sampler",
    )
