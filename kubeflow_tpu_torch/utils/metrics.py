"""Prometheus-style metrics registry (copy of the subset of
kubeflow_tpu/utils/metrics.py the port uses): counters, gauges and
histograms with labels, a registry, and a renderer in the Prometheus
text exposition format for `/metrics`. Thread-safe; no dependency."""

from __future__ import annotations

import threading
import time
from typing import Dict, Iterable, Sequence, Tuple

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


def training_goodput_gauge() -> Gauge:
    """Fraction of the training wall window spent feeding the device:
    1 minus the host input-wait share per logging window."""
    return default_registry().gauge(
        "training_goodput",
        "fraction of training wall time not lost to host-side overheads",
        ["model"],
    )
