"""kft-trace — platform-wide structured tracing on a bounded ring buffer
(copy of kubeflow_tpu/observability/trace.py: the same span records,
traceparent grammar, tail sampling, Chrome export and KFT_TRACE_* knobs).

Aggregate Prometheus counters (utils/metrics.py) cannot answer "where did
THIS request's 2.0 s TTFT go" or "what did step 1234 spend on host
input" — questions that need structured, per-phase, per-request
wall-time records. kft-trace is the span layer that answers them. Spans
are host wall time: a span around asynchronous device work closes after
the host has read that work's result, or it measures the launch.

- `Tracer.span(name, **attrs)` — context-managed span on the calling
  thread; nesting is tracked per thread so a span records its parent.
- `Tracer.start_span(...)` / `Span.end(...)` — explicit begin/end for
  spans that START on one thread and END on another (an engine request's
  queue wait begins on the REST handler thread and ends when the scheduler
  thread pops it).
- `Tracer.event(name, **attrs)` — zero-duration instant (compile fence,
  cache rewind).
- records land in ONE bounded ring buffer (thread-safe, fixed capacity, a
  few hundred bytes per span): tracing is always cheap enough to leave on
  in production, and a wedged process still holds its recent history
  for /debug/trace.
- `chrome_trace()` exports the buffer in the Chrome trace-event JSON
  format (one "X" complete event per span, thread-per-track), loadable in
  Perfetto / chrome://tracing directly from the /debug/trace endpoint.

Trace-id propagation: a request-scoped id (the `X-Request-Id` header on
the serving path, or the trace-id half of a W3C-style `traceparent`
minted by the fleet router) rides every span recorded for that request,
so one request's phases can be filtered out of the interleaved buffer —
and, with the router minting the id, correlated ACROSS processes. Spans
inherit the calling thread's current trace context (`trace_context`:
trace id + remote parent span id, strictly thread-local so concurrent
requests on other threads never cross-contaminate); cross-thread spans
carry both explicitly.

Tail-based sampling (`finish_trace`): at request completion the tracer
decides whether the request's spans are worth keeping as a completed
trace — error traces and traces slower than the rolling p99 are ALWAYS
kept, the rest are kept with probability `sample_prob` — into a bounded
completed-traces ring served by `/tracez` (observability/http.py). The
fleet collector pulls every process's /tracez and merges spans by
trace id into one cross-process view (observability/fleet.py
`merged_tracez`).
Exemplars close the metric→trace loop: `observe_exemplar` remembers the
trace ids of the recent worst offenders per latency series, so an SLO
breach links directly to replayable traces.

Knobs flow like every other platform knob: ObservabilityConfig
(config/platform.py) → controller-rendered KFT_TRACE_* env → the
entrypoints (serving/main.py, runtime/train_run.py) call
`configure_from_env()`.
"""

from __future__ import annotations

import itertools
import json
import os
import random
import re
import threading
import time
from collections import deque
from typing import Any, Dict, Iterable, List, Optional, Tuple

# The env contract rendered by the controllers (controllers/inference.py,
# controllers/tpujob.py) and consumed by the serving/runtime entrypoints.
ENV_TRACE_ENABLED = "KFT_TRACE_ENABLED"
ENV_TRACE_BUFFER_SPANS = "KFT_TRACE_BUFFER_SPANS"
ENV_TRACE_STATUSZ = "KFT_TRACE_STATUSZ"
ENV_TRACE_SAMPLE_PROB = "KFT_TRACE_SAMPLE_PROB"
ENV_TRACE_SAMPLE_KEEP = "KFT_TRACE_SAMPLE_KEEP"

DEFAULT_BUFFER_SPANS = 4096
# tail sampling defaults: keep everything (prob 1.0) until an operator
# lowers it — a small fleet's completed-traces ring is cheap, and the
# knob exists for the high-QPS fleets where it is not
DEFAULT_SAMPLE_PROB = 1.0
DEFAULT_SAMPLE_KEEP = 128
# completed-request latencies feeding the rolling p99 tail threshold;
# the tail rule needs a minimum population before "slowest so far"
# stops meaning "first request seen"
_TAIL_LATENCY_WINDOW = 512
_TAIL_MIN_SAMPLES = 20
# finishes between p99 recomputes (the threshold drifts slowly; sorting
# the whole window per completed request would be hot-path work)
_TAIL_REFRESH = 16
# per-series exemplar memory: recent (value, trace_id) observations the
# worst offenders are picked from
_EXEMPLAR_WINDOW = 64
EXEMPLAR_TOP_K = 5


# ---------------------------------------------------------------------------
# W3C-style traceparent (the cross-process propagation header):
#   traceparent: 00-<32 hex trace-id>-<16 hex parent-span-id>-01
# The router mints one per inbound request (or continues a client-sent
# one); the model server extracts it and continues the trace, so one
# request is ONE trace id across the router hop and every replica span.
# ---------------------------------------------------------------------------

TRACEPARENT_HEADER = "traceparent"

_TRACEPARENT_RE = re.compile(
    r"^(?P<ver>[0-9a-f]{2})-(?P<trace>[0-9a-f]{32})"
    r"-(?P<span>[0-9a-f]{16})-(?P<flags>[0-9a-f]{2})$"
)


def mint_trace_id() -> str:
    """A new 32-hex-char W3C trace id (all-zero is invalid per spec)."""
    while True:
        tid = os.urandom(16).hex()
        if tid != "0" * 32:
            return tid


def mint_span_id() -> str:
    """A new 16-hex-char span id."""
    while True:
        sid = os.urandom(8).hex()
        if sid != "0" * 16:
            return sid


def format_traceparent(trace_id: str, span_id: str) -> str:
    """`00-<trace-id>-<span-id>-01` (version 00, sampled flag set)."""
    return f"00-{trace_id}-{span_id}-01"


def parse_traceparent(value: Optional[str]) -> Optional[Tuple[str, str]]:
    """(trace_id, parent_span_id) out of a traceparent header, or None
    for anything malformed — an unparseable header must degrade to a
    locally minted trace, never a 500. Per the W3C grammar: lowercase
    hex, all-zero trace/span ids rejected, version ff rejected."""
    if not value:
        return None
    m = _TRACEPARENT_RE.match(value.strip().lower())
    if m is None:
        return None
    if m.group("ver") == "ff":
        return None
    trace_id, span_id = m.group("trace"), m.group("span")
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id


class SpanRecord:
    """One finished span (or instant event, dur_s == 0.0 and phase "i")."""

    __slots__ = (
        "name", "trace_id", "parent", "t_start", "dur_s", "tid",
        "thread_name", "attrs", "phase", "span_id", "parent_span_id",
    )

    def __init__(self, name, trace_id, parent, t_start, dur_s, tid,
                 thread_name, attrs, phase="X", span_id=None,
                 parent_span_id=None):
        self.name = name
        self.trace_id = trace_id
        self.parent = parent  # enclosing span's name on the same thread
        self.t_start = t_start  # time.monotonic() seconds
        self.dur_s = dur_s
        self.tid = tid
        self.thread_name = thread_name
        self.attrs = attrs
        self.phase = phase
        # W3C-style causality: this span's own 16-hex id and the id of
        # its parent — the ENCLOSING span on this thread, or the REMOTE
        # span that propagated a traceparent here (router → replica)
        self.span_id = span_id
        self.parent_span_id = parent_span_id

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "parent": self.parent,
            "t_start": self.t_start,
            "dur_s": self.dur_s,
            "tid": self.tid,
            "thread_name": self.thread_name,
            "attrs": dict(self.attrs) if self.attrs else {},
            "phase": self.phase,
            "span_id": self.span_id,
            "parent_span_id": self.parent_span_id,
        }


class Span:
    """A live span handle (returned by start_span; span() wraps one).

    `end()` is safe from any thread — the record keeps the STARTING
    thread's track so a request's queue-wait span renders on the thread
    that submitted it, per the thread-per-track export convention.
    """

    __slots__ = (
        "_tracer", "name", "trace_id", "parent", "t_start", "tid",
        "thread_name", "attrs", "_ended", "_on_stack", "span_id",
        "parent_span_id",
    )

    def __init__(self, tracer, name, trace_id, parent, attrs,
                 parent_span_id=None):
        t = threading.current_thread()
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.parent = parent
        self.attrs = attrs
        self.tid = t.ident or 0
        self.thread_name = t.name
        self.t_start = time.monotonic()
        self._ended = False
        self._on_stack = False
        # minted per live span so a forwarded traceparent can name THIS
        # span as the remote parent of the receiving process's spans
        self.span_id = mint_span_id()
        self.parent_span_id = parent_span_id

    def end(self, **extra_attrs) -> None:
        if self._ended:
            return
        self._ended = True
        dur = time.monotonic() - self.t_start
        if extra_attrs:
            attrs = dict(self.attrs) if self.attrs else {}
            attrs.update(extra_attrs)
            self.attrs = attrs
        self._tracer._record(
            SpanRecord(
                self.name, self.trace_id, self.parent, self.t_start, dur,
                self.tid, self.thread_name, self.attrs,
                span_id=self.span_id,
                parent_span_id=self.parent_span_id,
            )
        )

    # -- context-manager protocol (tracer.span(...)) -----------------------

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> bool:
        if self._on_stack:
            self._tracer._pop(self)
        self.end()
        return False


class _NoopSpan:
    """Shared do-nothing span: the disabled-tracer fast path allocates
    nothing and records nothing."""

    __slots__ = ()

    def end(self, **extra_attrs) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NOOP = _NoopSpan()


class Tracer:
    """Thread-safe bounded ring buffer of span records.

    Thread model: the buffer deque and the config fields are guarded by
    `_lock`; per-thread nesting stacks and trace ids live in a
    threading.local (no lock needed — single-thread by construction).
    """

    def __init__(self, capacity: int = DEFAULT_BUFFER_SPANS,
                 enabled: bool = True,
                 sample_prob: float = DEFAULT_SAMPLE_PROB,
                 sample_keep: int = DEFAULT_SAMPLE_KEEP):
        if capacity < 1:
            raise ValueError("trace buffer capacity must be >= 1")
        if not 0.0 <= sample_prob <= 1.0:
            raise ValueError("sample_prob must be in [0, 1]")
        if sample_keep < 1:
            raise ValueError("sample_keep must be >= 1")
        self._lock = threading.Lock()
        self._buf: deque = deque(maxlen=capacity)
        self._capacity = capacity
        self._enabled = bool(enabled)
        self._dropped = 0
        self._tls = threading.local()
        self._ids = itertools.count(1)
        # tail sampling (finish_trace): completed-traces ring + the
        # rolling request-latency window the p99 tail threshold reads.
        # Guarded by `_sample_lock`, NOT `_lock`: finish_trace snapshots
        # the span ring (which takes _lock) while holding it.
        self._sample_lock = threading.Lock()
        self._sample_prob = float(sample_prob)
        self._sample_keep = int(sample_keep)
        self._completed: deque = deque(maxlen=int(sample_keep))
        self._latencies: deque = deque(maxlen=_TAIL_LATENCY_WINDOW)
        # p99 tail threshold, recomputed every _TAIL_REFRESH finishes
        # instead of sorting the whole window per request (hot path)
        self._tail_thr: Optional[float] = None
        self._tail_thr_age = 0
        self._sample_rng = random.Random()
        self._kept = {"error": 0, "tail": 0, "sampled": 0}
        self._sampled_out = 0
        # metric→trace exemplars: per latency-series ring of recent
        # (value, trace_id) observations; worst offenders on demand
        self._exemplars: Dict[str, deque] = {}

    # -- configuration -----------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._enabled

    def configure(self, enabled: Optional[bool] = None,
                  capacity: Optional[int] = None,
                  sample_prob: Optional[float] = None,
                  sample_keep: Optional[int] = None,
                  sample_seed: Optional[int] = None) -> None:
        if enabled is not None:
            # a bare flag, deliberately NOT lock-guarded: the hot-path
            # span()/event() reads must stay lock-free, and a torn read of
            # a Python bool is impossible
            self._enabled = bool(enabled)
        if capacity is not None:
            if capacity < 1:
                raise ValueError("trace buffer capacity must be >= 1")
            with self._lock:
                if capacity != self._capacity:
                    self._buf = deque(self._buf, maxlen=capacity)
                    self._capacity = capacity
        if sample_prob is not None:
            if not 0.0 <= sample_prob <= 1.0:
                raise ValueError("sample_prob must be in [0, 1]")
            with self._sample_lock:
                self._sample_prob = float(sample_prob)
        if sample_keep is not None:
            if sample_keep < 1:
                raise ValueError("sample_keep must be >= 1")
            with self._sample_lock:
                if sample_keep != self._sample_keep:
                    self._completed = deque(
                        self._completed, maxlen=int(sample_keep)
                    )
                    self._sample_keep = int(sample_keep)
        if sample_seed is not None:
            # deterministic sampling decisions for tests
            with self._sample_lock:
                self._sample_rng = random.Random(sample_seed)

    @property
    def capacity(self) -> int:
        with self._lock:
            return self._capacity

    # -- trace-id propagation ---------------------------------------------
    #
    # The context is STRICTLY thread-local (`self._tls`): a trace id set
    # on one HTTP handler thread is invisible to every other thread, so
    # the router's concurrent forwards (and any number of concurrent
    # replica handler threads) can each carry their own request's context
    # without cross-contamination. The one leak vector left is a REUSED
    # thread (keep-alive connections, pooled workers): always set the
    # context through the restoring `trace_context` manager on request
    # paths, never a bare `set_trace_id`, so the previous request's id
    # cannot bleed into the next one handled on the same thread.

    def set_trace_id(self, trace_id: Optional[str]) -> None:
        """Set the calling thread's trace id (thread-local; other
        threads' contexts are untouched). Also clears any remote parent
        span id — a new id means a new context, and keeping the old
        parent would attach the new trace to the old trace's span."""
        self._tls.trace_id = trace_id
        self._tls.parent_span_id = None

    def set_trace_context(
        self, trace_id: Optional[str],
        parent_span_id: Optional[str] = None,
    ) -> None:
        """set_trace_id plus the remote parent span id (the span-id half
        of an extracted traceparent): spans opened on this thread record
        it as their parent_span_id until a local ancestor exists."""
        self._tls.trace_id = trace_id
        self._tls.parent_span_id = parent_span_id

    def current_trace_id(self) -> Optional[str]:
        return getattr(self._tls, "trace_id", None)

    def current_parent_span_id(self) -> Optional[str]:
        """The calling thread's ambient parent span id: the innermost
        open span's own id, else the remote parent from the thread's
        trace context (an extracted traceparent), else None."""
        stack = getattr(self._tls, "stack", None)
        if stack:
            return stack[-1].span_id
        return getattr(self._tls, "parent_span_id", None)

    def new_trace_id(self, prefix: str = "t") -> str:
        """Process-unique fallback id for callers without an X-Request-Id."""
        return f"{prefix}-{os.getpid():x}-{next(self._ids):x}"

    def trace_context(self, trace_id: Optional[str],
                      parent_span_id: Optional[str] = None):
        """Context manager: set the calling thread's trace context
        (trace id + optional remote parent span id), restore the
        previous context on exit — ALWAYS, including on exception, so a
        reused handler thread never leaks one request's id into the
        next. Spans opened inside inherit both."""
        return _TraceContext(self, trace_id, parent_span_id)

    # -- span API ----------------------------------------------------------

    def _stack(self) -> List[Span]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = []
            self._tls.stack = stack
        return stack

    def span(self, name: str, trace_id: Optional[str] = None,
             parent_span_id: Optional[str] = None, **attrs) -> Any:
        """Context-managed span on the calling thread. Nested spans record
        their parent's name; the trace id defaults to the thread's current
        one (`trace_context`), the parent span id to the enclosing span's
        (else the thread's remote parent from an extracted traceparent)."""
        if not self._enabled:
            return _NOOP
        stack = self._stack()
        parent = stack[-1].name if stack else None
        if trace_id is None:
            trace_id = self.current_trace_id()
            if trace_id is None and stack:
                trace_id = stack[-1].trace_id
        if parent_span_id is None:
            parent_span_id = (
                stack[-1].span_id if stack
                else getattr(self._tls, "parent_span_id", None)
            )
        sp = Span(self, name, trace_id, parent, attrs or None,
                  parent_span_id=parent_span_id)
        sp._on_stack = True
        stack.append(sp)
        return sp

    def start_span(self, name: str, trace_id: Optional[str] = None,
                   parent_span_id: Optional[str] = None, **attrs) -> Any:
        """Explicit-end span for cross-thread phases: returned handle's
        `end()` may be called from any thread. NOT pushed on the nesting
        stack (the start and end threads' stacks are different objects)."""
        if not self._enabled:
            return _NOOP
        if trace_id is None:
            trace_id = self.current_trace_id()
        if parent_span_id is None:
            parent_span_id = self.current_parent_span_id()
        return Span(self, name, trace_id, None, attrs or None,
                    parent_span_id=parent_span_id)

    def event(self, name: str, trace_id: Optional[str] = None,
              parent_span_id: Optional[str] = None, **attrs) -> None:
        """Zero-duration instant (compile fence, rewind, retire)."""
        if not self._enabled:
            return
        t = threading.current_thread()
        if trace_id is None:
            trace_id = self.current_trace_id()
        if parent_span_id is None:
            parent_span_id = self.current_parent_span_id()
        self._record(
            SpanRecord(
                name, trace_id, None, time.monotonic(), 0.0,
                t.ident or 0, t.name, attrs or None, phase="i",
                span_id=mint_span_id(), parent_span_id=parent_span_id,
            )
        )

    def _pop(self, span: Span) -> None:
        stack = self._stack()
        if stack and stack[-1] is span:
            stack.pop()
        elif span in stack:  # pragma: no cover - misnested exit
            stack.remove(span)

    def _record(self, record: SpanRecord) -> None:
        with self._lock:
            if len(self._buf) == self._capacity:
                self._dropped += 1
            self._buf.append(record)

    # -- tail-based sampling (completed request traces) -------------------

    def finish_trace(self, trace_id: Optional[str], *,
                     error: bool = False,
                     dur_s: Optional[float] = None,
                     **attrs) -> Optional[str]:
        """The tail-sampling decision point, called once per request at
        completion (router: after the attempt loop; model server: after
        the engine futures resolve). Collects the request's spans out of
        the ring (the exact id plus its `<id>/<row>` children) and keeps
        them as a completed trace when the request is WORTH keeping:

        - `error` requests: always ("error"),
        - requests slower than the rolling p99 ("tail"),
        - the rest with probability `sample_prob` ("sampled").

        Returns the keep reason, or None when sampled out. Either way
        the latency feeds the rolling window the p99 reads. No-op (and
        None) on a disabled tracer or a None trace id.

        Decisions are PER-PROCESS (router and replica roll
        independently): at sample_prob < 1 a fleet-merged trace can
        hold only the hop that kept it — error and tail keeps correlate
        across hops (a replica 5xx is the router's error verdict too),
        so failure traces stay complete; only the probabilistic band
        diverges (docs/OBSERVABILITY.md)."""
        if not self._enabled or trace_id is None:
            return None
        with self._sample_lock:
            # the rolling-p99 tail threshold: None until the window
            # holds enough samples for 'slower than p99' to mean
            # something (the first request seen is trivially the max);
            # cached and recomputed every _TAIL_REFRESH finishes — the
            # threshold drifts slowly, and a full-window sort per
            # completed request would be hot-path work
            thr: Optional[float] = None
            if len(self._latencies) >= _TAIL_MIN_SAMPLES:
                if (
                    self._tail_thr is None
                    or self._tail_thr_age >= _TAIL_REFRESH
                ):
                    ordered = sorted(self._latencies)
                    self._tail_thr = ordered[int(0.99 * (len(ordered) - 1))]
                    self._tail_thr_age = 0
                self._tail_thr_age += 1
                thr = self._tail_thr
            reason: Optional[str] = None
            if error:
                reason = "error"
            elif dur_s is not None:
                # STRICTLY greater: a perfectly uniform latency stream
                # must not tail-keep every request (everything ties p99)
                if thr is not None and dur_s > thr:
                    reason = "tail"
            if reason is None and self._sample_rng.random() < self._sample_prob:
                reason = "sampled"
            if dur_s is not None:
                self._latencies.append(float(dur_s))
            if reason is None:
                self._sampled_out += 1
            else:
                self._kept[reason] += 1
        kept_counter, dropped_counter = _sampling_counters()
        if reason is None:
            dropped_counter.inc()
            return None
        kept_counter.inc(reason=reason)
        child_prefix = trace_id + "/"
        spans = [
            r.to_dict() for r in self.snapshot()
            if r.trace_id is not None
            and (r.trace_id == trace_id
                 or r.trace_id.startswith(child_prefix))
        ]
        if dur_s is None and spans:
            dur_s = max(
                s["t_start"] + s["dur_s"] for s in spans
            ) - min(s["t_start"] for s in spans)
        trace = {
            "trace_id": trace_id,
            "keep_reason": reason,
            "error": bool(error),
            "dur_s": dur_s,
            "wall_time": time.time(),
            "spans": spans,
        }
        if attrs:
            trace["attrs"] = dict(attrs)
        with self._sample_lock:
            self._completed.append(trace)
        return reason

    def completed_traces(self) -> List[Dict[str, Any]]:
        """The kept (tail-sampled) request traces, oldest first."""
        with self._sample_lock:
            return list(self._completed)

    # -- metric→trace exemplars -------------------------------------------

    def observe_exemplar(self, series: str, value: float,
                         trace_id: Optional[str]) -> None:
        """Remember (value, trace_id) for a latency series so its worst
        recent offenders stay linkable to traces: the serving path feeds
        TTFT per request, the router its request wall time. Bounded per
        series; no-op when tracing is off or the id is None."""
        if not self._enabled or trace_id is None:
            return
        with self._sample_lock:
            ring = self._exemplars.get(series)
            if ring is None:
                ring = deque(maxlen=_EXEMPLAR_WINDOW)
                self._exemplars[series] = ring
            ring.append((float(value), trace_id, time.time()))

    def exemplars(self, k: int = EXEMPLAR_TOP_K) -> Dict[str, List[Dict[str, Any]]]:
        """Per series, the k worst (largest-value) recent observations as
        {trace_id, value, wall_time}, worst first — the /tracez payload
        the fleet collector merges and attaches to SLO breaches."""
        with self._sample_lock:
            snap = {s: list(ring) for s, ring in self._exemplars.items()}
        return {
            series: [
                {"trace_id": tid, "value": v, "wall_time": t}
                for v, tid, t in sorted(obs, key=lambda o: -o[0])[:k]
            ]
            for series, obs in snap.items()
            if obs
        }

    def tracez(self, include_traces: bool = True) -> Dict[str, Any]:
        """The /tracez document: sampling state, the kept completed
        traces, and the per-series exemplars. `captureUs` is the same
        monotonic export stamp chrome_trace() carries, so the fleet
        collector applies the identical clock-offset estimation when
        merging spans across processes. `include_traces=False` is the
        exemplars-only shape (`/tracez?exemplars_only=1`) the fleet's
        per-SLO worst-offender lookup fetches — a few KB instead of
        every kept trace's full span list."""
        with self._sample_lock:
            sampling = {
                "prob": self._sample_prob,
                "keep": self._sample_keep,
                "kept": dict(self._kept),
                "sampled_out": self._sampled_out,
                "buffered": len(self._completed),
            }
        doc = {
            "captureUs": round(time.monotonic() * 1e6, 3),
            "sampling": sampling,
            "exemplars": self.exemplars(),
        }
        if include_traces:
            doc["traces"] = self.completed_traces()
        return doc

    # -- introspection / export -------------------------------------------

    def snapshot(self) -> List[SpanRecord]:
        with self._lock:
            return list(self._buf)

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self._dropped = 0
        with self._sample_lock:
            self._completed.clear()
            self._latencies.clear()
            self._exemplars.clear()
            self._tail_thr = None
            self._tail_thr_age = 0
            self._kept = {"error": 0, "tail": 0, "sampled": 0}
            self._sampled_out = 0

    def stats(self) -> Dict[str, Any]:
        with self._sample_lock:
            sample_prob = self._sample_prob
            sample_keep = self._sample_keep
            completed = len(self._completed)
        with self._lock:
            return {
                "enabled": self._enabled,
                "capacity": self._capacity,
                "buffered": len(self._buf),
                "dropped": self._dropped,
                "sample_prob": sample_prob,
                "sample_keep": sample_keep,
                "completed_traces": completed,
            }

    def chrome_trace(self) -> Dict[str, Any]:
        """The buffer as Chrome trace-event JSON (Perfetto-loadable).

        One "X" complete event per span (ts/dur in µs on the starting
        thread's track), "i" instants for events, plus thread_name
        metadata events so Perfetto labels each track. Span attrs and the
        trace id land in `args` — Perfetto's query/filter surface.

        The top-level `captureUs` key is this process's monotonic clock
        at export time (same basis as every `ts`). The fleet collector
        (observability/fleet.py) uses it for scrape-time clock-offset
        estimation when stitching several hosts' dumps onto one
        timeline; Perfetto ignores unknown top-level keys.
        """
        records = self.snapshot()
        pid = os.getpid()
        events: List[Dict[str, Any]] = []
        threads: Dict[int, str] = {}
        for r in records:
            threads.setdefault(r.tid, r.thread_name)
            args: Dict[str, Any] = dict(r.attrs) if r.attrs else {}
            if r.trace_id is not None:
                args["trace_id"] = r.trace_id
            if r.parent is not None:
                args["parent"] = r.parent
            ev: Dict[str, Any] = {
                "name": r.name,
                "ph": r.phase,
                "ts": round(r.t_start * 1e6, 3),
                "pid": pid,
                "tid": r.tid,
                "args": args,
            }
            if r.phase == "X":
                ev["dur"] = round(r.dur_s * 1e6, 3)
            else:
                ev["s"] = "t"  # thread-scoped instant
            events.append(ev)
        meta = [
            {
                "name": "thread_name",
                "ph": "M",
                "pid": pid,
                "tid": tid,
                "args": {"name": name},
            }
            for tid, name in sorted(threads.items())
        ]
        return {
            "traceEvents": meta + sorted(events, key=lambda e: e["ts"]),
            "displayTimeUnit": "ms",
            "captureUs": round(time.monotonic() * 1e6, 3),
        }

    def chrome_trace_json(self) -> str:
        return json.dumps(self.chrome_trace())


class _TraceContext:
    __slots__ = (
        "_tracer", "_trace_id", "_parent", "_prev", "_prev_parent",
    )

    def __init__(self, tracer: Tracer, trace_id: Optional[str],
                 parent_span_id: Optional[str] = None):
        self._tracer = tracer
        self._trace_id = trace_id
        self._parent = parent_span_id

    def __enter__(self):
        # prev state read and restored on the SAME thread (enter/exit of
        # a with-block cannot migrate threads), so nesting restores
        # correctly and nothing leaks to a reused handler thread
        self._prev = self._tracer.current_trace_id()
        self._prev_parent = getattr(
            self._tracer._tls, "parent_span_id", None
        )
        self._tracer.set_trace_context(self._trace_id, self._parent)
        return self._trace_id

    def __exit__(self, *exc) -> bool:
        self._tracer.set_trace_context(self._prev, self._prev_parent)
        return False


_default_tracer = Tracer()


def default_tracer() -> Tracer:
    """The process-wide tracer every instrumented subsystem records into
    (one buffer = one /debug/trace dump covering serving AND training)."""
    return _default_tracer


def _sampling_counters():
    """The tail-sampling fleet counters (utils/metrics.py declarations;
    AGGREGATION_POLICY-covered). Resolved lazily so importing trace.py
    never registers metrics as a side effect."""
    from kubeflow_tpu_torch.utils.metrics import (
        trace_kept_counter,
        trace_sampled_out_counter,
    )

    return trace_kept_counter(), trace_sampled_out_counter()


def knobs_from_env(environ=None) -> Dict[str, Any]:
    """The observability contract the controllers render
    (ObservabilityConfig → KFT_TRACE_* env): trace_enabled
    (KFT_TRACE_ENABLED, "0" disables), trace_buffer_spans
    (KFT_TRACE_BUFFER_SPANS), statusz_enabled (KFT_TRACE_STATUSZ,
    "0" disables the /statusz + /debug/trace routes), trace_sample_prob
    (KFT_TRACE_SAMPLE_PROB, the tail-sampling keep probability for
    unremarkable traces) and trace_sample_keep (KFT_TRACE_SAMPLE_KEEP,
    the completed-traces ring capacity /tracez serves)."""
    env = os.environ if environ is None else environ

    def _flag(name: str, default: bool) -> bool:
        raw = env.get(name, "").strip()
        if not raw:
            return default
        return raw not in ("0", "false", "False", "off")

    raw_cap = env.get(ENV_TRACE_BUFFER_SPANS, "").strip()
    capacity = int(raw_cap) if raw_cap else DEFAULT_BUFFER_SPANS
    raw_prob = env.get(ENV_TRACE_SAMPLE_PROB, "").strip()
    raw_keep = env.get(ENV_TRACE_SAMPLE_KEEP, "").strip()
    return {
        "trace_enabled": _flag(ENV_TRACE_ENABLED, True),
        "trace_buffer_spans": capacity,
        "statusz_enabled": _flag(ENV_TRACE_STATUSZ, True),
        "trace_sample_prob": (
            float(raw_prob) if raw_prob else DEFAULT_SAMPLE_PROB
        ),
        "trace_sample_keep": (
            int(raw_keep) if raw_keep else DEFAULT_SAMPLE_KEEP
        ),
    }


def configure_from_env(environ=None) -> Dict[str, Any]:
    """Entrypoint hook (serving/main.py, runtime/train_run.py): apply the
    rendered env to the default tracer; returns the parsed knobs so the
    caller can also gate its /statusz routes."""
    knobs = knobs_from_env(environ)
    _default_tracer.configure(
        enabled=knobs["trace_enabled"],
        capacity=knobs["trace_buffer_spans"],
        sample_prob=knobs["trace_sample_prob"],
        sample_keep=knobs["trace_sample_keep"],
    )
    return knobs


def iter_trace(records: Iterable[SpanRecord],
               trace_id: str) -> List[SpanRecord]:
    """Filter one request's spans out of the interleaved buffer."""
    return [r for r in records if r.trace_id == trace_id]
