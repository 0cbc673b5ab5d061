"""kft-router: the prefix-affinity front door over a serving fleet (port
of kubeflow_tpu/routing/router.py).

The radix prefix cache lives in one process, so N replicas behind a
plain Service are N cold caches. The router is a WSGI app that

- keeps a **replica registry**: static, or discovered from the cluster
  store's `inferenceservice`-labelled pods, with the InferenceService
  controller re-rendering it on every scale event;
- tracks **health and drains**: a replica answering 429 + Retry-After
  (the draining-shutdown contract) or failing its /healthz probe is
  demoted, and re-admitted when it recovers;
- admits with **prefix affinity**: the prompt's first page-aligned
  chunk hashes (over the wire-level ids, no tokenizer) to a rendezvous
  (HRW) ranking of the live replicas, so requests sharing a radix
  prefix land where its pages already are;
- **spills** by load: when the home's queue depth per slot (the fleet
  collector's signals when wired, else the router's own in-flight count)
  exceeds `spill_queue_per_slot`, the request takes the second choice;
- **retries**, bounded: a 429 (the drainer stays demoted for its
  Retry-After), a connect failure or a 5xx moves to the next choice, at
  most `retry_budget` extra attempts, then a clean 503;
- **steers** a disaggregated fleet: a cold prefix goes through the
  prefill tier, which ships its pages to the decode home, and a
  draining decode replica is asked once to hand its hottest chains to
  the survivors.

Pure host code: it imports no torch, so the router pod starts fast.
Every routed request records a `request.route` span and the `router_*`
series (utils/metrics.py), which the fleet collector aggregates.
"""

from __future__ import annotations

import dataclasses
import json
import math
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from kubeflow_tpu_torch.api.wsgi import App, BadRequest, HttpError, Response
from kubeflow_tpu_torch.observability.trace import (
    TRACEPARENT_HEADER,
    default_tracer,
    format_traceparent,
    mint_trace_id,
    parse_traceparent,
)
from kubeflow_tpu_torch.routing.affinity import first_page_key, rendezvous_rank
from kubeflow_tpu_torch.utils.audit_lock import audit_lock
from kubeflow_tpu_torch.utils.logging import get_logger
from kubeflow_tpu_torch.utils.metrics import (
    default_registry,
    router_affinity_hits_counter,
    router_first_page_keys_gauge,
    router_request_seconds_histogram,
    router_requests_counter,
    router_retries_counter,
    router_spills_counter,
    router_tier_steer_counter,
    router_trace_minted_counter,
)

log = get_logger(__name__)

# the serving path's default KV page size (the JAX package's
# analysis/serving_plans.py DEFAULT_PAGE_SIZE, kept here so the router
# needs nothing of the engine)
DEFAULT_PAGE_SIZE = 16

# Router knob defaults — ONE definition point shared by RouterConfig
# (config/platform.py documents the same numbers), the controller's env
# render and the entrypoint's env parse (routing/__main__.py).
DEFAULT_SPILL_QUEUE_PER_SLOT = 2.0
DEFAULT_RETRY_BUDGET = 2
DEFAULT_PROBE_INTERVAL_S = 5.0
# Retry-After ceiling: a replica can ask for a long backoff but never an
# unbounded one — 'Retry-After: inf' (or a far-future HTTP-date) from a
# buggy replica must not demote it until process restart
RETRY_AFTER_CAP_S = 3600.0
# upstream request bound: a hung replica must surface as the router's
# 503/retry path, not a stuck client socket (mirrors the model server's
# ENGINE_WAIT_S generosity)
UPSTREAM_TIMEOUT_S = 600.0

# Disaggregated-fleet knob defaults (serving.disagg in config/
# platform.py documents the same numbers; docs/SERVING.md
# "Disaggregated fleet"): a decode home whose prefix-cache hit rate
# sits under cold_hit_rate treats arrivals as cold (steer through the
# prefill tier); handoff_chains bounds what one drain window ships.
DEFAULT_COLD_HIT_RATE = 0.2
DEFAULT_HANDOFF_CHAINS = 64
# cold/warm memory: first-page keys the router has steered through the
# prefill tier — capped like the engine's first-page cardinality so
# all-unique traffic saturates the verdict instead of leaking host
# memory (past the cap every new key still steers cold, which is the
# honest verdict for a key space that large)
_SEEN_KEYS_CAP = 65536

# the serving-replica pod label (controllers/inference.py deployment
# labels); duplicated as a string so this module never imports the
# controller layer — the same pairing fleet.py documents for discovery
_SERVING_LABEL = "inferenceservice"
# the tier label the controller stamps on disaggregated pods
# (prefill|decode; absent = unified)
_TIER_LABEL = "inferenceservice-tier"
_SERVE_PORT = 8500

# response headers the router passes through from the replica (the
# engine's TTFT attribution, the echoed request id, a drain's
# Retry-After) — everything else is hop-local
_PASSTHROUGH_HEADERS = (
    ("x-ttft-ms", "X-TTFT-Ms"),
    ("x-request-id", "X-Request-Id"),
    ("retry-after", "Retry-After"),
)


@dataclasses.dataclass(frozen=True)
class Replica:
    """One serving replica the router can admit to."""

    id: str         # stable identity (pod name / bench label) — the HRW key
    base_url: str   # e.g. http://pod-0:8500 (no trailing slash)
    # disaggregated tier: "prefill" (cold-prefix chunked prefill + page
    # handoff), "decode" (steady-state decode, the rendezvous homes), or
    # "unified" (both — every pre-disagg fleet). The controller stamps
    # the role from serving.disagg; discovery reads the tier pod label.
    role: str = "unified"


@dataclasses.dataclass
class _ReplicaState:
    """Per-replica health bookkeeping (guarded by the router lock)."""

    healthy: bool = True
    draining: bool = False     # informational (healthz/statusz rendering)
    demoted_until: float = 0.0  # monotonic deadline of a 429/drain demotion
    fails: int = 0
    last_error: str = ""

    def available(self, now: float) -> bool:
        return self.healthy and now >= self.demoted_until


def discover_replicas(
    store, namespace: str, name: str, port: int = _SERVE_PORT
) -> List[Replica]:
    """Replica registry from the cluster store's pod objects: every pod
    labeled `inferenceservice: <name>` in `namespace` is a routable
    replica (the exact label scheme FleetCollector.discover_targets
    scrapes by). Addressing is the shared `pod_host` preference order
    (cluster/objects.py), the same one the collector dials — so the
    router's registry ids and the fleet's instance ids stay pairable."""
    from kubeflow_tpu_torch.cluster.objects import pod_host

    out: List[Replica] = []
    for pod in store.list("Pod"):
        meta = pod.get("metadata", {})
        labels = meta.get("labels", {}) or {}
        if labels.get(_SERVING_LABEL) != name:
            continue
        if meta.get("namespace", "default") != namespace:
            continue
        host = pod_host(pod)
        tier = labels.get(_TIER_LABEL, "") or "unified"
        out.append(
            Replica(
                id=meta.get("name", host),
                base_url=f"http://{host}:{port}",
                role=tier if tier in ("prefill", "decode") else "unified",
            )
        )
    return sorted(out, key=lambda r: r.id)


def fleet_signals_source(
    collector, namespace: str, name: str
) -> Callable[[str], Optional[Dict[str, float]]]:
    """Adapt a FleetCollector into the router's spill-signal shape: a
    callable mapping a replica id (the pod's KFT_FLEET_INSTANCE) to its
    last-scraped {queue_depth, num_slots} row
    (observability/fleet.py replica_serving_signals)."""

    def signals(replica_id: str) -> Optional[Dict[str, float]]:
        # instance-narrowed: one replica's row per routed request, not
        # a full-fleet collapse discarded after one .get()
        return collector.replica_serving_signals(
            namespace, name, instance=replica_id
        ).get(replica_id)

    return signals


# Transport: (method, url, body-bytes-or-None, headers) ->
# (status, body bytes, lowercase header dict). Injectable so unit tests
# route against in-process fakes and the bench/e2e use real sockets.
Transport = Callable[
    [str, str, Optional[bytes], Dict[str, str]],
    Tuple[int, bytes, Dict[str, str]],
]


def default_transport(
    method: str,
    url: str,
    body: Optional[bytes],
    headers: Dict[str, str],
    timeout_s: float = UPSTREAM_TIMEOUT_S,
) -> Tuple[int, bytes, Dict[str, str]]:
    """urllib transport: HTTP error statuses return as statuses (the
    router's routing verdicts need the 429/5xx, not an exception);
    connection-level failures raise (the caller demotes the replica)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        url, data=body, headers=dict(headers), method=method
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout_s) as resp:
            return (
                resp.status,
                resp.read(),
                {k.lower(): v for k, v in resp.headers.items()},
            )
    except urllib.error.HTTPError as e:
        data = e.read()
        return e.code, data, {k.lower(): v for k, v in e.headers.items()}


def _parse_retry_after(headers: Dict[str, str], default_s: float = 1.0) -> float:
    """Seconds to back a replica off, from its Retry-After header.

    RFC 9110 allows BOTH forms: delta-seconds ("3") and an HTTP-date
    ("Wed, 21 Oct 2015 07:28:00 GMT" — also the obsolete RFC 850 and
    asctime shapes, which parsedate handles). Anything else — garbage,
    a negative delta, non-finite values ('inf'/'nan', which float()
    happily parses), a date already in the past — clamps to the
    DEFAULT, never to a zero-length window (a demotion the drain
    contract asked for must not evaporate on a malformed header);
    finite-but-huge values cap at RETRY_AFTER_CAP_S — never an
    unbounded demotion."""
    raw = (headers or {}).get("retry-after", "").strip()
    if not raw:
        return default_s
    try:
        delta = float(raw)
    except ValueError:
        from email.utils import parsedate_to_datetime

        try:
            when = parsedate_to_datetime(raw)
        except (TypeError, ValueError):
            return default_s
        if when is None:
            return default_s
        import datetime

        if when.tzinfo is None:
            when = when.replace(tzinfo=datetime.timezone.utc)
        delta = (
            when - datetime.datetime.now(datetime.timezone.utc)
        ).total_seconds()
    if not math.isfinite(delta) or delta <= 0.0:
        return default_s
    return min(delta, RETRY_AFTER_CAP_S)


class FleetRouter:
    """The prefix-affinity front door: one WSGI app (`self.app`) fronting
    N model-server replicas with the same REST surface clients already
    speak — `:generate` rides affinity + spill + bounded retry; the other
    `/v1/*` endpoints proxy to any live replica.

    Thread model: handler threads and the probe loop share the replica
    registry/state under `_lock`; upstream I/O always happens OUTSIDE the
    lock. The injectable `transport`/`signals`/`clock` keep every routing
    decision unit-testable without sockets."""

    def __init__(
        self,
        replicas: Tuple[Replica, ...] = (),
        *,
        affinity: bool = True,
        page_size: int = DEFAULT_PAGE_SIZE,
        spill_queue_per_slot: float = DEFAULT_SPILL_QUEUE_PER_SLOT,
        retry_budget: int = DEFAULT_RETRY_BUDGET,
        signals: Optional[Callable[[str], Optional[Dict[str, float]]]] = None,
        replica_slots: int = 0,
        transport: Optional[Transport] = None,
        probe_interval_s: float = DEFAULT_PROBE_INTERVAL_S,
        clock: Callable[[], float] = time.monotonic,
        statusz_enabled: bool = True,
        disagg: bool = False,
        cold_hit_rate: float = DEFAULT_COLD_HIT_RATE,
        handoff_chains: int = DEFAULT_HANDOFF_CHAINS,
    ) -> None:
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        if spill_queue_per_slot < 0:
            raise ValueError("spill_queue_per_slot must be >= 0")
        if retry_budget < 0:
            raise ValueError("retry_budget must be >= 0")
        if probe_interval_s <= 0:
            raise ValueError("probe_interval_s must be > 0")
        if not 0.0 <= cold_hit_rate <= 1.0:
            raise ValueError("cold_hit_rate must be in [0, 1]")
        if handoff_chains < 1:
            raise ValueError("handoff_chains must be >= 1")
        self.affinity = bool(affinity)
        # disaggregated steering (docs/SERVING.md "Disaggregated
        # fleet"): cold-prefix :generate requests take a prefill-tier
        # hop that ships the committed pages to the decode home; a
        # draining decode replica gets a warm-handoff request
        self.disagg = bool(disagg)
        self.cold_hit_rate = float(cold_hit_rate)
        self.handoff_chains = int(handoff_chains)
        self.page_size = int(page_size)
        self.spill_queue_per_slot = float(spill_queue_per_slot)
        self.retry_budget = int(retry_budget)
        self.probe_interval_s = float(probe_interval_s)
        self._signals = signals
        # spill denominator when no collector is wired (the standalone
        # pod): the replicas' slot capacity, rendered by the controller
        # as KFT_ROUTER_REPLICA_SLOTS from the one ServingConfig.
        # 0 = unknown (in-flight compares against slots=1).
        self.replica_slots = int(replica_slots)
        self._transport: Transport = transport or default_transport
        # probes get their OWN short-deadline transport: a wedged replica
        # must cost one probe-interval, not UPSTREAM_TIMEOUT_S, or the
        # whole health loop freezes behind it. An injected transport is
        # used as-is (tests own their timing).
        if transport is not None:
            self._probe_transport: Transport = transport
        else:
            self._probe_transport = (
                lambda method, url, body, headers: default_transport(
                    method, url, body, headers,
                    timeout_s=max(1.0, float(probe_interval_s)),
                )
            )
        self._clock = clock
        self._lock = audit_lock("FleetRouter._lock")
        self._replicas: Dict[str, Replica] = {}
        self._states: Dict[str, _ReplicaState] = {}
        self._inflight: Dict[str, int] = {}
        # drain() flips this: new proxied requests answer 429 +
        # Retry-After (the caller retries another router / the VIP)
        # while in-flight ones finish — without the gate a sustained
        # client stream would keep the in-flight count nonzero and
        # drain could never converge. _proxying counts requests from
        # the moment they pass the gate to _forward's return (the
        # engine's _admitting pattern): per-replica _inflight only
        # covers the transport call, and the gaps around it — ordering,
        # between retry attempts — must not be invisible to drain()
        self._draining = False
        self._proxying = 0
        for r in replicas:
            self._replicas[r.id] = r
            self._states[r.id] = _ReplicaState()
        self._rr = 0  # round-robin cursor for the no-affinity spray path
        # disagg state (all under _lock): keys already steered through
        # the prefill tier (warm thereafter), per-(tier, reason) steer
        # counts for /statusz, drainers whose warm handoff already
        # fired this window, and the last handoff verdict
        self._seen_keys: set = set()
        self._steer_counts: Dict[Tuple[str, str], int] = {}
        self._handoff_fired: set = set()
        self._handoff_last: Dict[str, Any] = {}
        self._tracer = default_tracer()
        self._requests = router_requests_counter()
        self._affinity_hits = router_affinity_hits_counter()
        self._spills = router_spills_counter()
        self._retries = router_retries_counter()
        self._request_seconds = router_request_seconds_histogram()
        self._trace_minted = router_trace_minted_counter()
        self._tier_steer = router_tier_steer_counter()
        self._first_page_keys_g = router_first_page_keys_gauge()
        self._first_page_keys_g.set(0)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.app = self._build()
        if statusz_enabled:
            from kubeflow_tpu_torch.observability.http import add_debug_routes

            add_debug_routes(
                self.app,
                statusz_sections=[("router", self._statusz_lines)],
                role="router",
            )

            # the port's add_debug_routes leaves /metrics to its caller:
            # the fleet collector scrapes the router's series here
            @self.app.get("/metrics")
            def metrics_text(req):
                return Response(
                    default_registry().render(), "text/plain; charset=utf-8"
                )

    # -- replica registry --------------------------------------------------

    def set_replicas(self, replicas) -> None:
        """Replace the registry (a scale event); surviving ids keep their
        health state so a re-render cannot resurrect a demoted replica."""
        with self._lock:
            keep = {r.id: r for r in replicas}
            self._replicas = keep
            self._states = {
                rid: self._states.get(rid, _ReplicaState()) for rid in keep
            }
            self._inflight = {
                rid: self._inflight.get(rid, 0) for rid in keep
            }

    def add_replica(self, replica: Replica) -> None:
        with self._lock:
            self._replicas[replica.id] = replica
            self._states.setdefault(replica.id, _ReplicaState())

    def remove_replica(self, replica_id: str) -> None:
        with self._lock:
            self._replicas.pop(replica_id, None)
            self._states.pop(replica_id, None)
            self._inflight.pop(replica_id, None)

    def replica_states(self) -> Dict[str, Dict[str, Any]]:
        """Snapshot for healthz/statusz/tests."""
        with self._lock:
            now = self._clock()
            return {
                rid: {
                    "base_url": self._replicas[rid].base_url,
                    "role": self._replicas[rid].role,
                    "healthy": st.healthy,
                    "draining": st.draining,
                    "demoted": not st.available(now),
                    "fails": st.fails,
                    "last_error": st.last_error,
                }
                for rid, st in self._states.items()
            }

    # -- health bookkeeping ------------------------------------------------

    def _note_ok(self, rid: str, clear_demotion: bool = True) -> None:
        """Replica answered conclusively. `clear_demotion=False` is the
        traffic path: it heals failure demotions (healthy again) but
        must NOT cut short a live 429/Retry-After drain window — a 200
        on some non-gated endpoint doesn't prove the drain ended, and
        the advertised window is a promise to the drainer. The probe
        path (an authoritative non-draining healthz) fully resets."""
        with self._lock:
            st = self._states.get(rid)
            if st is None:
                return
            st.healthy = True
            st.fails = 0
            st.last_error = ""
            if clear_demotion or self._clock() >= st.demoted_until:
                st.draining = False
                st.demoted_until = 0.0
                # drain over: a future drain of this replica gets a
                # fresh warm-handoff window
                self._handoff_fired.discard(rid)

    def _note_failure(self, rid: str, err: str) -> None:
        with self._lock:
            st = self._states.get(rid)
            if st is None:
                return
            st.healthy = False
            st.fails += 1
            st.last_error = err

    def _note_draining(
        self, rid: str, retry_after_s: float, draining: bool = True
    ) -> None:
        """A 429 (or a draining healthz): demote for the advertised (or
        default) window — honoring Retry-After means the fleet stops
        OFFERING traffic to the drainer, not just this one request.
        `draining=False` is the queue-full 429 (no Retry-After header):
        the replica is merely BUSY — it backs off the same way but must
        not show as a phantom drain on healthz/statusz.

        Disagg warm handoff (docs/SERVING.md): the first REAL drain
        signal for a decode/unified replica fires one background
        POST /v1/kv/handoff at the drainer — its hottest committed
        chains ship to each key's NEW rendezvous home among the
        surviving decode tier, so post-scale-down traffic re-admits
        as prefix hits instead of re-prefilling. Once per drain
        window: a recovered replica (probe ok) re-arms."""
        peers: Dict[str, str] = {}
        fire = False
        with self._lock:
            st = self._states.get(rid)
            if st is None:
                return
            st.draining = draining
            st.demoted_until = max(
                st.demoted_until, self._clock() + max(0.0, retry_after_s)
            )
            drainer = self._replicas.get(rid)
            if (
                draining
                and self.disagg
                and drainer is not None
                and drainer.role in ("decode", "unified")
                and rid not in self._handoff_fired
            ):
                peers = {
                    r.id: r.base_url
                    for r in self._replicas.values()
                    if r.id != rid and r.role in ("decode", "unified")
                }
                if peers:
                    fire = True
                    self._handoff_fired.add(rid)
        if fire:
            # daemon + fire-and-forget: the handoff rides the drainer's
            # own grace window; a router shutdown mid-handoff only costs
            # warmth, never correctness.
            threading.Thread(
                target=self._request_handoff,
                args=(rid, peers),
                daemon=True,
                name=f"kv-handoff-{rid}",
            ).start()

    def _request_handoff(self, rid: str, peers: Dict[str, str]) -> None:
        """Ask draining replica `rid` to ship its hottest committed
        chains to `peers` (its surviving decode-tier siblings), each
        chain to its first-page key's rendezvous home. Best-effort: the
        drain window is a race against the socket dying, and a lost
        handoff only costs cache warmth."""
        with self._lock:
            rep = self._replicas.get(rid)
        if rep is None:
            return
        payload = json.dumps(
            {"peers": peers, "chains": self.handoff_chains}
        ).encode()
        try:
            status, data, _ = self._transport(
                "POST",
                rep.base_url + "/v1/kv/handoff",
                payload,
                {"Content-Type": "application/json"},
            )
            doc = json.loads(data) if data else {}
        except Exception as e:  # noqa: BLE001 - handoff is best-effort
            log.warning("warm handoff from %s failed: %s", rid, e)
            with self._lock:
                self._handoff_last = {
                    "from": rid, "error": str(e), "at": self._clock(),
                }
            return
        verdicts = doc.get("peers", {}) if isinstance(doc, dict) else {}
        pages = sum(int(v.get("pages", 0)) for v in verdicts.values())
        admitted = sum(int(v.get("admitted", 0)) for v in verdicts.values())
        log.info(
            "warm handoff from %s: %d page(s) shipped, %d admitted "
            "across %d peer(s) (status %d)",
            rid, pages, admitted, len(verdicts), status,
        )
        with self._lock:
            self._handoff_last = {
                "from": rid,
                "status": status,
                "pages": pages,
                "admitted": admitted,
                "peers": len(verdicts),
                "at": self._clock(),
            }

    # -- probing -----------------------------------------------------------

    def probe_once(self) -> None:
        """One health sweep: GET each replica's /healthz — CONCURRENTLY
        and on the short probe-deadline transport, so one wedged replica
        costs one probe interval, never the upstream request timeout or
        the other replicas' verdicts. `draining` in the body (or a
        non-ok verdict) demotes; a clean ok re-admits — the probe is how
        a drained-then-restarted replica returns to rotation without
        waiting for traffic to rediscover it."""
        from concurrent.futures import ThreadPoolExecutor

        with self._lock:
            targets = list(self._replicas.values())
        if not targets:
            return

        def _grab(rep: Replica):
            try:
                status, data, _ = self._probe_transport(
                    "GET", rep.base_url + "/healthz", None, {}
                )
                return status, (json.loads(data) if data else {}), ""
            except Exception as e:  # noqa: BLE001 - probes are best-effort
                return None, None, f"{type(e).__name__}: {e}"

        with ThreadPoolExecutor(max_workers=min(8, len(targets))) as pool:
            results = list(pool.map(_grab, targets))
        for rep, (status, doc, err) in zip(targets, results):
            if status is None:
                self._note_failure(rep.id, err)
            elif doc.get("draining"):
                self._note_draining(rep.id, self.probe_interval_s)
            elif status < 500 and doc.get("ok"):
                self._note_ok(rep.id)
            else:
                self._note_failure(rep.id, f"healthz {status}")

    def start(self) -> None:
        """Run the probe loop on a daemon thread until stop().
        Restartable: a start() after stop() probes again."""
        # check-then-act under the lock: two racing start() calls must not
        # both observe _thread is None and spawn duplicate probe loops
        with self._lock:
            if self._thread is not None:
                return
            self._stop.clear()
            t = threading.Thread(
                target=self._run, daemon=True, name="router-probe"
            )
            self._thread = t
        t.start()

    def stop(self) -> None:
        self._stop.set()
        with self._lock:
            t = self._thread
            self._thread = None
        if t is not None:
            t.join(timeout=5)

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.probe_once()
            except Exception:  # noqa: BLE001 - the loop must survive
                log.exception("router probe sweep failed")
            self._stop.wait(self.probe_interval_s)

    def drain(self, deadline_s: float = 30.0) -> bool:
        """Shutdown grace: flip the admission gate (new proxied requests
        get 429 + Retry-After; /healthz reports draining so readiness
        pulls this router from its endpoints), then wait (bounded) for
        every in-flight proxied request to complete before the caller
        stops the HTTP server — the router-side mirror of the replicas'
        drain contract. The wsgi Server's handler threads are daemon, so
        stopping it mid-proxy would kill exactly the requests the
        fleet's drain machinery protects. Returns True when the router
        went idle in time."""
        with self._lock:
            self._draining = True
        deadline = self._clock() + max(0.0, float(deadline_s))
        while True:
            with self._lock:
                busy = self._proxying
            if busy == 0:
                return True
            if self._clock() >= deadline:
                log.warning(
                    "router drain deadline (%.1fs) expired with %d "
                    "request(s) still in flight", deadline_s, busy,
                )
                return False
            time.sleep(0.05)

    # -- selection ---------------------------------------------------------

    def _affinity_row(self, body: Dict[str, Any]) -> Optional[list]:
        """The request's first prompt row, or None when the body has no
        usable prompt (the replica's own validation will 400 it)."""
        prompt = body.get("prompt_ids")
        row = None
        if isinstance(prompt, list) and prompt:
            if isinstance(prompt[0], list):
                row = prompt[0]
            elif all(isinstance(t, int) for t in prompt):
                row = prompt  # tolerate a flat row
        return row or None

    def _affinity_key(self, body: Dict[str, Any]) -> Optional[str]:
        """The first row's first-page key, or None when the body has no
        usable prompt (the replica's own validation will 400 it)."""
        row = self._affinity_row(body)
        if not row:
            return None
        try:
            return first_page_key(row, self.page_size)
        except (TypeError, ValueError):
            return None

    def _order_for(
        self, key: Optional[str], pool: Optional[List[str]] = None
    ) -> Tuple[List[Replica], bool]:
        """Candidate replicas in attempt order plus the spill verdict.
        Affinity keys rank by HRW (first = the prefix's home); keyless
        requests spray round-robin. `pool` restricts candidates to the
        named replica ids (the disagg decode tier) — an empty
        intersection falls back to the whole registry, because serving
        somewhere beats 503ing over tier bookkeeping. When every
        replica is demoted the full registry is offered anyway — a
        stale demotion must degrade to a retry, not a hard 503 while
        the fleet is actually fine."""
        with self._lock:
            now = self._clock()
            live = [
                self._replicas[rid]
                for rid in self._replicas
                if self._states[rid].available(now)
            ]
            if not live:
                live = list(self._replicas.values())
            if pool is not None:
                pooled = [r for r in live if r.id in pool]
                if pooled:
                    live = pooled
            if key is None and live:
                start = self._rr % len(live)
                self._rr += 1
                return live[start:] + live[:start], False
        if not live:
            return [], False
        by_id = {r.id: r for r in live}
        order = [
            by_id[rid] for rid in rendezvous_rank(key, list(by_id))
        ]
        spilled = False
        if len(order) > 1:
            sig = (
                self._signals(order[0].id)
                if self._signals is not None
                else self._inflight_signals(order[0].id)
            )
            if sig:
                slots = max(1.0, float(sig.get("num_slots") or 0.0))
                depth = float(sig.get("queue_depth") or 0.0)
                # strictly greater: an IDLE home must never spill, even
                # at threshold 0 (">=" would divert 100% of traffic the
                # moment an operator sets the knob to zero)
                if depth / slots > self.spill_queue_per_slot:
                    order[0], order[1] = order[1], order[0]
                    spilled = True
                    self._spills.inc()
        return order, spilled

    def _inflight_signals(self, rid: str) -> Dict[str, float]:
        """The spill signal when no fleet collector is wired (the
        standalone router pod): this router's own outstanding requests
        against the replica — an exact queue-depth proxy for a
        single-router fleet — over the controller-rendered slot
        capacity (KFT_ROUTER_REPLICA_SLOTS; 0 = compare per single
        slot)."""
        with self._lock:
            depth = float(self._inflight.get(rid, 0))
        return {
            "queue_depth": depth,
            "num_slots": float(self.replica_slots) or 1.0,
        }

    # -- disaggregated steering (docs/SERVING.md "Disaggregated fleet") ----

    def _count_steer(self, tier: str, reason: str) -> None:
        self._tier_steer.inc(tier=tier, reason=reason)
        with self._lock:
            self._steer_counts[(tier, reason)] = (
                self._steer_counts.get((tier, reason), 0) + 1
            )

    def _steer(
        self, name: str, key: str, body: Dict[str, Any]
    ) -> Optional[List[str]]:
        """The disagg steering verdict for one :generate request.

        Returns the decode-tier replica-id pool to pin the forward to
        (None = unified path, no restriction). COLD keys — never
        steered before, or whose decode home reports a prefix-cache hit
        rate under `cold_hit_rate` — take a synchronous prefill-tier
        hop first: the prefill replica runs chunked prefill to page
        completion and ships the committed pages to the decode home's
        /v1/kv/pages, so the forwarded request admits there as a prefix
        hit (bitwise the unified output — prefill is deterministic and
        the pages move bit-for-bit). Any tier gap or prefill failure
        falls back to the unified path with the tier-down counter —
        steering is an optimization, never an availability dependency.
        """
        with self._lock:
            now = self._clock()
            prefill = [
                r for r in self._replicas.values()
                if r.role == "prefill"
                and self._states[r.id].available(now)
            ]
            decode = [
                r for r in self._replicas.values()
                if r.role in ("decode", "unified")
                and self._states[r.id].available(now)
            ]
            seen = key in self._seen_keys
        if not prefill or not decode:
            self._count_steer("unified", "tier-down")
            return None
        pool = [r.id for r in decode]
        home = next(
            r for r in decode
            if r.id == rendezvous_rank(key, pool)[0]
        )
        cold = not seen
        if not cold and self._signals is not None:
            sig = self._signals(home.id) or {}
            rate = sig.get("prefix_hit_rate")
            if rate is not None and float(rate) < self.cold_hit_rate:
                cold = True
        if not cold:
            self._count_steer("decode", "page-complete")
            return pool
        pf = next(
            r for r in prefill
            if r.id == rendezvous_rank(key, [p.id for p in prefill])[0]
        )
        row = self._affinity_row(body)
        payload = json.dumps(
            {
                "prompt_ids": row,
                "handoff_url": home.base_url + "/v1/kv/pages",
            }
        ).encode()
        self._tracer.event(
            "router.steer", tier="prefill", replica=pf.id, home=home.id
        )
        try:
            status, _, hdrs = self._transport(
                "POST",
                pf.base_url + f"/v1/models/{name}:prefill",
                payload,
                {"Content-Type": "application/json"},
            )
        except Exception as e:  # noqa: BLE001 - fall back to unified
            self._note_failure(pf.id, f"prefill hop: {type(e).__name__}: {e}")
            self._count_steer("unified", "tier-down")
            return None
        if status == 429:
            self._note_draining(
                pf.id, _parse_retry_after(hdrs),
                draining="retry-after" in hdrs,
            )
            self._count_steer("unified", "tier-down")
            return None
        if status >= 500:
            self._note_failure(pf.id, f"prefill hop: upstream {status}")
            self._count_steer("unified", "tier-down")
            return None
        if status >= 400:
            # the replica's own 4xx verdict: the forwarded request will
            # get the same one — don't mask it behind a steering retry
            self._count_steer("unified", "tier-down")
            return None
        self._note_ok(pf.id, clear_demotion=False)
        self._count_steer("prefill", "cold")
        with self._lock:
            if len(self._seen_keys) < _SEEN_KEYS_CAP:
                self._seen_keys.add(key)
            keys = len(self._seen_keys)
        self._first_page_keys_g.set(keys)
        return pool

    # -- the routed request ------------------------------------------------

    def _forward(
        self,
        req,
        method: str,
        path: str,
        key: Optional[str],
        pool: Optional[List[str]] = None,
    ) -> Tuple[Any, int]:
        """The attempt loop shared by every proxied route: walk the
        candidate order, demoting on 429/connect-failure/5xx and
        retrying within `retry_budget`; pass the first conclusive
        replica verdict (including its 4xx) through unchanged. The
        drain gate and the _proxying increment are ATOMIC (one lock
        hold): a request either sees the gate or is counted — drain()
        can never declare idle while an admitted request is between
        attempts."""
        with self._lock:
            draining = self._draining
            if not draining:
                self._proxying += 1
        if draining:
            # shutdown gate: stop ADMITTING so drain() converges; the
            # client's retry lands on another router / the Service VIP
            self._requests.inc(outcome="rejected")
            req.response_headers.append(("Retry-After", "1"))
            raise HttpError(429, "router is draining for shutdown")
        try:
            return self._forward_traced(req, method, path, key, pool)
        finally:
            with self._lock:
                self._proxying -= 1

    def _forward_traced(
        self,
        req,
        method: str,
        path: str,
        key: Optional[str],
        pool: Optional[List[str]] = None,
    ) -> Tuple[Any, int]:
        """Distributed-tracing envelope around the attempt loop: continue
        a client-sent W3C `traceparent` (or mint one), run the loop under
        that thread-local trace context so every router span — and, via
        the forwarded header, every replica span — carries ONE trace id,
        then feed the outcome to the tail sampler (`finish_trace`: 5xx/
        exhaustion outcomes are error-kept) and the latency series +
        worst-offender exemplars. With tracing disabled the entire
        envelope is the latency observation plus one bool check."""
        tracer = self._tracer
        trace_id: Optional[str] = None
        parent_span_id: Optional[str] = None
        if tracer.enabled:
            inbound = parse_traceparent(
                req.headers.get(TRACEPARENT_HEADER)
            )
            if inbound is not None:
                trace_id, parent_span_id = inbound
            else:
                trace_id = mint_trace_id()
                self._trace_minted.inc()
            # the id clients (and operators) query /tracez and
            # /debug/trace with — echoed whether minted or continued
            req.response_headers.append(("X-Trace-Id", trace_id))
        t0 = time.monotonic()
        error = False
        try:
            with tracer.trace_context(trace_id, parent_span_id):
                with tracer.span(
                    "router.request",
                    path=path,
                    affinity=key is not None,
                ):
                    return self._forward_admitted(
                        req, method, path, key, trace_id, pool
                    )
        except HttpError as e:
            # a replica's own 4xx verdict is the CLIENT's problem; 5xx
            # and retry-budget exhaustion are fleet failures worth a
            # kept error trace
            error = e.status >= 500
            raise
        except Exception:
            error = True
            raise
        finally:
            dur = time.monotonic() - t0
            self._request_seconds.observe(dur)
            if trace_id is not None:
                tracer.observe_exemplar(
                    "router_request_seconds", dur, trace_id
                )
                tracer.finish_trace(trace_id, error=error, dur_s=dur)

    def _forward_admitted(
        self,
        req,
        method: str,
        path: str,
        key: Optional[str],
        trace_id: Optional[str] = None,
        pool: Optional[List[str]] = None,
    ) -> Tuple[Any, int]:
        with self._tracer.span("router.order", affinity=key is not None):
            order, spilled = self._order_for(key, pool)
        if spilled and len(order) > 1:
            # the spill decision, queryable per request: who was hot,
            # where the request went instead
            self._tracer.event(
                "router.spill", home=order[1].id, spilled_to=order[0].id
            )
        if not order:
            self._requests.inc(outcome="rejected")
            raise HttpError(503, "no replicas registered")
        payload = None
        headers: Dict[str, str] = {}
        if req.body is not None:
            payload = json.dumps(req.body).encode()
            headers["Content-Type"] = "application/json"
        request_id = req.headers.get("x-request-id")
        if request_id:
            headers["X-Request-Id"] = request_id
        attempts = 0
        retry_after_hint: Optional[float] = None
        last_err = "no replica available"
        for idx, rep in enumerate(order):
            if attempts > self.retry_budget:
                break
            attempts += 1
            on_affinity_target = key is not None and idx == 0 and not spilled
            # in-flight accounting: the spill fallback's queue-depth
            # proxy — incremented for exactly the duration the replica
            # is working this attempt
            with self._lock:
                self._inflight[rep.id] = self._inflight.get(rep.id, 0) + 1
            try:
                route_span = self._tracer.span(
                    "request.route",
                    replica=rep.id,
                    attempt=attempts,
                    affinity=on_affinity_target,
                    spilled=spilled and idx == 0,
                )
                with route_span:
                    # propagate: THIS attempt's span is the remote
                    # parent of every span the replica records for the
                    # request (trace_id is None = tracing off: the
                    # header is simply not sent)
                    span_id = getattr(route_span, "span_id", None)
                    if trace_id is not None and span_id is not None:
                        headers["Traceparent"] = format_traceparent(
                            trace_id, span_id
                        )
                    try:
                        status, data, hdrs = self._transport(
                            method, rep.base_url + path, payload, headers
                        )
                    except Exception as e:  # noqa: BLE001 - replica verdict
                        last_err = f"{rep.id}: {type(e).__name__}: {e}"
                        self._note_failure(rep.id, last_err)
                        self._retries.inc()
                        continue
            finally:
                with self._lock:
                    self._inflight[rep.id] = max(
                        0, self._inflight.get(rep.id, 0) - 1
                    )
            if status == 429:
                # the drain contract: back off this replica for the
                # advertised window, try the next rendezvous choice.
                # No Retry-After header = queue-full, not draining —
                # same backoff, no phantom drain flag.
                ra = _parse_retry_after(hdrs)
                self._tracer.event(
                    "router.backoff", replica=rep.id, retry_after_s=ra
                )
                self._note_draining(
                    rep.id, ra, draining="retry-after" in hdrs
                )
                retry_after_hint = (
                    ra if retry_after_hint is None
                    else min(retry_after_hint, ra)
                )
                last_err = f"{rep.id}: 429 (retry-after {ra:g}s)"
                self._retries.inc()
                continue
            if status >= 500:
                last_err = f"{rep.id}: upstream {status}"
                self._note_failure(rep.id, last_err)
                self._retries.inc()
                continue
            # conclusive: success or the replica's own 4xx verdict —
            # heals failure demotions but leaves a live drain window
            # intact (clear_demotion=False)
            self._note_ok(rep.id, clear_demotion=False)
            self._requests.inc(outcome="ok" if status < 400 else "upstream_4xx")
            if on_affinity_target and status < 400:
                self._affinity_hits.inc()
            for lower, canonical in _PASSTHROUGH_HEADERS:
                if lower in hdrs:
                    req.response_headers.append((canonical, hdrs[lower]))
            try:
                result = json.loads(data) if data else {}
            except json.JSONDecodeError:
                result = {"success": False, "log": "unparseable upstream body"}
            return result, status
        self._requests.inc(outcome="rejected")
        if retry_after_hint is not None:
            req.response_headers.append(
                ("Retry-After", str(max(1, math.ceil(retry_after_hint))))
            )
        raise HttpError(
            503,
            f"no replica accepted the request after {attempts} "
            f"attempt(s); last: {last_err}",
        )

    # -- WSGI surface ------------------------------------------------------

    def _build(self) -> App:
        app = App("kft-router")

        @app.post("/v1/models/<name>:generate")
        def generate(req):
            body = req.body or {}
            if not isinstance(body, dict):
                raise BadRequest("request body must be a JSON object")
            key = self._affinity_key(body) if self.affinity else None
            pool = None
            if self.disagg and key is not None:
                with self._lock:
                    draining = self._draining
                if not draining:
                    # tier steering (may run the prefill hop) — skipped
                    # while draining: _forward's gate 429s anyway
                    pool = self._steer(req.params["name"], key, body)
            return self._forward(
                req, "POST", f"/v1/models/{req.params['name']}:generate",
                key, pool,
            )

        @app.post("/v1/models/<name>:predict")
        def predict(req):
            # :predict has no prefix to be affine to — spray it
            return self._forward(
                req, "POST", f"/v1/models/{req.params['name']}:predict", None
            )

        @app.get("/v1/models/<name>")
        def model_status(req):
            return self._forward(
                req, "GET", f"/v1/models/{req.params['name']}", None
            )

        @app.get("/v1/models")
        def list_models(req):
            return self._forward(req, "GET", "/v1/models", None)

        @app.get("/healthz")
        def healthz(req):
            states = self.replica_states()
            available = sum(1 for s in states.values() if not s["demoted"])
            with self._lock:
                draining = self._draining
            body = {
                "ok": True,
                "role": "router",
                "draining": draining,
                "replicas": {
                    "total": len(states),
                    "available": available,
                    "draining": sum(
                        1 for s in states.values() if s["draining"]
                    ),
                },
            }
            # same contract as the model server: 503 while draining so
            # the readiness probe pulls this router from its endpoints
            return (body, 503) if draining else body

        return app

    def _statusz_lines(self) -> List[str]:
        lines = [
            f"  affinity={'on' if self.affinity else 'off'} "
            f"page_size={self.page_size} "
            f"spill_queue_per_slot={self.spill_queue_per_slot:g} "
            f"retry_budget={self.retry_budget} "
            f"disagg={'on' if self.disagg else 'off'}"
        ]
        if self.disagg:
            with self._lock:
                counts = dict(self._steer_counts)
                seen = len(self._seen_keys)
                handoff = dict(self._handoff_last)
                now = self._clock()
            steers = " ".join(
                f"{tier}/{reason}={n}"
                for (tier, reason), n in sorted(counts.items())
            ) or "<none>"
            lines.append(
                f"  steering: cold_hit_rate={self.cold_hit_rate:g} "
                f"seen_keys={seen} steers: {steers}"
            )
            if handoff:
                verdict = (
                    f"error={handoff['error']}"
                    if "error" in handoff
                    else f"pages={handoff.get('pages', 0)} "
                    f"admitted={handoff.get('admitted', 0)} "
                    f"peers={handoff.get('peers', 0)}"
                )
                lines.append(
                    f"  last handoff: from={handoff.get('from')} "
                    f"{verdict} age={now - handoff.get('at', now):.0f}s"
                )
        states = self.replica_states()
        for rid in sorted(states):
            s = states[rid]
            verdict = (
                "draining" if s["draining"]
                else ("demoted" if s["demoted"] else "ok")
            )
            err = f" ({s['last_error']})" if s["last_error"] else ""
            lines.append(
                f"  {rid:<24}{s['base_url']:<32}{s['role']:<9}"
                f"{verdict:<10}fails={s['fails']}{err}"
            )
        if not states:
            lines.append("  <no replicas>")
        return lines
