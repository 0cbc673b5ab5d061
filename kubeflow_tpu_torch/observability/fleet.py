"""kft-fleet: cross-process metrics aggregation, SLO evaluation and
straggler detection for the control plane (port of
kubeflow_tpu/observability/fleet.py).

Each model-server replica and each gang rank exports its own /metrics,
/statusz and trace ring. This module is the layer above them:

- **Discovery**: scrape targets come from the cluster store's pod
  objects. Pods labeled `inferenceservice: <name>` are serving replicas
  (controllers/inference.py), pods labeled `inferenceservice-router:
  <name>` are kft-router front doors (their router_* series; never
  counted as replicas), pods labeled with the GPUTrainJob gang label are
  training ranks (controllers/gpujob.py). The
  controller-rendered `KFT_FLEET_METRICS_PORT` env names the scrape
  port; `KFT_FLEET_INSTANCE` names the replica/rank identity.
- **Aggregation**: every target's /metrics text parses back into
  structured samples (utils/metrics.py parse_rendered) and merges into
  fleet-level series per AGGREGATION_POLICY: counters sum, gauges follow
  their declared sum/max/min/mean policy, histograms merge bucket-wise
  (cross-replica quantiles come from the MERGED ladder). The policy
  covers every metric name the port declares, each exactly once.
- **SLO engine**: declarative rules (observability/slo.py) evaluate each
  sweep into `fleet_slo_compliant{slo}` + `fleet_slo_burn_rate{slo}`.
- **Straggler detection**: per gang rank, the rolling mean step time
  (delta `training_step_seconds` sum/count between sweeps) feeds a
  robust leave-one-out z-score against the job's other ranks; outliers
  flag `fleet_straggler{job,host}` = 1 and clear on recovery. The
  GPUTrainJob controller relays a rank flagged for several sweeps into
  a reshape (`stragglers()`, `sweeps()`).
- **Autoscaler signals**: `serving_signals(ns, name)` condenses a
  service's replicas into queue depth / occupancy / slot capacity / 429
  rate, and `disagg_signals` a disaggregated service's tiers (decode
  queue and occupancy, fleet TTFT p99, the router's cold-prefix steer
  rate); `InferenceServiceController` reads them each reconcile to
  adjust `spec.replicas` and `disagg.prefill_replicas` with hysteresis
  (controllers/inference.py). `replica_serving_signals` keeps the rows
  per replica for the router's spill and steering verdicts
  (routing/router.py `fleet_signals_source`).
- **Merged Perfetto export**: `merged_chrome_trace()` stitches every
  target's /debug/trace ring onto one timeline using scrape-time
  clock-offset estimation (each dump carries the process's monotonic
  capture timestamp; offset = collector clock at fetch − capture), one
  Perfetto process track per host; `merged_tracez()` merges the kept
  request traces by trace id.

The scrape loop is a daemon thread with an injectable fetch and clock,
so tests drive `scrape_once()` against fake endpoints with a fake clock.
"""

from __future__ import annotations

import dataclasses
import json
import math
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import (
    Any,
    Callable,
    Deque,
    Dict,
    List,
    Optional,
    Tuple,
)

from kubeflow_tpu_torch.chaos import ChaosError, default_chaos
from kubeflow_tpu_torch.observability.http import (  # noqa: F401
    ENV_FLEET_INSTANCE,
    instance_id,
)
from kubeflow_tpu_torch.observability.slo import (
    SloEngine,
    SloStatus,
    check_signal_kinds,
    parse_rules,
)
from kubeflow_tpu_torch.observability.trace import (
    EXEMPLAR_TOP_K as _EXEMPLAR_TOP_K,
)
from kubeflow_tpu_torch.utils.audit_lock import audit_lock
from kubeflow_tpu_torch.utils.logging import get_logger
from kubeflow_tpu_torch.utils.metrics import (
    HistogramState,
    MetricsRegistry,
    ParsedMetric,
    default_registry,
    fleet_slo_burn_rate_gauge,
    fleet_slo_compliant_gauge,
    fleet_straggler_gauge,
    fleet_targets_gauge,
    merge_rendered,
    parse_rendered,
)

log = get_logger(__name__)

# The fleet env contract rendered by the controllers
# (controllers/inference.py, controllers/gpujob.py):
# - KFT_FLEET_INSTANCE: this process's host/replica identity, carried on
#   the kft_instance_info series so aggregated rows stay attributable.
# - KFT_FLEET_METRICS_PORT: the port the collector scrapes on this pod
#   (the serving port for model servers, the debug port for gang ranks).
# - KFT_FLEET_SCRAPE: "1" makes EVERY gang rank serve the debug/metrics
#   endpoint (runtime/launcher.py), not just the coordinator: per-rank
#   series are what the straggler detector needs.
ENV_FLEET_METRICS_PORT = "KFT_FLEET_METRICS_PORT"
ENV_FLEET_SCRAPE = "KFT_FLEET_SCRAPE"

DEFAULT_SCRAPE_INTERVAL_S = 10.0
DEFAULT_STRAGGLER_ZSCORE = 3.0
DEFAULT_BURN_WINDOW = 30
# rolling per-host step-time window (sweeps) feeding the z-score
STRAGGLER_WINDOW = 8
# leave-one-out std floor, relative to the peers' mean: below it a
# perfectly homogeneous gang would divide by ~0 and flag noise
_STRAGGLER_REL_FLOOR = 0.02

# Aggregation policy: every metric name the port declares (a registry's
# counter/gauge/histogram call in kubeflow_tpu_torch/) has exactly one
# merge policy here: counters "sum", histograms "merge", gauges one of
# sum/max/min/mean. A missing, stale or duplicate entry is a test
# failure, so a new metric cannot ship unaggregatable. fleet_* series
# are collector-PRODUCED, never scraped, and stay out. It is the
# reference's table under the port's names (gpujob_* for tpujob_*, and
# the pod's serving_kernel_launches).
AGGREGATION_POLICY: Dict[str, str] = {
    # control-plane + HTTP counters
    "checkpoint_bytes_total": "sum",
    "checkpoint_restores_total": "sum",
    "checkpoint_save_total": "sum",
    "gpujob_gang_reshapes_total": "sum",
    "gpujob_gang_restarts_total": "sum",
    "gpujob_total": "sum",
    "http_requests_total": "sum",
    "kft_faults_injected_total": "sum",
    # distributed-tracing tail sampler (observability/trace.py
    # finish_trace): kept-by-reason + sampled-out across the fleet
    "kft_trace_kept_total": "sum",
    "kft_trace_sampled_out_total": "sum",
    # the kft-router front door (routing/router.py)
    "router_affinity_hits_total": "sum",
    "router_requests_total": "sum",
    "router_retry_total": "sum",
    "router_spill_total": "sum",
    # steering decisions by (tier, reason): a fleet stuck on
    # unified/tier-down has a broken tier registry or prefill health
    "router_tier_steer_total": "sum",
    # fresh traceparents (requests_total minus this = traffic that
    # arrives already traced)
    "router_trace_minted_total": "sum",
    "profiler_captures_total": "sum",
    "reconcile_total": "sum",
    "serving_decode_steps_total": "sum",
    "serving_draft_accepted_total": "sum",
    "serving_draft_proposed_total": "sum",
    "serving_engine_recoveries_total": "sum",
    # read-path dispatches by variant label: summed per variant across
    # the fleet, so any "gather" samples from a kernel fleet stand out
    "serving_paged_attention_calls_total": "sum",
    # page handoff between tiers: pages moved and milliseconds spent,
    # both directions (the fleet question is pages/ms, not a latency
    # distribution)
    "serving_kv_handoff_ms": "sum",
    "serving_kv_handoff_pages_total": "sum",
    "serving_kv_spill_hits_total": "sum",
    "serving_kv_spill_pages_total": "sum",
    # MoE routing (dense engines emit none of these): per-expert routed
    # positions and capacity drops sum across the fleet
    "serving_moe_capacity_overflow_total": "sum",
    "serving_moe_expert_tokens_total": "sum",
    "serving_prefix_cache_hit_tokens_total": "sum",
    "serving_prefix_cache_lookups_total": "sum",
    "serving_requests_total": "sum",
    "serving_tokens_total": "sum",
    "serving_verify_steps_total": "sum",
    "statestore_writes_total": "sum",
    "study_total": "sum",
    "study_trials_total": "sum",
    # histograms: bucket-wise merge (quantiles from the merged ladder)
    "checkpoint_blocked_seconds": "merge",
    "checkpoint_save_seconds": "merge",
    "http_request_seconds": "merge",
    "reconcile_seconds": "merge",
    "serving_accept_rate": "merge",
    "serving_drain_seconds": "merge",
    "serving_fused_batch_rows": "merge",
    "serving_predict_seconds": "merge",
    "serving_request_phase_seconds": "merge",
    "serving_time_to_first_token_seconds": "merge",
    # router request wall time: fleet quantiles for front-door SLO
    # rules; exemplar trace ids ride /tracez
    "router_request_seconds": "merge",
    "training_host_wait_seconds": "merge",
    "training_step_seconds": "merge",
    # gauges: capacity/queue-like sum, identity max, ratio-like mean (a
    # mean of fractions, NOT a max: one idle replica must pull fleet
    # occupancy down)
    "gpujob_running": "sum",
    "kft_instance_info": "max",
    # a serving process's paged-kernel launches by kernel (serving/
    # server.py, read at each scrape): launches add across replicas
    "serving_kernel_launches": "sum",
    # the router's distinct first-page keys (capped): one router a
    # service, so max is that router's value
    "router_first_page_keys": "max",
    "serving_kv_pages_in_use": "sum",
    "serving_kv_pages_total": "sum",
    # last persisted-generation size: a restart-warmth indicator, not a
    # capacity, so the largest snapshot any replica committed
    "serving_kv_persisted_chains": "max",
    "serving_kv_pool_bytes": "sum",
    # per-card pool bytes: the card-memory-limiting value, max not sum
    "serving_kv_pool_bytes_per_chip": "max",
    # distinct first-page keys each replica has seen (engine-side cap):
    # summed = the fleet's tracked key population
    "serving_first_page_keys": "sum",
    "serving_num_slots": "sum",
    # lifetime prefix-cache hit-token fraction per replica: ratio-like
    "serving_prefix_hit_rate": "mean",
    # per-replica max/mean expert occupancy: ratio-like
    "serving_moe_load_imbalance": "mean",
    "serving_queue_depth": "sum",
    "serving_slot_occupancy": "mean",
    "training_eval_top1": "mean",
    "training_goodput": "mean",
    "training_items_per_sec": "sum",
    "training_model_flops_utilization": "mean",
    "training_prefetch_queue_depth": "sum",
}


@dataclasses.dataclass(frozen=True)
class ScrapeTarget:
    """One per-process metrics endpoint the collector polls."""

    role: str        # "serving" | "training"
    namespace: str
    owner: str       # InferenceService name / GPUTrainJob name
    instance: str    # replica/host identity (pod name or rendered env)
    base_url: str    # e.g. http://pod-0.ns:9432 (no trailing slash)
    # disaggregated serving tier (controllers/inference.py renders the
    # `inferenceservice-tier` pod label): "prefill" | "decode" |
    # "unified"; per-tier signal splits key on it
    tier: str = "unified"


def _container_env(pod: Dict[str, Any]) -> Dict[str, str]:
    env: Dict[str, str] = {}
    for c in (pod.get("spec") or {}).get("containers", []):
        for e in c.get("env", []) or []:
            if "name" in e and "value" in e:
                env[e["name"]] = str(e["value"])
    return env


# the GPUTrainJob gang label (controllers/gpujob.py JOB_NAME_LABEL, the
# reference's value); a string here so this module never imports the
# controller layer. It must match the controller's constant: discovery
# keyed on another label would never find real gang pods, and the
# straggler → reshape relay rides it.
_JOB_NAME_LABEL = "kubeflow-tpu.dev/job-name"
_SERVING_LABEL = "inferenceservice"
# the kft-router pod label (controllers/inference.py _reconcile_router):
# the router is scraped (its router_* series) but carries no
# `inferenceservice` label, so it never counts as a replica
_ROUTER_LABEL = "inferenceservice-router"
# the disaggregated-tier pod label (controllers/inference.py; the router
# reads the same one, routing/router.py _TIER_LABEL)
_TIER_LABEL = "inferenceservice-tier"


def discover_targets(store) -> List[ScrapeTarget]:
    """Scrape targets from the cluster store's pod objects: any pod whose
    env carries KFT_FLEET_METRICS_PORT is scrapeable; its labels say
    which fleet it belongs to. Addressing is the shared `pod_host`
    preference order (cluster/objects.py): the reported pod IP, else
    the pod's gang DNS name, else the bare pod name."""
    from kubeflow_tpu_torch.cluster.objects import pod_host

    out: List[ScrapeTarget] = []
    for pod in store.list("Pod"):
        meta = pod.get("metadata", {})
        labels = meta.get("labels", {}) or {}
        env = _container_env(pod)
        port = env.get(ENV_FLEET_METRICS_PORT, "").strip()
        if not port:
            continue
        if _SERVING_LABEL in labels:
            role, owner = "serving", labels[_SERVING_LABEL]
        elif _JOB_NAME_LABEL in labels:
            role, owner = "training", labels[_JOB_NAME_LABEL]
        elif _ROUTER_LABEL in labels:
            role, owner = "router", labels[_ROUTER_LABEL]
        else:
            continue
        ns = meta.get("namespace", "default")
        host = pod_host(pod)
        tier = labels.get(_TIER_LABEL, "").strip()
        if role != "serving" or tier not in ("prefill", "decode"):
            tier = "unified"
        out.append(
            ScrapeTarget(
                role=role,
                namespace=ns,
                owner=owner,
                instance=env.get(ENV_FLEET_INSTANCE)
                or meta.get("name", host),
                base_url=f"http://{host}:{port}",
                tier=tier,
            )
        )
    return out


def default_fetch(url: str, timeout_s: float = 3.0) -> str:
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        return resp.read().decode("utf-8", errors="replace")


@dataclasses.dataclass
class FleetSignals:
    """One InferenceService's fleet-condensed engine signals — the
    autoscaler's entire input (pure data: the controller's scaling logic
    tests against hand-built instances)."""

    replicas: int            # replicas scraped OK at the last sweep
    queue_depth: float       # sum of serving_queue_depth
    occupancy: float         # mean of serving_slot_occupancy
    num_slots: float         # sum of serving_num_slots (fleet capacity)
    rate_429_per_s: float    # fleet 429 responses/sec between sweeps
    # monotonically increasing scrape-sweep id: the autoscaler advances
    # its hysteresis streaks only when this moves, so watch-event
    # reconciles re-reading ONE sweep cannot fake consecutive breaches.
    # -1 = untracked source (every read counts — test fakes).
    sweep: int = -1


@dataclasses.dataclass
class DisaggSignals:
    """Per-tier autoscaler input for one DISAGGREGATED InferenceService
    (controllers/inference.py _autoscale_prefill, _autoscale_decode).
    TTFT is fleet-wide (the latency the prefill tier exists to protect);
    queue and occupancy are over decode/unified replicas only, so idle
    prefill slots cannot mask decode pressure."""

    prefill_replicas: int    # prefill-tier replicas scraped OK
    decode_replicas: int     # decode/unified-tier replicas scraped OK
    ttft_p99_s: Optional[float]  # fleet TTFT p99 (merged histogram)
    cold_per_s: float        # router cold-prefix steers a second
    decode_queue_depth: float
    decode_num_slots: float
    decode_occupancy: float
    sweep: int = -1


@dataclasses.dataclass
class _TargetState:
    """Per-target scrape bookkeeping (guarded by the collector lock)."""

    parsed: Optional[Dict[str, ParsedMetric]] = None
    error: str = ""
    last_ok_t: float = 0.0
    prev_429: Optional[float] = None
    prev_429_t: float = 0.0
    rate_429: float = 0.0
    # the router's cold-prefix steer rate (router_tier_steer_total
    # {tier=prefill,reason=cold} deltas between sweeps): the prefill
    # autoscaler's arrival signal
    prev_steer: Optional[float] = None
    prev_steer_t: float = 0.0
    rate_steer: float = 0.0
    # straggler inputs: previous (sum, count) of training_step_seconds
    prev_step: Optional[Tuple[float, float]] = None
    step_means: Deque[float] = dataclasses.field(
        default_factory=lambda: deque(maxlen=STRAGGLER_WINDOW)
    )


def _collapse(pm: ParsedMetric, policy: str) -> Optional[float]:
    """One scalar for a merged metric across its label sets, using the
    same policy that merged it across processes."""
    vals = [float(v) for v in pm.samples.values()
            if not isinstance(v, HistogramState)]
    if not vals:
        return None
    if policy == "max":
        return max(vals)
    if policy == "min":
        return min(vals)
    if policy == "mean":
        return sum(vals) / len(vals)
    return sum(vals)


def _merged_histogram(pm: ParsedMetric) -> Optional[HistogramState]:
    out: Optional[HistogramState] = None
    for v in pm.samples.values():
        if not isinstance(v, HistogramState):
            continue
        if out is None:
            out = HistogramState()
        out.merge(v)
    return out


class FleetCollector:
    """Scrapes every fleet target's /metrics, merges, evaluates SLOs,
    detects stragglers, and feeds the serving autoscaler.

    Thread model: `scrape_once()` may run on the daemon loop thread or a
    caller thread; all mutable state is guarded by `_lock` (fetches
    happen outside it). The exported gauges live in `registry`.
    """

    def __init__(
        self,
        targets: Callable[[], List[ScrapeTarget]],
        fetch: Optional[Callable[[str], str]] = None,
        registry: Optional[MetricsRegistry] = None,
        slo_rules: Optional[List[str]] = None,
        scrape_interval_s: float = DEFAULT_SCRAPE_INTERVAL_S,
        straggler_zscore: float = DEFAULT_STRAGGLER_ZSCORE,
        burn_window: int = DEFAULT_BURN_WINDOW,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if scrape_interval_s <= 0:
            raise ValueError("scrape_interval_s must be > 0")
        if straggler_zscore <= 0:
            raise ValueError("straggler_zscore must be > 0")
        self._targets_fn = targets
        self._fetch = fetch or default_fetch
        self._clock = clock
        self.scrape_interval_s = float(scrape_interval_s)
        self.straggler_zscore = float(straggler_zscore)
        self._registry = registry or default_registry()
        rules = parse_rules(slo_rules or [])
        # a histogram signal without a quantile (or a quantile of a
        # scalar) would silently never evaluate — fail construction, not
        # the first 3am sweep
        check_signal_kinds(rules, AGGREGATION_POLICY)
        self._slo = SloEngine(rules, burn_window=burn_window)
        self._lock = audit_lock("FleetCollector._lock")
        self._state: Dict[ScrapeTarget, _TargetState] = {}
        self._merged: Dict[str, ParsedMetric] = {}
        self._groups: Dict[Tuple[str, str, str], Dict[str, ParsedMetric]] = {}
        self._group_429: Dict[Tuple[str, str, str], float] = {}
        self._group_steer: Dict[Tuple[str, str, str], float] = {}
        self._group_replicas: Dict[Tuple[str, str, str], int] = {}
        self._stragglers: Dict[Tuple[str, str, str], bool] = {}
        self._straggler_means: Dict[Tuple[str, str, str], float] = {}
        self._exported_stragglers: set = set()
        self._slo_statuses: List[SloStatus] = self._slo.statuses()
        self._sweeps = 0
        self._last_sweep_t = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._g_compliant = fleet_slo_compliant_gauge(self._registry)
        self._g_burn = fleet_slo_burn_rate_gauge(self._registry)
        self._g_straggler = fleet_straggler_gauge(self._registry)
        self._g_targets = fleet_targets_gauge(self._registry)
        # kft-chaos: fleet.scrape_fetch models an unreachable pod /
        # partition — the injected fault rides the same best-effort
        # per-target error path a real timeout does
        self._chaos = default_chaos()

    @classmethod
    def from_config(
        cls, cfg, targets, fetch=None, registry=None,
        clock: Callable[[], float] = time.monotonic,
    ) -> "FleetCollector":
        """Build from an ObservabilityConfig (config/platform.py): its
        slo_rules / fleet_scrape_interval_s / fleet_straggler_zscore /
        fleet_burn_window knobs map 1:1 onto the constructor."""
        return cls(
            targets,
            fetch=fetch,
            registry=registry,
            slo_rules=list(cfg.slo_rules),
            scrape_interval_s=cfg.fleet_scrape_interval_s,
            straggler_zscore=cfg.fleet_straggler_zscore,
            burn_window=cfg.fleet_burn_window,
            clock=clock,
        )

    # -- scrape loop -------------------------------------------------------

    def start(self) -> None:
        """Run the scrape loop on a daemon thread until stop().
        Restartable: a start() after stop() scrapes again."""
        # check-then-act under the lock: two racing start() calls must not
        # both observe _thread is None and spawn duplicate scrape loops
        with self._lock:
            if self._thread is not None:
                return
            self._stop.clear()
            t = threading.Thread(
                target=self._run, daemon=True, name="fleet-collector"
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
                self.scrape_once()
            except Exception:  # noqa: BLE001 - the loop must survive
                log.exception("fleet scrape sweep failed")
            self._stop.wait(self.scrape_interval_s)

    # -- one sweep ---------------------------------------------------------

    def scrape_once(self) -> None:
        """One full sweep: fetch every target (network OUTSIDE the lock,
        CONCURRENTLY — a few unreachable pods during a rollout must cost
        one fetch timeout, not timeouts x pods, or every signal goes
        stale exactly when the cluster is unhealthy), then merge +
        evaluate under the lock."""
        targets = list(self._targets_fn())
        now = self._clock()
        # chaos decided SERIALLY, in target order, BEFORE the pool runs:
        # the executor's threads would otherwise consume the injection
        # point's call counter/RNG in scheduling order, making WHICH
        # target fails run-dependent — breaking the bitwise-replay
        # guarantee the chaos layer documents
        chaos_down = set()
        for t in targets:
            try:
                self._chaos.maybe_fail("fleet.scrape_fetch")
            except ChaosError:
                chaos_down.add(t)

        def _grab(t: ScrapeTarget) -> Tuple[Optional[Dict], str]:
            try:
                if t in chaos_down:
                    raise ChaosError("fleet.scrape_fetch")
                return parse_rendered(self._fetch(t.base_url + "/metrics")), ""
            except Exception as e:  # noqa: BLE001 - scrape is best-effort
                return None, f"{type(e).__name__}: {e}"

        fetched: Dict[ScrapeTarget, Tuple[Optional[Dict], str]] = {}
        if targets:
            with ThreadPoolExecutor(
                max_workers=min(8, len(targets))
            ) as pool:
                for t, res in zip(targets, pool.map(_grab, targets)):
                    fetched[t] = res
        with self._lock:
            self._ingest(targets, fetched, now)
        self._export()

    def _ingest(self, targets, fetched, now: float) -> None:
        # drop state for targets that no longer exist (scaled away)
        live = set(targets)
        for t in list(self._state):
            if t not in live:
                del self._state[t]
        ok_snapshots: List[Dict[str, ParsedMetric]] = []
        group_snaps: Dict[Tuple[str, str, str], List[Dict]] = {}
        self._group_429 = {}
        self._group_steer = {}
        self._group_replicas = {}
        for t in targets:
            st = self._state.setdefault(t, _TargetState())
            parsed, err = fetched[t]
            if parsed is None:
                st.error = err
                continue
            st.error = ""
            st.parsed = parsed
            st.last_ok_t = now
            self._update_429(st, parsed, now)
            self._update_cold_steer(st, parsed, now)
            self._update_step_stats(st, parsed)
            ok_snapshots.append(parsed)
            key = (t.role, t.namespace, t.owner)
            group_snaps.setdefault(key, []).append(parsed)
            self._group_429[key] = (
                self._group_429.get(key, 0.0) + st.rate_429
            )
            if st.rate_steer:
                self._group_steer[key] = (
                    self._group_steer.get(key, 0.0) + st.rate_steer
                )
            self._group_replicas[key] = (
                self._group_replicas.get(key, 0) + 1
            )
        self._merged = merge_rendered(ok_snapshots, AGGREGATION_POLICY)
        self._groups = {
            key: merge_rendered(snaps, AGGREGATION_POLICY)
            for key, snaps in group_snaps.items()
        }
        self._detect_stragglers(targets)
        self._slo_statuses = self._slo.evaluate(self._resolve_locked)
        self._sweeps += 1
        self._last_sweep_t = now

    @staticmethod
    def _update_429(st: _TargetState, parsed, now: float) -> None:
        pm = parsed.get("http_requests_total")
        total = 0.0
        if pm is not None:
            for key, v in pm.samples.items():
                if ("status", "429") in key:
                    total += float(v)
        if st.prev_429 is not None and now > st.prev_429_t:
            delta = max(0.0, total - st.prev_429)
            st.rate_429 = delta / (now - st.prev_429_t)
        st.prev_429 = total
        st.prev_429_t = now

    @staticmethod
    def _update_cold_steer(st: _TargetState, parsed, now: float) -> None:
        """Cold-prefix steers a second off the router's
        router_tier_steer_total{tier=prefill,reason=cold}: the 429
        rate's delta-between-sweeps shape."""
        pm = parsed.get("router_tier_steer_total")
        if pm is None:
            return
        total = 0.0
        for key, v in pm.samples.items():
            if ("tier", "prefill") in key and ("reason", "cold") in key:
                total += float(v)
        if st.prev_steer is not None and now > st.prev_steer_t:
            delta = max(0.0, total - st.prev_steer)
            st.rate_steer = delta / (now - st.prev_steer_t)
        st.prev_steer = total
        st.prev_steer_t = now

    @staticmethod
    def _update_step_stats(st: _TargetState, parsed) -> None:
        pm = parsed.get("training_step_seconds")
        if pm is None:
            return
        hs = _merged_histogram(pm)
        if hs is None:
            return
        if st.prev_step is not None:
            d_sum = hs.sum - st.prev_step[0]
            d_count = hs.count - st.prev_step[1]
            if d_count > 0:
                st.step_means.append(d_sum / d_count)
        elif hs.count > 0:
            # first sight of a host mid-run: its lifetime mean seeds the
            # window so detection does not wait a full extra sweep
            st.step_means.append(hs.sum / hs.count)
        st.prev_step = (hs.sum, hs.count)

    # -- straggler detection ----------------------------------------------

    def _detect_stragglers(self, targets) -> None:
        """Robust leave-one-out z-score per gang host: a host is a
        straggler while its rolling mean step time exceeds its peers'
        mean by more than `straggler_zscore` of their spread (std floored
        at a fraction of their mean, so a perfectly uniform gang cannot
        flag noise). Needs >= 2 peers with data."""
        jobs: Dict[Tuple[str, str], List[Tuple[str, float]]] = {}
        for t in targets:
            if t.role != "training":
                continue
            st = self._state.get(t)
            if st is None or not st.step_means:
                continue
            mean = sum(st.step_means) / len(st.step_means)
            jobs.setdefault((t.namespace, t.owner), []).append(
                (t.instance, mean)
            )
        flags: Dict[Tuple[str, str, str], bool] = {}
        means: Dict[Tuple[str, str, str], float] = {}
        for (ns, job), hosts in jobs.items():
            for host, mean in hosts:
                others = [m for h, m in hosts if h != host]
                key = (ns, job, host)
                means[key] = mean
                if len(others) < 2:
                    flags[key] = False
                    continue
                o_mean = sum(others) / len(others)
                o_var = sum((m - o_mean) ** 2 for m in others) / len(others)
                o_std = max(
                    math.sqrt(o_var),
                    _STRAGGLER_REL_FLOOR * abs(o_mean),
                    1e-12,
                )
                z = (mean - o_mean) / o_std
                flags[key] = z > self.straggler_zscore
        self._stragglers = flags
        self._straggler_means = means

    # -- SLO signal resolution --------------------------------------------

    def _resolve_locked(
        self, metric: str, quantile: Optional[float]
    ) -> Optional[float]:
        pm = self._merged.get(metric)
        if pm is None:
            return None
        if quantile is not None:
            hs = _merged_histogram(pm)
            return hs.quantile(quantile) if hs is not None else None
        policy = AGGREGATION_POLICY.get(metric, "sum")
        return _collapse(pm, policy)

    def resolve_signal(
        self, metric: str, quantile: Optional[float] = None
    ) -> Optional[float]:
        with self._lock:
            return self._resolve_locked(metric, quantile)

    # -- gauge export ------------------------------------------------------

    def _export(self) -> None:
        with self._lock:
            statuses = list(self._slo_statuses)
            stragglers = dict(self._stragglers)
            # a flagged host that vanished (gang restart, job done) must
            # not leave fleet_straggler{...}=1 stuck forever: zero out
            # every key we exported before that has no row this sweep
            stale_stragglers = self._exported_stragglers - set(stragglers)
            self._exported_stragglers = set(stragglers)
            counts: Dict[str, int] = {}
            for t, st in self._state.items():
                if st.parsed is not None and not st.error:
                    counts[t.role] = counts.get(t.role, 0) + 1
        for status in statuses:
            if status.compliant is None:
                continue
            self._g_compliant.set(
                1.0 if status.compliant else 0.0, slo=status.rule.name
            )
            self._g_burn.set(status.burn_rate, slo=status.rule.name)
        for (ns, job, host), flagged in stragglers.items():
            self._g_straggler.set(
                1.0 if flagged else 0.0, job=f"{ns}/{job}", host=host
            )
        for ns, job, host in stale_stragglers:
            self._g_straggler.set(0.0, job=f"{ns}/{job}", host=host)
        for role in ("serving", "training", "router"):
            self._g_targets.set(float(counts.get(role, 0)), role=role)

    # -- consumers ---------------------------------------------------------

    def fleet_series(self) -> Dict[str, ParsedMetric]:
        with self._lock:
            return dict(self._merged)

    def slo_statuses(self) -> List[SloStatus]:
        with self._lock:
            return list(self._slo_statuses)

    def stragglers(self) -> Dict[Tuple[str, str, str], bool]:
        with self._lock:
            return dict(self._stragglers)

    def sweeps(self) -> int:
        """Monotonic scrape-sweep count — the freshness token consumers
        with hysteresis (the autoscaler via FleetSignals.sweep, the
        GPUTrainJob controller's straggler-trip counter) key their
        consecutive-observation streaks on, so re-reading one sweep's
        snapshot can never fake repeated observations."""
        with self._lock:
            return self._sweeps

    def serving_signals(
        self, namespace: str, name: str
    ) -> Optional[FleetSignals]:
        """Condensed autoscaler input for one InferenceService, or None
        when no replica of it was reachable at the last sweep."""
        key = ("serving", namespace, name)
        with self._lock:
            merged = self._groups.get(key)
            if not merged:
                return None

            def val(metric: str, default: float = 0.0) -> float:
                pm = merged.get(metric)
                if pm is None:
                    return default
                v = _collapse(pm, AGGREGATION_POLICY.get(metric, "sum"))
                return default if v is None else v

            return FleetSignals(
                replicas=self._group_replicas.get(key, 0),
                queue_depth=val("serving_queue_depth"),
                occupancy=val("serving_slot_occupancy"),
                num_slots=val("serving_num_slots"),
                rate_429_per_s=self._group_429.get(key, 0.0),
                sweep=self._sweeps,
            )

    def disagg_signals(
        self, namespace: str, name: str
    ) -> Optional[DisaggSignals]:
        """Per-tier autoscaler input for one disaggregated
        InferenceService, or None when no serving replica of it was
        reachable at the last sweep. The tier split keys on each scrape
        target's pod label (discover_targets); unified replicas count as
        decode capacity, since they serve decode traffic."""
        key = ("serving", namespace, name)
        with self._lock:
            prefill = 0
            decode_snaps: List[Dict[str, ParsedMetric]] = []
            for t, st in self._state.items():
                if (t.role, t.namespace, t.owner) != key:
                    continue
                if st.parsed is None or st.error:
                    continue
                if t.tier == "prefill":
                    prefill += 1
                else:
                    decode_snaps.append(st.parsed)
            if not prefill and not decode_snaps:
                return None
            decode = merge_rendered(decode_snaps, AGGREGATION_POLICY)

            def val(metric: str) -> float:
                pm = decode.get(metric)
                if pm is None:
                    return 0.0
                v = _collapse(pm, AGGREGATION_POLICY.get(metric, "sum"))
                return 0.0 if v is None else v

            # TTFT stays fleet-wide: the merged service group holds
            # every tier's histogram
            ttft = None
            pm = (self._groups.get(key) or {}).get(
                "serving_time_to_first_token_seconds"
            )
            if pm is not None:
                hs = _merged_histogram(pm)
                if hs is not None and hs.count > 0:
                    ttft = hs.quantile(0.99)
            return DisaggSignals(
                prefill_replicas=prefill,
                decode_replicas=len(decode_snaps),
                ttft_p99_s=ttft,
                cold_per_s=self._group_steer.get(
                    ("router", namespace, name), 0.0
                ),
                decode_queue_depth=val("serving_queue_depth"),
                decode_num_slots=val("serving_num_slots"),
                decode_occupancy=val("serving_slot_occupancy"),
                sweep=self._sweeps,
            )

    def replica_serving_signals(
        self, namespace: str, name: str, instance: Optional[str] = None
    ) -> Dict[str, Dict[str, float]]:
        """Per-replica engine signals of one InferenceService, the
        router's spill and steering input (routing/router.py
        `fleet_signals_source`): each reachable replica's queue depth and
        slot capacity from its last good scrape, keyed by its fleet
        instance id, and its prefix hit rate and first-page keys where it
        exports them (so "cold cache, 0.0" differs from "unknown").
        `instance` narrows the work to one replica's row, the query a
        routed request makes."""
        key = ("serving", namespace, name)
        out: Dict[str, Dict[str, float]] = {}
        with self._lock:
            for t, st in self._state.items():
                if (t.role, t.namespace, t.owner) != key:
                    continue
                if instance is not None and t.instance != instance:
                    continue
                if st.parsed is None or st.error:
                    continue

                def opt(metric: str) -> Optional[float]:
                    pm = st.parsed.get(metric)
                    if pm is None:
                        return None
                    return _collapse(
                        pm, AGGREGATION_POLICY.get(metric, "sum")
                    )

                row = {
                    "queue_depth": opt("serving_queue_depth") or 0.0,
                    "num_slots": opt("serving_num_slots") or 0.0,
                }
                for field, metric in (
                    ("prefix_hit_rate", "serving_prefix_hit_rate"),
                    ("first_page_keys", "serving_first_page_keys"),
                ):
                    v = opt(metric)
                    if v is not None:
                        row[field] = v
                out[t.instance] = row
        return out

    # -- merged cross-host Perfetto export ---------------------------------

    def merged_chrome_trace(self) -> Dict[str, Any]:
        """Fetch every target's /debug/trace live and stitch the rings
        onto ONE timeline: each dump carries its process's monotonic
        capture timestamp (`captureUs`, observability/trace.py), so the
        per-host clock offset is estimated at fetch time as
        `collector_monotonic_at_fetch - captureUs` (error bounded by the
        fetch RTT). Every host becomes its own Perfetto process track."""
        targets = sorted(
            self._targets_fn(),
            key=lambda x: (x.role, x.namespace, x.owner, x.instance),
        )

        def _grab(t: ScrapeTarget):
            # the offset reference clock is read right after THIS fetch
            # returns, so one slow host does not skew the others' offsets
            try:
                doc = json.loads(self._fetch(t.base_url + "/debug/trace"))
            except Exception:  # noqa: BLE001 - partial fleets still export
                return None
            return doc, self._clock() * 1e6

        grabbed: List[Any] = []
        if targets:
            with ThreadPoolExecutor(
                max_workers=min(8, len(targets))
            ) as pool:
                grabbed = list(pool.map(_grab, targets))
        events: List[Dict[str, Any]] = []
        idx = -1
        for t, got in zip(targets, grabbed):
            if got is None:
                continue
            doc, ref_us = got
            idx += 1
            capture = doc.get("captureUs")
            host_events = doc.get("traceEvents", [])
            if capture is None:
                # pre-captureUs dump: anchor its newest event at fetch time
                body_ts = [
                    e["ts"] for e in host_events if e.get("ph") != "M"
                ]
                capture = max(body_ts) if body_ts else ref_us
            offset = ref_us - float(capture)
            events.append(
                {
                    "name": "process_name",
                    "ph": "M",
                    "pid": idx,
                    "tid": 0,
                    "args": {
                        "name": (
                            f"{t.role}:{t.namespace}/{t.owner}"
                            f" [{t.instance}]"
                        )
                    },
                }
            )
            for e in host_events:
                e = dict(e)
                if e.get("name") == "process_name" and e.get("ph") == "M":
                    continue
                e["pid"] = idx
                if e.get("ph") != "M":
                    e["ts"] = round(float(e.get("ts", 0.0)) + offset, 3)
                events.append(e)
        events.extend(self._request_flow_events(events))
        meta = [e for e in events if e.get("ph") == "M"]
        body = sorted(
            (e for e in events if e.get("ph") != "M"),
            key=lambda e: e["ts"],
        )
        return {"traceEvents": meta + body, "displayTimeUnit": "ms"}

    @staticmethod
    def _trace_root(trace_id: str) -> str:
        """Multi-row requests tag row i `<id>/<i>` (serving/engine.py
        submit_batch) — causality groups on the request id."""
        return trace_id.split("/", 1)[0]

    @staticmethod
    def _request_flow_events(
        events: List[Dict[str, Any]]
    ) -> List[Dict[str, Any]]:
        """Perfetto flow events binding one request's spans ACROSS
        process tracks: for every trace id whose spans live in >= 2
        pids (the router hop + the replica), emit an s→t→f flow chain
        anchored at each process's earliest span of that trace — the
        merged timeline renders the request as ONE connected flow
        instead of coincidentally aligned slices."""
        anchors: Dict[str, Dict[int, Dict[str, Any]]] = {}
        for e in events:
            if e.get("ph") != "X":
                continue
            tid_ = (e.get("args") or {}).get("trace_id")
            if not isinstance(tid_, str):
                continue
            root = FleetCollector._trace_root(tid_)
            per_pid = anchors.setdefault(root, {})
            cur = per_pid.get(e["pid"])
            if cur is None or e["ts"] < cur["ts"]:
                per_pid[e["pid"]] = e
        flows: List[Dict[str, Any]] = []
        flow_id = 0
        for root in sorted(anchors):
            per_pid = anchors[root]
            if len(per_pid) < 2:
                continue
            flow_id += 1
            chain = sorted(per_pid.values(), key=lambda e: e["ts"])
            for i, anchor in enumerate(chain):
                ph = "s" if i == 0 else ("f" if i == len(chain) - 1 else "t")
                ev = {
                    "name": "request",
                    "cat": "request",
                    "ph": ph,
                    "id": flow_id,
                    "pid": anchor["pid"],
                    "tid": anchor["tid"],
                    # nudged inside the anchor slice so Perfetto binds
                    # the flow to it rather than the slice boundary
                    "ts": round(anchor["ts"] + 0.001, 3),
                    "args": {"trace_id": root},
                }
                if ph == "f":
                    ev["bp"] = "e"
                flows.append(ev)
        return flows

    def merged_tracez(self) -> Dict[str, Any]:
        """Fetch every target's /tracez live and merge the kept request
        traces BY TRACE ID across processes: every process's spans of
        one request (the same propagated trace id) land in one merged
        trace, each span stamped with the process it
        came from and clock-shifted onto the collector timeline exactly
        like merged_chrome_trace. Per-series exemplars merge worst-first
        across the fleet — the metric→trace index `slo_exemplars` (and
        /fleetz) serves."""
        targets = sorted(
            self._targets_fn(),
            key=lambda x: (x.role, x.namespace, x.owner, x.instance),
        )

        def _grab(t: ScrapeTarget):
            try:
                doc = json.loads(self._fetch(t.base_url + "/tracez"))
            except Exception:  # noqa: BLE001 - partial fleets still export
                return None
            return doc, self._clock() * 1e6

        grabbed: List[Any] = []
        if targets:
            with ThreadPoolExecutor(
                max_workers=min(8, len(targets))
            ) as pool:
                grabbed = list(pool.map(_grab, targets))
        merged: Dict[str, Dict[str, Any]] = {}
        exemplars: Dict[str, List[Dict[str, Any]]] = {}
        for t, got in zip(targets, grabbed):
            if got is None:
                continue
            doc, ref_us = got
            capture = doc.get("captureUs")
            offset_s = (
                (ref_us - float(capture)) / 1e6 if capture is not None
                else 0.0
            )
            for trace in doc.get("traces", []):
                root = self._trace_root(str(trace.get("trace_id", "")))
                if not root:
                    continue
                tgt = merged.setdefault(
                    root,
                    {
                        "trace_id": root,
                        "processes": [],
                        "error": False,
                        "keep_reasons": [],
                        "dur_s": 0.0,
                        "spans": [],
                    },
                )
                if t.instance not in tgt["processes"]:
                    tgt["processes"].append(t.instance)
                tgt["error"] = tgt["error"] or bool(trace.get("error"))
                reason = trace.get("keep_reason")
                if reason and reason not in tgt["keep_reasons"]:
                    tgt["keep_reasons"].append(reason)
                if trace.get("dur_s"):
                    tgt["dur_s"] = max(
                        tgt["dur_s"], float(trace["dur_s"])
                    )
                for span in trace.get("spans", []):
                    span = dict(span)
                    span["instance"] = t.instance
                    span["t_start"] = (
                        float(span.get("t_start", 0.0)) + offset_s
                    )
                    tgt["spans"].append(span)
            self._merge_exemplar_doc(exemplars, doc, t.instance)
        for tgt in merged.values():
            tgt["spans"].sort(key=lambda s: s["t_start"])
        return {
            "traces": merged,
            "exemplars": self._top_exemplars(exemplars),
        }

    @staticmethod
    def _merge_exemplar_doc(
        into: Dict[str, List[Dict[str, Any]]],
        doc: Dict[str, Any],
        instance: str,
    ) -> None:
        for series, obs in (doc.get("exemplars") or {}).items():
            into.setdefault(series, []).extend(
                {**o, "instance": instance} for o in obs
            )

    @staticmethod
    def _top_exemplars(
        ex: Dict[str, List[Dict[str, Any]]]
    ) -> Dict[str, List[Dict[str, Any]]]:
        for obs in ex.values():
            obs.sort(key=lambda o: -float(o.get("value", 0.0)))
            del obs[_EXEMPLAR_TOP_K:]
        return ex

    def fleet_exemplars(self) -> Dict[str, List[Dict[str, Any]]]:
        """Per-series worst offenders fleet-wide, via the EXEMPLARS-ONLY
        /tracez shape (`?exemplars_only=1`): a few KB per target instead
        of every kept trace's span list — the cheap lookup /fleetz
        renders with, leaving the full-trace merge to merged_tracez()
        (/debug/fleet-tracez)."""
        targets = sorted(
            self._targets_fn(),
            key=lambda x: (x.role, x.namespace, x.owner, x.instance),
        )

        def _grab(t: ScrapeTarget):
            try:
                return json.loads(
                    self._fetch(t.base_url + "/tracez?exemplars_only=1")
                )
            except Exception:  # noqa: BLE001 - best effort
                return None

        grabbed: List[Any] = []
        if targets:
            with ThreadPoolExecutor(
                max_workers=min(8, len(targets))
            ) as pool:
                grabbed = list(pool.map(_grab, targets))
        exemplars: Dict[str, List[Dict[str, Any]]] = {}
        for t, doc in zip(targets, grabbed):
            if doc is not None:
                self._merge_exemplar_doc(exemplars, doc, t.instance)
        return self._top_exemplars(exemplars)

    def slo_exemplars(self) -> Dict[str, List[Dict[str, Any]]]:
        """SLO rule name → the fleet's worst-offender exemplars for the
        rule's left-hand metric (merged live off every target's
        exemplars-only /tracez). The link from 'burn rate is high' to
        'here are the exact traces that burned it' — rendered on
        /fleetz next to each SLO row."""
        merged = self.fleet_exemplars()
        out: Dict[str, List[Dict[str, Any]]] = {}
        for status in self.slo_statuses():
            obs = merged.get(status.rule.lhs.metric)
            if obs:
                out[status.rule.name] = obs
        return out

    # -- /fleetz rendering -------------------------------------------------

    def fleetz_lines(self) -> List[str]:
        """The aggregated text snapshot /fleetz serves (observability/
        http.py add_fleet_routes)."""
        with self._lock:
            state = {t: st for t, st in self._state.items()}
            statuses = list(self._slo_statuses)
            stragglers = dict(self._stragglers)
            s_means = dict(self._straggler_means)
            groups = dict(self._group_replicas)
            g429 = dict(self._group_429)
            merged = dict(self._merged)
            sweeps = self._sweeps
        lines = [f"[fleet] sweeps={sweeps} targets={len(state)}"]
        lines.append("")
        lines.append("[targets]")
        for t in sorted(
            state, key=lambda x: (x.role, x.namespace, x.owner, x.instance)
        ):
            st = state[t]
            status = f"ERR {st.error}" if st.error else "ok"
            lines.append(
                f"  {t.role:<9}{t.namespace}/{t.owner:<20}"
                f"{t.instance:<24}{t.base_url:<32}{status}"
            )
        if not state:
            lines.append("  <none>")
        lines.append("")
        lines.append("[serving fleets]")
        served = False
        for (role, ns, owner), n in sorted(groups.items()):
            if role != "serving":
                continue
            served = True
            sig = self.serving_signals(ns, owner)
            if sig is None:
                continue
            lines.append(
                f"  {ns}/{owner}: replicas={n} "
                f"queue={sig.queue_depth:g} "
                f"occupancy={sig.occupancy:.3f} "
                f"slots={sig.num_slots:g} "
                f"429/s={g429.get((role, ns, owner), 0.0):.3f}"
            )
            dsig = self.disagg_signals(ns, owner)
            if dsig is not None and dsig.prefill_replicas > 0:
                ttft = (
                    "n/a" if dsig.ttft_p99_s is None
                    else f"{dsig.ttft_p99_s:.3f}s"
                )
                lines.append(
                    f"    tiers: prefill={dsig.prefill_replicas} "
                    f"ttft_p99={ttft} cold/s={dsig.cold_per_s:.3f} | "
                    f"decode={dsig.decode_replicas} "
                    f"queue={dsig.decode_queue_depth:g} "
                    f"occupancy={dsig.decode_occupancy:.3f}"
                )
        if not served:
            lines.append("  <none>")
        lines.append("")
        lines.append("[slo]")
        # metric→trace exemplars: the fleet's worst offenders for each
        # rule's metric, pulled live off every target's /tracez (best
        # effort — an unreachable fleet still renders the SLO table)
        try:
            slo_exemplars = self.slo_exemplars()
        except Exception:  # noqa: BLE001 - fleetz must render
            slo_exemplars = {}
        for status in statuses:
            r = status.rule
            cur = "n/a" if status.value is None else f"{status.value:.4g}"
            verdict = (
                "unknown" if status.compliant is None
                else ("OK" if status.compliant else "BREACH")
            )
            lines.append(
                f"  {r.name:<32}{r.raw:<44}current={cur:<12}"
                f"{verdict:<8}burn={status.burn_rate:.2f}"
            )
            for ex in slo_exemplars.get(r.name, [])[:3]:
                lines.append(
                    f"    worst: trace {ex.get('trace_id', '?')} "
                    f"({float(ex.get('value', 0.0)):.4g}s "
                    f"on {ex.get('instance', '?')})"
                )
        if not statuses:
            lines.append("  <none>")
        lines.append("")
        lines.append("[stragglers]")
        flagged_any = False
        for (ns, job, host), flagged in sorted(stragglers.items()):
            flagged_any = True
            mean = s_means.get((ns, job, host), 0.0)
            lines.append(
                f"  {ns}/{job:<20}{host:<24}"
                f"step_mean={mean * 1e3:9.1f}ms "
                f"{'STRAGGLER' if flagged else 'ok'}"
            )
        if not flagged_any:
            lines.append("  <none>")
        lines.append("")
        lines.append(
            f"[series] {len(merged)} fleet-aggregated metric families"
        )
        return lines
