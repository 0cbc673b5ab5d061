"""InferenceService controller: model-serving deployments per CR (port of
kubeflow_tpu/controllers/inference.py with its per-tier autoscaler and
its router render).

InferenceService CR → a Deployment of the port's model server (`python -m
kubeflow_tpu_torch.serving.main`) + Service(8500) + VirtualService
/models/<ns>/<name>/, the same reconcile idiom as the JAX controller. The
pod's env is the engine contract: the platform's `ServingConfig` merged
with the CR's `spec.serving`, rendered as KFT_SERVING_*, KFT_TRACE_*,
KFT_FLEET_METRICS_PORT and (armed only) KFT_CHAOS_*, which
serving/main.py `engine_knobs_from_env` reads back.

A replica is one pod. Its serving mesh (`serving.mesh`, tensor · fsdp ·
expert = m cards) runs in that pod on m cards of one node: the pod
requests `nvidia.com/gpu: m`, and serving/main.py starts the m − 1 worker
ranks beside its own. `spec.gpu.topology`, when given, must be `h100-m`.

`serving.autoscale` scales `spec.replicas` on the fleet collector's
signals (observability/fleet.py `serving_signals`, passed in as
`fleet=`): pressure or headroom must hold `breach_cycles` consecutive
fleet sweeps, a resize starts a `cooldown_cycles` quiet period and emits
an `autoscale.resize` trace event and a ScaleUp/ScaleDown event, and the
controller requeues every 5 s while autoscaling is on. A disaggregated
service's prefill tier (`serving.disagg.prefill_replicas`) scales on the
collector's `disagg_signals`: fleet TTFT p99 and the router's cold-prefix
steer rate.

`serving.router.enabled` renders a `<name>-router` Deployment and Service
running `python -m kubeflow_tpu_torch.routing` (routing/) with the
KFT_ROUTER_* contract, its replica registry re-rendered on every
reconcile. The router pod requests no card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from kubeflow_tpu_torch.cluster.objects import (
    new_object,
    set_condition,
    set_owner,
)
from kubeflow_tpu_torch.cluster.reconciler import Controller, Result
from kubeflow_tpu_torch.cluster.store import StateStore
from kubeflow_tpu_torch.config.platform import (
    GPU_RESOURCE,
    ConfigError,
    ServingConfig,
    SliceConfig,
)
from kubeflow_tpu_torch.controllers.statefulset import new_deployment
from kubeflow_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

KIND = "InferenceService"
DEFAULT_IMAGE = "kubeflow-tpu/model-server:latest"
SERVE_PORT = 8500
SERVER_MODULE = "kubeflow_tpu_torch.serving.main"
# the kft-router front door's port and module (routing/__main__.py
# DEFAULT_ROUTER_PORT is the same number)
ROUTER_PORT = 8600
ROUTER_MODULE = "kubeflow_tpu_torch.routing"


def new_inference_service(
    name: str,
    namespace: str = "default",
    model: str = "",
    checkpoint_dir: str = "",
    gpu_topology: str = "",
    replicas: int = 1,
    image: str = DEFAULT_IMAGE,
    serving: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    return new_object(
        KIND,
        name,
        namespace,
        spec={
            "model": model,
            "checkpointDir": checkpoint_dir,
            # an H100 topology of config/platform.py GPU_TOPOLOGIES
            "gpu": {"topology": gpu_topology} if gpu_topology else {},
            "replicas": replicas,
            "image": image,
            # decode-engine knob overrides (ServingConfig field names);
            # absent keys fall back to the platform defaults
            "serving": dict(serving or {}),
        },
    )


@dataclasses.dataclass
class _ScaleState:
    """A service tier's autoscaler hysteresis: how many consecutive fleet
    SWEEPS the pressure/headroom signal has held, and the post-resize
    cooldown countdown (also in sweeps)."""

    up_streak: int = 0
    down_streak: int = 0
    cooldown: int = 0
    last_sweep: int = -1  # collector sweep id last counted


class InferenceServiceController(Controller):
    kind = KIND
    name = "inference-controller"

    def __init__(
        self,
        use_istio: bool = True,
        istio_gateway: str = "kubeflow/kubeflow-gateway",
        serving_defaults: Optional[ServingConfig] = None,
        fleet=None,
    ) -> None:
        super().__init__()
        self.use_istio = use_istio
        self.istio_gateway = istio_gateway
        # platform-wide engine defaults; per-CR spec.serving keys
        # override field by field
        self.serving_defaults = serving_defaults or ServingConfig()
        # the fleet collector (observability/fleet.py FleetCollector, or
        # anything with its serving_signals(ns, name) shape): the
        # autoscaler's only input. None = autoscaling inert even when a
        # CR asks for it (no signals, no decisions).
        self.fleet = fleet
        self._scale_state: Dict[Tuple[str, str, str], _ScaleState] = {}
        self.watches = {"Deployment": self.map_owned}

    def _serving_env(
        self, spec: Dict[str, Any], cfg: Optional[ServingConfig] = None
    ) -> Dict[str, str]:
        """The engine contract rendered into every serving pod, read by
        serving/main.py `engine_knobs_from_env`. Always rendered, also at
        defaults: the pod's env documents the engine it runs."""
        if cfg is None:
            cfg = self._serving_cfg(spec)
        obs = cfg.observability
        env = {
            "KFT_SERVING_NUM_SLOTS": str(cfg.num_slots),
            "KFT_SERVING_MAX_QUEUE": str(cfg.max_queue),
            "KFT_SERVING_PREFILL_BUCKETS": ",".join(
                str(b) for b in cfg.prefill_buckets
            ),
            # paged-KV pool + radix prefix cache (serving/engine.py)
            "KFT_SERVING_PAGE_SIZE": str(cfg.page_size),
            "KFT_SERVING_NUM_PAGES": str(cfg.num_pages),
            "KFT_SERVING_PREFIX_CACHE": "1" if cfg.prefix_cache else "0",
            # tiered KV (serving/kv_tiers.py)
            "KFT_SERVING_KV_HOST_BYTES": str(cfg.kv_host_bytes),
            "KFT_SERVING_KV_PERSIST_DIR": cfg.kv_persist_dir,
            "KFT_SERVING_KV_PERSIST_INTERVAL_S": (
                f"{cfg.kv_persist_interval_s:g}"
            ),
            "KFT_SERVING_KV_PERSIST_CHAINS": str(cfg.kv_persist_chains),
            # decode read path (gather | kernel) and int8 quantization
            "KFT_SERVING_PAGED_ATTENTION": cfg.paged_attention,
            "KFT_SERVING_QUANTIZE": cfg.quantize,
            **cfg.mesh.env(),
            "KFT_SERVING_DRAFT_MODEL": cfg.draft_model,
            "KFT_SERVING_DRAFT_TOKENS": str(cfg.num_draft_tokens),
            "KFT_SERVING_DRAFT_CHECKPOINT_DIR": cfg.draft_checkpoint_dir,
            # the SIGTERM drain budget (serving/main.py)
            "KFT_SERVING_DRAIN_DEADLINE_S": f"{cfg.drain_deadline_s:g}",
            # kft-trace (observability/trace.py knobs_from_env)
            "KFT_TRACE_ENABLED": "1" if obs.trace_enabled else "0",
            "KFT_TRACE_BUFFER_SPANS": str(obs.trace_buffer_spans),
            "KFT_TRACE_STATUSZ": "1" if obs.statusz_enabled else "0",
            "KFT_TRACE_SAMPLE_PROB": f"{obs.trace_sample_prob:g}",
            "KFT_TRACE_SAMPLE_KEEP": str(obs.trace_sample_keep),
        }
        if obs.statusz_enabled:
            # the fleet collector scrapes /metrics on the serving port; a
            # statusz-off replica mounts no /statusz, so it advertises none
            env["KFT_FLEET_METRICS_PORT"] = str(SERVE_PORT)
        if cfg.chaos.enabled and cfg.chaos.points:
            # rendered only when armed: a chaos-off pod carries no plan
            env["KFT_CHAOS_POINTS"] = ";".join(cfg.chaos.points)
            env["KFT_CHAOS_SEED"] = str(cfg.chaos.seed)
        return env

    def _serving_cfg(self, spec: Dict[str, Any]) -> ServingConfig:
        """Platform defaults merged with the CR's spec.serving overrides;
        the subtrees merge field by field, so a CR overriding one knob
        keeps its siblings at the platform's values."""
        merged = {
            f.name: getattr(self.serving_defaults, f.name)
            for f in dataclasses.fields(ServingConfig)
        }
        merged["prefill_buckets"] = list(merged["prefill_buckets"])
        subtrees = ("mesh", "observability", "autoscale", "router", "disagg",
                    "chaos")
        for subtree in subtrees:
            merged[subtree] = dataclasses.asdict(merged[subtree])
        overrides = dict(spec.get("serving") or {})
        for subtree in subtrees:
            merged[subtree].update(overrides.pop(subtree, None) or {})
        merged.update(overrides)
        return ServingConfig.from_dict(merged)

    def _pop_scale_state(self, namespace: str, name: str) -> None:
        """Drop every tier's hysteresis entry of one service."""
        for key in [k for k in self._scale_state
                    if (k[0], k[1]) == (namespace, name)]:
            del self._scale_state[key]

    def _sweep_scale_state(self, store: StateStore) -> None:
        """Drop the hysteresis entries of services that are gone. A CR
        that vanished without its own reconcile (a store wiped in bulk,
        a controller pointed at a rebuilt store) must not leave a
        cooldown or a streak that a recreated same-name service would
        inherit."""
        if not self._scale_state:
            return
        live = {
            (
                o.get("metadata", {}).get("namespace", "default"),
                o.get("metadata", {}).get("name", ""),
            )
            for o in store.list(KIND)
            if not o.get("metadata", {}).get("deletionTimestamp")
        }
        for key in list(self._scale_state):
            if (key[0], key[1]) not in live:
                del self._scale_state[key]

    @staticmethod
    def _hysteresis(
        st: _ScaleState,
        fresh: bool,
        outage: bool,
        pressure: bool,
        headroom: bool,
        breach_cycles: int,
        cooldown_cycles: int,
        desired: int,
        lo: int,
        hi: int,
    ) -> Tuple[int, str]:
        """One hysteresis step for one tier: advance the streaks on a
        fresh observation and emit at most a one-replica move. On a
        signal outage the streaks RESET rather than freeze: hysteresis
        promises CONSECUTIVE observations, and a stale pre-outage streak
        must not let one post-recovery reading trigger a resize."""
        reason = "Clamp"
        if not fresh:
            return desired, reason
        if st.cooldown > 0:
            st.cooldown -= 1
            return desired, reason
        if outage:
            st.up_streak = st.down_streak = 0
            return desired, reason
        st.up_streak = st.up_streak + 1 if pressure else 0
        st.down_streak = st.down_streak + 1 if headroom else 0
        if st.up_streak >= breach_cycles and desired < hi:
            desired += 1
            reason = "ScaleUp"
        elif st.down_streak >= breach_cycles and desired > lo:
            desired -= 1
            reason = "ScaleDown"
        if reason in ("ScaleUp", "ScaleDown"):
            st.up_streak = st.down_streak = 0
            st.cooldown = cooldown_cycles
        return desired, reason

    def _maybe_autoscale(
        self,
        store: StateStore,
        svc_cr: Dict[str, Any],
        namespace: str,
        name: str,
        cfg_serving: ServingConfig,
    ) -> bool:
        """Signal-driven replica autoscaling, a tier at a time: the decode
        tier (`spec.replicas`) on the fleet collector's queue, occupancy
        and 429 signals; a disaggregated service's prefill tier
        (`serving.disagg.prefill_replicas`) on fleet TTFT p99 and the
        router's cold-prefix steer rate. Each tier keeps its own
        (namespace, name, tier) hysteresis entry. Returns True while
        autoscaling is active, so the caller keeps requeueing and the
        signals are polled again."""
        if not cfg_serving.autoscale.enabled or self.fleet is None:
            self._pop_scale_state(namespace, name)
            return False
        self._autoscale_decode(store, svc_cr, namespace, name, cfg_serving)
        if cfg_serving.disagg.enabled:
            self._autoscale_prefill(
                store, svc_cr, namespace, name, cfg_serving
            )
        return True

    def _autoscale_decode(
        self,
        store: StateStore,
        svc_cr: Dict[str, Any],
        namespace: str,
        name: str,
        cfg_serving: ServingConfig,
    ) -> None:
        spec = svc_cr.get("spec", {})
        cfg = cfg_serving.autoscale
        st = self._scale_state.setdefault(
            (namespace, name, "decode"), _ScaleState()
        )
        current = int(spec.get("replicas", 1))
        # the min/max clamp applies even before any signal arrives
        desired = min(max(current, cfg.min_replicas), cfg.max_replicas)
        sig = self.fleet.serving_signals(namespace, name)
        # a disaggregated fleet's decode decision reads the decode
        # tier's queue and occupancy (idle prefill slots must not drag
        # the mean down and mask decode pressure); the 429 rate stays
        # fleet-wide: a prefill-tier 429 still refuses arrivals
        dsig = None
        if cfg_serving.disagg.enabled:
            src = getattr(self.fleet, "disagg_signals", None)
            dsig = src(namespace, name) if callable(src) else None
        # hysteresis counts fleet SWEEPS, not reconciles: the controller
        # also reconciles on watch events and its 5 s requeue, and
        # re-reading one sweep's snapshot must not fake "consecutive"
        # observations (sweep < 0 = an untracked source, every read
        # counts: the test fakes)
        fresh = True
        if sig is not None and sig.sweep >= 0:
            fresh = sig.sweep != st.last_sweep
            st.last_sweep = sig.sweep
        pressure = headroom = False
        if sig is not None:
            queue, slots, occ = sig.queue_depth, sig.num_slots, sig.occupancy
            if dsig is not None and dsig.decode_replicas > 0:
                queue = dsig.decode_queue_depth
                slots = dsig.decode_num_slots
                occ = dsig.decode_occupancy
            if slots > 0:
                q_per_slot = queue / slots
            else:
                q_per_slot = 1.0 if queue > 0 else 0.0
            pressure = (
                occ >= cfg.scale_up_occupancy
                or q_per_slot >= cfg.scale_up_queue_per_slot
                or sig.rate_429_per_s > 0
            )
            headroom = (
                occ <= cfg.scale_down_occupancy
                and queue == 0
                and sig.rate_429_per_s == 0
            )
        desired, reason = self._hysteresis(
            st, fresh, sig is None, pressure, headroom,
            cfg.breach_cycles, cfg.cooldown_cycles,
            desired, cfg.min_replicas, cfg.max_replicas,
        )
        if desired != current:
            from kubeflow_tpu_torch.observability.trace import default_tracer

            detail = (
                f"replicas {current} -> {desired} "
                f"(occupancy={getattr(sig, 'occupancy', None)}, "
                f"queue={getattr(sig, 'queue_depth', None)}, "
                f"429/s={getattr(sig, 'rate_429_per_s', None)})"
            )
            if reason == "ScaleDown":
                # the condemned replica drains before it dies: SIGTERM →
                # ModelServer.close(drain=True) inside the grace period
                # (serving/main.py). On a disaggregated fleet the router
                # also asks the drainer to hand its hottest committed
                # chains to the surviving rendezvous homes inside that
                # window (routing/router.py _note_draining →
                # /v1/kv/handoff)
                detail += (
                    f"; replica drains in-flight requests for up to "
                    f"{cfg_serving.drain_deadline_s:g}s before exit"
                )
            default_tracer().event(
                "autoscale.resize",
                service=f"{namespace}/{name}",
                reason=reason,
                replicas_from=current,
                replicas_to=desired,
            )
            log.info("autoscale %s/%s: %s %s", namespace, name, reason, detail)
            spec["replicas"] = desired
            svc_cr["spec"] = spec
            store.update(svc_cr)
            store.record_event(svc_cr, reason, detail)

    def _autoscale_prefill(
        self,
        store: StateStore,
        svc_cr: Dict[str, Any],
        namespace: str,
        name: str,
        cfg_serving: ServingConfig,
    ) -> None:
        """The prefill tier's policy (serving.disagg): fleet TTFT p99 at
        or over `scale_up_ttft_p99_s`, or the router's cold-prefix steer
        rate at or over `scale_up_cold_per_s`, is pressure; both at or
        under half their threshold is headroom. Needs the collector's
        tier-aware `disagg_signals`: against a source without it the
        prefill count stays where the spec put it."""
        src = getattr(self.fleet, "disagg_signals", None)
        if not callable(src):
            return
        sig = src(namespace, name)
        spec = svc_cr.get("spec", {})
        cfg = cfg_serving.autoscale
        dcfg = cfg_serving.disagg
        st = self._scale_state.setdefault(
            (namespace, name, "prefill"), _ScaleState()
        )
        current = int(dcfg.prefill_replicas)
        desired = min(
            max(current, dcfg.min_prefill_replicas),
            dcfg.max_prefill_replicas,
        )
        fresh = True
        if sig is not None and sig.sweep >= 0:
            fresh = sig.sweep != st.last_sweep
            st.last_sweep = sig.sweep
        pressure = headroom = False
        if sig is not None:
            slow = (
                sig.ttft_p99_s is not None
                and sig.ttft_p99_s >= dcfg.scale_up_ttft_p99_s
            )
            pressure = slow or sig.cold_per_s >= dcfg.scale_up_cold_per_s
            headroom = (
                (
                    sig.ttft_p99_s is None
                    or sig.ttft_p99_s <= dcfg.scale_up_ttft_p99_s / 2
                )
                and sig.cold_per_s <= dcfg.scale_up_cold_per_s / 2
            )
        desired, reason = self._hysteresis(
            st, fresh, sig is None, pressure, headroom,
            cfg.breach_cycles, cfg.cooldown_cycles,
            desired, dcfg.min_prefill_replicas, dcfg.max_prefill_replicas,
        )
        if desired != current:
            from kubeflow_tpu_torch.observability.trace import default_tracer

            serving = dict(spec.get("serving") or {})
            disagg = dict(serving.get("disagg") or {})
            disagg["prefill_replicas"] = desired
            serving["disagg"] = disagg
            spec["serving"] = serving
            svc_cr["spec"] = spec
            # the caller's merged cfg sizes this reconcile's Deployments,
            # so the resize lands there too, not only in the spec the
            # next reconcile reads
            cfg_serving.disagg.prefill_replicas = desired
            detail = (
                f"prefill replicas {current} -> {desired} "
                f"(ttft_p99={getattr(sig, 'ttft_p99_s', None)}, "
                f"cold/s={getattr(sig, 'cold_per_s', None)})"
            )
            default_tracer().event(
                "autoscale.resize",
                service=f"{namespace}/{name}",
                reason=reason,
                tier="prefill",
                replicas_from=current,
                replicas_to=desired,
            )
            log.info("autoscale %s/%s: %s %s", namespace, name, reason, detail)
            store.update(svc_cr)
            store.record_event(svc_cr, reason, detail)

    def _reconcile_router(
        self,
        store: StateStore,
        svc_cr: Dict[str, Any],
        namespace: str,
        name: str,
        spec: Dict[str, Any],
        cfg: ServingConfig,
    ) -> None:
        """The kft-router front door (routing/): with
        serving.router.enabled, a `<name>-router` Deployment and Service
        run `python -m kubeflow_tpu_torch.routing` with the KFT_ROUTER_*
        contract. The replica registry is re-rendered on every reconcile
        from the replica counts (the workload controller's stable
        `<name>-<i>` pod names), so a scale event updates the router's
        fleet in the pass that resizes the Deployment. Disabled = a
        router rendered earlier is torn down. The pod requests no card:
        the router is host code."""
        router_name = f"{name}-router"
        if not cfg.router.enabled:
            for kind in ("Deployment", "Service"):
                try:
                    store.delete(kind, router_name, namespace)
                except KeyError:
                    pass
            return
        replicas = int(spec.get("replicas", 1))
        if cfg.disagg.enabled:
            # entries carry tier roles as `id=url#role`
            # (routing/__main__.py parse_replicas)
            entries = [
                f"{name}-{i}=http://{name}-{i}:{SERVE_PORT}#decode"
                for i in range(replicas)
            ]
            entries.extend(
                f"{name}-prefill-{i}="
                f"http://{name}-prefill-{i}:{SERVE_PORT}#prefill"
                for i in range(int(cfg.disagg.prefill_replicas))
            )
            registry = ",".join(entries)
        else:
            registry = ",".join(
                f"{name}-{i}=http://{name}-{i}:{SERVE_PORT}"
                for i in range(replicas)
            )
        env = {
            "KFT_ROUTER_AFFINITY": "1" if cfg.router.affinity else "0",
            # the affinity hash granularity is the replicas' page size
            "KFT_ROUTER_PAGE_SIZE": str(cfg.page_size),
            "KFT_ROUTER_SPILL_QUEUE_PER_SLOT": (
                f"{cfg.router.spill_queue_per_slot:g}"
            ),
            "KFT_ROUTER_RETRY_BUDGET": str(cfg.router.retry_budget),
            # the in-flight spill signal's denominator: the replicas'
            # slot capacity
            "KFT_ROUTER_REPLICA_SLOTS": str(cfg.num_slots),
            "KFT_ROUTER_REPLICAS": registry,
        }
        if cfg.disagg.enabled:
            env["KFT_ROUTER_DISAGG"] = "1"
            env["KFT_ROUTER_DISAGG_COLD_HIT_RATE"] = (
                f"{cfg.disagg.cold_hit_rate:g}"
            )
            env["KFT_SERVING_DISAGG_HANDOFF_CHAINS"] = str(
                cfg.disagg.handoff_chains
            )
        if cfg.observability.statusz_enabled:
            # the fleet collector scrapes router_* off the router's
            # /metrics; the pod carries no `inferenceservice` label, so
            # it never counts as a replica or joins the Service
            env["KFT_FLEET_METRICS_PORT"] = str(ROUTER_PORT)
        container = {
            "name": "router",
            "image": spec.get("image", DEFAULT_IMAGE),
            "command": [
                "python",
                "-m",
                ROUTER_MODULE,
                "--service", f"{namespace}/{name}",
                "--port", str(ROUTER_PORT),
            ],
            "ports": [{"containerPort": ROUTER_PORT}],
            "env": [
                {"name": k, "value": v} for k, v in sorted(env.items())
            ],
            "readinessProbe": {
                "httpGet": {"path": "/healthz", "port": ROUTER_PORT},
                "periodSeconds": 5,
            },
        }
        dep = new_deployment(
            router_name,
            namespace,
            1,
            {"containers": [container]},
            labels={"app": "kft-router", "inferenceservice-router": name},
        )
        set_owner(dep, svc_cr)
        store.apply(dep)
        svc = new_object(
            "Service",
            router_name,
            namespace,
            api_version="v1",
            spec={
                "selector": {"inferenceservice-router": name},
                "ports": [
                    {"port": ROUTER_PORT, "targetPort": ROUTER_PORT}
                ],
            },
        )
        set_owner(svc, svc_cr)
        store.apply(svc)

    @staticmethod
    def _gpu_request(spec: Dict[str, Any], cfg: ServingConfig):
        """(resource limits, node selector) of a replica's pod, or None
        without a topology: `nvidia.com/gpu` = the serving mesh's cards,
        which `spec.gpu.topology` must name."""
        topology = (spec.get("gpu") or {}).get("topology", "")
        if not topology:
            return None
        slice_cfg = SliceConfig.from_dict({"topology": topology})
        cards = cfg.mesh.num_devices
        if slice_cfg.total_chips != cards:
            raise ConfigError(
                f"spec.gpu.topology {topology} has {slice_cfg.total_chips} "
                f"card(s), but serving.mesh (tensor·fsdp·expert) runs a "
                f"replica on {cards}: name h100-{cards}")
        return {GPU_RESOURCE: str(cards)}, slice_cfg.node_selectors()

    def reconcile(self, store: StateStore, namespace: str, name: str) -> Result:
        svc_cr = store.try_get(KIND, name, namespace)
        # hysteresis state of services that no longer exist must not leak
        # into a later same-name service: swept against the live CRs
        self._sweep_scale_state(store)
        if svc_cr is None or svc_cr["metadata"].get("deletionTimestamp"):
            self._pop_scale_state(namespace, name)
            return Result()
        spec = svc_cr.get("spec", {})
        serving_cfg = self._serving_cfg(spec)
        gpu = self._gpu_request(spec, serving_cfg)
        autoscaling = self._maybe_autoscale(
            store, svc_cr, namespace, name, serving_cfg
        )

        container: Dict[str, Any] = {
            "name": "model-server",
            "image": spec.get("image", DEFAULT_IMAGE),
            "command": [
                "python",
                "-m",
                SERVER_MODULE,
                "--model", spec.get("model", ""),
                "--checkpoint-dir", spec.get("checkpointDir", ""),
                "--port", str(SERVE_PORT),
            ],
            "ports": [{"containerPort": SERVE_PORT}],
            "env": [
                {"name": k, "value": v}
                for k, v in sorted(
                    self._serving_env(spec, serving_cfg).items()
                )
            ],
            # /healthz answers 503 + {"draining": true} while a drain
            # runs: the replica leaves the Service endpoints alive
            "readinessProbe": {
                "httpGet": {"path": "/healthz", "port": SERVE_PORT},
                "periodSeconds": 5,
            },
        }
        # the grace period covers the worst-case shutdown: the SIGTERM
        # poll (1 s), the drain deadline, and the engine's close after it
        pod_spec: Dict[str, Any] = {
            "containers": [container],
            "terminationGracePeriodSeconds": int(
                serving_cfg.drain_deadline_s
            ) + 30,
        }
        if gpu is not None:
            container["resources"] = {"limits": gpu[0]}
            pod_spec["nodeSelector"] = gpu[1]

        disagg = serving_cfg.disagg.enabled
        labels = {"app": "model-server", "inferenceservice": name}
        if disagg:
            # the tier label is the role contract a steering client reads
            labels["inferenceservice-tier"] = "decode"
        dep = new_deployment(
            name,
            namespace,
            int(spec.get("replicas", 1)),
            pod_spec,
            labels=labels,
        )
        set_owner(dep, svc_cr)
        store.apply(dep)

        prefill_name = f"{name}-prefill"
        if disagg:
            # the prefill tier: the same image and engine contract (the
            # pages it ships must be bitwise the decode tier's), its own
            # Deployment so the tiers scale apart
            prefill_dep = new_deployment(
                prefill_name,
                namespace,
                int(serving_cfg.disagg.prefill_replicas),
                pod_spec,
                labels={
                    "app": "model-server",
                    "inferenceservice": name,
                    "inferenceservice-tier": "prefill",
                },
            )
            set_owner(prefill_dep, svc_cr)
            store.apply(prefill_dep)
        else:
            try:
                store.delete("Deployment", prefill_name, namespace)
            except KeyError:
                pass

        selector = {"inferenceservice": name}
        if disagg:
            # the Service VIP fronts decode capacity only: prefill pods
            # answer :prefill at their stable pod addresses
            selector["inferenceservice-tier"] = "decode"
        svc = new_object(
            "Service",
            name,
            namespace,
            api_version="v1",
            spec={
                "selector": selector,
                "ports": [{"port": SERVE_PORT, "targetPort": SERVE_PORT}],
            },
        )
        set_owner(svc, svc_cr)
        store.apply(svc)

        self._reconcile_router(store, svc_cr, namespace, name, spec, serving_cfg)

        if self.use_istio:
            vs = new_object(
                "VirtualService",
                f"inference-{namespace}-{name}",
                namespace,
                api_version="networking.istio.io/v1alpha3",
                spec={
                    "hosts": ["*"],
                    "gateways": [self.istio_gateway],
                    "http": [
                        {
                            "match": [
                                {"uri": {"prefix": f"/models/{namespace}/{name}/"}}
                            ],
                            "rewrite": {"uri": "/"},
                            "route": [
                                {
                                    "destination": {
                                        "host": f"{name}.{namespace}.svc.cluster.local",
                                        "port": {"number": SERVE_PORT},
                                    }
                                }
                            ],
                        }
                    ],
                },
            )
            set_owner(vs, svc_cr)
            store.apply(vs)

        ready = (
            store.try_get("Deployment", name, namespace) or {}
        ).get("status", {}).get("readyReplicas", 0)
        changed = set_condition(
            svc_cr,
            "Ready",
            "True" if ready >= int(spec.get("replicas", 1)) else "False",
            "Available" if ready else "Pending",
        )
        if changed:
            store.patch_status(KIND, name, namespace, svc_cr["status"])
        # an autoscaling service re-polls its fleet signals even with no
        # cluster writes pending (each poll is one hysteresis cycle);
        # everything else stays event-driven
        return Result(requeue_after_s=5.0) if autoscaling else Result()
