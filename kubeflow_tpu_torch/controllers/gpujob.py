"""GPUTrainJob controller — the gang-scheduled training-job reconciler of
the port (the counterpart of kubeflow_tpu/controllers/tpujob.py, with the
same semantics on H100 gangs):

- **all-or-nothing gang creation**: one pod per card (the port runs one
  process a rank), created atomically per reconcile pass — if any creation
  fails, the partial gang is torn down (no half-placed gang holding cards),
- **GPU vocabulary**: `nvidia.com/gpu: "1"` a pod and the
  `cloud.google.com/gke-accelerator: nvidia-h100-80gb` node selector from
  SliceConfig (config/platform.py GPU_TOPOLOGIES: h100-1 ... h100-64),
- **torch.distributed env rendering**: coordinator address / process id /
  slice id per pod (parallel/distributed.py render_gang_env), read by
  `python -m kubeflow_tpu_torch.runtime.launcher` in the pod,
- **whole-gang restart with checkpoint resume**: any pod failure fails the
  gang; the gang is deleted and recreated (bounded by maxRestarts) with
  KFT_RESTORE_DIR pointing at the job's checkpoint directory,
- **elastic resume** down the H100 ladder (data axes shrink first, the
  expert axis never), the fleet straggler relay, `cleanPodPolicy`,
  `activeDeadlineSeconds` and the finalizer,
- **status conditions** (Created/Running/Restarting/Degraded/Succeeded/
  Failed), as the JAX controller sets them.

The JAX controller starts each pod under `slice_agent` (a TPU device gate
and gang barrier); the port's pods run the launcher directly, and the
rendezvous of `torch.distributed.init_process_group` is the barrier.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional, Tuple

from kubeflow_tpu_torch.cluster.objects import (
    new_object,
    now_iso,
    set_condition,
    set_owner,
)
from kubeflow_tpu_torch.cluster.reconciler import Controller, Result
from kubeflow_tpu_torch.cluster.store import AlreadyExists, StateStore
from kubeflow_tpu_torch.config.platform import (
    GPU_TOPOLOGIES,
    ChaosConfig,
    ConfigError,
    ObservabilityConfig,
    SliceConfig,
    TrainingConfig,
)
from kubeflow_tpu_torch.controllers.helpers import (
    ensure_finalizer,
    list_owned,
    remove_finalizer,
)
from kubeflow_tpu_torch.parallel.distributed import (
    DEFAULT_COORDINATOR_PORT,
    render_gang_env,
)
from kubeflow_tpu_torch.utils.logging import get_logger
from kubeflow_tpu_torch.utils.metrics import default_registry

# the runtime debug server (statusz/trace/metrics, runtime/launcher.py)
DEBUG_PORT = 9432

log = get_logger(__name__)

KIND = "GPUTrainJob"
FINALIZER = "kubeflow-tpu.dev/gang-cleanup"
JOB_NAME_LABEL = "kubeflow-tpu.dev/job-name"
REPLICA_INDEX_LABEL = "kubeflow-tpu.dev/replica-index"
DEFAULT_IMAGE = "kubeflow-tpu/trainer-gpu:latest"
LAUNCHER = ["python", "-m", "kubeflow_tpu_torch.runtime.launcher"]

# Condition types (the contract tests/UIs poll).
COND_CREATED = "Created"
COND_RUNNING = "Running"
COND_RESTARTING = "Restarting"
COND_DEGRADED = "Degraded"
COND_SUCCEEDED = "Succeeded"
COND_FAILED = "Failed"

TERMINAL_CONDITIONS = (COND_SUCCEEDED, COND_FAILED)

# How many consecutive fleet sweeps a host must stay flagged by the
# straggler detector (observability/fleet.py fleet_straggler) before the
# controller treats it as conclusively sick and reshapes the gang off it.
# Counted in SWEEPS, not reconciles — watch-event reconciles re-reading
# one sweep's snapshot cannot fake persistence (the autoscaler's
# hysteresis discipline).
STRAGGLER_TRIP_SWEEPS = 3

# Degraded-reshape axis policy: only the pure data-parallel axes shrink.
# Halving data (or fsdp) changes WHERE batch rows land, never the model's
# parameter structure — so the checkpoint subsystem's resharding restore
# stays bitwise. tensor/pipeline/sequence/expert stay untouched: shrinking
# them would change the model partitioning itself (pipeline_stages is a
# model-construction knob), which is a migration, not a degradation.
# An fsdp leaf's blocks are regions of the whole leaf in a checkpoint, so
# a gang reshaped to a smaller fsdp axis reads its new blocks back.
_SHRINK_AXES = ("data", "fsdp")


def shrink_mesh(
    axes: Dict[str, int], factor: int
) -> Optional[Dict[str, int]]:
    """Shrink the mesh's chip product by `factor` (a power of two) by
    repeatedly halving the data-parallel axes (data first, then fsdp).
    Returns the new axis map, or None when those axes cannot absorb the
    reduction. global_batch_size divisibility survives by construction:
    a batch divisible by data*fsdp is divisible by any halving of it."""
    if factor < 1 or factor & (factor - 1):
        return None
    out = dict(axes)
    remaining = factor
    while remaining > 1:
        for a in _SHRINK_AXES:
            if out.get(a, 1) % 2 == 0:
                out[a] //= 2
                remaining //= 2
                break
        else:
            return None
    # Postcondition, asserted rather than implied by the loop above: the
    # model-partitioning axes come out exactly as they went in. The
    # expert axis carries the sharpest version of the contract (r20): a
    # MoE gang's [E, ...] expert stacks are sharded along it in training
    # AND serving, and a degraded reshape that halved it would change
    # how experts map to cards mid-job — a repartition the resharding
    # restore cannot make bitwise.
    assert all(
        out.get(a, 1) == size
        for a, size in axes.items()
        if a not in _SHRINK_AXES
    ), f"degraded reshape touched a non-data axis: {axes} -> {out}"
    return out


def plan_degraded_reshape(
    slice_cfg: SliceConfig, training: TrainingConfig
) -> Optional[Tuple[Dict[str, Any], Dict[str, int]]]:
    """The largest valid smaller gang shape for a job that lost a host:
    multislice jobs try dropping one slice first (the lost host's slice
    — same topology, one fewer DCN member), but that candidate is valid
    only when the remaining chips divide the old count by a power of
    two (`shrink_mesh` halves axes), i.e. 2 -> 1 slices; other slice
    counts fall through to the same path single-slice jobs take — the
    largest same-generation topology with fewer chips, keeping the
    slice count. The mesh shrinks data-first by the chip ratio
    (`shrink_mesh`). Returns
    ({"topology", "num_slices"}, mesh_axes) or None when no smaller
    shape can hold the job (data axes exhausted, or no smaller
    topology exists in the generation)."""
    candidates: List[Tuple[str, int]] = []
    if slice_cfg.num_slices > 1:
        candidates.append((slice_cfg.topology, slice_cfg.num_slices - 1))
    gen = slice_cfg.topology.split("-")[0]
    same_gen = sorted(
        (
            (name, cards)
            for name, cards in GPU_TOPOLOGIES.items()
            if name.split("-")[0] == gen
            and cards < slice_cfg.chips_per_slice
        ),
        key=lambda kv: kv[1],
        reverse=True,
    )
    candidates.extend((name, slice_cfg.num_slices) for name, _ in same_gen)
    old_chips = slice_cfg.total_chips
    axes = training.mesh.axis_sizes()
    for topology, num_slices in candidates:
        new_chips = GPU_TOPOLOGIES[topology] * num_slices
        if new_chips >= old_chips or old_chips % new_chips:
            continue
        mesh = shrink_mesh(axes, old_chips // new_chips)
        if mesh is None:
            continue
        return {"topology": topology, "num_slices": num_slices}, mesh
    return None

# Pod phases (mirrors k8s).
PENDING, RUNNING, SUCCEEDED, FAILED = "Pending", "Running", "Succeeded", "Failed"


def new_gpu_train_job(
    name: str,
    namespace: str = "default",
    training: Optional[Dict[str, Any]] = None,
    slice_spec: Optional[Dict[str, Any]] = None,
    max_restarts: int = 3,
    image: str = DEFAULT_IMAGE,
    active_deadline_seconds: Optional[float] = None,
    clean_pod_policy: str = "None",
    elastic_resume: bool = True,
) -> Dict[str, Any]:
    """Spec constructor (the create_job_specs.py equivalent, mesh-first).

    `elastic_resume` (runPolicy.elasticResume, default on): a gang that
    conclusively lost a host reshapes to the largest valid smaller
    topology and resumes from the last committed checkpoint instead of
    failing terminally (docs/ROBUSTNESS.md). Off restores strict
    fail-fast: budget exhaustion is always BackoffLimitExceeded —
    the contract for operators whose automation resubmits on Failed."""
    return new_object(
        KIND,
        name,
        namespace,
        spec={
            "image": image,
            "slice": dict(slice_spec or {}),
            "training": dict(training or {}),
            "runPolicy": {
                "maxRestarts": max_restarts,
                "activeDeadlineSeconds": active_deadline_seconds,
                "cleanPodPolicy": clean_pod_policy,
                "elasticResume": elastic_resume,
            },
        },
    )


def parse_job_spec(spec: Dict[str, Any]):
    """Validate + hydrate the typed configs embedded in a job spec."""
    slice_cfg = SliceConfig.from_dict(spec.get("slice") or {})
    training = TrainingConfig.from_dict(spec.get("training") or {})
    if training.mesh.num_devices != slice_cfg.total_chips:
        raise ConfigError(
            f"mesh needs {training.mesh.num_devices} cards but slice "
            f"{slice_cfg.topology} x{slice_cfg.num_slices} provides "
            f"{slice_cfg.total_chips}"
        )
    return slice_cfg, training


def gang_pod_names(job_name: str, total_hosts: int) -> List[str]:
    return [f"{job_name}-worker-{i}" for i in range(total_hosts)]


def gang_hostnames(job_name: str, namespace: str, total_hosts: int) -> List[str]:
    # Stable headless-service pod DNS, the k8s idiom for per-pod addresses.
    svc = f"{job_name}-gang"
    return [
        f"{job_name}-worker-{i}.{svc}.{namespace}.svc"
        for i in range(total_hosts)
    ]


class GPUTrainJobController(Controller):
    kind = KIND
    name = "gpujob-controller"

    def __init__(self, fleet=None) -> None:
        super().__init__()
        self.watches = {"Pod": self.map_owned}
        # the fleet collector (observability/fleet.py FleetCollector, or
        # anything with its stragglers()/sweeps() shape): the straggler-
        # trip → degraded-reshape relay's only input. None = reshape
        # still triggers on restart-budget exhaustion, never proactively.
        self.fleet = fleet
        # (ns, job, host) → consecutive flagged sweeps; (ns, job) → last
        # counted sweep id (re-reading one sweep must not double-count)
        self._straggler_strikes: Dict[Tuple[str, str, str], int] = {}
        self._straggler_sweep: Dict[Tuple[str, str], int] = {}
        reg = default_registry()
        self._jobs_total = reg.counter(
            "gpujob_total", "job terminal outcomes", ["outcome"]
        )
        self._restarts_total = reg.counter(
            "gpujob_gang_restarts_total", "whole-gang restarts", []
        )
        self._reshapes_total = reg.counter(
            "gpujob_gang_reshapes_total",
            "degraded-mesh gang reshapes (elastic resume on fewer cards)",
            [],
        )
        self._running = reg.gauge("gpujob_running", "jobs currently running", [])
        # (ns, job) gangs currently in the Running condition — the gauge's
        # backing set (a reconcile sees one job; the gauge is fleet-wide)
        self._running_jobs: set = set()

    def _set_running(self, job: Dict[str, Any], running: bool) -> None:
        m = job["metadata"]
        key = (m["namespace"], m["name"])
        if running:
            self._running_jobs.add(key)
        else:
            self._running_jobs.discard(key)
        self._running.set(float(len(self._running_jobs)))

    # -- reconcile --------------------------------------------------------

    def reconcile(self, store: StateStore, namespace: str, name: str) -> Result:
        job = store.try_get(KIND, name, namespace)
        if job is None:
            return Result()

        if job["metadata"].get("deletionTimestamp"):
            return self._handle_deletion(store, job)

        if ensure_finalizer(job, FINALIZER):
            job = store.update(job)

        status = job.setdefault("status", {})
        if any(
            c.get("type") in TERMINAL_CONDITIONS and c.get("status") == "True"
            for c in status.get("conditions", [])
        ):
            self._maybe_clean_pods(store, job)
            return Result()

        try:
            slice_cfg, training, training_spec = self._effective_config(job)
        except ConfigError as e:
            self._finish(store, job, COND_FAILED, "InvalidSpec", str(e))
            return Result()

        self._ensure_gang_service(store, job)

        total_hosts = slice_cfg.total_hosts
        pods = {
            p["metadata"]["name"]: p for p in list_owned(store, job, "Pod")
        }
        desired = gang_pod_names(name, total_hosts)
        missing = [n for n in desired if n not in pods]

        changed = False
        if not status.get("startTime"):
            status["startTime"] = now_iso()
            changed = True

        if missing:
            created = self._create_gang(
                store, job, slice_cfg, training, desired, pods, training_spec
            )
            if created:
                changed |= set_condition(
                    job,
                    COND_CREATED,
                    "True",
                    "GangScheduled",
                    f"all {total_hosts} gang pods created",
                )
            else:
                # atomic placement failed; partial gang already torn down
                changed |= set_condition(
                    job, COND_CREATED, "False", "GangPending", "placement failed"
                )
                self._write_status(store, job)
                return Result(requeue_after_s=1.0)
            pods = {
                p["metadata"]["name"]: p for p in list_owned(store, job, "Pod")
            }
            conflicts = [
                n
                for n in desired
                if n not in pods
                and store.try_get("Pod", n, namespace) is not None
            ]
            if conflicts:
                # a foreign (un-owned) pod squats on a gang pod name; surface
                # it as a terminal condition instead of crash-looping
                self._finish(
                    store,
                    job,
                    COND_FAILED,
                    "PodNameConflict",
                    f"pods {conflicts} exist but are not owned by this job",
                )
                return Result()

        phases = [
            pods[n].get("status", {}).get("phase", PENDING) if n in pods else PENDING
            for n in desired
        ]
        replica_statuses = {
            "active": sum(p in (PENDING, RUNNING) for p in phases),
            "running": sum(p == RUNNING for p in phases),
            "succeeded": sum(p == SUCCEEDED for p in phases),
            "failed": sum(p == FAILED for p in phases),
        }
        if status.get("replicaStatuses") != replica_statuses:
            status["replicaStatuses"] = replica_statuses
            changed = True

        deadline = (job["spec"].get("runPolicy") or {}).get("activeDeadlineSeconds")
        if deadline and status.get("startTime"):
            elapsed = time.time() - _parse_iso(status["startTime"])
            if elapsed > float(deadline):
                self._finish(
                    store,
                    job,
                    COND_FAILED,
                    "DeadlineExceeded",
                    f"active for {elapsed:.0f}s > {deadline}s",
                )
                # deadline always reclaims the slice (k8s Job semantics),
                # independent of cleanPodPolicy
                for n in desired:
                    try:
                        store.delete("Pod", n, namespace)
                    except KeyError:
                        pass
                return Result()

        if any(p == FAILED for p in phases):
            return self._handle_gang_failure(
                store, job, desired, pods, slice_cfg, training
            )

        if all(p == SUCCEEDED for p in phases):
            # surface the coordinator's final metrics on the job (trial
            # controllers and dashboards read these, not pod internals)
            coord = pods.get(desired[0])
            if coord is not None:
                ps = coord.get("status", {})
                metrics = {}
                for key in (
                    "items_per_sec", "final_loss", "final_step", "eval_top1",
                    "compile_s",
                ):
                    if key in ps:
                        try:
                            metrics[key] = float(ps[key])
                        except (TypeError, ValueError):
                            pass
                if metrics:
                    status["trainingMetrics"] = metrics
            self._finish(
                store, job, COND_SUCCEEDED, "GangSucceeded", "all workers succeeded"
            )
            self._maybe_clean_pods(store, job)
            return Result()

        if all(p == RUNNING for p in phases):
            # a persistently-straggling host (fleet_straggler relay) is
            # treated as conclusively gone: reshape proactively instead
            # of letting the slow host throttle the whole gang
            if self._check_stragglers(store, job, slice_cfg, training):
                return Result(requeue=True)
            changed |= set_condition(
                job, COND_RUNNING, "True", "GangRunning", "all workers running"
            )
            self._set_running(job, True)
        if changed:
            self._write_status(store, job)
        # periodic deadline check while non-terminal
        return Result(requeue_after_s=1.0 if deadline else 5.0)

    # -- effective shape (degraded-mesh overrides) -------------------------

    def _effective_config(self, job: Dict[str, Any]):
        """The job's EFFECTIVE (slice, training) shape: the spec as
        written, overridden by status.degraded after an elastic reshape.
        The spec itself stays immutable — what the operator asked for —
        while the status records what the job actually runs on, exactly
        like replicaStatuses records what exists vs what was requested.
        Returns (slice_cfg, training_cfg, training_spec_dict); the spec
        dict is what _build_pod renders into KFT_TRAINING_SPEC so the
        in-pod Trainer builds the degraded mesh."""
        spec = job.get("spec", {})
        degraded = (job.get("status") or {}).get("degraded") or {}
        slice_spec = dict(spec.get("slice") or {})
        # shallow copy: the degraded override replaces the top-level
        # "mesh" key, never mutates nested spec state — and this runs
        # on every reconcile, so no deepcopy on the hot path
        training_spec = dict(spec.get("training") or {})
        if degraded:
            slice_spec["topology"] = degraded["topology"]
            slice_spec["num_slices"] = degraded["numSlices"]
            training_spec["mesh"] = dict(degraded["mesh"])
        slice_cfg, training = parse_job_spec(
            {"slice": slice_spec, "training": training_spec}
        )
        return slice_cfg, training, training_spec

    # -- gang creation ----------------------------------------------------

    def _ensure_gang_service(self, store: StateStore, job: Dict[str, Any]) -> None:
        m = job["metadata"]
        svc = new_object(
            "Service",
            f"{m['name']}-gang",
            m["namespace"],
            spec={
                "clusterIP": "None",  # headless: per-pod DNS
                "selector": {JOB_NAME_LABEL: m["name"]},
                "ports": [
                    {"name": "coordinator", "port": DEFAULT_COORDINATOR_PORT}
                ],
            },
            labels={JOB_NAME_LABEL: m["name"]},
        )
        set_owner(svc, job)
        store.apply(svc)

    def _build_pod(
        self,
        job: Dict[str, Any],
        slice_cfg: SliceConfig,
        pod_name: str,
        index: int,
        env: Dict[str, str],
        training_spec: Optional[Dict[str, Any]] = None,
    ) -> Dict[str, Any]:
        m = job["metadata"]
        spec = job["spec"]
        # the EFFECTIVE training spec (degraded mesh applied) — what the
        # in-pod Trainer actually builds; defaults to the raw spec for
        # direct callers
        if training_spec is None:
            training_spec = spec.get("training") or {}
        restarts = job.get("status", {}).get("restarts", 0)
        env = dict(env)
        env["KFT_TRAINING_SPEC"] = json.dumps(training_spec)
        ckpt = training_spec.get("checkpoint") or {}
        ckpt_dir = ckpt.get("directory")
        if ckpt_dir and ckpt.get("enabled", True):
            # the platform checkpoint knob (checkpointing subsystem,
            # docs/CHECKPOINTING.md): every gang pod saves/restores through
            # this one directory; the env wins over the spec in-pod so an
            # operator can repoint a job without editing it
            env["KFT_CHECKPOINT_DIR"] = ckpt_dir
        if ckpt_dir and restarts > 0:
            # resume-on-gang-restart: the in-pod runner restores the latest
            # COMMITTED step (an interrupted save's uncommitted shards are
            # invisible to the manifest scan, so a preemption mid-save can
            # never resume from a torn checkpoint)
            env["KFT_RESTORE_DIR"] = ckpt_dir
        profiler_logdir = training_spec.get("profiler_logdir")
        if profiler_logdir:
            # the coordinator serves the torch.profiler capture endpoint
            # (runtime/profiler.py); a Tensorboard CR fronts the logdir
            env["KFT_PROFILER_LOGDIR"] = profiler_logdir
            env.setdefault("KFT_PROFILER_PORT", "9431")
        # the JAX controller also renders KFT_COMPILE_CACHE_DIR from
        # compile_cache_dir, which the port's TrainingConfig refuses
        # (ROADMAP A14): such a spec fails InvalidSpec before a pod exists
        # kft-trace contract (observability/; docs/OBSERVABILITY.md):
        # TrainingConfig.observability → KFT_TRACE_* consumed by
        # runtime/launcher.py. Always rendered — the pod env documents
        # the tracing configuration it actually runs, defaults included.
        obs = ObservabilityConfig.from_dict(
            training_spec.get("observability") or {}
        )
        env["KFT_TRACE_ENABLED"] = "1" if obs.trace_enabled else "0"
        env["KFT_TRACE_BUFFER_SPANS"] = str(obs.trace_buffer_spans)
        env["KFT_TRACE_STATUSZ"] = "1" if obs.statusz_enabled else "0"
        env["KFT_TRACE_SAMPLE_PROB"] = f"{obs.trace_sample_prob:g}"
        env["KFT_TRACE_SAMPLE_KEEP"] = str(obs.trace_sample_keep)
        if obs.statusz_enabled:
            # every gang host serves /statusz + /debug/trace + /metrics on
            # this port (runtime/launcher.py; pods have distinct network
            # namespaces so one port fits all); unset = no debug server
            env.setdefault("KFT_DEBUG_PORT", str(DEBUG_PORT))
            # kft-fleet contract (observability/fleet.py): the collector
            # scrapes each host's debug port; KFT_FLEET_SCRAPE makes the
            # NON-coordinator hosts serve it too (per-host step-time
            # series are the straggler detector's input), and the
            # per-pod instance id keeps aggregated rows attributable
            env["KFT_FLEET_SCRAPE"] = "1"
            env["KFT_FLEET_METRICS_PORT"] = env["KFT_DEBUG_PORT"]
            env["KFT_FLEET_INSTANCE"] = pod_name
        # kft-chaos contract (chaos/; docs/ROBUSTNESS.md):
        # the fault plan rides the pod env only when armed — a chaos-off
        # job's pods carry no plan at all (and run_training actively
        # disarms on an empty env). KFT_CHAOS_ATTEMPT is the gang
        # generation (restarts counter, reshapes included), so a spec
        # qualified `attempt=N` targets exactly one incarnation — the
        # restarted/reshaped gang re-renders the same plan, but the
        # fault stays behind with the generation it was aimed at.
        chaos_cfg = ChaosConfig.from_dict(training_spec.get("chaos") or {})
        if chaos_cfg.enabled and chaos_cfg.points:
            env["KFT_CHAOS_POINTS"] = ";".join(chaos_cfg.points)
            env["KFT_CHAOS_SEED"] = str(chaos_cfg.seed)
            env["KFT_CHAOS_ATTEMPT"] = str(restarts)
        pod = new_object(
            "Pod",
            pod_name,
            m["namespace"],
            api_version="v1",
            labels={
                JOB_NAME_LABEL: m["name"],
                REPLICA_INDEX_LABEL: str(index),
            },
            spec={
                "restartPolicy": "Never",  # gang restart is controller-driven
                "nodeSelector": slice_cfg.node_selectors(),
                "subdomain": f"{m['name']}-gang",
                "hostname": pod_name,
                "containers": [
                    {
                        "name": "trainer",
                        "image": spec.get("image", DEFAULT_IMAGE),
                        # one rank a pod: the launcher joins the gang's
                        # torch.distributed group, whose rendezvous is the
                        # gang barrier
                        "command": list(LAUNCHER),
                        "env": [
                            {"name": k, "value": v} for k, v in sorted(env.items())
                        ],
                        "resources": {
                            "limits": slice_cfg.resource_requests(),
                            "requests": slice_cfg.resource_requests(),
                        },
                    }
                ],
            },
        )
        if slice_cfg.spot:
            pod["spec"]["nodeSelector"]["cloud.google.com/gke-spot"] = "true"
        pod["status"] = {"phase": PENDING}
        set_owner(pod, job)
        return pod

    def _create_gang(
        self,
        store: StateStore,
        job: Dict[str, Any],
        slice_cfg: SliceConfig,
        training: TrainingConfig,
        desired: List[str],
        existing: Dict[str, Dict[str, Any]],
        training_spec: Optional[Dict[str, Any]] = None,
    ) -> bool:
        """All-or-nothing creation of the missing gang pods.

        Returns True if after this pass the full gang exists; on any failure
        the pods created *in this pass* are deleted so no partial slice holds
        cards (atomic placement — the semantic the reference lacks).
        """
        m = job["metadata"]
        hostnames = gang_hostnames(m["name"], m["namespace"], slice_cfg.total_hosts)
        envs = render_gang_env(
            m["name"], hostnames, num_slices=slice_cfg.num_slices
        )
        created_now: List[str] = []
        try:
            for i, pod_name in enumerate(desired):
                if pod_name in existing:
                    continue
                pod = self._build_pod(
                    job, slice_cfg, pod_name, i, envs[i], training_spec
                )
                try:
                    store.create(pod)
                except AlreadyExists:
                    continue
                created_now.append(pod_name)
        except Exception as e:  # placement failure → tear down partial gang
            log.warning(
                "gang creation for %s/%s failed (%s); rolling back %d pods",
                m["namespace"],
                m["name"],
                e,
                len(created_now),
            )
            for pod_name in created_now:
                try:
                    store.delete("Pod", pod_name, m["namespace"])
                except KeyError:
                    pass
            store.record_event(
                job, "GangPlacementFailed", str(e), type="Warning"
            )
            return False
        if created_now:
            store.record_event(
                job,
                "GangScheduled",
                f"created {len(created_now)} pods "
                f"({slice_cfg.topology} x{slice_cfg.num_slices})",
            )
        return True

    # -- failure / restart ------------------------------------------------

    def _handle_gang_failure(
        self,
        store: StateStore,
        job: Dict[str, Any],
        desired: List[str],
        pods: Dict[str, Dict[str, Any]],
        slice_cfg: SliceConfig,
        training: TrainingConfig,
    ) -> Result:
        status = job["status"]
        restarts = status.get("restarts", 0)
        # same-SHAPE restart budget: restarts is the monotonic gang-
        # generation counter (reshapes bump it too — a reshape IS a gang
        # restart), so the budget measures attempts since the last
        # reshape. Each degraded shape gets a fresh budget; the topology
        # ladder is finite, so degradation always terminates.
        shape_restarts = restarts - status.get("restartsAtReshape", 0)
        max_restarts = (job["spec"].get("runPolicy") or {}).get("maxRestarts", 0)
        # tolerate pods deleted out-of-band (e.g. cascade GC racing a
        # failure) — a missing gang member must not crash the reconcile
        failed = [
            n for n in desired
            if pods.get(n, {}).get("status", {}).get("phase") == FAILED
        ]
        if shape_restarts >= max_restarts:
            # same-topology restarts exhausted: the host is conclusively
            # gone (retrying the same dead topology would burn forever) —
            # resume on the largest valid smaller mesh instead of dying
            if self._try_degrade(
                store, job, slice_cfg, training,
                f"workers {failed} failed with the same-shape restart "
                f"budget exhausted ({shape_restarts}/{max_restarts})",
            ):
                return Result(requeue=True)
            self._finish(
                store,
                job,
                COND_FAILED,
                "BackoffLimitExceeded",
                f"workers {failed} failed; {restarts} restarts exhausted "
                f"and no resumable smaller shape is available (elastic "
                f"resume needs elasticResume on, a committed checkpoint, "
                f"and a smaller topology that holds the mesh)",
            )
            self._maybe_clean_pods(store, job)
            return Result()
        # whole-gang restart: delete every pod, bump the counter; the next
        # reconcile recreates the gang with KFT_RESTORE_DIR set. The new
        # generation's pods may land on different nodes, so any straggler
        # strikes accumulated against the old placement are stale.
        m = job["metadata"]
        self._drop_straggler_state((m["namespace"], m["name"]))
        for n in desired:
            try:
                store.delete("Pod", n, job["metadata"]["namespace"])
            except KeyError:
                pass
        status["restarts"] = restarts + 1
        set_condition(
            job,
            COND_RESTARTING,
            "True",
            "GangRestart",
            f"workers {failed} failed; restart {restarts + 1}/{max_restarts}",
        )
        set_condition(job, COND_RUNNING, "False", "GangRestart", "")
        self._restarts_total.inc()
        store.record_event(
            job,
            "GangRestart",
            f"restarting whole gang (attempt {restarts + 1}) after "
            f"failure of {failed}",
            type="Warning",
        )
        self._write_status(store, job)
        return Result(requeue=True)

    # -- elastic degradation ----------------------------------------------

    def _try_degrade(
        self,
        store: StateStore,
        job: Dict[str, Any],
        slice_cfg: SliceConfig,
        training: TrainingConfig,
        reason: str,
    ) -> bool:
        """Reshape the gang to the largest valid smaller shape and
        restart it there, resuming from the last committed checkpoint
        (KFT_RESTORE_DIR is gated on restarts > 0, and a reshape bumps
        the generation counter). Records the new shape in
        status.degraded — the spec stays what the operator wrote — sets
        the Degraded condition, and gives the new shape a fresh restart
        budget. Returns False when no smaller shape can hold the job."""
        if not (job["spec"].get("runPolicy") or {}).get(
            "elasticResume", True
        ):
            # strict fail-fast opted in: the operator's automation
            # watches for Failed, not a silently-smaller gang
            return False
        if not self._has_committed_checkpoint(job, training):
            # nothing to resume FROM: a reshape would rerun the whole
            # job from step 0 on fewer cards — and a persistent failure
            # would cascade down the topology ladder, each shape with a
            # fresh budget, burning chip time on doomed from-scratch
            # runs. Without a committed step, exhaustion stays terminal.
            return False
        plan = plan_degraded_reshape(slice_cfg, training)
        if plan is None:
            return False
        new_slice, new_mesh = plan
        status = job["status"]
        restarts = status.get("restarts", 0)
        old = f"{slice_cfg.topology} x{slice_cfg.num_slices}"
        new = f"{new_slice['topology']} x{new_slice['num_slices']}"
        m = job["metadata"]
        # tear down the WHOLE old gang (list_owned, not the desired
        # names: the new shape may have fewer hosts, and a stale
        # worker-3 from the bigger gang must not linger)
        for p in list_owned(store, job, "Pod"):
            try:
                store.delete("Pod", p["metadata"]["name"], m["namespace"])
            except KeyError:
                pass
        status["degraded"] = {
            "topology": new_slice["topology"],
            "numSlices": new_slice["num_slices"],
            "mesh": new_mesh,
            "from": old,
        }
        status["restarts"] = restarts + 1
        status["reshapes"] = status.get("reshapes", 0) + 1
        status["restartsAtReshape"] = restarts + 1
        msg = f"gang reshaped {old} -> {new} (mesh {new_mesh}): {reason}"
        set_condition(job, COND_DEGRADED, "True", "MeshReshaped", msg)
        set_condition(job, COND_RESTARTING, "True", "GangDegraded", msg)
        set_condition(job, COND_RUNNING, "False", "GangDegraded", "")
        self._reshapes_total.inc()
        self._restarts_total.inc()
        # the reshaped gang is a new placement: straggler strikes
        # accumulated against the old pods are stale evidence, whichever
        # trigger (budget exhaustion or straggler trip) got us here
        self._drop_straggler_state((m["namespace"], m["name"]))
        store.record_event(job, "GangDegraded", msg, type="Warning")
        log.warning(
            "job %s/%s: %s", m["namespace"], m["name"], msg
        )
        self._write_status(store, job)
        return True

    def _check_stragglers(
        self,
        store: StateStore,
        job: Dict[str, Any],
        slice_cfg: SliceConfig,
        training: TrainingConfig,
    ) -> bool:
        """The fleet_straggler → reshape relay (the fleet's straggler
        detector as the elastic-resume trigger signal). A host flagged
        for STRAGGLER_TRIP_SWEEPS consecutive fleet sweeps is treated as
        conclusively sick — a same-topology restart could land right
        back on the bad node, so the gang reshapes off it proactively.
        Strikes advance only when the collector has actually swept again
        (fakes without sweeps() count every reconcile)."""
        if self.fleet is None:
            return False
        m = job["metadata"]
        jkey = (m["namespace"], m["name"])
        sweeps_fn = getattr(self.fleet, "sweeps", None)
        sweep = sweeps_fn() if callable(sweeps_fn) else -1
        if sweep >= 0 and sweep == self._straggler_sweep.get(jkey):
            return False  # no fresh fleet data since the last count
        self._straggler_sweep[jkey] = sweep
        tripped = None
        seen = set()
        for (ns, owner, host), flagged in self.fleet.stragglers().items():
            if (ns, owner) != jkey:
                continue
            key = (ns, owner, host)
            seen.add(key)
            strikes = self._straggler_strikes.get(key, 0) + 1 if flagged else 0
            self._straggler_strikes[key] = strikes
            if strikes >= STRAGGLER_TRIP_SWEEPS and tripped is None:
                tripped = host
        # hosts with NO row this sweep (scrape outage, target gone) are
        # missing evidence, not flagged evidence: their streak is broken —
        # a stale pre-outage strike count must never complete later on
        # one fresh flag (the autoscaler's signal-outage discipline)
        for key in [
            k for k in self._straggler_strikes
            if (k[0], k[1]) == jkey and k not in seen
        ]:
            self._straggler_strikes[key] = 0
        if tripped is None:
            return False
        reason = (
            f"host {tripped} flagged fleet_straggler for "
            f"{STRAGGLER_TRIP_SWEEPS} consecutive sweeps"
        )
        if not self._has_committed_checkpoint(job, training):
            # a PROACTIVE reshape of a running-but-slow gang is only a
            # win when the job can resume where it left off; without a
            # committed checkpoint it would trade a slow gang for a
            # from-scratch restart on fewer cards — strictly worse.
            # (Budget-exhaustion reshape is different: that gang is
            # already dead.) Reset the streak so the warning rate-limits
            # itself to once per TRIP_SWEEPS flagged sweeps.
            self._drop_straggler_state(jkey)
            log.warning(
                "job %s/%s: %s, but no committed checkpoint to resume "
                "from — leaving the slow gang running (enable "
                "checkpointing to opt into proactive reshape)",
                jkey[0], jkey[1], reason,
            )
            store.record_event(
                job, "StragglerNotReshaped",
                f"{reason}; no committed checkpoint to resume from",
                type="Warning",
            )
            return False
        # _try_degrade drops the straggler state itself on success (the
        # reshaped gang is a new placement)
        return self._try_degrade(store, job, slice_cfg, training, reason)

    @staticmethod
    def _has_committed_checkpoint(
        job: Dict[str, Any], training: TrainingConfig
    ) -> bool:
        """Can this job actually RESUME after a reshape? Checkpointing
        must be on and at least one step committed in its directory."""
        ckpt = training.checkpoint
        if not (ckpt.enabled and ckpt.directory):
            return False
        from kubeflow_tpu_torch.checkpointing import latest_committed_step

        try:
            return latest_committed_step(ckpt.directory) is not None
        except OSError:
            return False

    def _drop_straggler_state(self, jkey: Tuple[str, str]) -> None:
        for key in [
            k for k in self._straggler_strikes if (k[0], k[1]) == jkey
        ]:
            del self._straggler_strikes[key]
        self._straggler_sweep.pop(jkey, None)

    # -- terminal / cleanup -----------------------------------------------

    def _finish(
        self,
        store: StateStore,
        job: Dict[str, Any],
        cond: str,
        reason: str,
        message: str,
    ) -> None:
        set_condition(job, cond, "True", reason, message)
        set_condition(job, COND_RUNNING, "False", reason, "")
        job["status"]["completionTime"] = now_iso()
        m = job["metadata"]
        self._drop_straggler_state((m["namespace"], m["name"]))
        self._set_running(job, False)
        self._jobs_total.inc(outcome=cond.lower())
        store.record_event(
            job, reason, message, type="Normal" if cond == COND_SUCCEEDED else "Warning"
        )
        self._write_status(store, job)

    def _maybe_clean_pods(self, store: StateStore, job: Dict[str, Any]) -> None:
        policy = (job["spec"].get("runPolicy") or {}).get("cleanPodPolicy", "None")
        if policy == "All":
            for p in list_owned(store, job, "Pod"):
                try:
                    store.delete("Pod", p["metadata"]["name"], p["metadata"]["namespace"])
                except KeyError:
                    pass
        elif policy == "Running":
            for p in list_owned(store, job, "Pod"):
                if p.get("status", {}).get("phase") in (PENDING, RUNNING):
                    try:
                        store.delete(
                            "Pod", p["metadata"]["name"], p["metadata"]["namespace"]
                        )
                    except KeyError:
                        pass

    def _handle_deletion(self, store: StateStore, job: Dict[str, Any]) -> Result:
        m = job["metadata"]
        self._drop_straggler_state((m["namespace"], m["name"]))
        self._set_running(job, False)
        for kind in ("Pod", "Service"):
            for obj in list_owned(store, job, kind):
                try:
                    store.delete(kind, obj["metadata"]["name"], obj["metadata"]["namespace"])
                except KeyError:
                    pass
        if remove_finalizer(job, FINALIZER):
            store.update(job)
        return Result()

    def _write_status(self, store: StateStore, job: Dict[str, Any]) -> None:
        m = job["metadata"]
        store.patch_status(KIND, m["name"], m["namespace"], job["status"])


def _parse_iso(ts: str) -> float:
    import calendar

    return calendar.timegm(time.strptime(ts, "%Y-%m-%dT%H:%M:%SZ"))
