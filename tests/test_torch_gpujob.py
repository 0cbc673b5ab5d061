"""The port's GPUTrainJob controller (kubeflow_tpu_torch/controllers/
gpujob.py) and pod executor (runtime/executor.py) on the CPU.

- The FakePodRunner cases of tests/test_tpujob.py against the port, in the
  GPU vocabulary: gang creation, env and resources, conditions, restarts,
  backoff, deletion, cleanPodPolicy, the deadline, elastic reshape down
  the H100 ladder and the straggler relay.
- One script of scenarios through both packages' controllers, compared
  after `VOCAB` maps the TPU vocabulary to the GPU one: conditions,
  restarts, reshapes, events, pod names, labels, selectors, resources and
  the KFT_* env.
- Real runs: the in-process runner trains the mlp at one card's mesh, a
  config's chaos plan rendered by the controller fails attempt 0 and the
  restart resumes to the uninterrupted run's losses bit for bit, and one
  2-rank gloo gang through SubprocessPodRunner loses a member after a
  commit, reshapes h100-2 -> h100-1 and succeeds at world 1.
"""

import json
import re
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from kubeflow_tpu_torch.cluster.reconciler import ControllerManager  # noqa: E402
from kubeflow_tpu_torch.cluster.store import StateStore  # noqa: E402
from kubeflow_tpu_torch.config.platform import (  # noqa: E402
    GPU_TOPOLOGIES,
    ConfigError,
    SliceConfig,
    TrainingConfig,
)
from kubeflow_tpu_torch.controllers import wait_for_condition  # noqa: E402
from kubeflow_tpu_torch.controllers.gpujob import (  # noqa: E402
    COND_CREATED,
    COND_FAILED,
    COND_RESTARTING,
    COND_RUNNING,
    COND_SUCCEEDED,
    JOB_NAME_LABEL,
    LAUNCHER,
    STRAGGLER_TRIP_SWEEPS,
    GPUTrainJobController,
    gang_pod_names,
    new_gpu_train_job,
    plan_degraded_reshape,
    shrink_mesh,
)
from kubeflow_tpu_torch.parallel.distributed import (  # noqa: E402
    ENV_COORDINATOR,
    ENV_NUM_PROCESSES,
    ENV_PROCESS_ID,
    ENV_SLICE_ID,
)
from kubeflow_tpu_torch.runtime.executor import (  # noqa: E402
    FakePodRunner,
    InProcessTrainerRunner,
    PodExecutor,
    SubprocessPodRunner,
    pod_env,
)
from kubeflow_tpu_torch.runtime.train_run import run_training  # noqa: E402

KIND = "GPUTrainJob"
# f32 CPU training: a gang against world 1 (summation order only)
LOSS_REL = 1e-5


def make_harness(runner=None, fleet=None):
    store = StateStore()
    cm = ControllerManager(store)
    cm.register(GPUTrainJobController(fleet=fleet))
    executor = PodExecutor(store, runner or FakePodRunner())
    return store, cm, executor


def drive(cm, executor, rounds=10):
    """Alternate reconcile and kubelet ticks until both settle."""
    for _ in range(rounds):
        cm.run_until_idle(max_seconds=5)
        if executor.tick() == 0 and executor.tick() == 0:
            cm.run_until_idle(max_seconds=5)
            return


def training(data=4, **kw):
    return {"model": "mlp", "global_batch_size": 16, "steps": 2,
            "mesh": {"data": data}, "checkpoint": {"enabled": False}, **kw}


def submit(store, **kwargs):
    defaults = dict(training=training(),
                    slice_spec={"topology": "h100-4", "num_slices": 1})
    defaults.update(kwargs)
    return store.create(new_gpu_train_job("train1", "team-a", **defaults))


def conditions(job):
    return {c["type"]: c for c in job["status"]["conditions"]}


def commit_checkpoint(directory, step=2):
    """A committed step the controller's resumability gate reads (the
    FakePodRunner gang never trains): the JAX package's manager writes
    the kft-checkpoint-v1 layout the port reads."""
    from kubeflow_tpu.checkpointing import CheckpointManager

    with CheckpointManager(str(directory), async_save=False) as mgr:
        mgr.save(step, {"params": {"w": np.arange(4.0)}}, force=True)
    return str(directory)


class FakeFleet:
    def __init__(self):
        self._sweep = 0
        self.flags = {}

    def sweeps(self):
        return self._sweep

    def stragglers(self):
        return dict(self.flags)


# -- the config ---------------------------------------------------------------


def test_the_h100_ladder_and_its_pods():
    assert list(GPU_TOPOLOGIES) == [
        f"h100-{n}" for n in (1, 2, 4, 8, 16, 32, 64)]
    for name, cards in GPU_TOPOLOGIES.items():
        cfg = SliceConfig.from_dict({"topology": name, "num_slices": 2})
        assert cfg.total_chips == cfg.total_hosts == 2 * cards
        assert cfg.resource_requests() == {"nvidia.com/gpu": "1"}
        assert cfg.node_selectors() == {
            "cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}


@pytest.mark.parametrize("spec,match", [
    ({"topology": "v5e-16"}, "unknown GPU topology 'v5e-16'.*h100-1"),
    ({"topology": "a100-8"}, "unknown GPU topology"),
    ({"topology": "h100-8", "num_slices": 0}, "num_slices"),
    ({"topology": "h100-8", "reserved": True, "spot": True}, "exclusive"),
    ({"topology": "h100-8", "chips": 8}, "unknown field slice.chips"),
])
def test_the_slice_config_refuses(spec, match):
    with pytest.raises(ConfigError, match=match):
        SliceConfig.from_dict(spec)


# -- gang creation --------------------------------------------------------------


class TestGangCreation:
    def test_creates_full_gang_with_env_and_resources(self):
        store, cm, _ = make_harness()
        submit(store)
        cm.run_until_idle(max_seconds=5)
        # h100-4: one pod a card
        pods = store.list("Pod", "team-a", {JOB_NAME_LABEL: "train1"})
        assert len(pods) == 4
        assert {p["metadata"]["name"] for p in pods} == set(
            gang_pod_names("train1", 4))
        by_index = sorted(pods, key=lambda p: p["metadata"]["name"])
        for i, pod in enumerate(by_index):
            env = pod_env(pod)
            assert env[ENV_PROCESS_ID] == str(i)
            assert env[ENV_NUM_PROCESSES] == "4"
            assert env[ENV_SLICE_ID] == "0"
            assert env[ENV_COORDINATOR] == (
                "train1-worker-0.train1-gang.team-a.svc:8476")
            c = pod["spec"]["containers"][0]
            assert c["command"] == LAUNCHER
            assert c["resources"]["limits"] == {"nvidia.com/gpu": "1"}
            assert pod["spec"]["nodeSelector"] == {
                "cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}
        svc = store.get("Service", "train1-gang", "team-a")
        assert svc["spec"]["clusterIP"] == "None"
        job = store.get(KIND, "train1", "team-a")
        assert conditions(job)[COND_CREATED]["status"] == "True"

    def test_multislice_env(self):
        store, cm, _ = make_harness()
        store.create(new_gpu_train_job(
            "ms", training=training(data=8, global_batch_size=32),
            slice_spec={"topology": "h100-4", "num_slices": 2, "spot": True}))
        cm.run_until_idle(max_seconds=5)
        pods = sorted(store.list("Pod", "default", {JOB_NAME_LABEL: "ms"}),
                      key=lambda p: int(pod_env(p)[ENV_PROCESS_ID]))
        assert len(pods) == 8  # 2 groups x 4 cards
        assert [pod_env(p)[ENV_SLICE_ID] for p in pods] == [
            "0", "0", "0", "0", "1", "1", "1", "1"]
        assert pods[0]["spec"]["nodeSelector"][
            "cloud.google.com/gke-spot"] == "true"

    @pytest.mark.parametrize("spec,match", [
        (dict(training=training(data=7, global_batch_size=14)),
         "mesh needs 7 cards but slice "
                                          "h100-4 x1 provides 4"),
        (dict(slice_spec={"topology": "v5e-16"}), "H100 gangs"),
        (dict(training=training(compile_cache_dir="/c")), "A14"),
    ])
    def test_invalid_spec_fails_without_pods(self, spec, match):
        store, cm, _ = make_harness()
        submit(store, **spec)
        cm.run_until_idle(max_seconds=5)
        cond = conditions(store.get(KIND, "train1", "team-a"))[COND_FAILED]
        assert cond["status"] == "True" and cond["reason"] == "InvalidSpec"
        assert re.search(match, cond["message"]), cond["message"]
        assert store.list("Pod", "team-a") == []


# -- the gang's lifecycle ---------------------------------------------------------


class TestGangLifecycle:
    def test_success_path_conditions(self):
        store, cm, executor = make_harness()
        submit(store)
        drive(cm, executor)
        job = wait_for_condition(store, KIND, "train1", "team-a",
                                 COND_SUCCEEDED, timeout_s=5)
        assert job["status"]["completionTime"]
        assert job["status"]["replicaStatuses"]["succeeded"] == 4

    def test_running_condition_and_gauge(self):
        from kubeflow_tpu_torch.utils.metrics import default_registry

        g = default_registry().gauge("gpujob_running")
        store, cm, executor = make_harness()
        submit(store)
        cm.run_until_idle(max_seconds=5)
        executor.tick()  # Pending -> Running
        cm.run_until_idle(max_seconds=5)
        job = store.get(KIND, "train1", "team-a")
        assert conditions(job)[COND_RUNNING]["status"] == "True"
        assert g.value() == 1
        drive(cm, executor)
        wait_for_condition(store, KIND, "train1", "team-a", COND_SUCCEEDED,
                           timeout_s=5)
        assert g.value() == 0

    def test_gang_restart_on_single_pod_failure(self):
        runner = FakePodRunner()
        store, cm, executor = make_harness(runner)
        submit(store)
        cm.run_until_idle(max_seconds=5)
        runner.fail_next("train1-worker-2")
        drive(cm, executor)
        job = wait_for_condition(store, KIND, "train1", "team-a",
                                 COND_SUCCEEDED, timeout_s=5)
        assert job["status"]["restarts"] == 1
        assert conditions(job)[COND_RESTARTING]["status"] == "True"
        # every worker reran (whole-gang restart, not single-pod)
        assert runner.ran.count("train1-worker-0") == 2

    def test_gang_failure_tolerates_pod_deleted_out_of_band(self):
        store, cm, executor = make_harness()
        submit(store)
        cm.run_until_idle(max_seconds=5)
        pod = store.get("Pod", "train1-worker-2", "team-a")
        pod.setdefault("status", {})["phase"] = "Failed"
        store.update(pod)
        store.delete("Pod", "train1-worker-1", "team-a")
        cm.run_until_idle(max_seconds=5)
        assert store.get(KIND, "train1", "team-a")["status"]["restarts"] == 1

    def test_backoff_limit_exhaustion_fails_job(self, tmp_path):
        """At the bottom of the ladder (h100-1, data 1) exhaustion is
        terminal even with a committed checkpoint."""
        runner = FakePodRunner()
        store, cm, executor = make_harness(runner)
        ckpt = commit_checkpoint(tmp_path / "ckpt", step=1)
        submit(store, max_restarts=1,
               training=training(data=1, checkpoint={
                   "enabled": True, "directory": ckpt}),
               slice_spec={"topology": "h100-1"})
        cm.run_until_idle(max_seconds=5)
        runner.fail_next("train1-worker-0", times=5)
        drive(cm, executor, rounds=20)
        job = wait_for_condition(store, KIND, "train1", "team-a",
                                 COND_FAILED, timeout_s=5)
        assert conditions(job)[COND_FAILED]["reason"] == "BackoffLimitExceeded"
        assert job["status"]["restarts"] == 1
        assert "reshapes" not in job["status"]

    def test_deletion_cleans_gang(self):
        store, cm, _ = make_harness()
        submit(store)
        cm.run_until_idle(max_seconds=5)
        assert len(store.list("Pod", "team-a")) == 4
        store.delete(KIND, "train1", "team-a")
        cm.run_until_idle(max_seconds=5)
        assert store.list("Pod", "team-a") == []
        assert store.try_get(KIND, "train1", "team-a") is None
        assert store.try_get("Service", "train1-gang", "team-a") is None

    @pytest.mark.parametrize("policy,left", [("All", 0), ("None", 4)])
    def test_clean_pod_policy(self, policy, left):
        store, cm, executor = make_harness()
        submit(store, clean_pod_policy=policy)
        drive(cm, executor)
        wait_for_condition(store, KIND, "train1", "team-a", COND_SUCCEEDED,
                           timeout_s=5)
        cm.run_until_idle(max_seconds=5)
        assert len(store.list("Pod", "team-a")) == left

    def test_active_deadline_exceeded(self):
        store, cm, _ = make_harness()
        submit(store, active_deadline_seconds=0.05)
        cm.run_until_idle(max_seconds=5)
        time.sleep(1.1)  # startTime resolution is 1s
        cm.enqueue_all()
        cm.run_until_idle(max_seconds=5)
        job = wait_for_condition(store, KIND, "train1", "team-a",
                                 COND_FAILED, timeout_s=5)
        assert conditions(job)[COND_FAILED]["reason"] == "DeadlineExceeded"
        assert store.list("Pod", "team-a") == []


# -- elastic resume ---------------------------------------------------------------


class TestElasticResume:
    def test_shrink_mesh_prefers_data_then_fsdp(self):
        assert shrink_mesh({"data": 4, "fsdp": 2}, 2) == {"data": 2, "fsdp": 2}
        assert shrink_mesh({"data": 1, "fsdp": 4}, 2) == {"data": 1, "fsdp": 2}
        assert shrink_mesh({"data": 4, "fsdp": 2}, 4) == {"data": 1, "fsdp": 2}
        assert shrink_mesh({"data": 1, "tensor": 4}, 2) is None
        assert shrink_mesh({"data": 6}, 3) is None

    def test_shrink_mesh_never_touches_expert_axis(self):
        assert shrink_mesh({"data": 2, "expert": 4}, 2) == {
            "data": 1, "expert": 4}
        assert shrink_mesh({"data": 4, "fsdp": 2, "expert": 4}, 4) == {
            "data": 1, "fsdp": 2, "expert": 4}
        assert shrink_mesh({"data": 1, "expert": 4}, 2) is None

    @pytest.mark.parametrize("topology,slices,mesh,want,want_mesh", [
        # a second group is dropped first
        ("h100-4", 2, {"data": 8}, {"topology": "h100-4", "num_slices": 1},
         {"data": 4}),
        # else the largest smaller H100 topology
        ("h100-16", 1, {"data": 16}, {"topology": "h100-8", "num_slices": 1},
         {"data": 8}),
        ("h100-2", 1, {"data": 2}, {"topology": "h100-1", "num_slices": 1},
         {"data": 1}),
        # the expert axis is kept: data absorbs the halving
        ("h100-8", 1, {"data": 2, "expert": 4},
         {"topology": "h100-4", "num_slices": 1}, {"data": 1, "expert": 4}),
    ])
    def test_plan_walks_the_h100_ladder(self, topology, slices, mesh, want,
                                        want_mesh):
        sc = SliceConfig(topology=topology, num_slices=slices)
        model = "gpt_tiny_moe" if "expert" in mesh else "mlp"
        tc = TrainingConfig.from_dict({"model": model, "global_batch_size": 32,
                                       "mesh": mesh})
        new_slice, new_mesh = plan_degraded_reshape(sc, tc)
        assert new_slice == want
        assert {a: n for a, n in new_mesh.items() if n > 1} == {
            a: n for a, n in want_mesh.items() if n > 1}

    def test_no_smaller_shape_at_the_bottom(self):
        tc = TrainingConfig.from_dict({"model": "mlp", "global_batch_size": 8})
        assert plan_degraded_reshape(SliceConfig(topology="h100-1"), tc) is None

    def test_budget_exhaustion_reshapes_instead_of_failing(self, tmp_path):
        runner = FakePodRunner()
        store, cm, executor = make_harness(runner)
        ckpt = commit_checkpoint(tmp_path / "ckpt")
        submit(store, max_restarts=1, training=training(
            checkpoint={"enabled": True, "directory": ckpt}))
        cm.run_until_idle(max_seconds=5)
        # the fourth card fails persistently: one same-shape restart burns
        # the budget, the next failure degrades instead of killing the job
        runner.fail_next("train1-worker-3", times=5)
        drive(cm, executor, rounds=30)
        job = wait_for_condition(store, KIND, "train1", "team-a",
                                 COND_SUCCEEDED, timeout_s=5)
        status = job["status"]
        assert status["reshapes"] == 1
        assert status["degraded"]["topology"] == "h100-2"
        assert status["degraded"]["mesh"]["data"] == 2
        cond = conditions(job)["Degraded"]
        assert (cond["status"], cond["reason"]) == ("True", "MeshReshaped")
        # the degraded gang is two pods: worker-3 never came back
        assert status["replicaStatuses"]["succeeded"] == 2
        assert store.try_get("Pod", "train1-worker-3", "team-a") is None
        assert job["spec"]["slice"]["topology"] == "h100-4"

    def test_an_fsdp_gang_reshapes_its_fsdp_axis(self, tmp_path):
        """A GPUTrainJob on `{data: 1, fsdp: 2}` (h100-2) validates and
        renders its mesh into every pod's KFT_TRAINING_SPEC; after losing
        a member for good it reshapes to h100-1 with `{fsdp: 1}` (the
        fsdp branch of `shrink_mesh`, end to end) and succeeds."""
        runner = FakePodRunner()
        store, cm, executor = make_harness(runner)
        ckpt = commit_checkpoint(tmp_path / "ckpt")
        submit(store, max_restarts=1,
               slice_spec={"topology": "h100-2", "num_slices": 1},
               training=training(mesh={"data": 1, "fsdp": 2},
                                 checkpoint={"enabled": True,
                                             "directory": ckpt}))
        cm.run_until_idle(max_seconds=5)
        pods = store.list("Pod", "team-a")
        assert len(pods) == 2
        for pod in pods:
            mesh = json.loads(pod_env(pod)["KFT_TRAINING_SPEC"])["mesh"]
            assert (mesh["data"], mesh["fsdp"]) == (1, 2)
        runner.fail_next("train1-worker-1", times=5)
        drive(cm, executor, rounds=30)
        job = wait_for_condition(store, KIND, "train1", "team-a",
                                 COND_SUCCEEDED, timeout_s=5)
        status = job["status"]
        assert status["reshapes"] == 1
        assert status["degraded"]["topology"] == "h100-1"
        assert (status["degraded"]["mesh"]["data"],
                status["degraded"]["mesh"]["fsdp"]) == (1, 1)
        env = pod_env(store.get("Pod", "train1-worker-0", "team-a"))
        mesh = json.loads(env["KFT_TRAINING_SPEC"])["mesh"]
        assert (mesh["data"], mesh["fsdp"]) == (1, 1)
        assert env["KFT_RESTORE_DIR"] == ckpt
        assert store.try_get("Pod", "train1-worker-1", "team-a") is None

    def test_budget_exhaustion_reshape_resets_straggler_strikes(self, tmp_path):
        fleet = FakeFleet()
        runner = FakePodRunner()
        store = StateStore()
        cm = ControllerManager(store)
        ctrl = GPUTrainJobController(fleet=fleet)
        cm.register(ctrl)
        executor = PodExecutor(store, runner)
        ckpt = commit_checkpoint(tmp_path / "ckpt")
        submit(store, max_restarts=0, training=training(checkpoint={
            "enabled": True, "directory": ckpt, "interval_steps": 2}))
        cm.run_until_idle(max_seconds=5)
        executor.tick()  # Pending -> Running (and STAYS running)
        cm.run_until_idle(max_seconds=5)
        key = ("team-a", "train1", "train1-worker-2")
        fleet.flags[key] = True
        for _ in range(STRAGGLER_TRIP_SWEEPS - 1):
            fleet._sweep += 1
            cm.enqueue_all()
            cm.run_until_idle(max_seconds=5)
        assert ctrl._straggler_strikes[key] == STRAGGLER_TRIP_SWEEPS - 1
        runner.fail_next("train1-worker-1", times=1)
        drive(cm, executor, rounds=20)
        assert store.get(KIND, "train1", "team-a")["status"]["reshapes"] == 1
        assert key not in ctrl._straggler_strikes

    @pytest.mark.parametrize("elastic,checkpoint", [
        (False, True),   # strict fail-fast opted in
        (True, False),   # nothing committed to resume from
    ])
    def test_exhaustion_fails_without_a_resumable_reshape(
            self, tmp_path, elastic, checkpoint):
        runner = FakePodRunner()
        store, cm, executor = make_harness(runner)
        ckpt = ({"enabled": True,
                 "directory": commit_checkpoint(tmp_path / "ckpt")}
                if checkpoint else {"enabled": False})
        submit(store, max_restarts=0, elastic_resume=elastic,
               training=training(checkpoint=ckpt))
        cm.run_until_idle(max_seconds=5)
        runner.fail_next("train1-worker-1", times=2)
        drive(cm, executor, rounds=20)
        job = wait_for_condition(store, KIND, "train1", "team-a",
                                 COND_FAILED, timeout_s=5)
        assert conditions(job)[COND_FAILED]["reason"] == "BackoffLimitExceeded"
        assert "reshapes" not in job["status"]

    def _straggler_harness(self, fleet, checkpoint):
        store, cm, executor = make_harness(fleet=fleet)
        submit(store, training=training(checkpoint=checkpoint))
        cm.run_until_idle(max_seconds=5)
        executor.tick()  # Pending -> Running (and STAYS running)
        cm.run_until_idle(max_seconds=5)
        return store, cm

    @staticmethod
    def _sweep(cm, fleet, n=1, fresh=True):
        for _ in range(n):
            fleet._sweep += int(fresh)
            cm.enqueue_all()
            cm.run_until_idle(max_seconds=5)

    def test_straggler_trip_reshapes_proactively(self, tmp_path):
        fleet = FakeFleet()
        ckpt = commit_checkpoint(tmp_path / "ckpt")
        store, cm = self._straggler_harness(fleet, {
            "enabled": True, "directory": ckpt, "interval_steps": 2})
        key = ("team-a", "train1", "train1-worker-2")
        fleet.flags[key] = True
        # one sweep re-read many times: no strikes accumulate
        self._sweep(cm, fleet, STRAGGLER_TRIP_SWEEPS + 2, fresh=False)
        assert "degraded" not in store.get(KIND, "train1", "team-a")["status"]
        # an outage sweep (no row) breaks the streak
        self._sweep(cm, fleet, STRAGGLER_TRIP_SWEEPS - 1)
        del fleet.flags[key]
        self._sweep(cm, fleet)
        fleet.flags[key] = True
        self._sweep(cm, fleet)
        assert "degraded" not in store.get(KIND, "train1", "team-a")["status"]
        self._sweep(cm, fleet, STRAGGLER_TRIP_SWEEPS)
        job = store.get(KIND, "train1", "team-a")
        assert job["status"]["reshapes"] == 1
        assert job["status"]["degraded"]["topology"] == "h100-2"
        assert conditions(job)["Degraded"]["status"] == "True"
        events = [e for e in store.list("Event", "team-a")
                  if e.get("reason") == "GangDegraded"]
        assert events and "fleet_straggler" in events[0]["message"]

    def test_straggler_trip_without_checkpoint_leaves_gang_running(self):
        fleet = FakeFleet()
        store, cm = self._straggler_harness(fleet, {"enabled": False})
        fleet.flags[("team-a", "train1", "train1-worker-2")] = True
        self._sweep(cm, fleet, STRAGGLER_TRIP_SWEEPS + 1)
        assert "degraded" not in store.get(KIND, "train1", "team-a")["status"]
        assert len(store.list("Pod", "team-a")) == 4  # gang untouched
        events = [e for e in store.list("Event", "team-a")
                  if e.get("reason") == "StragglerNotReshaped"]
        assert events and "no committed checkpoint" in events[0]["message"]


# -- one script through both packages --------------------------------------------

# The TPU vocabulary of the JAX controller → the GPU one of the port, for
# the shapes the scenarios use. A TPU host of v5e-4/v5e-16 (4 chips) is
# one card, so its mesh's data axis is divided by 4; v5e-1 is one chip.
VOCAB = {
    "kind": ("TPUTrainJob", "GPUTrainJob"),
    "topology": {"v5e-16": "h100-4", "v5e-4": "h100-1", "v5e-1": "h100-1"},
    "mesh.data": {16: 4, 8: 2, 4: 1, 1: 1},
    "resources": ({"google.com/tpu": "4"}, {"nvidia.com/gpu": "1"}),
    "resources v5e-1": ({"google.com/tpu": "1"}, {"nvidia.com/gpu": "1"}),
    "nodeSelector": (("cloud.google.com/gke-tpu-accelerator",
                      "cloud.google.com/gke-tpu-topology"),
                     {"cloud.google.com/gke-accelerator": "nvidia-h100-80gb"}),
    "gauge": ("tpujob_running", "gpujob_running"),
}


def to_gpu(value):
    """A JAX controller's record in the port's vocabulary (`VOCAB`)."""
    if isinstance(value, dict):
        out = {}
        for k, v in value.items():
            if k == "mesh" and isinstance(v, dict):
                v = {a: VOCAB["mesh.data"][n] if a == "data" else n
                     for a, n in v.items()}
            elif k == "KFT_TRAINING_SPEC":
                v = json.dumps(to_gpu(json.loads(v)))
            elif k == "nodeSelector":
                tpu_keys, gpu = VOCAB["nodeSelector"]
                v = {**{a: b for a, b in v.items() if a not in tpu_keys},
                     **gpu}
            elif k in ("limits", "requests"):
                for tpu, gpu in (VOCAB["resources"],
                                 VOCAB["resources v5e-1"]):
                    if v == tpu:
                        v = gpu
            out[k] = to_gpu(v)
        return out
    if isinstance(value, (list, tuple)):
        return type(value)(to_gpu(v) for v in value)
    if isinstance(value, str):
        for tpu, gpu in sorted(VOCAB["topology"].items(),
                               key=lambda kv: -len(kv[0])):
            value = re.sub(re.escape(tpu) + r"(?![0-9])", gpu, value)
        value = re.sub(r"'data': (\d+)", lambda m: "'data': %d" % VOCAB[
            "mesh.data"][int(m.group(1))], value)
        return value.replace(*VOCAB["kind"])
    return value


SCENARIOS = {
    # name: (slice, mesh data, runPolicy keywords, checkpoint committed)
    "gang": ({"topology": "v5e-16"}, 16, {}, False),
    "restart": ({"topology": "v5e-16"}, 16, {}, False),
    "backoff": ({"topology": "v5e-1"}, 1, {"max_restarts": 1}, True),
    "deletion": ({"topology": "v5e-16"}, 16, {}, False),
    "clean_all": ({"topology": "v5e-16"}, 16, {"clean_pod_policy": "All"},
                  False),
    "deadline": ({"topology": "v5e-16"}, 16,
                 {"active_deadline_seconds": 0.05}, False),
    "reshape": ({"topology": "v5e-4", "num_slices": 2}, 8,
                {"max_restarts": 0}, True),
    "straggler": ({"topology": "v5e-4", "num_slices": 2}, 8, {}, True),
}


def _clock_free(message):
    """A condition or event message without its wall-clock reading (the
    deadline's "active for <n>s", whole seconds since startTime)."""
    return re.sub(r"active for \d+s", "active for <n>s", message)


def _run_scenario(pkg, name, ckpt):
    """Scenario `name` through one package's controller on FakePodRunner
    → its normalised record: the job's conditions, status counters and
    degraded shape, its events, the runner's pod runs, and every pod
    left (name, labels, selectors, resources, KFT_* env)."""
    if pkg == "jax":
        from kubeflow_tpu.cluster.reconciler import (
            ControllerManager as CM,
        )
        from kubeflow_tpu.cluster.store import StateStore as Store
        from kubeflow_tpu.controllers.tpujob import (
            TPUTrainJobController as Ctrl,
            new_tpu_train_job as new_job,
        )
        from kubeflow_tpu.runtime.executor import (
            FakePodRunner as Fake,
            PodExecutor as Exe,
        )
        from kubeflow_tpu.runtime.executor import pod_env as env_of
        kind, topo = "TPUTrainJob", dict
    else:
        CM, Store, Ctrl, new_job = (ControllerManager, StateStore,
                                    GPUTrainJobController, new_gpu_train_job)
        Fake, Exe, env_of, kind = FakePodRunner, PodExecutor, pod_env, KIND

        def topo(s):
            return to_gpu(dict(s, topology=VOCAB["topology"][s["topology"]]))
    slice_spec, data, policy, committed = SCENARIOS[name]
    if pkg != "jax":
        data = VOCAB["mesh.data"][data]
    ckpt_cfg = ({"enabled": True, "directory": ckpt, "interval_steps": 2}
                if committed else {"enabled": False})
    fleet = FakeFleet() if name == "straggler" else None
    store, runner = Store(), Fake()
    cm = CM(store)
    cm.register(Ctrl(fleet=fleet))
    executor = Exe(store, runner)
    store.create(new_job("train1", "team-a", slice_spec=topo(slice_spec),
                         training=training(data=data, checkpoint=ckpt_cfg),
                         **policy))
    cm.run_until_idle(max_seconds=5)
    if name in ("restart", "reshape"):
        runner.fail_next("train1-worker-1", times=1)
    elif name == "backoff":
        runner.fail_next("train1-worker-0", times=5)
    if name == "deletion":
        store.delete(kind, "train1", "team-a")
        cm.run_until_idle(max_seconds=5)
    elif name == "deadline":
        time.sleep(1.1)  # startTime resolution is 1s
        cm.enqueue_all()
        cm.run_until_idle(max_seconds=5)
    elif name == "straggler":
        executor.tick()  # Pending -> Running (and STAYS running)
        cm.run_until_idle(max_seconds=5)
        fleet.flags[("team-a", "train1", "train1-worker-1")] = True
        for _ in range(STRAGGLER_TRIP_SWEEPS):
            fleet._sweep += 1
            cm.enqueue_all()
            cm.run_until_idle(max_seconds=5)
        fleet.flags.clear()
    drive(cm, executor, rounds=30)
    job = store.try_get(kind, "train1", "team-a")
    record = {"ran": list(runner.ran), "job": None}
    if job is not None:
        st = job["status"]
        record["job"] = {
            "conditions": [(c["type"], c["status"], c["reason"],
                            _clock_free(c["message"]))
                           for c in st.get("conditions", [])],
            **{k: st[k] for k in ("restarts", "reshapes", "restartsAtReshape",
                                  "degraded", "replicaStatuses") if k in st},
        }
    record["events"] = [
        (e["reason"], e["type"], _clock_free(e["message"])) for e in sorted(
            store.list("Event", "team-a"),
            key=lambda e: int(e["metadata"]["resourceVersion"]))]
    record["pods"] = {
        p["metadata"]["name"]: {
            "labels": p["metadata"]["labels"],
            "phase": p["status"].get("phase"),
            "nodeSelector": p["spec"]["nodeSelector"],
            "resources": p["spec"]["containers"][0]["resources"],
            "env": env_of(p),
        } for p in store.list("Pod", "team-a")}
    return record


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_a_scripted_scenario_matches_the_jax_controller(tmp_path, name):
    ckpt = commit_checkpoint(tmp_path / "ckpt")
    want = to_gpu(_run_scenario("jax", name, ckpt))
    got = _run_scenario("torch", name, ckpt)
    assert got == want
    if name in ("gang", "restart", "clean_all", "backoff"):
        assert got["job"]["conditions"][-1][:2] in (
            ("Succeeded", "True"), ("Failed", "True"))
    if name in ("reshape", "straggler"):
        assert got["job"]["reshapes"] == 1 and len(got["pods"]) == 1
    if name == "restart":
        assert got["job"]["restarts"] == 1
        assert all(p["env"]["KFT_TRACE_ENABLED"] == "1"
                   for p in got["pods"].values())


# -- real runs: the in-process runner ----------------------------------------------

REAL = {"model": "mlp", "global_batch_size": 16, "steps": 4,
        "dtype": "float32", "learning_rate": 0.01, "warmup_steps": 1,
        "mesh": {"data": 1}}


def test_job_trains_mlp_in_process():
    runner = InProcessTrainerRunner(device="cpu")
    store, cm, executor = make_harness(runner)
    store.create(new_gpu_train_job(
        "e2e", training=dict(REAL, checkpoint={"enabled": False}),
        slice_spec={"topology": "h100-1"}))
    drive(cm, executor)
    done = wait_for_condition(store, KIND, "e2e", "default", COND_SUCCEEDED,
                              timeout_s=30)
    assert done["status"]["replicaStatuses"]["succeeded"] == 1
    assert runner.last_metrics["items_per_sec"] > 0
    assert done["status"]["trainingMetrics"]["final_step"] == 4
    pod = store.get("Pod", "e2e-worker-0", "default")
    assert float(pod["metadata"]["annotations"][
        "kubeflow-tpu.dev/items-per-sec"]) > 0
    assert runner.runs[0]["result"]["final_step"] == 4


def test_in_process_runner_refuses_a_mesh_above_one():
    store, cm, executor = make_harness(InProcessTrainerRunner(device="cpu"))
    store.create(new_gpu_train_job(
        "wide", max_restarts=0,
        training=dict(REAL, mesh={"data": 2}, checkpoint={"enabled": False}),
        slice_spec={"topology": "h100-2"}))
    drive(cm, executor)
    wait_for_condition(store, KIND, "wide", "default", COND_FAILED,
                       timeout_s=5)
    assert store.get("Pod", "wide-worker-0")["status"]["reason"] == (
        "InsufficientDevices")


def test_a_rendered_chaos_plan_fails_attempt_0_and_the_restart_resumes(
        tmp_path):
    """chip_smoke.py phase 22b on the CPU at mlp size: the spec's chaos
    plan (trainer.device_step after the step-2 commit, attempt 0 only)
    reaches the run only through the env the controller renders; the
    gang restarts with KFT_RESTORE_DIR, resumes at step 2 and ends on the
    uninterrupted run's losses, bit for bit."""
    whole = run_training(TrainingConfig.from_dict(dict(
        REAL, checkpoint={"enabled": False})), device="cpu", log_every=1)
    runner = InProcessTrainerRunner(device="cpu")
    store, cm, executor = make_harness(runner)
    ckpt = str(tmp_path / "ckpt")
    store.create(new_gpu_train_job(
        "cut", max_restarts=1, slice_spec={"topology": "h100-1"},
        training=dict(REAL, checkpoint={"directory": ckpt,
                                        "interval_steps": 2},
                      chaos={"enabled": True, "points": [
                          "trainer.device_step:after=2,once,attempt=0"]})))
    cm.run_until_idle(max_seconds=5)
    env0 = pod_env(store.get("Pod", "cut-worker-0"))
    assert env0["KFT_CHAOS_ATTEMPT"] == "0" and "KFT_RESTORE_DIR" not in env0
    drive(cm, executor, rounds=30)
    done = wait_for_condition(store, KIND, "cut", "default", COND_SUCCEEDED,
                              timeout_s=30)
    assert done["status"]["restarts"] == 1
    assert conditions(done)[COND_RESTARTING]["status"] == "True"
    env1 = pod_env(store.get("Pod", "cut-worker-0"))
    assert env1["KFT_RESTORE_DIR"] == ckpt and env1["KFT_CHAOS_ATTEMPT"] == "1"
    (resumed,) = [r["result"] for r in runner.runs]  # attempt 0 raised
    assert "restore_s" in resumed
    assert resumed["losses"] == whole["losses"][2:]
    assert resumed["loss"] == whole["loss"]


# -- a real gang: SubprocessPodRunner over gloo -------------------------------------


def test_a_reserved_gang_port_is_held_for_rank_0s_store_alone():
    """The runners' coordinator port (`reserve_port`): while it is held
    the kernel gives it to no bind(0), rank 0's TCPStore listens on it,
    and a second store on it fails with EADDRINUSE (what a port probed
    and released let happen to a gang under pytest-xdist)."""
    import socket
    from datetime import timedelta

    from kubeflow_tpu_torch.parallel.distributed import reserve_port

    held = reserve_port()
    port = held.getsockname()[1]
    others = []
    try:
        for _ in range(256):
            s = socket.socket()
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", 0))
            others.append(s)
        assert port not in {s.getsockname()[1] for s in others}
        store = torch.distributed.TCPStore(
            "127.0.0.1", port, 1, True, timeout=timedelta(seconds=10))
        store.set("k", "v")
        assert store.get("k") == b"v"
        with pytest.raises(RuntimeError, match="EADDRINUSE|in use"):
            torch.distributed.TCPStore("127.0.0.1", port, 1, True,
                                       timeout=timedelta(seconds=5))
        del store
    finally:
        for s in others:
            s.close()
        held.close()



def test_a_killed_gang_member_reshapes_to_world_1_and_resumes(
        tmp_path, monkeypatch):
    """One 2-rank gloo gang (mlp, a commit every 2 steps, maxRestarts 0,
    elastic resume): rank 1 is killed after the first commit, the
    controller reshapes h100-2 -> h100-1 (data 2 -> 1), and one rank
    resumes from the committed step with KFT_RESTORE_DIR and succeeds;
    its final loss is an uninterrupted world-1 run's within LOSS_REL."""
    from kubeflow_tpu_torch.checkpointing import latest_committed_step

    spec = dict(REAL, steps=40, mesh={"data": 2})
    ckpt = str(tmp_path / "ckpt")
    store = StateStore()
    cm = ControllerManager(store)
    cm.register(GPUTrainJobController())
    # the children inherit this env: one thread a rank, or two ranks
    # oversubscribe the cores
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    runner = SubprocessPodRunner(store, device="cpu")
    executor = PodExecutor(store, runner)
    store.create(new_gpu_train_job(
        "gang", max_restarts=0, slice_spec={"topology": "h100-2"},
        training=dict(spec, checkpoint={"directory": ckpt,
                                        "interval_steps": 2})))
    killed = {}

    def kill_after_the_commit(stop):
        while not stop.is_set():
            step = latest_committed_step(ckpt)
            if step is not None and runner.kill_member("gang-worker-1"):
                killed["step"] = step
                return
            time.sleep(0.005)

    stop = threading.Event()
    killer = threading.Thread(target=kill_after_the_commit, args=(stop,),
                              daemon=True)
    killer.start()
    # the control plane's background mode, as a user runs it
    cm.start()
    executor.start()
    deadline = time.monotonic() + 240  # the gang's own time limit
    try:
        while time.monotonic() < deadline:
            conds = {c["type"]: c["status"] for c in store.get(
                KIND, "gang")["status"].get("conditions", [])}
            if "True" in (conds.get(COND_SUCCEEDED), conds.get(COND_FAILED)):
                break
            time.sleep(0.05)
    finally:
        stop.set()
        executor.stop()
        cm.stop()
        runner.stop_all()
    job = store.get(KIND, "gang")
    assert conditions(job)[COND_SUCCEEDED]["status"] == "True", job["status"]
    status = job["status"]
    assert killed["step"] >= 2
    assert status["reshapes"] == 1 and status["restarts"] == 1
    assert status["degraded"]["topology"] == "h100-1"
    assert status["degraded"]["from"] == "h100-2 x1"
    assert status["degraded"]["mesh"]["data"] == 1
    env = pod_env(store.get("Pod", "gang-worker-0"))
    assert env["KFT_RESTORE_DIR"] == ckpt
    assert json.loads(env["KFT_TRAINING_SPEC"])["mesh"]["data"] == 1
    first = [r for r in runner.results if r["attempt"] == 0]
    assert {r["pod"] for r in first} >= {"gang-worker-1"}
    (last,) = [r for r in runner.results if r["attempt"] == 1]
    res = last["line"]
    assert last["rc"] == 0 and res["world_size"] == 1
    assert res["backend"] == "gloo" and "restore_s" in res
    # resumed at a committed step (a commit every 2), at or after the kill's
    resumed_at = res["losses"][0][0] - 1
    assert resumed_at >= killed["step"] and resumed_at % 2 == 0
    assert res["final_step"] == spec["steps"]
    whole = run_training(TrainingConfig.from_dict(dict(
        spec, mesh={"data": 1}, checkpoint={"enabled": False})),
        device="cpu", log_every=1)
    np.testing.assert_allclose(res["loss"], whole["loss"], rtol=LOSS_REL)
    assert store.get(KIND, "gang")["status"]["trainingMetrics"][
        "final_step"] == spec["steps"]
