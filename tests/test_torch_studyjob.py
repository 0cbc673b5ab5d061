"""The port's StudyJob controller (kubeflow_tpu_torch/controllers/
studyjob.py) on the CPU: the suggestion engine against the JAX package's
(grid, seeded random, dotted paths), the cases of tests/test_studyjob.py
on FakePodRunner (fan-out under the parallelism cap, best-trial
selection, all trials failed, an invalid algorithm), and one
warm-started grid study of real mlp trials through both packages'
controllers and in-process runners: per-trial final losses within rel
1e-5 (f32) at lr 0.01, within the bound of optax's f32 bias correction at
lr 0.1 (closed to rel 1e-5 once the port's AdamW takes that correction),
and the same best trial."""

import json

import pytest

torch = pytest.importorskip("torch")

from kubeflow_tpu_torch.cluster.reconciler import ControllerManager  # noqa: E402
from kubeflow_tpu_torch.cluster.store import StateStore  # noqa: E402
from kubeflow_tpu_torch.controllers import wait_for_condition  # noqa: E402
from kubeflow_tpu_torch.controllers.gpujob import (  # noqa: E402
    GPUTrainJobController,
)
from kubeflow_tpu_torch.controllers.studyjob import (  # noqa: E402
    StudyJobController,
    generate_suggestions,
    new_study_job,
    set_by_path,
)
from kubeflow_tpu_torch.runtime.executor import (  # noqa: E402
    FakePodRunner,
    InProcessTrainerRunner,
    PodExecutor,
    pod_env,
)

TRIAL = "GPUTrainJob"
TRIAL_TEMPLATE = {
    "image": "kubeflow-tpu/trainer-gpu:latest",
    "slice": {"topology": "h100-4", "num_slices": 1},
    "training": {
        "model": "mlp",
        "global_batch_size": 16,
        "steps": 2,
        "mesh": {"data": 4},
        "checkpoint": {"enabled": False},
    },
    "runPolicy": {"maxRestarts": 0, "cleanPodPolicy": "None"},
}
# f32 CPU training from one warm start: the packages' trials differ by
# summation order only
LOSS_REL = 1e-5


def make_harness(runner=None):
    store = StateStore()
    cm = ControllerManager(store)
    cm.register(GPUTrainJobController())
    cm.register(StudyJobController())
    executor = PodExecutor(store, runner or FakePodRunner())
    return store, cm, executor


def drive(cm, executor, rounds=30, max_seconds=10.0):
    for _ in range(rounds):
        cm.run_until_idle(max_seconds=max_seconds)
        if executor.tick() == 0 and executor.tick() == 0:
            cm.run_until_idle(max_seconds=max_seconds)
            return


# -- suggestions ---------------------------------------------------------------

SUGGESTION_SPECS = {
    "grid": {"algorithm": {"name": "grid"}, "parameters": [
        {"name": "a", "type": "double", "min": 0.0, "max": 1.0,
         "gridPoints": 3},
        {"name": "b", "type": "int", "list": [1, 2]}]},
    "grid_int": {"algorithm": {"name": "grid"}, "parameters": [
        {"name": "n", "type": "int", "min": 1, "max": 9, "gridPoints": 4}]},
    "random": {"algorithm": {"name": "random", "seed": 7}, "parameters": [
        {"name": "lr", "type": "double", "min": 1e-4, "max": 1e-1,
         "scale": "log"},
        {"name": "bs", "type": "int", "min": 8, "max": 64},
        {"name": "opt", "list": ["sgd", "adam"]}]},
    "none": {"parameters": []},
}


@pytest.mark.parametrize("name", list(SUGGESTION_SPECS))
@pytest.mark.parametrize("max_trials", [4, 100])
def test_suggestions_are_the_jax_packages(name, max_trials):
    from kubeflow_tpu.controllers.studyjob import (
        generate_suggestions as jgenerate,
    )

    spec = SUGGESTION_SPECS[name]
    got = generate_suggestions(spec, max_trials)
    assert got == jgenerate(spec, max_trials)
    assert got == generate_suggestions(spec, max_trials)  # seeded


def test_grid_cartesian_truncated():
    spec = SUGGESTION_SPECS["grid"]
    got = generate_suggestions(spec, 100)
    assert len(got) == 6
    assert {"a": 0.0, "b": 1} in got and {"a": 1.0, "b": 2} in got
    assert len(generate_suggestions(spec, 4)) == 4


def test_random_points_stay_in_range():
    got = generate_suggestions(SUGGESTION_SPECS["random"], 5)
    assert all(1e-4 <= s["lr"] <= 1e-1 for s in got)
    assert all(8 <= s["bs"] <= 64 for s in got)


def test_unknown_algorithm_raises():
    with pytest.raises(ValueError, match="quantum"):
        generate_suggestions({"algorithm": {"name": "quantum"},
                              "parameters": [{"name": "x", "list": [1]}]}, 2)


def test_set_by_path():
    tree = {"training": {"learning_rate": 0.1}}
    set_by_path(tree, "training.learning_rate", 0.01)
    set_by_path(tree, "training.mesh.data", 8)
    assert tree["training"]["learning_rate"] == 0.01
    assert tree["training"]["mesh"]["data"] == 8


# -- the study's lifecycle on FakePodRunner ------------------------------------------


def test_fan_out_respects_parallelism():
    store, cm, _ = make_harness()
    store.create(new_study_job(
        "s1", parameters=[{"name": "training.learning_rate",
                           "type": "double",
                           "list": [0.1, 0.01, 0.001, 0.0001]}],
        trial_template=TRIAL_TEMPLATE, max_trials=4, parallelism=2))
    cm.run_until_idle(max_seconds=10)
    trials = store.list(TRIAL, "default")
    assert len(trials) == 2  # parallelism cap
    assert store.get("StudyJob", "s1")["status"]["trialsRunning"] == 2
    assert {t["spec"]["training"]["learning_rate"] for t in trials} <= {
        0.1, 0.01, 0.001, 0.0001}
    # each trial is a gang of the template's topology: one pod a card
    assert len(store.list("Pod", "default")) == 8


@pytest.mark.parametrize("objective,losses,best", [
    ({"type": "minimize", "metric": "final_loss"}, [3.0, 1.5, 2.0], 1),
    ({"type": "maximize", "metric": "final_loss"}, [3.0, 1.5, 2.0], 0),
])
def test_completes_with_best_trial_fake_metrics(objective, losses, best):
    store, cm, executor = make_harness()
    store.create(new_study_job(
        "s2", objective=objective,
        parameters=[{"name": "training.seed", "type": "int",
                     "list": [1, 2, 3]}],
        trial_template=TRIAL_TEMPLATE, max_trials=3, parallelism=3))
    cm.run_until_idle(max_seconds=10)
    executor.tick()  # pending -> running
    for i, loss in enumerate(losses):
        store.patch_status("Pod", f"s2-trial-{i}-worker-0", "default", {
            "phase": "Running", "final_loss": str(loss),
            "items_per_sec": "10"})
    for pod in store.list("Pod", "default"):
        store.patch_status("Pod", pod["metadata"]["name"], "default",
                           dict(pod["status"], phase="Succeeded"))
    cm.run_until_idle(max_seconds=10)
    done = wait_for_condition(store, "StudyJob", "s2", "default",
                              "Completed", timeout_s=5)
    got = done["status"]["bestTrial"]
    assert got["index"] == best
    assert got["parameters"] == {"training.seed": best + 1}
    assert got["metric"]["final_loss"] == losses[best]
    assert got["allMetrics"] == {"final_loss": losses[best],
                                 "items_per_sec": 10.0}
    assert done["status"]["trialsSucceeded"] == 3


def test_failed_trials_fail_study():
    runner = FakePodRunner()
    store, cm, executor = make_harness(runner)
    store.create(new_study_job(
        "s4", parameters=[{"name": "training.seed", "type": "int",
                           "list": [1, 2]}],
        trial_template=TRIAL_TEMPLATE, max_trials=2, parallelism=2))
    cm.run_until_idle(max_seconds=10)
    for i in range(2):
        for w in range(4):
            runner.fail_next(f"s4-trial-{i}-worker-{w}", times=5)
    drive(cm, executor)
    done = wait_for_condition(store, "StudyJob", "s4", "default", "Failed",
                              timeout_s=10)
    cond = {c["type"]: c for c in done["status"]["conditions"]}["Failed"]
    assert cond["reason"] == "AllTrialsFailed"


def test_invalid_algorithm_fails_study():
    store, cm, _ = make_harness()
    store.create(new_study_job(
        "s5", algorithm={"name": "quantum-annealing"},
        parameters=[{"name": "x", "type": "double", "min": 0, "max": 1}],
        trial_template=TRIAL_TEMPLATE))
    cm.run_until_idle(max_seconds=10)
    done = wait_for_condition(store, "StudyJob", "s5", "default", "Failed",
                              timeout_s=5)
    cond = {c["type"]: c for c in done["status"]["conditions"]}["Failed"]
    assert cond["reason"] == "InvalidSpec"
    assert store.list(TRIAL, "default") == []


# -- real trials ---------------------------------------------------------------------

ONE_CARD = {
    "slice": {"topology": "h100-1"},
    "training": {"model": "mlp", "global_batch_size": 16, "steps": 3,
                 "dtype": "float32", "warmup_steps": 1,
                 "data": {"name": "blobs", "num_examples": 256},
                 "mesh": {"data": 1}, "checkpoint": {"enabled": False}},
    "runPolicy": {"maxRestarts": 0, "cleanPodPolicy": "None"},
}
# one real update (warmup 1: the first runs at lr 0, the second at the
# rate) at each rate, the third step's loss read after it
RATES = [0.1, 0.01]
# optax.adamw takes its bias corrections 1 - b**t in f32 (1 - 0.999 is
# 0.00099998713 there, rel -1.29e-5) and torch.optim.AdamW in float64, so
# the port's updates are about 1e-5 larger on every leaf. At lr 0.1 the
# update sends the loss from 2.30 to 6.70, and the final losses 2.207e-05
# apart (7.1e-08 with the correction taken in f32, F32BiasAdamW); at lr
# 0.01 2.4e-06 apart. Each rate's bound over the JAX loss:
TRIAL_REL = {0.1: 5e-5, 0.01: LOSS_REL}


class F32BiasAdamW(torch.optim.Optimizer):
    """optax.adamw's arithmetic as the JAX package runs it: b1 0.9, b2
    0.999, eps 1e-8 outside the sqrt, decay on every leaf times the lr,
    the bias corrections 1 - b**count taken in f32."""

    def __init__(self, params, weight_decay):
        super().__init__(params, dict(lr=0.0, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st.update(count=0, mu=torch.zeros_like(p),
                              nu=torch.zeros_like(p))
                st["count"] += 1
                st["mu"] = (1 - 0.9) * p.grad + 0.9 * st["mu"]
                st["nu"] = (1 - 0.999) * p.grad.square() + 0.999 * st["nu"]
                count = torch.tensor(float(st["count"]))
                bc1 = 1 - torch.tensor(0.9) ** count
                bc2 = 1 - torch.tensor(0.999) ** count
                u = (st["mu"] / bc1) / ((st["nu"] / bc2).sqrt() + 1e-8)
                p.add_(-torch.tensor(group["lr"]) * (
                    u + group["weight_decay"] * p))


def _rel(got, want):
    return abs(got - want) / abs(want)


def _study(new_study, warm_start, template):
    study = new_study(
        "ws", objective={"type": "minimize", "metric": "final_loss"},
        parameters=[{"name": "training.learning_rate", "type": "double",
                     "list": RATES}],
        trial_template=template, max_trials=len(RATES), parallelism=1)
    study["spec"]["warmStartFrom"] = warm_start
    return study


def test_a_warm_started_study_matches_the_jax_packages(tmp_path, devices8,
                                                       monkeypatch):
    """The JAX mlp's params, written as a checkpoint by the JAX package,
    warm-start a 2-trial grid study (minimize final_loss) in each
    package: each trial's final loss agrees within its TRIAL_REL and the
    best trial is the same. The lr 0.1 trial rerun with the port's AdamW
    given optax's f32 bias correction agrees within LOSS_REL: that
    correction is the whole of its gap."""
    from kubeflow_tpu.cluster.reconciler import ControllerManager as JCM
    from kubeflow_tpu.cluster.store import StateStore as JStore
    from kubeflow_tpu.config.core import from_dict
    from kubeflow_tpu.config.platform import TrainingConfig as JTraining
    from kubeflow_tpu.controllers.studyjob import (
        StudyJobController as JStudy,
        new_study_job as jnew_study,
    )
    from kubeflow_tpu.controllers.tpujob import TPUTrainJobController
    from kubeflow_tpu.runtime import executor as jexecutor
    from kubeflow_tpu.runtime.train_run import run_training as jrun

    import jax
    from kubeflow_tpu.parallel.mesh import MeshSpec, build_mesh

    parent = str(tmp_path / "parent")
    parent_cfg = from_dict(JTraining, {
        "model": "mlp", "global_batch_size": 16, "steps": 1,
        "dtype": "float32", "checkpoint": {"directory": parent,
                                           "async_save": False}})
    jrun(parent_cfg, mesh=build_mesh(MeshSpec.from_config(parent_cfg.mesh),
                                     devices=jax.devices()[:1]))

    class Recording(jexecutor.InProcessTrainerRunner):
        losses = {}

        def run(self, pod):
            out = super().run(pod)
            if out[0] == "Succeeded":
                self.losses[pod["metadata"]["name"]] = self.last_metrics["loss"]
            return out

    jstore = JStore()
    jcm = JCM(jstore)
    jcm.register(TPUTrainJobController())
    jcm.register(JStudy())
    jrunner = Recording()
    jstore.create(_study(jnew_study, parent, dict(
        ONE_CARD, slice={"topology": "v5e-1"})))
    # the JAX StudyJob writes its status on every pass, so its
    # run_until_idle never idles: each call runs for its max_seconds
    drive(jcm, jexecutor.PodExecutor(jstore, jrunner), max_seconds=0.5)
    jdone = wait_for_condition(jstore, "StudyJob", "ws", "default",
                               "Completed", timeout_s=5)

    runner = InProcessTrainerRunner(device="cpu")
    store, cm, executor = make_harness(runner)
    store.create(_study(new_study_job, parent, ONE_CARD))
    drive(cm, executor)
    done = wait_for_condition(store, "StudyJob", "ws", "default",
                              "Completed", timeout_s=5)

    got = {r["pod"]: r["result"] for r in runner.runs}
    assert sorted(got) == sorted(jrunner.losses) == [
        f"ws-trial-{i}-worker-0" for i in range(len(RATES))]
    for i, rate in enumerate(RATES):
        pod = f"ws-trial-{i}-worker-0"
        res = got[pod]
        assert res["warm_started"] and res["final_step"] == 3
        assert abs(res["loss"] - jrunner.losses[pod]) <= TRIAL_REL[rate] * abs(
            jrunner.losses[pod]), (rate, res["loss"], jrunner.losses[pod])
        spec = pod_env(store.get("Pod", pod))["KFT_TRAINING_SPEC"]
        assert f'"learning_rate": {rate}' in spec
        assert f'"warm_start_dir": "{parent}"' in spec
    best, jbest = done["status"]["bestTrial"], jdone["status"]["bestTrial"]
    assert best["index"] == jbest["index"]
    assert best["parameters"] == jbest["parameters"]
    assert done["status"]["trialsSucceeded"] == len(RATES)

    from kubeflow_tpu_torch.config.platform import TrainingConfig
    from kubeflow_tpu_torch.runtime.train_run import run_training
    from kubeflow_tpu_torch.training import trainer

    monkeypatch.setattr(trainer, "make_optimizer", lambda cfg, name, params:
                        F32BiasAdamW(params, cfg.weight_decay))
    spec = json.loads(pod_env(store.get("Pod", "ws-trial-0-worker-0"))[
        "KFT_TRAINING_SPEC"])
    assert spec["learning_rate"] == 0.1
    f32_bias = run_training(TrainingConfig.from_dict(spec), device="cpu")
    want = jrunner.losses["ws-trial-0-worker-0"]
    print(f"lr 0.1: JAX {want!r}, port {got['ws-trial-0-worker-0']['loss']!r}"
          f" (rel {_rel(got['ws-trial-0-worker-0']['loss'], want):.3e}), "
          f"port with f32 bias correction {f32_bias['loss']!r} (rel "
          f"{_rel(f32_bias['loss'], want):.3e})")
    assert _rel(f32_bias["loss"], want) <= LOSS_REL, (f32_bias["loss"], want)


def test_chip_smoke_phase_22a_rehearsal():
    """Phase 22a of chip_smoke.py as main runs it, on the CPU with mlp
    trials: the StudyJob over GPUTrainJob trials in the control plane's
    background mode, every gate of the phase (Completed, bestTrial the
    argmax, each pod's rate, finite losses, trial 0 against a direct
    run)."""
    from torch_gangs import chip_smoke

    trial = dict(model="mlp", global_batch_size=16, steps=3,
                 dtype="float32", mesh={"data": 1},
                 checkpoint={"enabled": False})
    assert chip_smoke().phase_job_study(torch, device="cpu",
                                        trial=trial) > 0
