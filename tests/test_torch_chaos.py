"""The port's fault injection (kubeflow_tpu_torch/chaos/) and the seams
that call it, held against the JAX package (kubeflow_tpu/chaos/) on the
CPU.

- The two packages share one catalog and one spec grammar, and for the
  same plan and seed the same calls fire (each point's stream is
  `random.Random(f"{seed}:{point}")` in both), through the env chain too.
- The checkpoint seams ride the manager's bounded retries: a transient
  fault is absorbed, a persistent commit fault leaves the step
  uncommitted (the JAX package reads the directory the same way).
- Training: `trainer.device_step` faults a run after its step-2 save and
  a restart resumes to the uninterrupted run's losses and params, bit for
  bit; `gang.host_exit` fails `run_training` before step 1, and the plan
  is disarmed on every exit path. A config's `chaos` and `observability`
  act only as the KFT_CHAOS_* / KFT_TRACE_* env the GPUTrainJob
  controller renders from them, as in the JAX package.
- The engine: an `engine.step` fault fails the residents and runs the
  recovery, which resets the pools, the allocator and the radix index,
  as the JAX engine's does. After it, the same prompt is a prefix MISS in
  both packages, with `generate()`'s tokens (the parent kept the radix
  index and answered a hit). `engine.prefill` fails one request only.
Every comparison is exact (tolerance 0): greedy tokens, counters, and f32
CPU training, which is deterministic run to run."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from kubeflow_tpu.chaos import (  # noqa: E402
    CATALOG as JCATALOG,
    ChaosController as JChaosController,
    ChaosError as JChaosError,
    ChaosSpecError as JChaosSpecError,
    configure_from_env as jconfigure_from_env,
    default_chaos as jdefault_chaos,
    parse_point as jparse_point,
    parse_points as jparse_points,
)
from kubeflow_tpu_torch.chaos import (  # noqa: E402
    CATALOG,
    ChaosController,
    ChaosError,
    ChaosSpecError,
    configure_from_env,
    default_chaos,
    parse_point,
    parse_points,
)
from kubeflow_tpu_torch.checkpointing import (  # noqa: E402
    CheckpointManager,
    latest_committed_step,
    restore_latest,
    restore_params,
)
from kubeflow_tpu_torch.config.platform import TrainingConfig  # noqa: E402
from kubeflow_tpu_torch.models import get_model  # noqa: E402
from kubeflow_tpu_torch.models.convert import load_jax_params  # noqa: E402
from kubeflow_tpu_torch.observability.trace import (  # noqa: E402
    default_tracer,
)
from kubeflow_tpu_torch.runtime.train_run import run_training  # noqa: E402
from kubeflow_tpu_torch.serving.engine import DecodeEngine  # noqa: E402
from kubeflow_tpu_torch.serving.generate import generate  # noqa: E402
from kubeflow_tpu_torch.utils.metrics import default_registry  # noqa: E402


@pytest.fixture(autouse=True)
def _always_disarm():
    """Both packages' controllers are process-global: no plan may leak
    out of a test into another suite."""
    yield
    default_chaos().disarm()
    jdefault_chaos().disarm()


def _fires(ctrl, error, calls):
    """Indices of `calls` (point names, in order) whose maybe_fail
    raised."""
    out = []
    for i, point in enumerate(calls):
        try:
            ctrl.maybe_fail(point)
        except error:
            out.append(i)
    return out


# -- catalog and grammar ---------------------------------------------------------


def test_catalog_is_the_jax_packages():
    assert CATALOG == JCATALOG


SPECS = [
    "engine.step",
    " trainer.device_step : p=0.25 , after=3 , once , attempt=2 ",
    "checkpoint.commit:once",
    "engine.prefill:p=1",
    "gang.host_exit:attempt=0",
    "fleet.scrape_fetch:after=0",
    # the JAX TestSpecGrammar's refusals
    "nope.unknown",
    "engine.step:p=1.5",
    "engine.step:p=0",
    "engine.step:after=-1",
    "engine.step:once=yes",
    "engine.step:frobnicate=1",
    "",
    "engine.step:attempt=-1",
    "engine.step:p=abc",
]


def _parsed(parse, error, spec):
    try:
        s = parse(spec)
    except error as e:
        return ("refused", type(e).__name__)
    return (s.point, s.probability, s.after, s.once, s.attempt, s.spec_str())


@pytest.mark.parametrize("spec", SPECS)
def test_parse_point_accepts_and_refuses_as_the_jax_package(spec):
    got = _parsed(parse_point, ChaosSpecError, spec)
    want = _parsed(jparse_point, JChaosSpecError, spec)
    assert got == want
    if got[0] != "refused":
        # round-trips through the string form the controllers render
        assert parse_point(got[-1]) == parse_point(spec)


def test_duplicate_points_refused_in_both():
    for parse, error in ((parse_points, ChaosSpecError),
                         (jparse_points, JChaosSpecError)):
        with pytest.raises(error, match="duplicate"):
            parse(["engine.step", "engine.step:once"])


# -- the same plan fires on the same calls ---------------------------------------

CALLS = (["engine.step", "engine.prefill", "checkpoint.commit",
          "trainer.device_step", "gang.host_exit"] * 12)

PLANS = [
    (["engine.step"], 0, 0),
    (["engine.step:p=0.3"], 7, 0),
    (["engine.step:p=0.3"], 8, 0),
    (["trainer.device_step:after=3"], 0, 0),
    (["trainer.device_step:after=3,once"], 0, 0),
    (["checkpoint.commit:p=0.5,once"], 11, 0),
    (["gang.host_exit:attempt=1"], 0, 1),
    (["gang.host_exit:attempt=1"], 0, 0),
    (["engine.prefill:p=0.25,after=2", "engine.step:p=0.5,after=1,once",
      "checkpoint.commit:p=0.7"], 3, 2),
]


@pytest.mark.parametrize("plan,seed,attempt", PLANS)
def test_same_plan_and_seed_fire_on_the_same_calls(plan, seed, attempt):
    port, ref = ChaosController(), JChaosController()
    port.arm(parse_points(plan), seed=seed, attempt=attempt)
    ref.arm(jparse_points(plan), seed=seed, attempt=attempt)
    assert port.enabled == ref.enabled
    assert port.armed_points() == ref.armed_points()
    got = _fires(port, ChaosError, CALLS)
    assert got == _fires(ref, JChaosError, CALLS)
    if plan == ["engine.step"]:
        assert len(got) == CALLS.count("engine.step")


ENVS = [
    {},
    {"KFT_CHAOS_POINTS": ""},
    {"KFT_CHAOS_POINTS": "engine.step:p=0.4;checkpoint.commit:once",
     "KFT_CHAOS_SEED": "5"},
    {"KFT_CHAOS_POINTS": "trainer.device_step:attempt=1,after=2",
     "KFT_CHAOS_ATTEMPT": "1"},
    {"KFT_CHAOS_POINTS": "trainer.device_step:attempt=1",
     "KFT_CHAOS_ATTEMPT": "0"},
]


@pytest.mark.parametrize("env", ENVS)
def test_the_env_chain_behaves_as_the_jax_packages(env):
    armed = configure_from_env(env)
    jarmed = jconfigure_from_env(env)
    assert armed == jarmed
    assert default_chaos().armed_points() == jdefault_chaos().armed_points()
    assert (_fires(default_chaos(), ChaosError, CALLS)
            == _fires(jdefault_chaos(), JChaosError, CALLS))
    # an env without a plan disarms: it is the whole truth
    configure_from_env({})
    assert default_chaos().enabled is False


def test_disarmed_maybe_fail_is_a_no_op_and_faults_are_counted():
    ctrl = ChaosController()
    assert ctrl.enabled is False
    for _ in range(1000):
        ctrl.maybe_fail("engine.step")
    counter = default_registry().counter(
        "kft_faults_injected_total", "", ["point"])
    before = counter.value(point="checkpoint.commit")
    ctrl.arm([parse_point("checkpoint.commit:once")])
    assert _fires(ctrl, ChaosError, ["engine.step", "checkpoint.commit"] * 2) == [1]
    assert counter.value(point="checkpoint.commit") - before == 1


# -- checkpoint seams --------------------------------------------------------------


def _state():
    return {"params": {"w": torch.arange(8, dtype=torch.float32)}}


def _manager(tmp_path):
    return CheckpointManager(str(tmp_path / "ckpt"), async_save=False)


@pytest.mark.parametrize("point", ["checkpoint.shard_write",
                                   "checkpoint.commit"])
def test_a_transient_save_fault_is_absorbed_by_the_retry(tmp_path, point):
    default_chaos().arm([parse_point(f"{point}:once")])
    with _manager(tmp_path) as mgr:
        assert mgr.save(2, _state(), force=True)
    assert latest_committed_step(str(tmp_path / "ckpt")) == 2
    from kubeflow_tpu.checkpointing import (
        latest_committed_step as jlatest_committed_step,
    )

    assert jlatest_committed_step(str(tmp_path / "ckpt")) == 2


def test_a_persistent_commit_fault_leaves_the_step_uncommitted(tmp_path):
    from kubeflow_tpu.checkpointing import (
        latest_committed_step as jlatest_committed_step,
    )

    default_chaos().arm([parse_point("checkpoint.commit")])  # every call
    with _manager(tmp_path) as mgr:
        with pytest.raises(ChaosError):
            mgr.save(6, _state(), force=True)
    directory = str(tmp_path / "ckpt")
    # the shards are on disk, no manifest names them: neither package
    # sees a step
    assert latest_committed_step(directory) is None
    assert jlatest_committed_step(directory) is None


@pytest.mark.parametrize("reader", ["restore_latest", "restore_params"])
def test_a_transient_restore_fault_is_absorbed_by_the_retry(tmp_path, reader):
    with _manager(tmp_path) as mgr:
        mgr.save(2, _state(), force=True)
    default_chaos().arm([parse_point("checkpoint.restore:once")])
    directory = str(tmp_path / "ckpt")
    if reader == "restore_latest":
        out = restore_latest(directory, _state())["params"]
    else:
        out = restore_params(directory)
    assert torch.equal(out["w"], _state()["params"]["w"])
    assert default_chaos().armed_points() == ["checkpoint.restore"]


# -- training seams ----------------------------------------------------------------

TRAIN = dict(model="gpt_tiny", global_batch_size=4, steps=4, seq_len=64,
             learning_rate=1e-3, warmup_steps=1, weight_decay=0.1,
             dtype="float32", seed=0)


def _train_cfg(directory, **kw):
    ckpt = dict(directory=str(directory), interval_steps=2)
    ckpt.update(kw.pop("checkpoint", {}))
    return TrainingConfig(**{**TRAIN, **kw}, checkpoint=ckpt)


def test_a_device_step_fault_after_the_step_2_save_resumes_bitwise(tmp_path):
    """trainer.device_step:after=2,once fails step 3 of a run that saves
    every 2 steps; the restart without the plan resumes from step 2, and
    its losses and final params are the uninterrupted run's, bit for
    bit."""
    from kubeflow_tpu_torch.training.trainer import Trainer

    default_tracer().configure(enabled=True)
    whole_trainer = Trainer(_train_cfg(tmp_path / "whole"), device="cpu")
    whole = run_training(_train_cfg(tmp_path / "whole"), device="cpu",
                         log_every=1, trainer=whole_trainer)
    cut_dir = tmp_path / "cut"
    with pytest.raises(ChaosError, match="trainer.device_step"):
        run_training(_train_cfg(cut_dir), device="cpu", log_every=1,
                     environ={"KFT_CHAOS_POINTS":
                              "trainer.device_step:after=2,once"})
    assert default_chaos().enabled is False
    assert latest_committed_step(str(cut_dir)) == 2
    trainer = Trainer(_train_cfg(cut_dir), device="cpu")
    resumed = run_training(_train_cfg(cut_dir), restore=True, device="cpu",
                           log_every=1, environ={}, trainer=trainer)
    assert resumed["final_step"] == 4
    assert resumed["losses"] == whole["losses"][2:]
    got = dict(trainer._final_state.model.named_parameters())
    want = dict(whole_trainer._final_state.model.named_parameters())
    assert got.keys() == want.keys()
    for name in want:
        assert torch.equal(got[name], want[name]), name
    spans = {r.name for r in default_tracer().snapshot()}
    assert {"train.device_step", "train.host_wait",
            "train.checkpoint_block", "train.compile_fence"} <= spans


def _rendered_env(training):
    """The env GPUTrainJobController renders into the pod of a one-card
    job with this training spec (controllers/gpujob.py)."""
    from kubeflow_tpu_torch.cluster.reconciler import ControllerManager
    from kubeflow_tpu_torch.cluster.store import StateStore
    from kubeflow_tpu_torch.controllers.gpujob import (
        GPUTrainJobController,
        new_gpu_train_job,
    )
    from kubeflow_tpu_torch.runtime.executor import pod_env

    store = StateStore()
    cm = ControllerManager(store)
    cm.register(GPUTrainJobController())
    store.create(new_gpu_train_job("c", training=training,
                                   slice_spec={"topology": "h100-1"}))
    cm.run_until_idle(max_seconds=5)
    return pod_env(store.get("Pod", "c-worker-0"))


@pytest.mark.parametrize("source", ["env", "config"])
def test_gang_host_exit_fails_the_run_before_step_1(tmp_path, source):
    if source == "env":
        cfg = _train_cfg(tmp_path / "c", steps=1)
        environ = {"KFT_CHAOS_POINTS": "gang.host_exit"}
    else:
        # only the env is read, as in the JAX package: the config's plan
        # alone neither fires nor is refused; the controller renders it
        # into the pod's env, and that env fires it
        plan = {"enabled": True, "points": ["gang.host_exit"]}
        alone = run_training(
            _train_cfg(tmp_path / "alone", steps=1, chaos=plan,
                       checkpoint={"enabled": False}),
            device="cpu", environ={})
        assert alone["final_step"] == 1
        cfg = _train_cfg(tmp_path / "c", steps=1, chaos=plan)
        environ = _rendered_env({**TRAIN, "steps": 1, "chaos": plan})
        assert environ["KFT_CHAOS_POINTS"] == "gang.host_exit"
        assert environ["KFT_CHAOS_ATTEMPT"] == "0"
    with pytest.raises(ChaosError, match="gang.host_exit"):
        run_training(cfg, device="cpu", environ=environ)
    assert default_chaos().enabled is False
    assert latest_committed_step(str(tmp_path / "c")) is None


def test_a_config_observability_is_refused_until_a_controller_renders_it(
        tmp_path):
    """The controller renders a config's `observability` (the JAX
    package's behaviour): the run given the config alone neither refuses
    it nor applies it, and the pod env GPUTrainJobController renders
    carries it as KFT_TRACE_*, which the run applies to the tracer."""
    obs = {"trace_sample_prob": 0.5, "trace_buffer_spans": 64}
    tracer = default_tracer()
    before = (tracer._sample_prob, tracer._capacity)
    cfg = _train_cfg(tmp_path / "o", steps=1, observability=obs,
                     checkpoint={"enabled": False})
    try:
        assert run_training(cfg, device="cpu", environ={})["final_step"] == 1
        assert (tracer._sample_prob, tracer._capacity) == before
        environ = _rendered_env({**TRAIN, "steps": 1, "observability": obs,
                                 "checkpoint": {"enabled": False}})
        assert {k: v for k, v in environ.items()
                if k.startswith("KFT_TRACE_")} == {
            "KFT_TRACE_ENABLED": "1", "KFT_TRACE_BUFFER_SPANS": "64",
            "KFT_TRACE_STATUSZ": "1", "KFT_TRACE_SAMPLE_PROB": "0.5",
            "KFT_TRACE_SAMPLE_KEEP": "128"}
        run_training(cfg, device="cpu", environ=environ)
        assert (tracer._sample_prob, tracer._capacity) == (0.5, 64)
    finally:
        tracer.configure(sample_prob=before[0], capacity=before[1])
    assert latest_committed_step(str(tmp_path / "o")) is None


def test_the_plan_is_disarmed_on_every_exit_path(tmp_path):
    # a run that completes with its plan armed (a point it never reaches)
    out = run_training(
        _train_cfg(tmp_path / "ok", steps=1, checkpoint={"enabled": False}),
        device="cpu", environ={"KFT_CHAOS_POINTS": "engine.step"})
    assert out["final_step"] == 1
    assert default_chaos().enabled is False
    # a run that fails mid-fit with the plan armed
    with pytest.raises(ChaosError):
        run_training(_train_cfg(tmp_path / "bad", steps=2),
                     device="cpu",
                     environ={"KFT_CHAOS_POINTS": "trainer.device_step"})
    assert default_chaos().enabled is False
    # an env without a plan disarms one armed by hand
    default_chaos().arm([parse_point("engine.step")])
    run_training(_train_cfg(tmp_path / "x", steps=1,
                            checkpoint={"enabled": False}),
                 device="cpu", environ={})
    assert default_chaos().enabled is False


# -- engine seams (C4: the recovery's pool reset) ---------------------------------

ROW = (np.arange(20) * 7 + 3) % 512
MAX_NEW = 5


@pytest.fixture(scope="module")
def tiny(gpt_and_params):
    jmodel, params = gpt_and_params
    tmodel = get_model("gpt_tiny", dtype=torch.float32, device="cpu")
    load_jax_params(tmodel, jax.tree.map(np.asarray, params))
    return jmodel, params, tmodel


def _fault_sequence(engine, arm, disarm, error):
    """Serve ROW (its pages commit), serve it again under engine.step:once
    (the admission is a prefix hit, then the step fails and recovery
    runs), then serve it a third time, disarmed → (failure, last tokens,
    stats)."""
    first = engine.generate_row(ROW, MAX_NEW, timeout=120)
    arm()
    with pytest.raises(RuntimeError, match="decode step failed") as failed:
        engine.submit(ROW, MAX_NEW).wait(120)
    disarm()
    last = engine.generate_row(ROW, MAX_NEW, timeout=120)
    assert last["tokens"] == first["tokens"]
    return failed.value, last["tokens"], engine.stats()


KEYS = ("admitted", "prefix_lookups", "prefix_hit_tokens", "cow_copies",
        "prefill_compute_tokens", "pages_in_use", "pages_total")


def test_an_engine_step_fault_recovers_as_the_jax_engine_does(tiny):
    """The same weights and plan in both engines: each fails its resident
    with "decode step failed" (the cause kept), counts one recovery and
    records engine.recover; afterwards the prompt is a prefix miss in
    both (the radix index was reset) with `generate()`'s tokens, and the
    stats agree."""
    from kubeflow_tpu.observability.trace import default_tracer as jtracer
    from kubeflow_tpu.serving.engine import DecodeEngine as JDecodeEngine
    from kubeflow_tpu.utils.metrics import default_registry as jregistry

    jmodel, params, tmodel = tiny
    counter = default_registry().counter(
        "serving_engine_recoveries_total", "", ["model"])
    jtr, tr = jtracer(), default_tracer()
    jtr.configure(enabled=True)
    tr.configure(enabled=True)
    jeng = JDecodeEngine("c4", jmodel, params, num_slots=1, max_queue=4,
                         page_size=8)
    try:
        jcounter = jregistry().get("serving_engine_recoveries_total")
        jbefore = jcounter.value(model="c4")
        jfail, jtokens, jstats = _fault_sequence(
            jeng, lambda: jdefault_chaos().arm(
                [jparse_point("engine.step:once")]),
            jdefault_chaos().disarm, JChaosError)
        assert jcounter.value(model="c4") - jbefore == 1
    finally:
        jeng.close()
    eng = DecodeEngine("c4", tmodel, device="cpu", num_slots=1, max_queue=4,
                       page_size=8)
    pool_ptr = eng._pool.k.data_ptr()
    try:
        before = counter.value(model="c4")
        tr.clear()
        fail, tokens, stats = _fault_sequence(
            eng, lambda: default_chaos().arm(
                [parse_point("engine.step:once")]),
            default_chaos().disarm, ChaosError)
        assert counter.value(model="c4") - before == 1
        (event,) = [r for r in tr.snapshot() if r.name == "engine.recover"]
        assert event.attrs == {"model": "c4", "residents": 1,
                               "error": "ChaosError"}
        # the pools were reset in place, not allocated again
        assert eng._pool.k.data_ptr() == pool_ptr
    finally:
        eng.close()
    assert any(r.name == "engine.recover" for r in jtr.snapshot())
    assert isinstance(fail.__cause__, ChaosError)
    assert isinstance(jfail.__cause__, JChaosError)
    want = np.asarray(generate(tmodel, ROW[None], MAX_NEW))[0, len(ROW):]
    assert tokens == jtokens == want.tolist()
    # the faulted admission was a hit; the one after recovery a miss
    assert stats["prefix_lookups"] == 3
    assert stats["prefix_hit_tokens"] == len(ROW) - 1
    assert {k: stats[k] for k in KEYS} == {k: jstats[k] for k in KEYS}


def test_recovery_zeroes_both_pools_of_a_drafted_engine(tiny):
    _, _, tmodel = tiny
    eng = DecodeEngine("c4d", tmodel, device="cpu", num_slots=2,
                       page_size=8, draft_model=tmodel, num_draft_tokens=2,
                       paged_attention="kernel")
    try:
        eng.generate_row(ROW, MAX_NEW, timeout=120)
        default_chaos().arm([parse_point("engine.step:once")])
        with pytest.raises(RuntimeError, match="decode step failed"):
            eng.submit(ROW, MAX_NEW).wait(120)
        default_chaos().disarm()
        st = eng.stats()
        assert st["pages_in_use"] == st["prefix_index_pages"] == 0
        for pool in (eng._pool, eng._draft_pool):
            assert all(not t.any() for t in pool.tensors())
        out = eng.generate_row(ROW, MAX_NEW, timeout=120)
    finally:
        eng.close()
    want = np.asarray(generate(tmodel, ROW[None], MAX_NEW))[0, len(ROW):]
    assert out["tokens"] == want.tolist()


def test_a_failure_inside_recovery_still_fails_the_resident(tiny,
                                                           monkeypatch):
    """A second failure inside recovery (on the card, the first zero_()
    on a context a sticky CUDA error poisoned raises again) is not
    caught: it ends the scheduler thread. The resident's future has
    failed with the decode step's error before that, so its caller does
    not wait out its timeout."""
    _, _, tmodel = tiny

    class Poisoned:
        """A pool tensor whose zero_() raises; everything else reaches
        the tensor."""

        def __init__(self, t):
            self.t = t

        def __getattr__(self, name):
            return getattr(self.t, name)

        def __getitem__(self, index):
            return self.t[index]

        def __setitem__(self, index, value):
            self.t[index] = value

        def zero_(self):
            raise RuntimeError("CUDA error: an illegal memory access was "
                               "encountered")

    eng = DecodeEngine("c4z", tmodel, device="cpu", num_slots=1,
                       max_queue=4, page_size=8)
    try:
        eng.generate_row(ROW, MAX_NEW, timeout=120)
        tensors = eng._pool.tensors()
        monkeypatch.setattr(eng._pool, "tensors",
                            lambda: [Poisoned(t) for t in tensors])
        default_chaos().arm([parse_point("engine.step:once")])
        with pytest.raises(RuntimeError, match="decode step failed") as failed:
            eng.submit(ROW, MAX_NEW).wait(60)
        assert isinstance(failed.value.__cause__, ChaosError)
        eng._thread.join(timeout=30)
        assert not eng._thread.is_alive()
    finally:
        default_chaos().disarm()
        eng.close()


def test_an_engine_prefill_fault_fails_one_request_only(tiny):
    _, _, tmodel = tiny
    eng = DecodeEngine("c4p", tmodel, device="cpu", num_slots=1, max_queue=4,
                       page_size=8)
    try:
        default_chaos().arm([parse_point("engine.prefill:once")])
        with pytest.raises(ChaosError):
            eng.submit(ROW, 3).wait(60)
        # the fault consumed itself; the engine was never poisoned
        out = eng.generate_row(ROW, 3, timeout=120)
        recoveries = default_registry().counter(
            "serving_engine_recoveries_total", "", ["model"]
        ).value(model="c4p")
    finally:
        eng.close()
    want = np.asarray(generate(tmodel, ROW[None], 3))[0, len(ROW):]
    assert out["tokens"] == want.tolist()
    assert recoveries == 0


def test_chip_smoke_chaos_phase_rehearses_on_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's phase 14 on the CPU at gpt_tiny size: phase 5's
    rehearsal traffic traced and untraced (tokens bitwise phase 5's, ids
    echoed, the traceparent continued, each request's spans and
    /tracez), an engine.step fault with the traffic in flight (failed
    requests 500, one recovery, no page leaked, resubmissions equal
    phase 5's and miss, the warm-up prompt a miss), engine.prefill:once;
    then 14c's faulted run and its bitwise resume against phase 12's
    rehearsal. CPU tensors take the plain versions (no launches), and
    the span-against-step-time gate is left to the card: CPU step times
    on a shared box are noise."""
    import importlib.util
    import os

    for knob in ("DRAFT_MODEL", "DRAFT_TOKENS", "DRAFT_CHECKPOINT_DIR",
                 "QUANTIZE", "NUM_SLOTS"):
        monkeypatch.delenv(f"KFT_SERVING_{knob}", raising=False)
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    traffic = dict(model="gpt_tiny", device="cpu", max_new=16,
                   buckets="8,16,32")
    f32_model = get_model("gpt_tiny", dtype=torch.float32, device="cpu")
    _, k0, _ = smoke.phase_serve_bf16(
        torch, f32_model, short=(3, 5, 9, 17, 30), long_len=90, hit_len=40,
        **traffic)
    launches = smoke.phase_chaos_serve(torch, k0, step_after=3,
                                       span_rel=None, **traffic)
    assert not any(launches.values())
    overrides = dict(model="gpt_tiny", seq_len=128)
    _, trainer, _ = smoke.phase_ckpt_train(
        torch, str(tmp_path / "ckpt"), overrides=overrides, device="cpu")
    params = {name: p.detach().cpu().clone() for name, p
              in trainer._final_state.model.named_parameters()}
    launches = smoke.phase_chaos_train(
        torch, str(tmp_path), list(trainer.losses), params,
        overrides=overrides, device="cpu")
    assert launches == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
