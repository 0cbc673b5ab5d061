"""The port's checkpointing (kubeflow_tpu_torch/checkpointing/,
training/checkpoint.py, runtime/train_run.py's restore gate, serving's
checkpoint load) on the CPU at gpt_tiny size in f32.

The JAX package's own cases (tests/test_checkpointing.py) run on the
port's manager: the async round trip, interval and force, a kill
mid-save, a foreign torn directory, double close, the bounded in-flight
window, blocked time, retention, `restore_params` and warm start. Then
the two packages read each other's checkpoints: (a) a JAX `Trainer`
state saved over a 2-device mesh (leaves split across shard files)
restores into the port bitwise; (b) a port state restores into the JAX
`TrainState` bitwise; (c) the port resumes (a) for step 3 and matches
the JAX trainer's step 3 at tests/test_torch_train.py's bounds (losses
rel 1e-5, params atol 2e-5: the two frameworks' summation orders; every
parameter but the attention key biases, whose update is rounding noise
in both); (d)
an async save holds the pre-step values though the step updates the
state in place right after it; (e) `run_training` preempted at step 2
and resumed equals an uninterrupted run bitwise; (f) the port's server
on a checkpoint gives the JAX server's tokens on the same directory;
(g) bf16 crosses without ml_dtypes and float8 raises. Every other check
is bitwise (tolerance 0)."""

import filecmp
import json
import os
import threading
import time
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa: E402

from kubeflow_tpu.checkpointing import (  # noqa: E402
    CheckpointManager as JCheckpointManager,
    restore_params as jrestore_params,
)
from kubeflow_tpu.config.platform import (  # noqa: E402
    MeshConfig,
    TrainingConfig as JTrainingConfig,
)
from kubeflow_tpu.models.registry import get_model as jget_model  # noqa: E402
from kubeflow_tpu.parallel.mesh import mesh_from_config  # noqa: E402
from kubeflow_tpu.training.data import make_global_batch  # noqa: E402
from kubeflow_tpu.training.tasks import CausalLmTask as JCausalLmTask  # noqa: E402
from kubeflow_tpu.training.trainer import Trainer as JTrainer  # noqa: E402
from kubeflow_tpu_torch.checkpointing import (  # noqa: E402
    CheckpointManager,
    latest_committed_step,
    restore_params,
    restore_subtree,
)
from kubeflow_tpu_torch.checkpointing import layout  # noqa: E402
from kubeflow_tpu_torch.checkpointing.quantize import (  # noqa: E402
    quantize_params_int8,
)
from kubeflow_tpu_torch.config.platform import (  # noqa: E402
    CheckpointConfig,
    ConfigError,
    TrainingConfig,
)
from kubeflow_tpu_torch.models.convert import (  # noqa: E402
    jax_path,
    params_from_jax,
    params_to_jax,
    quantized_params_from_jax,
)
from kubeflow_tpu_torch.runtime.train_run import run_training  # noqa: E402
from kubeflow_tpu_torch.serving.generate import generate  # noqa: E402
from kubeflow_tpu_torch.serving.main import build_server  # noqa: E402
from kubeflow_tpu_torch.serving.server import (  # noqa: E402
    restore_checkpoint_params,
)
from kubeflow_tpu_torch.training.tasks import CausalLmTask  # noqa: E402
from kubeflow_tpu_torch.training.trainer import Trainer  # noqa: E402
from kubeflow_tpu_torch.utils.metrics import (  # noqa: E402
    checkpoint_blocked_histogram,
    checkpoint_save_histogram,
)

SEQ, BATCH, VOCAB = 64, 4, 512
CFG = dict(model="gpt_tiny", global_batch_size=BATCH, steps=3,
           learning_rate=1e-3, warmup_steps=1, weight_decay=0.1,
           dtype="float32", seed=0)


def make_state():
    """A small state with a f32 matrix, a bf16 vector and an int32
    scalar (the three kinds a real state mixes)."""
    return {
        "step": torch.tensor(7, dtype=torch.int32),
        "params": {"dense": {
            "kernel": torch.arange(32, dtype=torch.float32).reshape(8, 4),
            "bias": torch.linspace(-1, 1, 4).to(torch.bfloat16),
        }},
    }


def leaves(tree, prefix=""):
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from leaves(v, key)
        else:
            yield key, v


def assert_trees_equal(a, b):
    a, b = dict(leaves(a)), dict(leaves(b))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k


def assert_bitwise(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.detach().cpu()
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.reshape(-1).view(torch.uint8).numpy(),
                                  np.ascontiguousarray(want).reshape(-1)
                                  .view(np.uint8))


# -- the JAX package's manager cases on the port's manager ----------------------


def test_async_save_restore_roundtrip(tmp_path):
    state = make_state()
    with CheckpointManager(str(tmp_path)) as mgr:
        assert mgr.save(1, state)
        mgr.wait()
        assert mgr.latest_step() == 1
        restored = mgr.restore(state)
    assert_trees_equal(restored, state)
    manifest = layout.read_manifest(layout.step_dir(str(tmp_path), 1))
    assert manifest["format"] == "kft-checkpoint-v1"
    assert {e["key"]: e["dtype"] for e in manifest["leaves"]} == {
        "step": "int32", "params/dense/kernel": "float32",
        "params/dense/bias": "bfloat16"}
    assert sorted(os.listdir(layout.step_dir(str(tmp_path), 1))) == [
        "l00000.full.bin", "l00001.0-8_0-4.bin", "l00002.0-4.bin",
        "manifest.json"]


def test_restore_missing_and_url_directories_raise(tmp_path):
    with CheckpointManager(str(tmp_path / "empty"), async_save=False) as mgr:
        assert mgr.latest_step() is None
        with pytest.raises(FileNotFoundError):
            mgr.restore({})
    with pytest.raises(ValueError, match="URL scheme"):
        CheckpointManager("gs://bucket/run")


def test_save_interval_and_force(tmp_path):
    state = make_state()
    with CheckpointManager(str(tmp_path), async_save=False,
                           save_interval_steps=2) as mgr:
        assert not mgr.save(1, state)  # off-interval: skipped
        assert mgr.save(2, state)
        assert mgr.save(3, state, force=True)  # preempt-save path
        assert not mgr.save(3, state, force=True)  # already committed
        assert mgr.all_steps() == [2, 3]


def test_kill_mid_save_leaves_latest_valid(tmp_path):
    """A crash between shards and manifest leaves the previous step as
    latest; a stale torn directory is swept by a later retention pass,
    a fresh one is spared."""
    state = make_state()
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.save(1, state)
    mgr.wait()
    mgr._crash_after_shards = True
    assert mgr.save(2, state)
    with pytest.raises(RuntimeError, match="simulated crash"):
        mgr.wait()
    torn = layout.step_dir(str(tmp_path), 2)
    assert os.path.isdir(torn)
    assert not os.path.exists(os.path.join(torn, layout.MANIFEST))
    assert mgr.latest_step() == 1
    assert int(mgr.restore(state)["step"]) == 7
    mgr._crash_after_shards = False
    assert mgr.save(3, state)
    mgr.wait()
    assert mgr.all_steps() == [1, 3]
    assert os.path.isdir(torn)
    old = time.time() - mgr.commit_timeout_s - 60
    os.utime(torn, (old, old))
    assert mgr.save(4, state)
    mgr.wait()
    assert not os.path.isdir(torn)
    mgr.close()


def test_foreign_torn_dir_invisible(tmp_path):
    torn = layout.step_dir(str(tmp_path), 99)
    os.makedirs(torn)
    with open(os.path.join(torn, "l00000.full.bin"), "wb") as f:
        f.write(b"\x00" * 16)
    assert latest_committed_step(str(tmp_path)) is None
    with CheckpointManager(str(tmp_path), async_save=False) as mgr:
        old = time.time() - mgr.commit_timeout_s - 60
        os.utime(torn, (old, old))
        assert mgr.latest_step() is None
        mgr.save(1, make_state())
        assert mgr.latest_step() == 1
    assert not os.path.isdir(torn)


def test_double_close_idempotent(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, make_state())
    mgr.close()
    mgr.close()
    with pytest.raises(RuntimeError, match="closed"):
        mgr.save(2, make_state())


def _gated_writes(monkeypatch):
    gate = threading.Event()
    real_write = layout.atomic_write_bytes

    def slow_write(path, data):
        gate.wait(timeout=10)
        real_write(path, data)

    monkeypatch.setattr(
        "kubeflow_tpu_torch.checkpointing.manager.layout.atomic_write_bytes",
        slow_write,
    )
    return gate


def test_bounded_in_flight_blocks_when_full(tmp_path, monkeypatch):
    state = make_state()
    gate = _gated_writes(monkeypatch)
    mgr = CheckpointManager(str(tmp_path), max_in_flight=1)
    try:
        assert mgr.save(1, state)  # the writer waits at the gate
        second_done = threading.Event()

        def second():
            mgr.save(2, state)
            second_done.set()

        t = threading.Thread(target=second)
        t.start()
        time.sleep(0.2)
        assert not second_done.is_set()  # blocked on the window
        gate.set()
        t.join(timeout=10)
        assert second_done.is_set()
        mgr.wait()
        assert mgr.all_steps() == [1, 2]
    finally:
        gate.set()
        mgr.close()


def test_blocked_time_excludes_write_time_when_async(tmp_path, monkeypatch):
    """save() returns (its blocked leg observed) while the writer still
    holds the uncommitted step; wait() completes it."""
    gate = _gated_writes(monkeypatch)
    blocked, saved = checkpoint_blocked_histogram(), checkpoint_save_histogram()
    b0, s0 = blocked.count(), saved.count()
    mgr = CheckpointManager(str(tmp_path))
    try:
        mgr.save(1, make_state())
        assert blocked.count() == b0 + 1 and saved.count() == s0
        assert mgr.latest_step() is None
        gate.set()
        mgr.wait()
        assert saved.count() == s0 + 1 and mgr.latest_step() == 1
    finally:
        gate.set()
        mgr.close()


def test_keep_last_n_and_keep_every_k(tmp_path):
    with CheckpointManager(str(tmp_path), keep=2, keep_every=4,
                           async_save=False) as mgr:
        for s in range(1, 8):
            mgr.save(s, make_state(), force=True)
        assert mgr.all_steps() == [4, 6, 7]


def test_restore_params_nested_dict_and_subtree(tmp_path):
    state = make_state()
    with CheckpointManager(str(tmp_path), async_save=False) as mgr:
        mgr.save(5, state)
    params = restore_params(str(tmp_path))
    assert_trees_equal(params, state["params"])
    with pytest.raises(KeyError):
        restore_params(str(tmp_path), prefix="nonexistent")
    # onto a target's dtypes (bias widened to f32) and devices
    target = {"dense": {"kernel": torch.zeros(8, 4),
                        "bias": torch.zeros(4)}}
    warm = restore_subtree(str(tmp_path), target)
    assert torch.equal(warm["dense"]["kernel"], state["params"]["dense"]["kernel"])
    assert torch.equal(warm["dense"]["bias"],
                       state["params"]["dense"]["bias"].float())
    with pytest.raises(ValueError, match="shape"):
        restore_subtree(str(tmp_path), {"dense": {"kernel": torch.zeros(4, 8)}})


def test_checkpoint_config_defaults_and_checks():
    cfg = TrainingConfig.from_dict({"model": "gpt_tiny",
                                    "checkpoint": {"interval_steps": 5}})
    assert isinstance(cfg.checkpoint, CheckpointConfig)
    assert (cfg.checkpoint.enabled, cfg.checkpoint.interval_steps,
            cfg.checkpoint.keep, cfg.checkpoint.async_save,
            cfg.checkpoint.max_in_flight) == (True, 5, 3, True, 2)
    for bad in ({"keep": 0}, {"interval_steps": 0}, {"max_in_flight": 0},
                {"keep_every": -1}):
        with pytest.raises(ConfigError):
            CheckpointConfig(**bad)
    with pytest.raises(ConfigError, match="unknown field checkpoint.bogus"):
        TrainingConfig.from_dict({"model": "gpt_tiny",
                                  "checkpoint": {"bogus": 1}})


@pytest.mark.parametrize("layout_name", ["named", "scan"])
def test_params_to_jax_gives_the_jax_tree(gpt_and_params, layout_name):
    """`params_to_jax` is the JAX tree's flat form (its key paths, shapes
    and bits), and `params_from_jax` of it is the state dict again."""
    from kubeflow_tpu.checkpointing.layout import path_str as jpath_str
    from kubeflow_tpu.models.gpt import stack_layer_params

    _, params = gpt_and_params
    tree = params if layout_name == "named" else stack_layer_params(params, 2)
    want = {jpath_str(path): np.asarray(leaf) for path, leaf
            in jax.tree_util.tree_flatten_with_path(tree)[0]}
    sd = params_from_jax(jax.tree.map(np.asarray, tree))
    got = params_to_jax(sd, layout_name)
    assert got.keys() == want.keys()
    for path, arr in want.items():
        assert_bitwise(torch.from_numpy(got[path]), arr)
    probe = ("layer_0/attention/query/kernel" if layout_name == "named"
             else "layers/block/attention/query/kernel")
    assert got[probe].shape == ((64, 4, 16) if layout_name == "named"
                                else (2, 64, 4, 16))
    back = params_from_jax(got)
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], sd[k]) for k in sd)


# -- the two packages read each other's checkpoints ------------------------------


def _jax_trainer(devices8):
    cfg = JTrainingConfig(mesh=MeshConfig(data=1), **CFG)
    mesh = mesh_from_config(cfg.mesh, devices=devices8[:1])
    task = JCausalLmTask(cfg, seq_len=SEQ, vocab_size=VOCAB)
    tr = JTrainer(cfg, mesh=mesh, task=task,
                  model=jget_model("gpt_tiny", dtype=jnp.float32))
    return tr, mesh, task


def _port_trainer(**ckpt):
    cfg = TrainingConfig(**CFG, checkpoint=ckpt or {"enabled": False})
    return Trainer(cfg, device="cpu",
                   task=CausalLmTask(cfg, seq_len=SEQ, vocab_size=VOCAB))


def _split_over_two_devices(tree, devices8):
    """Every leaf whose first dim is even split over 2 devices along it
    (so its checkpoint has 2 shard files); the rest replicated."""
    mesh = Mesh(np.array(devices8[:2]).reshape(1, 2), ("data", "fsdp"))

    def put(x):
        spec = P("fsdp") if x.ndim and x.shape[0] % 2 == 0 else P()
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree.map(put, tree)


@pytest.fixture(scope="module")
def jax_ckpt(devices8, tmp_path_factory):
    """The JAX trainer's 3 steps; its step-2 state saved through the JAX
    manager with leaves split across shard files. → (dir, step-2 state as
    numpy, step-3 loss, step-3 params as numpy)."""
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    tr, mesh, task = _jax_trainer(devices8)
    state = tr.init_state()
    data = task.synthetic_data()
    losses = []
    for i in range(3):
        batch = make_global_batch(data.batch_at(i), mesh)
        state, m = tr.train_step(state, batch, jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
        if i == 1:
            with JCheckpointManager(d, async_save=False) as mgr:
                mgr.save(2, _split_over_two_devices(state, devices8))
            saved = jax.tree.map(np.asarray, state)
    return d, saved, losses[2], jax.tree.map(np.asarray, state.params)


def _port_tree(state):
    """{manifest key: tensor} of a port TrainState."""
    return dict(leaves(state.checkpoint_tree()))


def test_a_jax_checkpoint_restores_into_the_port_bitwise(jax_ckpt):
    d, saved, _, _ = jax_ckpt
    manifest = layout.read_manifest(layout.step_dir(d, 2))
    split = [e["key"] for e in manifest["leaves"] if len(e["shards"]) > 1]
    assert "params/tok_emb/embedding" in split and len(split) > 10
    tr = _port_trainer()
    state = CheckpointManager(d, async_save=False).restore(tr.init_state())
    assert state.step == 2
    got = _port_tree(state)
    adam = saved.opt_state[1][0]
    for name, want in params_from_jax(saved.params).items():
        path = jax_path(name)
        assert_bitwise(got[f"params/{path}"], want.numpy())
        assert_bitwise(got[f"opt_state/1/0/mu/{path}"],
                       params_from_jax(adam.mu)[name].numpy())
        assert_bitwise(got[f"opt_state/1/0/nu/{path}"],
                       params_from_jax(adam.nu)[name].numpy())
    opt = state.optimizer
    assert {float(s["step"]) for s in opt.state.values()} == {2.0}
    assert len(opt.state) == len(list(state.model.parameters()))
    assert int(adam.count) == int(saved.opt_state[1][2].count) == 2


def test_c_the_port_resumes_a_jax_checkpoint_for_step_3(jax_ckpt):
    d, _, jloss3, jparams3 = jax_ckpt
    tr = _port_trainer()
    state = CheckpointManager(d, async_save=False).restore(tr.init_state())
    state, m = tr.train_step(state, tr.task.synthetic_data().batch_at(2))
    assert state.step == 3
    np.testing.assert_allclose(float(m["loss"]), jloss3, rtol=1e-5)
    want = params_from_jax(jparams3)
    for name, p in state.model.named_parameters():
        if name.endswith("attention.key.bias"):
            # its gradient is 0 up to rounding (softmax ignores a per-row
            # shift), so AdamW's per-element step there is each
            # framework's rounding noise over its own gradient scale
            continue
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   atol=2e-5, rtol=0, err_msg=name)


def test_b_a_port_checkpoint_restores_into_the_jax_train_state(devices8,
                                                               tmp_path):
    tr = _port_trainer()
    state = tr.init_state()
    data = tr.task.synthetic_data()
    for i in range(2):
        state, _ = tr.train_step(state, data.batch_at(i))
    with CheckpointManager(str(tmp_path), async_save=False) as mgr:
        assert mgr.save(state.step, state)
    jtr, _, _ = _jax_trainer(devices8)
    jstate = JCheckpointManager(str(tmp_path)).restore(jtr.init_state())
    jstate = jax.tree.map(np.asarray, jstate)
    assert int(jstate.step) == 2
    assert int(jstate.opt_state[1][0].count) == 2
    assert int(jstate.opt_state[1][2].count) == 2
    got = _port_tree(state)
    adam = jstate.opt_state[1][0]
    for tree, prefix in ((jstate.params, "params"), (adam.mu, "opt_state/1/0/mu"),
                         (adam.nu, "opt_state/1/0/nu")):
        for path, want in params_to_jax(params_from_jax(tree)).items():
            assert_bitwise(got[f"{prefix}/{path}"], want)
    served = jrestore_params(str(tmp_path))
    for path, want in params_to_jax(params_from_jax(served)).items():
        assert_bitwise(got[f"params/{path}"], want)


def test_d_an_async_save_holds_the_pre_step_values(tmp_path, monkeypatch):
    """The trainer updates parameters and moments in place: a step taken
    while the async writer still holds the save must not reach it."""
    tr = _port_trainer()
    state = tr.init_state()
    data = tr.task.synthetic_data()
    state, _ = tr.train_step(state, data.batch_at(0))
    state, _ = tr.train_step(state, data.batch_at(1))
    before = {k: v.clone() for k, v in _port_tree(state).items()}
    gate = _gated_writes(monkeypatch)
    mgr = CheckpointManager(str(tmp_path))
    try:
        assert mgr.save(state.step, state)
        state, _ = tr.train_step(state, data.batch_at(2))  # in place
        gate.set()
        mgr.wait()
    finally:
        gate.set()
        mgr.close()
    after = _port_tree(state)
    assert not torch.equal(after["params/head/kernel"],
                           before["params/head/kernel"])
    restored = dict(leaves(CheckpointManager(str(tmp_path)).restore(
        _port_trainer().init_state()).checkpoint_tree()))
    assert restored.keys() == before.keys()
    for k in before:
        assert torch.equal(restored[k], before[k]), k


class _TripAfter:
    """A stop event that reads set from its (n+1)-th check on: set during
    step n+1, deterministically."""

    def __init__(self, n):
        self.calls, self.n = 0, n

    def is_set(self):
        self.calls += 1
        return self.calls > self.n

    def set(self):
        pass


def _run_cfg(directory, steps=4, **ckpt):
    # seq_len 128 = gpt_tiny's max_len: the checkpoint serves as the
    # registry model
    return TrainingConfig(**{**CFG, "steps": steps, "seq_len": 128},
                          checkpoint=dict(directory=str(directory),
                                          interval_steps=2, **ckpt))


def _same_step_files(a, b, step):
    da, db = layout.step_dir(str(a), step), layout.step_dir(str(b), step)
    files = sorted(f for f in os.listdir(da) if f.endswith(".bin"))
    assert files == sorted(f for f in os.listdir(db) if f.endswith(".bin"))
    assert len(files) == 114  # step, 37 params, 37 mu, 37 nu, 2 counts
    _, mismatch, errors = filecmp.cmpfiles(da, db, files, shallow=False)
    assert mismatch == [] and errors == []


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """An uninterrupted 4-step run and one preempted at step 2 then
    resumed (both interval 2) → (whole, resumed dirs, results)."""
    root = tmp_path_factory.mktemp("runs")
    whole = run_training(_run_cfg(root / "whole"), device="cpu")
    cut = run_training(_run_cfg(root / "cut"), device="cpu",
                       stop_event=_TripAfter(1))
    resumed = run_training(_run_cfg(root / "cut"), restore=True, device="cpu")
    return root / "whole", root / "cut", whole, cut, resumed


def test_e_preempt_at_step_2_resume_equals_an_uninterrupted_run(trained):
    whole_dir, cut_dir, whole, cut, resumed = trained
    assert cut["preempted"] and cut["final_step"] == 2
    assert latest_committed_step(str(cut_dir)) == 4
    assert not resumed["preempted"] and resumed["final_step"] == 4
    assert [s for s, _ in resumed["losses"]] == [3, 4]
    assert resumed["losses"] == whole["losses"][2:]
    assert cut["losses"] == whole["losses"][:2]
    assert layout.committed_steps(str(whole_dir)) == [2, 4]
    for step in (2, 4):
        _same_step_files(whole_dir, cut_dir, step)


def test_e_covered_budget_and_restore_with_saving_disabled(trained, tmp_path):
    whole_dir = trained[0]
    done = run_training(_run_cfg(whole_dir), restore=True, device="cpu")
    assert done["already_complete"] and done["final_step"] == 4
    # saving off, a longer budget: resumes at 4 and writes nothing
    cfg = _run_cfg(whole_dir, steps=5, enabled=False)
    more = run_training(cfg, restore=True, device="cpu")
    assert more["final_step"] == 5 and [s for s, _ in more["losses"]] == [5]
    assert layout.committed_steps(str(whole_dir)) == [2, 4]
    # KFT_CHECKPOINT_DIR wins over the config's directory
    moved = run_training(_run_cfg(tmp_path / "elsewhere"), restore=True,
                         device="cpu",
                         environ={"KFT_CHECKPOINT_DIR": str(whole_dir)})
    assert moved["already_complete"] and not os.listdir(tmp_path)


def test_warm_start_restores_params_only(trained, tmp_path):
    whole_dir = trained[0]
    parent = restore_params(str(whole_dir))
    cfg = TrainingConfig(**{**CFG, "steps": 1, "seq_len": 128, "seed": 123,
                            "learning_rate": 1e-9},
                         checkpoint=dict(directory=str(tmp_path / "child"),
                                         async_save=False,
                                         warm_start_dir=str(whole_dir)))
    res = run_training(cfg, device="cpu")
    assert res["warm_started"] and res["final_step"] == 1
    child = restore_params(str(tmp_path / "child"))
    # the first update runs at lr schedule(0) = 0: the parent's params
    assert_trees_equal(child, parent)
    moments = CheckpointManager(str(tmp_path / "child")).restore(
        _port_trainer().init_state())
    assert moments.step == 1


def _post(port, name, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/models/{name}:generate",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST",
    )
    with urllib.request.urlopen(req, timeout=120) as resp:
        return json.loads(resp.read())["sequences"]


def test_f_the_port_serves_a_checkpoint_as_the_jax_server_does(trained,
                                                               monkeypatch):
    from kubeflow_tpu.api.wsgi import Server as JServer
    from kubeflow_tpu.serving.main import build_server as jbuild_server
    from kubeflow_tpu_torch.api.wsgi import Server

    d = str(trained[1])
    for knob in ("NUM_SLOTS", "DRAFT_MODEL", "DRAFT_TOKENS",
                 "DRAFT_CHECKPOINT_DIR", "QUANTIZE"):
        monkeypatch.delenv(f"KFT_SERVING_{knob}", raising=False)
    prompts = [[1, 2, 3, 4, 5], [9, 8, 7, 6, 5]]
    body = {"prompt_ids": prompts, "max_new_tokens": 6}
    jms = jbuild_server("gpt_tiny", checkpoint_dir=d, num_slots=0)
    httpd = JServer(jms.app, port=0)
    httpd.start()
    try:
        want = _post(httpd.port, "gpt_tiny", body)
    finally:
        httpd.stop()
        jms.close()
    ms = build_server("gpt_tiny", d, device="cpu", dtype=torch.float32,
                      num_slots=2, page_size=8, paged_attention="kernel")
    httpd = Server(ms.app, port=0)
    httpd.start()
    try:
        got = _post(httpd.port, "gpt_tiny", body)
        served = ms.lm("gpt_tiny").model.state_dict()
    finally:
        httpd.stop()
        ms.close()
    assert got == want
    assert_trees_equal(served, params_from_jax(restore_params(d)))


def test_f_a_draft_from_the_checkpoint_accepts_everything(trained,
                                                          monkeypatch):
    d = str(trained[1])
    monkeypatch.setenv("KFT_SERVING_DRAFT_CHECKPOINT_DIR", d)
    ms = build_server("gpt_tiny", d, device="cpu", dtype=torch.float32,
                      num_slots=2, page_size=8, paged_attention="kernel",
                      draft_model="gpt_tiny", num_draft_tokens=3)
    try:
        eng = ms.engine("gpt_tiny")
        assert_trees_equal(eng.draft_model.state_dict(),
                           ms.lm("gpt_tiny").model.state_dict())
        rows = [np.arange(n) * 7 % VOCAB for n in (4, 9)]
        got = [eng.generate_row(r, 8, timeout=120)["tokens"] for r in rows]
        stats = eng.stats()
        model = ms.lm("gpt_tiny").model
    finally:
        ms.close()
    want = [generate(model, r[None], 8)[0, len(r):].tolist() for r in rows]
    assert got == want
    assert stats["accept_rate"] == 1.0 and stats["verify_steps"] > 0


def test_f_int8_from_the_checkpoint_is_the_ports_quantize(trained):
    d = str(trained[1])
    full = params_from_jax(restore_params(d))
    want = quantize_params_int8(full)
    got = quantized_params_from_jax(restore_checkpoint_params(d, "int8"))
    for part in ("qvalues", "qscales"):
        assert_trees_equal(got[part], want[part])
    ms = build_server("gpt_tiny", d, device="cpu", dtype=torch.float32,
                      num_slots=0, paged_attention="gather", quantize="int8")
    try:
        sd = ms.lm("gpt_tiny").model.state_dict()
    finally:
        ms.close()
    assert sd.keys() == {**want["qvalues"], **{
        f"{k}_qscale": v for k, v in want["qscales"].items()}}.keys()
    for name, v in want["qvalues"].items():
        assert torch.equal(sd[name], v), name
    for name, v in want["qscales"].items():
        assert torch.equal(sd[f"{name}_qscale"], v), name


@pytest.mark.parametrize("layout_name", ["named", "scan"])
def test_f_either_flax_layout_serves(trained, tmp_path, layout_name):
    """A checkpoint holding the params in the scan-stacked layout (the
    JAX serving layout) loads as the named one does."""
    full = params_from_jax(restore_params(str(trained[1])))
    flat = params_to_jax(full, layout_name)
    tree = {"params": {}}
    for path, arr in flat.items():
        node = tree["params"]
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(arr)
    with CheckpointManager(str(tmp_path), async_save=False) as mgr:
        mgr.save(1, tree)
    ms = build_server("gpt_tiny", str(tmp_path), device="cpu",
                      dtype=torch.float32, num_slots=0,
                      paged_attention="gather")
    try:
        assert_trees_equal(ms.lm("gpt_tiny").model.state_dict(), full)
    finally:
        ms.close()


def test_g_a_jax_bf16_leaf_reads_back_and_float8_raises(devices8, tmp_path):
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.standard_normal((6, 4)), jnp.bfloat16)
    f8 = jnp.asarray(rng.standard_normal((3,)), jnp.float8_e4m3fn)
    with JCheckpointManager(str(tmp_path / "bf16"), async_save=False) as mgr:
        mgr.save(1, {"params": {"w": _split_over_two_devices(w, devices8)}})
    got = restore_params(str(tmp_path / "bf16"))["w"]
    assert got.dtype == torch.bfloat16
    assert_bitwise(got, np.asarray(w))
    with JCheckpointManager(str(tmp_path / "f8"), async_save=False) as mgr:
        mgr.save(1, {"params": {"w": w, "scale8": f8}})
    with pytest.raises(ValueError, match="scale8.*float8_e4m3fn"):
        restore_params(str(tmp_path / "f8"))
