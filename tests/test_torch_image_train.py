"""The port's image-classification training path (config, tasks, the
SGD-nesterov recipe, Trainer eval and early stop, checkpoints) against
the JAX package's on the CPU, in f32.

Cross-framework runs start from the JAX trainer's own init (carried over
by `params_from_jax` with its `batch_stats`) and take the same
`ArrayDataset` batches (blobs, augment none): per-step losses within rel
1e-4 (f32 summation order, compounded over 5 steps), eval top-1 and
count equal and eval loss within rel 1e-4, and a target accuracy stops
both at the same step. SGD-nesterov against optax over three updates:
params within rel 1e-6. Checkpoints cross both ways with manifest keys
equal and every leaf bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import yaml  # noqa: E402

from kubeflow_tpu.checkpointing import (  # noqa: E402
    CheckpointManager as JCheckpointManager,
)
from kubeflow_tpu.config.core import from_dict as jfrom_dict  # noqa: E402
from kubeflow_tpu.config.platform import (  # noqa: E402
    ConfigError as JConfigError,
    DataConfig as JDataConfig,
    MeshConfig,
    TrainingConfig as JTrainingConfig,
)
from kubeflow_tpu.models.registry import get_model as jget_model  # noqa: E402
from kubeflow_tpu.parallel.mesh import mesh_from_config  # noqa: E402
from kubeflow_tpu.training.data import make_global_batch  # noqa: E402
from kubeflow_tpu.training.datasets import build_data as jbuild_data  # noqa: E402
from kubeflow_tpu.training.tasks import (  # noqa: E402
    ImageClassificationTask as JImageTask,
    cross_entropy as jcross_entropy,
    make_optimizer as jmake_optimizer,
)
from kubeflow_tpu.training.trainer import Trainer as JTrainer  # noqa: E402
from kubeflow_tpu_torch.checkpointing import CheckpointManager, layout  # noqa: E402
from kubeflow_tpu_torch.config.platform import (  # noqa: E402
    ConfigError,
    DataConfig,
    TrainingConfig,
)
from kubeflow_tpu_torch.models import get_model  # noqa: E402
from kubeflow_tpu_torch.models.convert import jax_path, params_from_jax  # noqa: E402
from kubeflow_tpu_torch.runtime.train_run import run_training  # noqa: E402
from kubeflow_tpu_torch.training.datasets import build_data  # noqa: E402
from kubeflow_tpu_torch.training.tasks import (  # noqa: E402
    ImageClassificationTask,
    cross_entropy,
    make_optimizer,
    make_schedule,
)
from kubeflow_tpu_torch.training.trainer import Trainer  # noqa: E402

LOSS_REL = 1e-4
SIZE, CLASSES = 8, 10
DATA = dict(name="blobs", num_examples=192, eval_fraction=0.25)
RUNS = {
    "mlp": dict(model="mlp", global_batch_size=16, learning_rate=3e-3,
                warmup_steps=1, weight_decay=1e-4, dtype="float32", seed=0),
    "resnet18": dict(model="resnet18", global_batch_size=16,
                     learning_rate=0.05, warmup_steps=1, weight_decay=1e-4,
                     dtype="float32", seed=0, label_smoothing=0.1),
}
MODEL_KW = {"mlp": dict(hidden=(32,), num_classes=CLASSES),
            "resnet18": dict(num_filters=8, num_classes=CLASSES)}


# -- losses and the recipe ------------------------------------------------


@pytest.mark.parametrize("ignore,smoothing", [(-1000000, 0.0), (-1000000, 0.1),
                                              (-100, 0.0), (-100, 0.2),
                                              (3, 0.1)])
def test_cross_entropy_equals_the_reference(ignore, smoothing):
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((4, 6, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (4, 6)).astype(np.int32)
    labels[0, :3] = ignore if ignore < 0 else labels[0, :3]
    want = jcross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                          ignore=ignore, label_smoothing=smoothing)
    got = cross_entropy(torch.from_numpy(logits),
                        torch.from_numpy(labels).long(), ignore=ignore,
                        label_smoothing=smoothing)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_sgd_nesterov_recipe_equals_optax():
    """Three updates of the convnet recipe (weight decay on every leaf,
    nesterov momentum 0.9, the warmup-cosine schedule at the update count
    before each update) leave the params optax leaves."""
    cfg = TrainingConfig(model="resnet50", learning_rate=0.4, warmup_steps=2,
                         steps=5, weight_decay=1e-3)
    jcfg = JTrainingConfig(model="resnet50", learning_rate=0.4,
                           warmup_steps=2, steps=5, weight_decay=1e-3)
    rng = np.random.default_rng(0)
    params = {"w": rng.standard_normal((5, 3)).astype(np.float32),
              "scale": rng.standard_normal(3).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    tx, _ = jmake_optimizer(jcfg, "resnet50")
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = make_optimizer(cfg, "resnet50", tp.values())
    assert isinstance(opt, torch.optim.SGD)
    schedule = make_schedule(cfg)
    for step, g in enumerate(grads):
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        for group in opt.param_groups:
            group["lr"] = schedule(step)
        opt.step()
    for k in params:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)


# -- config ---------------------------------------------------------------


def test_resnet50_yaml_parses_into_equal_configs():
    with open("configs/resnet50_imagenet_v5e16.yaml") as f:
        training = yaml.safe_load(f)["training"]
    # the config's pure data-parallel mesh (data: 16) is ported
    port = TrainingConfig.from_dict(training)
    ref = jfrom_dict(JTrainingConfig, training)
    assert port.mesh.axis_sizes() == ref.mesh.axis_sizes()
    assert port.mesh.data == 16 and port.mesh.num_devices == 16
    for f in ("model", "global_batch_size", "steps", "learning_rate",
              "warmup_steps", "weight_decay", "label_smoothing", "dtype"):
        assert getattr(port, f) == getattr(ref, f), f
    for f in ("name", "path", "augment", "eval_every_steps",
              "target_accuracy", "eval_fraction", "eval_batch_size",
              "shuffle", "num_examples", "prefetch_depth"):
        assert getattr(port.data, f) == getattr(ref.data, f), f
    assert port.checkpoint.keep_every == ref.checkpoint.keep_every == 12510


CONFIG_CASES = [
    dict(model="mlp", data={"name": "blobs", "eval_fraction": 0.1,
                            "target_accuracy": 0.9}),
    dict(model="mlp", data={"name": "blobs", "target_accuracy": 0.9}),
    dict(model="mlp", data={"target_accuracy": 0.5}),
    dict(model="mlp", data={"eval_every_steps": 5}),
    dict(model="resnet50", data={"name": "npz"}),
    dict(model="resnet50", data={"name": "npz", "path": "/d",
                                 "augment": "crop_flip"}),
    dict(model="resnet50", data={"name": "imagenet"}),
    dict(model="resnet50", data={"augment": "mixup"}),
    dict(model="resnet50", data={"eval_fraction": 1.0}),
    dict(model="resnet50", data={"target_accuracy": 1.5}),
    dict(model="resnet50", label_smoothing=0.1),
    dict(model="resnet50", label_smoothing=1.0),
    dict(model="gpt_tiny", label_smoothing=0.1),
    dict(model="gpt_tiny", data={"augment": "crop_flip"}),
]


@pytest.mark.parametrize("case", CONFIG_CASES,
                         ids=[str(c) for c in CONFIG_CASES])
def test_config_accepts_and_refuses_what_the_reference_does(case):
    def build(parse, errors):
        try:
            parse(case)
        except errors:
            return False
        return True

    assert build(TrainingConfig.from_dict, (ConfigError, TypeError)) == build(
        lambda d: jfrom_dict(JTrainingConfig, d), (JConfigError, TypeError))
    assert DataConfig().augment == JDataConfig().augment == "none"


# -- the trainer against the JAX trainer ----------------------------------


def _jax_trainer(name, devices, data=None, steps=5):
    cfg = JTrainingConfig(mesh=MeshConfig(data=1), steps=steps,
                          data=JDataConfig(**(data or DATA)), **RUNS[name])
    mesh = mesh_from_config(cfg.mesh, devices=devices[:1])
    task = JImageTask(cfg, image_size=SIZE, num_classes=CLASSES)
    model = jget_model(name, dtype=jnp.float32, **MODEL_KW[name])
    return JTrainer(cfg, mesh=mesh, model=model, task=task), mesh


def _port_trainer(name, jstate, data=None, steps=5, checkpoint=None):
    cfg = TrainingConfig(steps=steps, data=data or DATA,
                         checkpoint=checkpoint or {"enabled": False},
                         **RUNS[name])
    kw = dict(MODEL_KW[name])
    if name == "mlp":
        kw["in_features"] = SIZE * SIZE * 3
    model = get_model(name, dtype=torch.float32, device="cpu", **kw)
    tr = Trainer(cfg, model=model, device="cpu",
                 task=ImageClassificationTask(cfg, image_size=SIZE,
                                              num_classes=CLASSES))
    state = tr.init_state()
    if jstate is not None:
        np_state = jax.tree.map(np.asarray, jstate)
        model.load_state_dict(params_from_jax(
            np_state.params, np_state.extra_vars.get("batch_stats")))
    return tr, state


@pytest.fixture(scope="module", params=["mlp", "resnet18"])
def jax_run(request, devices8):
    """The JAX trainer's 5 steps on blobs from its own init: (name, init
    state, per-step losses, final state, eval of the final state)."""
    name = request.param
    jtr, mesh = _jax_trainer(name, devices8)
    state = jtr.init_state()
    # the step donates its state: keep the init as numpy first
    init = jax.tree.map(np.asarray, state)
    data, eval_data = jbuild_data(jtr.cfg, jtr.task)
    losses = []
    for i in range(5):
        state, m = jtr.train_step(state, make_global_batch(data.batch_at(i),
                                                           mesh),
                                  jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
    return name, init, losses, state, jtr.evaluate(state, eval_data)


def test_per_step_losses_and_eval_equal_the_jax_trainer(jax_run):
    name, init, want, _, want_eval = jax_run
    tr, state = _port_trainer(name, init)
    data, eval_data = build_data(tr.cfg, tr.task)
    got = []
    for i in range(5):
        state, m = tr.train_step(state, data.batch_at(i))
        got.append(float(m["loss"]))
    np.testing.assert_allclose(got, want, rtol=LOSS_REL)
    ev = tr.evaluate(state, eval_data)
    assert ev["count"] == want_eval["count"] == 48
    assert ev["top1"] == want_eval["top1"]
    np.testing.assert_allclose(ev["loss"], want_eval["loss"], rtol=LOSS_REL)


def test_running_averages_after_training_equal_the_jax_trainer(jax_run):
    name, init, _, jstate, _ = jax_run
    tr, state = _port_trainer(name, init)
    data, _ = build_data(tr.cfg, tr.task)
    for i in range(5):
        state, _ = tr.train_step(state, data.batch_at(i))
    stats = jstate.extra_vars.get("batch_stats", {})
    want = params_from_jax(jax.tree.map(np.asarray, jstate.params),
                           jax.tree.map(np.asarray, stats))
    # the mlp has none in either package
    assert len(list(state.model.named_buffers())) == len(
        jax.tree.leaves(stats)) == (40 if name == "resnet18" else 0)
    for n, b in state.model.named_buffers():
        w = want[n].numpy()
        assert np.abs(b.numpy() - w).max() <= 1e-4 * np.abs(w).max(), n


@pytest.mark.parametrize("name", ["mlp", "resnet18"])
def test_target_accuracy_stops_both_at_the_same_step(name, devices8):
    data = dict(DATA, eval_every_steps=2, target_accuracy=0.6)
    jtr, _ = _jax_trainer(name, devices8, data=data, steps=40)
    jstate = jtr.init_state()
    init = jax.tree.map(np.asarray, jstate)
    jm = jtr.fit(state=jstate, log_every=2)
    tr, state = _port_trainer(name, init, data=data, steps=40)
    m = tr.fit(state=state, log_every=2)
    assert m.step == jm.step < 40
    assert tr._final_state.step == m.step
    assert m.aux["eval_top1"] == jm.aux["eval_top1"] >= 0.6
    np.testing.assert_allclose(m.aux["eval_loss"], jm.aux["eval_loss"],
                               rtol=LOSS_REL)


def test_accum_steps_with_batch_statistics_is_refused():
    cfg = TrainingConfig(model="resnet18", global_batch_size=4, accum_steps=2,
                         dtype="float32")
    model = get_model("resnet18", num_filters=8, dtype=torch.float32,
                      device="cpu")
    tr = Trainer(cfg, model=model, device="cpu",
                 task=ImageClassificationTask(cfg, image_size=SIZE))
    batch = ImageClassificationTask(cfg, image_size=SIZE).synthetic_data(
    ).batch_at(0)
    with pytest.raises(ValueError, match="accum_steps > 1 is unsupported "
                       "for models with batch statistics"):
        tr.train_step(tr.init_state(), batch)


def test_a_bn_free_model_accumulates_exactly():
    """The mlp under the image task with accum_steps 2 equals one full
    batch (equal weights: the image task reports no item count)."""
    results = []
    for accum in (1, 2):
        cfg = TrainingConfig(model="mlp", global_batch_size=8, dtype="float32",
                             accum_steps=accum, learning_rate=1e-2)
        tr = Trainer(cfg, device="cpu")
        state = tr.init_state()
        data = tr.task.synthetic_data()
        for i in range(2):
            state, m = tr.train_step(state, data.batch_at(i))
        results.append((float(m["loss"]), state.model.head.kernel.clone()))
    np.testing.assert_allclose(results[0][0], results[1][0], rtol=1e-5)
    assert torch.allclose(results[0][1], results[1][1], atol=2e-5)


def test_step_flops_count_the_model_on_the_meta_device():
    """The mlp's FLOPs a step: forward 2·B·in·out per Dense, backward
    4·B·in·out (input and weight gradients), but no input gradient for
    the first layer."""
    cfg = TrainingConfig(model="mlp", global_batch_size=8, dtype="float32")
    tr = Trainer(cfg, device="cpu")
    batch = tr.task.synthetic_data().batch_at(0)
    dims = [(192, 64), (64, 64), (64, 10)]
    want = 6 * 8 * sum(a * b for a, b in dims) - 2 * 8 * 192 * 64
    assert tr.step_flops(batch) == want
    assert all(p.device.type == "cpu" for p in tr.model.parameters())


def test_run_training_reports_eval_and_the_early_stop():
    cfg = TrainingConfig(model="mlp", global_batch_size=16, steps=60,
                         learning_rate=3e-3, warmup_steps=1, dtype="float32",
                         checkpoint={"enabled": False},
                         data=dict(DATA, eval_every_steps=5,
                                   target_accuracy=0.6))
    result = run_training(cfg, device="cpu", log_every=5)
    assert result["target_reached"] and result["eval_top1"] >= 0.6
    assert result["final_step"] < 60 and result["final_step"] % 5 == 0
    assert np.isfinite(result["eval_loss"])


# -- checkpoints across the packages --------------------------------------


@pytest.fixture(scope="module")
def jax_resnet_ckpt(devices8, tmp_path_factory):
    """The JAX resnet18 trainer's 3 steps; its step-2 state saved. →
    (dir, step-2 state as numpy, step-3 loss)."""
    d = str(tmp_path_factory.mktemp("jax_resnet_ckpt"))
    jtr, mesh = _jax_trainer("resnet18", devices8)
    state = jtr.init_state()
    data, _ = jbuild_data(jtr.cfg, jtr.task)
    for i in range(3):
        state, m = jtr.train_step(state, make_global_batch(data.batch_at(i),
                                                           mesh),
                                  jax.random.PRNGKey(0))
        if i == 1:
            with JCheckpointManager(d, async_save=False) as mgr:
                mgr.save(2, state)
            saved = jax.tree.map(np.asarray, state)
    return d, saved, float(m["loss"])


def _manifest_keys(d, step):
    return sorted(e["key"] for e in
                  layout.read_manifest(layout.step_dir(d, step))["leaves"])


def test_a_jax_resnet_checkpoint_resumes_in_the_port(jax_resnet_ckpt):
    d, saved, jloss3 = jax_resnet_ckpt
    tr, state = _port_trainer("resnet18", None)
    assert sorted(k for k, _ in _leaves(state.checkpoint_tree())) == \
        _manifest_keys(d, 2)
    state = CheckpointManager(d, async_save=False).restore(state)
    assert state.step == 2
    want = params_from_jax(saved.params, saved.extra_vars["batch_stats"])
    for n, t in state.model.state_dict().items():
        assert np.array_equal(t.numpy(), want[n].numpy()), n
    trace = params_from_jax(saved.opt_state[1][0].trace)
    for n, p in state.model.named_parameters():
        buf = state.optimizer.state[p]["momentum_buffer"]
        assert np.array_equal(buf.numpy(), trace[n].numpy()), n
    assert int(saved.opt_state[1][1].count) == 2
    data, _ = build_data(tr.cfg, tr.task)
    state, m = tr.train_step(state, data.batch_at(2))
    np.testing.assert_allclose(float(m["loss"]), jloss3, rtol=LOSS_REL)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            yield from _leaves(v, path)
        else:
            yield path, v


def test_a_port_resnet_checkpoint_resumes_in_jax(devices8, tmp_path):
    tr, state = _port_trainer("resnet18", None)
    data, _ = build_data(tr.cfg, tr.task)
    for i in range(2):
        state, _ = tr.train_step(state, data.batch_at(i))
    with CheckpointManager(str(tmp_path), async_save=False) as mgr:
        assert mgr.save(state.step, state)
    jtr, mesh = _jax_trainer("resnet18", devices8)
    template = jtr.init_state()
    jstate = JCheckpointManager(str(tmp_path)).restore(template)
    np_state = jax.tree.map(np.asarray, jstate)
    assert int(np_state.step) == 2 and int(np_state.opt_state[1][1].count) == 2
    got = dict(_leaves(state.checkpoint_tree()))
    want_params = params_from_jax(np_state.params,
                                  np_state.extra_vars["batch_stats"])
    for n, t in want_params.items():
        key = ("extra_vars/batch_stats/" if n.rsplit(".", 1)[1] in
               ("mean", "var") else "params/") + jax_path(n)
        assert np.array_equal(got[key].detach().numpy(), t.numpy()), key
    for n, t in params_from_jax(np_state.opt_state[1][0].trace).items():
        assert np.array_equal(got[f"opt_state/1/0/trace/{jax_path(n)}"].numpy(),
                              t.numpy()), n
    # the next step from the port's save, in both
    jstate, jm = jtr.train_step(jstate, make_global_batch(data.batch_at(2),
                                                          mesh),
                                jax.random.PRNGKey(0))
    state, m = tr.train_step(state, data.batch_at(2))
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=LOSS_REL)
