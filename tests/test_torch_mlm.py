"""BERT pretraining in the port (training/data.py's mlm streams,
training/tasks.py MlmTask and the shared eval statistics,
training/trainer.py's dropout generators and modes, checkpoints of the
BERT tree, chip_smoke.py phase 16) against the JAX package on the CPU at
bert_tiny size in f32.

Tolerances: the MlmTask loss rel 1e-5 and its gradients atol 1e-6 +
rel 1e-4 (f32 summation order; measured ~1e-8); eval statistics'
counts exactly and their sums rel 1e-5; three trainer steps' losses rel
1e-5 and params after step 3 atol 2e-5 = 2 % of lr (AdamW divides each
element's step by its own gradient scale, so summation-order noise in a
tiny gradient element moves its step by a visible fraction of lr: the
bound tests/test_torch_train.py holds the GPT family to). The host mlm
stream is the JAX one bit for bit; the device stream is held by
determinism and by statistics (the mask rate within four binomial
standard deviations of 15 %). Checkpoints with dropout 0.1 on resume
bit for bit."""

import filecmp
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.checkpointing import (  # noqa: E402
    CheckpointManager as JCheckpointManager,
)
from kubeflow_tpu.config.platform import (  # noqa: E402
    MeshConfig,
    TrainingConfig as JTrainingConfig,
)
from kubeflow_tpu.models.registry import get_model as jget_model  # noqa: E402
from kubeflow_tpu.parallel.mesh import mesh_from_config  # noqa: E402
from kubeflow_tpu.training.data import (  # noqa: E402
    SyntheticData as JSyntheticData,
    make_global_batch,
)
from kubeflow_tpu.training.tasks import (  # noqa: E402
    CausalLmTask as JCausalLmTask,
    MlmTask as JMlmTask,
)
from kubeflow_tpu.training.trainer import Trainer as JTrainer  # noqa: E402
from kubeflow_tpu_torch.checkpointing import layout  # noqa: E402
from kubeflow_tpu_torch.config.platform import TrainingConfig  # noqa: E402
from kubeflow_tpu_torch.models import get_model  # noqa: E402
from kubeflow_tpu_torch.models.convert import (  # noqa: E402
    jax_path,
    load_jax_params,
    params_from_jax,
)
from kubeflow_tpu_torch.runtime.train_run import run_training  # noqa: E402
from kubeflow_tpu_torch.training.data import (  # noqa: E402
    SyntheticData,
    to_device,
)
from kubeflow_tpu_torch.training.datasets import ArrayDataset  # noqa: E402
from kubeflow_tpu_torch.training.tasks import (  # noqa: E402
    CausalLmTask,
    MlmTask,
    task_for_model,
)
from kubeflow_tpu_torch.training.trainer import (  # noqa: E402
    Trainer,
    dropout_seed,
)

SEQ, BATCH, VOCAB = 64, 4, 512
CFG = dict(model="bert_tiny", global_batch_size=BATCH, steps=3,
           learning_rate=1e-3, warmup_steps=1, weight_decay=0.1,
           dtype="float32", seed=0)
LEAVES = ("layers.0.attention.query.kernel", "layers.1.mlp.wo.kernel",
          "tok_emb.embedding", "mlm_out.kernel", "nsp_out.kernel",
          "ln_emb.scale")


@pytest.mark.parametrize("step", [0, 3])
@pytest.mark.parametrize("seed", [0, 1, 7])
def test_host_mlm_stream_is_the_jax_stream_bit_for_bit(seed, step):
    want = JSyntheticData("mlm", 4, seed=seed, seq_len=32,
                          vocab_size=VOCAB).batch_at(step)
    got = SyntheticData("mlm", 4, seed=seed, seq_len=32,
                        vocab_size=VOCAB).batch_at(step)
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_device_mlm_stream_is_deterministic_with_the_streams_statistics():
    data = SyntheticData("mlm", 64, seed=3, seq_len=128, vocab_size=VOCAB)
    fn = data.device_batch_fn("cpu")
    batch = fn(5)
    for key, t in fn(5).items():
        torch.testing.assert_close(t, batch[key], atol=0, rtol=0)
    assert not torch.equal(fn(6)["input_ids"], batch["input_ids"])
    ids, labels = batch["input_ids"], batch["labels"]
    assert ids.shape == labels.shape == (64, 128)
    assert all(t.dtype == torch.int64 for t in batch.values())
    masked = labels != -100
    n = masked.numel()
    assert abs(masked.float().mean().item() - 0.15) <= 4 * math.sqrt(
        0.15 * 0.85 / n)
    assert (ids[masked] == 1).all()
    assert ((labels[masked] >= 0) & (labels[masked] < VOCAB)).all()
    assert ((ids >= 0) & (ids < VOCAB)).all()
    assert (batch["attention_mask"] == 1).all()
    assert set(batch["nsp_labels"].tolist()) == {0, 1}
    assert batch["nsp_labels"].shape == (64,)
    # the causal-LM stream is made on the device too (its own tests:
    # test_torch_lm_stream.py)
    lm = SyntheticData("lm", 2, seq_len=8, vocab_size=VOCAB).device_batch_fn(
        "cpu")(0)
    assert set(lm) == {"input_ids", "attention_mask"}


@pytest.fixture(scope="module")
def jparams():
    jm = jget_model("bert_tiny", dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, SEQ), jnp.int32),
                     deterministic=True)["params"]
    return jax.tree.map(np.asarray, params)


def _ragged(batch):
    """The host batch with ragged key masks (each row keeps a key)."""
    batch = dict(batch)
    mask = batch["attention_mask"].copy()
    mask[1, 40:] = 0
    mask[2, 3:] = 0
    batch["attention_mask"] = mask
    return batch


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_mlm_loss_and_gradients_match_jax(jparams, impl):
    cfg = TrainingConfig(**CFG)
    batch = _ragged(SyntheticData("mlm", BATCH, seq_len=SEQ,
                                  vocab_size=VOCAB).batch_at(2))
    jm = jget_model("bert_tiny", dtype=jnp.float32, attention_impl=impl)
    jtask = JMlmTask(JTrainingConfig(**CFG), seq_len=SEQ, vocab_size=VOCAB)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        loss, out = jtask.loss(jm, p, {}, jbatch, False, None)
        return loss, out["aux"]

    (jl, jaux), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    model = get_model("bert_tiny", dtype=torch.float32, attention_impl=impl,
                      device="cpu")
    load_jax_params(model, jparams)
    model.trainable()
    loss, out = MlmTask(cfg, seq_len=SEQ, vocab_size=VOCAB).loss(
        model, to_device(batch, torch.device("cpu")))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for key in ("mlm_loss", "nsp_loss"):
        np.testing.assert_allclose(out["aux"][key].item(), float(jaux[key]),
                                   rtol=1e-5)
    assert out["loss_items"].item() == 1.0
    want = params_from_jax(jax.tree.map(np.asarray, jgrads))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=1e-6, rtol=1e-4, err_msg=name)


def _stats_match(got, want):
    assert got["count"].item() == float(want["count"])
    assert got["correct"].item() == float(want["correct"])
    np.testing.assert_allclose(got["loss_sum"].item(),
                               float(want["loss_sum"]), rtol=1e-5)


def test_mlm_eval_stats_match_jax(jparams):
    cfg = TrainingConfig(**CFG)
    batch = _ragged(SyntheticData("mlm", BATCH, seq_len=SEQ,
                                  vocab_size=VOCAB).batch_at(4))
    batch["eval_mask"] = np.array([1, 1, 1, 0], np.float32)
    jm = jget_model("bert_tiny", dtype=jnp.float32)
    want = JMlmTask(JTrainingConfig(**CFG), seq_len=SEQ).eval_stats(
        jm, jparams, {}, {k: jnp.asarray(v) for k, v in batch.items()})
    model = get_model("bert_tiny", dtype=torch.float32, device="cpu")
    load_jax_params(model, jparams)
    with torch.no_grad():
        got = MlmTask(cfg, seq_len=SEQ).eval_stats(
            model, to_device(batch, torch.device("cpu")))
    _stats_match(got, want)


def test_causal_lm_eval_stats_match_jax(gpt_and_params):
    jm, params = gpt_and_params
    cfg = TrainingConfig(**{**CFG, "model": "gpt_tiny"})
    batch = SyntheticData("lm", BATCH, seq_len=SEQ,
                          vocab_size=VOCAB).batch_at(1)
    batch["attention_mask"][1, 50:] = 0
    batch["eval_mask"] = np.array([1, 1, 0, 1], np.float32)
    want = JCausalLmTask(JTrainingConfig(**{**CFG, "model": "gpt_tiny"}),
                         seq_len=SEQ).eval_stats(
        jm, params, {}, {k: jnp.asarray(v) for k, v in batch.items()})
    model = get_model("gpt_tiny", dtype=torch.float32, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, params))
    with torch.no_grad():
        got = CausalLmTask(cfg, seq_len=SEQ).eval_stats(
            model, to_device(batch, torch.device("cpu")))
    assert float(want["count"]) == 2 * 63 + 49 + 0  # rows 0, 3 and 1's pairs
    _stats_match(got, want)


@pytest.fixture(scope="module")
def jax_run(devices8):
    """Three JAX train steps of bert_tiny (flash, one device, dropout 0):
    the initial params, per-step losses and the params after step 3."""
    cfg = JTrainingConfig(mesh=MeshConfig(data=1), **CFG)
    mesh = mesh_from_config(cfg.mesh, devices=devices8[:1])
    task = JMlmTask(cfg, seq_len=SEQ, vocab_size=VOCAB)
    tr = JTrainer(cfg, mesh=mesh, task=task,
                  model=jget_model("bert_tiny", dtype=jnp.float32,
                                   attention_impl="flash"))
    state = tr.init_state()
    init = jax.tree.map(np.asarray, state.params)
    data = task.synthetic_data()
    losses = []
    for i in range(3):
        batch = make_global_batch(data.batch_at(i), mesh)
        state, m = tr.train_step(state, batch, jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
    return init, losses, jax.tree.map(np.asarray, state.params)


def _port_trainer(**over):
    cfg = TrainingConfig(**{**CFG, "attention_impl": "flash", **over})
    return Trainer(cfg, device="cpu",
                   task=MlmTask(cfg, seq_len=SEQ, vocab_size=VOCAB))


def test_train_steps_match_the_jax_trainer(jax_run):
    init, jlosses, jafter = jax_run
    tr = _port_trainer()
    assert not tr._dropout
    state = tr.init_state()
    load_jax_params(state.model, init)
    data = tr.task.synthetic_data()
    losses = []
    for i in range(3):
        state, m = tr.train_step(state, data.batch_at(i))
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    want = params_from_jax(jafter)
    for name in LEAVES:
        np.testing.assert_allclose(state.params[name].detach().numpy(),
                                   want[name].numpy(), atol=2e-5, rtol=0,
                                   err_msg=name)


def test_the_trainer_builds_bert_with_the_configs_attention():
    cfg = TrainingConfig(model="bert_tiny", global_batch_size=2, steps=1,
                         seq_len=32, dtype="float32", attention_impl="auto")
    tr = Trainer(cfg, device="cpu")
    assert isinstance(tr.task, MlmTask) and tr.task.seq_len == 32
    assert tr.model.cfg.attention_impl == "auto"
    assert tr.model.cfg.max_len == 32
    assert isinstance(task_for_model("bert_base", cfg), MlmTask)


def _dropout_trainer(**over):
    cfg = TrainingConfig(**{**CFG, "seq_len": SEQ, **over})
    model = get_model("bert_tiny", dtype=torch.float32, max_len=SEQ,
                      dropout_rate=0.1, device="cpu", seed=cfg.seed)
    return Trainer(cfg, model=model, device="cpu")


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_dropout_steps_are_a_function_of_seed_and_step(accum_steps):
    """Two trainers with dropout 0.1 take the same steps bit for bit (one
    generator a step, or a microbatch, seeded by (seed, step, micro));
    evaluate runs in eval mode (no generator needed, twice the same) and
    leaves the model in train mode."""
    runs = []
    for _ in range(2):
        tr = _dropout_trainer(accum_steps=accum_steps)
        assert tr._dropout
        state = tr.init_state()
        data = tr.task.synthetic_data()
        losses = [float(tr.train_step(state, data.batch_at(i))[1]["loss"])
                  for i in range(2)]
        runs.append((losses, {n: p.detach().clone()
                              for n, p in state.params.items()}))
        arrays = SyntheticData("mlm", 6, seq_len=SEQ,
                               vocab_size=VOCAB).batch_at(9)
        ds = ArrayDataset(arrays, 4, shuffle=False)
        first, second = tr.evaluate(state, ds), tr.evaluate(state, ds)
        assert first == second and first["count"] > 0
        assert state.model.training
    assert runs[0][0] == runs[1][0]
    for name, p in runs[0][1].items():
        torch.testing.assert_close(runs[1][1][name], p, atol=0, rtol=0)
    plain = _port_trainer(accum_steps=accum_steps)
    state = plain.init_state()
    loss = float(plain.train_step(state, plain.task.synthetic_data(
    ).batch_at(0))[1]["loss"])
    assert loss != runs[0][0][0]
    seeds = {dropout_seed(0, s, m) for s in range(3) for m in range(2)}
    assert len(seeds) == 6 and dropout_seed(0, 1, 0) == dropout_seed(0, 1, 0)


def _ckpt_cfg(directory, steps=4):
    return TrainingConfig(**{**CFG, "steps": steps, "seq_len": SEQ},
                          checkpoint=dict(directory=str(directory),
                                          interval_steps=2))


class _TripAfter:
    """A stop event that reads set from its (n+1)-th check on."""

    def __init__(self, n):
        self.calls, self.n = 0, n

    def is_set(self):
        self.calls += 1
        return self.calls > self.n

    def set(self):
        pass


def test_a_dropout_run_resumes_bit_for_bit_and_reads_back_in_jax(
        tmp_path, devices8):
    def run(name, **kw):
        cfg = _ckpt_cfg(tmp_path / name)
        tr = _dropout_trainer(seq_len=SEQ)
        return run_training(cfg, device="cpu", trainer=tr, **kw), tr

    whole, tr = run("whole")
    cut, _ = run("cut", stop_event=_TripAfter(1))
    resumed, _ = run("cut", restore=True)
    assert cut["preempted"] and cut["final_step"] == 2
    assert resumed["losses"] == whole["losses"][2:]
    assert cut["losses"] == whole["losses"][:2]
    da = layout.step_dir(str(tmp_path / "whole"), 4)
    db = layout.step_dir(str(tmp_path / "cut"), 4)
    files = sorted(f for f in os.listdir(da) if f.endswith(".bin"))
    n_params = len(list(tr.model.parameters()))
    assert len(files) == 1 + 3 * n_params + 2  # step, params, mu, nu, counts
    _, mismatch, errors = filecmp.cmpfiles(da, db, files, shallow=False)
    assert mismatch == [] and errors == []
    # the JAX package restores the port's BERT checkpoint into its state
    jcfg = JTrainingConfig(mesh=MeshConfig(data=1), **{**CFG, "seq_len": SEQ})
    jtr = JTrainer(jcfg, mesh=mesh_from_config(jcfg.mesh,
                                               devices=devices8[:1]),
                   task=JMlmTask(jcfg, seq_len=SEQ, vocab_size=VOCAB))
    jstate = JCheckpointManager(str(tmp_path / "whole")).restore(
        jtr.init_state())
    assert int(jstate.step) == 4
    jflat = params_from_jax(jax.tree.map(np.asarray, jstate.params))
    for name, p in tr._final_state.model.named_parameters():
        np.testing.assert_array_equal(jflat[name].numpy(),
                                      p.detach().numpy(), err_msg=jax_path(name))


def test_chip_smoke_phase_16_rehearsal(tmp_path):
    """Phase 16 of chip_smoke.py on the CPU at bert_tiny size: 16a's
    gates (finite losses, input made on the device), 16b's flash/dense
    agreement, 16c's bitwise resume with dropout 0.1 on."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    small = dict(model="bert_tiny", seq_len=SEQ, global_batch_size=BATCH,
                 dtype="float32")
    launches = smoke.phase_bert_train(torch, overrides=dict(small, steps=3),
                                      device="cpu")
    assert launches == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    assert smoke.phase_bert_parity(torch, overrides=small,
                                   device="cpu") == "dense"
    smoke.phase_bert_ckpt(torch, str(tmp_path), overrides=small, device="cpu")
