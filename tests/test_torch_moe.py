"""The port's MoE (kubeflow_tpu_torch/parallel/moe.py routing,
models/layers.py MoeMlp, the gpt_*_moe and bert_*_moe presets, the LM
tasks' load-balance loss, the trainer's `moe_aux_loss`, int8 of the
expert stacks, the param bridge, checkpoints and `lm_train_flops`)
against the JAX package on the CPU, with seeded numpy inputs.

Tolerances. Routing: dispatch and fraction_dropped exact (they are
counts), combine and aux within 1e-6 (f32 softmax). MoeMlp and the tiny
models in f32: outputs within 1e-5, losses rel 1e-5, gradients atol 1e-6
plus rel 1e-4 (f32 summation order; measured ~1e-7); bf16 outputs within
4e-2 of the larger of their own largest |value| and 1 (test_torch_bert's
bound: the two frameworks round at the same points in other orders).
Trainer steps: losses and `moe_aux_loss` rel 1e-5, params atol 2e-5
(2 % of lr; tests/test_torch_train.py measures why). The int8 bits,
the bridged trees and the checkpoints' leaves are compared bit for bit.
The data-parallel gang's global load-balance loss is held against the
JAX `Trainer` in tests/test_torch_data_parallel.py (gpt_tiny_moe)."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.checkpointing import (  # noqa: E402
    CheckpointManager as JCheckpointManager,
)
from kubeflow_tpu.checkpointing.quantize import (  # noqa: E402
    quantize_leaf_int8 as jquantize_leaf_int8,
    quantize_params_int8 as jquantize_params_int8,
)
from kubeflow_tpu.config.platform import (  # noqa: E402
    MeshConfig,
    TrainingConfig as JTrainingConfig,
)
from kubeflow_tpu.models.layers import MoeMlp as JMoeMlp  # noqa: E402
from kubeflow_tpu.models.registry import get_model as jget_model  # noqa: E402
from kubeflow_tpu.parallel import moe as jmoe  # noqa: E402
from kubeflow_tpu.parallel.mesh import mesh_from_config  # noqa: E402
from kubeflow_tpu.training.data import make_global_batch  # noqa: E402
from kubeflow_tpu.training.tasks import (  # noqa: E402
    CausalLmTask as JCausalLmTask,
    MlmTask as JMlmTask,
)
from kubeflow_tpu.training.trainer import Trainer as JTrainer  # noqa: E402
from kubeflow_tpu_torch.checkpointing import CheckpointManager  # noqa: E402
from kubeflow_tpu_torch.checkpointing.quantize import (  # noqa: E402
    quantize_leaf_int8,
    quantize_params_int8,
)
from kubeflow_tpu_torch.config.platform import TrainingConfig  # noqa: E402
from kubeflow_tpu_torch.models import get_model  # noqa: E402
from kubeflow_tpu_torch.models.bert import BertConfig  # noqa: E402
from kubeflow_tpu_torch.models.convert import (  # noqa: E402
    jax_path,
    load_jax_params,
    params_from_jax,
    params_to_jax,
    quantized_params_from_jax,
)
from kubeflow_tpu_torch.models.gpt import GptConfig, int8_model  # noqa: E402
from kubeflow_tpu_torch.models.layers import MoeCollector, MoeMlp  # noqa: E402
from kubeflow_tpu_torch.observability.mfu import (  # noqa: E402
    encoder_train_flops,
    lm_train_flops,
)
from kubeflow_tpu_torch.parallel import moe  # noqa: E402
from kubeflow_tpu_torch.training.tasks import (  # noqa: E402
    CausalLmTask,
    MlmTask,
)
from kubeflow_tpu_torch.training.trainer import Trainer  # noqa: E402

SEQ, BATCH, VOCAB = 32, 4, 512
BF16_REL = 4e-2
CFG = dict(global_batch_size=BATCH, steps=3, learning_rate=1e-3,
           warmup_steps=1, weight_decay=0.1, dtype="float32", seed=0)


def _np(t):
    return t.detach().float().numpy()


# -- routing -------------------------------------------------------------------


def _both(logits, capacity, k):
    want = jmoe.topk_route(jnp.asarray(logits), capacity, k=k)
    got = moe.topk_route(torch.as_tensor(logits), capacity, k=k)
    return got, want


def _assert_route(got, want):
    np.testing.assert_array_equal(_np(got.dispatch), np.asarray(want.dispatch))
    np.testing.assert_allclose(_np(got.combine), np.asarray(want.combine),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(float(got.aux_loss), float(want.aux_loss),
                               rtol=1e-6)
    assert float(got.fraction_dropped) == float(want.fraction_dropped)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("capacity", [2, 16])
def test_topk_route_matches_jax(k, capacity):
    """Seeded logits [3, 24, 6]: capacity 2 drops most choices (in token
    order, rank 0 first), 16 keeps every one."""
    logits = np.random.default_rng(k).normal(size=(3, 24, 6)).astype(
        np.float32)
    got, want = _both(logits, capacity, k)
    _assert_route(got, want)
    assert (float(got.fraction_dropped) > 0.5) == (capacity == 2)
    # the sums the gang's global loss is built from give the same loss
    again = moe.load_balance_loss(got.first_choice, got.prob_sum, 3 * 24, 6)
    np.testing.assert_allclose(float(again), float(want.aux_loss), rtol=1e-6)


def test_over_capacity_drops_in_token_order_and_rank0_comes_first():
    full = np.zeros((1, 4, 2), np.float32)
    full[..., 0] = 9.0
    got, want = _both(full, 2, 1)
    _assert_route(got, want)
    np.testing.assert_array_equal(_np(got.dispatch.sum((2, 3)))[0],
                                  [1, 1, 0, 0])
    ranked = np.tile(np.array([3.0, 2.0, -9.0, -9.0], np.float32), (1, 4, 1))
    got, want = _both(ranked, 2, 2)
    _assert_route(got, want)
    d = _np(got.dispatch)
    assert d[0, :2, 0].sum() == 2 and d[0, 2:, 0].sum() == 0
    assert d[0, :, 1].sum() == 2


@pytest.mark.parametrize("k", [1, 2, 3])
def test_an_exact_tie_takes_the_lower_expert_first(k):
    """Equal logits: `jax.lax.top_k` takes the lower index first; so does
    the port's argmax rounds (torch.topk promises no order)."""
    logits = np.zeros((2, 5, 4), np.float32)
    logits[1, :, 2:] = 1.0  # row 1: experts 2 and 3 tie above the rest
    got, want = _both(logits, 8, k)
    _assert_route(got, want)
    assert _np(got.dispatch)[0, :, 0].sum() == 5
    assert _np(got.dispatch)[1, :, 2].sum() == 5


def test_capacity_and_k_checks_match_jax():
    for args in ((32, 4, 1.0), (32, 4, 1.25), (3, 8, 1.0), (1, 8, 1.25),
                 (1024, 8, 1.25), (5, 8, 1.25)):
        assert moe.expert_capacity(*args) == jmoe.expert_capacity(*args)
    with pytest.raises(ValueError, match="k="):
        moe.topk_route(torch.zeros(1, 4, 4), 2, k=5)
    logits = torch.randn(2, 16, 4, generator=torch.Generator().manual_seed(1))
    a, b = moe.switch_route(logits, 8), moe.topk_route(logits, 8, k=1)
    assert torch.equal(a.dispatch, b.dispatch)
    assert torch.equal(a.combine, b.combine)


# -- MoeMlp --------------------------------------------------------------------


@pytest.mark.parametrize("dtype,x_dtype", [
    ("float32", "float32"), ("bfloat16", "bfloat16"),
    ("bfloat16", "float32")])  # BERT: bf16 compute fed the f32 stream
@pytest.mark.parametrize("k", [1, 2])
def test_moe_mlp_matches_jax(dtype, x_dtype, k):
    jdt, xdt = getattr(jnp, dtype), getattr(jnp, x_dtype)
    jm = JMoeMlp(mlp_dim=48, num_experts=4, top_k=k, dtype=jdt)
    x = np.random.default_rng(3).normal(size=(3, 10, 16)).astype(np.float32)
    jx = jnp.asarray(x).astype(xdt)
    variables = jm.init(jax.random.PRNGKey(0), jx, True)
    want, sown = jm.apply({"params": variables["params"]}, jx, True,
                          mutable=["losses", "moe_stats"])
    tm = MoeMlp(16, 48, 4, getattr(torch, dtype), top_k=k)
    tm.load_state_dict(params_from_jax(variables["params"]))
    col = MoeCollector()
    with torch.no_grad():
        got = tm(torch.as_tensor(x).to(getattr(torch, x_dtype)), col)
    assert got.dtype == getattr(torch, "float32" if x_dtype == "float32"
                                else dtype)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), want, atol=1e-5, rtol=0)
    else:
        scale = max(np.abs(want).max(), 1.0)
        assert np.abs(_np(got) - want).max() <= BF16_REL * scale
    stats = sown["moe_stats"]
    np.testing.assert_array_equal(_np(col.layers[0].expert_tokens),
                                  np.asarray(stats["expert_tokens"]))
    assert float(col.layers[0].dropped) == float(stats["dropped"])
    np.testing.assert_allclose(float(col.aux_loss()),
                               float(sown["losses"]["moe_aux"]), rtol=1e-5)


def test_collector_ignores_a_recompute_after_it_is_read():
    """A remat recompute in the backward runs the layers again: their
    second reports must not count."""
    m = get_model("gpt_tiny_moe", device="cpu", dtype=torch.float32,
                  remat=True).trainable()
    ids = torch.as_tensor(np.random.default_rng(0).integers(
        0, VOCAB, (2, 16)))
    col = MoeCollector()
    loss = m(ids, moe=col).float().mean() + col.aux_loss()
    loss.backward()
    assert len(col.layers) == m.cfg.num_layers
    assert m.layers[0].moe.router.grad.abs().sum() > 0


# -- the models, their losses and gradients ------------------------------------


def _lm_batch(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, (BATCH, SEQ)).astype(np.int32)
    mask = np.ones((BATCH, SEQ), np.int32)
    mask[1, 20:] = 0
    return {"input_ids": ids, "attention_mask": mask}


def _flat_grads(tree):
    return {k: np.asarray(v) for k, v in params_to_jax(
        params_from_jax(jax.tree.map(np.asarray, tree))).items()}


@pytest.mark.parametrize("name", ["gpt_tiny_moe", "bert_tiny_moe"])
def test_tiny_moe_loss_aux_and_gradients_match_jax(name):
    """The task loss (CE + the summed weighted load-balance loss), its
    `moe_aux_loss` and every parameter's gradient, from the JAX module's
    init, on a seeded batch."""
    jcfg = JTrainingConfig(model=name, **CFG)
    cfg = TrainingConfig(model=name, **CFG)
    if name.startswith("gpt"):
        jtask = JCausalLmTask(jcfg, seq_len=SEQ, vocab_size=VOCAB)
        task = CausalLmTask(cfg, seq_len=SEQ, vocab_size=VOCAB)
        batch = _lm_batch()
    else:
        jtask = JMlmTask(jcfg, seq_len=SEQ, vocab_size=VOCAB)
        task = MlmTask(cfg, seq_len=SEQ, vocab_size=VOCAB)
        batch = jtask.synthetic_data().batch_at(0)
    jm = jget_model(name, dtype=jnp.float32)
    params = jtask.init_variables(jm, jax.random.PRNGKey(0), batch)["params"]

    def jloss(p):
        loss, out = jtask.loss(jm, p, {}, {k: jnp.asarray(v) for k, v in
                                           batch.items()}, True, {})
        return loss, out["aux"]["moe_aux_loss"]

    (want, want_aux), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    tm = get_model(name, device="cpu", dtype=torch.float32).trainable()
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    loss, out = task.loss(tm, {k: torch.as_tensor(v).long()
                               for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(out["aux"]["moe_aux_loss"]),
                               float(want_aux), rtol=1e-5)
    assert float(want_aux) > 0
    jg = _flat_grads(jgrads)
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(_np(p.grad), jg[jax_path(n)], atol=1e-6,
                                   rtol=1e-4, err_msg=n)


def test_the_presets_build_with_the_reference_shapes():
    for name in ("gpt_small_moe", "gpt_tiny_moe", "bert_base_moe",
                 "bert_tiny_moe"):
        jm = jget_model(name)
        m = get_model(name, device="meta")
        assert m.cfg.num_experts == jm.cfg.num_experts, name
        assert m.cfg.moe_top_k == jm.cfg.moe_top_k == 1
        assert m.cfg.expert_capacity_factor == jm.cfg.expert_capacity_factor
        assert m.cfg.moe_aux_weight == jm.cfg.moe_aux_weight
    sd = get_model("gpt_small_moe", device="meta").state_dict()
    assert tuple(sd["layers.0.moe.wi"].shape) == (8, 768, 3072)
    assert tuple(sd["layers.0.moe.wo"].shape) == (8, 3072, 768)
    assert tuple(sd["layers.0.moe.router"].shape) == (768, 8)
    assert "layers.0.mlp_wi.kernel" not in sd
    assert sum(t.numel() for t in sd.values()) == 559_426_560
    # the pipeline knobs build (the pipeline axis is ported)
    assert BertConfig(num_experts=4, pipeline_stages=2).pipeline_stages == 2


def test_bert_moe_init_follows_flax_initializers():
    m = get_model("bert_base_moe", device="cpu", seed=1)
    layer = m.layers[0].moe
    assert abs(layer.router.std().item() / 0.02 - 1) < 0.02
    for w in (layer.wi, layer.wo):
        std = (1 / w.shape[-2]) ** 0.5
        assert abs(w.std().item() / std - 1) < 0.02
        assert w.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-6


# -- training: one card against the JAX Trainer; checkpoints both ways ---------


def _jax_trainer(devices8, name="gpt_tiny_moe"):
    cfg = JTrainingConfig(model=name, mesh=MeshConfig(data=1), **CFG)
    mesh = mesh_from_config(cfg.mesh, devices=devices8[:1])
    task = JCausalLmTask(cfg, seq_len=SEQ, vocab_size=VOCAB)
    return JTrainer(cfg, mesh=mesh, task=task,
                    model=jget_model(name, dtype=jnp.float32)), mesh, task


def _port_trainer(name="gpt_tiny_moe"):
    cfg = TrainingConfig(model=name, **CFG, checkpoint={"enabled": False})
    return Trainer(cfg, device="cpu",
                   task=CausalLmTask(cfg, seq_len=SEQ, vocab_size=VOCAB))


@pytest.fixture(scope="module")
def jax_moe_run(devices8):
    """Three JAX train steps of gpt_tiny_moe: init, per-step losses and
    moe_aux_loss, the params after step 3."""
    tr, mesh, task = _jax_trainer(devices8)
    state = tr.init_state()
    init = jax.tree.map(np.asarray, state.params)
    data = task.synthetic_data()
    losses, auxes = [], []
    for i in range(3):
        state, m = tr.train_step(state, make_global_batch(data.batch_at(i),
                                                          mesh),
                                 jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
        auxes.append(float(m["moe_aux_loss"]))
    return init, losses, auxes, jax.tree.map(np.asarray, state.params)


def test_train_steps_and_moe_aux_loss_match_the_jax_trainer(jax_moe_run):
    init, jlosses, jauxes, jparams = jax_moe_run
    tr = _port_trainer()
    state = tr.init_state()
    load_jax_params(state.model, init)
    data = tr.task.synthetic_data()
    losses, auxes = [], []
    for i in range(3):
        state, m = tr.train_step(state, data.batch_at(i))
        losses.append(float(m["loss"]))
        auxes.append(float(m["moe_aux_loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    np.testing.assert_allclose(auxes, jauxes, rtol=1e-5)
    want = params_from_jax(jparams)
    for n, p in state.model.named_parameters():
        if n.endswith("attention.key.bias"):
            continue  # its true gradient is 0 (test_torch_train.py)
        np.testing.assert_allclose(_np(p), want[n].numpy(), atol=2e-5,
                                   rtol=0, err_msg=n)


def test_fit_reports_moe_aux_loss_and_dense_runs_do_not():
    """`moe_aux_loss` reaches the fit metrics' aux, as the JAX trainer
    logs it; a dense model reports none."""
    for name, has in (("gpt_tiny_moe", True), ("gpt_tiny", False)):
        tr = _port_trainer(name)
        last = tr.fit(steps=2, log_every=1)
        assert ("moe_aux_loss" in last.aux) == has, name
        if has:
            assert np.isfinite(last.aux["moe_aux_loss"])
            assert last.aux["moe_aux_loss"] > 0


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            yield from _leaves(v, key)
        else:
            yield key, v


def _bitwise(got, want):
    got = got.detach().cpu().contiguous()
    want = np.ascontiguousarray(np.asarray(want))
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.reshape(-1).view(torch.uint8).numpy(),
                                  want.reshape(-1).view(np.uint8))


def test_checkpoints_cross_both_packages_with_the_expert_moments(devices8,
                                                                 tmp_path):
    """AdamW's mu/nu of the [E, ...] leaves: a port save restores into
    the JAX TrainState, and a JAX save into the port, bit for bit."""
    tr = _port_trainer()
    state = tr.init_state()
    data = tr.task.synthetic_data()
    for i in range(2):
        state, _ = tr.train_step(state, data.batch_at(i))
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    with CheckpointManager(port_dir, async_save=False) as mgr:
        assert mgr.save(state.step, state)
    got = dict(_leaves(state.checkpoint_tree()))
    assert "opt_state/1/0/mu/layer_0/moe/wi" in got
    jtr, mesh, jtask = _jax_trainer(devices8)
    jstate = JCheckpointManager(port_dir).restore(jtr.init_state())
    _assert_state_is(got, jstate)
    # and back: the JAX state, one step on, restores into the port
    jstate, _ = jtr.train_step(jstate, make_global_batch(
        jtask.synthetic_data().batch_at(2), mesh), jax.random.PRNGKey(0))
    with JCheckpointManager(jax_dir, async_save=False) as mgr:
        mgr.save(3, jstate)
    back = CheckpointManager(jax_dir, async_save=False).restore(
        _port_trainer().init_state())
    assert back.step == 3
    _assert_state_is(dict(_leaves(back.checkpoint_tree())), jstate)


def _assert_state_is(port_tree, jstate):
    """Every param and AdamW moment of the port's manifest tree is the
    JAX state's, bit for bit."""
    jstate = jax.tree.map(np.asarray, jstate)
    adam = jstate.opt_state[1][0]
    for tree, prefix in ((jstate.params, "params"),
                         (adam.mu, "opt_state/1/0/mu"),
                         (adam.nu, "opt_state/1/0/nu")):
        for path, want in params_to_jax(params_from_jax(tree)).items():
            _bitwise(port_tree[f"{prefix}/{path}"], want)


# -- int8, the bridge and the FLOP count ---------------------------------------


def test_int8_expert_stacks_are_the_jax_bits():
    """The scale of an [E, D, F] stack reduces over every axis but the
    last: the port's int8 values and scales are JAX's, bit for bit, for
    one stack and for gpt_tiny_moe's whole envelope (both layouts)."""
    w = np.random.default_rng(5).normal(size=(4, 16, 24)).astype(np.float32)
    q, s = quantize_leaf_int8(torch.as_tensor(w))
    jq, js = jquantize_leaf_int8(jnp.asarray(w))
    assert tuple(s.shape) == (24,)
    _bitwise(q, jq)
    _bitwise(s, js)
    jm = jget_model("gpt_tiny_moe", dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
                     deterministic=True)["params"]
    tm = get_model("gpt_tiny_moe", device="cpu", dtype=torch.float32)
    load_jax_params(tm, jax.tree.map(np.asarray, params))
    mine = quantize_params_int8(tm.state_dict())
    theirs = quantized_params_from_jax(jax.tree.map(
        np.asarray, jquantize_params_int8(params)))
    assert mine["qscales"].keys() == theirs["qscales"].keys()
    assert "layers.0.moe.wi" in mine["qscales"]
    for part in ("qvalues", "qscales"):
        for n, v in theirs[part].items():
            _bitwise(mine[part][n], v.numpy())
    # an int8 model of the envelope dequantizes the stacks at use
    q8 = int8_model(tm, mine)
    assert q8.layers[0].moe.wi.dtype == torch.int8
    ids = torch.as_tensor(np.arange(12)[None] % VOCAB)
    with torch.no_grad():
        assert torch.isfinite(q8(ids)).all()


@pytest.mark.parametrize("layout", ["named", "scan"])
def test_the_expert_leaves_cross_in_both_layouts(layout):
    """moe/{router,wi,wo} cross to the flax tree and back bit for bit,
    named or scan-stacked ([L, E, ...]); a JAX scan-layers tree loads."""
    tm = get_model("gpt_tiny_moe", device="cpu", seed=2)
    flat = params_to_jax(tm.state_dict(), layout)
    key = ("layers/block/moe/wi" if layout == "scan" else "layer_1/moe/wi")
    assert flat[key].shape == ((2, 4, 64, 128) if layout == "scan"
                               else (4, 64, 128))
    back = params_from_jax(flat)
    for n, v in tm.state_dict().items():
        _bitwise(back[n], v.numpy())
    if layout == "scan":
        jm = jget_model("gpt_tiny_moe", dtype=jnp.float32, scan_layers=True)
        params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
                         deterministic=True)["params"]
        load_jax_params(tm, jax.tree.map(np.asarray, params))
        _bitwise(tm.layers[1].moe.wo,
                 np.asarray(params["layers"]["block"]["moe"]["wo"])[1])


@pytest.mark.parametrize("family", ["gpt", "bert"])
def test_moe_train_flops_against_a_hand_count(family):
    """The router's D·E a token and the expert products at capacity
    (E·C slots a row, every slot computed), 6× for forward and backward;
    the one-hot dispatch and combine are not counted."""
    if family == "gpt":
        cfg, fn, b, s = GptConfig(num_experts=8), lm_train_flops, 8, 1024
        attn, extra = 6 * b * 12 * s * s * 64, 768 * 50257
    else:
        cfg, fn, b, s = BertConfig(num_experts=8), encoder_train_flops, 32, 512
        attn, extra = 12 * b * 12 * s * s * 64, 768 * 768 + 768 * 30522
    c = -(-s * 5 // 32)  # ceil(s / 8 · 1.25): 160 at 1024, 80 at 512
    assert c == moe.expert_capacity(s, 8, 1.25)
    per_layer = (6 * 4 * 768 * 768 * b * s + 6 * 768 * 8 * b * s
                 + 6 * 2 * 768 * 3072 * b * 8 * c + attn)
    assert fn(cfg, b, s) == 12 * per_layer + 6 * extra * b * s
    dense = fn(dataclasses.replace(cfg, num_experts=0), b, s)
    # routed at capacity factor 1.25: the MLP's products grow 1.25x
    mlp = 12 * 6 * 2 * 768 * 3072 * b * s
    assert fn(cfg, b, s) - dense == 12 * 6 * 768 * 8 * b * s + mlp // 4

