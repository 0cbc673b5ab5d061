"""The port's training path (kubeflow_tpu_torch: config, data, tasks,
trainer, train_run, mfu) against the JAX package's, and its own
equivalences, on the CPU at gpt_tiny size in f32.

Cross-framework: the JAX `Trainer` (one-device mesh, gpt_tiny,
attention_impl="flash": Pallas in interpret mode) and the port's
`Trainer` (same flax params through `params_from_jax`, flash on its plain
path) take three `train_step`s on the same `SyntheticData.batch_at`
batches. Losses agree within rel 1e-5 (f32 summation order) and params
after step 3 within atol 2e-5 = 2 % of lr: AdamW divides each element's
step by its own gradient scale, so where a gradient element is tiny the
two frameworks' summation-order noise in it moves that element's step by
a visible fraction of lr (measured up to 4.7e-6). Inside the port the
equivalences (accumulation, remat, chunked loss, flash against dense)
hold at the same bounds for the same reasons: losses rel 1e-5, params
atol 2e-5 (measured up to 1.7e-6)."""

import importlib.util
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

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
    cross_entropy as jcross_entropy,
    make_optimizer as jmake_optimizer,
)
from kubeflow_tpu.training.trainer import Trainer as JTrainer  # noqa: E402
from kubeflow_tpu_torch.config.platform import (  # noqa: E402
    CheckpointConfig,
    ConfigError,
    TrainingConfig,
)
from kubeflow_tpu_torch.models.convert import load_jax_params  # noqa: E402
from kubeflow_tpu_torch.models import get_model  # noqa: E402
from kubeflow_tpu_torch.models.gpt import GptConfig  # noqa: E402
from kubeflow_tpu_torch.observability.mfu import (  # noqa: E402
    lm_train_flops,
    mfu,
)
from kubeflow_tpu_torch.runtime.train_run import run_training  # noqa: E402
from kubeflow_tpu_torch.training.data import SyntheticData  # noqa: E402
from kubeflow_tpu_torch.training.tasks import (  # noqa: E402
    CausalLmTask,
    clip_by_global_norm,
    cross_entropy,
    make_schedule,
)
from kubeflow_tpu_torch.training.trainer import Trainer  # noqa: E402

SEQ, BATCH, VOCAB = 64, 4, 512
CFG = dict(model="gpt_tiny", global_batch_size=BATCH, steps=3,
           learning_rate=1e-3, warmup_steps=1, weight_decay=0.1,
           dtype="float32", seed=0)
# run_training checkpoints by default (the JAX package's default): these
# runs test other things and write nothing
NO_CHECKPOINT = {"enabled": False}
LEAVES = ("layers.0.attention.query.kernel", "layers.1.mlp_wo.kernel",
          "tok_emb.embedding", "head.kernel", "ln_final.scale")


def _jleaf(params, name):
    node = params
    parts = name.split(".")
    if parts[0] == "layers":
        node, parts = node[f"layer_{parts[1]}"], parts[2:]
    for p in parts:
        node = node[p]
    return np.asarray(node)


@pytest.fixture(scope="module")
def jax_run(devices8):
    """Three JAX train steps (flash, one device): per-step losses, the
    initial params and the params after steps 1 and 3."""
    cfg = JTrainingConfig(mesh=MeshConfig(data=1), **CFG)
    mesh = mesh_from_config(cfg.mesh, devices=devices8[:1])
    task = JCausalLmTask(cfg, seq_len=SEQ, vocab_size=VOCAB)
    tr = JTrainer(cfg, mesh=mesh, task=task,
                  model=jget_model("gpt_tiny", dtype=jnp.float32,
                                   attention_impl="flash"))
    state = tr.init_state()
    init = jax.tree.map(np.asarray, state.params)
    data = task.synthetic_data()
    losses, after = [], []
    for i in range(3):
        batch = make_global_batch(data.batch_at(i), mesh)
        state, m = tr.train_step(state, batch, jax.random.PRNGKey(0))
        losses.append(float(m["loss"]))
        after.append(jax.tree.map(np.asarray, state.params))
    return init, losses, after


def _port_trainer(**over):
    cfg = TrainingConfig(**{**CFG, "attention_impl": "flash", **over})
    return Trainer(cfg, device="cpu",
                   task=CausalLmTask(cfg, seq_len=SEQ, vocab_size=VOCAB))


def test_train_steps_match_the_jax_trainer(jax_run):
    init, jlosses, jafter = jax_run
    tr = _port_trainer()
    state = tr.init_state()
    load_jax_params(state.model, init)
    before = {n: p.detach().clone() for n, p in state.params.items()}
    data = tr.task.synthetic_data()
    losses = []
    for i in range(3):
        state, m = tr.train_step(state, data.batch_at(i))
        losses.append(float(m["loss"]))
        if i == 0:
            # the lr-0 first update (optax evaluates the schedule at the
            # count before the update): no param moves on either side
            for n, p in state.params.items():
                torch.testing.assert_close(p.detach(), before[n], atol=0, rtol=0)
                np.testing.assert_array_equal(_jleaf(jafter[0], n),
                                              _jleaf(init, n))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert state.step == 3
    for name in LEAVES:
        got = state.params[name].detach().numpy()
        want = _jleaf(jafter[2], name)
        assert np.abs(want - _jleaf(init, name)).max() > 1e-4, name  # moved
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=0, err_msg=name)


def _two_steps(tr, batches):
    state = tr.init_state()
    losses = []
    for b in batches:
        state, m = tr.train_step(state, b)
        losses.append(float(m["loss"]))
    return losses, {n: p.detach().clone() for n, p in state.params.items()}


def _assert_same(a, b, rtol=1e-5, atol=2e-5):
    np.testing.assert_allclose(a[0], b[0], rtol=rtol)
    for name in LEAVES:
        torch.testing.assert_close(a[1][name], b[1][name], atol=atol, rtol=0,
                                   msg=lambda m: f"{name}: {m}")


def _ragged_batches():
    """Rows with very different valid-pair counts, so the accumulation's
    microbatches are unequally weighted (JAX test_trainer.py:285-330)."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(2):
        ids = rng.integers(0, VOCAB, size=(BATCH, SEQ)).astype(np.int32)
        mask = np.ones((BATCH, SEQ), np.int32)
        for row in range(BATCH):
            mask[row, 3 + 9 * row:] = 0
        out.append({"input_ids": ids, "attention_mask": mask})
    return out


@pytest.mark.parametrize("batches", ["synthetic", "ragged"])
def test_accum_steps_2_equals_1(batches):
    data = SyntheticData("lm", BATCH, seq_len=SEQ, vocab_size=VOCAB)
    bs = ([data.batch_at(i) for i in range(2)] if batches == "synthetic"
          else _ragged_batches())
    _assert_same(_two_steps(_port_trainer(accum_steps=2), bs),
                 _two_steps(_port_trainer(accum_steps=1), bs))


@pytest.mark.parametrize("over", [dict(remat=True), dict(loss_chunk=16),
                                  dict(attention_impl="dense")],
                         ids=["remat", "loss_chunk16", "dense"])
def test_port_equivalences(over):
    """remat=True == False, loss_chunk=16 == 0, and flash == dense (f32:
    the dense path rounds nothing here, and /8 is exact)."""
    bs = _ragged_batches()
    _assert_same(_two_steps(_port_trainer(**over), bs),
                 _two_steps(_port_trainer(), bs))


def test_run_training_returns_the_jax_result_keys():
    cfg = TrainingConfig(**{**CFG, "seq_len": SEQ, "attention_impl": "flash",
                            "accum_steps": 2, "remat": True, "loss_chunk": 16,
                            "checkpoint": NO_CHECKPOINT})
    res = run_training(cfg, device="cpu", log_every=1)
    assert {"final_step", "loss", "items_per_sec", "already_complete",
            "preempted", "compile_s"} <= set(res)
    assert res["final_step"] == 3 and not res["preempted"]
    assert [s for s, _ in res["losses"]] == [1, 2, 3]
    assert all(np.isfinite(loss) for _, loss in res["losses"])
    assert res["items_per_sec"] > 0 and "mfu" not in res  # no CPU peak


def test_fit_reads_every_steps_loss_in_its_windows_one_sync():
    """With one log window over the whole run, fit still returns every
    step's loss (read together at the window's end), equal to a run that
    reads the loss after every step."""
    cfg = TrainingConfig(**{**CFG, "seq_len": SEQ, "checkpoint": NO_CHECKPOINT})
    once = run_training(cfg, device="cpu", log_every=cfg.steps)
    each = run_training(cfg, device="cpu", log_every=1)
    assert [s for s, _ in once["losses"]] == [1, 2, 3]
    assert once["losses"] == each["losses"]


def test_stop_event_preempts_after_the_step_in_flight():
    stop = threading.Event()
    stop.set()
    cfg = TrainingConfig(**{**CFG, "seq_len": SEQ, "checkpoint": NO_CHECKPOINT})
    res = run_training(cfg, device="cpu", stop_event=stop)
    assert res["preempted"] and res["final_step"] == 1


def test_clip_and_schedule_match_optax():
    """optax's clip_by_global_norm and warmup-cosine schedule on a seeded
    gradient tree, below and above the clip threshold."""
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((5, 3)).astype(np.float32),
            "b": rng.standard_normal((7,)).astype(np.float32)}
    for scale in (0.01, 3.0):
        leaves = {k: v * scale for k, v in tree.items()}
        want, _ = optax.clip_by_global_norm(1.0).update(
            jax.tree.map(jnp.asarray, leaves), optax.EmptyState()
        )
        grads = {k: torch.from_numpy(v.copy()) for k, v in leaves.items()}
        clip_by_global_norm(grads.values(), 1.0)
        for k in grads:
            np.testing.assert_allclose(grads[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=0)
    cfg = TrainingConfig(**{**CFG, "steps": 20, "warmup_steps": 5})
    _, jsched = jmake_optimizer(JTrainingConfig(**{**CFG, "steps": 20,
                                                   "warmup_steps": 5}),
                                "gpt_tiny")
    sched = make_schedule(cfg)
    for count in range(0, 25):
        assert sched(count) == pytest.approx(float(jsched(count)), rel=1e-6,
                                             abs=1e-12)
    assert sched(0) == 0.0


def test_synthetic_batches_and_cross_entropy_match_jax():
    mine = SyntheticData("lm", 3, seed=7, seq_len=10, vocab_size=99)
    theirs = JSyntheticData("lm", 3, seed=7, seq_len=10, vocab_size=99)
    for step in (0, 5):
        a, b = mine.batch_at(step), theirs.batch_at(step)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((4, 6, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (4, 6))
    labels[0, :3] = -100
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                        ignore=-100)
    want = jcross_entropy(jnp.asarray(logits), jnp.asarray(labels), ignore=-100)
    assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_config_refuses_what_it_does_not_honour():
    cfg = TrainingConfig.from_dict({"model": "gpt_tiny",
                                    "checkpoint": {"enabled": False}})
    assert isinstance(cfg.checkpoint, CheckpointConfig)
    assert not cfg.checkpoint.enabled and cfg.checkpoint.keep == 3
    # the data and fsdp axes are ported; fsdp beside the expert axis
    # still names its ROADMAP item
    assert TrainingConfig.from_dict(
        {"model": "gpt_tiny", "global_batch_size": 4,
         "mesh": {"data": 2}}).mesh.data == 2
    assert TrainingConfig.from_dict(
        {"model": "gpt_tiny", "mesh": {"fsdp": 2}}).mesh.fsdp == 2
    assert TrainingConfig.from_dict(
        {"model": "gpt_tiny", "global_batch_size": 8,
         "mesh": {"data": 2, "fsdp": 2}}).mesh.num_devices == 4
    with pytest.raises(ConfigError, match="A13 item 8"):
        TrainingConfig.from_dict({"model": "gpt_tiny",
                                  "mesh": {"fsdp": 2, "expert": 2}})
    # the tensor axis is ported; beside the fsdp axis, and for an image
    # model, it names its ROADMAP item
    assert TrainingConfig.from_dict(
        {"model": "gpt_tiny", "mesh": {"tensor": 2}}).mesh.tensor == 2
    with pytest.raises(ConfigError, match="A13 item 9"):
        TrainingConfig.from_dict({"model": "gpt_tiny",
                                  "mesh": {"tensor": 2, "fsdp": 2}})
    with pytest.raises(ConfigError, match="A13 item 10"):
        TrainingConfig.from_dict({"model": "mlp", "mesh": {"tensor": 2}})
    with pytest.raises(ConfigError, match="unknown field"):
        TrainingConfig.from_dict({"model": "gpt_tiny", "bogus": 1})
    # the profiler endpoint is ported (runtime/profiler.py); the compile
    # cache stays refused
    assert TrainingConfig.from_dict(
        {"model": "gpt_tiny", "profiler_logdir": "/tmp/prof"}
    ).profiler_logdir == "/tmp/prof"
    with pytest.raises(ConfigError, match="A14"):
        TrainingConfig.from_dict({"model": "gpt_tiny",
                                  "compile_cache_dir": "/tmp/cache"})
    # eval without a held-out split is refused as in the JAX config
    with pytest.raises(ConfigError, match="requires a real dataset"):
        TrainingConfig.from_dict({"model": "gpt_tiny",
                                  "data": {"eval_every_steps": 5}})
    with pytest.raises(TypeError):
        TrainingConfig(model="gpt_tiny", compile_cache_dir="/tmp/cache")
    with pytest.raises(ConfigError, match="accum_steps"):
        TrainingConfig(model="gpt_tiny", global_batch_size=6, accum_steps=4)
    with pytest.raises(ConfigError, match="requires data.path"):
        TrainingConfig(model="gpt_tiny", data={"name": "npz"})
    cfg = TrainingConfig.from_dict({
        "model": "gpt_small", "seq_len": 4096, "global_batch_size": 8,
        "accum_steps": 4, "remat": True, "loss_chunk": 4096,
        "assume_full_attention": True, "data": {"prefetch_depth": 0},
    })
    assert cfg.data.prefetch_depth == 0 and cfg.learning_rate == 0.1
    with pytest.raises(ValueError, match="exceeds the model's max_len"):
        Trainer(TrainingConfig(model="gpt_tiny", seq_len=256), device="cpu",
                model=get_model("gpt_tiny", device="cpu"))


@pytest.mark.parametrize("impl", ["auto", "ring", "ulysses"])
def test_unported_attention_and_dropout_raise(impl):
    """The "auto" policy and dropout are ported: both build and train
    (through the trainer's per-step generator); ring and ulysses are
    ported too (parallel/): their configs build, and without a sequence
    axis their forward is dense attention's."""
    if impl != "auto":
        assert GptConfig(attention_impl=impl).attention_impl == impl
        ids = torch.arange(16).reshape(2, 8) % 64
        sp = get_model("gpt_tiny", dtype=torch.float32, device="cpu",
                       attention_impl=impl)
        dense = get_model("gpt_tiny", dtype=torch.float32, device="cpu")
        assert torch.equal(sp(ids), dense(ids))
        return
    assert GptConfig(attention_impl=impl).attention_impl == "auto"
    assert GptConfig(dropout_rate=0.1).dropout_rate == 0.1
    model = get_model("gpt_tiny", dtype=torch.float32, device="cpu",
                      attention_impl="auto", dropout_rate=0.1)
    cfg = TrainingConfig(**{**CFG, "steps": 2, "seq_len": SEQ,
                            "attention_impl": "auto"})
    tr = Trainer(cfg, model=model, device="cpu")
    state = tr.init_state()
    data = tr.task.synthetic_data()
    losses = [float(tr.train_step(state, data.batch_at(i))[1]["loss"])
              for i in range(2)]
    assert all(np.isfinite(losses))


def _chip_smoke():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_flash_bound_counts_visible_pairs():
    """The bound counts the (query, key) pairs a causal call sees, and
    under a key mask only the unpadded keys' pairs; a bidirectional call
    (BERT's) sees every unpadded key from every query."""
    smoke = _chip_smoke()
    elems = smoke.FB * smoke.FS * smoke.FH * smoke.FD
    want_ms = {"flash_fwd": 0.052, "flash_bwd_dq": 0.078,
               "flash_bwd_dkv": 0.104}
    for kname, c in (("flash_fwd", 4), ("flash_bwd_dq", 6),
                     ("flash_bwd_dkv", 8)):
        ms, by, nbytes, ops = smoke.flash_bound(kname, None, smoke.FS, 2,
                                                "bfloat16")
        pairs = smoke.FB * smoke.FS * (smoke.FS + 1) // 2
        assert ops == c * pairs * smoke.FH * smoke.FD
        assert by == "operations" and nbytes > 4 * elems * 2
        assert ms == pytest.approx(want_ms[kname], abs=5e-4)
    s = 16
    _, _, _, _, mask = smoke.flash_case(torch, torch.float32, s, True, "cpu")
    m = mask.numpy() != 0
    seen = np.tril(np.ones((s, s), bool))[None] & m[:, None, :]
    _, _, _, ops = smoke.flash_bound("flash_fwd", mask, s, 4, "float32")
    assert ops == 4 * int(seen.sum()) * smoke.FH * smoke.FD
    # bidirectional (BERT's call): every query sees every unpadded key
    b, h, d = smoke.BB, smoke.BH, smoke.BD
    _, _, _, _, ragged = smoke.flash_case(
        torch, torch.float32, s, True, "cpu", b=b, h=h, d=d,
        lengths=[min(n, s) for n in smoke.BERT_LENGTHS])
    keys = int((ragged.numpy() != 0).sum())
    assert keys == sum(min(n, s) for n in smoke.BERT_LENGTHS)
    _, _, _, ops = smoke.flash_bound("flash_fwd", ragged, s, 4, "float32",
                                     causal=False, b=b, h=h, d=d)
    assert ops == 4 * s * keys * h * d
    elems = b * smoke.BS * h * d
    want = {"flash_fwd": (4, 0.03028, "bytes"),
            "flash_bwd_dq": (6, 0.03908, "operations"),
            "flash_bwd_dkv": (8, 0.05211, "operations")}
    for kname, (c, want_ms, want_by) in want.items():
        ms, by, nbytes, ops = smoke.flash_bound(
            kname, None, smoke.BS, 2, "bfloat16", causal=False, b=b, h=h, d=d)
        assert ops == c * b * smoke.BS * smoke.BS * h * d
        assert by == want_by and nbytes > 4 * elems * 2
        assert ms == pytest.approx(want_ms, abs=1e-5)


def test_chip_smoke_flash_check_holds_each_row_at_its_own_scale():
    """Phase 6's bf16 check: the plain outputs rounded to bf16 (one ulp)
    pass with room; an error of 1 % of the tensor's largest |value| on
    the later half of the causal rows — under the 2 %-of-max limit an
    absolute check would use, and several times those rows' own values'
    rounding — fails, in o, dq, dk and dv alike."""
    from kubeflow_tpu_torch.ops import flash_attention as fa

    smoke = _chip_smoke()
    s = 256
    q, k, v, do, _ = smoke.flash_case(torch, torch.float32, s, False, "cpu")
    scale = fa.default_scale(smoke.FD)
    o, lse = fa.flash_attention_reference(q, k, v, None, True, scale)
    delta = fa.flash_attention_delta(o, do)
    dq = fa.flash_bwd_dq_reference(q, k, v, None, do, lse, delta, True, scale)
    dk, dv = fa.flash_bwd_dkv_reference(q, k, v, None, do, lse, delta, True,
                                        scale)
    for want, key in ((o, "o"), (dq, "grad"), (dk, "grad"), (dv, "grad")):
        _, worst, typical = smoke.flash_err(torch, want.bfloat16(), want,
                                            "bfloat16", key)
        assert worst <= 0.25 and typical > 0
        bad = want.clone()
        bad[:, s // 2:] += 0.01 * want.abs().max()
        _, worst, _ = smoke.flash_err(torch, bad, want, "bfloat16", key)
        assert worst > 5


def test_chip_smoke_train_phases_rehearse_on_cpu():
    """chip_smoke.py's train phases, driven on the CPU at gpt_tiny size:
    f32 flash and dense losses agree, and the main-path run (remat,
    accumulation, chunked loss) reads a finite loss at every step. CPU
    tensors take the plain versions, so nothing is launched."""
    smoke = _chip_smoke()
    smoke.phase_train_f32(torch, model="gpt_tiny", seq=32, device="cpu")
    launches, result = smoke.phase_train_bf16(
        torch, overrides=dict(model="gpt_tiny", seq_len=64,
                              global_batch_size=4, accum_steps=2,
                              loss_chunk=32, steps=3),
        device="cpu",
    )
    assert launches == {"flash_fwd": 0, "flash_bwd_dq": 0,
                        "flash_bwd_dkv": 0}
    assert result["final_step"] == 3 and "compile_s" in result


def test_chip_smoke_checkpoint_phases_rehearse_on_cpu(tmp_path, monkeypatch):
    """chip_smoke.py's phase 12 on the CPU at gpt_tiny size (seq 128 =
    its max_len, so the checkpoint serves as the registry model): 12a's
    preempted-and-resumed run equals the uninterrupted one bit for bit
    (losses and every saved file), and 12b serves the checkpoint: f32
    weights bit for bit the trainer's, tokens equal generate() with and
    without a draft from the checkpoint, the drafted bf16 REST traffic,
    the int8 envelope bit for bit the port's quantize and the int8
    kernel tokens equal gather's (CPU tensors take the plain versions:
    no launches)."""
    for knob in ("DRAFT_MODEL", "DRAFT_TOKENS", "DRAFT_CHECKPOINT_DIR",
                 "QUANTIZE", "NUM_SLOTS"):
        monkeypatch.delenv(f"KFT_SERVING_{knob}", raising=False)
    smoke = _chip_smoke()
    launches, trainer, ckpt_dir = smoke.phase_ckpt_train(
        torch, str(tmp_path), overrides=dict(model="gpt_tiny", seq_len=128),
        device="cpu")
    assert launches == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    assert trainer._final_state.step == smoke.CKPT_TRAIN_CFG["steps"]
    k0 = {"load_tokens_per_s": 1.0, "load_decode_step_ms": 1.0}
    paged = smoke.phase_ckpt_serve(
        torch, trainer, ckpt_dir, k0, 1.0, model="gpt_tiny", device="cpu",
        f32_prompts=(5, 37), f32_max_new=8, short=(3, 5, 9, 17, 30),
        long_len=90, hit_len=40, max_new=16, buckets="8,16,32")
    assert not any(paged.values())


def test_mfu_counts_model_flops():
    """6·params·tokens for the matmuls (head included) plus 6·B·H·S²·D
    per layer of causal attention; no peak on the CPU means no MFU."""
    small = GptConfig()
    params = 12 * (4 * 768 * 768 + 2 * 768 * 3072) + 768 * 50257
    want = 6 * params * 8 * 4096 + 12 * 6 * 8 * 12 * 4096 ** 2 * 64
    assert lm_train_flops(small, 8, 4096) == want
    assert mfu(want, 0.25, peak=989e12) == pytest.approx(want / 0.25 / 989e12)
    assert mfu(want, 0.25, peak=None) is None
