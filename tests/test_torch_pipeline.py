"""The port's pipeline pieces on one process (kubeflow_tpu_torch/parallel/
pipeline.py and the pipelined GPT and BERT models), against the JAX
package's `PipelinedDecoder` / `PipelinedEncoder` (tests/test_pipeline.py,
tests/test_gpt.py) in f32 on the CPU.

- The pipelined stacks: the JAX pipelined model's params through the
  bridge (the stacked `decoder|encoder/stages/layer_<j>` layout) into the
  port's model, which runs the microbatches through the stages in turn,
  give the JAX model's outputs (atol/rtol 1e-5); the port's stages run
  one at a time (embed, stage, stage, finish) give the same bits, and so
  does the unpipelined port model on the same weights.
- The schedules themselves run in tests/test_torch_pipeline_parallel.py's
  gangs (each stage's order of forwards and backwards, its live peak).
- Refusals: an unknown schedule, pipelined decoding, a model without
  stages on a pipeline axis, pipeline × sequence.
- A stage's seeded init is world 1's leaves; the bridge both ways; the
  annotations' stage axis; the stages' FLOP counts.
- Dropout: the pipelined forward draws each microbatch's rows of the
  unpipelined forward's masks, and a remat recompute on another thread
  (autograd's device thread) replays the microbatch's rows.
"""

import math
import os
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.models.registry import get_model as jget_model  # noqa: E402
from kubeflow_tpu.parallel.pipeline import (  # noqa: E402
    microbatch as jmicrobatch,
)
from kubeflow_tpu_torch.config.platform import (  # noqa: E402
    ConfigError,
    TrainingConfig,
)
from kubeflow_tpu_torch.models.convert import (  # noqa: E402
    StageLayout,
    load_jax_params,
    params_from_jax,
    params_to_jax,
)
from kubeflow_tpu_torch.models.layers import (  # noqa: E402
    dropout_rows,
    stage_layout,
)
from kubeflow_tpu_torch.models.registry import get_model  # noqa: E402
from kubeflow_tpu_torch.observability.mfu import (  # noqa: E402
    encoder_train_flops,
    lm_train_flops,
    rank_train_flops,
)
from kubeflow_tpu_torch.parallel.mesh import PipelineShard  # noqa: E402
from kubeflow_tpu_torch.parallel.pipeline import (  # noqa: E402
    clamp_microbatches,
    microbatch,
    pipeline_stage_slices,
    unmicrobatch,
)
from kubeflow_tpu_torch.parallel.sharding import param_specs  # noqa: E402
from kubeflow_tpu_torch.training.annotations import (  # noqa: E402
    logical_axes_for,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return t.detach().float().cpu().numpy()


def _jax_pipelined(name, stages, layers, microbatches=0, schedule="gpipe",
                   batch=4, seq=16, seed=1):
    """A JAX pipelined model, its params and its outputs on seeded ids."""
    model = jget_model(name, dtype=jnp.float32, pipeline_stages=stages,
                       num_layers=layers, num_microbatches=microbatches,
                       pipeline_schedule=schedule)
    ids = np.random.default_rng(seed).integers(0, 512, (batch, seq)).astype(
        np.int32)
    mask = np.ones((batch, seq), bool)
    mask[1, seq // 2:] = False
    params = model.init(jax.random.PRNGKey(seed), jnp.asarray(ids[:1]),
                        deterministic=True)["params"]
    out = model.apply({"params": params}, jnp.asarray(ids),
                      attention_mask=jnp.asarray(mask), deterministic=True)
    return jax.tree.map(np.asarray, params), ids, mask, out


def _port_out(out):
    return out["mlm_logits"] if isinstance(out, dict) else out


def _stage_models(name, stages, **kw):
    return [get_model(name, device="cpu", dtype=torch.float32,
                      pipeline_stages=stages,
                      pipeline=PipelineShard(None, s, stages), **kw)
            for s in range(stages)]


def _run_stages(parts, ids, mask):
    x = parts[0].embed(ids)
    for p in parts:
        x = p.stage(x, attention_mask=mask)
    last = parts[-1]
    return last.heads(x) if hasattr(last, "heads") else last.finish(x)


@pytest.mark.parametrize("name,stages,layers,micro", [
    ("gpt_tiny", 2, 4, 0), ("gpt_tiny", 2, 4, 4), ("gpt_tiny", 4, 4, 2),
    ("bert_tiny", 2, 2, 0), ("bert_tiny", 2, 4, 4),
    ("bert_tiny_moe", 2, 2, 2)])
def test_the_pipelined_stack_equals_the_jax_pipelined_model(
        name, stages, layers, micro):
    """test_pipelined_{decoder,encoder}_equals_sequential_stages on the
    port: the JAX pipelined model's stacked params load into the port's
    pipelined model, whose outputs are the JAX model's (1e-5); the port's
    stages run one at a time give its bits, and the unpipelined port
    model on the same weights too (rows are independent)."""
    params, ids, mask, jout = _jax_pipelined(name, stages, layers, micro)
    prefix = "decoder" if name.startswith("gpt") else "encoder"
    assert params[prefix]["stages"]["layer_0"]["ln_att"]["scale"].shape == \
        (stages, 64)
    kw = dict(num_layers=layers, num_microbatches=micro)
    model = get_model(name, device="cpu", dtype=torch.float32,
                      pipeline_stages=stages, **kw)
    load_jax_params(model, params)
    tids, tmask = torch.as_tensor(ids).long(), torch.as_tensor(mask)
    got = _port_out(model(tids, attention_mask=tmask))
    want = jout["mlm_logits" if "mlm_logits" in jout else "logits"]
    np.testing.assert_allclose(_np(got), np.asarray(want), **TOL)
    parts = _stage_models(name, stages, **kw)
    for p in parts:
        load_jax_params(p, params)
    torch.testing.assert_close(
        _port_out(_run_stages(parts, tids, tmask)) if micro == 0
        else _port_out(model(tids, attention_mask=tmask)), got,
        rtol=0, atol=0)
    flat = get_model(name, device="cpu", dtype=torch.float32,
                     num_layers=layers)
    flat.load_state_dict(model.state_dict())
    torch.testing.assert_close(_port_out(flat(tids, attention_mask=tmask)),
                               got, rtol=0, atol=0)


def test_a_bf16_stage_boundary_crosses_in_the_compute_dtype():
    """BERT's residual stream is f32 between layers, but a stage's output
    crosses to the next stage in the compute dtype (the JAX roll casts):
    the pipelined bf16 model equals the unpipelined one with that cast
    after layer 0, not the unpipelined model itself."""
    kw = dict(device="cpu", dtype=torch.bfloat16, num_layers=2, seed=2)
    piped = get_model("bert_tiny", pipeline_stages=2, **kw)
    flat = get_model("bert_tiny", **kw)
    ids = torch.randint(0, 512, (4, 16), generator=torch.Generator()
                        .manual_seed(0))
    x = flat.embed(ids)
    h = flat.layers[0](x, flat._call(None, 4, 16, ids.device, None, None))
    h = h.to(torch.bfloat16)
    h = flat.layers[1](h, flat._call(None, 4, 16, ids.device, None, None))
    torch.testing.assert_close(piped(ids)["mlm_logits"],
                               flat.heads(h)["mlm_logits"], rtol=0, atol=0)


def test_microbatch_round_trips():
    """TestGpipeSchedule.test_microbatch_roundtrip, against the JAX
    helper's split."""
    x = torch.arange(24.0).reshape(12, 2)
    torch.testing.assert_close(unmicrobatch(microbatch(x, 4)), x)
    np.testing.assert_array_equal(_np(microbatch(x, 4)),
                                  np.asarray(jmicrobatch(x.numpy(), 4)))
    with pytest.raises(ValueError, match="not divisible"):
        microbatch(x, 5)
    with pytest.raises(ValueError, match="not divisible"):
        pipeline_stage_slices(12, 5)
    assert pipeline_stage_slices(12, 4) == (3, 4)
    # the JAX clamp: the largest count <= the request dividing the batch
    assert [clamp_microbatches(m, 4, 12) for m in (0, 5, 8, 16)] == \
        [4, 4, 6, 12]


@pytest.mark.parametrize("family", ["gpt_tiny", "bert_tiny"])
def test_an_unknown_schedule_is_refused(family):
    """tests/test_pipeline.py test_unknown_schedule_rejected."""
    with pytest.raises(ValueError, match="schedule"):
        get_model(family, device="meta", pipeline_stages=2,
                  pipeline_schedule="rolling")
    with pytest.raises(ConfigError, match="schedule"):
        TrainingConfig(model=family, pipeline_schedule="rolling")


def test_pipelined_decoding_is_refused():
    """tests/test_gpt.py test_pipelined_decode_rejected: prefill, decode
    and the paged forward of a pipelined model raise."""
    from kubeflow_tpu_torch.models.gpt import PagedState, make_paged_pool

    model = get_model("gpt_tiny", device="cpu", dtype=torch.float32,
                      pipeline_stages=2)
    ids = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="pipelined decoding"):
        model.prefill(ids)
    flat = get_model("gpt_tiny", device="cpu", dtype=torch.float32)
    _, cache = flat.prefill(ids)
    with pytest.raises(ValueError, match="pipelined decoding"):
        model.decode(ids[:, :1], cache)
    pool = make_paged_pool(model.cfg, 4, 8, "cpu")
    paged = PagedState(torch.zeros((1, 2), dtype=torch.int32),
                       torch.zeros((1,), dtype=torch.int32))
    with pytest.raises(ValueError, match="pipelined decoding"):
        model.paged_forward(ids[:, :1], pool, paged)


def test_a_model_without_stages_is_refused_on_a_pipeline_axis():
    """tests/test_pipeline.py test_unsupported_model_raises: the factory
    of a model without stages (mlp, resnet) raises TypeError on the
    pipeline kwargs the trainer passes every factory on a pipeline axis
    (the trainer in a gang: tests/test_torch_pipeline_parallel.py), and
    without its gang the trainer asks for the axis's devices; a stage
    model's own forward names the schedule that drives it; pipeline ×
    sequence names its item."""
    from kubeflow_tpu_torch.training.trainer import Trainer

    for name in ("mlp", "resnet18"):
        with pytest.raises(TypeError, match="pipeline_stages"):
            get_model(name, device="cpu", pipeline_stages=2,
                      pipeline_schedule="gpipe")
    cfg = TrainingConfig(model="mlp", global_batch_size=8, steps=1,
                         mesh={"pipeline": 2}, checkpoint={"enabled": False})
    with pytest.raises(ValueError, match="mesh spec needs 2 devices"):
        Trainer(cfg, device="cpu")
    stage = _stage_models("gpt_tiny", 2)[0]
    with pytest.raises(ValueError, match="schedule"):
        stage(torch.zeros((2, 4), dtype=torch.long))
    with pytest.raises(ConfigError, match="A13 item 7"):
        TrainingConfig(model="gpt_tiny", mesh={"pipeline": 2, "sequence": 2})


@pytest.mark.parametrize("name", ["gpt_tiny", "bert_tiny", "gpt_tiny_moe"])
def test_a_stage_holds_world_1s_leaves(name):
    """The seeded init of each stage is world 1's (the layers keep their
    flat names): stage 0 holds the embeddings, the last stage the final
    LayerNorm and the heads, and every leaf lands on exactly one stage."""
    whole = get_model(name, device="cpu", dtype=torch.float32, seed=4,
                      num_layers=4)
    sd = whole.state_dict()
    parts = _stage_models(name, 2, seed=4, num_layers=4)
    seen = set()
    for s, p in enumerate(parts):
        for k, v in p.state_dict().items():
            torch.testing.assert_close(v, sd[k], rtol=0, atol=0)
            assert k not in seen
            seen.add(k)
        layers = {int(k.split(".")[1]) for k in p.state_dict()
                  if k.startswith("layers.")}
        assert layers == {2 * s, 2 * s + 1}
        tops = {k.split(".")[0] for k in p.state_dict()} - {"layers"}
        assert tops == set(p.FIRST_STAGE if s == 0 else p.LAST_STAGE)
    assert seen == set(sd)


def test_the_bridge_carries_the_stacked_layout_both_ways():
    """params_to_jax(StageLayout) is the JAX pipelined tree's keys and
    shapes; params_from_jax reads it back bit for bit; a whole [S, ...]
    leaf loads into a stage's layers."""
    name, stages, layers = "gpt_tiny", 2, 4
    params, _, _, _ = _jax_pipelined(name, stages, layers)
    model = get_model(name, device="cpu", dtype=torch.float32,
                      pipeline_stages=stages, num_layers=layers)
    load_jax_params(model, params)
    layout = stage_layout(model)
    assert layout == StageLayout("decoder", stages, layers // stages)
    flat = params_to_jax(model.state_dict(), layout)
    want = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(params)}
    assert {k: v.shape for k, v in flat.items()} == \
        {k: v.shape for k, v in want.items()}
    for k, v in want.items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)
    back = params_from_jax(flat)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)
    assert layout.path("layers.3.attention.query.kernel") == (
        "decoder/stages/layer_1/attention/query/kernel", 1)
    assert layout.path("head.kernel") == ("head/kernel", None)


def test_the_stage_axis_is_annotated_on_a_stages_layers():
    """The leading "stage" axis of every stacked leaf maps to `pipeline`
    (tests/test_pipeline.py's sharding plan); the owned leaves stay
    replicated."""
    parts = _stage_models("bert_tiny_moe", 2)
    sizes = {"data": 1, "fsdp": 1, "pipeline": 2, "expert": 2,
             "sequence": 1, "tensor": 1}
    for p in parts:
        axes = logical_axes_for(p, mesh_axis_sizes=sizes)
        specs = param_specs(axes, mesh=sizes)
        for name, spec in specs.items():
            if name.startswith("layers."):
                assert axes[name][0] == "stage", name
                assert spec[0] == "pipeline", name
                if name.endswith(("moe.wi", "moe.wo")):
                    assert spec[:2] == ("pipeline", "expert"), name
            else:
                assert all(a is None for a in spec), name


@pytest.mark.parametrize("name,count", [("gpt_tiny", lm_train_flops),
                                        ("bert_tiny", encoder_train_flops),
                                        ("gpt_tiny_moe", lm_train_flops)])
def test_the_stages_flops_sum_to_world_1s(name, count):
    cfg = get_model(name, device="meta", num_layers=4,
                    pipeline_stages=4).cfg
    flat = get_model(name, device="meta", num_layers=4).cfg
    parts = [rank_train_flops(count, cfg, 8, 32, stage=s, stages=4)
             for s in range(4)]
    assert math.isclose(sum(parts), count(flat, 8, 32), rel_tol=1e-12)
    assert parts[0] == parts[1] == parts[2] < parts[3]


def test_pipelined_dropout_draws_world_1s_masks():
    """The in-process pipelined forward draws each microbatch's rows of
    the masks the unpipelined forward draws from the same generator (the
    generator replayed a microbatch), so both give the same bits, remat
    on or off; inside a data-parallel rank's `dropout_rows` too."""
    kw = dict(device="cpu", dtype=torch.float32, num_layers=4,
              dropout_rate=0.2, seed=3)
    ids = torch.randint(0, 512, (8, 16), generator=torch.Generator()
                        .manual_seed(1))
    for remat in (False, True):
        flat = get_model("gpt_tiny", remat=remat, **kw).trainable()
        piped = get_model("gpt_tiny", remat=remat, pipeline_stages=2,
                          num_microbatches=4, **kw).trainable()
        outs = []
        for m in (flat, piped):
            gen = torch.Generator().manual_seed(9)
            outs.append(m(ids, dropout_generator=gen))
        torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=0)
        # a rank holding rows 2..5 of a 16-row batch
        with dropout_rows(2, 16):
            a = flat(ids[:4], dropout_generator=torch.Generator()
                     .manual_seed(9))
            b = piped(ids[:4], dropout_generator=torch.Generator()
                      .manual_seed(9))
        torch.testing.assert_close(b, a, rtol=0, atol=0)


def test_a_remat_recompute_on_another_thread_replays_the_rows():
    """A CUDA backward recomputes on autograd's device thread, where the
    step's `dropout_rows` context is not set: remat carries the rows on
    the call, so a backward on a fresh thread gives the gradients of one
    inside the context."""
    kw = dict(device="cpu", dtype=torch.float32, dropout_rate=0.3, seed=5,
              remat=True)
    ids = torch.randint(0, 512, (2, 16), generator=torch.Generator()
                        .manual_seed(2))
    grads = []
    for inside in (True, False):
        model = get_model("gpt_tiny", **kw).trainable()
        with dropout_rows(2, 8):
            loss = model(ids, dropout_generator=torch.Generator()
                         .manual_seed(4)).square().mean()
            if inside:
                loss.backward()
        if not inside:
            t = threading.Thread(target=loss.backward)
            t.start()
            t.join()
        grads.append([p.grad.clone() for p in model.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_the_pipeline_config_loads_as_it_is():
    """configs/gpt_pipeline_1f1b_v5e16.yaml's training block loads
    unedited (`{data: 4, pipeline: 4}`, 1f1b), and the launcher run as one
    process is refused asking for its gang of 16."""
    import yaml

    from kubeflow_tpu_torch.runtime import launcher

    path = os.path.join(REPO, "configs", "gpt_pipeline_1f1b_v5e16.yaml")
    with open(path) as f:
        spec = yaml.safe_load(f)
    cfg = TrainingConfig.from_dict(spec["training"])
    assert (cfg.mesh.data, cfg.mesh.pipeline) == (4, 4)
    assert cfg.pipeline_schedule == "1f1b" and cfg.mesh.num_devices == 16
    assert launcher.load_spec(path)["pipeline_schedule"] == "1f1b"
    with pytest.raises(ValueError, match="needs 16 devices"):
        launcher.run(path, device="cpu")
