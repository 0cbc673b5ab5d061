"""The port's BERT (kubeflow_tpu_torch/models/bert.py), dropout
(models/layers.py), the "auto" attention policy (ops/attention.py) and
`encoder_train_flops` (observability/mfu.py) against the JAX package on
the CPU: bert_tiny initialised by the JAX module from PRNGKey(0), bridged
through `params_from_jax`, inputs seeded with numpy.

Tolerances: f32 outputs (mlm_logits, nsp_logits, pooled) atol 1e-4
(summation order through two layers and the vocab head; measured
~2e-6). bf16 against the JAX module in bf16: each output within 4e-2 of
the larger of its own largest |value| and 1, about ten bf16 ulps (2^-8
relative each): JAX's own bf16 outputs sit up to 0.017 of that scale
from its f32 ones (the pooled row, ~4 ulps), and the port's bf16
rounds at the same points in other op orders, so the two may sit on
either side (measured up to 0.021). JAX's flash runs as its own
tests run it on the CPU (Pallas in interpret mode), the port's through
its plain version. Dropout cannot follow JAX's threefry stream: it is
held by distribution (a zero fraction within four binomial standard
deviations of the rate), by its scaling and by the port's own
determinism."""

import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.models.registry import get_model as jget_model  # noqa: E402
from kubeflow_tpu_torch.models import get_model  # noqa: E402
from kubeflow_tpu_torch.models.bert import BertConfig  # noqa: E402
from kubeflow_tpu_torch.models.convert import (  # noqa: E402
    jax_path,
    load_jax_params,
    params_from_jax,
    params_to_jax,
)
from kubeflow_tpu_torch.models.layers import dropout  # noqa: E402
from kubeflow_tpu_torch.observability.mfu import (  # noqa: E402
    encoder_train_flops,
)
from kubeflow_tpu_torch.ops.attention import auto_attention_impl  # noqa: E402

ATOL = 1e-4
BF16_REL = 4e-2
B, S, VOCAB = 3, 40, 512
OUTPUTS = ("mlm_logits", "nsp_logits", "pooled")


@pytest.fixture(scope="module")
def jparams():
    jm = jget_model("bert_tiny", dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, S), jnp.int32),
                     deterministic=True)["params"]
    return jax.tree.map(np.asarray, params)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, VOCAB, (B, S)).astype(np.int32)
    types = (np.arange(S)[None] >= rng.integers(1, S, (B, 1))).astype(np.int32)
    return ids, types


def _mask(kind):
    """None, all ones, or ragged rows (each keeps at least one key:
    flash and dense differ only on a row that keeps none)."""
    if kind == "none":
        return None
    mask = np.ones((B, S), np.int32)
    if kind == "ragged":
        mask[1, 25:] = 0
        mask[2, 1:] = 0
    return mask


@functools.lru_cache(maxsize=None)
def _japply(impl, dtype_name):
    jm = jget_model("bert_tiny", dtype=getattr(jnp, dtype_name),
                    attention_impl=impl)
    return jax.jit(functools.partial(jm.apply, deterministic=True))


def _jax_out(params, impl, ids, mask, types, dtype_name="float32"):
    kw = {}
    if mask is not None:
        kw["attention_mask"] = jnp.asarray(mask)
    if types is not None:
        kw["token_type_ids"] = jnp.asarray(types)
    out = _japply(impl, dtype_name)({"params": params}, jnp.asarray(ids), **kw)
    return {k: np.asarray(v.astype(jnp.float32)) for k, v in out.items()}


def _port(params, impl, dtype=torch.float32, **kw):
    model = get_model("bert_tiny", dtype=dtype, attention_impl=impl,
                      device="cpu", **kw)
    load_jax_params(model, params)
    return model


def _port_out(model, ids, mask, types):
    with torch.no_grad():
        out = model(
            torch.from_numpy(ids).long(),
            attention_mask=None if mask is None else torch.from_numpy(mask),
            token_type_ids=None if types is None else torch.from_numpy(
                types).long())
    return {k: v.float().numpy() for k, v in out.items()}


@pytest.mark.parametrize("with_types", [False, True])
@pytest.mark.parametrize("mask_kind", ["none", "ones", "ragged"])
@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_forward_matches_jax(jparams, impl, mask_kind, with_types):
    ids, types = _inputs()
    types = types if with_types else None
    mask = _mask(mask_kind)
    want = _jax_out(jparams, impl, ids, mask, types)
    got = _port_out(_port(jparams, impl), ids, mask, types)
    assert got["mlm_logits"].shape == (B, S, VOCAB)
    assert got["nsp_logits"].shape == (B, 2) and got["pooled"].shape == (B, 64)
    for key in OUTPUTS:
        np.testing.assert_allclose(got[key], want[key], atol=ATOL, rtol=0,
                                   err_msg=key)


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_bf16_forward_within_its_bound(jparams, impl):
    """bf16 compute (f32 weights at rest) against the JAX module in bf16,
    ragged mask and segments."""
    ids, types = _inputs(1)
    mask = _mask("ragged")
    want = _jax_out(jparams, impl, ids, mask, types, "bfloat16")
    model = _port(jparams, impl, dtype=torch.bfloat16)
    got = _port_out(model, ids, mask, types)
    for key in OUTPUTS:
        scale = max(float(np.abs(want[key]).max()), 1.0)
        err = float(np.abs(got[key] - want[key]).max())
        assert err <= BF16_REL * scale, (key, err, scale)
    with torch.no_grad():
        out = model(torch.from_numpy(ids).long())
    assert out["pooled"].dtype == torch.bfloat16
    assert out["mlm_logits"].dtype == out["nsp_logits"].dtype == torch.float32


def test_bert_base_names_and_shapes_match_the_jax_init():
    jm = jget_model("bert_base")
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
                        deterministic=True))["params"]
    want = {"/".join(str(k.key) for k in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    model = get_model("bert_base", device="meta")
    got = {jax_path(n): tuple(p.shape) for n, p in model.named_parameters()}
    assert got == want
    assert got["layer_11/attention/query/kernel"] == (768, 12, 64)
    assert got["layer_0/attention/out/kernel"] == (12, 64, 768)
    assert got["mlm_out/kernel"] == (768, 30522)


def test_params_round_trip_through_the_flax_names(jparams):
    model = _port(jparams, "dense")
    flat = params_to_jax(model.state_dict())
    assert "layer_1/mlp/wo/kernel" in flat and "seg_emb/embedding" in flat
    back = params_from_jax(flat)
    for name, t in model.state_dict().items():
        torch.testing.assert_close(back[name], t, atol=0, rtol=0)


@pytest.mark.parametrize("name", ["bert_base", "bert_large", "bert_tiny"])
def test_presets_match_the_reference_configs(name):
    want = jget_model(name).cfg
    got = get_model(name, device="meta").cfg
    for field in ("vocab_size", "hidden_size", "num_layers", "num_heads",
                  "mlp_dim", "max_len", "type_vocab_size", "dropout_rate",
                  "attention_impl"):
        assert getattr(got, field) == getattr(want, field), field


def test_seeded_init_follows_flaxs_distributions():
    model = get_model("bert_base", device="cpu", seed=3)
    p = dict(model.named_parameters())
    # lecun normal: truncated at 2 sigma of N(0, 1/fan_in) / 0.8796
    for name, fan_in in (("layers.0.mlp.wi.kernel", 768),
                         ("layers.0.mlp.wo.kernel", 3072),
                         ("layers.0.attention.out.kernel", 768)):
        w = p[name].detach()
        std = math.sqrt(1 / fan_in)
        assert abs(w.std().item() / std - 1) < 0.02, name
        assert w.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-6
    emb = p["tok_emb.embedding"].detach()
    assert abs(emb.std().item() * math.sqrt(768) - 1) < 0.02
    assert p["ln_emb.scale"].eq(1).all() and p["pooler.bias"].eq(0).all()
    again = get_model("bert_base", device="cpu", seed=3)
    torch.testing.assert_close(again.state_dict(), model.state_dict(),
                               atol=0, rtol=0)


@pytest.mark.parametrize("bad", [
    dict(attention_impl="ring"), dict(attention_impl="ulysses"),
    dict(pipeline_stages=2), dict(pipeline_schedule="1f1b")])
def test_unported_options_raise_naming_roadmap(bad):
    """Ring and ulysses attention (parallel/) and the pipeline knobs
    (`PipelinedEncoder`'s, parallel/pipeline.py) are ported, so those
    configs build; an unknown schedule still raises."""
    for name, value in bad.items():
        assert getattr(BertConfig(**bad), name) == value
    with pytest.raises(ValueError, match="schedule"):
        BertConfig(pipeline_schedule="rolling")


def test_bert_needs_cuda_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        get_model("bert_base")
    assert get_model("bert_tiny", device="cpu").device.type == "cpu"


def test_remat_replays_the_dropout_masks(jparams):
    """Under remat each layer runs again in the backward: with dropout on,
    its masks come from the generator's state at the layer, so the
    gradients equal the plain backward's bit for bit."""
    ids, types = _inputs(2)
    grads = []
    for remat in (False, True):
        model = _port(jparams, "dense", dropout_rate=0.1, remat=remat)
        model.trainable()
        gen = torch.Generator().manual_seed(7)
        out = model(torch.from_numpy(ids).long(),
                    token_type_ids=torch.from_numpy(types).long(),
                    dropout_generator=gen)
        (out["mlm_logits"].square().mean()
         + out["nsp_logits"].square().mean()).backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    for name in grads[0]:
        torch.testing.assert_close(grads[1][name], grads[0][name], atol=0,
                                   rtol=0, msg=name)


@pytest.mark.parametrize("num", [2, 16, 17])
def test_embedding_gradients_are_the_lookups(num):
    """A small table (BERT's segments) sums its rows' gradients by masked
    reductions, a larger one by F.embedding's backward: both are the
    lookup's gradient, and the forward is the lookup's bits."""
    from kubeflow_tpu_torch.models.layers import Embed

    g = torch.Generator().manual_seed(num)
    emb = Embed(num, 8, torch.bfloat16)
    with torch.no_grad():
        emb.embedding.copy_(torch.randn(num, 8, generator=g))
    ids = torch.randint(0, num, (4, 300), generator=g)
    ids[0] = 0  # one row looked up hundreds of times
    up = torch.randn(4, 300, 8, generator=g)
    out = emb(ids)
    (out.float() * up).sum().backward()
    table = emb.embedding.detach().clone().requires_grad_()
    want = torch.nn.functional.embedding(ids, table).to(torch.bfloat16)
    (want.float() * up).sum().backward()
    torch.testing.assert_close(out, want, atol=0, rtol=0)
    torch.testing.assert_close(emb.embedding.grad, table.grad, atol=1e-5,
                               rtol=1e-6)


def _dropout_fraction_bound(n, rate):
    return 4 * math.sqrt(rate * (1 - rate) / n)


def test_dropout_keeps_flaxs_semantics():
    x = torch.randn(200, 500, generator=torch.Generator().manual_seed(0)) + 3.0
    rate = 0.1
    y = dropout(x, rate, torch.Generator().manual_seed(1))
    zero = y == 0
    assert abs(zero.float().mean().item() - rate) <= _dropout_fraction_bound(
        x.numel(), rate)
    torch.testing.assert_close(y[~zero], x[~zero] / (1 - rate), atol=0, rtol=0)
    again = dropout(x, rate, torch.Generator().manual_seed(1))
    torch.testing.assert_close(again, y, atol=0, rtol=0)
    other = dropout(x, rate, torch.Generator().manual_seed(2))
    assert not torch.equal(other == 0, zero)
    assert dropout(x, rate, None, deterministic=True) is x
    assert dropout(x, 0.0, None) is x
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, rate, None)


@pytest.mark.parametrize("family", ["bert_tiny", "gpt_tiny"])
def test_dropout_in_both_families(family):
    """Train mode with a generator drops ~rate of each site's outputs and
    is a function of the generator's seed; eval mode is the model at
    dropout 0."""
    ids = torch.from_numpy(np.random.default_rng(3).integers(
        0, VOCAB, (2, 32))).long()

    def logits(model, gen=None):
        with torch.no_grad():
            out = model(ids, dropout_generator=gen)
        return out["mlm_logits"] if isinstance(out, dict) else out

    plain = get_model(family, dtype=torch.float32, device="cpu")
    model = get_model(family, dtype=torch.float32, device="cpu",
                      dropout_rate=0.1)
    assert model.cfg.dropout_rate == 0.1
    want = logits(plain)
    torch.testing.assert_close(logits(model), want, atol=0, rtol=0)  # eval
    model.trainable()
    a = logits(model, torch.Generator().manual_seed(5))
    b = logits(model, torch.Generator().manual_seed(5))
    c = logits(model, torch.Generator().manual_seed(6))
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not torch.allclose(a, want) and not torch.allclose(a, c)
    with pytest.raises(ValueError, match="Generator"):
        logits(model)


def test_auto_policy_on_the_cpu_and_its_h100_thresholds():
    bf16 = torch.bfloat16
    for causal in (False, True):
        assert auto_attention_impl(32, 512, 12, bf16, causal=causal,
                                   device="cpu") == "dense"
        assert auto_attention_impl(1, 512, 12, bf16, causal=causal,
                                   device="cuda") == "flash"
        assert auto_attention_impl(1, 32768, 12, bf16, causal=causal,
                                   device="cuda") == "flash"
        assert auto_attention_impl(8, 256, 12, bf16, causal=causal,
                                   device="cuda") == "dense"
    # below the measured lengths only the score-memory gate picks flash:
    # 2 x 4096 x 12 x 256² x 2 bytes = 12.9 GB of scores
    assert auto_attention_impl(4096, 256, 12, bf16, device="cuda") == "flash"
    model = get_model("bert_tiny", dtype=torch.float32, device="cpu",
                      attention_impl="auto")
    dense = get_model("bert_tiny", dtype=torch.float32, device="cpu")
    ids, _ = _inputs(4)
    torch.testing.assert_close(_port_out(model, ids, None, None)["mlm_logits"],
                               _port_out(dense, ids, None, None)["mlm_logits"],
                               atol=0, rtol=0)


def test_encoder_train_flops_against_a_hand_count():
    cfg = get_model("bert_base", device="meta").cfg
    b, s = 32, 512
    tokens = b * s
    layer = 4 * 768 * 768 + 2 * 768 * 3072
    matmul = 6 * tokens * (12 * layer + 768 * 768 + 768 * 30522)
    attention = 12 * (12 * b * 12 * s * s * 64)
    assert encoder_train_flops(cfg, b, s) == matmul + attention
    assert encoder_train_flops(cfg, b, s) == pytest.approx(11.639e12, rel=1e-4)
