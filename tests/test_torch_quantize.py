"""The port's int8 quantization against the JAX package's: KV vectors
(kubeflow_tpu_torch/ops/attention.py `quantize_kv`/`dequant_kv`) and
weights (kubeflow_tpu_torch/checkpointing/quantize.py), on the session
gpt_tiny (f32, PRNGKey(0)) in the named layout and the scan-stacked one,
with seeded numpy inputs.

Quantized values and scales must equal the JAX package's bit for bit;
so must dequantized weights. Logits of the int8 model against the JAX
model over the same dequantized weights: atol = rtol = 1e-4 (f32
summation order, as tests/test_torch_gpt.py). The accuracy gate holds
the JAX package's pinned thresholds (tests/test_quantize.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.checkpointing import quantize as jq  # noqa: E402
from kubeflow_tpu.models.gpt import (  # noqa: E402
    stack_layer_params,
    unstack_layer_params,
)
from kubeflow_tpu.ops.attention import (  # noqa: E402
    dequant_kv as jdequant_kv,
    quantize_kv as jquantize_kv,
)
from kubeflow_tpu_torch.checkpointing import quantize as tq  # noqa: E402
from kubeflow_tpu_torch.models import get_model  # noqa: E402
from kubeflow_tpu_torch.models.convert import (  # noqa: E402
    load_jax_params,
    params_from_jax,
    quantized_params_from_jax,
)
from kubeflow_tpu_torch.models.gpt import int8_model  # noqa: E402
from kubeflow_tpu_torch.ops.attention import (  # noqa: E402
    dequant_kv,
    quantize_kv,
)

# tests/test_quantize.py's pinned accuracy gate
LOGIT_MAX_ABS_ERR_THRESHOLD = 0.25
LOSS_DELTA_THRESHOLD = 0.02
ATOL = RTOL = 1e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _kv_input():
    """[3, 5, 4, 16] seeded vectors, one all zeros and one holding
    rounding ties: amax 63.5 gives the bf16 scale 0.5 exactly, so 1.25,
    -1.25 and 0.75 sit at x.5 before rounding (half to even: 2, -2, 2).
    Every tie value is exact in bf16 too."""
    x = np.random.default_rng(0).standard_normal((3, 5, 4, 16)) * 3.0
    x[0, 1, 2] = 0.0
    x[1, 2, 3] = 0.0
    x[1, 2, 3, :4] = [63.5, 1.25, -1.25, 0.75]
    return x.astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_is_bitwise_the_jax_package(dtype):
    x = _kv_input()
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jv, js = jquantize_kv(jx)
    tv, ts = quantize_kv(tx)
    assert tv.dtype == torch.int8 and ts.dtype == torch.bfloat16
    assert ts.shape == (3, 5, 4, 1)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.float().numpy(),
                                  np.asarray(js).astype(np.float32))
    # the zero vector quantizes to zeros at scale 0; the ties round to even
    assert not tv[0, 1, 2].any() and float(ts[0, 1, 2]) == 0.0
    assert float(ts[1, 2, 3]) == 0.5
    assert tv[1, 2, 3, :4].tolist() == [127, 2, -2, 2]
    want = np.asarray(jdequant_kv(jv, js, jnp.dtype(dtype))).astype(np.float32)
    got = dequant_kv(tv, ts, getattr(torch, dtype)).float().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def envelopes(gpt_and_params):
    """The JAX envelope of gpt_tiny in both layouts and the port's
    envelope of the bridged state dict."""
    jmodel, params = gpt_and_params
    n = jmodel.cfg.num_layers
    stacked = stack_layer_params(params, n)
    return {
        "named": (params, jq.quantize_params_int8(params)),
        "stacked": (stacked, jq.quantize_params_int8(stacked)),
        "port": tq.quantize_params_int8(params_from_jax(_np(params))),
    }


def _assert_envelopes_equal(got, want):
    assert set(got["qvalues"]) == set(want["qvalues"])
    assert set(got["qscales"]) == set(want["qscales"])
    for name, t in want["qvalues"].items():
        assert got["qvalues"][name].dtype == t.dtype, name
        torch.testing.assert_close(got["qvalues"][name], t, atol=0, rtol=0)
    for name, t in want["qscales"].items():
        torch.testing.assert_close(got["qscales"][name], t, atol=0, rtol=0)


def test_quantize_params_int8_is_bitwise_the_jax_package(envelopes):
    """Named layout: the port quantizing the bridged state dict gives the
    JAX envelope carried across the bridge, bit for bit."""
    bridged = quantized_params_from_jax(_np(envelopes["named"][1]))
    port = envelopes["port"]
    _assert_envelopes_equal(port, bridged)
    scales = port["qscales"]
    # q/k/v biases [H, Dh] are 2-D, so quantized; 1-D leaves are not
    assert scales["layers.0.attention.query.bias"].shape == (16,)
    assert scales["layers.1.attention.value.bias"].shape == (16,)
    assert scales["layers.0.attention.query.kernel"].shape == (16,)
    assert scales["layers.0.attention.out.kernel"].shape == (64,)
    assert {"tok_emb.embedding", "pos_emb.embedding", "head.kernel"} <= set(scales)
    for name in ("layers.0.attention.out.bias", "layers.0.mlp_wi.bias",
                 "layers.0.ln_att.scale", "ln_final.bias"):
        assert name not in scales
        assert port["qvalues"][name].dtype == torch.float32
    assert tq.is_quantized_params(port)
    assert not tq.is_quantized_params(port["qvalues"])


def test_scan_stacked_envelope_shares_each_scale_across_layers(envelopes):
    """In the stacked layout JAX reduces over the layer axis too (and
    quantizes the now 2-D LayerNorm and bias leaves): every layer's
    entry carries the one shared scale, and the values cross unchanged."""
    _, jenv = envelopes["stacked"]
    bridged = quantized_params_from_jax(_np(jenv))
    jscales = {k: np.asarray(v) for k, v in jenv["qscales"].items()}
    shared = jscales["['layers']['block']['attention']['query']['kernel']"]
    for i in range(2):
        np.testing.assert_array_equal(
            bridged["qscales"][f"layers.{i}.attention.query.kernel"].numpy(),
            shared,
        )
    assert "layers.0.ln_att.scale" in bridged["qscales"]
    values = np.asarray(jenv["qvalues"]["layers"]["block"]["mlp_wi"]["kernel"])
    np.testing.assert_array_equal(
        bridged["qvalues"]["layers.1.mlp_wi.kernel"].numpy(), values[1]
    )
    assert set(bridged["qvalues"]) == set(envelopes["port"]["qvalues"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["named", "stacked"])
def test_dequantize_params_is_bitwise_the_jax_package(envelopes, layout,
                                                      dtype):
    _, jenv = envelopes[layout]
    want = params_from_jax(_np(jax.tree.map(
        lambda a: a.astype(jnp.float32),
        jq.dequantize_params(jenv, jnp.dtype(dtype)),
    )))
    got = tq.dequantize_params(quantized_params_from_jax(_np(jenv)),
                               getattr(torch, dtype))
    assert set(got) == set(want)
    for name, t in want.items():
        torch.testing.assert_close(got[name].float(), t, atol=0, rtol=0,
                                   msg=name)


@pytest.mark.parametrize("layout", ["named", "stacked"])
def test_int8_model_logits_match_jax_over_dequantized_weights(
        gpt_and_params, envelopes, layout):
    """The int8 model (int8 buffers, dequantized at each use) built from
    the bridged JAX envelope against the JAX model applied to the JAX
    package's own dequantized tree."""
    jmodel, _ = gpt_and_params
    n = jmodel.cfg.num_layers
    _, jenv = envelopes[layout]
    deq = jq.dequantize_params(jenv, jnp.float32)
    if layout == "stacked":
        deq = unstack_layer_params(deq, n)
    ids = np.random.default_rng(4).integers(0, 512, (2, 12)).astype(np.int32)
    want = np.asarray(jax.jit(jmodel.apply)({"params": deq}, jnp.asarray(ids))
                      ["logits"])
    full = get_model("gpt_tiny", dtype=torch.float32, device="cpu")
    qmodel = int8_model(full, quantized_params_from_jax(_np(jenv)))
    assert qmodel.quantize == "int8" and full.quantize == "none"
    assert qmodel.weight_bytes() < full.weight_bytes() / 3
    with torch.inference_mode():
        got = qmodel(torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    # the resident weights are the envelope's int8 values and scales
    env = quantized_params_from_jax(_np(jenv))
    resident = qmodel.state_dict()
    for name, scale in env["qscales"].items():
        assert resident[name].dtype == torch.int8
        torch.testing.assert_close(resident[name], env["qvalues"][name],
                                   atol=0, rtol=0)
        torch.testing.assert_close(resident[name + "_qscale"], scale,
                                   atol=0, rtol=0)


def test_quantization_accuracy_passes_the_pinned_gate(gpt_and_params,
                                                      envelopes):
    """The port's gate on the bridged gpt_tiny, within the JAX package's
    pinned thresholds, and close to the JAX gate's own reading."""
    jmodel, params = gpt_and_params
    ids = np.random.default_rng(5).integers(0, 512, (4, 32)).astype(np.int32)
    jacc = jq.quantization_accuracy(jmodel, params, envelopes["named"][1],
                                    jnp.asarray(ids))
    model = get_model("gpt_tiny", dtype=torch.float32, device="cpu")
    load_jax_params(model, _np(params))
    sd = model.state_dict()
    acc = tq.quantization_accuracy(model, sd, tq.quantize_params_int8(sd),
                                   torch.from_numpy(ids).long())
    assert acc["logit_max_abs_err"] < LOGIT_MAX_ABS_ERR_THRESHOLD
    assert acc["loss_delta"] < LOSS_DELTA_THRESHOLD
    assert acc["logit_max_abs_err"] == pytest.approx(
        jacc["logit_max_abs_err"], abs=1e-4)
    assert acc["loss_delta"] == pytest.approx(jacc["loss_delta"], abs=1e-4)


def test_apply_transform_and_unknown_names():
    sd = {"w": torch.ones(3, 2), "b": torch.ones(2)}
    assert tq.apply_transform(sd, "") is sd
    env = tq.apply_transform(sd, "int8")
    assert tq.is_quantized_params(env) and set(env["qscales"]) == {"w"}
    with pytest.raises(ValueError, match="unknown"):
        tq.apply_transform(sd, "int4")
    q, scale = tq.quantize_leaf_int8(torch.zeros(4, 3))
    assert not q.any() and not scale.any()
