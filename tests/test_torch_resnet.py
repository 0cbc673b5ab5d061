"""The port's image models (kubeflow_tpu_torch/models/resnet.py, mlp.py)
against the JAX package's flax modules on the CPU, in f32, on the same
weights (carried across by models/convert.py `params_from_jax`).

Every BatchNorm scale and bias and every running average is replaced by
a seeded random value first (a block's zero-initialised last scale by a
small one), so no zero-initialised scale hides a branch.
Tolerances (f32, summation order only): logits within 1e-4 of the
largest |logit|; running averages after a training forward within 1e-5
of the leaf's largest |value|; the loss within rel 1e-5; each gradient
leaf within 1e-4 of its own L2 norm (relative L2).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.models.registry import get_model as jget_model  # noqa: E402
from kubeflow_tpu.training.tasks import cross_entropy as jcross_entropy  # noqa: E402
from kubeflow_tpu_torch.models import get_model  # noqa: E402
from kubeflow_tpu_torch.models.convert import (  # noqa: E402
    is_batch_stat,
    jax_path,
    params_from_jax,
    params_to_jax,
)
from kubeflow_tpu_torch.models.resnet import same_pads  # noqa: E402
from kubeflow_tpu_torch.training.tasks import cross_entropy  # noqa: E402

LOGIT_REL, STAT_REL, LOSS_REL, GRAD_REL = 1e-4, 1e-5, 1e-5, 1e-4
SMOOTHING = 0.1
CLASSES = 10


def _perturb(tree, rng, path=()):
    """BatchNorm scales and biases, and running means and variances,
    replaced by seeded random values (numpy tree)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng, path + (k,))
            continue
        v = np.asarray(v, np.float32)
        if k == "scale" and not v.any():
            # a block's zero-initialised last scale: small, not zero, so
            # the branch is held while the deep stack stays well
            # conditioned (scales near 1 there make the gradients of a
            # 16-block stack explode, and f32 rounding with them)
            v = rng.uniform(0.05, 0.3, v.shape).astype(np.float32)
        elif k in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        elif k in ("bias", "mean") and v.ndim == 1:
            v = rng.normal(0.0, 0.2, v.shape).astype(np.float32)
        out[k] = v
    return out


def _models(name, size, **kw):
    """(flax model, numpy variables, port model) on the same weights."""
    jm = jget_model(name, dtype=jnp.float32, **kw)
    variables = jm.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, size, size, 3)), train=False)
    variables = _perturb(jax.tree.map(np.asarray, dict(variables)),
                         np.random.default_rng(1))
    if "in_features" in kw:
        kw = {k: v for k, v in kw.items() if k != "in_features"}
    port_kw = dict(kw)
    if name == "mlp":
        port_kw["in_features"] = size * size * 3
    pm = get_model(name, dtype=torch.float32, device="cpu", **port_kw)
    pm.load_state_dict(params_from_jax(variables["params"],
                                       variables.get("batch_stats")),
                       strict=True)
    return jm, variables, pm


def _batch(size, n=4, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, size, size, 3), dtype=np.float32),
            rng.integers(0, CLASSES, (n,)).astype(np.int32))


CASES = [("resnet18", 32), ("resnet18", 33), ("resnet50", 32),
         ("resnet50", 33), ("mlp", 8)]


def _kw(name):
    if name == "mlp":
        return dict(hidden=(32, 16), num_classes=CLASSES)
    return dict(num_classes=CLASSES, num_filters=8)


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max(), \
        np.abs(got - want).max()


@pytest.mark.parametrize("name,size", CASES)
def test_eval_logits_equal_the_flax_model(name, size):
    jm, variables, pm = _models(name, size, **_kw(name))
    x, _ = _batch(size)
    want = jm.apply(variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        got = pm(torch.from_numpy(x), train=False)
    assert got.dtype == torch.float32
    _close(got.numpy(), want, LOGIT_REL)


TRAIN_CASES = CASES[:4]


@pytest.mark.parametrize("name,size", TRAIN_CASES)
def test_train_forward_moves_the_running_averages_as_flax(name, size):
    jm, variables, pm = _models(name, size, **_kw(name))
    x, _ = _batch(size, n=6)
    want, updates = jm.apply(variables, jnp.asarray(x), train=True,
                             mutable=["batch_stats"])
    with torch.no_grad():
        got = pm(torch.from_numpy(x), train=True)
    _close(got.numpy(), want, LOGIT_REL)
    stats = {k: v for k, v in params_to_jax(pm.state_dict()).items()
             if is_batch_stat(k)}
    flat = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(updates["batch_stats"])[0]}
    assert len(stats) == len(flat) > 0
    for path, v in stats.items():
        key = "".join(f"['{k}']" for k in path.split("/"))
        _close(v, flat[key], STAT_REL)


@pytest.mark.parametrize("name,size", [("resnet18", 33), ("resnet50", 32),
                                       ("resnet50", 33), ("mlp", 8)])
def test_smoothed_loss_and_every_gradient_equal_jax_grad(name, size):
    jm, variables, pm = _models(name, size, **_kw(name))
    x, y = _batch(size, n=6, seed=3)

    def jloss(params):
        logits, _ = jm.apply({**variables, "params": params}, jnp.asarray(x),
                             train=True, mutable=["batch_stats"])
        return jcross_entropy(logits, jnp.asarray(y),
                              label_smoothing=SMOOTHING)

    want_loss, want_grads = jax.value_and_grad(jloss)(variables["params"])
    pm.trainable()
    loss = cross_entropy(pm(torch.from_numpy(x), train=True),
                         torch.from_numpy(y).long(), label_smoothing=SMOOTHING)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=LOSS_REL)
    want = params_from_jax(jax.tree.map(np.asarray, want_grads))
    names = [n for n, _ in pm.named_parameters()]
    assert sorted(names) == sorted(want)
    for n, p in pm.named_parameters():
        w = want[n].numpy()
        err = np.linalg.norm(p.grad.numpy() - w)
        assert err <= GRAD_REL * max(np.linalg.norm(w), 1e-12), (n, err)


def test_resnet50_full_width_parameter_count_equals_the_jax_model():
    jm = jget_model("resnet50")
    shapes = jax.eval_shape(lambda k, x: jm.init(k, x, train=False),
                            jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3)))
    want = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes["params"]))
    pm = get_model("resnet50", device="meta")
    got = sum(p.numel() for p in pm.parameters())
    assert got == want == 25_557_032
    # every flax leaf has a port leaf of its name and shape
    flat = {jax.tree_util.keystr(p): s.shape for p, s in
            jax.tree_util.tree_flatten_with_path(shapes)[0]}
    for n, t in pm.state_dict().items():
        coll = "batch_stats" if n.rsplit(".", 1)[1] in ("mean", "var") \
            else "params"
        key = f"['{coll}']" + "".join(f"['{k}']" for k in jax_path(n).split("/"))
        assert flat[key] == tuple(t.shape), n


@pytest.mark.parametrize("n,k,s,want", [(224, 7, 2, (2, 3)), (56, 3, 2, (0, 1)),
                                        (112, 3, 2, (0, 1)), (33, 7, 2, (3, 3)),
                                        (17, 3, 2, (1, 1)), (56, 1, 2, (0, 0)),
                                        (56, 3, 1, (1, 1))])
def test_same_padding_is_tfs_rule(n, k, s, want):
    assert same_pads(n, k, s) == want
    # and XLA's own: lax.padtype_to_pads
    assert tuple(jax.lax.padtype_to_pads((n,), (k,), (s,), "SAME")[0]) == want


def test_zero_initialised_last_scale_and_seeded_init():
    a = get_model("resnet18", num_filters=8, device="cpu", seed=3)
    b = get_model("resnet18", num_filters=8, device="cpu", seed=3)
    for (n, p), (_, q) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(p, q), n
    assert not a.ResNetBlock_0.BatchNorm_1.scale.any()
    assert a.ResNetBlock_0.BatchNorm_0.scale.eq(1).all()
    assert a.bn_init.var.eq(1).all() and not a.bn_init.mean.any()
    assert not get_model("resnet50", num_filters=8,
                         device="cpu").BottleneckBlock_3.BatchNorm_2.scale.any()
