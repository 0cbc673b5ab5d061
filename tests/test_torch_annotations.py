"""training/annotations.py `logical_axes_for` over the port's parameter
names against the JAX package's over the flax paths, leaf for leaf, for
gpt_tiny, bert_tiny, the mlp and the port tests' small ResNet, with and
without an fsdp size and a mesh; and a data-only mesh leaves every leaf
replicated (what the data-parallel step assumes)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from kubeflow_tpu.models.registry import get_model as jget_model  # noqa: E402
from kubeflow_tpu.training.annotations import (  # noqa: E402
    logical_axes_for as jlogical_axes_for,
)
from kubeflow_tpu_torch.models import get_model  # noqa: E402
from kubeflow_tpu_torch.models.convert import jax_path  # noqa: E402
from kubeflow_tpu_torch.parallel.sharding import (  # noqa: E402
    is_replicated,
    param_specs,
)
from kubeflow_tpu_torch.training.annotations import logical_axes_for  # noqa: E402

MODELS = {
    "gpt_tiny": ({}, lambda: dict(x=jnp.zeros((1, 8), jnp.int32),
                                  deterministic=True)),
    "bert_tiny": ({}, lambda: dict(x=jnp.zeros((1, 8), jnp.int32),
                                   deterministic=True)),
    "mlp": (dict(hidden=(32, 16), num_classes=10),
            lambda: dict(x=jnp.zeros((1, 8, 8, 3)), train=False)),
    "resnet18": (dict(num_filters=8, num_classes=10),
                 lambda: dict(x=jnp.zeros((1, 32, 32, 3)), train=False)),
}
MESHES = [(1, None), (2, None), (4, {"data": 2, "fsdp": 4}),
          (2, {"data": 1, "fsdp": 2, "tensor": 4}),
          (1, {"data": 8, "tensor": 3})]


def _flat(tree):
    out = {}
    for path, axes in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, tuple))[0]:
        out["/".join(str(p.key) for p in path)] = axes
    return out


@pytest.fixture(scope="module", params=list(MODELS))
def both(request):
    name = request.param
    kw, args = MODELS[name]
    jm = jget_model(name, dtype=jnp.float32, **kw)
    a = args()
    x = a.pop("x")
    shapes = jax.eval_shape(lambda r: jm.init(r, x, **a),
                            jax.random.PRNGKey(0))["params"]
    port_kw = dict(kw)
    if name == "mlp":
        port_kw["in_features"] = 8 * 8 * 3
    model = get_model(name, device="cpu", dtype=torch.float32, **port_kw)
    return name, shapes, model


@pytest.mark.parametrize("fsdp,mesh", MESHES, ids=[str(m) for m in MESHES])
def test_every_leaf_has_the_references_logical_axes(both, fsdp, mesh):
    name, shapes, model = both
    want = _flat(jlogical_axes_for(shapes, fsdp_size=fsdp,
                                   mesh_axis_sizes=mesh))
    got = logical_axes_for(model, fsdp_size=fsdp, mesh_axis_sizes=mesh)
    assert {jax_path(n): ax for n, ax in got.items()} == want
    # BatchNorm's running averages are buffers, not parameters
    assert len(got) == len(list(model.parameters()))


def test_a_data_only_mesh_replicates_every_leaf(both):
    _, _, model = both
    for data in (1, 2, 16):
        sizes = {"data": data, "fsdp": 1, "tensor": 1}
        specs = param_specs(logical_axes_for(model, mesh_axis_sizes=sizes),
                            mesh=sizes)
        assert all(is_replicated(s) for s in specs.values())
    # an fsdp mesh would shard (the next slice's work)
    sizes = {"data": 1, "fsdp": 2}
    specs = param_specs(logical_axes_for(model, fsdp_size=2,
                                         mesh_axis_sizes=sizes), mesh=sizes)
    assert not all(is_replicated(s) for s in specs.values())
