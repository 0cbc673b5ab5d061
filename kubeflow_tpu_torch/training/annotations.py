"""Parameter logical-axis annotation (port of
kubeflow_tpu/training/annotations.py).

Maps every parameter (by its flax path and rank) to a tuple of logical
axis names, which parallel/sharding.py turns into mesh axes. The pattern
table and the fallback are the JAX package's: a leaf no pattern matches
gets its largest fsdp-divisible dim annotated "embed" (→ the fsdp axis)
when fsdp > 1, and is replicated otherwise. The port's parameter names
are matched in their flax form (models/convert.py `jax_path`:
`layers.0.attention.query.kernel` → `layer_0/attention/query/kernel`),
so both packages annotate every leaf alike.

On a data-only mesh every leaf's spec is replicated (what the
data-parallel trainer assumes). On an expert axis the MoE stacks' specs
put `expert` on dim 0 (the router stays replicated), and on an fsdp axis
a leaf whose spec names `fsdp` is split along that dim
(parallel/sharding.py `fsdp_dim`): the layouts the trainer builds
(training/trainer.py, models/layers.py `shard_fsdp`). A model's leaves
are annotated at their whole shapes: an expert-sharded stack as the
[E, ...] leaf it is a block of, an fsdp block as its whole leaf
(models/layers.py `whole_leaf_shape`). A pipelined model's
layer leaves are annotated as the JAX pipelined tree holds them
(`<prefix>/stages/layer_<j>/...`, models/convert.py `StageLayout`),
stacked [S, ...] with the leading "stage" axis (→ `pipeline`): a
pipeline rank holds its stage's slice.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional, Tuple, Union

import torch

from kubeflow_tpu_torch.models.convert import jax_path

Axes = Tuple[Optional[str], ...]

# (path regex, rank) -> logical axes. Paths are "/"-joined flax param paths.
_PATTERNS: Tuple[Tuple[str, Axes], ...] = (
    # BERT attention: DenseGeneral kernels [embed, heads, head_dim]
    (r".*/(query|key|value)/kernel$", ("embed", "heads", None)),
    (r".*/attention/out/kernel$", ("heads", None, "embed")),
    (r".*/(query|key|value)/bias$", ("heads", None)),
    # BERT MLP
    (r".*/mlp/wi/kernel$", ("embed", "mlp")),
    (r".*/mlp/wo/kernel$", ("mlp", "embed")),
    (r".*/mlp/wi/bias$", ("mlp",)),
    # GPT decoder MLP (models/gpt.py DecoderBlock)
    (r".*/mlp_wi/kernel$", ("embed", "mlp")),
    (r".*/mlp_wo/kernel$", ("mlp", "embed")),
    (r".*/mlp_wi/bias$", ("mlp",)),
    # MoE expert stacks [E, ...]; the router stays replicated
    (r".*/moe/wi$", ("expert", "embed", "mlp")),
    (r".*/moe/wo$", ("expert", "mlp", "embed")),
    (r".*/moe/router$", (None, None)),
    # Embeddings + vocab projections: lookup tables shard along VOCAB over
    # both the tensor and fsdp axes ("vocab_table"), the hidden dim whole
    (r".*/(tok_emb|seg_emb)/embedding$", ("vocab_table", None)),
    (r".*/pos_emb/embedding$", ("vocab_table", None)),
    (r".*/mlm_out/kernel$", ("embed", "vocab")),
    (r".*/mlm_out/bias$", ("vocab",)),
    (r".*/(mlm_transform|pooler)/kernel$", ("embed", "embed2")),
    # Conv kernels [h, w, cin, cout]
    (r".*conv.*/kernel$", (None, None, "conv_in", "conv_out")),
    # Classifier head
    (r".*/head/kernel$", ("embed", "vocab")),
)


def _annotate(path: str, shape: Tuple[int, ...], fsdp_size: int,
              mesh_axis_sizes: Optional[Mapping[str, int]]) -> Axes:
    from kubeflow_tpu_torch.parallel.sharding import LOGICAL_RULES

    def validated(axes, dims):
        if mesh_axis_sizes is None:
            return axes
        out = []
        for dim, ax in zip(dims, axes):
            if ax is None:
                out.append(None)
                continue
            mapped = LOGICAL_RULES.get(ax)
            names = (mapped if isinstance(mapped, tuple)
                     else (mapped,) if mapped else ())
            prod = 1
            for n in names:
                prod *= mesh_axis_sizes.get(n, 1)
            out.append(ax if prod <= 1 or dim % prod == 0 else None)
        return tuple(out)

    # pipeline-stacked ("stages") and scan-stacked ("layers") leaves have
    # a leading stacked dim; match the rest on the table
    slashed = f"/{path}"
    stacked = "/stages/" in slashed
    scanned = "/layers/" in slashed
    ndim = len(shape) - 1 if (stacked or scanned) else len(shape)
    lead: Axes = ("stage",) if stacked else (None,) if scanned else ()
    dims = shape[1:] if (stacked or scanned) else shape
    for pattern, axes in _PATTERNS:
        if re.match(pattern, slashed) and len(axes) == ndim:
            return lead + validated(axes, dims)
    if ndim >= 2 and fsdp_size > 1:
        order = sorted(range(ndim), key=lambda i: dims[i], reverse=True)
        for d in order:
            if dims[d] % fsdp_size == 0:
                return lead + tuple("embed" if i == d else None
                                    for i in range(ndim))
    return lead + tuple(None for _ in range(ndim))


def logical_axes_for(
    params: Union[torch.nn.Module, Mapping[str, torch.Tensor]],
    fsdp_size: int = 1,
    mesh_axis_sizes: Optional[Mapping[str, int]] = None,
) -> Dict[str, Axes]:
    """{parameter name: logical axes} of a model's parameters (or a
    name → tensor mapping), keyed by the port's names.

    With `mesh_axis_sizes`, a dim whose size the mapped mesh axes do not
    divide is degraded to replicated (None) instead of failing sharding,
    as in the JAX package."""
    layout = None
    if isinstance(params, torch.nn.Module):
        from kubeflow_tpu_torch.models.layers import stage_layout

        shapes, layout = whole_shapes(params), stage_layout(params)
    else:
        shapes = {name: tuple(t.shape) for name, t in params.items()}
    return {name: _annotate(jax_path(name) if layout is None
                            else layout.path(name)[0], shape, fsdp_size,
                            mesh_axis_sizes)
            for name, shape in shapes.items()}


def whole_shapes(model: torch.nn.Module) -> Dict[str, Tuple[int, ...]]:
    """{parameter name: its whole shape}: a parameter's own, for an
    expert stack's block the [E, ...] stack's, for an fsdp block its
    whole leaf's, and for a pipelined model's layer leaf the [S, ...]
    stage stack's."""
    from kubeflow_tpu_torch.models.layers import stage_layout, \
        whole_leaf_shape

    layout = stage_layout(model)
    out = {}
    for owner, module in model.named_modules():
        for leaf, _ in module.named_parameters(recurse=False):
            name = f"{owner}.{leaf}" if owner else leaf
            shape = whole_leaf_shape(module, leaf)
            if layout is not None and name.startswith("layers."):
                shape = (layout.stages,) + shape
            out[name] = shape
    return out
