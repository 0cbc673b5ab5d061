"""Tiny MLP classifier (port of kubeflow_tpu/models/mlp.py): the
training and serving tests' vehicle, on the same image task and
`ServedModel` path as ResNet.

Leaves keep flax's names and shapes: `dense_<i>/kernel` [in, out] and
`bias` [out] per hidden layer, then `head`. Weights are f32 at rest and
cast to the compute dtype at use, as flax's `Dense(dtype=...)` does; the
head computes in f32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from kubeflow_tpu_torch.models.layers import at_use, draw_value, shard_fsdp
from kubeflow_tpu_torch.models.registry import register_model
from kubeflow_tpu_torch.utils.device import DeviceLike, resolve_device


class Dense(nn.Module):
    """flax Dense: `kernel` [in, out] and `bias` [out], f32 at rest; input,
    kernel and bias are cast to `dtype`, then x @ kernel + bias."""

    def __init__(self, features_in: int, features_out: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(features_in, features_out))
        self.bias = nn.Parameter(torch.empty(features_out))

    def forward(self, x):
        return (x.to(self.dtype)
                @ at_use(self, "kernel", self.dtype).to(self.dtype)
                + self.bias.to(self.dtype))


def init_params(model: nn.Module, seed: int, zero_scales=()) -> None:
    """Seeded init from an explicit CPU torch.Generator (the same weights
    on every device), flax's defaults in distribution: every kernel
    N(0, 1/fan_in) (lecun normal; fan_in is every axis but the last of a
    flax kernel), biases 0, BatchNorm scales 1 (0 for the modules named
    in `zero_scales`), running means 0 and variances 1. An fsdp block
    draws its whole kernel and keeps the block."""
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            owner, _, leaf = name.rpartition(".")
            if leaf == "kernel":
                p.copy_(draw_value(
                    model.get_submodule(owner), leaf, lambda shape: (
                        torch.randn(shape, generator=gen)
                        * math.prod(shape[:-1]) ** -0.5)))
            elif leaf == "scale":
                p.fill_(0.0 if owner in zero_scales else 1.0)
            else:
                p.zero_()
        for name, b in model.named_buffers():
            b.fill_(1.0 if name.endswith(".var") else 0.0)


@dataclasses.dataclass(frozen=True)
class MlpConfig:
    hidden: Tuple[int, ...] = (64, 64)
    num_classes: int = 10
    # the flattened input width (flax infers it at init): 8 * 8 * 3, the
    # image task's default images for mlp
    in_features: int = 192
    dtype: torch.dtype = torch.float32


class Mlp(nn.Module):
    """flatten → (Dense + ReLU) per hidden layer → f32 head. `fsdp` (an
    `FsdpShard`) holds this rank's blocks of the fsdp leaves, each
    gathered at its use (models/layers.py `shard_fsdp`)."""

    def __init__(self, cfg: MlpConfig, *, device: DeviceLike = None,
                 seed: int = 0, fsdp=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.fsdp = None
        widths = (cfg.in_features,) + tuple(cfg.hidden)
        for i, (a, b) in enumerate(zip(widths, widths[1:])):
            self.add_module(f"dense_{i}", Dense(a, b, cfg.dtype))
        self.head = Dense(widths[-1], cfg.num_classes, torch.float32)
        shard_fsdp(self, fsdp)
        if dev.type != "meta":
            self.init_params(seed)
        self.to(dev)
        self.requires_grad_(False)
        self.eval()

    @property
    def device(self) -> torch.device:
        return self.head.kernel.device

    def init_params(self, seed: int) -> None:
        init_params(self, seed)

    def trainable(self) -> "Mlp":
        self.requires_grad_(True)
        self.train()
        return self

    def forward(self, x, train: bool = False):
        x = x.reshape(x.shape[0], -1).to(self.cfg.dtype)
        for i in range(len(self.cfg.hidden)):
            x = F.relu(getattr(self, f"dense_{i}")(x))
        return self.head(x).float()


@register_model("mlp")
def mlp(**kwargs) -> Mlp:
    device = kwargs.pop("device", None)
    seed = kwargs.pop("seed", 0)
    fsdp = kwargs.pop("fsdp", None)
    if "hidden" in kwargs:
        kwargs["hidden"] = tuple(kwargs["hidden"])
    return Mlp(MlpConfig(**kwargs), device=device, seed=seed, fsdp=fsdp)
