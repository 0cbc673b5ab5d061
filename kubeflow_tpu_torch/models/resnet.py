"""ResNet (port of kubeflow_tpu/models/resnet.py): the tf-cnn benchmark
vehicle, resnet18…152.

The flax model's arithmetic and names, on cuDNN:

- NHWC input [B, H, W, 3]. `x.permute(0, 3, 1, 2)` of a contiguous NHWC
  tensor is already `channels_last`, so activations stay NHWC in memory
  and cuDNN runs its NHWC kernels; each conv weight is made channels_last
  in the one copy that casts it.
- Leaves keep flax's names and shapes: a conv `kernel` is HWIO
  [kh, kw, in, out] (permuted to torch's OIHW at use), a BatchNorm has
  `scale` and `bias` and the buffers `mean` and `var` (flax's
  `batch_stats`), the head is a Dense `kernel` [in, out]. Submodules take
  flax's auto names (`conv_init`, `bn_init`, `BottleneckBlock_<k>` with
  `Conv_<i>`, `BatchNorm_<i>`, `conv_proj`, `norm_proj`, `head`), so the
  param bridge, the checkpoints and SGD's momentum map by name.
- f32 master weights cast to the compute dtype at use; convolutions in
  that dtype; BatchNorm statistics, normalisation and running averages
  in f32 (flax's `force_float32_reductions`), its output cast back; a
  mean pool (f32 accumulation, compute-dtype result, as `jnp.mean` of
  bf16) and an f32 head.
- `padding="SAME"` is TF's rule, which pads the high side more on a
  strided window: total max((ceil(n/s) - 1)·s + k - n, 0), low half
  floored (the 7x7/2 stem on 224 pads (2, 3); the 3x3/2 max pool on 112
  pads (0, 1) with -inf). An uneven pad is an explicit `F.pad`.
- BatchNorm in training normalises by the batch's mean and BIASED
  variance and moves the running averages as flax does: ra = 0.9·ra +
  0.1·batch, the variance biased too (torch's own running update would
  use the unbiased one). A forward with `train=True` updates the buffers
  in place (flax returns them as the mutable `batch_stats`); with
  `train=False` it reads them.
- The last BatchNorm of every block starts with scale 0 (the residual
  branch starts as identity).
- Data parallelism: the JAX BatchNorm under a batch split over
  ("data", "fsdp") reduces its statistics over every rank (GSPMD). Here a
  model given a data group (`sync_batch_stats`) does the same in
  training: each BatchNorm sums x and x² per channel and counts its
  elements in f32, all-reduces the three with a differentiable
  all-reduce (so the backward reduces too) and normalises by the global
  mean and biased variance E[x²] - E[x]² (flax's fast variance); the
  running averages move identically on every rank. Without a group (one
  rank) the path is the single-card one above. `nn.SyncBatchNorm` is not
  used: it refuses CPU tensors, where the gang tests run. On an fsdp
  axis the group is data × fsdp, and a model built with `fsdp=` holds
  its blocks of the kernels the specs split (the convs' fallback dim,
  the head's embed dim), each gathered at its use.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from kubeflow_tpu_torch.models.layers import at_use, shard_fsdp
from kubeflow_tpu_torch.models.mlp import Dense, init_params
from kubeflow_tpu_torch.models.registry import register_model
from kubeflow_tpu_torch.utils.device import DeviceLike, resolve_device

BN_MOMENTUM = 0.9
BN_EPS = 1e-5


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """TF/XLA "SAME" padding of one spatial axis: (low, high)."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, s: int, value: float = 0.0):
    """x [B, C, H, W] padded explicitly where SAME is uneven; returns
    (x, the symmetric padding left to the op)."""
    (ht, hb), (wl, wr) = (same_pads(x.shape[2], k, s),
                          same_pads(x.shape[3], k, s))
    if ht == hb and wl == wr:
        return x, (ht, wl)
    return F.pad(x, (wl, wr, ht, hb), value=value), (0, 0)


class Conv(nn.Module):
    """flax Conv(use_bias=False, padding="SAME"): `kernel` HWIO, f32 at
    rest; input and kernel in `dtype`."""

    def __init__(self, features_in: int, features_out: int,
                 kernel_size: Tuple[int, int], strides: Tuple[int, int],
                 dtype):
        super().__init__()
        self.dtype = dtype
        self.k, self.s = kernel_size[0], strides[0]
        self.kernel = nn.Parameter(
            torch.empty(*kernel_size, features_in, features_out))

    def forward(self, x):
        w = at_use(self, "kernel", self.dtype).permute(3, 2, 0, 1).to(
            dtype=self.dtype, memory_format=torch.channels_last)
        x, pad = _pad_same(x.to(self.dtype), self.k, self.s)
        return F.conv2d(x, w, stride=self.s, padding=pad)


class BatchNorm(nn.Module):
    """flax BatchNorm(momentum=0.9, epsilon=1e-5, dtype=dtype) over the
    channel axis: `scale`, `bias` (f32 parameters), `mean`, `var` (f32
    running averages)."""

    def __init__(self, features: int, dtype):
        super().__init__()
        self.dtype = dtype
        self.scale = nn.Parameter(torch.empty(features))
        self.bias = nn.Parameter(torch.empty(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        # the data-parallel group training statistics reduce over (None:
        # this rank's batch is the whole batch)
        self.group = None

    def _global_forward(self, x):
        """Training under a data group: the global batch's statistics."""
        from kubeflow_tpu_torch.parallel.distributed import all_reduce_sum

        xf = x.float()
        c = xf.shape[1]
        count = xf.new_full((1,), xf.numel() / c)
        stats = all_reduce_sum(torch.cat([
            xf.sum((0, 2, 3)), (xf * xf).sum((0, 2, 3)), count]), self.group)
        n = stats[-1]
        mean = stats[:c] / n
        var = (stats[c:2 * c] / n - mean * mean).clamp_min(0.0)
        shape = (1, c, 1, 1)
        y = ((xf - mean.view(shape)) * torch.rsqrt(var + BN_EPS).view(shape)
             * self.scale.view(shape) + self.bias.view(shape))
        with torch.no_grad():
            self.mean.copy_(BN_MOMENTUM * self.mean
                            + (1.0 - BN_MOMENTUM) * mean)
            self.var.copy_(BN_MOMENTUM * self.var + (1.0 - BN_MOMENTUM) * var)
        return y.to(self.dtype)

    def forward(self, x, train: bool):
        if not train:
            return F.batch_norm(x, self.mean, self.var, self.scale,
                                self.bias, False, 0.0, BN_EPS).to(self.dtype)
        if self.group is not None:
            return self._global_forward(x)
        # the batch's statistics in f32 (the saved mean and 1/sqrt(var +
        # eps) of the op that normalises with them), the variance biased
        y, mean, invstd = torch.native_batch_norm(
            x, self.scale, self.bias, None, None, True, 0.0, BN_EPS)
        with torch.no_grad():
            var = invstd.float().pow(-2) - BN_EPS
            self.mean.copy_(BN_MOMENTUM * self.mean
                            + (1.0 - BN_MOMENTUM) * mean.float())
            self.var.copy_(BN_MOMENTUM * self.var + (1.0 - BN_MOMENTUM) * var)
        return y.to(self.dtype)


def sync_batch_stats(model: nn.Module, group) -> None:
    """Make every BatchNorm of `model` reduce its training statistics over
    `group` (None: back to this rank's batch alone)."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = group


class ResNetBlock(nn.Module):
    """Two 3x3 convs (the ResNet-18/34 basic block)."""

    expansion = 1

    def __init__(self, features_in: int, filters: int, strides: int, dtype):
        super().__init__()
        self.Conv_0 = Conv(features_in, filters, (3, 3), (strides,) * 2,
                           dtype)
        self.BatchNorm_0 = BatchNorm(filters, dtype)
        self.Conv_1 = Conv(filters, filters, (3, 3), (1, 1), dtype)
        self.BatchNorm_1 = BatchNorm(filters, dtype)
        self.last_norm = "BatchNorm_1"
        self._proj(features_in, filters, strides, dtype)

    def _proj(self, features_in, features_out, strides, dtype):
        # the shortcut projects when the residual's shape changes
        self.has_proj = features_in != features_out or strides != 1
        if self.has_proj:
            self.conv_proj = Conv(features_in, features_out, (1, 1),
                                  (strides,) * 2, dtype)
            self.norm_proj = BatchNorm(features_out, dtype)

    def _shortcut(self, x, train):
        if not self.has_proj:
            return x
        return self.norm_proj(self.conv_proj(x), train)

    def forward(self, x, train: bool):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = self.BatchNorm_1(self.Conv_1(y), train)
        return F.relu(self._shortcut(x, train) + y)


class BottleneckBlock(ResNetBlock):
    """1x1 → 3x3 → 1x1 bottleneck with a projection shortcut."""

    expansion = 4

    def __init__(self, features_in: int, filters: int, strides: int, dtype):
        nn.Module.__init__(self)
        self.Conv_0 = Conv(features_in, filters, (1, 1), (1, 1), dtype)
        self.BatchNorm_0 = BatchNorm(filters, dtype)
        self.Conv_1 = Conv(filters, filters, (3, 3), (strides,) * 2, dtype)
        self.BatchNorm_1 = BatchNorm(filters, dtype)
        self.Conv_2 = Conv(filters, filters * 4, (1, 1), (1, 1), dtype)
        self.BatchNorm_2 = BatchNorm(filters * 4, dtype)
        self.last_norm = "BatchNorm_2"
        self._proj(features_in, filters * 4, strides, dtype)

    def forward(self, x, train: bool):
        y = F.relu(self.BatchNorm_0(self.Conv_0(x), train))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y), train))
        y = self.BatchNorm_2(self.Conv_2(y), train)
        return F.relu(self._shortcut(x, train) + y)


BLOCKS = {"basic": ResNetBlock, "bottleneck": BottleneckBlock}


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Tuple[int, ...]
    block: str  # "basic" | "bottleneck"
    num_classes: int = 1000
    num_filters: int = 64
    dtype: torch.dtype = torch.bfloat16


class ResNet(nn.Module):
    """conv_init 7x7/2 → bn_init → ReLU → max pool 3x3/2 → the stages →
    mean pool → f32 head. `forward(x [B, H, W, 3], train)` → f32 logits."""

    def __init__(self, cfg: ResNetConfig, *, device: DeviceLike = None,
                 seed: int = 0, fsdp=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.fsdp = None
        block_cls = BLOCKS[cfg.block]
        f = cfg.num_filters
        self.conv_init = Conv(3, f, (7, 7), (2, 2), cfg.dtype)
        self.bn_init = BatchNorm(f, cfg.dtype)
        self.block_names = []
        width = f
        for i, count in enumerate(cfg.stage_sizes):
            for j in range(count):
                name = f"{block_cls.__name__}_{len(self.block_names)}"
                block = block_cls(width, f * 2 ** i,
                                  2 if i > 0 and j == 0 else 1, cfg.dtype)
                self.add_module(name, block)
                self.block_names.append(name)
                width = f * 2 ** i * block_cls.expansion
        self.head = Dense(width, cfg.num_classes, torch.float32)
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
        init_params(self, seed, zero_scales={
            f"{n}.{getattr(self, n).last_norm}" for n in self.block_names})

    def trainable(self) -> "ResNet":
        self.requires_grad_(True)
        self.train()
        return self

    def forward(self, x, train: bool = False):
        x = x.to(self.cfg.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.bn_init(self.conv_init(x), train))
        x, pad = _pad_same(x, 3, 2, value=-math.inf)
        x = F.max_pool2d(x, 3, 2, padding=pad)
        for name in self.block_names:
            x = getattr(self, name)(x, train)
        x = x.float().mean((2, 3)).to(self.cfg.dtype)
        return self.head(x).float()


_VARIANTS = {
    "resnet18": dict(stage_sizes=(2, 2, 2, 2), block="basic"),
    "resnet34": dict(stage_sizes=(3, 4, 6, 3), block="basic"),
    "resnet50": dict(stage_sizes=(3, 4, 6, 3), block="bottleneck"),
    "resnet101": dict(stage_sizes=(3, 4, 23, 3), block="bottleneck"),
    "resnet152": dict(stage_sizes=(3, 8, 36, 3), block="bottleneck"),
}


def _make_factory(variant: str):
    def factory(**kwargs):
        device = kwargs.pop("device", None)
        seed = kwargs.pop("seed", 0)
        fsdp = kwargs.pop("fsdp", None)
        cfg = ResNetConfig(**{**_VARIANTS[variant], **kwargs})
        return ResNet(cfg, device=device, seed=seed, fsdp=fsdp)

    factory.__name__ = variant
    return factory


for _name in _VARIANTS:
    register_model(_name)(_make_factory(_name))
