"""Ulysses sequence parallelism: head-scatter all-to-all attention (port
of kubeflow_tpu/parallel/ulysses.py).

One all-to-all turns this rank's sequence shard of every head into the
whole sequence of its share of the heads; each rank attends over the
full sequence for those heads, and the inverse all-to-all gives back
its sequence shard (parallel/distributed.py `all_to_all`; each
backward is the other one). The key mask is all-gathered.

Two formulations, the reference's two:
- impl="flash" (the default): the all-to-alls above, each rank's heads
  on the flash kernels or `dense_attention` by the port's H100 "auto"
  policy (`ops/attention.py auto_attention_impl` at the full sequence
  and the rank's heads), or by `local_impl` when given.
- impl="dense": K and V (and the mask) are all-gathered over the ring
  and this rank's queries attend the whole sequence by
  `dense_attention`, the causal triangle at the shard's global offset:
  the numbers of the reference's GSPMD dense path, a query row at a
  time. Heads that do not divide over the ring take this formulation
  with the reference's warning.

Without a sequence axis it is `dense_attention`. In the port each rank
holds its shard, so the sequence always divides the ring; the split of
a global sequence (training/data.py `local_columns`) raises the
reference's message when it does not.
"""

from __future__ import annotations

from typing import Optional

import torch

from kubeflow_tpu_torch.ops.attention import auto_attention_impl, dense_attention
from kubeflow_tpu_torch.ops.flash_attention import flash_attention
from kubeflow_tpu_torch.parallel.distributed import all_gather, all_to_all
from kubeflow_tpu_torch.parallel.mesh import SequenceShard, active_sequence
from kubeflow_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

ULYSSES_IMPLS = ("flash", "dense")


def _flash_or_dense_local(q, k, v, mask, dtype, causal: bool, force=None):
    """Attention over the full sequence for a head subset: the auto
    policy picks the kernel unless `force` ("flash" | "dense") does."""
    b, s, h, _ = q.shape
    impl = force or auto_attention_impl(b, s, h, dtype, causal=causal,
                                        device=q.device)
    if impl == "flash":
        return flash_attention(q, k, v, mask=mask, causal=causal).to(dtype)
    return dense_attention(q, k, v, mask=None if mask is None
                           else mask.bool(), dtype=dtype, causal=causal)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mask: Optional[torch.Tensor] = None,
                      dtype=torch.bfloat16, causal: bool = False,
                      impl: str = "flash", local_impl: Optional[str] = None,
                      shard: Optional[SequenceShard] = None) -> torch.Tensor:
    """Attention over this rank's sequence shard [B, s, H, D] (`mask`
    [B, s], nonzero = attend) with the sequence axis `shard` (default
    the step's `active_sequence()`). causal=True works unchanged on the
    flash formulation: after the all-to-all a rank holds its heads'
    whole sequence."""
    if impl not in ULYSSES_IMPLS:
        raise ValueError(f"unknown ulysses impl {impl!r}; known: "
                         f"{ULYSSES_IMPLS}")
    shard = active_sequence() if shard is None else shard
    if shard is None or shard.size == 1:
        return dense_attention(q, k, v, mask=None if mask is None
                               else mask.bool(), dtype=dtype, causal=causal)
    n, group = shard.size, shard.group
    if q.shape[2] % n and impl == "flash":
        log.warning(
            "ulysses attention: %d heads not divisible by the sequence "
            "mesh axis %d — downgrading impl='flash' to the dense "
            "formulation (K/V gathered over the ring; no flash "
            "kernel). Pick a head count divisible by the sequence "
            "axis to keep the flash path.",
            q.shape[2],
            n,
        )
        impl = "dense"
    full_mask = (None if mask is None
                 else all_gather(mask.to(torch.int32), group, dim=1))
    if impl == "flash":
        # sequence shard -> head shard: split the heads, join the shards
        qh, kh, vh = all_to_all(torch.stack([q, k, v]), group, split_dim=3,
                                concat_dim=2).unbind(0)
        o = _flash_or_dense_local(qh, kh, vh, full_mask, dtype, causal,
                                  force=local_impl)
        # head shard -> sequence shard (the inverse all-to-all)
        return all_to_all(o, group, split_dim=1, concat_dim=2)
    k_all, v_all = all_gather(torch.stack([k, v]), group, dim=2).unbind(0)
    return dense_attention(
        q, k_all, v_all, mask=None if full_mask is None else full_mask.bool(),
        dtype=dtype, causal=causal, q_offset=shard.offset(q.shape[1]))
