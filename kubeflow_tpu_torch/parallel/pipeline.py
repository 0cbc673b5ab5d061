"""Pipeline parallelism (port of kubeflow_tpu/parallel/pipeline.py and of
the schedule in kubeflow_tpu/models/layers.py `pipeline_scan`).

The JAX package runs a pipeline as one SPMD program: every stage's
layers are stacked [S, ...] and sharded over the `pipeline` mesh axis,
and a [S, mb, ...] state buffer moves one stage down a tick
(`jnp.roll`, a CollectivePermute). Here a pipeline rank is a stage: it
holds only its run of layers (models/gpt.py, models/bert.py, built for
this rank's `PipelineShard`), and the training step drives the
microbatches through the ranks with explicit sends and receives between
neighbours (`run_schedule`, called by training/trainer.py).

- **GPipe:** every microbatch's forward, then every backward (live
  activations: all M microbatches on every stage).
- **1F1B:** stage s runs S − 1 − s warm-up forwards, then alternates
  one forward and one backward, then drains the remaining backwards. At
  most S − s microbatches' activations are live on stage s, whatever M.
  The JAX package bounds the same set by a segmented remat scan; the
  bubble, (S − 1) / (M + S − 1), is the same for both schedules.

A stage's backward of microbatch m runs in microbatch order under both
schedules, so the gradients accumulate in the same order and the two
schedules give the same bits. Activations and their gradients cross
between neighbours in the model's compute dtype (the JAX package casts
at the roll). A send is paired with the receive that the neighbour posts
at the same point of its schedule (1F1B's steady state posts "send
forward, receive backward" and "send backward, receive forward" as one
`batch_isend_irecv` each, so no pair of ranks waits on each other). On a
gloo group a CUDA tensor is staged through host memory
(parallel/distributed.py `_staged`). A failed transfer raises: there is
no fallback.

`microbatch`, `unmicrobatch`, `pipeline_stage_slices` and
`clamp_microbatches` are the JAX package's helpers.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import torch

SCHEDULES = ("gpipe", "1f1b")


def check_schedule(schedule: str) -> str:
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {schedule!r}; known: "
                         f"{SCHEDULES}")
    return schedule


def microbatch(x: torch.Tensor, num_microbatches: int) -> torch.Tensor:
    """[B, ...] -> [M, B/M, ...] (leading-dim split, order preserving)."""
    b = x.shape[0]
    if b % num_microbatches:
        raise ValueError(
            f"batch {b} not divisible into {num_microbatches} microbatches")
    return x.reshape((num_microbatches, b // num_microbatches)
                     + tuple(x.shape[1:]))


def unmicrobatch(x_mb: torch.Tensor) -> torch.Tensor:
    """[M, mb, ...] -> [B, ...]."""
    return x_mb.reshape((x_mb.shape[0] * x_mb.shape[1],)
                        + tuple(x_mb.shape[2:]))


def pipeline_stage_slices(num_layers: int, num_stages: int
                          ) -> Tuple[int, int]:
    """Validate and return (layers_per_stage, num_stages)."""
    if num_stages < 1 or num_layers % num_stages:
        raise ValueError(
            f"{num_layers} layers not divisible into {num_stages} stages")
    return num_layers // num_stages, num_stages


def clamp_microbatches(num_microbatches: int, num_stages: int,
                       batch: int) -> int:
    """Largest feasible microbatch count <= the requested one (0 asks for
    one a stage)."""
    m = min(num_microbatches or num_stages, batch)
    while batch % m:
        m -= 1
    return m


def warmup_forwards(schedule: str, stage: int, num_stages: int,
                    num_microbatches: int) -> int:
    """Forwards stage `stage` runs before its first backward."""
    if check_schedule(schedule) == "gpipe":
        return num_microbatches
    return min(num_stages - 1 - stage, num_microbatches)


@dataclasses.dataclass
class LiveCounter:
    """Microbatches whose forward has run on this stage and whose
    backward has not (their saved activations): now and at most, and
    the stage's ("F", m) / ("B", m) in the order they ran."""

    live: int = 0
    peak: int = 0
    order: List[Tuple[str, int]] = dataclasses.field(default_factory=list)

    def forward(self, m: int) -> None:
        self.live += 1
        self.peak = max(self.peak, self.live)
        self.order.append(("F", m))

    def backward(self, m: int) -> None:
        self.live -= 1
        self.order.append(("B", m))


def _p2p(sends, recvs, group) -> List[torch.Tensor]:
    """Post every (tensor, peer) send and every (like, peer) receive as
    one `batch_isend_irecv`, wait for all → the received tensors (on
    their `like`'s device and dtype)."""
    from kubeflow_tpu_torch.parallel.distributed import _staged

    dist = torch.distributed
    ops, outs, bufs = [], [], []
    for t, peer in sends:
        src = t.detach().contiguous()
        if _staged(src, group):
            src = src.cpu()
        ops.append(dist.P2POp(dist.isend, src, peer, group))
    for like, peer in recvs:
        staged = _staged(like, group)
        buf = torch.empty(like.shape, dtype=like.dtype,
                          device="cpu" if staged else like.device)
        ops.append(dist.P2POp(dist.irecv, buf, peer, group))
        bufs.append((buf, like.device, staged))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    for buf, device, staged in bufs:
        outs.append(buf.to(device) if staged else buf)
    return outs


def run_schedule(pipe, schedule: str, num_microbatches: int,
                 forward: Callable[[int, Optional[torch.Tensor]],
                                   Optional[torch.Tensor]],
                 backward: Callable[[int, Optional[torch.Tensor]],
                                    Optional[torch.Tensor]],
                 like: torch.Tensor) -> LiveCounter:
    """Run one stage's part of a pipelined forward and backward over
    `num_microbatches` microbatches (the Megatron form of both schedules).

    `pipe` is this rank's `PipelineShard` (parallel/mesh.py).
    `forward(m, x)` runs microbatch m through this stage: `x` is the
    previous stage's output (None on stage 0) and it returns what the
    next stage receives (None on the last). `backward(m, g)` runs its
    backward: `g` is the gradient of what the forward returned (None on
    the last stage, whose forward kept its own loss) and it returns the
    gradient of `x` (None on stage 0). `like` has the shape, dtype and
    device of every activation that crosses (one microbatch's). Returns
    the stage's live-activation counter."""
    s, n, m = pipe.rank, pipe.size, num_microbatches
    first, last = pipe.first, pipe.last
    group = pipe.group
    w = warmup_forwards(schedule, s, n, m)
    live = LiveCounter()

    def recv_forward():
        return None if first else _p2p([], [(like, pipe.prev)], group)[0]

    def recv_backward():
        return None if last else _p2p([], [(like, pipe.next)], group)[0]

    def send_forward(y):
        if not last:
            _p2p([(y, pipe.next)], [], group)

    def send_backward(dx):
        if not first:
            _p2p([(dx, pipe.prev)], [], group)

    f = b = 0

    def fwd(x):
        nonlocal f
        y = forward(f, x)
        live.forward(f)
        f += 1
        return y

    def bwd(g):
        nonlocal b
        dx = backward(b, g)
        live.backward(b)
        b += 1
        return dx

    for _ in range(w):
        send_forward(fwd(recv_forward()))
    steady = m - w
    x = recv_forward() if steady else None
    for k in range(steady):
        y = fwd(x)
        # send this output, receive the oldest live microbatch's gradient
        g = None if last else _p2p([(y, pipe.next)],
                                   [(like, pipe.next)], group)[0]
        dx = bwd(g)
        if k == steady - 1:
            send_backward(dx)
        elif first:
            x = None
        else:
            # send that gradient back, receive the next microbatch
            x = _p2p([(dx, pipe.prev)], [(like, pipe.prev)], group)[0]
    for _ in range(w):
        send_backward(bwd(recv_backward()))
    return live


def run_forward(pipe, forward: Callable[[Optional[torch.Tensor]],
                                        Optional[torch.Tensor]],
                like: torch.Tensor) -> None:
    """A forward-only pass (eval): one batch through this stage, received
    from the previous stage (None on stage 0) and sent to the next."""
    x = None if pipe.first else _p2p([], [(like, pipe.prev)], pipe.group)[0]
    y = forward(x)
    if not pipe.last:
        _p2p([(y, pipe.next)], [], pipe.group)
