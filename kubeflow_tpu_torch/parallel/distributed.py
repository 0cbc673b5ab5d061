"""Distributed gang wiring (port of kubeflow_tpu/parallel/distributed.py):
the KFT_* env a gang controller renders into every process, and the
in-process bring-up of `torch.distributed` from it.

Every process of a gang needs (coordinator address, number of processes,
process id). `render_gang_env` and `GangEnv` are the JAX package's, so a
controller renders one env for either package. `initialize_from_env`
turns that env into `torch.distributed.init_process_group`: the
rendezvous is `tcp://<KFT_COORDINATOR_ADDRESS>`, the rank
`KFT_PROCESS_ID`, the world size `KFT_NUM_PROCESSES`. The backend
follows the device, as the JAX package picks gloo collectives for the
CPU platform: `nccl` for CUDA, `gloo` for the CPU.

A process without a rendered coordinator runs alone: no group, a no-op
(the JAX package's single-process rule). A rendered gang joins its group
at any size, one process included, so a gang of one runs the same
collectives as a gang of many.

Each process drives one card, `cuda:<local rank>`; the local rank is the
process's position among the gang's processes that share its hostname
(`TPU_WORKER_HOSTNAMES`), so a host that runs four ranks drives four
cards. A rank whose card does not exist raises: it never runs on the CPU
instead.
"""

from __future__ import annotations

import dataclasses
import os
import socket
from datetime import timedelta
from typing import Dict, List, Optional

import torch

from kubeflow_tpu_torch.utils.device import DeviceLike
from kubeflow_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

ENV_COORDINATOR = "KFT_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "KFT_NUM_PROCESSES"
ENV_PROCESS_ID = "KFT_PROCESS_ID"
ENV_SLICE_ID = "KFT_SLICE_ID"
ENV_NUM_SLICES = "KFT_NUM_SLICES"
ENV_WORKER_HOSTNAMES = "TPU_WORKER_HOSTNAMES"
ENV_JOB_NAME = "KFT_JOB_NAME"
DEFAULT_COORDINATOR_PORT = 8476
# how long a rank waits for its peers at the rendezvous and in a collective
DEFAULT_TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class GangEnv:
    """Per-process view of the gang (parsed from env)."""

    job_name: str
    coordinator_address: str
    num_processes: int
    process_id: int
    slice_id: int = 0
    num_slices: int = 1

    @classmethod
    def from_env(cls, environ: Optional[Dict[str, str]] = None) -> "GangEnv":
        env = os.environ if environ is None else environ
        return cls(
            job_name=env.get(ENV_JOB_NAME, "local"),
            coordinator_address=env.get(ENV_COORDINATOR, ""),
            num_processes=int(env.get(ENV_NUM_PROCESSES, "1")),
            process_id=int(env.get(ENV_PROCESS_ID, "0")),
            slice_id=int(env.get(ENV_SLICE_ID, "0")),
            num_slices=int(env.get(ENV_NUM_SLICES, "1")),
        )

    @property
    def is_coordinator(self) -> bool:
        return self.process_id == 0

    @property
    def single_process(self) -> bool:
        return self.num_processes <= 1


def render_gang_env(
    job_name: str,
    hostnames: List[str],
    num_slices: int = 1,
    coordinator_port: int = DEFAULT_COORDINATOR_PORT,
) -> List[Dict[str, str]]:
    """Render the env block for each process of a gang.

    `hostnames[i]` is the stable DNS name of process i. Process 0 is the
    coordinator. Slices are contiguous, hosts_per_slice = len(hostnames)
    / num_slices."""
    n = len(hostnames)
    if n < 1:
        raise ValueError("gang needs at least one host")
    if n % num_slices:
        raise ValueError(f"{n} hosts not divisible into {num_slices} slices")
    hosts_per_slice = n // num_slices
    coord = f"{hostnames[0]}:{coordinator_port}"
    envs = []
    for i, _host in enumerate(hostnames):
        envs.append(
            {
                ENV_JOB_NAME: job_name,
                ENV_COORDINATOR: coord,
                ENV_NUM_PROCESSES: str(n),
                ENV_PROCESS_ID: str(i),
                ENV_SLICE_ID: str(i // hosts_per_slice),
                ENV_NUM_SLICES: str(num_slices),
                ENV_WORKER_HOSTNAMES: ",".join(hostnames),
            }
        )
    return envs


def reserve_port(host: str = "127.0.0.1") -> socket.socket:
    """A coordinator port held for a gang until the returned socket is
    closed: bound with SO_REUSEADDR and never listening. Rank 0's
    TCPStore (which binds with SO_REUSEADDR too) listens on it, while the
    kernel hands it to no other bind(0) or outgoing connection, so no
    other gang's store or gloo socket can take it between the choice and
    the rendezvous. (A port bound to probe it and closed at once can be
    taken in that gap: rank 0 then fails with EADDRINUSE.) The number
    is `sock.getsockname()[1]`."""
    sock = socket.socket()
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind((host, 0))
    return sock


def local_rank(environ: Optional[Dict[str, str]] = None) -> int:
    """This process's position among the gang's processes on its host:
    how many processes before it share its hostname (0 without a
    hostname list)."""
    env = os.environ if environ is None else environ
    gang = GangEnv.from_env(env)
    hosts = [h for h in env.get(ENV_WORKER_HOSTNAMES, "").split(",") if h]
    if gang.process_id >= len(hosts):
        return 0
    return hosts[:gang.process_id].count(hosts[gang.process_id])


def gang_device(device: DeviceLike = None,
                environ: Optional[Dict[str, str]] = None) -> torch.device:
    """The device this rank drives: the CPU when asked for, else
    `cuda:<local rank>`. Raises when that card is not there."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    from kubeflow_tpu_torch.utils.device import local_rank_device

    return local_rank_device(local_rank(environ))


def backend_for(device: torch.device) -> str:
    """The collective backend of a rank on `device`."""
    return "nccl" if device.type == "cuda" else "gloo"


def initialize_from_env(environ: Optional[Dict[str, str]] = None,
                        device: DeviceLike = None,
                        backend: Optional[str] = None) -> GangEnv:
    """In-process entry point: parse GangEnv and join the gang's
    process group. `device` is the rank's device (default the card;
    "cpu" runs the gang on gloo); `backend` overrides the device's
    backend (gloo for ranks that share one card, which NCCL refuses).
    A no-op without a rendered coordinator, and once a group exists."""
    gang = GangEnv.from_env(environ)
    if not gang.coordinator_address:
        log.info("no gang coordinator rendered; running as one process")
        return gang
    if torch.distributed.is_initialized():
        return gang
    dev = gang_device(device, environ)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or backend_for(dev)
    log.info("initializing torch.distributed: coordinator=%s procs=%d id=%d "
             "backend=%s device=%s", gang.coordinator_address,
             gang.num_processes, gang.process_id, backend, dev)
    torch.distributed.init_process_group(
        backend=backend,
        init_method=f"tcp://{gang.coordinator_address}",
        world_size=gang.num_processes,
        rank=gang.process_id,
        timeout=timedelta(seconds=DEFAULT_TIMEOUT_S),
    )
    return gang


def world_size() -> int:
    """Processes in the gang's group (1 without one)."""
    dist = torch.distributed
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank in the gang's group (0 without one)."""
    dist = torch.distributed
    return dist.get_rank() if dist.is_initialized() else 0


def shutdown() -> None:
    """Leave the gang's group (a no-op without one)."""
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group in the forward; the backward sums the
    cotangents over the group too (every rank's loss reads the sum)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        torch.distributed.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        torch.distributed.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable SUM all-reduce of `x` over `group`: a new tensor,
    `x` untouched."""
    return _AllReduceSum.apply(x, group)


# -- the expert axis's pair -------------------------------------------------------
# Every expert rank of a data shard computes the same loss from the same
# rows, so the sum of the group's losses is NOT the loss: `all_reduce_sum`
# (both directions summed) would multiply an expert block's gradient by the
# group's size. A block's partial output enters the replicated stream
# through `reduce_from_group` (summed forward, passed back unchanged), and
# a replicated tensor enters the blocks through `copy_to_group` (passed
# forward unchanged, its cotangent summed back: each rank holds only its
# blocks' share). With `group` None (this process alone) both are the
# identity.


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    if group is None:
        return x
    out = x.contiguous().clone()
    torch.distributed.all_reduce(out, group=group)
    return out


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _summed(grad, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _summed(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_group(x: torch.Tensor, group=None) -> torch.Tensor:
    """`x` unchanged (a view) in the forward; the backward sums its
    cotangent over `group`: a tensor every rank of the group holds whole,
    read by each rank's own share of the work."""
    return _CopyToGroup.apply(x, group)


def reduce_from_group(x: torch.Tensor, group=None) -> torch.Tensor:
    """SUM all-reduce of `x` over `group` in the forward (a new tensor);
    the backward passes the cotangent on unchanged: each rank's partial
    result joins a stream every rank then holds whole."""
    return _ReduceFromGroup.apply(x, group)


# -- the sequence axis's collectives -------------------------------------------
# Differentiable forms of the JAX collectives ring and Ulysses attention
# use (`ppermute`, tiled `all_to_all` and `all_gather`), each over a
# process group (None: the default group). Each backward is the JAX
# transpose: the cotangent goes back the way the value came, so a K/V
# block's gradient reaches the rank that owns the block.
#
# gloo carries host tensors only for these (NCCL refuses two ranks on
# one card, so the ranks of a one-card gang talk over gloo): on a gloo
# group a CUDA tensor is staged through pinned host memory, the
# transport of that backend. The kernels still run on the card.


def _group(group):
    return group if group is not None else torch.distributed.group.WORLD


def _pinned(shape, dtype) -> torch.Tensor:
    """An empty host tensor in pinned memory (torch's caching host
    allocator): a copy to or from the card moves it once, with no pass
    through the CUDA runtime's own staging buffer."""
    return torch.empty(tuple(shape), dtype=dtype, pin_memory=True)


def _to_host(x: torch.Tensor) -> torch.Tensor:
    return _pinned(x.shape, x.dtype).copy_(x)


def _staged(x: torch.Tensor, group) -> bool:
    return (x.device.type == "cuda"
            and torch.distributed.get_backend(group) == "gloo")


def _shift(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """This rank's x to group rank (r + shift) mod n, and rank
    (r − shift) mod n's to here: one `batch_isend_irecv` of a send and a
    receive, so every rank posts the pair in the same order."""
    dist = torch.distributed
    group = _group(group)
    n, r = dist.get_world_size(group), dist.get_rank(group)
    stage = _staged(x, group)
    src = x.detach().contiguous()
    src = _to_host(src) if stage else src
    out = _pinned(src.shape, src.dtype) if stage else torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src, dist.get_global_rank(
               group, (r + shift) % n), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(
               group, (r - shift) % n), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out.to(x.device, non_blocking=True) if stage else out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _shift(x, group, shift)

    @staticmethod
    def backward(ctx, grad):
        return _shift(grad, ctx.group, -ctx.shift), None, None


def ppermute(x: torch.Tensor, group=None, shift: int = 1) -> torch.Tensor:
    """The ring rotation: group rank r's `x` lands on rank (r + shift)
    mod n (the JAX `ppermute` with perm [(j, (j + shift) % n)]); the
    backward sends the cotangent the other way. A new contiguous
    tensor."""
    return _PPermute.apply(x, group, shift)


def _all_to_all(x: torch.Tensor, group, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    dist = torch.distributed
    group = _group(group)
    n = dist.get_world_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(x.shape)} "
                         f"does not split over {n} ranks")
    send = torch.stack(x.detach().chunk(n, split_dim))
    stage = _staged(send, group)
    send = _to_host(send) if stage else send
    recv = (_pinned(send.shape, send.dtype) if stage
            else torch.empty_like(send))
    dist.all_to_all_single(recv, send, group=group)
    recv = recv.to(x.device, non_blocking=True) if stage else recv
    return torch.cat(recv.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, split_dim, concat_dim)
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        group, split_dim, concat_dim = ctx.args
        return _all_to_all(grad, group, concat_dim, split_dim), None, None, None


def all_to_all(x: torch.Tensor, group=None, split_dim: int = 0,
               concat_dim: int = 0) -> torch.Tensor:
    """The tiled all-to-all (JAX `all_to_all(..., tiled=True)`): `x` is
    cut into n blocks along `split_dim`, block j goes to group rank j,
    and the blocks received (in rank order) are joined along
    `concat_dim`. The backward is the inverse all-to-all."""
    return _AllToAll.apply(x, group, split_dim, concat_dim)


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    dist = torch.distributed
    group = _group(group)
    n = dist.get_world_size(group)
    src = x.detach().contiguous()
    stage = _staged(src, group)
    src = _to_host(src) if stage else src
    # the output is the ranks' tensors one after another along dim 0
    shape = (n * src.shape[0],) + tuple(src.shape[1:])
    out = _pinned(shape, src.dtype) if stage else src.new_empty(shape)
    dist.all_gather_into_tensor(out, src, group=group)
    out = out.to(x.device, non_blocking=True) if stage else out
    return out if dim == 0 else torch.cat(out.chunk(n), dim=dim)


def _reduce_scatter(grad: torch.Tensor, group, dim: int) -> torch.Tensor:
    dist = torch.distributed
    group = _group(group)
    n = dist.get_world_size(group)
    # the input is the ranks' blocks one after another along dim 0
    send = torch.cat(grad.chunk(n, dim))
    stage = _staged(send, group)
    send = _to_host(send) if stage else send
    shape = (send.shape[0] // n,) + tuple(send.shape[1:])
    out = _pinned(shape, send.dtype) if stage else send.new_empty(shape)
    dist.reduce_scatter_tensor(out, send, group=group)
    return out.to(grad.device, non_blocking=True) if stage else out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, counts):
        ctx.group, ctx.dim, ctx.counts = group, dim, counts
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        if ctx.counts is not None:
            ctx.counts["reduce_scatter"] += 1
        return _reduce_scatter(grad, ctx.group, ctx.dim), None, None, None


def all_gather(x: torch.Tensor, group=None, dim: int = 0,
               counts: Optional[Dict[str, int]] = None) -> torch.Tensor:
    """The tiled all-gather (JAX `all_gather(..., tiled=True)`): every
    group rank's `x` joined along `dim` in rank order. The backward is a
    reduce-scatter: each rank gets the sum over ranks of its block's
    cotangent (and `counts["reduce_scatter"]`, when given, one more)."""
    return _AllGather.apply(x, group, dim, counts)
