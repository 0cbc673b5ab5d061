"""Model-server entrypoint (port of kubeflow_tpu/serving/main.py): build a
registry model on the card and serve REST. A causal LM (the GPT family)
serves `:generate` through the decode engine; every other model (ResNet,
the mlp) serves `:predict` and `:predict_npy` through a `ServedModel`
with the micro-batcher (`--batch-window-ms`, default 2 ms).

Engine knobs default from the controller-rendered KFT_SERVING_* env (the
subset this port honours). `KFT_SERVING_PAGED_ATTENTION` takes
`gather | kernel`: `kernel` walks the page table in place through the
CUDA kernels on CUDA tensors (the counterpart of the JAX package's
`pallas`) and through their plain version on CPU tensors.
`KFT_SERVING_QUANTIZE` takes `none | int8`: int8 weights and int8 KV
pages (the engine), or int8 weights on the static path (num_slots=0).
`KFT_SERVING_DRAFT_MODEL` + `KFT_SERVING_DRAFT_TOKENS` turn on
speculative decoding (a registry draft model, K tokens drafted per
verify step), its trained params from `KFT_SERVING_DRAFT_CHECKPOINT_DIR`.
`KFT_SERVING_KV_HOST_BYTES` gives the host-RAM tier its budget (evicted
prefix pages are parked there and uploaded again on a hit),
`KFT_SERVING_KV_PERSIST_DIR` the on-disk prefix store a restarted
replica preloads (written every `KFT_SERVING_KV_PERSIST_INTERVAL_S`
seconds when > 0, and at shutdown; its `KFT_SERVING_KV_PERSIST_CHAINS`
hottest pages); both need the prefix cache.
`KFT_TRACE_ENABLED`, `_BUFFER_SPANS`, `_STATUSZ`, `_SAMPLE_PROB` and
`_SAMPLE_KEEP` configure the process tracer and the /statusz,
/debug/trace and /tracez routes (explicit arguments win);
`KFT_CHAOS_POINTS` / `_SEED` arm the engine's fault-injection points
(absent: disarmed).
`--checkpoint-dir` serves the latest committed platform checkpoint of a
training run (the port's or the JAX package's). SIGTERM drains the
engines (for at most `KFT_SERVING_DRAIN_DEADLINE_S` seconds) before the
process exits. controllers/inference.py renders this command and its
env into a serving pod.

`KFT_SERVING_MESH_TENSOR`, `_FSDP` and `_EXPERT` (or `--mesh-tensor`,
`--mesh-fsdp`, `--mesh-expert`) serve the engine on a `tensor × fsdp ×
expert` serving mesh (parallel/serving_mesh.py): a gang of m = t·f·e
processes, one a card. Rank 0 builds the model and the engine and serves
REST; every other rank builds the same model and runs the engine's
relayed programs on its shard (`serve_mesh_worker`) until rank 0 closes.
A replica is one pod on m cards of one node: started without a gang env
(`KFT_NUM_PROCESSES` absent), this process is rank 0 and starts ranks
1..m−1 itself (`ReplicaWorkers`: the same command, the gang env of
parallel/distributed.py `render_gang_env` over localhost, rank i on
cuda:i). A worker's death fails the replica (exit 1). Started with a
gang env, it is the rank that env names.

`--device cpu` runs every rank on the CPU (gloo); the default is the
card, and a rank whose card is missing raises.

    python -m kubeflow_tpu_torch.serving.main --model gpt_small \
        --checkpoint-dir /data/checkpoints/run --port 8500
"""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Dict, List, Mapping, Optional

import torch

from kubeflow_tpu_torch.models.gpt import (
    PAGED_ATTENTION_IMPLS,
    QUANTIZE_CHOICES,
)
from kubeflow_tpu_torch.serving.engine import (
    DEFAULT_MAX_QUEUE,
    DEFAULT_NUM_SLOTS,
    DEFAULT_PAGE_SIZE,
    DEFAULT_PAGED_ATTENTION,
    DEFAULT_QUANTIZE,
)
from kubeflow_tpu_torch.serving.server import DEFAULT_DRAIN_DEADLINE_S

# how long rank 0 waits for its workers to end after its engine closed
WORKER_EXIT_TIMEOUT_S = 30.0
# set by a replica's rank 0 in its workers' env: rank 0's pid
ENV_REPLICA_PARENT = "KFT_SERVING_REPLICA_PARENT"


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    return int(raw) if raw.strip() else default


def _env_float(name: str, default: float) -> float:
    raw = os.environ.get(name, "")
    return float(raw) if raw.strip() else default


def engine_knobs_from_env() -> dict:
    """KFT_SERVING_NUM_SLOTS (0 disables the engine), _MAX_QUEUE,
    _PREFILL_BUCKETS (comma-separated powers of two; empty = auto),
    _PAGE_SIZE, _NUM_PAGES (0 = auto), _PREFIX_CACHE (0 = off),
    _PAGED_ATTENTION (gather | kernel), _QUANTIZE (none | int8),
    _DRAFT_MODEL + _DRAFT_TOKENS (speculative decoding: registry draft
    model and tokens drafted per verify step; 0 disables) and
    _DRAFT_CHECKPOINT_DIR (the platform checkpoint the draft's params
    are restored from, at K > 0 without draft params), and the KV tiers:
    _KV_HOST_BYTES (host-RAM spill budget; 0 = off), _KV_PERSIST_DIR
    (the on-disk prefix store; empty = off), _KV_PERSIST_INTERVAL_S
    (seconds between persists; 0 = only at shutdown) and
    _KV_PERSIST_CHAINS (pages a persist keeps, hottest first), and the
    serving mesh: _MESH_TENSOR (ranks splitting the KV pools' heads and
    the heads/mlp/vocab dims of the weights), _MESH_FSDP (ranks
    splitting the weights' embed dims) and _MESH_EXPERT (ranks splitting
    an MoE model's expert stacks); 1/1/1 is the one-card engine; and
    _DRAIN_DEADLINE_S (the SIGTERM drain budget)."""
    buckets_raw = os.environ.get("KFT_SERVING_PREFILL_BUCKETS", "")
    buckets = [int(b) for b in buckets_raw.split(",") if b.strip()]
    prefix_raw = os.environ.get("KFT_SERVING_PREFIX_CACHE", "").strip()
    return {
        "num_slots": _env_int("KFT_SERVING_NUM_SLOTS", DEFAULT_NUM_SLOTS),
        "max_queue": _env_int("KFT_SERVING_MAX_QUEUE", DEFAULT_MAX_QUEUE),
        "prefill_buckets": buckets or None,
        "page_size": _env_int("KFT_SERVING_PAGE_SIZE", DEFAULT_PAGE_SIZE),
        "num_pages": _env_int("KFT_SERVING_NUM_PAGES", 0),
        "prefix_cache": prefix_raw != "0",
        "paged_attention": (
            os.environ.get("KFT_SERVING_PAGED_ATTENTION", "").strip()
            or DEFAULT_PAGED_ATTENTION
        ),
        "quantize": (
            os.environ.get("KFT_SERVING_QUANTIZE", "").strip()
            or DEFAULT_QUANTIZE
        ),
        "draft_model": os.environ.get("KFT_SERVING_DRAFT_MODEL", "").strip(),
        "num_draft_tokens": _env_int("KFT_SERVING_DRAFT_TOKENS", 0),
        "draft_checkpoint_dir": os.environ.get(
            "KFT_SERVING_DRAFT_CHECKPOINT_DIR", ""
        ).strip(),
        # tiered KV (serving/kv_tiers.py): the host-RAM spill budget and
        # the on-disk prefix store a warm restart preloads
        "kv_host_bytes": _env_int("KFT_SERVING_KV_HOST_BYTES", 0),
        "kv_persist_dir": os.environ.get(
            "KFT_SERVING_KV_PERSIST_DIR", ""
        ).strip(),
        "kv_persist_interval_s": _env_float(
            "KFT_SERVING_KV_PERSIST_INTERVAL_S", 0.0
        ),
        "kv_persist_chains": _env_int("KFT_SERVING_KV_PERSIST_CHAINS", 64),
        "mesh_tensor": _env_int("KFT_SERVING_MESH_TENSOR", 1),
        "mesh_fsdp": _env_int("KFT_SERVING_MESH_FSDP", 1),
        "mesh_expert": _env_int("KFT_SERVING_MESH_EXPERT", 1),
        "drain_deadline_s": _env_float(
            "KFT_SERVING_DRAIN_DEADLINE_S", DEFAULT_DRAIN_DEADLINE_S
        ),
    }


def is_causal_family(model_name: str) -> bool:
    """Does this registry model serve :generate (a decoder-only LM)?
    Decided by the model's type (a shapes-only build), not its name."""
    from kubeflow_tpu_torch.models.gpt import Gpt
    from kubeflow_tpu_torch.models.registry import get_model

    return isinstance(get_model(model_name, device="meta"), Gpt)


def build_server(
    model: str,
    checkpoint_dir: str = "",
    *,
    batch_window_ms: Optional[float] = None,
    params: Optional[Mapping[str, torch.Tensor]] = None,
    device=None,
    dtype: Optional[torch.dtype] = None,
    num_slots: Optional[int] = None,
    max_queue: Optional[int] = None,
    prefill_buckets=None,
    page_size: Optional[int] = None,
    num_pages: Optional[int] = None,
    prefix_cache: Optional[bool] = None,
    paged_attention: Optional[str] = None,
    quantize: Optional[str] = None,
    draft_model: Optional[str] = None,
    num_draft_tokens: Optional[int] = None,
    draft_params: Optional[Mapping[str, torch.Tensor]] = None,
    draft_checkpoint_dir: Optional[str] = None,
    kv_host_bytes: Optional[int] = None,
    kv_persist_dir: Optional[str] = None,
    kv_persist_interval_s: Optional[float] = None,
    kv_persist_chains: Optional[int] = None,
    trace_enabled: Optional[bool] = None,
    trace_buffer_spans: Optional[int] = None,
    statusz_enabled: Optional[bool] = None,
    mesh_tensor: Optional[int] = None,
    mesh_fsdp: Optional[int] = None,
    mesh_expert: Optional[int] = None,
    drain_deadline_s: Optional[float] = None,
):
    """Assemble the ModelServer for one registry model. A causal LM gets
    the ServedLm plus (num_slots > 0) its continuous-batching
    DecodeEngine; any other model a `ServedModel.from_registry` (params
    only, as in the reference, so a BatchNorm model is refused there)
    with `batch_window_ms` of micro-batching (default 2.0; the engine
    batches :generate by tokens, so a window given for an LM is noted
    and ignored).

    `num_draft_tokens` K > 0 drafts with the registry model
    `draft_model`, built on the same device in the same dtype, with
    `draft_params` (a state dict), else the params of the latest
    committed checkpoint in `draft_checkpoint_dir`, else its seed-0 init
    (a note says so: output stays right, acceptance is noise until
    trained draft weights come).

    `quantize="int8"` with the engine on serves int8 weights and int8 KV
    pages through the engine while the ServedLm stays full width; with
    num_slots=0 the ServedLm itself is int8 (the static int8 path).

    `kv_host_bytes`, `kv_persist_dir`, `kv_persist_interval_s` and
    `kv_persist_chains` are the engine's KV tiers (serving/kv_tiers.py);
    either tier needs the prefix cache. An auto-sized pool (`num_pages`
    0 or None) follows the pressure an earlier engine of this process
    left in the metrics registry (`kv_tiers.pool_sizing_telemetry`), as
    in the reference: a caller that builds several servers in one
    process and needs a pool size of its own passes `num_pages`.

    `params` is a state dict for the model (e.g. from
    models/convert.py `params_from_jax`); without one the params come
    from the latest committed platform checkpoint in `checkpoint_dir`
    (`ServedLm.from_registry`), and without that the model keeps its
    seed-0 init. `device` defaults to "cuda" and raises
    without CUDA unless "cpu" is asked for. Engine knobs default from
    `engine_knobs_from_env()`.

    `mesh_tensor`, `mesh_fsdp` and `mesh_expert` (default from the
    KFT_SERVING_MESH_* env) above 1 serve the engine on a serving mesh:
    this process must be rank 0 of a gang of tensor·fsdp·expert ranks
    (joined here from the gang env when no group exists yet), every
    other rank running `serve_mesh_worker` with the same arguments. The
    model is built on the host and the engine takes it over (its leaves
    become rank 0's blocks on `device`, the card holding no whole leaf
    it splits);
    `:generate` is the engine's, so the ServedLm's own path is not used.

    The KFT_CHAOS_* plan arms the process's injection points (absent, it
    disarms them). `trace_enabled`, `trace_buffer_spans` and
    `statusz_enabled` default from the KFT_TRACE_* env
    (`observability.trace.knobs_from_env`), which also gives the tail
    sampler's probability and ring size. `drain_deadline_s` (default
    from KFT_SERVING_DRAIN_DEADLINE_S) is the server's SIGTERM drain
    budget (`ModelServer.close(drain=True)`)."""
    from kubeflow_tpu_torch.chaos import configure_from_env as configure_chaos
    from kubeflow_tpu_torch.observability.trace import (
        default_tracer,
        knobs_from_env,
    )
    from kubeflow_tpu_torch.serving.engine import DecodeEngine
    from kubeflow_tpu_torch.serving.kv_tiers import pool_sizing_telemetry
    from kubeflow_tpu_torch.serving.server import ModelServer, ServedModel
    from kubeflow_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    # the KFT_CHAOS_* plan: the env is the whole truth
    configure_chaos()
    obs = knobs_from_env()
    if trace_enabled is None:
        trace_enabled = obs["trace_enabled"]
    if trace_buffer_spans is None:
        trace_buffer_spans = obs["trace_buffer_spans"]
    if statusz_enabled is None:
        statusz_enabled = obs["statusz_enabled"]
    default_tracer().configure(
        enabled=trace_enabled, capacity=trace_buffer_spans,
        sample_prob=obs["trace_sample_prob"],
        sample_keep=obs["trace_sample_keep"],
    )
    env = engine_knobs_from_env()
    if drain_deadline_s is None:
        drain_deadline_s = env["drain_deadline_s"]
    if not is_causal_family(model):
        server = ModelServer(statusz_enabled=statusz_enabled)
        server.drain_deadline_s = float(drain_deadline_s)
        server.add(ServedModel.from_registry(
            model, checkpoint_dir=checkpoint_dir or None, params=params,
            batch_window_ms=2.0 if batch_window_ms is None else batch_window_ms,
            device=dev, **({"dtype": dtype} if dtype is not None else {}),
        ))
        return server
    if batch_window_ms:
        print("note: batch_window_ms does not apply to the :generate path "
              "(the decode engine batches at token granularity)", flush=True)
    num_slots = env["num_slots"] if num_slots is None else num_slots
    max_queue = env["max_queue"] if max_queue is None else max_queue
    if prefill_buckets is None:
        prefill_buckets = env["prefill_buckets"]
    page_size = env["page_size"] if page_size is None else page_size
    num_pages = env["num_pages"] if num_pages is None else num_pages
    if prefix_cache is None:
        prefix_cache = env["prefix_cache"]
    if paged_attention is None:
        paged_attention = env["paged_attention"]
    if quantize is None:
        quantize = env["quantize"]
    if draft_model is None:
        draft_model = env["draft_model"]
    if num_draft_tokens is None:
        num_draft_tokens = env["num_draft_tokens"]
    if draft_checkpoint_dir is None:
        draft_checkpoint_dir = env["draft_checkpoint_dir"]
    if kv_host_bytes is None:
        kv_host_bytes = env["kv_host_bytes"]
    if kv_persist_dir is None:
        kv_persist_dir = env["kv_persist_dir"]
    if kv_persist_interval_s is None:
        kv_persist_interval_s = env["kv_persist_interval_s"]
    if kv_persist_chains is None:
        kv_persist_chains = env["kv_persist_chains"]
    mesh = _mesh_knobs(env, mesh_tensor, mesh_fsdp, mesh_expert)
    if num_slots < 1 and max(mesh.values()) > 1:
        raise ValueError(
            "a serving mesh needs num_slots >= 1: the mesh shards the "
            "decode engine's programs, and num_slots=0 disables the "
            "engine (the static path would silently serve one card)"
        )
    if (kv_host_bytes or kv_persist_dir) and not prefix_cache:
        raise ValueError(
            "KFT_SERVING_KV_HOST_BYTES / KFT_SERVING_KV_PERSIST_DIR need "
            "the prefix cache: both KV tiers key off the radix index's "
            "committed chains; enable KFT_SERVING_PREFIX_CACHE or drop the "
            "tier knobs"
        )
    if num_draft_tokens > 0 and not draft_model:
        raise ValueError(
            "num_draft_tokens > 0 needs a draft model "
            "(--draft-model / KFT_SERVING_DRAFT_MODEL)"
        )
    if num_draft_tokens > 0 and num_slots < 1:
        raise ValueError(
            "num_draft_tokens > 0 needs num_slots >= 1: speculation lives "
            "inside the decode engine, and num_slots=0 disables it"
        )
    if quantize not in QUANTIZE_CHOICES:
        raise ValueError(
            f"quantize {quantize!r} must be one of {QUANTIZE_CHOICES}"
        )
    if paged_attention not in PAGED_ATTENTION_IMPLS:
        raise ValueError(
            f"paged_attention {paged_attention!r} must be one of "
            f"{PAGED_ATTENTION_IMPLS}"
        )
    if num_slots < 1 and paged_attention != "gather":
        raise ValueError(
            "paged_attention=kernel needs num_slots >= 1: the kernel "
            "serves the engine, and num_slots=0 disables the engine"
        )
    if max(mesh.values()) > 1:
        from kubeflow_tpu_torch.parallel.distributed import (
            initialize_from_env,
        )

        # rank 0 of the serving gang (a no-op when this process joined it
        # already, or runs without a rendered gang: the mesh then raises)
        initialize_from_env(device=dev)
    # num_slots=0 + quantize=int8 is the static int8 path: the ServedLm
    # itself is int8. With the engine on, the ServedLm stays full width
    # and the engine quantizes.
    lm_quantize = quantize if num_slots < 1 else "none"
    # on a serving mesh the models are built on the host: the engine's
    # mesh copies only this rank's blocks to the card
    build_dev = torch.device("cpu") if max(mesh.values()) > 1 else dev
    lm = _served_lm(model, checkpoint_dir, params, build_dev, dtype,
                    lm_quantize)
    server = ModelServer(statusz_enabled=statusz_enabled)
    server.drain_deadline_s = float(drain_deadline_s)
    server.add_lm(lm)
    lm_model = lm.model
    if num_slots > 0:
        draft = _draft_lm(draft_model, num_draft_tokens, draft_params,
                          draft_checkpoint_dir, build_dev, dtype)
        server.add_engine(
            DecodeEngine(
                lm.name, lm_model, device=dev,
                num_slots=num_slots, max_queue=max_queue,
                prefill_buckets=prefill_buckets,
                page_size=page_size or None, num_pages=num_pages or None,
                prefix_cache=prefix_cache, paged_attention=paged_attention,
                quantize=quantize, draft_model=draft,
                num_draft_tokens=num_draft_tokens,
                kv_host_bytes=kv_host_bytes or 0,
                kv_persist_dir=kv_persist_dir or None,
                kv_persist_interval_s=kv_persist_interval_s or 0.0,
                kv_persist_chains=kv_persist_chains or 64,
                # an auto-sized pool follows an earlier engine's pressure
                # (None on a fresh process: the static rule)
                pool_telemetry=(None if num_pages
                                else pool_sizing_telemetry()),
                mesh_tensor=mesh["tensor"], mesh_fsdp=mesh["fsdp"],
                mesh_expert=mesh["expert"],
            )
        )
    return server


def _mesh_knobs(env: dict, tensor, fsdp, expert) -> dict:
    """The serving mesh's sizes: the arguments, else the env's."""
    return {"tensor": env["mesh_tensor"] if tensor is None else int(tensor),
            "fsdp": env["mesh_fsdp"] if fsdp is None else int(fsdp),
            "expert": env["mesh_expert"] if expert is None else int(expert)}


def _served_lm(model: str, checkpoint_dir, params, dev, dtype, quantize):
    """The ServedLm of registry model `model` on `dev`: `params` (a state
    dict), else the latest committed checkpoint in `checkpoint_dir`,
    else the seed-0 init."""
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.serving.generate import ServedLm

    kwargs = {"device": dev}
    if dtype is not None:
        kwargs["dtype"] = dtype
    if params is None and checkpoint_dir:
        return ServedLm.from_registry(model, checkpoint_dir=checkpoint_dir,
                                      quantize=quantize, **kwargs)
    lm_model = get_model(model, **kwargs)
    if params is not None:
        lm_model.load_state_dict(params, strict=True)
    return ServedLm(model, lm_model, quantize=quantize)


def _draft_lm(draft_model, num_draft_tokens, draft_params,
              draft_checkpoint_dir, dev, dtype):
    """The draft model at K > 0 (None at K = 0): registry model
    `draft_model` on `dev` with `draft_params`, else the params of the
    latest committed checkpoint in `draft_checkpoint_dir`, else its
    seed-0 init (a note says so)."""
    from kubeflow_tpu_torch.models.convert import params_from_jax
    from kubeflow_tpu_torch.models.registry import get_model
    from kubeflow_tpu_torch.serving.server import restore_checkpoint_params

    if not num_draft_tokens or num_draft_tokens <= 0:
        return None
    kwargs = {"device": dev}
    if dtype is not None:
        kwargs["dtype"] = dtype
    if draft_params is None and draft_checkpoint_dir:
        # trained draft params from a platform checkpoint: the same
        # manifest restore the target serves from
        draft_params = params_from_jax(
            restore_checkpoint_params(draft_checkpoint_dir)
        )
    if draft_params is not None:
        # shapes only, then memory on the device, then the params
        draft = get_model(draft_model, **{**kwargs, "device": "meta"})
        draft = draft.to_empty(device=dev)
        draft.load_state_dict(draft_params, strict=True)
        return draft
    print(f"note: draft model {draft_model} initialized from seed 0 (no "
          "draft params given); output stays correct, accept rate will be "
          "noise until trained draft params are provided", flush=True)
    return get_model(draft_model, **kwargs)


def serve_mesh_worker(
    model: str,
    checkpoint_dir: str = "",
    *,
    params: Optional[Mapping[str, torch.Tensor]] = None,
    device=None,
    dtype: Optional[torch.dtype] = None,
    draft_model: Optional[str] = None,
    num_draft_tokens: Optional[int] = None,
    draft_params: Optional[Mapping[str, torch.Tensor]] = None,
    draft_checkpoint_dir: Optional[str] = None,
    mesh_tensor: Optional[int] = None,
    mesh_fsdp: Optional[int] = None,
    mesh_expert: Optional[int] = None,
) -> Dict[str, int]:
    """A serving mesh's rank above 0: the models `build_server` builds
    from the same arguments (and the same KFT_SERVING_* env), then
    serving/engine.py `serve_worker` until rank 0's engine closes →
    {relayed call: times run}. Joins the gang from its env when no group exists
    yet."""
    from kubeflow_tpu_torch.parallel.distributed import initialize_from_env
    from kubeflow_tpu_torch.serving.engine import serve_worker
    from kubeflow_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    env = engine_knobs_from_env()
    mesh = _mesh_knobs(env, mesh_tensor, mesh_fsdp, mesh_expert)
    if draft_model is None:
        draft_model = env["draft_model"]
    if num_draft_tokens is None:
        num_draft_tokens = env["num_draft_tokens"]
    if draft_checkpoint_dir is None:
        draft_checkpoint_dir = env["draft_checkpoint_dir"]
    initialize_from_env(device=dev)
    # built on the host, as rank 0 builds them: the mesh copies only this
    # rank's blocks to the card
    cpu = torch.device("cpu")
    lm = _served_lm(model, checkpoint_dir, params, cpu, dtype, "none")
    draft = _draft_lm(draft_model, num_draft_tokens, draft_params,
                      draft_checkpoint_dir, cpu, dtype)
    return serve_worker(lm.model, draft, device=dev,
                        mesh_tensor=mesh["tensor"], mesh_fsdp=mesh["fsdp"],
                        mesh_expert=mesh["expert"])


def _follow_replica_parent() -> None:
    """In a worker a replica's rank 0 started (`ENV_REPLICA_PARENT` names
    rank 0's pid): ignore SIGTERM (rank 0 drains its engine first, and
    closing it ends the workers' relay), and die with rank 0 (Linux:
    PR_SET_PDEATHSIG), so no worker outlives it."""
    parent = int(os.environ.get(ENV_REPLICA_PARENT, "") or 0)
    if not parent:
        return
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    try:
        import ctypes

        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)
    except (AttributeError, OSError):
        pass
    if os.getppid() != parent:
        raise SystemExit(f"serving replica: rank 0 (pid {parent}) is gone")


class ReplicaWorkers:
    """Ranks 1..m−1 of a serving-mesh replica that runs in one pod: this
    process is rank 0. Each worker is `python -m
    kubeflow_tpu_torch.serving.main` with `argv` and the gang env
    `render_gang_env` gives its rank over localhost (so rank i drives
    cuda:i); rank 0 takes rank 0's env. The coordinator port stays held
    (`reserve_port`) until `stop()`, so nothing else takes it before rank
    0's store listens. A watchdog fails the replica when a worker exits
    before `stop()`: it kills the others and exits this process with 1."""

    def __init__(self, ranks: int, argv: List[str]) -> None:
        from kubeflow_tpu_torch.parallel.distributed import (
            render_gang_env,
            reserve_port,
        )

        self._port = reserve_port()
        envs = render_gang_env("serving-replica", ["127.0.0.1"] * ranks,
                               coordinator_port=self._port.getsockname()[1])
        os.environ.update(envs[0])
        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        self._stopping = threading.Event()
        self.procs: List[subprocess.Popen] = []
        for rank_env in envs[1:]:
            env = dict(os.environ, **rank_env)
            env[ENV_REPLICA_PARENT] = str(os.getpid())
            env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", "kubeflow_tpu_torch.serving.main",
                 *argv], env=env))
        print(f"serving replica: {ranks} ranks, workers "
              f"{[p.pid for p in self.procs]}", flush=True)
        threading.Thread(target=self._watch, name="replica-watchdog",
                         daemon=True).start()

    def _watch(self) -> None:
        while not self._stopping.wait(0.2):
            for rank, proc in enumerate(self.procs, 1):
                code = proc.poll()
                if code is not None and not self._stopping.is_set():
                    print(f"serving replica: worker rank {rank} exited "
                          f"{code}; the replica fails", flush=True)
                    self._kill()
                    os._exit(1)

    def _kill(self) -> None:
        for proc in self.procs:
            if proc.poll() is None:
                proc.kill()
        for proc in self.procs:
            proc.wait()

    def closing(self) -> None:
        """Rank 0 is about to close its engine: the workers' exits that
        follow end the replica, they do not fail it."""
        self._stopping.set()

    def stop(self, timeout_s: float) -> List[Optional[int]]:
        """Wait up to `timeout_s` for the workers to end (rank 0's engine
        closed their relay), kill any left → their exit codes (None for a
        worker killed here)."""
        self.closing()
        deadline = time.monotonic() + timeout_s
        codes: List[Optional[int]] = []
        for proc in self.procs:
            try:
                codes.append(proc.wait(max(0.0, deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                codes.append(None)
        self._kill()
        self._port.close()
        return codes


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    ap = argparse.ArgumentParser(description="kubeflow-tpu torch model server")
    ap.add_argument("--model", required=True, help="registry model name")
    ap.add_argument("--checkpoint-dir", default="",
                    help="platform checkpoint dir (checkpointing/): its "
                    "latest committed step's params are served")
    ap.add_argument("--weights", default="",
                    help="torch.save'd state dict (default: the checkpoint, "
                    "else seed-0 init)")
    ap.add_argument("--port", type=int, default=8500)
    ap.add_argument("--device", default=None,
                    help="where every rank runs: the card (default; rank i "
                    "of a replica drives cuda:i) or cpu (gloo)")
    ap.add_argument("--batch-window-ms", type=float, default=None,
                    help="cross-request micro-batch window for :predict "
                    "(default 2; 0 disables)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--num-slots", type=int, default=None)
    ap.add_argument("--max-queue", type=int, default=None)
    ap.add_argument("--page-size", type=int, default=None)
    ap.add_argument("--num-pages", type=int, default=None)
    ap.add_argument("--prefix-cache", type=int, choices=(0, 1), default=None)
    ap.add_argument("--paged-attention", choices=PAGED_ATTENTION_IMPLS,
                    default=None)
    ap.add_argument("--quantize", choices=QUANTIZE_CHOICES, default=None,
                    help="int8: int8 weights and int8 KV pages")
    ap.add_argument("--draft-model", default=None,
                    help="registry draft model for speculative decoding "
                    "(default from KFT_SERVING_DRAFT_MODEL; empty disables)")
    ap.add_argument("--draft-tokens", type=int, default=None,
                    help="tokens drafted per verify step (default from "
                    "KFT_SERVING_DRAFT_TOKENS, else 0)")
    ap.add_argument("--draft-checkpoint-dir", default=None,
                    help="platform checkpoint dir with the draft's trained "
                    "params (default from KFT_SERVING_DRAFT_CHECKPOINT_DIR; "
                    "empty = seed-0 init, accept rate will be noise)")
    ap.add_argument("--mesh-tensor", type=int, default=None,
                    help="serving mesh ranks splitting the KV pools' heads "
                    "(must divide the model's num_heads and mlp_dim; "
                    "default from KFT_SERVING_MESH_TENSOR, else 1)")
    ap.add_argument("--mesh-fsdp", type=int, default=None,
                    help="serving mesh ranks splitting the resident "
                    "weights' embed dims, gathered at use (must divide "
                    "hidden_size; default from KFT_SERVING_MESH_FSDP, "
                    "else 1)")
    ap.add_argument("--mesh-expert", type=int, default=None,
                    help="serving mesh ranks splitting an MoE model's "
                    "expert stacks (never gathered; must divide "
                    "num_experts, top-1 routing only; default from "
                    "KFT_SERVING_MESH_EXPERT, else 1)")
    args = ap.parse_args(argv)
    _follow_replica_parent()

    from kubeflow_tpu_torch.parallel.distributed import ENV_NUM_PROCESSES

    params = None
    if args.weights:
        params = torch.load(args.weights, map_location="cpu",
                            weights_only=True)
    elif not args.checkpoint_dir:
        print(f"note: {args.model} serves its seed-0 init (no --weights "
              "or --checkpoint-dir given)", flush=True)
    mesh = _mesh_knobs(engine_knobs_from_env(), args.mesh_tensor,
                       args.mesh_fsdp, args.mesh_expert)
    ranks = mesh["tensor"] * mesh["fsdp"] * mesh["expert"]
    workers = None
    if ranks > 1 and ENV_NUM_PROCESSES not in os.environ:
        # a replica's pod: this process is rank 0 and starts the others
        workers = ReplicaWorkers(ranks, argv)
    code = 1
    try:
        code = _serve(args, params, mesh, workers)
        return code
    finally:
        if workers is not None:
            # after a drain the workers end on their own; after a failure
            # they are killed at once
            codes = workers.stop(WORKER_EXIT_TIMEOUT_S if code == 0 else 0.0)
            print(f"serving replica: workers exited {codes}", flush=True)


def _serve(args, params, mesh, workers: Optional[ReplicaWorkers]) -> int:
    """The rest of `main`: a mesh worker's relay loop, or rank 0's (or a
    one-card replica's) server until SIGTERM drains it."""
    from kubeflow_tpu_torch.api.wsgi import Server

    if max(mesh.values()) > 1:
        from kubeflow_tpu_torch.parallel.distributed import (
            initialize_from_env,
            rank,
        )

        initialize_from_env(device=args.device)
        if rank() > 0:
            # a serving mesh's worker: no server of its own
            serve_mesh_worker(
                args.model, args.checkpoint_dir, params=params,
                device=args.device, draft_model=args.draft_model,
                num_draft_tokens=args.draft_tokens,
                draft_checkpoint_dir=args.draft_checkpoint_dir,
                mesh_tensor=mesh["tensor"], mesh_fsdp=mesh["fsdp"],
                mesh_expert=mesh["expert"])
            return 0
    server = build_server(
        args.model, args.checkpoint_dir, params=params, device=args.device,
        batch_window_ms=args.batch_window_ms,
        num_slots=args.num_slots, max_queue=args.max_queue,
        page_size=args.page_size, num_pages=args.num_pages,
        prefix_cache=(
            None if args.prefix_cache is None else bool(args.prefix_cache)
        ),
        paged_attention=args.paged_attention, quantize=args.quantize,
        draft_model=args.draft_model, num_draft_tokens=args.draft_tokens,
        draft_checkpoint_dir=args.draft_checkpoint_dir,
        mesh_tensor=mesh["tensor"], mesh_fsdp=mesh["fsdp"],
        mesh_expert=mesh["expert"],
    )
    httpd = Server(server.app, host=args.host, port=args.port)
    print(f"serving {args.model} on :{httpd.port}", flush=True)
    httpd.start()
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda signum, frame: stop.set())
    try:
        while not stop.wait(1.0):
            failed = server.failed_engines()
            if failed:
                # a serving mesh out of step: exiting ends the gang (the
                # workers' collectives fail) and the pod restarts
                print(f"engine(s) {', '.join(failed)} failed; exiting",
                      flush=True)
                server.close()
                return 1
        # scale-down: finish every accepted request, 429 + Retry-After
        # for new ones, before the process exits; the workers end when
        # the drained engine closes their relay
        print(f"SIGTERM: draining engines (deadline "
              f"{server.drain_deadline_s:g}s)", flush=True)
        if workers is not None:
            workers.closing()
        drained = server.close(drain=True)
        print(f"drain {'complete' if drained else 'TIMED OUT'}", flush=True)
    except KeyboardInterrupt:
        if workers is not None:
            workers.closing()
        server.close()
    finally:
        httpd.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
