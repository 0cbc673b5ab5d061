"""Paged attention: the CUDA kernels that walk the page table in place,
and their plain PyTorch version (port of kubeflow_tpu/ops/paged_attention.py).

`paged_attention` reads every slot's K/V rows page by page straight out
of the engine's block pool; nothing contiguous is materialized. On a
CUDA tensor it launches a hand-written kernel from
`ops/csrc/paged_attention.cu` (built with nvcc at first use): the
one-token decode kernel at s == 1 (replacing the JAX package's
`_kernel`), the window kernel at s > 1 (replacing `_mq_kernel`). Each has
an int8 variant for the pools of `serving.quantize=int8` (int8 values
plus one bf16 scale per (token, head) vector, `k_scale`/`v_scale`
[P, page_size, H, 1]) that dequantizes each vector on the page walk, as
the `quantized=True` branches of the JAX kernels do. It has no fallback:
a CUDA input either launches the kernel or raises. On a CPU tensor it
runs `paged_attention_reference`, as the JAX kernel runs in interpret
mode off-TPU.

Both kernels split each slot's walk over runs of pages and fold the
splits inside their one launch; their scratch (per-split partials and a
ticket per (slot, head), or per (slot, head, query tile) for a window) is
one workspace buffer per device, stream and size, allocated zeroed at
that shape's first call on the stream and reused by every later one (the
kernels leave it ready), so a call allocates nothing new and the launch,
whose grid follows the window and the table's width and never the
cursors, can be captured in a CUDA graph. The tickets assume that the
calls sharing a workspace run one after another: keyed by stream, two
streams (two engines, or a graph replayed on a side stream) never share
one.

`launch_counts` counts kernel launches, one integer per kernel and one
launch per wrapper call (a decode step makes one per layer), so a run
can show which read path served it.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Tuple

import torch

from kubeflow_tpu_torch.ops.attention import (
    dense_attention,
    dequant_kv,
    scale_for,
)

# launches of each CUDA kernel since the last reset (plain integers; the
# CPU path never counts)
launch_counts: Dict[str, int] = {
    "paged_decode": 0, "paged_window": 0,
    "paged_decode_int8": 0, "paged_window_int8": 0,
}

SUPPORTED_HEAD_DIMS = (16, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT8_CODE = 2  # the C interface's storage code of an int8 pool
# keys a window split takes at most: a larger page is cut into parts of
# this many keys, so it must hold whole ones
WINDOW_SPLIT_KEYS = 128
# the kernels' workspaces, by (device, stream, bytes); engines call from
# their own threads
_workspaces: Dict[Tuple[str, int, int], torch.Tensor] = {}
_workspaces_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def kernel_name(s: int, quantized: bool = False) -> str:
    """Which kernel serves a window of `s` query rows (over an int8 pool
    when `quantized`)."""
    name = "paged_decode" if s == 1 else "paged_window"
    return f"{name}_int8" if quantized else name


def paged_workspace(device: torch.device, stream: int,
                    nbytes: int) -> torch.Tensor:
    """The zeroed uint8 buffer of `nbytes` on `device` that the kernels
    launched on `stream` (its handle) use as their workspace: made at the
    first call of a size on that stream, the same tensor for every later
    one there, another tensor on another stream."""
    key = (str(device), stream, nbytes)
    with _workspaces_lock:
        ws = _workspaces.get(key)
        if ws is None:
            ws = torch.zeros(nbytes, dtype=torch.uint8, device=device)
            _workspaces[key] = ws
    return ws


def paged_attention_reference(
    q: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    page_table: torch.Tensor,
    cursors: torch.Tensor,
    *,
    dtype: torch.dtype,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of `paged_attention`: gather each slot's
    view through the page table (an int8 pool's values and scales alike,
    then `dequant_kv`), then the dense attention core with the per-query
    visibility mask (query row j of slot b sits at position cursors[b] + j
    and sees keys <= cursors[b] + j).

    Like the kernels, the table is read only up to each slot's last live
    page (min((cursor + s - 1) // page_size, max_pages - 1)); entries past
    it are replaced by that page, so a stale entry is never dereferenced
    (its positions are masked either way). A parked slot (cursor at or
    past the window, max_pages * page_size) is never read: its rows are
    zeros, as the kernels write them."""
    b, s = q.shape[:2]
    ps = pool_k.shape[1]
    mp = page_table.shape[1]
    view_len = mp * ps
    cur = cursors.long()
    last = ((cur + (s - 1)).clamp_min(0) // ps).clamp_max(mp - 1)
    p_idx = torch.minimum(
        torch.arange(mp, device=cur.device)[None, :], last[:, None]
    )
    table = torch.gather(page_table.long(), 1, p_idx)
    parked = cur >= view_len
    # a parked row's table may be stale: page 0 stands in, output zeroed
    table = table.masked_fill(parked[:, None], 0).reshape(-1)

    def view(pool):
        return pool.index_select(0, table).reshape(
            (b, view_len) + tuple(pool.shape[2:])
        )

    k_view, v_view = view(pool_k), view(pool_v)
    if k_scale is not None:
        k_view = dequant_kv(k_view, view(k_scale), dtype)
        v_view = dequant_kv(v_view, view(v_scale), dtype)
    q_pos = cur[:, None] + torch.arange(s, device=cur.device)[None, :]
    visible = (
        torch.arange(view_len, device=cur.device)[None, None, :]
        <= q_pos[:, :, None]
    )
    out = dense_attention(
        q, k_view, v_view, mask=visible, dtype=dtype, causal=False
    )
    return out.masked_fill(parked[:, None, None, None], 0)


def _library():
    from kubeflow_tpu_torch.native.build import load_library

    lib = load_library("paged_attention")
    if not getattr(lib, "_kft_bound", False):
        ptr = ctypes.c_void_p
        i32 = ctypes.c_int
        lib.kft_paged_attention.argtypes = [
            ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
            i32, i32, i32, i32, i32, i32, i32, i32, i32,
            ctypes.c_float, ptr, ptr,
        ]
        lib.kft_paged_attention.restype = ctypes.c_int
        lib.kft_paged_attention_workspace.argtypes = [i32] * 6
        lib.kft_paged_attention_workspace.restype = ctypes.c_size_t
        lib.kft_cuda_error_string.argtypes = [ctypes.c_int]
        lib.kft_cuda_error_string.restype = ctypes.c_char_p
        lib._kft_bound = True
    return lib


def _check_cuda_inputs(q, pool_k, pool_v, page_table, cursors, dtype,
                       k_scale=None, v_scale=None):
    b, s, h, d = q.shape
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"paged_attention kernel: dtype {dtype} not in "
                         f"{tuple(_DTYPE_CODES)}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"paged_attention kernel: head dim {d} not in "
                         f"{SUPPORTED_HEAD_DIMS}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("paged_attention kernel: k_scale and v_scale come "
                         "together")
    quantized = k_scale is not None
    if quantized != (pool_k.dtype == torch.int8):
        raise ValueError(
            "paged_attention kernel: an int8 pool needs k_scale/v_scale and "
            f"scales need an int8 pool (pool {pool_k.dtype}, scales "
            f"{'given' if quantized else 'absent'})"
        )
    store = torch.int8 if quantized else dtype
    checks = [("q", q, dtype), ("pool_k", pool_k, store),
              ("pool_v", pool_v, store)]
    if quantized:
        checks += [("k_scale", k_scale, torch.bfloat16),
                   ("v_scale", v_scale, torch.bfloat16)]
    for name, t, want in checks:
        if t.dtype != want:
            raise ValueError(f"paged_attention kernel: {name} is {t.dtype}, "
                             f"expected {want}")
    for name, t in (("page_table", page_table), ("cursors", cursors)):
        if t.dtype != torch.int32:
            raise ValueError(f"paged_attention kernel: {name} must be int32")
    tensors = [q, pool_k, pool_v, page_table, cursors]
    if quantized:
        tensors += [k_scale, v_scale]
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_attention kernel: inputs on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention kernel: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, pool_k, pool_v)):
        raise ValueError("paged_attention kernel: q and the pools must be "
                         "16-byte aligned (the kernels load 16-byte vectors)")
    if quantized and d % 16:
        # every supported head dim qualifies; the kernel relies on it
        raise ValueError("paged_attention kernel: an int8 pool needs a head "
                         "dim that is a multiple of 16 (one 16-byte load "
                         "holds 16 values, each vector 16-byte aligned)")
    if pool_k.shape != pool_v.shape or pool_k.shape[2:] != (h, d):
        raise ValueError(
            f"paged_attention kernel: pools {tuple(pool_k.shape)}/"
            f"{tuple(pool_v.shape)} do not match q heads {h} x {d}"
        )
    if quantized:
        want = tuple(pool_k.shape[:3]) + (1,)
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            if tuple(t.shape) != want:
                raise ValueError(
                    f"paged_attention kernel: {name} is {tuple(t.shape)}, "
                    f"expected {want} (one scale per pool vector)"
                )
    if page_table.dim() != 2 or page_table.shape[0] != b:
        raise ValueError("paged_attention kernel: page_table must be [B, MP]")
    if tuple(cursors.shape) != (b,):
        raise ValueError("paged_attention kernel: cursors must be [B]")


def paged_attention(
    q: torch.Tensor,
    pool_k: torch.Tensor,
    pool_v: torch.Tensor,
    page_table: torch.Tensor,
    cursors: torch.Tensor,
    *,
    dtype: torch.dtype,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Paged-attention read over all slots, any window size.

    q [B, s, H, D] compute dtype; pool_k/pool_v [P, page_size, H, D] in
    the compute dtype, or int8 with bf16 k_scale/v_scale [P, page_size,
    H, 1]; page_table [B, MP] int32; cursors [B] int32 (query row j of
    slot b sits at logical position cursors[b] + j). Returns [B, s, H, D].
    s == 1 is the one-token decode step, s > 1 a window (chunk prefill,
    the prefix-hit tail, the K+1 verify window).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    on the current stream (no sync; no allocation besides the output and,
    at a shape's first call on the stream, its workspace) or raise."""
    if q.device.type == "cpu":
        return paged_attention_reference(
            q, pool_k, pool_v, page_table, cursors, dtype=dtype,
            k_scale=k_scale, v_scale=v_scale,
        )
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: no kernel for {q.device}")
    _check_cuda_inputs(q, pool_k, pool_v, page_table, cursors, dtype,
                       k_scale, v_scale)
    b, s, h, d = q.shape
    num_pages, ps = pool_k.shape[:2]
    mp = page_table.shape[1]
    quantized = k_scale is not None
    kv_code = _INT8_CODE if quantized else _DTYPE_CODES[dtype]
    if s > 1 and ps > WINDOW_SPLIT_KEYS and ps % WINDOW_SPLIT_KEYS:
        raise ValueError(
            f"paged_attention kernel: a window over pages of {ps} positions "
            f"needs a page size of at most {WINDOW_SPLIT_KEYS} or a multiple "
            f"of it (a split takes {WINDOW_SPLIT_KEYS} keys of one page)"
        )
    lib = _library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        ws = paged_workspace(
            q.device, stream,
            lib.kft_paged_attention_workspace(s, b, h, d, ps, mp),
        )
        err = lib.kft_paged_attention(
            q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(),
            k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None,
            page_table.data_ptr(), cursors.data_ptr(), out.data_ptr(),
            b, s, h, d, ps, mp, num_pages, _DTYPE_CODES[dtype], kv_code,
            scale_for(d, dtype), stream, ws.data_ptr(),
        )
    if err != 0:
        msg = lib.kft_cuda_error_string(err).decode()
        raise RuntimeError(f"paged_attention kernel launch failed: {msg}")
    launch_counts[kernel_name(s, quantized)] += 1
    return out
