"""Flash attention: the CUDA forward and backward kernels and their plain
PyTorch versions (port of kubeflow_tpu/ops/flash_attention.py).

`flash_attention` applies a `torch.autograd.Function` whose forward is
`flash_fwd` and whose backward is `flash_bwd_dq` + `flash_bwd_dkv`, the
three hand-written kernels of `ops/csrc/flash_attention.cu` (built with
nvcc at first use), replacing the JAX package's `_fwd_kernel`,
`_bwd_dq_kernel` and `_bwd_dkv_kernel`. In bf16 the forward and dK/dV
kernels read their tiles through TMA, so every tensor they take must be
16-byte aligned (checked before any launch). On a CUDA tensor it launches them
or raises: there is no fallback. On a CPU tensor it runs
`flash_attention_reference` and `flash_attention_bwd_reference`, as the
JAX kernels run in interpret mode off-TPU.

Semantics are the Pallas kernels' (not their VMEM tiling): scores are
q·kᵀ accumulated in f32 times `scale` in f32 (not rounded to the compute
dtype, unlike `ops/attention.py::dense_attention`); a masked score is
BIG_NEG and contributes p = 0 exactly; o = acc / max(l, 1e-30) in the input
dtype and lse = m + log(max(l, 1e-30)) in f32, so a row with no visible
key gives o = 0 (not the dense path's uniform mix) and lse ≈ -1e30.

`launch_counts` counts kernel launches, one integer per kernel.
"""

from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Tuple

import torch

BIG_NEG = -1e30

# launches of each CUDA kernel since the last reset (plain integers; the
# CPU path never counts)
launch_counts: Dict[str, int] = {
    "flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0,
}

SUPPORTED_HEAD_DIMS = (16, 64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def default_scale(head_dim: int) -> float:
    """1/sqrt(D) as a Python float (the JAX wrapper's default)."""
    return 1.0 / math.sqrt(head_dim)


def _visible(mask: Optional[torch.Tensor], causal: bool, s: int, device):
    """[B or 1, 1, S, S] bool: which (query, key) pairs are attended."""
    live = torch.ones((1, 1, s, s), dtype=torch.bool, device=device)
    if causal:
        live = live.tril()
    if mask is not None:
        live = live & (mask != 0)[:, None, None, :]
    return live


def _scores(q, k, scale):
    """f32 q·kᵀ times scale: [B, H, S, S] (bf16 products are exact in f32)."""
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale


def flash_attention_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain one-pass version of the forward kernel: (o [B, S, H, D] in
    q's dtype, lse [B, H, S] f32). Materializes the [B, H, S, S] f32
    scores."""
    scale = default_scale(q.shape[-1]) if scale is None else scale
    live = _visible(mask, causal, q.shape[1], q.device)
    s = _scores(q, k, scale).masked_fill(~live, BIG_NEG)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m).masked_fill(~live, 0.0)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    o = (pv / l).permute(0, 2, 1, 3).to(q.dtype)
    return o, (m + torch.log(l))[..., 0]


def flash_attention_delta(
    o: torch.Tensor, do: torch.Tensor, dlse: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """delta [B, H, S] f32 = rowsum(f32(dO)·f32(O)), minus the lse
    cotangent when there is one (the fold ring attention needs: the
    kernels stay unchanged, only the per-row correction shifts)."""
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    if dlse is not None:
        delta = delta - dlse.float()
    return delta


def _bwd_terms(q, k, v, mask, lse, do, delta, causal, scale):
    """P = exp(scale·q·kᵀ − lse) (masked → 0) and dS = P∘(dO·Vᵀ − delta),
    both f32 [B, H, S, S]."""
    live = _visible(mask, causal, q.shape[1], q.device)
    s = _scores(q, k, scale).masked_fill(~live, BIG_NEG)
    p = torch.exp(s - lse[..., None]).masked_fill(~live, 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta[..., None])


def flash_bwd_dq_reference(q, k, v, mask, do, lse, delta, causal: bool,
                           scale: float) -> torch.Tensor:
    """Plain version of the dQ kernel: dQ = scale·dS·K, dS rounded to k's
    dtype first; dq in q's dtype."""
    _, ds = _bwd_terms(q, k, v, mask, lse, do, delta, causal, scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float())
    return (dq * scale).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, mask, do, lse, delta, causal: bool,
                            scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the dK/dV kernel: dK = scale·dSᵀ·Q (dS rounded to
    q's dtype), dV = Pᵀ·dO (P rounded to dO's dtype)."""
    p, ds = _bwd_terms(q, k, v, mask, lse, do, delta, causal, scale)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    return (dk * scale).to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor],
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    dlse: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the two backward kernels, as explicit formulas:
    P = exp(scale·q·kᵀ − lse) (masked → 0), dP = dO·Vᵀ,
    dS = P∘(dP − delta); dQ = scale·dS·K, dK = scale·dSᵀ·Q, dV = Pᵀ·dO,
    with dS rounded to k's (q's) dtype and P to dO's before the products.
    Returns (dq, dk, dv) in the input dtypes."""
    scale = default_scale(q.shape[-1]) if scale is None else scale
    delta = flash_attention_delta(o, do, dlse)
    dq = flash_bwd_dq_reference(q, k, v, mask, do, lse, delta, causal, scale)
    dk, dv = flash_bwd_dkv_reference(q, k, v, mask, do, lse, delta, causal,
                                     scale)
    return dq, dk, dv


# -- the CUDA kernels ----------------------------------------------------------


def _library():
    from kubeflow_tpu_torch.native.build import load_library

    lib = load_library("flash_attention")
    if not getattr(lib, "_kft_bound", False):
        ptr = ctypes.c_void_p
        i32 = ctypes.c_int
        tail = [i32, i32, i32, i32, i32, i32, ctypes.c_float, ptr]
        lib.kft_flash_fwd.argtypes = [ptr] * 6 + tail
        lib.kft_flash_bwd_dq.argtypes = [ptr] * 8 + tail
        lib.kft_flash_bwd_dkv.argtypes = [ptr] * 9 + tail
        for fn in (lib.kft_flash_fwd, lib.kft_flash_bwd_dq,
                   lib.kft_flash_bwd_dkv):
            fn.restype = ctypes.c_int
        lib.kft_flash_error_string.argtypes = [ctypes.c_int]
        lib.kft_flash_error_string.restype = ctypes.c_char_p
        lib._kft_bound = True
    return lib


def _check_cuda_inputs(tensors: Dict[str, torch.Tensor], mask) -> None:
    q = tensors["q"]
    if q.dim() != 4:
        raise ValueError(f"flash_attention kernel: q must be [B, S, H, D], "
                         f"got {tuple(q.shape)}")
    d = q.shape[-1]
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash_attention kernel: dtype {q.dtype} not in "
                         f"{tuple(_DTYPE_CODES)}")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention kernel: head dim {d} not in "
                         f"{SUPPORTED_HEAD_DIMS}")
    for name, t in tensors.items():
        if name in ("lse", "delta"):
            if t.dtype != torch.float32:
                raise ValueError(f"flash_attention kernel: {name} must be f32")
            continue
        if t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(
                f"flash_attention kernel: {name} is {t.dtype} "
                f"{tuple(t.shape)}, expected {q.dtype} {tuple(q.shape)}"
            )
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention kernel: {name} must be 16-byte "
                             f"aligned (TMA and the kernels' 16-byte loads "
                             f"require it)")
    every = list(tensors.values()) + ([] if mask is None else [mask])
    if any(t.device != q.device for t in every):
        raise ValueError("flash_attention kernel: inputs on different devices")
    if not all(t.is_contiguous() for t in every):
        raise ValueError("flash_attention kernel: inputs must be contiguous")
    if mask is not None and (mask.dtype != torch.int32
                             or tuple(mask.shape) != tuple(q.shape[:2])):
        raise ValueError("flash_attention kernel: mask must be int32 [B, S]")


def _raise_on(lib, err: int, name: str) -> None:
    if err != 0:
        msg = lib.kft_flash_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg}")


def _mask_ptr(mask):
    return None if mask is None else mask.data_ptr()


def flash_fwd(q, k, v, mask, causal: bool, scale: float):
    """Launch the forward kernel → (o [B, S, H, D], lse [B, H, S] f32)."""
    _check_cuda_inputs({"q": q, "k": k, "v": v}, mask)
    b, s, h, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.kft_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _mask_ptr(mask),
            o.data_ptr(), lse.data_ptr(), b, s, h, d, _DTYPE_CODES[q.dtype],
            int(causal), scale, stream,
        )
    _raise_on(lib, err, "flash_fwd")
    launch_counts["flash_fwd"] += 1
    return o, lse


def _bwd_launch(fn_name, q, k, v, mask, do, lse, delta, outs, causal, scale):
    _check_cuda_inputs({"q": q, "k": k, "v": v, "do": do, "lse": lse,
                        "delta": delta}, mask)
    b, s, h, d = q.shape
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, f"kft_{fn_name}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _mask_ptr(mask),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            *(t.data_ptr() for t in outs), b, s, h, d, _DTYPE_CODES[q.dtype],
            int(causal), scale, stream,
        )
    _raise_on(lib, err, fn_name)
    launch_counts[fn_name] += 1


def flash_bwd_dq(q, k, v, mask, do, lse, delta, causal: bool,
                 scale: float) -> torch.Tensor:
    """Launch the dQ kernel → dq."""
    dq = torch.empty_like(q)
    _bwd_launch("flash_bwd_dq", q, k, v, mask, do, lse, delta, (dq,),
                causal, scale)
    return dq


def flash_bwd_dkv(q, k, v, mask, do, lse, delta, causal: bool,
                  scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the dK/dV kernel → (dk, dv)."""
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_launch("flash_bwd_dkv", q, k, v, mask, do, lse, delta, (dk, dv),
                causal, scale)
    return dk, dv


def flash_bwd(q, k, v, mask, o, lse, do, dlse, causal: bool, scale: float):
    """The backward on the card → (dq, dk, dv): delta as a torch op (an
    XLA op outside the Pallas kernels in the JAX package), then the two
    kernels."""
    delta = flash_attention_delta(o, do, dlse)
    dq = flash_bwd_dq(q, k, v, mask, do, lse, delta, causal, scale)
    dk, dv = flash_bwd_dkv(q, k, v, mask, do, lse, delta, causal, scale)
    return dq, dk, dv


# -- autograd ------------------------------------------------------------------


class _FlashAttention(torch.autograd.Function):
    """(o, lse) with the kernels' backward; the lse cotangent, when lse
    is used, folds into delta."""

    @staticmethod
    def forward(ctx, q, k, v, mask, causal, scale):
        if q.device.type == "cuda":
            o, lse = flash_fwd(q, k, v, mask, causal, scale)
        elif q.device.type == "cpu":
            o, lse = flash_attention_reference(q, k, v, mask, causal, scale)
        else:
            raise ValueError(f"flash_attention: no kernel for {q.device}")
        ctx.save_for_backward(q, k, v, mask, o, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, mask, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        if q.device.type == "cuda":
            dq, dk, dv = flash_bwd(q, k, v, mask, o, lse, do.contiguous(),
                                   dlse, ctx.causal, ctx.scale)
        else:
            dq, dk, dv = flash_attention_bwd_reference(
                q, k, v, mask, o, lse, do, dlse, ctx.causal, ctx.scale
            )
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    causal: bool = False,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """Blockwise attention over [batch, seq, heads, head_dim] inputs.

    `mask` is a [batch, seq] key-padding mask (nonzero = attend); None
    means no padding. `scale` defaults to 1/sqrt(head_dim).
    `return_lse=True` returns (out, lse [batch, heads, seq] f32), and the
    backward carries lse's cotangent into delta. CUDA tensors launch the
    kernels (no sync, outputs allocated here) or raise; CPU tensors take
    the plain versions."""
    scale = default_scale(q.shape[-1]) if scale is None else float(scale)
    if mask is not None:
        mask = mask.to(torch.int32).contiguous()
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    o, lse = _FlashAttention.apply(q, k, v, mask, bool(causal), scale)
    return (o, lse) if return_lse else o
