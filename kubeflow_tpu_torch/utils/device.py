"""Device selection for the port's entry points.

Every entry point (model construction, `generate`, `DecodeEngine`,
`build_server`) runs on the card unless the caller asks for the CPU. With
no CUDA device and no explicit `device="cpu"` they raise: the port never
quietly falls back to the CPU. A gang rank drives `cuda:<local rank>`
(`local_rank_device`).
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`device` as a torch.device, defaulting to "cuda" (with its index
    filled in, so it compares equal to a tensor's device). Raises when
    the resolved device is CUDA and no CUDA device is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU explicitly"
        )
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def local_rank_device(local_rank: int) -> torch.device:
    """The card a gang rank drives: `cuda:<local rank>`. Raises when
    CUDA is absent or the host has fewer cards than that rank needs (a
    rank never falls back to the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"gang rank with local rank {local_rank} needs a CUDA device "
            f"and none is available; run the gang with device='cpu' to "
            f"train on the CPU explicitly"
        )
    count = torch.cuda.device_count()
    if local_rank >= count:
        raise RuntimeError(
            f"local rank {local_rank} needs cuda:{local_rank}, but this "
            f"host has {count} CUDA device(s)"
        )
    return torch.device("cuda", local_rank)
