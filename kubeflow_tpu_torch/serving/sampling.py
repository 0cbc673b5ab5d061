"""Sampling for every serving decode path (port of
kubeflow_tpu/serving/sampling.py: `sample_logits`, `slot_filtered_logits`,
`sample_slots`).

Composition contract (all paths): temperature scales first, top-k keeps
the k highest scaled logits, and the top-p nucleus is a prefix of the
top-k-renormalized distribution; both filters always keep the argmax.

Greedy is the exact f32 argmax (first index on ties, as in JAX). Sampled
rows draw from a torch.Generator: JAX's threefry stream cannot be
reproduced, so sampled output is held by its own determinism and its
support, never against JAX's bits. In the engine, token n of a request
is drawn with a generator seeded from (request seed, n), so a request's
stream does not depend on admission timing or slot placement.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

_NEG_INF = float("-inf")


def sample_logits(
    logits: torch.Tensor,
    generator: Optional[torch.Generator],
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
) -> torch.Tensor:
    """[B, V] logits → [B] int64 token ids with scalar knobs (the
    `generate()` path). temperature <= 0 is greedy argmax (the generator
    is unused)."""
    logits = logits.float()
    if temperature <= 0.0:
        return logits.argmax(dim=-1)
    b = logits.shape[0]
    filtered = slot_filtered_logits(
        logits,
        torch.full((b,), float(temperature), device=logits.device),
        torch.full((b,), int(top_k), device=logits.device),
        torch.full((b,), float(top_p), device=logits.device),
    )
    probs = torch.softmax(filtered, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def slot_filtered_logits(logits, temps, top_ks, top_ps):
    """[S, V] f32 logits → temperature-scaled logits with every token
    outside the per-slot top-k/top-p restriction at -inf; knobs are
    per-slot tensors. One descending sort powers both restrictions;
    top-p composes after top-k. temps <= 0 rows pass through unfiltered
    (their callers take the argmax)."""
    safe_t = torch.where(temps > 0.0, temps, torch.ones_like(temps))
    scaled = logits / safe_t[:, None]
    vocab = logits.shape[-1]
    srt = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.gather(
        srt, 1, (top_ks.clamp(1, vocab)[:, None] - 1).long()
    )
    no_k = top_ks[:, None] <= 0
    keep_k = no_k | (srt >= kth)
    keep = no_k | (scaled >= kth)
    # the sorted view of the k-masked logits is srt with the dropped tail
    # at -inf, so the one sort powers both restrictions
    srt_k = torch.where(keep_k, srt, _NEG_INF)
    probs = torch.softmax(srt_k, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # keep tokens whose EXCLUSIVE sorted prefix mass < top_p (top-1
    # always survives)
    keep_sorted = (cum - probs) < top_ps[:, None]
    thr = torch.where(keep_sorted, srt_k, float("inf")).min(
        dim=-1, keepdim=True
    ).values
    keep &= (top_ps[:, None] >= 1.0) | (scaled >= thr)
    return torch.where(keep, scaled, _NEG_INF)


def draw_seed(seed: int, counter: int) -> int:
    """The generator seed of draw `counter` of a request seeded `seed`."""
    return (int(seed) * 0x9E3779B1 + int(counter)) % (1 << 63)


def sample_slots(
    logits: torch.Tensor,
    seeds: Sequence[int],
    counters: Sequence[int],
    temps: Sequence[float],
    top_ks: Sequence[int],
    top_ps: Sequence[float],
) -> torch.Tensor:
    """[S, V] logits → [S] int64 tokens with PER-SLOT sampling knobs
    (host sequences: the engine keeps them in numpy). temps <= 0 rows are
    the greedy f32 argmax; sampled row s draws from the filtered
    distribution with a generator seeded `draw_seed(seeds[s],
    counters[s])`. While no slot samples, only the argmax runs."""
    logits = logits.float()
    out = logits.argmax(dim=-1)
    sampled = [i for i, t in enumerate(temps) if float(t) > 0.0]
    if not sampled:
        return out
    dev = logits.device
    rows = torch.as_tensor(sampled, device=dev)
    filtered = slot_filtered_logits(
        logits[rows],
        torch.as_tensor([float(temps[i]) for i in sampled], device=dev),
        torch.as_tensor([int(top_ks[i]) for i in sampled], device=dev),
        torch.as_tensor([float(top_ps[i]) for i in sampled], device=dev),
    )
    probs = torch.softmax(filtered, dim=-1)
    for j, i in enumerate(sampled):
        gen = torch.Generator(device=dev)
        gen.manual_seed(draw_seed(seeds[i], counters[i]))
        out[i] = torch.multinomial(probs[j], 1, generator=gen)[0]
    return out
