"""Sampling for every serving decode path (port of
kubeflow_tpu/serving/sampling.py: `sample_logits`, `slot_filtered_logits`,
`sample_slots`, `speculative_accept`).

Composition contract (all paths): temperature scales first, top-k keeps
the k highest scaled logits, and the top-p nucleus is a prefix of the
top-k-renormalized distribution; both filters always keep the argmax.

Greedy is the exact f32 argmax (first index on ties, as in JAX). Sampled
rows draw from a torch.Generator: JAX's threefry stream cannot be
reproduced, so sampled output is held by its own determinism and its
support, never against JAX's bits. In the engine, token n of a request
is drawn with a generator seeded from (request seed, n), so a request's
stream does not depend on admission timing or slot placement. A
speculative iteration draws at positions n..n+K on three more streams,
one per salt (the draft's proposal, the accept test, the correction),
as the JAX engine folds `fold_in(fold_in(key, n + j), salt)`: the draws
at one position are independent, and no draw is reused across
iterations.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

_NEG_INF = float("-inf")

# the speculative positions' stream salts (salt 0 is the one-token
# step's stream): the draft's proposal, the accept uniform, and the
# correction or bonus token
SALT_DRAFT, SALT_ACCEPT, SALT_CORRECT = 1, 2, 3


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


def draw_seed(seed: int, counter: int, salt: int = 0) -> int:
    """The generator seed of draw `counter` on stream `salt` of a request
    seeded `seed` (salt 0: the one-token step's stream)."""
    return ((int(seed) * 0x9E3779B1 + int(counter))
            ^ (int(salt) * 0xBF58476D1CE4E5B9)) % (1 << 63)


def draw_generator(device, seed: int, counter: int,
                   salt: int = 0) -> torch.Generator:
    """A generator on `device` at draw (seed, counter, salt)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(draw_seed(seed, counter, salt))
    return gen


def slot_probs(logits, temps, top_ks, top_ps) -> torch.Tensor:
    """[R, V] logits of sampled rows → their sampling distributions (the
    softmax of `slot_filtered_logits`); knobs are per-row sequences."""
    dev = logits.device
    return torch.softmax(slot_filtered_logits(
        logits.float(),
        torch.as_tensor([float(t) for t in temps], device=dev),
        torch.as_tensor([int(k) for k in top_ks], device=dev),
        torch.as_tensor([float(p) for p in top_ps], device=dev),
    ), dim=-1)


def sampled_rows(temps) -> list:
    """Indices of the rows that sample (temperature > 0)."""
    return [i for i, t in enumerate(temps) if float(t) > 0.0]


def sample_slots(
    logits: torch.Tensor,
    seeds: Sequence[int],
    counters: Sequence[int],
    temps: Sequence[float],
    top_ks: Sequence[int],
    top_ps: Sequence[float],
    salt: int = 0,
    with_probs: bool = False,
):
    """[S, V] logits → [S] int64 tokens with PER-SLOT sampling knobs
    (host sequences: the engine keeps them in numpy). temps <= 0 rows are
    the greedy f32 argmax; sampled row s draws from the filtered
    distribution with the generator at `draw_seed(seeds[s], counters[s],
    salt)`. While no slot samples, only the argmax runs.

    `with_probs` also returns the sampled rows' distributions ([R, V] in
    `sampled_rows(temps)` order, None when no row samples): the draft's
    q of a speculative iteration."""
    logits = logits.float()
    out = logits.argmax(dim=-1)
    sampled = sampled_rows(temps)
    probs = None
    if sampled:
        dev = logits.device
        probs = slot_probs(
            logits[torch.as_tensor(sampled, device=dev)],
            [temps[i] for i in sampled], [top_ks[i] for i in sampled],
            [top_ps[i] for i in sampled],
        )
        for j, i in enumerate(sampled):
            gen = draw_generator(dev, seeds[i], counters[i], salt)
            out[i] = torch.multinomial(probs[j], 1, generator=gen)[0]
    return (out, probs) if with_probs else out


def speculative_accept(p, q, drafted, uniforms):
    """The Leviathan/Chen rejection-sampling acceptance rule over slots
    and draft positions (port of the JAX function).

    p [S, K, V] target and q [S, K, V] draft sampling distributions at
    each position, drafted [S, K] proposals, uniforms [S, K] one U[0, 1)
    draw each. Returns (accept [S, K] bool, residual [S, K, V]): position
    j is accepted iff u·q(d) < p(d); on the first rejection the caller
    resamples from residual = normalize(max(p − q, 0)). A row whose
    residual is all zero (p == q) falls back to p."""
    idx = drafted.long()[..., None]
    p_d = torch.gather(p, -1, idx)[..., 0]
    q_d = torch.gather(q, -1, idx)[..., 0]
    accept = uniforms * q_d < p_d
    residual = torch.clamp_min(p - q, 0.0)
    total = residual.sum(dim=-1, keepdim=True)
    residual = torch.where(total > 0.0, residual / total, p)
    return accept, residual
