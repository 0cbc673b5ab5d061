"""Switch / GShard top-k routing with expert capacity (port of
kubeflow_tpu/parallel/moe.py).

Tokens are routed per batch row (the routing group): an f32 softmax over
the router logits [B, S, E], the top-k experts a token, and a slot in each
chosen expert's queue of `capacity` slots. Rank-0 choices take slots
before rank-1 ones (GShard priority); within a rank, queue positions
follow token order (a cumulative sum). A choice past its expert's
capacity is dropped: the residual carries the token unchanged. The
result is the one-hot dispatch tensor [B, S, E, C] and the combine tensor
(dispatch times the gate), which `models/layers.py MoeMlp` contracts
against the tokens and the expert outputs.

Gates: k = 1 uses the raw top-1 probability (Switch: the gate carries the
router's gradient); k > 1 renormalizes over the chosen experts (GShard).
The load-balance loss is E · Σ_e f_e · P_e over first choices, before
capacity (f_e the fraction of tokens whose first choice is e, P_e the
mean router probability of e): 1.0 for perfectly uniform routing.

Ties: `jax.lax.top_k` returns the lower index first among equal values.
`torch.topk` promises no order among equals, so the choices here are k
rounds of `argmax` (documented to return the first maximal index), each
masking the winner before the next.

`Routing` also carries the two sums the load-balance loss is built from
(first-choice counts and router probabilities, each summed over the
group's tokens): a data-parallel gang sums them over its ranks before
the product, because E · Σ f · P is not linear in the batch
(`load_balance_loss`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F


class Routing(NamedTuple):
    dispatch: torch.Tensor  # [B, S, E, C] f32, one-hot over (E, C) a choice
    combine: torch.Tensor   # [B, S, E, C] f32, dispatch * the choice's gate
    aux_loss: torch.Tensor  # scalar load-balance loss, E * Σ f_e P_e
    # dropped (token, choice) assignments / (tokens * k): a token losing
    # only its second choice under top-2 counts 0.5
    fraction_dropped: torch.Tensor
    first_choice: torch.Tensor  # [E] f32, tokens whose first choice is e
    prob_sum: torch.Tensor      # [E] f32, router probabilities summed


def expert_capacity(tokens_per_group: int, num_experts: int,
                    capacity_factor: float) -> int:
    """Slots an expert has in one routing group."""
    return max(1, math.ceil(tokens_per_group / num_experts * capacity_factor))


def top_k_choices(probs: torch.Tensor, k: int):
    """(values, indices) [..., k] of the k largest probabilities, largest
    first, the lower index first among equals (`jax.lax.top_k`'s order)."""
    values, indices = [], []
    masked = probs
    for _ in range(k):
        idx = masked.argmax(dim=-1, keepdim=True)
        values.append(torch.gather(probs, -1, idx))
        indices.append(idx)
        masked = masked.scatter(-1, idx, float("-inf"))
    return torch.cat(values, -1), torch.cat(indices, -1)


def assign(probs: torch.Tensor, top_i: torch.Tensor,
           capacity: int) -> Routing:
    """The routing of given choices: `probs` [B, S, E] f32 router
    probabilities, `top_i` [B, S, k] the chosen experts, rank 0 first.
    `topk_route` is `assign` of the top-k choices; a caller that must
    replay another run's choices (a teacher-forced route) passes them."""
    b, s, e = probs.shape
    k = top_i.shape[-1]
    top_p = torch.gather(probs, -1, top_i)
    if k == 1:
        # Switch: normalizing would make the gate a constant 1.0 and cut
        # the router's gradient
        gates = top_p
    else:
        gates = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    dispatch = probs.new_zeros((b, s, e, capacity))
    combine = probs.new_zeros((b, s, e, capacity))
    # per-expert slots already taken by earlier ranks, per group
    counts = probs.new_zeros((b, 1, e))
    rank0 = None
    for r in range(k):
        onehot = F.one_hot(top_i[..., r], e).to(probs.dtype)
        if r == 0:
            rank0 = onehot
        # queue position: earlier ranks' occupancy, then token order
        pos = torch.cumsum(onehot, dim=1) * onehot - 1.0 + counts
        kept = (pos >= 0) & (pos < capacity) & (onehot > 0)
        slot = F.one_hot(pos.clamp(0, capacity - 1).long(), capacity)
        dispatch_r = slot.to(probs.dtype) * kept[..., None].to(probs.dtype)
        dispatch = dispatch + dispatch_r
        combine = combine + dispatch_r * gates[..., r][..., None, None]
        counts = counts + kept.to(probs.dtype).sum(dim=1, keepdim=True)
    # load balance over first choices, before capacity
    f = rank0.mean(dim=(0, 1))
    p = probs.mean(dim=(0, 1))
    aux_loss = e * torch.sum(f * p)
    wanted = float(b * s * k)
    fraction_dropped = 1.0 - dispatch.sum() / max(wanted, 1.0)
    return Routing(dispatch, combine, aux_loss, fraction_dropped,
                   rank0.sum(dim=(0, 1)), probs.sum(dim=(0, 1)))


def topk_route(router_logits: torch.Tensor, capacity: int,
               k: int = 1) -> Routing:
    """Top-k routing with per-group capacity (k = 1 Switch, k = 2 GShard)
    of router_logits [B, S, E] (any float dtype; the softmax runs in
    f32). Deterministic: the ties and the queue order are fixed."""
    num_experts = router_logits.shape[-1]
    if not 1 <= k <= num_experts:
        raise ValueError(f"k={k} must be in [1, {num_experts}]")
    probs = torch.softmax(router_logits.float(), dim=-1)
    _, top_i = top_k_choices(probs, k)
    return assign(probs, top_i, capacity)


def switch_route(router_logits: torch.Tensor, capacity: int) -> Routing:
    """Top-1 (Switch) routing: the k = 1 case of `topk_route`."""
    return topk_route(router_logits, capacity, k=1)


def load_balance_loss(first_choice: torch.Tensor, prob_sum: torch.Tensor,
                      tokens, num_experts: int) -> torch.Tensor:
    """E · Σ_e f_e · P_e from the sums `Routing` carries (summed over as
    many groups, or ranks, as the batch spans) and their token count:
    the batch-wide `aux_loss`, whatever the batch's split. Leading axes
    (one a layer) stay: [..., E] sums give [...] losses."""
    f = first_choice / tokens
    p = prob_sum / tokens
    return num_experts * (f * p).sum(-1)
