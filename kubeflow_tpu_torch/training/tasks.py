"""Task adapter and optimizer (port of the causal-LM parts of
kubeflow_tpu/training/tasks.py): `cross_entropy`, `CausalLmTask` (the
full-logits and the chunked-head losses), `task_for_model` and the
optimizer.

The JAX package's `optax.chain(clip_by_global_norm(1.0),
adamw(warmup_cosine_decay_schedule(...), weight_decay=wd))` is three
pieces here, which the trainer applies in that order:
`clip_by_global_norm`, `make_schedule` and `make_optimizer`.
`torch.optim.AdamW(eps=1e-8, weight_decay=wd)` is optax.adamw's
arithmetic (b1 0.9, b2 0.999, eps outside the sqrt, decoupled decay on
every leaf times the lr); the schedule is a function of the update count,
evaluated at the count BEFORE the update as optax does (so the first
update runs at lr = schedule(0) = 0); `clip_by_global_norm` is optax's
formula (scale by max_norm / norm only when norm >= max_norm).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from kubeflow_tpu_torch.config.platform import TrainingConfig
from kubeflow_tpu_torch.training.data import SyntheticData

IGNORE = -100


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore: int = -1000000) -> torch.Tensor:
    """Mean CE over labels != ignore; logits float32 [..., C], labels int."""
    valid = labels != ignore
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logp = F.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, safe[..., None])[..., 0]
    ll = torch.where(valid, ll, torch.zeros_like(ll))
    count = valid.sum().clamp_min(1)
    return -ll.sum() / count


def _chunk_nll_sum(h_c, t_c, kernel, compute_dtype):
    """Sum of -log p(target) over one chunk's valid positions."""
    logits = (h_c.to(compute_dtype) @ kernel).float()
    valid = t_c != IGNORE
    safe = torch.where(valid, t_c, torch.zeros_like(t_c))
    logp = F.log_softmax(logits, dim=-1)
    ll = torch.gather(logp, -1, safe[..., None])[..., 0]
    return -torch.where(valid, ll, torch.zeros_like(ll)).sum()


class CausalLmTask:
    """Decoder-only pretrain: next-token cross-entropy over the sequence."""

    name = "lm"

    def __init__(self, cfg: TrainingConfig, seq_len: int = 1024,
                 vocab_size: int = 50257, loss_chunk: Optional[int] = None):
        self.cfg = cfg
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        # loss_chunk > 0 streams the LM head + cross-entropy over sequence
        # chunks of that many positions, each recomputed in the backward,
        # so the [B, S, V] logits never materialize
        self.loss_chunk = cfg.loss_chunk if loss_chunk is None else loss_chunk
        # masks known all-ones (packed pretrain): the model gets None, so
        # the flash kernel runs unmasked
        self.assume_full_attention = bool(cfg.assume_full_attention)

    def synthetic_data(self, batch_size: Optional[int] = None) -> SyntheticData:
        return SyntheticData(
            "lm", batch_size or self.cfg.global_batch_size, seed=self.cfg.seed,
            seq_len=self.seq_len, vocab_size=self.vocab_size,
        )

    @staticmethod
    def _shift(logits, input_ids, attention_mask):
        """Next-token pairs: logits[:, :-1] predict input_ids[:, 1:]; a
        pair counts only when both ends are real tokens."""
        targets = input_ids[:, 1:]
        valid = (attention_mask[:, 1:] != 0) & (attention_mask[:, :-1] != 0)
        return logits[:, :-1], torch.where(
            valid, targets, torch.full_like(targets, IGNORE)
        )

    @staticmethod
    def _shift_full(input_ids, attention_mask):
        """Full-length targets [B, S]: position i predicts ids[i+1], the
        final position is always ignored (same validity rule as _shift)."""
        b = input_ids.shape[0]
        pad = torch.full((b, 1), IGNORE, dtype=input_ids.dtype,
                         device=input_ids.device)
        targets = torch.cat([input_ids[:, 1:], pad], dim=1)
        valid = torch.cat([
            (attention_mask[:, 1:] != 0) & (attention_mask[:, :-1] != 0),
            torch.zeros((b, 1), dtype=torch.bool, device=input_ids.device),
        ], dim=1)
        return torch.where(valid, targets, torch.full_like(targets, IGNORE))

    @staticmethod
    def _chunked_lm_loss(head_kernel, hidden, targets, chunk: int,
                         compute_dtype) -> Tuple[torch.Tensor, torch.Tensor]:
        """Streamed LM head + CE: each sequence chunk's [B, chunk, V]
        logits live only inside its chunk and are recomputed in the
        backward (`torch.utils.checkpoint`, the JAX `jax.checkpoint`).
        Returns (mean loss, valid count)."""
        s = hidden.shape[1]
        kernel = head_kernel.to(compute_dtype)
        total = hidden.new_zeros((), dtype=torch.float32)
        grad = torch.is_grad_enabled()
        for c0 in range(0, s, chunk):
            h_c, t_c = hidden[:, c0:c0 + chunk], targets[:, c0:c0 + chunk]
            if grad:
                part = checkpoint(_chunk_nll_sum, h_c, t_c, kernel,
                                  compute_dtype, use_reentrant=False)
            else:
                part = _chunk_nll_sum(h_c, t_c, kernel, compute_dtype)
            total = total + part
        count = (targets != IGNORE).sum()
        return total / count.clamp_min(1), count

    def loss(self, model, batch: Dict[str, torch.Tensor]):
        """(loss, {"aux": {}, "loss_items": valid pairs as f32})."""
        chunked = self.loss_chunk and self.loss_chunk > 0
        ids, mask = batch["input_ids"], batch["attention_mask"]
        out = model(ids, attention_mask=None if self.assume_full_attention
                    else mask, return_hidden=bool(chunked))
        if chunked:
            targets = self._shift_full(ids, mask)
            loss, n_items = self._chunked_lm_loss(
                model.head.kernel, out, targets, int(self.loss_chunk),
                model.cfg.dtype,
            )
        else:
            logits, targets = self._shift(out, ids, mask)
            loss = cross_entropy(logits, targets, ignore=IGNORE)
            n_items = (targets != IGNORE).sum()
        return loss, {"aux": {}, "loss_items": n_items.float()}

    def count_items(self, batch) -> int:
        return batch["input_ids"].shape[0] * batch["input_ids"].shape[1]


def task_for_model(model_name: str, cfg: TrainingConfig, **kwargs):
    if model_name.startswith("gpt"):
        return CausalLmTask(cfg, **kwargs)
    raise KeyError(
        f"no task adapter for model {model_name!r} in the port (only the "
        f"GPT family; ROADMAP A13 item 6)"
    )


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule: linear warmup from init to
    peak over `warmup_steps`, then cosine decay to end_value at
    `decay_steps` (which includes the warmup)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed warmup_steps "
                         f"{warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, cos_steps)
        decay = 0.5 * (1 + math.cos(math.pi * t / cos_steps))
        return peak_value * ((1 - alpha) * decay + alpha)

    return schedule


def clip_by_global_norm(grads: Iterable[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm, in place: g ← g / norm · max_norm when
    the global norm is >= max_norm, else unchanged. No host sync.
    Returns the global norm (before clipping)."""
    grads = [g for g in grads if g is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads])
    )
    trigger = norm < max_norm
    for g in grads:
        g.copy_(torch.where(trigger, g, g / norm * max_norm))
    return norm


def make_schedule(cfg: TrainingConfig) -> Callable[[int], float]:
    """The lr schedule of every recipe: linear warmup from 0, cosine decay
    to 1 % of the peak at cfg.steps."""
    return warmup_cosine_decay_schedule(
        init_value=0.0,
        peak_value=cfg.learning_rate,
        warmup_steps=max(1, cfg.warmup_steps),
        decay_steps=max(cfg.steps, cfg.warmup_steps + 1),
        end_value=cfg.learning_rate * 0.01,
    )


def make_optimizer(cfg: TrainingConfig, model_name: str,
                   params: Iterable[torch.nn.Parameter]) -> torch.optim.AdamW:
    """AdamW over `params`: the JAX package's transformer recipe. The
    caller sets each update's lr to make_schedule(cfg)(updates done so
    far) before `step()` and clips the gradients first."""
    if model_name.startswith("resnet"):
        raise KeyError("the SGD-momentum convnet recipe is not ported yet "
                       "(ROADMAP A13 item 6)")
    return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=cfg.weight_decay)
