"""Task adapters and optimizers (port of kubeflow_tpu/training/tasks.py):
`cross_entropy` (with label smoothing), `ImageClassificationTask`
(ResNet and the mlp), `MlmTask` (BERT's masked-LM + next-sentence
pretraining), `CausalLmTask` (the full-logits and the chunked-head
losses), the shared eval statistics of the two LM tasks,
`task_for_model` and the two optimizer recipes.

A task whose model has dropout takes the step's `dropout_generator` in
its `loss` and hands it to the model (training/trainer.py makes one a
step, or one a microbatch, from (seed, step)).

MoE models (`num_experts > 0`): the LM tasks pass a `MoeCollector`
down the forward and add the layers' summed weighted load-balance loss
to the task loss, reporting it as `aux["moe_aux_loss"]` (the JAX tasks'
sown "losses"). In a data-parallel gang the loss is the global batch's:
each layer's first-choice counts and router probability sums are summed
over the step's `group` (data × sequence at the rank's expert
coordinate) before the product (`MoeCollector.aux_loss`), and each rank
adds its 1/|group| share, so the group's losses sum to the global loss
and their summed gradients are its gradient. The expert ranks of one
data shard route alike and compute the same loss: none of them is
summed over the expert axis.

Data parallelism: the JAX step computes each loss over the GLOBAL batch
(GSPMD), so each of its means divides by a global count. A task's
`item_counts(batch)` gives the denominators of its loss from the batch
alone (the causal LM's valid next-token pairs; MLM's masked positions
and its rows; the image count), the trainer sums them over the data
group before the backward, and `loss(..., counts=)` divides this rank's
sums by them: the ranks' losses then sum to the global loss, and their
summed gradients are its gradient. A mean of per-rank means (DDP's
average) would be another gradient wherever ranks hold different
counts (ragged masks, MLM's random 15 %).

Sequence parallelism: a rank holds a shard of each sequence's columns
(training/data.py `shard_columns`) and the trainer sums the counts over
data × sequence. The causal LM's next-token pairs include the one that
crosses into the next shard, whose target is the batch's lookahead
column (`next_input_ids`, `next_attention_mask`), so the pairs of all
shards are the unsharded sequence's; the streamed head runs over the
local shard. MLM counts its masked positions on every shard and the
next-sentence rows on sequence rank 0 only, which alone holds [CLS]
(`parallel/mesh.py active_sequence()`, set by the step).

Tensor parallelism: the tensor ranks of a data shard see the same rows
and the trainer sums the counts over data alone. A vocab-split head
(`mlm_out`, or the LM head where the axis divides the vocabulary) gives
this rank's columns of the logits: the cross-entropy (label smoothing
included), the chunked LM loss and the eval top-1 are taken over the
tensor group (`_log_likelihood`, `_argmax`; parallel/distributed.py
`vocab_parallel_terms`), and the hidden states enter the head's columns
through `copy_to_group` once.

Pipeline parallelism: a stage's forward is the model's own (training/
trainer.py runs the schedule); the LM tasks give the parts it needs:
`model_mask` (what the model's attention takes), `head_loss` (the last
stage's loss from its hidden states, divided by the global counts of
the whole accumulation microbatch, so the pipeline microbatches' losses
sum to the batch's), `head_eval_stats`, and `loss_weight` (a
microbatch's weight under accumulation, known before its forward).
`moe_aux_share` is each stage's MoE load-balance loss over its own
layers' calls.

The convnet recipe (`resnet*`), `optax.chain(add_decayed_weights(wd),
sgd(schedule, momentum=0.9, nesterov=True))`, is `torch.optim.SGD(
momentum=0.9, nesterov=True, dampening=0, weight_decay=wd)`: optax's
trace t = g + 0.9·t and update g + 0.9·t over g + wd·p are torch's
buffer and nesterov step, and its first trace (from zeros) is torch's
first buffer (the gradient). It has no gradient clip.

The transformer recipe (every other model), `optax.chain(
clip_by_global_norm(1.0), adamw(warmup_cosine_decay_schedule(...),
weight_decay=wd))`, is three pieces here, which the trainer applies in
that order: `clip_by_global_norm`, `make_schedule` and `make_optimizer`.
`torch.optim.AdamW(eps=1e-8, weight_decay=wd)` is optax.adamw's
arithmetic (b1 0.9, b2 0.999, eps outside the sqrt, decoupled decay on
every leaf times the lr); the schedule is a function of the update count,
evaluated at the count BEFORE the update as optax does (so the first
update runs at lr = schedule(0) = 0); `clip_by_global_norm` is optax's
formula (scale by max_norm / norm only when norm >= max_norm). Both
recipes set each update's lr to `make_schedule(cfg)(updates done)` before
`step()`.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from kubeflow_tpu_torch.config.platform import TrainingConfig
from kubeflow_tpu_torch.models.layers import (
    MoeCollector,
    at_use,
    tensor_copy,
    vocab_shard,
)
from kubeflow_tpu_torch.parallel.distributed import (
    all_reduce_max,
    vocab_parallel_terms,
)
from kubeflow_tpu_torch.parallel.mesh import active_sequence
from kubeflow_tpu_torch.training.data import NEXT, SyntheticData

IGNORE = -100


def _log_likelihood(logits: torch.Tensor, labels: torch.Tensor,
                    label_smoothing: float = 0.0, vocab=None
                    ) -> torch.Tensor:
    """Per-position log p(label) (labels in range), with label smoothing
    ε: (1-ε)·log p(label) + ε·mean over classes of log p. `vocab` (a
    vocab-split head's (TensorShard, first column): models/layers.py
    `vocab_shard`) makes `logits` this rank's columns of the row, and
    the log-normalizer, the label's logit and the row's sum are taken
    over the tensor group (`vocab_parallel_terms`); None: the whole
    row's log-softmax."""
    if vocab is None:
        logp = F.log_softmax(logits, dim=-1)
        ll = torch.gather(logp, -1, labels[..., None])[..., 0]
        if label_smoothing:
            ll = (1.0 - label_smoothing) * ll + label_smoothing * logp.mean(-1)
        return ll
    shard, first = vocab
    lse, picked, *rest = vocab_parallel_terms(
        logits, labels, first, shard.group, shard.counts,
        with_sum=bool(label_smoothing))
    ll = picked - lse
    if label_smoothing:
        mean = rest[0] / (logits.shape[-1] * shard.size) - lse
        ll = (1.0 - label_smoothing) * ll + label_smoothing * mean
    return ll


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore: int = -1000000,
                  label_smoothing: float = 0.0,
                  count: Optional[torch.Tensor] = None,
                  vocab=None) -> torch.Tensor:
    """Mean CE over labels != ignore; logits float32 [..., C], labels int.
    With label_smoothing ε the target is (1-ε)·onehot + ε/K uniform:
    loss = (1-ε)·NLL + ε·mean over classes of -log p. `count` replaces
    the denominator (the valid labels here) with a given one, such as
    the global batch's. `vocab`: the logits are this rank's columns of a
    vocab-split head (`_log_likelihood`)."""
    valid = labels != ignore
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    ll = _log_likelihood(logits, safe, label_smoothing, vocab)
    ll = torch.where(valid, ll, torch.zeros_like(ll))
    if count is None:
        count = valid.sum()
    return -ll.sum() / count.clamp_min(1)


def _nll(logits: torch.Tensor, labels: torch.Tensor,
         vocab=None) -> torch.Tensor:
    """Per-position negative log-likelihood (no reduction); `vocab` as in
    `cross_entropy`."""
    return -_log_likelihood(logits, labels, vocab=vocab)


def _argmax(logits: torch.Tensor, vocab=None) -> torch.Tensor:
    """The row's argmax; over a vocab-split head's columns (`vocab`) the
    whole row's: the lowest column holding the group's max."""
    if vocab is None:
        return logits.argmax(-1)
    shard, first = vocab
    best, idx = logits.max(-1)
    top = all_reduce_max(best, shard.group, shard.counts)
    whole = logits.shape[-1] * shard.size
    mine = torch.where(best == top, idx + first, torch.full_like(idx, whole))
    return -all_reduce_max(-mine, shard.group, shard.counts)


def _masked_token_stats(logits: torch.Tensor, labels: torch.Tensor,
                        row_valid: torch.Tensor, ignore: int, vocab=None
                        ) -> Dict[str, torch.Tensor]:
    """Summable eval statistics over labels != ignore (the MLM and
    causal-LM tasks'): top-1 numerator and denominator and the loss sum,
    with `row_valid` masking the padded rows of a ragged final batch;
    `vocab` as in `cross_entropy` (the top-1 across the shards)."""
    valid = (labels != ignore).float() * row_valid.float()[:, None]
    safe = torch.where(labels == ignore, torch.zeros_like(labels), labels)
    logits = logits.float()
    correct = ((_argmax(logits, vocab) == safe).float() * valid).sum()
    loss_sum = (_nll(logits, safe, vocab) * valid).sum()
    return {"correct": correct, "count": valid.sum(), "loss_sum": loss_sum}


def _vocab(model, head: str):
    """The model's `head` module's vocab split (models/layers.py
    `vocab_shard`), None when its logits are whole."""
    return vocab_shard(getattr(model, head, None))


def _row_valid(batch: Dict[str, torch.Tensor], rows: int,
               device) -> torch.Tensor:
    """The batch's `eval_mask` (real rows of a padded final batch), or
    every row."""
    valid = batch.get("eval_mask")
    return valid if valid is not None else torch.ones(rows, device=device)


def _moe_collector(model) -> Optional[MoeCollector]:
    """A collector for a model with routed layers, else None."""
    routed = getattr(getattr(model, "cfg", None), "num_experts", 0) > 0
    return MoeCollector() if routed else None


def moe_aux_share(collector: Optional[MoeCollector], group
                  ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """(this rank's share of the MoE load-balance loss of the
    collector's layers, the global value detached), or None without
    routed layers: the whole loss without a group, else 1/|group| of the
    group's global loss."""
    moe_aux = None if collector is None else collector.aux_loss(group)
    if moe_aux is None:
        return None
    value = moe_aux.detach()
    if group is not None:
        moe_aux = moe_aux / torch.distributed.get_world_size(group)
    return moe_aux, value


def _add_moe_aux(loss: torch.Tensor, aux: Dict[str, torch.Tensor],
                 collector: Optional[MoeCollector], group) -> torch.Tensor:
    """loss + this rank's share of the MoE load-balance loss (the whole
    of it without a group); the global value lands in
    aux["moe_aux_loss"]."""
    share = moe_aux_share(collector, group)
    if share is None:
        return loss
    aux["moe_aux_loss"] = share[1]
    return loss + share[0]


class ImageClassificationTask:
    """ResNet and the mlp: batch {image [B, H, W, 3], label [B]}; the
    model's BatchNorm running averages move in its training forward."""

    name = "image"

    def __init__(self, cfg: TrainingConfig, image_size: int = 224,
                 num_classes: int = 1000):
        self.cfg = cfg
        self.image_size = image_size
        self.num_classes = num_classes

    def synthetic_data(self, batch_size: Optional[int] = None) -> SyntheticData:
        return SyntheticData(
            "image", batch_size or self.cfg.global_batch_size,
            seed=self.cfg.seed, image_size=self.image_size,
            num_classes=self.num_classes,
        )

    def augment_batch(self, batch: Dict[str, torch.Tensor], step: int,
                      rows: Optional[np.ndarray] = None
                      ) -> Dict[str, torch.Tensor]:
        """The training augmentation of the batch of update `step`: a
        pure function of (cfg.seed, step, image index), on the batch's
        device (training/augment.py); "none" returns it unchanged. `rows`
        are the images' indices in the global batch (a data-parallel
        rank's share), default 0..B-1."""
        from kubeflow_tpu_torch.training.augment import augment_image_batch

        return augment_image_batch(batch, self.cfg.data.augment,
                                   self.cfg.seed, step, rows=rows)

    def item_counts(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """[images]: the loss's denominator, f32 on the batch's device."""
        labels = batch["label"]
        return torch.full((1,), float(labels.shape[0]), device=labels.device)

    def loss(self, model, batch: Dict[str, torch.Tensor], train: bool = True,
             counts: Optional[torch.Tensor] = None, group=None):
        """(loss, {"aux": {"accuracy"}}); label smoothing in training only.
        The caller augments a training batch first (`augment_batch`).
        `counts` (`item_counts` summed over the data group) divides this
        rank's sum instead of its own count; `group` (the data group) is
        unused: an image model has no routed layers."""
        logits = model(batch["image"], train=train)
        labels = batch["label"]
        loss = cross_entropy(
            logits, labels,
            label_smoothing=self.cfg.label_smoothing if train else 0.0,
            count=None if counts is None else counts[0],
        )
        acc = (logits.argmax(-1) == labels).float().mean()
        return loss, {"aux": {"accuracy": acc.detach()}}

    def count_items(self, batch) -> int:
        return batch["image"].shape[0]

    def eval_stats(self, model, batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """Summable eval statistics of one batch (top-1 numerator and
        denominator, loss sum); `eval_mask` marks the real rows of a
        padded final batch."""
        logits = model(batch["image"], train=False).float()
        labels = batch["label"]
        valid = _row_valid(batch, labels.shape[0], logits.device)
        correct = ((logits.argmax(-1) == labels).float() * valid).sum()
        loss_sum = (_nll(logits, labels) * valid).sum()
        return {"correct": correct, "count": valid.sum(), "loss_sum": loss_sum}


class MlmTask:
    """BERT pretrain: masked-LM + next-sentence losses. Batch
    {input_ids, attention_mask, labels (-100 off the masked positions),
    nsp_labels}."""

    name = "mlm"

    def __init__(self, cfg: TrainingConfig, seq_len: int = 128,
                 vocab_size: int = 30522):
        self.cfg = cfg
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        # the causal-LM task's contract: a packed batch's all-ones mask
        # is not passed, so the flash kernel runs unmasked
        self.assume_full_attention = bool(cfg.assume_full_attention)

    def synthetic_data(self, batch_size: Optional[int] = None) -> SyntheticData:
        return SyntheticData(
            "mlm", batch_size or self.cfg.global_batch_size,
            seed=self.cfg.seed, seq_len=self.seq_len,
            vocab_size=self.vocab_size,
        )

    def item_counts(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """[masked positions, rows]: the two denominators of the loss
        (the rows on sequence rank 0 alone under a sequence axis)."""
        labels = batch["labels"]
        rows = float(labels.shape[0]) if _holds_cls() else 0.0
        return torch.stack([(labels != IGNORE).sum().float(),
                            labels.new_tensor(rows, dtype=torch.float32)])

    def loss(self, model, batch: Dict[str, torch.Tensor],
             dropout_generator: Optional[torch.Generator] = None,
             counts: Optional[torch.Tensor] = None, group=None):
        """(mlm + nsp [+ MoE aux], {"aux": {mlm_loss, nsp_loss[,
        moe_aux_loss]}, "loss_items": 1}). The JAX task reports no item
        count (the loss mixes two denominators, masked tokens and rows),
        so the trainer weighs its microbatches equally, as the JAX
        trainer does. `counts` (summed `item_counts`) divides the two
        sums instead of their own counts; `group` is the data group an
        MoE model's load-balance loss is summed over."""
        moe = _moe_collector(model)
        out = model(
            batch["input_ids"], attention_mask=self.model_mask(batch),
            dropout_generator=dropout_generator,
            **({} if moe is None else {"moe": moe}),
        )
        loss, extra = self._head_loss(model, out, batch, counts)
        loss = _add_moe_aux(loss, extra["aux"], moe, group)
        return loss, extra

    def model_mask(self, batch: Dict[str, torch.Tensor]
                   ) -> Optional[torch.Tensor]:
        """The attention mask the model takes (None: all ones)."""
        return None if self.assume_full_attention else batch["attention_mask"]

    def loss_weight(self, counts: torch.Tensor) -> torch.Tensor:
        """A microbatch's weight under accumulation: equal (`loss`)."""
        return torch.ones((), device=counts.device)

    def _head_loss(self, model, out, batch, counts):
        # a vocab-split `mlm_out` gives this rank's columns of the logits
        mlm = cross_entropy(out["mlm_logits"], batch["labels"], ignore=IGNORE,
                            count=None if counts is None else counts[0],
                            vocab=_vocab(model, "mlm_out"))
        if _holds_cls():
            nsp = cross_entropy(out["nsp_logits"], batch["nsp_labels"],
                                count=None if counts is None else counts[1])
        else:  # another shard's row 0 is not [CLS]
            nsp = torch.zeros((), device=mlm.device)
        aux = {"mlm_loss": mlm.detach(), "nsp_loss": nsp.detach()}
        return mlm + nsp, {"aux": aux,
                           "loss_items": torch.ones((), device=mlm.device)}

    def head_loss(self, model, hidden: torch.Tensor,
                  batch: Dict[str, torch.Tensor],
                  counts: Optional[torch.Tensor] = None):
        """The last pipeline stage's loss: the heads on its final hidden
        states, (mlm + nsp, `loss`'s extras) without the MoE aux."""
        return self._head_loss(model, model.heads(hidden), batch, counts)

    def count_items(self, batch) -> int:
        # tokens a step: BERT's throughput unit
        return batch["input_ids"].shape[0] * batch["input_ids"].shape[1]

    def eval_stats(self, model, batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """Masked-token top-1 and loss over labels != -100."""
        out = model(batch["input_ids"], attention_mask=batch["attention_mask"])
        return self._stats(model, out, batch)

    def head_eval_stats(self, model, hidden: torch.Tensor,
                        batch: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
        """`eval_stats` from the last pipeline stage's hidden states."""
        return self._stats(model, model.heads(hidden), batch)

    def _stats(self, model, out, batch):
        labels = batch["labels"]
        return _masked_token_stats(
            out["mlm_logits"], labels,
            _row_valid(batch, labels.shape[0], labels.device), IGNORE,
            _vocab(model, "mlm_out"))


def _holds_cls() -> bool:
    """Whether this rank's shard holds each sequence's first position."""
    seq = active_sequence()
    return seq is None or seq.rank == 0


def _extended(batch: Dict[str, torch.Tensor]):
    """(ids, mask) with the lookahead column appended when the batch is
    a sequence shard's; else the batch's own."""
    ids, mask = batch["input_ids"], batch["attention_mask"]
    if NEXT + "input_ids" not in batch:
        return ids, mask
    return (torch.cat([ids, batch[NEXT + "input_ids"]], 1),
            torch.cat([mask, batch[NEXT + "attention_mask"]], 1))


def _chunk_nll_sum(h_c, t_c, kernel, compute_dtype, vocab=None):
    """Sum of -log p(target) over one chunk's valid positions (`vocab`:
    the kernel is this rank's vocab columns, as in `cross_entropy`)."""
    logits = (h_c.to(compute_dtype) @ kernel).float()
    valid = t_c != IGNORE
    safe = torch.where(valid, t_c, torch.zeros_like(t_c))
    ll = _log_likelihood(logits, safe, vocab=vocab)
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
    def _shard_targets(batch):
        """A sequence shard's targets [B, s]: position i predicts column
        i + 1 of the ids extended by the lookahead column, so the last
        position predicts the next shard's first token (the last shard's
        lookahead column is masked: no pair)."""
        ids, mask = _extended(batch)
        valid = (mask[:, 1:] != 0) & (mask[:, :-1] != 0)
        return torch.where(valid, ids[:, 1:], torch.full_like(ids[:, 1:],
                                                              IGNORE))

    @staticmethod
    def _chunked_lm_loss(head_kernel, hidden, targets, chunk: int,
                         compute_dtype, count: Optional[torch.Tensor] = None,
                         vocab=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Streamed LM head + CE: each sequence chunk's [B, chunk, V]
        logits live only inside its chunk and are recomputed in the
        backward (`torch.utils.checkpoint`, the JAX `jax.checkpoint`).
        Returns (mean loss, valid count); `count` replaces the
        denominator. `vocab`: `head_kernel` is this rank's columns of a
        vocab-split head, each chunk's loss vocab-parallel (its
        collectives run again in the recompute)."""
        s = hidden.shape[1]
        kernel = head_kernel.to(compute_dtype)
        total = hidden.new_zeros((), dtype=torch.float32)
        grad = torch.is_grad_enabled()
        for c0 in range(0, s, chunk):
            h_c, t_c = hidden[:, c0:c0 + chunk], targets[:, c0:c0 + chunk]
            if grad:
                part = checkpoint(_chunk_nll_sum, h_c, t_c, kernel,
                                  compute_dtype, vocab, use_reentrant=False)
            else:
                part = _chunk_nll_sum(h_c, t_c, kernel, compute_dtype, vocab)
            total = total + part
        if count is None:
            count = (targets != IGNORE).sum()
        return total / count.clamp_min(1), count

    def item_counts(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """[valid next-token pairs]: the loss's denominator, f32 (a
        sequence shard's include the pair into the next shard)."""
        _, mask = _extended(batch)
        valid = (mask[:, 1:] != 0) & (mask[:, :-1] != 0)
        return valid.sum().float().reshape(1)

    def loss(self, model, batch: Dict[str, torch.Tensor],
             dropout_generator: Optional[torch.Generator] = None,
             counts: Optional[torch.Tensor] = None, group=None):
        """(loss [+ MoE aux], {"aux": {[moe_aux_loss]}, "loss_items":
        valid pairs as f32}). `counts` (summed `item_counts`) is the
        denominator, and the item count reported, in place of this
        batch's own; `group` is the data group an MoE model's
        load-balance loss is summed over."""
        moe = _moe_collector(model)
        out = model(batch["input_ids"], attention_mask=self.model_mask(batch),
                    return_hidden=self._chunked(),
                    dropout_generator=dropout_generator,
                    **({} if moe is None else {"moe": moe}))
        loss, extra = self._head_loss(model, out, batch, counts)
        loss = _add_moe_aux(loss, extra["aux"], moe, group)
        return loss, extra

    def _chunked(self) -> bool:
        return bool(self.loss_chunk and self.loss_chunk > 0)

    def model_mask(self, batch: Dict[str, torch.Tensor]
                   ) -> Optional[torch.Tensor]:
        """The attention mask the model takes (None: all ones)."""
        return None if self.assume_full_attention else batch["attention_mask"]

    def loss_weight(self, counts: torch.Tensor) -> torch.Tensor:
        """A microbatch's weight under accumulation: its (global) valid
        pairs, `loss`'s item count."""
        return counts[0].float()

    def head_loss(self, model, hidden: torch.Tensor,
                  batch: Dict[str, torch.Tensor],
                  counts: Optional[torch.Tensor] = None):
        """The last pipeline stage's loss from its final hidden states
        (ln_final, then the streamed or the full head): `loss` without
        the MoE aux."""
        out = model.finish(hidden, return_hidden=self._chunked())
        return self._head_loss(model, out, batch, counts)

    def _head_loss(self, model, out, batch, counts):
        chunked = self._chunked()
        ids, mask = batch["input_ids"], batch["attention_mask"]
        count = None if counts is None else counts[0]
        sharded = NEXT + "input_ids" in batch
        # a vocab-split head's logits are this rank's columns
        vocab = _vocab(model, "head")
        if chunked:
            targets = (self._shard_targets(batch) if sharded
                       else self._shift_full(ids, mask))
            # the head's kernel as its use reads it (an fsdp block gathered
            # once; every chunk reads the one cast), the hidden states
            # entering a vocab-split head's columns once
            loss, n_items = self._chunked_lm_loss(
                at_use(model.head, "kernel", model.cfg.dtype),
                tensor_copy(model.head, out), targets,
                int(self.loss_chunk), model.cfg.dtype, count, vocab,
            )
        else:
            logits, targets = ((out, self._shard_targets(batch)) if sharded
                               else self._shift(out, ids, mask))
            loss = cross_entropy(logits, targets, ignore=IGNORE, count=count,
                                 vocab=vocab)
            n_items = (targets != IGNORE).sum() if count is None else count
        return loss, {"aux": {}, "loss_items": n_items.float()}

    def count_items(self, batch) -> int:
        return batch["input_ids"].shape[0] * batch["input_ids"].shape[1]

    def eval_stats(self, model, batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """Next-token top-1 and loss over the valid pairs (a sequence
        shard's include the pair into the next shard)."""
        logits = model(batch["input_ids"],
                       attention_mask=batch["attention_mask"])
        return self._stats(model, logits, batch)

    def head_eval_stats(self, model, hidden: torch.Tensor,
                        batch: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
        """`eval_stats` from the last pipeline stage's hidden states."""
        return self._stats(model, model.finish(hidden), batch)

    def _stats(self, model, logits, batch):
        ids, mask = batch["input_ids"], batch["attention_mask"]
        if NEXT + "input_ids" in batch:
            targets = self._shard_targets(batch)
        else:
            logits, targets = self._shift(logits, ids, mask)
        return _masked_token_stats(
            logits, targets, _row_valid(batch, targets.shape[0], ids.device),
            IGNORE, _vocab(model, "head"))


def task_for_model(model_name: str, cfg: TrainingConfig, **kwargs):
    if model_name.startswith("resnet"):
        return ImageClassificationTask(cfg, **kwargs)
    if model_name.startswith("bert"):
        return MlmTask(cfg, **kwargs)
    if model_name.startswith("gpt"):
        return CausalLmTask(cfg, **kwargs)
    if model_name.startswith("mlp"):
        kwargs.setdefault("image_size", 8)
        kwargs.setdefault("num_classes", 10)
        return ImageClassificationTask(cfg, **kwargs)
    raise KeyError(f"no task adapter for model {model_name!r}")


def uses_sgd(model_name: str) -> bool:
    """The convnet recipe (SGD-momentum, no clip) or the transformer one
    (clipped AdamW)."""
    return model_name.startswith("resnet")


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


def clip_by_global_norm(grads: Iterable[torch.Tensor], max_norm: float,
                        sharded: Iterable[torch.Tensor] = (),
                        group=None, stage_group=None) -> torch.Tensor:
    """optax.clip_by_global_norm, in place: g ← g / norm · max_norm when
    the global norm is >= max_norm, else unchanged. No host sync.
    Returns the global norm (before clipping). `sharded` are the
    gradients of this rank's blocks of leaves split over `group` (an
    expert stack's over the expert axis, an fsdp leaf's over the fsdp
    axis): their squared norms are summed
    over the group, and every other leaf counts once, so every rank
    clips at the whole state's norm and the replicas stay equal. With
    `stage_group` (the pipeline axis's) each rank holds only its stage's
    leaves: the squared norms are summed over the stages too."""
    grads = [g for g in grads if g is not None]
    sharded = [g for g in sharded if g is not None]
    norms = [torch.linalg.vector_norm(g.float()) for g in grads]
    if sharded:
        sq = torch.stack([torch.linalg.vector_norm(g.float())
                          for g in sharded]).square().sum()
        if group is not None:
            torch.distributed.all_reduce(sq, group=group)
        norms.append(sq.sqrt())
    norm = torch.linalg.vector_norm(torch.stack(norms))
    if stage_group is not None:
        sq = norm.square()
        torch.distributed.all_reduce(sq, group=stage_group)
        norm = sq.sqrt()
    trigger = norm < max_norm
    for g in grads + sharded:
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
                   params: Iterable[torch.nn.Parameter]
                   ) -> torch.optim.Optimizer:
    """The JAX package's recipe over `params`: SGD-momentum (nesterov,
    weight decay on every parameter, BatchNorm's included) for convnets,
    AdamW for the rest. The caller sets each update's lr to
    make_schedule(cfg)(updates done so far) before `step()`, and clips
    the gradients first under AdamW (`uses_sgd`)."""
    if uses_sgd(model_name):
        return torch.optim.SGD(params, lr=0.0, momentum=0.9, nesterov=True,
                               dampening=0.0, weight_decay=cfg.weight_decay)
    return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=cfg.weight_decay)
