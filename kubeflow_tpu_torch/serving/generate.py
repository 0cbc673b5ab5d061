"""Autoregressive generation over the slot-row KV cache (port of
kubeflow_tpu/serving/generate.py: `generate` and a minimal `ServedLm`).

One causal prefill over the prompt seeds the cache, then each new token
costs one single-token decode step. Ragged batches pass `prompt_mask`
(1 = real token): pad slots stay invisible to attention and each row's
position embeddings count only its real tokens. Rows that emit `eos_id`
keep emitting it (rectangular output, finished rows masked).

This is the port's own oracle: the paged engine's greedy output is held
against it.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from kubeflow_tpu_torch.models.gpt import QUANTIZE_CHOICES, int8_model
from kubeflow_tpu_torch.serving.sampling import sample_logits


def generate(
    model,
    prompt_ids,
    max_new_tokens: int,
    *,
    prompt_mask=None,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 1.0,
    eos_id: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """[B, P] int prompts → [B, P + max_new_tokens] continuations, on the
    model's device. Sampling (temperature > 0) needs a `generator` on
    that device."""
    cfg = model.cfg
    dev = model.device
    ids = torch.as_tensor(prompt_ids, device=dev).long()
    b, p = ids.shape
    if max_new_tokens < 1:
        raise ValueError("max_new_tokens must be >= 1")
    if p + max_new_tokens > cfg.max_len:
        raise ValueError(
            f"prompt {p} + {max_new_tokens} new tokens exceeds "
            f"max_len {cfg.max_len}"
        )
    if temperature > 0.0 and generator is None:
        raise ValueError("sampling (temperature > 0) requires a generator")
    mask = (
        None if prompt_mask is None
        else torch.as_tensor(prompt_mask, device=dev).bool()
    )

    def sample(logits):
        return sample_logits(logits, generator, temperature, top_k, top_p)

    with torch.inference_mode():
        logits, cache = model.prefill(ids, mask)
        if mask is None:
            last_logits = logits[:, -1]
        else:
            # each row's next-token logits live at its LAST REAL position
            last = (mask.long().sum(1) - 1).clamp_min(0)
            last_logits = logits[torch.arange(b, device=dev), last]
        tok = sample(last_logits)
        done = (
            tok == eos_id if eos_id is not None
            else torch.zeros((b,), dtype=torch.bool, device=dev)
        )
        out = [tok]
        for _ in range(max_new_tokens - 1):
            nxt = sample(model.decode(tok[:, None], cache)[:, 0])
            if eos_id is not None:
                nxt = torch.where(done, torch.full_like(nxt, eos_id), nxt)
                done = done | (nxt == eos_id)
            out.append(nxt)
            tok = nxt
        return torch.cat([ids, torch.stack(out, dim=1)], dim=1)


class ServedLm:
    """A named generative model for the server's static `:generate` path
    (one request, one prefill + decode loop) and the engine's model.

    `quantize="int8"` is the static int8 path: the resident weights are
    the int8 model of `model` (`models/gpt.py int8_model`; an int8
    `model` is kept as it is) and `generate` runs over them, each leaf
    dequantized at its use."""

    def __init__(self, name: str, model, max_batch: int = 8,
                 quantize: str = "none"):
        self.quantize = str(quantize or "none")
        if self.quantize not in QUANTIZE_CHOICES:
            raise ValueError(
                f"ServedLm quantize must be one of {QUANTIZE_CHOICES}, got "
                f"{self.quantize!r}"
            )
        if self.quantize == "int8":
            model = int8_model(model)
        self.name = name
        self.model = model
        self.max_batch = max_batch
        # one request at a time runs on the model
        self._lock = threading.Lock()

    def generate(
        self,
        prompt_ids,
        max_new_tokens: int,
        *,
        prompt_mask=None,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 1.0,
        eos_id: Optional[int] = None,
        seed: int = 0,
    ) -> np.ndarray:
        x = np.asarray(prompt_ids, dtype=np.int64)
        if x.ndim != 2:
            raise ValueError("prompt_ids must be [batch, prompt_len]")
        if x.shape[0] > self.max_batch:
            raise ValueError(
                f"batch {x.shape[0]} exceeds max_batch {self.max_batch}"
            )
        if x.shape[1] < 1:
            raise ValueError("prompt must contain at least one token")
        vocab = self.model.cfg.vocab_size
        if x.min() < 0 or x.max() >= vocab:
            raise ValueError(f"prompt ids must be in [0, {vocab})")
        mask = None
        if prompt_mask is not None:
            mask = np.asarray(prompt_mask).astype(bool)
            if mask.shape != x.shape:
                raise ValueError("attention_mask shape must match prompt_ids")
            if not mask.any(axis=1).all():
                raise ValueError("each prompt row needs >= 1 real token")
        temperature, top_k, top_p = float(temperature), int(top_k), float(top_p)
        if temperature < 0.0:
            raise ValueError("temperature must be >= 0")
        if top_k < 0:
            raise ValueError("top_k must be >= 0")
        if not 0.0 < top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        if eos_id is not None:
            eos_id = int(eos_id)
            if not 0 <= eos_id < vocab:
                raise ValueError(f"eos_id must be in [0, {vocab})")
        n = int(max_new_tokens)
        if n < 1:
            raise ValueError("max_new_tokens must be >= 1")
        max_len = self.model.cfg.max_len
        if x.shape[1] + n > max_len:
            raise ValueError(
                f"prompt {x.shape[1]} + {n} new tokens exceeds "
                f"max_len {max_len}"
            )
        gen = torch.Generator(device=self.model.device)
        gen.manual_seed(int(seed))
        with self._lock:
            out = generate(
                self.model, x, n, prompt_mask=mask, temperature=temperature,
                top_k=top_k, top_p=top_p, eos_id=eos_id, generator=gen,
            )
        return out.cpu().numpy()
