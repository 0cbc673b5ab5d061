"""The train-step engine (port of kubeflow_tpu/training/trainer.py) for one
card.

`Trainer` builds the model (f32 master weights, trainable, compute in
`cfg.dtype`), the causal-LM task and AdamW. `train_step` is the JAX
`step_fn`: forward and backward (gradient accumulation over
`accum_steps` microbatches as a Python loop, each weighted by its valid
next-token count, so the result is the full-batch token-mean gradient),
optax's global-norm clip, the schedule's lr for this update, one AdamW
step. `fit` is `_fit_loop`: the first-step fence (`compile_s`: in eager
PyTorch it fences first-use kernel builds and library warm-up out of the
throughput windows), the non-finite-loss stop, items/s, MFU and goodput
per log window, and the `stop_event` preemption exit.

Unlike the JAX package's functional state, a `TrainState` here is
updated IN PLACE: the model's parameters and the optimizer's moments are
the state, and `train_step` returns the same object one step on.

Batches come from `SyntheticData.batch_at` (the JAX numpy stream), copied
host→device from pinned memory; `data.prefetch_depth` batches are made
and enqueued ahead of the step that needs them. Not ported yet (ROADMAP
A11): the on-device generator (`device_batch_fn`), the `DevicePrefetcher`
thread, eval, and the mesh (one card).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from kubeflow_tpu_torch.config.platform import TrainingConfig
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.observability.mfu import (
    goodput as goodput_fraction,
    lm_train_flops,
    mfu as mfu_fraction,
    peak_flops_per_chip,
)
from kubeflow_tpu_torch.training.data import to_device
from kubeflow_tpu_torch.training.tasks import (
    clip_by_global_norm,
    make_optimizer,
    make_schedule,
    task_for_model,
)
from kubeflow_tpu_torch.utils.device import DeviceLike, resolve_device
from kubeflow_tpu_torch.utils.logging import get_logger
from kubeflow_tpu_torch.utils.metrics import (
    host_wait_histogram,
    training_goodput_gauge,
    training_items_gauge,
    training_mfu_gauge,
    training_step_histogram,
)

log = get_logger(__name__)

MAX_GRAD_NORM = 1.0


@dataclasses.dataclass
class TrainState:
    """Updates done so far, the model (its parameters are the f32 master
    weights) and the optimizer (its moments). Mutated in place."""

    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


@dataclasses.dataclass
class StepMetrics:
    step: int
    loss: float
    items_per_sec: float
    step_time_s: float
    aux: Dict[str, float]


class Trainer:
    """Builds the model, task and optimizer for one (model, config) on
    one device. `device` defaults to "cuda" and raises without CUDA
    unless "cpu" is asked for."""

    def __init__(self, cfg: TrainingConfig, model=None, task=None,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if model is None:
            # the config's context window, remat and attention reach the
            # model factory (JAX trainer.py:97-124)
            kwargs: Dict[str, Any] = {"attention_impl": cfg.attention_impl,
                                      "remat": cfg.remat}
            if cfg.seq_len > 0:
                kwargs["max_len"] = cfg.seq_len
            dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
            model = get_model(cfg.model, dtype=dtype, device=self.device,
                              seed=cfg.seed, **kwargs)
        if model.device != self.device:
            raise ValueError(f"model is on {model.device}, the trainer on "
                             f"{self.device}")
        self.model = model.trainable()
        self.task = task if task is not None else task_for_model(cfg.model, cfg)
        mcfg = self.model.cfg
        if task is None:
            # clamp the task's data dims to the model's tables
            self.task.vocab_size = min(self.task.vocab_size, mcfg.vocab_size)
            if cfg.seq_len > 0:
                if cfg.seq_len > mcfg.max_len:
                    # an explicit request is never clamped silently
                    raise ValueError(
                        f"cfg.seq_len {cfg.seq_len} exceeds the model's "
                        f"max_len {mcfg.max_len}; build the model with a "
                        f"matching context window"
                    )
                self.task.seq_len = cfg.seq_len
            self.task.seq_len = min(self.task.seq_len, mcfg.max_len)
        self.schedule = make_schedule(cfg)
        self._final_state: Optional[TrainState] = None
        self._stop_reason = ""
        # every step's loss fit ran, read on the host: (step, loss)
        self.losses: List[Tuple[int, float]] = []

    # ---- state -----------------------------------------------------------

    def init_state(self) -> TrainState:
        """Fresh state: the model's seeded init (cfg.seed) and a fresh
        AdamW. Every call gives the same initial weights."""
        from kubeflow_tpu_torch.models.gpt import init_params

        init_params(self.model, self.cfg.seed)
        opt = make_optimizer(self.cfg, self.cfg.model, self.model.parameters())
        return TrainState(step=0, model=self.model, optimizer=opt)

    # ---- the step --------------------------------------------------------

    def _microbatches(self, batch):
        a = self.cfg.accum_steps
        rows = batch["input_ids"].shape[0] // a
        return [{k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
                for i in range(a)]

    def train_step(self, state: TrainState, batch) -> Tuple[TrainState, Dict]:
        """One update, in place → (state, {"loss": device scalar}). `batch`
        holds [B, S] input_ids/attention_mask (numpy or device tensors).
        No host sync."""
        if any(isinstance(v, np.ndarray) for v in batch.values()):
            batch = to_device(batch, self.device)
        model, opt = state.model, state.optimizer
        params = [p for p in model.parameters() if p.requires_grad]
        opt.zero_grad(set_to_none=True)
        if self.cfg.accum_steps > 1:
            # Σ w_i·g_i / Σ w_i with w_i the microbatch's valid pairs: the
            # full-batch token-mean gradient even under ragged masks
            loss_sum = torch.zeros((), device=self.device)
            w_sum = torch.zeros((), device=self.device)
            for sub in self._microbatches(batch):
                loss_i, out_i = self.task.loss(model, sub)
                w_i = out_i["loss_items"]
                (loss_i * w_i).backward()
                loss_sum = loss_sum + loss_i.detach() * w_i
                w_sum = w_sum + w_i
            w_sum = w_sum.clamp_min(1e-9)
            for p in params:
                p.grad.div_(w_sum)
            loss = loss_sum / w_sum
        else:
            loss, _ = self.task.loss(model, batch)
            loss.backward()
            loss = loss.detach()
        clip_by_global_norm([p.grad for p in params], MAX_GRAD_NORM)
        # optax evaluates the schedule at the update count BEFORE this
        # update: the first update runs at schedule(0)
        lr = self.schedule(state.step)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        state.step += 1
        return state, {"loss": loss}

    # ---- the loop --------------------------------------------------------

    def fit(self, steps: Optional[int] = None, data=None,
            state: Optional[TrainState] = None, log_every: int = 10,
            stop_event=None) -> Optional[StepMetrics]:
        """Run the training loop; returns the last log window's metrics.
        `stop_event` (a threading.Event) is the preemption hook: once set,
        the loop finishes the step in flight and exits (unless that step
        is the last anyway)."""
        cfg = self.cfg
        steps = cfg.steps if steps is None else steps
        data = data if data is not None else self.task.synthetic_data()
        state = state if state is not None else self.init_state()
        start, end = state.step, state.step + steps
        model_label = cfg.model
        step_hist = training_step_histogram()
        thpt = training_items_gauge()
        host_wait = host_wait_histogram()
        mfu_gauge = training_mfu_gauge()
        goodput_gauge = training_goodput_gauge()
        peak = peak_flops_per_chip(self.device)
        # read-ahead: batches made and enqueued on the device before the
        # step that takes them (same step indices, so any depth trains on
        # the same sequence)
        ahead: collections.deque = collections.deque()
        next_fetch = start

        last: Optional[StepMetrics] = None
        # this window's (step, device loss): all read with the window's one
        # host sync, so every step's loss is kept without a sync a step
        pending: List[Tuple[int, torch.Tensor]] = []
        t_last = time.monotonic()
        steps_since_log = 0
        compile_s = 0.0
        stop_reason = ""
        self._stop_reason = ""
        w_start = time.monotonic()
        overhead_s = 0.0
        for i in range(start, end):
            t_wait = time.monotonic()
            while next_fetch < end and (
                not ahead or len(ahead) <= cfg.data.prefetch_depth
            ):
                batch_np = data.batch_at(next_fetch)
                ahead.append((batch_np, to_device(batch_np, self.device)))
                next_fetch += 1
            batch_np, batch = ahead.popleft()
            waited = time.monotonic() - t_wait
            host_wait.observe(waited, model=model_label)
            overhead_s += waited
            state, metrics = self.train_step(state, batch)
            pending.append((i + 1, metrics["loss"]))
            steps_since_log += 1
            if i == start and steps > 1:
                # the first step pays kernel builds and library warm-up:
                # fence it out of the throughput windows (one host sync)
                self._read_losses(pending)
                now = time.monotonic()
                compile_s = now - t_last
                t_last = now
                steps_since_log = 0
                w_start = now
                overhead_s = 0.0
            if (stop_event is not None and stop_event.is_set()
                    and not stop_reason and i != end - 1):
                stop_reason = f"preempted at step {i + 1}"
                self._stop_reason = "preempted"
            is_last = i == end - 1
            if (steps_since_log or (is_last and last is None)) and (
                (i + 1) % log_every == 0 or is_last
            ):
                loss = self._read_losses(pending)
                now = time.monotonic()
                dt = ((now - t_last) / steps_since_log if steps_since_log
                      else max(compile_s, 1e-9))
                t_last = now
                steps_since_log = 0
                items = self.task.count_items(batch_np)
                step_hist.observe(dt, model=model_label)
                thpt.set(items / dt, model=model_label)
                aux: Dict[str, float] = {}
                flops = lm_train_flops(self.model.cfg, *batch_np["input_ids"].shape)
                mfu_val = mfu_fraction(flops, dt, peak)
                if mfu_val is not None:
                    mfu_gauge.set(mfu_val, model=model_label)
                    aux["mfu"] = mfu_val
                gp = goodput_fraction(now - w_start, overhead_s)
                goodput_gauge.set(gp, model=model_label)
                aux["goodput"] = gp
                w_start = time.monotonic()
                overhead_s = 0.0
                if compile_s:
                    aux["compile_s"] = compile_s
                last = StepMetrics(step=i + 1, loss=loss,
                                   items_per_sec=items / dt, step_time_s=dt,
                                   aux=aux)
                log.info("step %d loss=%.4f %.1f items/s (%.1f ms/step)",
                         last.step, last.loss, last.items_per_sec, dt * 1e3)
            if stop_reason:
                log.info("early stop: %s", stop_reason)
                if pending:
                    self._read_losses(pending)
                break
        self._final_state = state
        return last

    def _read_losses(self, pending: List[Tuple[int, torch.Tensor]]) -> float:
        """Read the window's losses in one host sync into `self.losses`;
        returns the last. A non-finite one stops the run: a "succeeded"
        run with a NaN loss is a silent failure."""
        values = torch.stack([loss for _, loss in pending]).tolist()
        for (step, _), loss in zip(pending, values):
            self.losses.append((step, loss))
            if not np.isfinite(loss):
                raise FloatingPointError(f"non-finite loss at step {step}")
        pending.clear()
        return values[-1]
