"""The train-step engine (port of kubeflow_tpu/training/trainer.py) for one
card.

`Trainer` builds the model (f32 master weights, trainable, compute in
`cfg.dtype`), its task (causal LM for the GPT family, masked LM for
BERT, image classification for ResNet and the mlp) and the recipe's
optimizer (AdamW, or SGD-momentum for convnets). `train_step` is the JAX
`step_fn`: the model in train mode, the task's augmentation of the
batch (a pure function of (seed, step), so a resumed run replays the
crops), forward and backward (gradient accumulation over `accum_steps`
microbatches as a Python loop, each weighted by the task's item count:
the causal LM's valid next-token pairs, so the result is the full-batch
token-mean gradient; refused for a model with batch statistics, as in
the JAX package), optax's global-norm clip (AdamW only), the schedule's
lr for this update, one optimizer step. A model with dropout draws its
masks from one `torch.Generator` on the device a step, or a microbatch,
seeded by (seed, step, microbatch) (`dropout_seed`; the JAX `fold_in`s
of the step and the microbatch), so a resumed run replays the same
masks. A BatchNorm model's running averages move in the training
forward (the JAX `var_updates`). `evaluate` is a pass over
`eval_batches` in eval mode → top1, loss, count. `fit` is `_fit_loop`: the first-step fence (`compile_s`: in
eager PyTorch it fences first-use kernel builds and library warm-up out
of the throughput windows), the non-finite-loss stop, eval every
`data.eval_every_steps` and at the end with the early stop at
`data.target_accuracy` (eval time kept out of the step timing), items/s,
MFU and goodput per log window, the interval checkpoint saves, and the
`stop_event` preemption exit. The loop records the kft-trace spans
`train.host_wait`, `train.device_step`, `train.eval` and
`train.checkpoint_block` and the `train.compile_fence` event, and calls
the kft-chaos point `trainer.device_step` before each step (a host
losing its card mid-run; disarmed, one bool check).

Unlike the JAX package's functional state, a `TrainState` here is
updated IN PLACE: the model's parameters and buffers and the optimizer's
state are the state, and `train_step` returns the same object one step on.

Data comes from `datasets.build_data` (synthetic, blobs, npz). Synthetic
image batches are made on the card (`SyntheticData.device_batch_fn`);
every other stream is read by step (`batch_at`) and copied host→device
from pinned memory, `data.prefetch_depth` batches made and enqueued
ahead of the step that needs them. Synthetic MLM batches are made on
the card too. MFU is the LM's or the encoder's analytic FLOPs, or for
other models the FLOPs `FlopCounterMode` counts once over one forward
and backward of the model's shapes on the meta device. Not ported yet
(ROADMAP A11): `device_batch_fn` for the causal-LM stream, the
`DevicePrefetcher` thread, and the mesh (one card).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from kubeflow_tpu_torch.chaos import default_chaos
from kubeflow_tpu_torch.config.platform import TrainingConfig
from kubeflow_tpu_torch.models.convert import is_batch_stat
from kubeflow_tpu_torch.models.registry import get_model
from kubeflow_tpu_torch.observability.mfu import (
    encoder_train_flops,
    goodput as goodput_fraction,
    lm_train_flops,
    mfu as mfu_fraction,
    peak_flops_per_chip,
)
from kubeflow_tpu_torch.observability.trace import default_tracer
from kubeflow_tpu_torch.training.data import to_device
from kubeflow_tpu_torch.training.tasks import (
    clip_by_global_norm,
    make_optimizer,
    make_schedule,
    task_for_model,
    uses_sgd,
)
from kubeflow_tpu_torch.utils.device import DeviceLike, resolve_device
from kubeflow_tpu_torch.utils.logging import get_logger
from kubeflow_tpu_torch.utils.metrics import (
    host_wait_histogram,
    training_eval_top1_gauge,
    training_goodput_gauge,
    training_items_gauge,
    training_mfu_gauge,
    training_step_histogram,
)

log = get_logger(__name__)

MAX_GRAD_NORM = 1.0
# tags the dropout stream's seeds apart from the data streams'
_DROPOUT_STREAM = 0x64726F70


def dropout_seed(seed: int, step: int, micro: int = 0) -> int:
    """The 64-bit seed of update `step`'s dropout generator (microbatch
    `micro` under accumulation): a pure function of (seed, step, micro)."""
    ss = np.random.SeedSequence([_DROPOUT_STREAM, seed, step, micro])
    return int(ss.generate_state(1, np.uint64)[0])


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

    def checkpoint_tree(self) -> Dict[str, Any]:
        """The JAX package's manifest tree of this state (live tensors;
        training/checkpoint.py)."""
        from kubeflow_tpu_torch.training.checkpoint import train_state_tree

        return train_state_tree(self)

    def load_checkpoint_tree(self, tree: Dict[str, Any]) -> None:
        """Load a restored manifest tree in place."""
        from kubeflow_tpu_torch.training.checkpoint import (
            load_train_state_tree,
        )

        load_train_state_tree(self, tree)


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
            # the config's context window, remat and attention reach an
            # LM's factory (JAX trainer.py:97-124)
            kwargs: Dict[str, Any] = {}
            if cfg.remat:
                kwargs["remat"] = True
            if cfg.model.startswith(("gpt", "bert")):
                kwargs["attention_impl"] = cfg.attention_impl
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
        if task is None and hasattr(self.task, "vocab_size"):
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
        self._clip = not uses_sgd(cfg.model)
        self._final_state: Optional[TrainState] = None
        self._stop_reason = ""
        # every step's loss fit ran, read on the host: (step, loss)
        self.losses: List[Tuple[int, float]] = []
        # FLOPs of one step (non-LM models), counted once
        self._step_flops: Optional[float] = None
        # where the last step's input came from: "device" (made on the
        # card) or "host" (batch_at, copied over); the device type the
        # last augmented batch lived on (None when nothing was augmented)
        self.input_path = ""
        self.augment_device: Optional[str] = None
        # kft-chaos: the trainer.device_step injection point
        self._chaos = default_chaos()
        # dropout draws from a generator made for each step
        self._dropout = getattr(self.model.cfg, "dropout_rate", 0.0) > 0

    # ---- state -----------------------------------------------------------

    def init_state(self) -> TrainState:
        """Fresh state: the model's seeded init (cfg.seed; running
        averages reset) and a fresh optimizer. Every call gives the same
        initial weights."""
        self.model.init_params(self.cfg.seed)
        opt = make_optimizer(self.cfg, self.cfg.model, self.model.parameters())
        return TrainState(step=0, model=self.model, optimizer=opt)

    # ---- the step --------------------------------------------------------

    def _microbatches(self, batch):
        a = self.cfg.accum_steps
        rows = next(iter(batch.values())).shape[0] // a
        return [{k: v[i * rows:(i + 1) * rows] for k, v in batch.items()}
                for i in range(a)]

    def _loss_kwargs(self, step: int, micro: int = 0) -> Dict[str, Any]:
        """The task loss's dropout generator for (step, micro), on the
        device; nothing for a model without dropout."""
        if not self._dropout:
            return {}
        gen = torch.Generator(device=self.device)
        gen.manual_seed(dropout_seed(self.cfg.seed, step, micro))
        return {"dropout_generator": gen}

    def train_step(self, state: TrainState, batch) -> Tuple[TrainState, Dict]:
        """One update, in place → (state, {"loss": device scalar}). `batch`
        is the task's (numpy or device tensors): [B, S]
        input_ids/attention_mask, or image [B, H, W, 3] and label [B]. No
        host sync."""
        model, opt = state.model, state.optimizer
        if self.cfg.accum_steps > 1 and any(
                is_batch_stat(n) for n, _ in model.named_buffers()):
            # keyed on the model's variables, not the task class
            raise ValueError(
                "accum_steps > 1 is unsupported for models with batch "
                "statistics (BatchNorm): per-microbatch stats != "
                "full-batch stats"
            )
        if any(isinstance(v, np.ndarray) for v in batch.values()):
            batch = to_device(batch, self.device)
        augment = getattr(self.task, "augment_batch", None)
        if augment is not None and self.cfg.data.augment != "none":
            # every stream is a pure function of (seed, step): a resumed
            # run replays the same crops
            batch = augment(batch, state.step)
            self.augment_device = batch["image"].device.type
        model.train()
        params = [p for p in model.parameters() if p.requires_grad]
        opt.zero_grad(set_to_none=True)
        if self.cfg.accum_steps > 1:
            # Σ w_i·g_i / Σ w_i with w_i the microbatch's valid pairs: the
            # full-batch token-mean gradient even under ragged masks
            loss_sum = torch.zeros((), device=self.device)
            w_sum = torch.zeros((), device=self.device)
            for i, sub in enumerate(self._microbatches(batch)):
                loss_i, out_i = self.task.loss(
                    model, sub, **self._loss_kwargs(state.step, i))
                # tasks without an item count weight microbatches equally
                w_i = out_i.get("loss_items", torch.ones((), device=self.device))
                (loss_i * w_i).backward()
                loss_sum = loss_sum + loss_i.detach() * w_i
                w_sum = w_sum + w_i
            w_sum = w_sum.clamp_min(1e-9)
            for p in params:
                p.grad.div_(w_sum)
            loss = loss_sum / w_sum
        else:
            loss, _ = self.task.loss(model, batch,
                                     **self._loss_kwargs(state.step))
            loss.backward()
            loss = loss.detach()
        if self._clip:
            clip_by_global_norm([p.grad for p in params], MAX_GRAD_NORM)
        # optax evaluates the schedule at the update count BEFORE this
        # update: the first update runs at schedule(0)
        lr = self.schedule(state.step)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        state.step += 1
        return state, {"loss": loss}

    # ---- eval ------------------------------------------------------------

    def evaluate(self, state: TrainState, eval_data) -> Dict[str, float]:
        """A pass over the eval split (`eval_batches`, the model in eval
        mode) → {top1, loss, count}. Each batch's three sums are read on
        the host, as the JAX package reads them."""
        correct = count = loss_sum = 0.0
        state.model.eval()
        with torch.no_grad():
            for batch_np in eval_data.eval_batches():
                stats = self.task.eval_stats(
                    state.model, to_device(batch_np, self.device))
                values = torch.stack([stats["correct"], stats["count"],
                                      stats["loss_sum"]]).tolist()
                correct += values[0]
                count += values[1]
                loss_sum += values[2]
        state.model.train()
        count = max(count, 1.0)
        return {"top1": correct / count, "loss": loss_sum / count,
                "count": count}

    def step_flops(self, batch) -> float:
        """FLOPs of one training step of this model at `batch`'s shapes
        (forward and backward of the task's loss), counted once by
        `FlopCounterMode` on a meta-device twin of the model, so nothing
        runs on the card and no state moves. The LM and the encoder keep
        their analytic counts (`lm_train_flops`, `encoder_train_flops`)."""
        if self._step_flops is None:
            from torch.utils.flop_counter import FlopCounterMode

            twin = type(self.model)(self.model.cfg, device="meta").trainable()
            meta = {k: torch.empty(v.shape, device="meta", dtype=(
                v.dtype if isinstance(v, torch.Tensor)
                else torch.float32 if np.issubdtype(v.dtype, np.floating)
                else torch.int64)) for k, v in batch.items()}
            with FlopCounterMode(display=False) as counter:
                loss, _ = self.task.loss(twin, meta)
                loss.backward()
            self._step_flops = float(counter.get_total_flops())
        return self._step_flops

    # ---- the loop --------------------------------------------------------

    def fit(self, steps: Optional[int] = None, data=None,
            state: Optional[TrainState] = None, log_every: int = 10,
            checkpoint_manager=None, stop_event=None,
            eval_data=None) -> Optional[StepMetrics]:
        """Run the training loop; returns the last log window's metrics.
        Without `data`, the config's pipeline (`datasets.build_data`)
        gives the train data and its eval split. With eval data, a pass
        runs every `cfg.data.eval_every_steps` and at the end, and once
        `cfg.data.target_accuracy` (> 0) is reached the run stops early;
        the last eval's top1 and loss land in the metrics' aux as
        eval_top1/eval_loss. With `checkpoint_manager`
        (checkpointing/manager.py) the state is saved after every
        `cfg.checkpoint.interval_steps`-th update; the save blocks for its
        host copy only, and that time counts as overhead in goodput.
        `stop_event` (a threading.Event) is the preemption hook: once
        set, the loop finishes the step in flight and exits (unless that
        step is the last anyway; no eval runs); the save of that step is
        runtime/train_run.py's final forced save. Batches are read by
        global step (`batch_at(state.step + i)`), so a resumed run sees
        the batches an uninterrupted one would."""
        cfg = self.cfg
        steps = cfg.steps if steps is None else steps
        if data is None:
            from kubeflow_tpu_torch.training.datasets import build_data

            data, built_eval = build_data(cfg, self.task)
            if eval_data is None:
                eval_data = built_eval
        state = state if state is not None else self.init_state()
        start, end = state.step, state.step + steps
        # synthetic image batches are made on the card: no host normals
        # and no host→device copy a step
        device_gen = None
        if cfg.data.name == "synthetic" and hasattr(data, "device_batch_fn"):
            device_gen = data.device_batch_fn(self.device)
        self.input_path = "device" if device_gen is not None else "host"
        model_label = cfg.model
        step_hist = training_step_histogram()
        thpt = training_items_gauge()
        host_wait = host_wait_histogram()
        mfu_gauge = training_mfu_gauge()
        goodput_gauge = training_goodput_gauge()
        acc_gauge = training_eval_top1_gauge()
        peak = peak_flops_per_chip(self.device)
        tracer = default_tracer()
        eval_every = cfg.data.eval_every_steps if eval_data is not None else 0
        target = cfg.data.target_accuracy if eval_data is not None else 0.0
        eval_metrics: Dict[str, float] = {}
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
            with tracer.span("train.host_wait", model=model_label, step=i):
                if device_gen is not None:
                    batch = batch_np = device_gen(i)
                else:
                    while next_fetch < end and (
                        not ahead or len(ahead) <= cfg.data.prefetch_depth
                    ):
                        host = data.batch_at(next_fetch)
                        ahead.append((host, to_device(host, self.device)))
                        next_fetch += 1
                    batch_np, batch = ahead.popleft()
            waited = time.monotonic() - t_wait
            host_wait.observe(waited, model=model_label)
            overhead_s += waited
            # the span covers the step's launches (no sync is added); once
            # the launch queue is full they wait on the step before, so at
            # steady state it reads the step's time
            with tracer.span("train.device_step", model=model_label, step=i):
                self._chaos.maybe_fail("trainer.device_step")
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
                # where steady state begins, in a trace
                tracer.event("train.compile_fence", model=model_label,
                             step=i + 1, compile_s=round(compile_s, 4))
                w_start = now
                overhead_s = 0.0
            if (checkpoint_manager is not None
                    and (i + 1) % cfg.checkpoint.interval_steps == 0):
                t_ckpt = time.monotonic()
                with tracer.span("train.checkpoint_block", model=model_label,
                                 step=i + 1):
                    checkpoint_manager.save(i + 1, state)
                overhead_s += time.monotonic() - t_ckpt
            if (stop_event is not None and stop_event.is_set()
                    and not stop_reason and i != end - 1):
                stop_reason = f"preempted at step {i + 1}"
                self._stop_reason = "preempted"
            is_last = i == end - 1
            # a stopping run does not spend its grace period on an eval
            if eval_data is not None and not stop_reason and (
                is_last or (eval_every and (i + 1) % eval_every == 0)
            ):
                t_eval = time.monotonic()
                with tracer.span("train.eval", model=model_label, step=i + 1):
                    eval_metrics = self.evaluate(state, eval_data)
                # eval time stays out of the step timing
                t_last += time.monotonic() - t_eval
                overhead_s += time.monotonic() - t_eval
                acc_gauge.set(eval_metrics["top1"], model=model_label)
                log.info("step %d eval top1=%.4f loss=%.4f (%d examples)",
                         i + 1, eval_metrics["top1"], eval_metrics["loss"],
                         int(eval_metrics["count"]))
                if target and eval_metrics["top1"] >= target:
                    stop_reason = (f"target accuracy {target:.2%} reached "
                                   f"at step {i + 1}")
                    is_last = True
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
                # the one-time FLOP count is fenced out of the next window
                t_acct = time.monotonic()
                if peak is None:
                    flops = None  # no MFU off a listed card
                elif getattr(self.task, "name", "") == "mlm":
                    flops = encoder_train_flops(self.model.cfg,
                                                *batch_np["input_ids"].shape)
                elif getattr(self.task, "name", "") == "lm":
                    flops = lm_train_flops(self.model.cfg,
                                           *batch_np["input_ids"].shape)
                else:
                    flops = self.step_flops(batch_np)
                mfu_val = mfu_fraction(flops, dt, peak)
                if mfu_val is not None:
                    mfu_gauge.set(mfu_val, model=model_label)
                    aux["mfu"] = mfu_val
                gp = goodput_fraction(now - w_start, overhead_s)
                goodput_gauge.set(gp, model=model_label)
                aux["goodput"] = gp
                t_last += time.monotonic() - t_acct
                w_start = time.monotonic()
                overhead_s = 0.0
                if compile_s:
                    aux["compile_s"] = compile_s
                if eval_metrics:
                    aux["eval_top1"] = eval_metrics["top1"]
                    aux["eval_loss"] = eval_metrics["loss"]
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
