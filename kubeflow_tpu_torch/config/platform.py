"""Platform configuration (copy of the subset of
kubeflow_tpu/config/platform.py's `TrainingConfig`, `MeshConfig`,
`DataConfig` and `CheckpointConfig` the port's training path honours, of
`ObservabilityConfig` and `ChaosConfig` both paths read, and of
`ServingConfig`: its engine and KV-tier knobs and its `mesh`,
`observability`, `autoscale`, `chaos`, `router` and `disagg` subtrees, which
controllers/inference.py renders into a serving pod or acts on), and
`SliceConfig`,
the GPU counterpart of the JAX package's TPU slice request: an H100
topology from `GPU_TOPOLOGIES`, one pod a card.

Fields keep the JAX package's names and defaults. A field of the JAX
config that the port does not honour yet is absent here, so passing it
raises (a `TypeError` from the constructor, a `ValueError` naming the
ROADMAP item from `from_dict`): no field is accepted and silently
ignored. `validate()` runs on construction. The port runs the `data`,
`sequence`, `expert` and `pipeline` axes (pipeline and sequence not
together); any other axis above 1 raises naming its ROADMAP item. A
`sequence` axis above 1 trains an LM by ring or Ulysses attention over
sequence shards, and its `seq_len` must divide over it.
An `expert` axis above 1 shards an MoE model's expert stacks, E/ep
experts a rank: the model's `num_experts` must divide over it (the JAX
package's GSPMD would pad the stacks; the port refuses). A dense model
on an expert axis trains as replicas. A `pipeline` axis above 1 cuts an
LM's layers into that many stages (the model's layer count must divide
over it), run by `pipeline_schedule` ("gpipe" or "1f1b"); the trainer
refuses a model without stages (training/trainer.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping

# JAX TrainingConfig fields this port does not take, and why (ROADMAP.md)
_UNPORTED_FIELDS = {
    "compile_cache_dir": "A14 (nothing compiles ahead in eager PyTorch)",
}

# cards a serving replica's pod may request: a replica is one pod on one
# node, and an H100 node holds 8
GPUS_PER_NODE = 8

MESH_AXES = ("data", "fsdp", "tensor", "pipeline", "sequence", "expert")
# pairs of axes (each ported alone) that the port does not run together
# yet, and their ROADMAP items
_UNPORTED_MESH_PAIRS = {
    ("pipeline", "sequence"): "A13 item 7 (pipeline × sequence)",
    ("fsdp", "sequence"): "A13 item 8 (fsdp with the other axes)",
    ("fsdp", "expert"): "A13 item 8 (fsdp with the other axes)",
    ("fsdp", "pipeline"): "A13 item 8 (fsdp with the other axes)",
    ("tensor", "fsdp"): "A13 item 9 (tensor with the other axes)",
    ("tensor", "sequence"): "A13 item 9 (tensor with the other axes)",
    ("tensor", "expert"): "A13 item 9 (tensor with the other axes)",
    ("tensor", "pipeline"): "A13 item 9 (tensor with the other axes)",
}
# the models whose tensor-split leaves (conv_out, the classifier head)
# the port's trainer does not hold as blocks yet
_TENSOR_IMAGE_MODELS = ("resnet", "mlp")
_TENSOR_IMAGE_ITEM = "A13 item 10 (the image models under the tensor axis)"
PIPELINE_SCHEDULES = ("gpipe", "1f1b")

DTYPES = ("float32", "bfloat16")
DATASETS = ("synthetic", "blobs", "npz")
AUGMENTS = ("none", "crop_flip")
ATTENTION_IMPLS = ("dense", "flash", "auto", "ring", "ulysses")
# the attentions a sequence axis can run ("dense", the default, becomes
# "ring" there, as the JAX trainer defaults it)
SEQUENCE_ATTENTION_IMPLS = ("dense", "ring", "ulysses")


class ConfigError(ValueError):
    pass


# H100 gangs by card count (the counterpart of the JAX package's
# TPU_TOPOLOGIES). The port runs one process a rank and one card a
# process, so a gang is one pod a card; up to 8 share a node.
GPU_TOPOLOGIES: Dict[str, int] = {
    f"h100-{n}": n for n in (1, 2, 4, 8, 16, 32, 64)
}
GPU_RESOURCE = "nvidia.com/gpu"
GPU_ACCELERATOR_LABEL = "cloud.google.com/gke-accelerator"
H100_ACCELERATOR = "nvidia-h100-80gb"


def _check_keys(raw: Mapping, cls, unported: Mapping[str, str], path: str):
    known = {f.name for f in dataclasses.fields(cls)}
    for key in raw:
        if key in known:
            continue
        if key in unported:
            raise ConfigError(f"{path}{key} is not ported yet: ROADMAP "
                              f"{unported[key]}")
        raise ConfigError(f"unknown field {path}{key}")


@dataclasses.dataclass
class SliceConfig:
    """The gang's GPU request (the JAX `SliceConfig`'s fields, with H100
    topologies in place of TPU slices). A "chip" in the controller's
    vocabulary is one card: `total_chips` is the gang's card count and
    `total_hosts` its pod count, the same number, as each pod runs one
    rank on one card (`nvidia.com/gpu: "1"`). `num_slices` groups of the
    topology join over the network, as TPU slices join over DCN."""

    topology: str = "h100-8"
    num_slices: int = 1
    reserved: bool = False
    spot: bool = False

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        if self.topology not in GPU_TOPOLOGIES:
            raise ConfigError(
                f"unknown GPU topology {self.topology!r}; the port "
                f"schedules H100 gangs: {list(GPU_TOPOLOGIES)}")
        if not isinstance(self.num_slices, int) or self.num_slices < 1:
            raise ConfigError("num_slices must be >= 1")
        if self.reserved and self.spot:
            raise ConfigError("reserved and spot are mutually exclusive")

    @property
    def chips_per_slice(self) -> int:
        return GPU_TOPOLOGIES[self.topology]

    @property
    def total_chips(self) -> int:
        return self.chips_per_slice * self.num_slices

    @property
    def total_hosts(self) -> int:
        """Pods: one a card."""
        return self.total_chips

    def node_selectors(self) -> Dict[str, str]:
        return {GPU_ACCELERATOR_LABEL: H100_ACCELERATOR}

    def resource_requests(self) -> Dict[str, str]:
        return {GPU_RESOURCE: "1"}

    @classmethod
    def from_dict(cls, raw: Mapping[str, Any]) -> "SliceConfig":
        _check_keys(raw, cls, {}, "slice.")
        return cls(**raw)


@dataclasses.dataclass
class MeshConfig:
    """Logical parallelism mesh, axis name → size (the JAX package's
    fields and check). The product of the axes is the gang's device
    count: one process per rank, one card a process
    (parallel/mesh.py `build_mesh` checks it against the world size).
    The port runs every axis alone; a pair it does not run together
    (`_UNPORTED_MESH_PAIRS`: pipeline × sequence, fsdp or tensor beside
    another model axis) raises naming the ROADMAP item it waits for."""

    data: int = 1
    fsdp: int = 1
    tensor: int = 1
    pipeline: int = 1
    sequence: int = 1
    expert: int = 1

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        for axis in MESH_AXES:
            v = getattr(self, axis)
            if not isinstance(v, int) or v < 1:
                raise ConfigError(
                    f"mesh.{axis} must be a positive int, got {v!r}")
        for (a, b), item in _UNPORTED_MESH_PAIRS.items():
            if getattr(self, a) > 1 and getattr(self, b) > 1:
                raise ConfigError(f"mesh.{a} > 1 with mesh.{b} > 1 is not "
                                  f"ported yet: ROADMAP {item}")

    @property
    def num_devices(self) -> int:
        n = 1
        for axis in MESH_AXES:
            n *= getattr(self, axis)
        return n

    def axis_sizes(self) -> Dict[str, int]:
        return {a: getattr(self, a) for a in MESH_AXES}

    @classmethod
    def from_dict(cls, raw: Mapping[str, Any]) -> "MeshConfig":
        _check_keys(raw, cls, {}, "mesh.")
        return cls(**raw)


@dataclasses.dataclass
class DataConfig:
    """Input pipeline (training/datasets.py `build_data`): synthetic
    batches, generated `blobs`, or `npz` shards / `.npy` mmap files under
    `path`; the eval loop's knobs (a pass over the held-out split every
    `eval_every_steps` and at the end, an early stop at
    `target_accuracy`); the training augmentation; and `prefetch_depth`
    host batches made and copied to the device ahead of their step."""

    # synthetic | blobs | npz
    name: str = "synthetic"
    # a file or directory for npz datasets
    path: str = ""
    # held-out fraction split from train when there is no eval split
    eval_fraction: float = 0.0
    # eval period; 0 = only at the end of training
    eval_every_steps: int = 0
    # 0 = global_batch_size
    eval_batch_size: int = 0
    # stop once eval top-1 reaches this (0 = off)
    target_accuracy: float = 0.0
    shuffle: bool = True
    # generated dataset size (blobs)
    num_examples: int = 4096
    # none | crop_flip (random-resized-crop + horizontal flip on the
    # device, training/augment.py)
    augment: str = "none"
    prefetch_depth: int = 2

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        if self.prefetch_depth < 0:
            raise ConfigError("data.prefetch_depth must be >= 0")
        if self.name not in DATASETS:
            raise ConfigError(
                f"data.name must be synthetic|blobs|npz, got {self.name!r}")
        if not 0.0 <= self.eval_fraction < 1.0:
            raise ConfigError("data.eval_fraction must be in [0, 1)")
        if self.augment not in AUGMENTS:
            raise ConfigError(
                f"data.augment must be none|crop_flip, got {self.augment!r}")
        if not 0.0 <= self.target_accuracy <= 1.0:
            raise ConfigError("data.target_accuracy must be in [0, 1]")
        if self.name == "npz" and not self.path:
            raise ConfigError("data.name=npz requires data.path")
        # the eval knobs must be reachable: skipping a configured
        # train-to-accuracy contract would burn the whole step budget
        wants_eval = self.target_accuracy > 0 or self.eval_every_steps > 0
        if wants_eval and self.name == "synthetic":
            raise ConfigError(
                "eval (target_accuracy/eval_every_steps) requires a real "
                "dataset; data.name=synthetic has no held-out split")
        if wants_eval and self.name == "blobs" and self.eval_fraction == 0:
            raise ConfigError(
                "data.name=blobs with eval requires data.eval_fraction > 0")

    @classmethod
    def from_dict(cls, raw: Mapping[str, Any]) -> "DataConfig":
        _check_keys(raw, cls, {}, "data.")
        return cls(**raw)


@dataclasses.dataclass
class CheckpointConfig:
    """Knobs for the async checkpoint subsystem (checkpointing/), the JAX
    package's fields and defaults. `KFT_CHECKPOINT_DIR` in the run's
    environment overrides `directory` (runtime/train_run.py), so an
    operator can repoint a job without editing its spec."""

    enabled: bool = True
    directory: str = "/tmp/kubeflow_tpu/checkpoints"
    interval_steps: int = 1000
    # last-N checkpoints retained
    keep: int = 3
    # additionally retain every k-th step forever (milestones that survive
    # the keep-last-N sweep); 0 = off
    keep_every: int = 0
    # save on a background writer: the train loop blocks only for the
    # host snapshot, never the shard writes or the commit
    async_save: bool = True
    # at most this many saves snapshot-resident/writing at once; save()
    # blocks when full (bounds host memory at ~window x state size)
    max_in_flight: int = 2
    # non-empty: a fresh run (no checkpoint in `directory`) initializes
    # its PARAMS from the latest committed checkpoint here (step and
    # optimizer state start at zero)
    warm_start_dir: str = ""

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        if self.interval_steps < 1:
            raise ConfigError("checkpoint.interval_steps must be >= 1")
        if self.keep < 1:
            raise ConfigError("checkpoint.keep must be >= 1")
        if self.keep_every < 0:
            raise ConfigError("checkpoint.keep_every must be >= 0")
        if self.max_in_flight < 1:
            raise ConfigError("checkpoint.max_in_flight must be >= 1")

    @classmethod
    def from_dict(cls, raw: Mapping[str, Any]) -> "CheckpointConfig":
        _check_keys(raw, cls, {}, "checkpoint.")
        return cls(**raw)


@dataclasses.dataclass
class ObservabilityConfig:
    """kft-trace knobs (observability/trace.py) and the fleet collector's
    (observability/fleet.py, slo.py), the JAX package's fields, defaults
    and checks. The trace knobs are rendered as KFT_TRACE_* env and read
    through `observability.trace.configure_from_env` by serving/main.py
    and runtime/train_run.py; tracing is on by default (the span layer
    is a bounded ring, and off it is a shared no-op). The fleet knobs
    map 1:1 onto `FleetCollector.from_config`."""

    # record spans into the in-process ring; off = the span API is a no-op
    trace_enabled: bool = True
    # ring capacity in span records; the oldest drop first
    trace_buffer_spans: int = 4096
    # serve /statusz, /debug/trace and /tracez; off = not mounted
    statusz_enabled: bool = True
    # tail-sampling keep probability for unremarkable completed request
    # traces (error and slower-than-p99 traces are always kept)
    trace_sample_prob: float = 1.0
    # completed-traces ring capacity served by /tracez
    trace_sample_keep: int = 128
    # declarative fleet SLO rules (observability/slo.py), e.g.
    # 'serving_ttft_p99 < 5s', 'serving_queue_depth / num_slots < 0.8',
    # evaluated each fleet sweep into fleet_slo_compliant{slo} and
    # fleet_slo_burn_rate{slo}
    slo_rules: List[str] = dataclasses.field(default_factory=list)
    # fleet collector sweep period: every replica's and rank's /metrics
    # is scraped and merged this often
    fleet_scrape_interval_s: float = 10.0
    # straggler threshold: flag a gang rank whose rolling mean step time
    # exceeds its peers' by more than this many (leave-one-out, floored)
    # standard deviations
    fleet_straggler_zscore: float = 3.0
    # SLO burn-rate window in sweeps: the breached share of the last N
    fleet_burn_window: int = 30

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        if self.trace_buffer_spans < 1:
            raise ConfigError("observability.trace_buffer_spans must be >= 1")
        if not 0.0 <= self.trace_sample_prob <= 1.0:
            raise ConfigError(
                "observability.trace_sample_prob must be in [0, 1]"
            )
        if self.trace_sample_keep < 1:
            raise ConfigError("observability.trace_sample_keep must be >= 1")
        if self.fleet_scrape_interval_s <= 0:
            raise ConfigError(
                "observability.fleet_scrape_interval_s must be > 0")
        if self.fleet_straggler_zscore <= 0:
            raise ConfigError(
                "observability.fleet_straggler_zscore must be > 0")
        if self.fleet_burn_window < 1:
            raise ConfigError("observability.fleet_burn_window must be >= 1")
        # parse and kind-check the rules now: an unparseable rule, a
        # histogram signal without its quantile or a quantile of a scalar
        # would otherwise never evaluate, silently
        from kubeflow_tpu_torch.observability.fleet import AGGREGATION_POLICY
        from kubeflow_tpu_torch.observability.slo import (
            SloParseError,
            check_signal_kinds,
            parse_rules,
        )

        try:
            check_signal_kinds(parse_rules(self.slo_rules), AGGREGATION_POLICY)
        except SloParseError as e:
            raise ConfigError(f"observability.slo_rules: {e}") from e

    @classmethod
    def from_dict(cls, raw: Mapping[str, Any]) -> "ObservabilityConfig":
        _check_keys(raw, cls, {}, "observability.")
        return cls(**raw)


@dataclasses.dataclass
class ChaosConfig:
    """kft-chaos fault-injection knobs (chaos/core.py), the JAX package's
    fields and checks. Rendered as KFT_CHAOS_* env and read through
    `chaos.configure_from_env` by runtime/train_run.py and
    serving/main.py; disabled (the default) every injection point is a
    shared no-op."""

    # arm the plan below in this job's or service's processes
    enabled: bool = False
    # '<point>[:qualifiers]' entries (p=<prob>, after=<n>, once,
    # attempt=<n>) naming points of chaos.CATALOG
    points: List[str] = dataclasses.field(default_factory=list)
    # the plan's RNG seed: the same plan, seed and call sequence inject
    # the same faults
    seed: int = 0

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        if self.seed < 0:
            raise ConfigError("chaos.seed must be >= 0")
        # parse NOW: an unknown point or a bad qualifier fails the
        # config, never arms nothing quietly
        from kubeflow_tpu_torch.chaos import ChaosSpecError, parse_points

        try:
            parse_points(self.points)
        except ChaosSpecError as e:
            raise ConfigError(f"chaos.points: {e}") from e

    @classmethod
    def from_dict(cls, raw: Mapping[str, Any]) -> "ChaosConfig":
        _check_keys(raw, cls, {}, "chaos.")
        return cls(**raw)


@dataclasses.dataclass
class TrainingConfig:
    """Per-job training knobs (the JAX `TrainingConfig` subset).

    `attention_impl` is the port's own field: the JAX trainer takes the
    model's default ("dense") unless a `sequence` mesh axis switches it
    to ring attention, and its model kwargs name any other. Here the
    config names it: "dense", "flash" (the CUDA kernels), "auto"
    (ops/attention.py `auto_attention_impl`), "ring" or "ulysses". With
    `mesh.sequence > 1` the default "dense" becomes "ring" (the JAX
    trainer's default), "ulysses" is kept, and "flash" or "auto", which
    attend within a shard only, raise; the model must be an LM and
    `seq_len` must divide over the axis."""

    model: str = "resnet50"
    global_batch_size: int = 256
    steps: int = 100
    learning_rate: float = 0.1
    weight_decay: float = 1e-4
    warmup_steps: int = 5
    dtype: str = "bfloat16"
    seed: int = 0
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    checkpoint: CheckpointConfig = dataclasses.field(
        default_factory=CheckpointConfig
    )
    remat: bool = False
    # label-smoothing epsilon of the classification loss (0.1 in the
    # ImageNet recipe)
    label_smoothing: float = 0.0
    # non-empty: the coordinator serves the profiler capture endpoint
    # (runtime/profiler.py), writing Tensorboard-readable traces here
    profiler_logdir: str = ""
    loss_chunk: int = 0
    assume_full_attention: bool = False
    seq_len: int = 0
    # microbatch schedule when mesh.pipeline > 1: "gpipe" or "1f1b"
    # (parallel/pipeline.py); ignored without a pipeline axis
    pipeline_schedule: str = "gpipe"
    accum_steps: int = 1
    attention_impl: str = "dense"
    observability: ObservabilityConfig = dataclasses.field(
        default_factory=ObservabilityConfig
    )
    chaos: ChaosConfig = dataclasses.field(default_factory=ChaosConfig)

    def __post_init__(self):
        if isinstance(self.mesh, Mapping):
            self.mesh = MeshConfig.from_dict(self.mesh)
        if isinstance(self.data, Mapping):
            self.data = DataConfig.from_dict(self.data)
        if isinstance(self.checkpoint, Mapping):
            self.checkpoint = CheckpointConfig.from_dict(self.checkpoint)
        if isinstance(self.observability, Mapping):
            self.observability = ObservabilityConfig.from_dict(
                self.observability
            )
        if isinstance(self.chaos, Mapping):
            self.chaos = ChaosConfig.from_dict(self.chaos)
        self.validate()

    def validate(self) -> None:
        if self.global_batch_size < 1:
            raise ConfigError("global_batch_size must be >= 1")
        if self.accum_steps < 1:
            raise ConfigError("accum_steps must be >= 1")
        if self.seq_len < 0:
            raise ConfigError("seq_len must be >= 0")
        if self.loss_chunk < 0:
            raise ConfigError("loss_chunk must be >= 0")
        if self.seq_len and not self.model.startswith(("bert", "gpt")):
            raise ConfigError(
                f"seq_len applies to LM models only (model={self.model!r})"
            )
        if self.global_batch_size % self.accum_steps:
            raise ConfigError(
                f"global_batch_size {self.global_batch_size} not divisible "
                f"by accum_steps {self.accum_steps}"
            )
        if self.dtype not in DTYPES:
            raise ConfigError(f"dtype must be float32|bfloat16, got {self.dtype}")
        if self.pipeline_schedule not in PIPELINE_SCHEDULES:
            raise ConfigError(
                f"pipeline_schedule must be gpipe|1f1b, "
                f"got {self.pipeline_schedule!r}"
            )
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ConfigError(
                f"attention_impl must be one of {ATTENTION_IMPLS}, got "
                f"{self.attention_impl!r}"
            )
        if not 0.0 <= self.label_smoothing < 1.0:
            raise ConfigError("label_smoothing must be in [0, 1)")
        # read only by the image-classification task: an LM config
        # carrying them would train without either
        is_image = self.model.startswith(("resnet", "mlp"))
        if self.label_smoothing > 0 and not is_image:
            raise ConfigError(
                f"label_smoothing applies to image-classification models "
                f"only (model={self.model!r})"
            )
        if self.data.augment != "none" and not is_image:
            raise ConfigError(
                f"data.augment applies to image-classification models only "
                f"(model={self.model!r})"
            )
        self.mesh.validate()
        sp = self.mesh.sequence
        if sp > 1:
            if not self.model.startswith(("bert", "gpt")):
                raise ConfigError(f"mesh.sequence applies to LM models only "
                                  f"(model={self.model!r})")
            if self.attention_impl not in SEQUENCE_ATTENTION_IMPLS:
                raise ConfigError(
                    f"attention_impl {self.attention_impl!r} runs no "
                    f"sequence axis; mesh.sequence {sp} takes one of "
                    f"{SEQUENCE_ATTENTION_IMPLS}")
            if self.seq_len % sp:
                raise ConfigError(f"seq_len {self.seq_len} not divisible by "
                                  f"the sequence mesh axis {sp}")
        if self.mesh.tensor > 1 and self.model.startswith(
                _TENSOR_IMAGE_MODELS):
            raise ConfigError(
                f"mesh.tensor > 1 with model {self.model!r} is not ported "
                f"yet: ROADMAP {_TENSOR_IMAGE_ITEM}")
        ep = self.mesh.expert
        if ep > 1:
            experts = _num_experts(self.model)
            if experts and experts % ep:
                raise ConfigError(
                    f"{self.model}'s {experts} experts do not divide over "
                    f"the expert mesh axis {ep} (each rank holds E/ep "
                    f"whole experts)")
        dp = self.mesh.data * self.mesh.fsdp
        if self.global_batch_size % dp != 0:
            raise ConfigError(
                f"global_batch_size {self.global_batch_size} not divisible by "
                f"data*fsdp axes {dp}"
            )

    @classmethod
    def from_dict(cls, raw: Mapping[str, Any]) -> "TrainingConfig":
        """Build from a spec's `training:` mapping; a field the port does
        not honour raises, naming the ROADMAP item it waits for."""
        _check_keys(raw, cls, _UNPORTED_FIELDS, "")
        return cls(**raw)


def _num_experts(model: str) -> int:
    """The registry preset's `num_experts` (0 for a dense or an unknown
    model; the trainer checks a model built with other kwargs again)."""
    from kubeflow_tpu_torch.models.registry import get_model

    try:
        return getattr(get_model(model, device="meta").cfg, "num_experts", 0)
    except (KeyError, TypeError):
        return 0


@dataclasses.dataclass
class AutoscaleConfig:
    """Signal-driven replica autoscaling of an InferenceService's decode
    tier (controllers/inference.py, fed by the fleet collector's
    `serving_signals`), the JAX `AutoscaleConfig`'s fields, defaults and
    checks. Control-plane knobs only: nothing here is rendered into a
    pod's env."""

    # let the controller adjust spec.replicas from the fleet's queue,
    # occupancy and 429 signals; off = replicas are the operator's
    enabled: bool = False
    # never scale below / above these
    min_replicas: int = 1
    max_replicas: int = 1
    # fleet mean slot occupancy at or above this is scale-up pressure
    scale_up_occupancy: float = 0.9
    # fleet queue depth a fleet slot at or above this is scale-up
    # pressure (the queue / num_slots SLO's shape)
    scale_up_queue_per_slot: float = 0.5
    # occupancy at or below this with an empty queue and no 429s is
    # scale-down headroom
    scale_down_occupancy: float = 0.3
    # the pressure (or headroom) must hold this many consecutive fleet
    # sweeps before a resize
    breach_cycles: int = 3
    # sweeps to wait after a resize before another (the new replica's
    # signals land first)
    cooldown_cycles: int = 5

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        if self.min_replicas < 0:
            raise ConfigError("autoscale.min_replicas must be >= 0")
        if self.max_replicas < max(1, self.min_replicas):
            raise ConfigError(
                "autoscale.max_replicas must be >= max(1, min_replicas)")
        for knob in ("scale_up_occupancy", "scale_up_queue_per_slot",
                     "scale_down_occupancy"):
            if getattr(self, knob) < 0:
                raise ConfigError(f"autoscale.{knob} must be >= 0")
        if self.scale_down_occupancy >= self.scale_up_occupancy:
            raise ConfigError(
                "autoscale.scale_down_occupancy must be below "
                "scale_up_occupancy (the hysteresis band)")
        if self.breach_cycles < 1:
            raise ConfigError("autoscale.breach_cycles must be >= 1")
        if self.cooldown_cycles < 0:
            raise ConfigError("autoscale.cooldown_cycles must be >= 0")

    @classmethod
    def from_dict(cls, raw: Mapping[str, Any]) -> "AutoscaleConfig":
        _check_keys(raw, cls, {}, "serving.autoscale.")
        return cls(**raw)


@dataclasses.dataclass
class RouterConfig:
    """kft-router knobs (routing/; the JAX `RouterConfig`'s fields,
    defaults and checks). When enabled the InferenceService controller
    deploys a `<name>-router` pod beside the replica fleet running
    `python -m kubeflow_tpu_torch.routing`, with these rendered as
    KFT_ROUTER_* (routing/__main__.py `knobs_from_env`). The affinity
    page size is not a knob: the controller renders KFT_ROUTER_PAGE_SIZE
    from `ServingConfig.page_size`, so the router's hash and the
    replicas' radix pages cannot drift apart."""

    # deploy the prefix-affinity front door; off = clients talk to the
    # replica Service directly and each replica's prefix cache is its own
    enabled: bool = False
    # route :generate by the prompt's first-page hash over a rendezvous
    # ranking of live replicas; off = round-robin spray
    affinity: bool = True
    # queue depth a slot strictly above which an affinity request takes
    # its second rendezvous choice (routing/router.py
    # DEFAULT_SPILL_QUEUE_PER_SLOT)
    spill_queue_per_slot: float = 2.0
    # extra replica attempts after a 429, connect failure or 5xx before
    # a clean 503 (routing/router.py DEFAULT_RETRY_BUDGET)
    retry_budget: int = 2

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        if self.spill_queue_per_slot < 0:
            raise ConfigError(
                "serving.router.spill_queue_per_slot must be >= 0")
        if self.retry_budget < 0:
            raise ConfigError("serving.router.retry_budget must be >= 0")

    @classmethod
    def from_dict(cls, raw: Mapping[str, Any]) -> "RouterConfig":
        _check_keys(raw, cls, {}, "serving.router.")
        return cls(**raw)


@dataclasses.dataclass
class DisaggConfig:
    """The disaggregated prefill/decode fleet (the JAX `DisaggConfig`'s
    fields, defaults and checks). `enabled` renders a `<name>-prefill`
    Deployment of `prefill_replicas` pods beside the decode tier
    (controllers/inference.py), and the router steers cold-prefix
    :generate requests through it: the prefill replica runs chunked
    prefill and ships the committed pages to the request's decode home
    over `POST /v1/kv/pages`. Needs `router.enabled` (the router is the
    steering point) and `prefix_cache` (shipped pages admit as radix
    hits)."""

    enabled: bool = False
    # prefill-tier pod count; spec.replicas stays the decode tier's. The
    # per-tier autoscaler moves it within min/max below
    prefill_replicas: int = 1
    min_prefill_replicas: int = 1
    max_prefill_replicas: int = 1
    # a request whose first-page key the router has not steered, or
    # whose decode home's prefix hit rate is strictly below this, is
    # cold (KFT_ROUTER_DISAGG_COLD_HIT_RATE)
    cold_hit_rate: float = 0.2
    # prefill-tier scale-up pressure: tier TTFT p99 at or above this
    scale_up_ttft_p99_s: float = 2.0
    # prefill-tier scale-up pressure: router cold steers a second at or
    # above this
    scale_up_cold_per_s: float = 2.0
    # committed radix pages a draining decode replica ships to the
    # keys' new rendezvous homes (KFT_SERVING_DISAGG_HANDOFF_CHAINS)
    handoff_chains: int = 64

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        if self.prefill_replicas < 0:
            raise ConfigError("serving.disagg.prefill_replicas must be >= 0")
        if self.min_prefill_replicas < 0:
            raise ConfigError(
                "serving.disagg.min_prefill_replicas must be >= 0")
        if self.max_prefill_replicas < max(1, self.min_prefill_replicas):
            raise ConfigError(
                "serving.disagg.max_prefill_replicas must be >= "
                "max(1, min_prefill_replicas)")
        if not 0.0 <= self.cold_hit_rate <= 1.0:
            raise ConfigError(
                "serving.disagg.cold_hit_rate must be in [0, 1]")
        if self.scale_up_ttft_p99_s <= 0:
            raise ConfigError(
                "serving.disagg.scale_up_ttft_p99_s must be > 0")
        if self.scale_up_cold_per_s <= 0:
            raise ConfigError(
                "serving.disagg.scale_up_cold_per_s must be > 0")
        if self.handoff_chains < 1:
            raise ConfigError("serving.disagg.handoff_chains must be >= 1")

    @classmethod
    def from_dict(cls, raw: Mapping[str, Any]) -> "DisaggConfig":
        _check_keys(raw, cls, {}, "serving.disagg.")
        return cls(**raw)


@dataclasses.dataclass
class ServingMeshConfig:
    """The decode engine's serving mesh (the JAX `ServingMeshConfig`;
    parallel/serving_mesh.py): `tensor × fsdp × expert` ranks a replica,
    one card a rank. 1×1×1 (the default) is the one-card engine, the
    bitwise baseline. `tensor` splits the KV pools on heads (a card's
    pool bytes divide by it), `fsdp` the resident weights on their embed
    dims, gathered at use, `expert` an MoE model's expert stacks, never
    gathered. The model's divisibility (heads and mlp by tensor, hidden
    by fsdp, num_experts by expert, top-1 routing at expert > 1) is
    checked where the model is known: the engine's construction."""

    tensor: int = 1
    fsdp: int = 1
    expert: int = 1

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        for axis in ("tensor", "fsdp", "expert"):
            v = getattr(self, axis)
            if not isinstance(v, int) or v < 1:
                raise ConfigError(
                    f"serving.mesh.{axis} must be a positive int, got {v!r}"
                )

    @property
    def num_devices(self) -> int:
        """Cards a replica runs on: tensor · fsdp · expert."""
        return self.tensor * self.fsdp * self.expert

    def env(self) -> Dict[str, str]:
        """The KFT_SERVING_MESH_* env a controller renders into a serving
        replica's pod (serving/main.py reads it)."""
        return {"KFT_SERVING_MESH_TENSOR": str(self.tensor),
                "KFT_SERVING_MESH_FSDP": str(self.fsdp),
                "KFT_SERVING_MESH_EXPERT": str(self.expert)}

    @classmethod
    def from_dict(cls, raw: Mapping[str, Any]) -> "ServingMeshConfig":
        _check_keys(raw, cls, {}, "serving.mesh.")
        return cls(**raw)


@dataclasses.dataclass
class ServingConfig:
    """Continuous-batching decode-engine knobs (serving/engine.py), the
    JAX `ServingConfig`'s fields, defaults and checks. The
    InferenceService controller (controllers/inference.py) renders them
    as KFT_SERVING_*, KFT_TRACE_* and KFT_CHAOS_* into every serving pod,
    where serving/main.py `engine_knobs_from_env` reads them back.

    `paged_attention` takes the port's read paths, `gather | kernel`
    (models/gpt.py `PAGED_ATTENTION_IMPLS`): "kernel" is the CUDA page
    walk, the counterpart of the JAX package's "pallas", which is
    refused here. `mesh` is a replica's `tensor × fsdp × expert` serving
    mesh: one pod on that many cards of one node (at most
    `GPUS_PER_NODE`), one process a card. `autoscale` scales the decode
    tier's `spec.replicas` on the fleet collector's signals, and the
    prefill tier's within `disagg`'s bounds. `router` deploys the
    prefix-affinity front door, which `disagg` needs."""

    # resident decode slots (the engine's batch); 0 disables the engine
    num_slots: int = 8
    # tokens per KV pool page (a power of two dividing max_len)
    page_size: int = 16
    # pool capacity in pages; 0 = auto
    num_pages: int = 0
    # radix prefix index over committed requests
    prefix_cache: bool = True
    # decode read path: gather | kernel
    paged_attention: str = "gather"
    # none | int8 (int8 weights and int8 KV pages)
    quantize: str = "none"
    # prompt-length buckets (ascending powers of two); empty = the
    # power-of-two ladder from 8 to max_len
    prefill_buckets: List[int] = dataclasses.field(default_factory=list)
    # admission-queue bound: past it requests get 429
    max_queue: int = 64
    # registry model drafting speculative tokens; empty = none
    draft_model: str = ""
    # tokens drafted a slot a verify step (K); 0 = no speculation
    num_draft_tokens: int = 0
    # platform checkpoint of the draft's params; empty = seed-0 init
    draft_checkpoint_dir: str = ""
    # host-RAM budget of the KV spill tier in bytes; 0 = off
    kv_host_bytes: int = 0
    # the on-disk persistent prefix store; empty = off
    kv_persist_dir: str = ""
    # seconds between persists; 0 = only at drain / shutdown
    kv_persist_interval_s: float = 0.0
    # prefix pages a persisted generation keeps, hottest first
    kv_persist_chains: int = 64
    # SIGTERM drain budget; the pod's grace period is derived from it
    drain_deadline_s: float = 30.0
    mesh: ServingMeshConfig = dataclasses.field(
        default_factory=ServingMeshConfig
    )
    observability: ObservabilityConfig = dataclasses.field(
        default_factory=ObservabilityConfig
    )
    autoscale: AutoscaleConfig = dataclasses.field(
        default_factory=AutoscaleConfig
    )
    router: RouterConfig = dataclasses.field(default_factory=RouterConfig)
    disagg: DisaggConfig = dataclasses.field(default_factory=DisaggConfig)
    chaos: ChaosConfig = dataclasses.field(default_factory=ChaosConfig)

    def __post_init__(self):
        if isinstance(self.mesh, Mapping):
            self.mesh = ServingMeshConfig.from_dict(self.mesh)
        if isinstance(self.observability, Mapping):
            self.observability = ObservabilityConfig.from_dict(
                self.observability
            )
        if isinstance(self.autoscale, Mapping):
            self.autoscale = AutoscaleConfig.from_dict(self.autoscale)
        if isinstance(self.chaos, Mapping):
            self.chaos = ChaosConfig.from_dict(self.chaos)
        if isinstance(self.router, Mapping):
            self.router = RouterConfig.from_dict(self.router)
        if isinstance(self.disagg, Mapping):
            self.disagg = DisaggConfig.from_dict(self.disagg)
        self.validate()

    def validate(self) -> None:
        from kubeflow_tpu_torch.chaos import parse_points
        from kubeflow_tpu_torch.models.gpt import (
            PAGED_ATTENTION_IMPLS,
            QUANTIZE_CHOICES,
        )

        self.mesh.validate()
        self.observability.validate()
        self.autoscale.validate()
        self.router.validate()
        self.disagg.validate()
        if self.disagg.enabled:
            if not self.router.enabled:
                raise ConfigError(
                    "serving.disagg.enabled needs serving.router.enabled: "
                    "the router steers cold-prefix requests to the "
                    "prefill tier")
            if not self.prefix_cache:
                raise ConfigError(
                    "serving.disagg.enabled needs serving.prefix_cache: "
                    "handed-off pages are admitted as radix prefix hits")
            if self.num_slots < 1:
                raise ConfigError(
                    "serving.disagg.enabled needs serving.num_slots >= 1: "
                    "both tiers run the decode engine")
        # a programmatically built config must hit the same parse
        # rejection from_dict applies
        self.chaos.validate()
        # serving replicas have no gang-incarnation counter: an
        # attempt-qualified point would arm inert, so it fails here
        for spec in parse_points(self.chaos.points):
            if spec.attempt is not None:
                raise ConfigError(
                    f"serving.chaos.points: {spec.spec_str()!r} uses "
                    f"attempt=, which only gang pods support (the "
                    f"GPUTrainJob controller renders the incarnation "
                    f"counter; serving replicas have none)"
                )
        if self.drain_deadline_s < 0:
            raise ConfigError("serving.drain_deadline_s must be >= 0")
        if self.num_slots < 0:
            raise ConfigError("serving.num_slots must be >= 0")
        if self.max_queue < 1:
            raise ConfigError("serving.max_queue must be >= 1")
        if self.num_draft_tokens < 0:
            raise ConfigError("serving.num_draft_tokens must be >= 0")
        if self.num_draft_tokens > 0 and not self.draft_model:
            raise ConfigError(
                "serving.num_draft_tokens > 0 needs serving.draft_model "
                "(speculative decoding drafts from a second model)")
        if self.paged_attention not in PAGED_ATTENTION_IMPLS:
            hint = (" (the JAX package's TPU page walk; the port's CUDA "
                    "page walk is 'kernel')"
                    if self.paged_attention == "pallas" else "")
            raise ConfigError(
                f"serving.paged_attention must be one of "
                f"{list(PAGED_ATTENTION_IMPLS)}, got "
                f"{self.paged_attention!r}{hint}")
        if self.quantize not in QUANTIZE_CHOICES:
            raise ConfigError(
                f"serving.quantize must be one of {list(QUANTIZE_CHOICES)}, "
                f"got {self.quantize!r}")
        # both knobs live inside the decode engine, which num_slots=0
        # disables
        if self.num_slots < 1 and self.paged_attention != "gather":
            raise ConfigError(
                "serving.paged_attention=kernel needs serving.num_slots "
                ">= 1: the kernel serves the decode engine's step, and "
                "num_slots=0 disables the engine")
        if self.num_slots < 1 and self.mesh.num_devices > 1:
            raise ConfigError(
                "serving.mesh needs serving.num_slots >= 1: the mesh "
                "shards the decode engine's programs, and num_slots=0 "
                "disables the engine (the static path would silently "
                "serve one card)")
        if self.mesh.num_devices > GPUS_PER_NODE:
            raise ConfigError(
                f"serving.mesh needs {self.mesh.num_devices} cards "
                f"(tensor·fsdp·expert) in one pod, more than the "
                f"{GPUS_PER_NODE} of one node")
        if self.num_draft_tokens > 0 and self.num_slots < 1:
            raise ConfigError(
                "serving.num_draft_tokens > 0 needs serving.num_slots "
                ">= 1: speculation lives inside the decode engine, and "
                "num_slots=0 disables it (the drafted knobs would be "
                "silently ignored)")
        for b in self.prefill_buckets:
            if b < 1 or b & (b - 1):
                raise ConfigError(
                    f"serving.prefill_buckets entries must be positive "
                    f"powers of two, got {b}")
        if self.prefill_buckets != sorted(self.prefill_buckets):
            raise ConfigError("serving.prefill_buckets must be ascending")
        if self.page_size < 1 or self.page_size & (self.page_size - 1):
            raise ConfigError(
                f"serving.page_size must be a positive power of two, "
                f"got {self.page_size}")
        if self.num_pages < 0:
            raise ConfigError("serving.num_pages must be >= 0 (0 = auto)")
        if self.kv_host_bytes < 0:
            raise ConfigError(
                "serving.kv_host_bytes must be >= 0 (0 = no host tier)")
        if self.kv_persist_interval_s < 0:
            raise ConfigError(
                "serving.kv_persist_interval_s must be >= 0 "
                "(0 = shutdown-only snapshots)")
        if self.kv_persist_chains < 1:
            raise ConfigError("serving.kv_persist_chains must be >= 1")
        if (self.kv_host_bytes > 0 or self.kv_persist_dir) \
                and not self.prefix_cache:
            raise ConfigError(
                "serving.kv_host_bytes / kv_persist_dir need "
                "serving.prefix_cache=true: both tiers key off the "
                "radix index's committed chains (the knobs would be "
                "silently ignored)")

    @classmethod
    def from_dict(cls, raw: Mapping[str, Any]) -> "ServingConfig":
        """Build from a spec's `serving:` mapping."""
        _check_keys(raw, cls, {}, "serving.")
        return cls(**raw)
