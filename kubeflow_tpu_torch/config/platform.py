"""Training configuration (copy of the subset of
kubeflow_tpu/config/platform.py's `TrainingConfig` and `DataConfig` the
port's training path honours).

Fields keep the JAX package's names and defaults. A field of the JAX
config that the port does not honour yet is absent here, so passing it
raises (a `TypeError` from the constructor, a `ValueError` naming the
ROADMAP item from `from_dict`): no field is accepted and silently
ignored. `validate()` runs on construction.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

# JAX TrainingConfig fields this port does not take yet, and what they
# wait for (ROADMAP.md)
_UNPORTED_FIELDS = {
    "mesh": "A13 (parallelism: one card, no mesh)",
    "checkpoint": "A12 (checkpointing)",
    "observability": "A14 (tracing spans)",
    "chaos": "A14 (fault injection)",
    "label_smoothing": "A13 item 6 (image classification)",
    "profiler_logdir": "A14 (runtime profiler)",
    "compile_cache_dir": "A14 (nothing compiles ahead in eager PyTorch)",
    "pipeline_schedule": "A13 item 4 (pipeline parallelism)",
}
_UNPORTED_DATA_FIELDS = {
    "path": "A11 (real datasets)",
    "eval_fraction": "A11 (eval)",
    "eval_every_steps": "A11 (eval)",
    "eval_batch_size": "A11 (eval)",
    "target_accuracy": "A11 (eval)",
    "shuffle": "A11 (real datasets)",
    "num_examples": "A11 (real datasets)",
    "augment": "A13 item 6 (image augmentation)",
}

DTYPES = ("float32", "bfloat16")
ATTENTION_IMPLS = ("dense", "flash")


class ConfigError(ValueError):
    pass


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
class DataConfig:
    """Input pipeline: the synthetic LM stream, read ahead `prefetch_depth`
    batches (already copied to the device) while the current step runs."""

    name: str = "synthetic"
    prefetch_depth: int = 2

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        if self.prefetch_depth < 0:
            raise ConfigError("data.prefetch_depth must be >= 0")
        if self.name != "synthetic":
            raise ConfigError(
                f"data.name {self.name!r} is not ported yet: only synthetic "
                f"(ROADMAP A11: real datasets)"
            )

    @classmethod
    def from_dict(cls, raw: Mapping[str, Any]) -> "DataConfig":
        _check_keys(raw, cls, _UNPORTED_DATA_FIELDS, "data.")
        return cls(**raw)


@dataclasses.dataclass
class TrainingConfig:
    """Per-job training knobs (the JAX `TrainingConfig` subset).

    `attention_impl` is the port's own field: the JAX trainer takes the
    model's default ("dense") unless a `sequence` mesh axis switches it
    to ring attention; a one-card port has no mesh, so the choice between
    "dense" and "flash" (the CUDA kernels) is named here."""

    model: str = "resnet50"
    global_batch_size: int = 256
    steps: int = 100
    learning_rate: float = 0.1
    weight_decay: float = 1e-4
    warmup_steps: int = 5
    dtype: str = "bfloat16"
    seed: int = 0
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    remat: bool = False
    loss_chunk: int = 0
    assume_full_attention: bool = False
    seq_len: int = 0
    accum_steps: int = 1
    attention_impl: str = "dense"

    def __post_init__(self):
        if isinstance(self.data, Mapping):
            self.data = DataConfig.from_dict(self.data)
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
        if self.attention_impl not in ATTENTION_IMPLS:
            raise ConfigError(
                f"attention_impl must be one of {ATTENTION_IMPLS}, got "
                f"{self.attention_impl!r}"
            )

    @classmethod
    def from_dict(cls, raw: Mapping[str, Any]) -> "TrainingConfig":
        """Build from a spec's `training:` mapping; a field the port does
        not honour raises, naming the ROADMAP item it waits for."""
        _check_keys(raw, cls, _UNPORTED_FIELDS, "")
        return cls(**raw)
