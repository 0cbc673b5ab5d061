"""On-disk checkpoint layout (port of kubeflow_tpu/checkpointing/layout.py):
step directories, shard files, the manifest. The format is the JAX
package's, byte for byte, so a checkpoint written by either package is
read by the other.

One checkpoint directory holds one step directory per saved step:

    <directory>/
      step_00000010/
        l00000.full.bin            # one raw little-endian buffer per shard
        l00001.0-4_0-16.bin        # dims joined by '_', 'start-stop' per dim
        manifest.json              # written LAST: the commit record
      step_00000020/ ...

The commit protocol is two-phase and rename-atomic:

1. every host writes its shards, each to a temp name in the step
   directory and `os.rename`d into place (a shard file either exists
   complete or not at all);
2. process 0, once every expected shard file is present, writes
   `manifest.json` the same way (temp + rename).

A step directory is *committed* iff `manifest.json` exists. A kill at any
point mid-save leaves either a missing step directory or an uncommitted
one; readers ignore both, so `latest` can never name a torn checkpoint.
The manifest records, per leaf, the global shape/dtype and every shard
file with the global index range it covers, so a reader assembles any
region from the overlapping files, whatever layout saved them.

Dtypes go by their numpy names. The port reads and writes them through
torch dtypes: bf16 is its raw 2-byte buffer under the name "bfloat16",
read back as uint16 and viewed as torch.bfloat16. A name torch cannot
hold (a `float8_*` leaf of a JAX checkpoint) raises, naming the leaf.
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

MANIFEST = "manifest.json"
FORMAT = "kft-checkpoint-v1"
_STEP_PREFIX = "step_"
_URL_SCHEME = re.compile(r"^[a-zA-Z][a-zA-Z0-9+.-]*://")


def local_checkpoint_dir(directory: str) -> str:
    """Normalize a checkpoint directory, rejecting object-store URLs.

    The subsystem is filesystem-native (rename-atomic commit), so a
    bucket must be mounted (GCS Fuse, PVC) and addressed by its mount
    path. Failing loudly here beats os.path.abspath silently mangling
    'gs://b/run' into a pod-local relative path: saves that land on
    ephemeral disk 'succeed' until the reschedule that finds no
    checkpoint and restarts from step 0."""
    if _URL_SCHEME.match(directory):
        raise ValueError(
            f"checkpoint directory {directory!r} uses a URL scheme; the "
            f"checkpoint subsystem is filesystem-native — mount the bucket "
            f"(GCS Fuse / PVC) and point checkpoint.directory at the mount "
            f"path (docs/CHECKPOINTING.md)"
        )
    return os.path.abspath(os.path.expanduser(directory))


# ((start, stop), ...) per dim; () for scalars.
IndexRanges = Tuple[Tuple[int, int], ...]


def step_dir_name(step: int) -> str:
    return f"{_STEP_PREFIX}{step:08d}"


def step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, step_dir_name(step))


def parse_step(name: str) -> Optional[int]:
    if not name.startswith(_STEP_PREFIX):
        return None
    try:
        return int(name[len(_STEP_PREFIX):])
    except ValueError:
        return None


def is_committed(directory: str, step: int) -> bool:
    return os.path.exists(os.path.join(step_dir(directory, step), MANIFEST))


def committed_steps(directory: str) -> List[int]:
    """Sorted steps whose directories carry a manifest (torn saves excluded)."""
    if not os.path.isdir(directory):
        return []
    steps = []
    for name in os.listdir(directory):
        step = parse_step(name)
        if step is not None and is_committed(directory, step):
            steps.append(step)
    return sorted(steps)


def uncommitted_step_dirs(directory: str) -> List[str]:
    """Step directories without a manifest: torn or in-flight saves."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        step = parse_step(name)
        if step is not None and not is_committed(directory, step):
            out.append(os.path.join(directory, name))
    return sorted(out)


def shard_filename(leaf_id: int, ranges: IndexRanges) -> str:
    """Deterministic shard file name: every host derives the same name for
    the same global region, so process 0 can enumerate the files it must
    wait for without any cross-host message."""
    if not ranges:
        span = "full"
    else:
        span = "_".join(f"{a}-{b}" for a, b in ranges)
    return f"l{leaf_id:05d}.{span}.bin"


def atomic_write_bytes(path: str, data) -> None:
    """Write-then-rename in the target directory: the file either exists
    with the full contents or not at all (POSIX rename atomicity). `data`
    is any buffer-protocol object; the writer passes array views directly
    so multi-GB shards are never copied into an intermediate bytes object.

    Deliberately does NOT fsync the parent directory: crash-ordering
    (no shard rename may be lost while the later manifest rename persists)
    needs only ONE directory fsync between the shard phase and the
    manifest write, which the writer makes with fsync_dir."""
    dirpath = os.path.dirname(path)
    fd, tmp = tempfile.mkstemp(
        dir=dirpath, prefix=os.path.basename(path) + ".tmp"
    )
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def fsync_dir(dirpath: str) -> None:
    """Flush a directory's entries (file renames) to stable storage.

    Called once after the shard phase and once more after the commit
    barrier, BEFORE the manifest write: if the manifest's rename survives
    a power loss, every shard rename it lists is already durable; losing
    the manifest rename itself merely leaves the step uncommitted, which
    readers treat as absent."""
    dfd = os.open(dirpath, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def write_manifest(dirpath: str, manifest: Dict[str, Any]) -> None:
    atomic_write_bytes(
        os.path.join(dirpath, MANIFEST),
        json.dumps(manifest, indent=1, sort_keys=True).encode(),
    )


def read_manifest(dirpath: str) -> Dict[str, Any]:
    with open(os.path.join(dirpath, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT:
        raise ValueError(
            f"unrecognized checkpoint format {manifest.get('format')!r} "
            f"in {dirpath} (expected {FORMAT})"
        )
    return manifest


def path_str(parts: Sequence) -> str:
    """'/'-joined key path: the manifest leaf key (e.g.
    'params/layer_0/attention/query/kernel', 'opt_state/1/0/mu/...')."""
    return "/".join(str(p) for p in parts)


# numpy dtype names (the manifest's) ↔ torch dtypes
_TORCH_DTYPES = {
    "float64": torch.float64, "float32": torch.float32,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def dtype_name(dtype: torch.dtype) -> str:
    try:
        return _DTYPE_NAMES[dtype]
    except KeyError:
        raise ValueError(f"checkpoint: no manifest name for {dtype}") from None


def dtype_from_name(name: str, leaf: str = "") -> torch.dtype:
    """The torch dtype of a manifest dtype name; a name torch cannot hold
    here (float8_* and the other ml_dtypes extensions) raises, naming
    `leaf`."""
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise ValueError(
            f"checkpoint leaf {leaf!r} has dtype {name!r}, which the port "
            f"cannot read (known: {sorted(_TORCH_DTYPES)})"
        ) from None


def intersect_ranges(
    a: IndexRanges, b: IndexRanges
) -> Optional[IndexRanges]:
    """Overlap of two global regions, or None when empty."""
    out = []
    for (a0, a1), (b0, b1) in zip(a, b):
        lo, hi = max(a0, b0), min(a1, b1)
        if lo >= hi:
            return None
        out.append((lo, hi))
    return tuple(out)


def ranges_shape(ranges: IndexRanges) -> Tuple[int, ...]:
    return tuple(b - a for a, b in ranges)
