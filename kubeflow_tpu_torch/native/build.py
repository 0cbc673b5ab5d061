"""Build the port's CUDA kernels at first use and load them with ctypes
(the role kubeflow_tpu/native/build.py plays for the C++ components).

Each `ops/csrc/<name>.cu` has a plain C interface and includes no
PyTorch header, so one nvcc call builds it in seconds:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/<name>-<hash>.so <name>.cu

The library name carries a hash of the flags, the source and every
header of ops/csrc it includes (`#include "..."`, directly or through
another header), so a stale build is never loaded; a finished build is
reused by later processes in the same checkout. Pointer and stream
arguments go through ctypes as `c_void_p`; every C entry point returns
`cudaGetLastError()` and the caller raises when it is not 0. A failed
build raises with nvcc's output. Nothing here runs at import time.

`shard_loader_lib_path` builds the repo's C++ shard reader
(native/shard_loader/shard_loader.cc, where the JAX package's build
also finds it) with g++ and the flags of its Makefile into
build/native_torch/ (the JAX package's build writes build/ itself, so
the two never share a file), under a name hashed like a kernel's. The
library is written to a temporary name and renamed into place, so
processes building at once (test workers) never load a half-written one.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, List, Optional

PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(PACKAGE_ROOT)
CSRC_DIR = os.path.join(PACKAGE_ROOT, "ops", "csrc")
BUILD_DIR = os.path.join(REPO_ROOT, "build", "kernels")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# ptxas register/shared-memory report of each library this process built
# or found built (nvcc's output, kept beside the library as <name>.so.log)
build_logs: Dict[str, str] = {}


class KernelBuildError(RuntimeError):
    pass


SHARD_LOADER_SRC = os.path.join(REPO_ROOT, "native", "shard_loader",
                                "shard_loader.cc")
NATIVE_BUILD_DIR = os.path.join(REPO_ROOT, "build", "native_torch")
# native/shard_loader/Makefile's CXXFLAGS and -shared
GXX_FLAGS = ("-O2", "-std=c++17", "-Wall", "-Wextra", "-fPIC", "-pthread",
             "-shared")


class NativeBuildError(RuntimeError):
    pass


def shard_loader_lib_path() -> str:
    """The built shard reader library, building it first when needed.
    Raises NativeBuildError without g++ or when the build fails."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise NativeBuildError("g++ not available")
    with open(SHARD_LOADER_SRC, "rb") as fh:
        digest = hashlib.sha256(" ".join(GXX_FLAGS).encode() + b"\0"
                                + fh.read()).hexdigest()[:16]
    out = os.path.join(NATIVE_BUILD_DIR, f"libshard_loader-{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(NATIVE_BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run([gxx, *GXX_FLAGS, "-o", tmp, SHARD_LOADER_SRC],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise NativeBuildError(
            f"building shard_loader failed:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelBuildError("nvcc not found (no CUDA toolkit on PATH)")


def kernel_sources() -> List[str]:
    """Names of every kernel source under ops/csrc (without .cu)."""
    return sorted(
        f[:-3] for f in os.listdir(CSRC_DIR) if f.endswith(".cu")
    )


_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def source_files(name: str) -> List[str]:
    """ops/csrc/<name>.cu and every file of ops/csrc it includes with
    quotes, directly or through another header, each once, in the order
    they are first met."""
    files, todo = [], [f"{name}.cu"]
    while todo:
        f = todo.pop(0)
        if f in files:
            continue
        path = os.path.join(CSRC_DIR, f)
        if not os.path.exists(path):
            raise KernelBuildError(f"{f} (a source of {name}) is not in "
                                   f"{CSRC_DIR}")
        files.append(f)
        with open(path, "rb") as fh:
            todo += [m.decode() for m in _INCLUDE.findall(fh.read())]
    return files


def _library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in source_files(name):
        with open(os.path.join(CSRC_DIR, f), "rb") as fh:
            digest.update(f.encode() + b"\0" + fh.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def _tmp_path(name: str) -> str:
    return f"{_library_path(name)}.{os.getpid()}.tmp"


def _start_build(name: str) -> Optional[subprocess.Popen]:
    """Start nvcc for `name` unless its library is already built with its
    report (which then goes into build_logs)."""
    report = _library_path(name) + ".log"
    if os.path.exists(_library_path(name)) and os.path.exists(report):
        if name not in build_logs:
            with open(report) as f:
                build_logs[name] = f.read()
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", _tmp_path(name),
           os.path.join(CSRC_DIR, f"{name}.cu")]
    return subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )


def _finish_build(name: str, proc: subprocess.Popen) -> None:
    output, _ = proc.communicate()
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc failed for {name}.cu:\n{output}")
    # the report first, then the library (atomic: a concurrent loader never
    # sees a half-written one), so a built library always has its report
    with open(_library_path(name) + ".log", "w") as f:
        f.write(output)
    os.replace(_tmp_path(name), _library_path(name))
    build_logs[name] = output


def build_all(names: Optional[List[str]] = None) -> Dict[str, str]:
    """Build every kernel source (or `names`), one nvcc per source, all
    started together. Returns {name: library path}."""
    names = list(names or kernel_sources())
    with _lock:
        procs = {n: _start_build(n) for n in names}
        errors = []
        for n, proc in procs.items():
            if proc is None:
                continue
            try:  # wait for every nvcc, failed or not, before raising
                _finish_build(n, proc)
            except KernelBuildError as e:
                errors.append(str(e))
        if errors:
            raise KernelBuildError("\n".join(errors))
    return {n: _library_path(n) for n in names}


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ops/csrc/<name>.cu, building it first when
    needed. One load per process."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    path = build_all([name])[name]
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(path)
            _loaded[name] = lib
    return lib
