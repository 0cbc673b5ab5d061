"""The native shard prefetcher over ctypes (port of
kubeflow_tpu/native/shard_prefetch.py).

`ShardPrefetcher` streams whole shard files through the C++ reader pool
(native/shard_loader/shard_loader.cc, built by native/build.py
`shard_loader_lib_path`): reads overlap the caller's work, shards arrive
strictly in list order (epoch determinism for restart and resume), and
resident memory is bounded by `prefetch_depth` shards. Each shard is
copied out of the C buffer into Python bytes before its release. Where
the library cannot be built (no g++), it reads the files in Python, as
the JAX package does, and logs that once; `native_loaded()` says which,
so a caller that must have the native reader can refuse the fallback.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Iterator, List, Optional, Sequence, Tuple

from kubeflow_tpu_torch.native.build import (
    NativeBuildError,
    shard_loader_lib_path,
)
from kubeflow_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _load_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, or None (a failed build is remembered: a host
    without a toolchain does not try again at every dataset open)."""
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            path = shard_loader_lib_path()
        except NativeBuildError as e:
            _load_failed = True
            log.warning("shard_loader unavailable (%s); python IO fallback", e)
            return None
        lib = ctypes.CDLL(path)
        lib.sl_open.restype = ctypes.c_void_p
        lib.sl_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                                ctypes.c_int, ctypes.c_int]
        lib.sl_next.restype = ctypes.c_int
        lib.sl_next.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int),
        ]
        lib.sl_release.restype = None
        lib.sl_release.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.sl_close.restype = None
        lib.sl_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def native_loaded() -> bool:
    """Is the native reader loaded (building it if needed)?"""
    return _load_lib() is not None


class ShardPrefetcher:
    """Iterate (path, bytes) over shard files with native read-ahead.

    with ShardPrefetcher(paths) as shards:
        for path, blob in shards:
            arrays = np.load(io.BytesIO(blob))
    """

    def __init__(self, paths: Sequence[str], prefetch_depth: int = 4,
                 n_threads: int = 2, force_python: bool = False):
        self.paths: List[str] = list(paths)
        self.prefetch_depth = max(1, prefetch_depth)
        self.n_threads = max(1, n_threads)
        self._lib = None if force_python else _load_lib()
        self._handle: Optional[int] = None
        self.native = self._lib is not None

    def __enter__(self) -> "ShardPrefetcher":
        if self._lib is not None and self.paths:
            # the array of path pointers lives as long as the pool reads
            self._paths_c = (ctypes.c_char_p * len(self.paths))(
                *[p.encode() for p in self.paths])
            self._handle = self._lib.sl_open(
                self._paths_c, len(self.paths), self.prefetch_depth,
                self.n_threads)
            if not self._handle:
                raise RuntimeError("sl_open failed")
        return self

    def close(self) -> None:
        """Release the native pool. Idempotent: the handle is detached
        before sl_close runs, so a second close never frees it twice."""
        handle, self._handle = self._handle, None
        if handle and self._lib is not None:
            self._lib.sl_close(handle)

    def __exit__(self, *exc) -> None:
        self.close()

    def __iter__(self) -> Iterator[Tuple[str, bytes]]:
        if self._lib is None or not self.paths:
            for p in self.paths:  # the fallback: plain sequential reads
                with open(p, "rb") as f:
                    yield p, f.read()
            return
        if self._handle is None:
            raise RuntimeError("use `with ShardPrefetcher(...) as s:`")
        path_p = ctypes.c_char_p()
        data_p = ctypes.POINTER(ctypes.c_uint8)()
        size = ctypes.c_int64()
        index = ctypes.c_int()
        while True:
            rc = self._lib.sl_next(self._handle, ctypes.byref(path_p),
                                   ctypes.byref(data_p), ctypes.byref(size),
                                   ctypes.byref(index))
            if rc == 0:
                return
            path = (path_p.value or b"").decode()
            if rc < 0:
                self._lib.sl_release(self._handle, index.value)
                # close now: the raise unwinds into the with block, whose
                # exit then finds no handle to close again
                self.close()
                raise OSError(f"shard read failed: {path}")
            blob = ctypes.string_at(data_p, size.value)
            self._lib.sl_release(self._handle, index.value)
            yield path, blob
