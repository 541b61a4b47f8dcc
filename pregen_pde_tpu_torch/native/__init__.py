"""The C++ shard writer (``shardio.cpp``), built at first use and bound with ctypes.

The port's own copy of the JAX package's ``native`` writer: ``g++ -O3
-shared`` into ``pregen_pde_tpu_torch/_build/native/`` (git-ignored) with the
source hash in the artifact name, so it is rebuilt only when the source
changes. ``available()`` is False when no toolchain exists; the caller then
writes with the Python writer.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
from pathlib import Path

import numpy as np

from pregen_pde_tpu_torch.utils.trace import span

_SRC = Path(__file__).parent / "shardio.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build" / "native"
_LIB = None
_LIB_ERR: str | None = None


def _load():
    global _LIB, _LIB_ERR
    if _LIB is not None or _LIB_ERR is not None:
        return _LIB
    try:
        tag = hashlib.md5(_SRC.read_bytes()).hexdigest()[:12]
        so_path = BUILD_DIR / f"shardio_{tag}.so"
        if not so_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
                            str(_SRC), "-o", str(tmp)], check=True, capture_output=True)
            os.replace(tmp, so_path)  # atomic against concurrent builds
        lib = ctypes.CDLL(str(so_path))
        lib.shard_writer_create.restype = ctypes.c_void_p
        lib.shard_writer_create.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                            ctypes.c_int, ctypes.c_int]
        lib.shard_writer_write.restype = ctypes.c_int
        lib.shard_writer_write.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
                                           ctypes.POINTER(ctypes.c_int64), ctypes.c_int]
        lib.shard_writer_close.restype = ctypes.c_int64
        lib.shard_writer_close.argtypes = [ctypes.c_void_p]
        _LIB = lib
    except (OSError, subprocess.CalledProcessError) as e:  # no toolchain: Python writer
        _LIB_ERR = f"{type(e).__name__}: {e}"
    return _LIB


def available() -> bool:
    return _load() is not None


def load_error() -> str | None:
    _load()
    return _LIB_ERR


class NativeShardWriter:
    """Writes (B, T, H, W, C) float32 batches as numbered npy shards from the
    C++ background thread: ``write_batch`` returns after one copy into the
    native queue; the disk I/O holds no GIL."""

    def __init__(self, out_dir, prefix: str = "results", queue_depth: int = 2,
                 start_index: int = 0):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native shardio unavailable: {_LIB_ERR}")
        self._lib = lib
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.prefix = prefix
        self._h = lib.shard_writer_create(str(self.out_dir).encode(), prefix.encode(),
                                          queue_depth, int(start_index))
        self._n_shards = int(start_index)

    def write_batch(self, arr: np.ndarray):
        if arr.dtype != np.float32:
            raise TypeError(f"native shard writer is float32-only, got {arr.dtype}; "
                            "use ShardWriter(backend='python', dtype=...) for other dtypes")
        arr = np.ascontiguousarray(arr)
        with span("pregen.write", arr.nbytes):
            rc = self._lib.shard_writer_write(
                self._h, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                (ctypes.c_int64 * arr.ndim)(*arr.shape), arr.ndim)
        if rc < 0:
            raise RuntimeError(f"native shard write failed: {rc}")
        self._n_shards += 1

    def close(self, metadata: dict | None = None):
        n = int(self._lib.shard_writer_close(self._h))
        self._h = None
        if n < 0:
            raise RuntimeError(f"native shard writer failed: {n}")
        meta = {"n_trajectories": n, "n_shards": self._n_shards,
                "format": "npy", "backend": "native", **(metadata or {})}
        (self.out_dir / f"{self.prefix}_meta.json").write_text(json.dumps(meta, indent=2))
