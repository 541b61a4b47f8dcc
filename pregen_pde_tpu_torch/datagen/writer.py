"""Streaming shard writers (port of ``datagen/writer.py``).

Batches stream to numbered ``<prefix>_batch_<k>.npy`` shards (or one growable
HDF5 dataset) from a background thread fed by a bounded queue. float32 npy
shards route to the C++ writer of ``pregen_pde_tpu_torch.native`` (numpy +
ctypes) when its toolchain is available.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from pathlib import Path

import numpy as np


class ShardWriter:
    """Writes (B, T, H, W, C) batches as numbered shards ('npy' or 'h5')."""

    def __new__(cls, out_dir, prefix: str = "results", fmt: str = "npy",
                queue_depth: int = 2, backend: str = "auto",
                dtype: str = "float32", start_index: int = 0,
                resume: bool = False):
        # the C++ writer is float32-only; other storage dtypes stay in Python
        if fmt == "npy" and backend in ("auto", "native") and dtype == "float32":
            from pregen_pde_tpu_torch import native

            if native.available():
                return native.NativeShardWriter(out_dir, prefix, queue_depth,
                                                start_index)
            if backend == "native":
                raise RuntimeError(
                    f"native backend requested but unavailable: {native.load_error()}"
                )
        return super().__new__(cls)

    def __init__(self, out_dir: str | os.PathLike, prefix: str = "results",
                 fmt: str = "npy", queue_depth: int = 2, backend: str = "auto",
                 dtype: str = "float32", start_index: int = 0, resume: bool = False):
        if fmt not in ("npy", "h5"):
            raise ValueError(f"unknown format {fmt!r}")
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.prefix = prefix
        self.fmt = fmt
        self._resume = bool(resume)
        self._q: queue.Queue = queue.Queue(maxsize=queue_depth)
        self._idx = int(start_index)
        self._n_written = 0
        self._error: BaseException | None = None
        self._h5 = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                break
            idx, arr = item
            try:
                if self.fmt == "npy":
                    np.save(self.out_dir / f"{self.prefix}_batch_{idx}.npy", arr)
                else:
                    self._h5_append(arr)
                self._n_written += arr.shape[0]
            except BaseException as e:  # re-raised by write_batch / close
                self._error = e
            finally:
                self._q.task_done()

    def _h5_append(self, arr: np.ndarray):
        import h5py

        if self._h5 is None:
            path = self.out_dir / f"{self.prefix}.h5"
            mode = "a" if (self._resume and path.exists()) else "w"
            self._h5 = h5py.File(path, mode)
            if "data" not in self._h5:
                self._h5.create_dataset(
                    "data", shape=(0, *arr.shape[1:]),
                    maxshape=(None, *arr.shape[1:]), dtype=arr.dtype,
                    chunks=(1, *arr.shape[1:]),
                )
        ds = self._h5["data"]
        n0 = ds.shape[0]
        ds.resize(n0 + arr.shape[0], axis=0)
        ds[n0:] = arr
        self._h5.flush()  # batch-granular durability for --resume

    def write_batch(self, arr: np.ndarray):
        if self._error is not None:
            raise RuntimeError("writer thread failed") from self._error
        self._q.put((self._idx, np.ascontiguousarray(arr)))
        self._idx += 1

    def close(self, metadata: dict | None = None):
        self._q.put(None)
        self._thread.join()
        if self._h5 is not None:
            self._h5.close()
            self._h5 = None
        if self._error is not None:
            raise RuntimeError("writer thread failed") from self._error
        meta = {"n_trajectories": self._n_written, "n_shards": self._idx,
                "format": self.fmt, **(metadata or {})}
        (self.out_dir / f"{self.prefix}_meta.json").write_text(json.dumps(meta, indent=2))


def _shard_files(out_dir: Path, prefix: str) -> list[Path]:
    return sorted(out_dir.glob(f"{prefix}_batch_*.npy"),
                  key=lambda p: int(p.stem.rsplit("_", 1)[1]))


def scan_existing_shards(out_dir: str | os.PathLike,
                         prefix: str = "results") -> tuple[int, int]:
    """(next_shard_index, trajectories already written) for ``--resume``."""
    files = _shard_files(Path(out_dir), prefix)
    if not files:
        return 0, 0
    next_idx = int(files[-1].stem.rsplit("_", 1)[1]) + 1
    return next_idx, sum(int(np.load(f, mmap_mode="r").shape[0]) for f in files)


def scan_existing_h5(out_dir: str | os.PathLike, prefix: str = "results") -> int:
    """Trajectories already persisted in a (possibly interrupted) h5 run."""
    path = Path(out_dir) / f"{prefix}.h5"
    if not path.exists():
        return 0
    import h5py

    with h5py.File(path, "r") as f:
        return int(f["data"].shape[0]) if "data" in f else 0


def load_shards(out_dir: str | os.PathLike, prefix: str = "results") -> np.ndarray:
    """Reassemble npy shards into one (N, T, H, W, C) array."""
    files = _shard_files(Path(out_dir), prefix)
    if not files:
        raise FileNotFoundError(f"no shards matching {prefix}_batch_*.npy in {out_dir}")
    return np.concatenate([np.load(f) for f in files], axis=0)
