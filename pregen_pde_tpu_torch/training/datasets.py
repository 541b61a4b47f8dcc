"""Time-pair datasets over the (N, T, H, W, 6) contract (the port's copy of
the JAX package's ``training/datasets.py``; numpy only, apart from the
span ``pregen.train.load`` around the loader's assembly of a batch).

- sample index = (trajectory, (t1, t2)) where the (t1, t2) table enumerates
  ``t = time_step_size·i → time_step_size·j`` for ``j ≥ i`` with ``(j−i) ∈
  allowed_transitions`` (or ``i = 0`` fixed when transitions is None);
- lead time fed to the model = (t2−t1)/19.0;
- input = all 6 contract channels at t1 (first 3 z-scored) + optional
  constant time channel; label = z-scored [Ux, Uy, p] at t2;
- splits are index ranges over the trajectory axis: train = [0, n),
  val/test = the tail;
- ``make_mixed_datasets``: the difficulty mix of ``mix-sweep``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from pregen_pde_tpu_torch.utils.trace import span

TIME_NORMALIZER = 19.0  # (t2 - t1)/19 — reference `CNO_TimeLoaders.py:229`


@dataclasses.dataclass(frozen=True)
class TimePairConfig:
    max_num_time_steps: int = 20
    time_step_size: int = 1
    allowed_transitions: Sequence[int] | None = None  # None → t1 fixed at 0
    fix_input_to_time_step: int | None = None
    time_input: bool = True  # append constant lead-time channel to the input
    n_val: int = 100
    n_test: int = 100


def build_time_indices(cfg: TimePairConfig) -> list[tuple[int, int]]:
    ts = cfg.time_step_size
    out: list[tuple[int, int]] = []
    if cfg.allowed_transitions is None:
        out = [(0, ts * j) for j in range(cfg.max_num_time_steps + 1)]
    else:
        allowed = set(cfg.allowed_transitions)
        for i in range(cfg.max_num_time_steps + 1):
            for j in range(i, cfg.max_num_time_steps + 1):
                if (j - i) in allowed:
                    out.append((ts * i, ts * j))
    return out


def compute_stats(arrays: Sequence[np.ndarray], n_channels: int = 3,
                  chunk_rows: int = 64):
    """Global mean/std of the first ``n_channels`` across several (N,T,H,W,C)
    arrays — the reference's `streaming_stats` (`mixingexp.py:275-296`).

    Streams `chunk_rows` trajectories at a time (Chan et al. pairwise
    merge), so memmapped 20 GB shards never materialize in RAM — the
    reference streams per-file the same way."""
    count = 0
    mean = np.zeros(n_channels, np.float64)
    m2 = np.zeros(n_channels, np.float64)
    for a in arrays:
        for s in range(0, a.shape[0], chunk_rows):
            x = np.asarray(a[s:s + chunk_rows, ..., :n_channels],
                           np.float64).reshape(-1, n_channels)
            n = x.shape[0]
            if n == 0:
                continue
            new_mean = x.mean(0)
            new_m2 = ((x - new_mean) ** 2).sum(0)
            if count == 0:
                mean, m2, count = new_mean, new_m2, n
            else:
                delta = new_mean - mean
                tot = count + n
                mean = mean + delta * n / tot
                m2 = m2 + new_m2 + delta**2 * count * n / tot
                count = tot
    std = np.sqrt(m2 / max(count, 1))
    std = np.where(std < 1e-10, 1.0, std)
    return mean.astype(np.float32), std.astype(np.float32)


class TimePairDataset:
    """Indexable dataset over one (N, T, H, W, 6) contract array."""

    def __init__(
        self,
        data: np.ndarray,
        cfg: TimePairConfig,
        which: str = "train",
        num_trajectories: int | None = None,
        mean: np.ndarray | None = None,
        std: np.ndarray | None = None,
        out_channels: int = 3,
    ):
        assert data.ndim == 5
        assert which in ("train", "val", "test")
        self.data = data
        self.cfg = cfg
        self.which = which
        self.out_channels = out_channels
        n_max = data.shape[0]
        if n_max < cfg.n_val + cfg.n_test + 1:
            raise ValueError(
                f"dataset has {n_max} trajectories but the split needs "
                f"n_val({cfg.n_val}) + n_test({cfg.n_test}) + >=1 train"
            )
        if mean is None or std is None:
            mean, std = compute_stats([data], out_channels)
        self.mean, self.std = mean, std

        if cfg.fix_input_to_time_step is not None:
            self.time_indices = None
            self.multiplier = cfg.max_num_time_steps
        else:
            self.time_indices = build_time_indices(cfg)
            self.multiplier = len(self.time_indices)

        if which == "train":
            n_train_avail = n_max - cfg.n_val - cfg.n_test
            n = num_trajectories if num_trajectories is not None else n_train_avail
            assert 0 < n <= n_train_avail, (n, n_max)
            self.start, self.n_traj = 0, n
        elif which == "val":
            self.start, self.n_traj = n_max - cfg.n_val - cfg.n_test, cfg.n_val
        else:
            self.start, self.n_traj = n_max - cfg.n_test, cfg.n_test

    def __len__(self) -> int:
        return self.n_traj * self.multiplier

    @property
    def in_channels(self) -> int:
        return self.data.shape[-1] + int(self.cfg.time_input)

    def __getitem__(self, idx: int):
        cfg = self.cfg
        i = idx // self.multiplier
        t_idx = idx % self.multiplier
        if cfg.fix_input_to_time_step is None:
            t1, t2 = self.time_indices[t_idx]
        else:
            # ≡ `scOT/problems/base.py:328-340` _idx_map: t2 carries the
            # fixed-input offset
            t1 = cfg.fix_input_to_time_step
            t2 = cfg.time_step_size * (t_idx + 1) + t1
        time = (t2 - t1) / TIME_NORMALIZER

        sample = self.data[i + self.start]  # (T, H, W, 6)
        inp = sample[t1].astype(np.float32).copy()
        lab = sample[t2, :, :, : self.out_channels].astype(np.float32).copy()
        inp[..., : self.out_channels] = (
            inp[..., : self.out_channels] - self.mean
        ) / self.std
        lab = (lab - self.mean) / self.std
        if cfg.time_input:
            tch = np.full((*inp.shape[:2], 1), time, np.float32)
            inp = np.concatenate([inp, tch], axis=-1)
        return np.float32(time), inp, lab


class ConcatDataset:
    def __init__(self, parts: Sequence):
        self.parts = list(parts)
        self._lens = [len(p) for p in self.parts]

    def __len__(self):
        return sum(self._lens)

    def __getitem__(self, idx):
        for p, n in zip(self.parts, self._lens):
            if idx < n:
                return p[idx]
            idx -= n
        raise IndexError


def make_mixed_datasets(hard: np.ndarray, easy: np.ndarray, alpha: float,
                        total_trajectories: int, cfg: TimePairConfig):
    """Difficulty-mixing construction (`CNO_timeModule_CIN.py:1021-1073`):
    train = α·N hard ⊕ (1−α)·N easy; val and test from each tail; shared
    stats. → (train, val_hard, val_easy, test_hard, test_easy)."""
    n_hard = int(round(alpha * total_trajectories))
    n_easy = total_trajectories - n_hard
    mean, std = compute_stats([hard, easy])
    kw = dict(mean=mean, std=std)
    parts = []
    if n_hard > 0:
        parts.append(TimePairDataset(hard, cfg, "train", n_hard, **kw))
    if n_easy > 0:
        parts.append(TimePairDataset(easy, cfg, "train", n_easy, **kw))
    train = ConcatDataset(parts)
    return (train, TimePairDataset(hard, cfg, "val", **kw), TimePairDataset(easy, cfg, "val", **kw),
            TimePairDataset(hard, cfg, "test", **kw), TimePairDataset(easy, cfg, "test", **kw))


class Subset:
    """View of a sample-style dataset at a fixed index list (rank-strided
    eval shards, debugging slices). Attribute access (``cfg``, ``mean``,
    ``std``, …) forwards to the wrapped dataset."""

    def __init__(self, dataset, indices):
        self._ds = dataset
        self._indices = np.asarray(indices, np.int64)

    def __len__(self):
        return len(self._indices)

    def __getitem__(self, i):
        return self._ds[int(self._indices[i])]

    def __getattr__(self, name):
        return getattr(self._ds, name)


class BatchLoader:
    """Shuffling batch iterator → dict of stacked numpy arrays
    {"time": (B,), "input": (B,H,W,Cin), "label": (B,H,W,Cout)}."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = True):
        self.ds = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last

    def __len__(self):
        n = len(self.ds)
        return n // self.bs if self.drop_last else -(-n // self.bs)

    def __iter__(self):
        order = np.arange(len(self.ds))
        if self.shuffle:
            self.rng.shuffle(order)
        for s in range(0, len(order) - (self.bs - 1 if self.drop_last else 0), self.bs):
            with span("pregen.train.load"):
                idxs = order[s : s + self.bs]
                times, inps, labs = zip(*(self.ds[int(i)] for i in idxs))
                batch = {
                    "time": np.stack(times),
                    "input": np.stack(inps),
                    "label": np.stack(labs),
                }
            yield batch
