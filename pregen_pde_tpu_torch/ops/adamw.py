"""AdamW with the global-norm clip on the card: the hand-written kernels of
``csrc/adamw.cu`` and their work lists.

``FusedAdamW`` holds, for one optimizer's leaves on one CUDA device, what
the kernels read besides the tensors: a row per leaf (the parameter's and
its moments' addresses, the group's index, the decay flag) and a row per
chunk (leaf, first element, length; ``CHUNK`` elements at most, never
across a leaf's end), built once, when the optimizer is made or reset, so
the parameters and moments must keep their storage (``load_state_dict``
copies in place; ``step`` raises for a parameter or moment that moved,
or a moment rebound in the optimizer without ``reset()``). Only the
gradients' addresses change (backward allocates them anew): ``step``
gathers them, 0 for a leaf with no gradient (read as zeros), into a reused
page-locked buffer, copies them to the card asynchronously (a buffer is
written again only once the event after its copy has passed), then
launches the clip's norm and the update, two kernels with a clip and one
without, no host sync and no allocation. ``.grad`` is read, not changed.

No TPU kernel corresponds (optax's update is fused by XLA into the JAX
step; ``pregen_pde_tpu/training/fused_optim.py`` is a bucketed jnp option).
``training/optim.py::TieredAdamW`` takes this route for float32,
contiguous leaves on a CUDA device; on the CPU it keeps its ``_foreach``
route, which is the plain version: the kernels repeat its arithmetic
operation by operation (``csrc/adamw.cu``).

``launches`` counts the kernels enqueued (the C entry point reports its
launches): 2 a step with the clip, 1 without.
"""

from __future__ import annotations

import ctypes
import itertools
import math

import numpy as np
import torch

from pregen_pde_tpu_torch.kernels import build as _build

__all__ = ["LIB_NAME", "CHUNK", "MAX_GROUPS", "FusedAdamW", "on_card", "chunk_table",
           "leaf_table", "launches", "reset_launches"]

LIB_NAME = "adamw"
CHUNK = 16384  # elements a block updates (a multiple of 4: chunks keep a leaf's alignment)
MAX_GROUPS = 8  # the kernel's array of learning rates
HOST_SLOTS = 4  # page-locked address buffers in turn
LEAF_DTYPE = np.dtype([("p", "<i8"), ("m", "<i8"), ("v", "<i8"), ("group", "<i4"),
                       ("decay", "<i4")])

launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def on_card(params) -> bool:
    """Whether an optimizer over ``params`` takes the kernels: any leaf on a
    CUDA device (``FusedAdamW`` then raises for one it does not take)."""
    return any(p.device.type == "cuda" for p in params)


def chunk_table(numels, chunk: int = CHUNK) -> np.ndarray:
    """(n_chunks, 3) int32 rows (leaf, first element, length) covering
    every element of every leaf once, in leaf order: ``chunk`` elements a
    row, a leaf's last row the rest; an empty leaf has none."""
    if chunk <= 0 or chunk % 4:
        raise ValueError(f"chunk must be a positive multiple of 4, got {chunk}")
    numels = np.asarray(list(numels), dtype=np.int64)
    if numels.size and (numels.min() < 0 or numels.max() >= 2 ** 31):
        raise ValueError("a leaf's numel must be in [0, 2**31)")
    per_leaf = -(-numels // chunk)
    leaf = np.repeat(np.arange(numels.size, dtype=np.int64), per_leaf)
    first = np.cumsum(per_leaf) - per_leaf
    start = (np.arange(leaf.size, dtype=np.int64) - np.repeat(first, per_leaf)) * chunk
    length = np.minimum(numels[leaf] - start, chunk)
    return np.stack([leaf, start, length], axis=1).astype(np.int32)


def leaf_table(params, m, v, group, decay) -> np.ndarray:
    """A ``LEAF_DTYPE`` row per leaf: the addresses of p, m and v, the
    group's index, the decay flag."""
    rows = np.zeros(len(params), dtype=LEAF_DTYPE)
    rows["p"] = [t.data_ptr() for t in params]
    rows["m"] = [t.data_ptr() for t in m]
    rows["v"] = [t.data_ptr() for t in v]
    rows["group"] = group
    rows["decay"] = decay
    return rows


_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_typed: dict = {}


def _lib() -> ctypes.CDLL:
    """The loaded library, its entry points typed and its rows' sizes checked once."""
    lib = _build.load(LIB_NAME)
    if _typed.get("lib") is not lib:
        lib.adamw_step.argtypes = [_P] * 6 + [_I, _I, _F, ctypes.POINTER(_F), _I] + [_F] * 8 + [
            _P, ctypes.POINTER(_I)]
        lib.adamw_step.restype = _I
        lib.adamw_row_bytes.argtypes = [_I]
        lib.adamw_row_bytes.restype = _I
        if (lib.adamw_row_bytes(0), lib.adamw_row_bytes(1)) != (LEAF_DTYPE.itemsize, 12):
            raise RuntimeError("csrc/adamw.cu's rows differ from ops/adamw.py's layout")
        _typed["lib"] = lib
    return lib


class FusedAdamW:
    """The kernels' work lists for ``params`` (each float32, contiguous, on
    one CUDA device) and their moments ``m``, ``v``; ``group[i]`` is leaf
    i's group (fewer than ``MAX_GROUPS``), ``decay[i]`` whether it decays."""

    def __init__(self, params, m, v, group, decay):
        dev = params[0].device
        for name, ts in (("parameter", params), ("first moment", m), ("second moment", v)):
            for t in ts:
                if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
                    raise ValueError(f"the fused AdamW takes float32, contiguous leaves on one "
                                     f"CUDA device; a {name} is {t.dtype} on {t.device}"
                                     f"{'' if t.is_contiguous() else ', not contiguous'}")
        if len(group) and max(group) >= MAX_GROUPS:
            raise ValueError(f"the fused AdamW takes at most {MAX_GROUPS} groups")
        _lib()
        self.device = dev
        self.params = list(params)
        self._tensors = (list(m), list(v))  # the moments the rows point at
        self._ptrs = [t.data_ptr() for t in itertools.chain(self.params, m, v)]
        chunks = chunk_table(p.numel() for p in self.params)
        self.n_chunks = len(chunks)
        self.chunks = torch.from_numpy(chunks).to(dev)
        rows = leaf_table(self.params, m, v, group, decay)
        self.leaves = torch.from_numpy(rows.view(np.uint8)).to(dev)
        self.grad_ptrs = torch.zeros(len(self.params), dtype=torch.int64, device=dev)
        self.partials = torch.empty(max(self.n_chunks, 1), dtype=torch.float32, device=dev)
        self.clip_out = torch.zeros(3, dtype=torch.float32, device=dev)  # norm, divisor, factor
        self.ticket = torch.zeros(1, dtype=torch.int32, device=dev)
        self._host = [torch.empty(len(self.params), dtype=torch.int64, pin_memory=True)
                      for _ in range(HOST_SLOTS)]
        self._copied: list = [None] * HOST_SLOTS
        self._slot = 0

    def _gather_grads(self, m, v) -> int:
        """The gradients' addresses into the next page-locked buffer → its
        slot, once the parameters and the moments ``m``, ``v`` the optimizer
        holds now (in leaf order) are found where the rows point."""
        now = list(map(torch.Tensor.data_ptr, itertools.chain(self.params, m, v)))
        if now != self._ptrs:
            raise RuntimeError("a parameter's or a moment's storage moved since the optimizer "
                               "was built or reset; the fused AdamW's rows point at the old one")
        grads = [p.grad for p in self.params]
        if not all(g is None or g.is_contiguous() for g in grads):
            raise ValueError("the fused AdamW takes contiguous gradients")
        slot = self._slot
        self._slot = (slot + 1) % HOST_SLOTS
        if self._copied[slot] is not None:
            self._copied[slot].synchronize()  # that buffer's last copy has been made
        self._host[slot].numpy()[:] = [0 if g is None else g.data_ptr() for g in grads]
        return slot

    @torch.no_grad()
    def step(self, m, v, neg_lr, bc1: float, bc2: float, b1: float, b2: float, eps: float,
             weight_decay: float, grad_clip: float | None) -> None:
        """One update from the leaves' ``.grad`` of the moments ``m``, ``v``
        (those the rows were built over, checked): ``neg_lr`` the −lr of each
        group, ``bc1``, ``bc2`` the bias corrections at this step; the
        scalars are rounded to float32 as the ``_foreach`` ops round them
        (a division by a scalar as the product with its reciprocal)."""
        global launches
        if self.device.index != torch.cuda.current_device():
            with torch.cuda.device(self.device):
                return self.step(m, v, neg_lr, bc1, bc2, b1, b2, eps, weight_decay, grad_clip)
        slot = self._gather_grads(m, v)
        stream = torch.cuda.current_stream(self.device)
        self.grad_ptrs.copy_(self._host[slot], non_blocking=True)
        self._copied[slot] = torch.cuda.Event()
        self._copied[slot].record(stream)
        n = ctypes.c_int(0)
        rc = _lib().adamw_step(
            self.chunks.data_ptr(), self.leaves.data_ptr(), self.grad_ptrs.data_ptr(),
            self.partials.data_ptr(), self.clip_out.data_ptr(), self.ticket.data_ptr(),
            self.n_chunks, grad_clip is not None,
            grad_clip if grad_clip is not None else math.inf, (_F * MAX_GROUPS)(*neg_lr),
            len(neg_lr), b1, 1.0 - b1, b2, 1.0 - b2, 1.0 / bc1, 1.0 / bc2, eps, weight_decay,
            stream.cuda_stream, ctypes.byref(n))
        if rc != 0:
            raise RuntimeError(f"{LIB_NAME}.adamw_step failed with CUDA error {rc}")
        launches += n.value
