"""The generators' device-to-host fetch into reused page-locked buffers.

``to_host(t)`` returns ``t`` as a host ndarray, as ``t.cpu().numpy()`` does.
For a CUDA tensor the copy goes into a page-locked host buffer of exactly
``t``'s byte size, taken from a process-wide pool: one DMA
(``copy_(non_blocking=True)``, a ``Memcpy DtoH`` on the current stream) at
the link's rate, waited for before the array is returned. ``.cpu()`` copies
instead into pageable memory allocated fresh for every batch, which CUDA
stages through a page-locked bounce buffer of its own while the host faults
in every new page.

The returned array is a fresh ndarray over the buffer whose base is a
``_Lease``; every view of the array holds the array, so the buffer goes back
to the pool only once the array and all its views are dropped
(``weakref.finalize`` on the lease). Nothing overwrites an array while it is
held: a caller may keep any number of them (a writer's queue, a retry's
``frames[bad] = ...``).

The pool holds at most ``CAP_SHARE`` of the host's physical memory in
page-locked bytes. A fetch of a size with no free buffer pins a new one in
the span ``pregen.fetch.pin`` (its bytes), first releasing free buffers of
other sizes where the cap requires; when the held buffers leave no room, it
takes the pageable path in the span ``pregen.fetch.pageable``. A CPU tensor
takes ``.cpu().numpy()`` as before.
"""

from __future__ import annotations

import collections
import mmap
import os
import threading
import weakref

import numpy as np
import torch

from pregen_pde_tpu_torch.utils.trace import span

# the pool's cap on page-locked bytes, as a share of the host's physical memory
CAP_SHARE = 0.25


def host_memory_bytes() -> int:
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def pin_alloc(nbytes: int) -> np.ndarray:
    """``nbytes`` of anonymous memory, page-aligned, registered with CUDA as
    page-locked, as a uint8 ndarray that unregisters it when it is collected
    (before its pages are unmapped, which a new mapping may reuse). Not
    ``torch``'s caching host allocator, which rounds a size up to the next
    power of two; not write-combined, which the host reads slowly."""
    cudart = torch.cuda.cudart()
    block = np.frombuffer(mmap.mmap(-1, nbytes), np.uint8)
    addr = block.ctypes.data
    # cudaHostRegisterPortable: page-locked for every CUDA context
    err = cudart.cudaHostRegister(addr, nbytes, 1)
    if int(err) != 0:
        raise RuntimeError(f"cudaHostRegister of {nbytes} bytes failed: "
                           f"{cudart.cudaGetErrorString(err)}")
    weakref.finalize(block, cudart.cudaHostUnregister, addr).atexit = False
    return block


class _Lease:
    """One fetch's hold on a pooled buffer: the base of the array it
    returns."""

    __slots__ = ("__array_interface__", "block", "__weakref__")

    def __init__(self, block: np.ndarray, shape: tuple, dtype: np.dtype):
        self.block = block
        self.__array_interface__ = {"shape": shape, "typestr": dtype.str,
                                    "data": (block.ctypes.data, False), "version": 3}


class HostPool:
    """Host buffers reused across fetches, keyed by exact byte size, at most
    ``cap_bytes`` of them in all. ``alloc(nbytes)`` returns a uint8 ndarray
    of ``nbytes`` that frees itself when it is collected (``pin_alloc`` by
    default; tests pass plain host memory)."""

    def __init__(self, cap_bytes: int, alloc=pin_alloc):
        self.cap_bytes = int(cap_bytes)
        self._alloc = alloc
        self._free: dict[int, list[np.ndarray]] = {}
        self._bytes = 0  # every buffer's, free and held
        # buffers whose arrays were dropped; finalizers only append, so one
        # run by the garbage collector in the middle of a fetch is harmless
        self._returned: collections.deque = collections.deque()
        self._lock = threading.Lock()

    @property
    def pinned_bytes(self) -> int:
        return self._bytes

    def _take(self, nbytes: int) -> np.ndarray | None:
        """A free buffer of ``nbytes``, a new one, or None (the pageable
        path)."""
        with self._lock:
            while self._returned:
                block = self._returned.popleft()
                self._free.setdefault(block.nbytes, []).append(block)
            if self._free.get(nbytes):
                return self._free[nbytes].pop()
            for size in list(self._free):  # above the cap: other sizes go first
                while self._free[size] and self._bytes + nbytes > self.cap_bytes:
                    self._free[size].pop()
                    self._bytes -= size
                if not self._free[size]:
                    del self._free[size]
            if self._bytes + nbytes > self.cap_bytes:
                return None
            with span("pregen.fetch.pin", nbytes):
                block = self._alloc(nbytes)
            self._bytes += nbytes
            return block

    def fetch(self, t: torch.Tensor) -> np.ndarray:
        """``t`` as a host ndarray over a pooled buffer (or pageable memory
        where the pool has no room)."""
        dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
        nbytes = t.numel() * dtype.itemsize
        block = self._take(nbytes)
        if block is None:
            with span("pregen.fetch.pageable", nbytes):
                return t.cpu().numpy()
        lease = _Lease(block, tuple(t.shape), dtype)
        weakref.finalize(lease, self._returned.append, block).atexit = False
        out = np.asarray(lease)
        if t.is_cuda:
            torch.from_numpy(out).copy_(t, non_blocking=True)
            torch.cuda.current_stream(t.device).synchronize()
        else:
            torch.from_numpy(out).copy_(t)
        return out


_pool: HostPool | None = None
_pool_lock = threading.Lock()


def pool() -> HostPool:
    """The process-wide pool of page-locked buffers."""
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = HostPool(int(CAP_SHARE * host_memory_bytes()))
        return _pool


def to_host(t: torch.Tensor) -> np.ndarray:
    """``t.cpu().numpy()``, through the pool of page-locked buffers for a
    non-empty CUDA tensor."""
    if not t.is_cuda or t.numel() == 0:
        return t.cpu().numpy()
    return pool().fetch(t)
