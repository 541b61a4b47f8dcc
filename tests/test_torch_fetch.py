"""The pool of reused host buffers behind the generators' fetch
(``datagen/fetch.py``), on the CPU: plain host memory stands in for
page-locking, so the bookkeeping runs here as it runs on a card."""

import gc
import weakref

import numpy as np
import pytest
import torch

from pregen_pde_tpu_torch.datagen import fetch
from pregen_pde_tpu_torch.utils import trace

from torch_threads import _one_torch_thread  # noqa: F401 (autouse)


class PlainHost:
    """An ``alloc`` over plain host memory that records each buffer made and
    each one collected."""

    def __init__(self, fail: bool = False):
        self.allocs: list[int] = []
        self.releases: list[int] = []
        self.fail = fail

    def alloc(self, nbytes: int) -> np.ndarray:
        if self.fail:
            raise RuntimeError("no page-locked memory")
        self.allocs.append(nbytes)
        block = np.full(nbytes, 0xAB, np.uint8)  # garbage a missed copy would show
        weakref.finalize(block, self.releases.append, nbytes)
        return block


def _pool(cap: int, host: PlainHost | None = None):
    host = host or PlainHost()
    return fetch.HostPool(cap, alloc=host.alloc), host


def _calls(name: str) -> int:
    return trace.totals().get(name, {}).get("calls", 0)


def _src(seed: int, shape=(3, 4, 5), dtype=torch.float32) -> torch.Tensor:
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)).to(dtype)


@pytest.fixture(autouse=True)
def _fresh_totals():
    trace.reset()
    yield
    gc.collect()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_values_are_byte_equal_to_the_source(dtype):
    pool, _ = _pool(1 << 20)
    t = _src(0, (2, 3, 8, 8, 6), dtype)
    got = pool.fetch(t)
    want = t.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    assert not np.shares_memory(got, want)


def test_held_arrays_are_never_overwritten():
    pool, host = _pool(1 << 20)
    srcs = [_src(k) for k in range(4)]
    held = [pool.fetch(s) for s in srcs[:3]]
    fourth = pool.fetch(srcs[3])
    for got, s in zip(held + [fourth], srcs):
        assert got.tobytes() == s.numpy().tobytes()
    assert len(host.allocs) == 4
    assert _calls("pregen.fetch.pin") == 4 and _calls("pregen.fetch.pageable") == 0


def test_a_view_keeps_its_buffer_held():
    pool, host = _pool(1 << 20)
    a, b = _src(1), _src(2)
    view = pool.fetch(a)[1:, ::2]  # the array itself is dropped at once
    gc.collect()
    again = pool.fetch(b)
    assert len(host.allocs) == 2  # the view's buffer was not handed out
    assert view.tobytes() == a.numpy()[1:, ::2].tobytes()
    assert again.tobytes() == b.numpy().tobytes()
    # a tensor over the array holds it too
    t = torch.from_numpy(pool.fetch(a))
    del view, again
    gc.collect()
    pool.fetch(b)
    assert t.numpy().tobytes() == a.numpy().tobytes()


def test_a_dropped_arrays_buffer_is_reused():
    pool, host = _pool(1 << 20)
    addrs = set()
    for k in range(5):
        got = pool.fetch(_src(k))
        assert got.tobytes() == _src(k).numpy().tobytes()
        addrs.add(got.ctypes.data)
        del got
    assert _calls("pregen.fetch.pin") == 1 and _calls("pregen.fetch.pageable") == 0
    assert len(host.allocs) == 1 and len(addrs) == 1
    assert trace.totals()["pregen.fetch.pin"]["bytes"] == 3 * 4 * 5 * 4


def test_buffer_sizes_are_exact():
    pool, host = _pool(1 << 20)
    shapes = [((3, 4, 5), torch.float32), ((3, 4, 5), torch.float16), ((7, 11), torch.float32)]
    for shape, dtype in shapes:
        pool.fetch(_src(0, shape, dtype))
    assert host.allocs == [240, 120, 308]
    assert pool.pinned_bytes == 668
    # a size with no free buffer of its own gets a new one, never a larger one
    pool.fetch(_src(0, (3, 4, 4), torch.float32))
    assert host.allocs[-1] == 192


def test_the_cap_releases_other_sizes_then_falls_back_to_pageable():
    nbytes = 3 * 4 * 5 * 4
    pool, host = _pool(2 * nbytes)
    small = pool.fetch(_src(0, (3, 4, 2)))  # 96 bytes, held
    del small
    gc.collect()
    held = [pool.fetch(_src(k)) for k in range(2)]
    assert host.releases == [96]  # the free buffer of another size went first
    assert pool.pinned_bytes == 2 * nbytes
    third = pool.fetch(_src(2))  # every buffer held, no room for another
    assert _calls("pregen.fetch.pageable") == 1 and len(host.allocs) == 3
    assert trace.totals()["pregen.fetch.pageable"]["bytes"] == nbytes
    assert third.tobytes() == _src(2).numpy().tobytes()
    for k, got in enumerate(held):
        assert got.tobytes() == _src(k).numpy().tobytes()
    # larger than the cap: pageable, nothing released
    pool.fetch(_src(3, (3, 4, 11)))
    assert _calls("pregen.fetch.pageable") == 2 and host.releases == [96]


def test_a_failed_pin_raises_and_keeps_the_books():
    host = PlainHost(fail=True)
    pool, _ = _pool(1 << 20, host)
    with pytest.raises(RuntimeError, match="no page-locked memory"):
        pool.fetch(_src(0))
    assert pool.pinned_bytes == 0
    host.fail = False
    got = pool.fetch(_src(0))
    assert got.tobytes() == _src(0).numpy().tobytes() and pool.pinned_bytes == 240


def test_a_dropped_pool_frees_its_buffers():
    """Once a dropped pool's arrays are dropped too, every buffer it made is
    collected (on a card: unregistered before its pages are unmapped)."""
    pool, host = _pool(1 << 20)
    held = pool.fetch(_src(0))
    pool.fetch(_src(1, (3, 4, 2)))
    pool.fetch(_src(2, (3, 4, 3)))
    pool.fetch(_src(1, (3, 4, 2)))  # the 96-byte buffer back in the free list
    del pool
    gc.collect()
    assert held.tobytes() == _src(0).numpy().tobytes()
    del held
    gc.collect()
    assert sorted(host.releases) == sorted(host.allocs) == [96, 144, 240]


def test_returned_buffers_come_back_from_another_thread():
    import threading

    pool, host = _pool(1 << 20)
    got = [pool.fetch(_src(0))]
    th = threading.Thread(target=got.clear)  # a writer thread drops the array
    th.start()
    th.join(timeout=10)
    assert not th.is_alive()
    pool.fetch(_src(1))
    assert len(host.allocs) == 1


def test_concurrent_fetches_keep_the_books():
    """More threads than cores fetch, hold and drop arrays of two sizes while
    the interpreter switches threads often: every array reads its own
    source, and the pool's bytes are what was allocated less what was
    released."""
    import os
    import sys
    import threading

    pool, host = _pool(6 * 240)
    srcs = [_src(k, (3, 4, 5) if k % 2 else (3, 4, 3)) for k in range(8)]
    errors = []

    def work(k):
        held = []
        for i in range(60):
            s = srcs[(k + i) % len(srcs)]
            got = pool.fetch(s)
            held.append((got, s))
            if len(held) > 2:
                a, b = held.pop(0)
                if a.tobytes() != b.numpy().tobytes():
                    errors.append((k, i))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(2 * (os.cpu_count() or 1) + 2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert errors == []
    assert pool.pinned_bytes == sum(host.allocs) - sum(host.releases) <= pool.cap_bytes


def test_a_cpu_source_takes_the_plain_path():
    t = _src(0)
    got = fetch.to_host(t)
    assert np.shares_memory(got, t.numpy())  # what .cpu().numpy() gives
    assert got.tobytes() == t.numpy().tobytes()
    assert _calls("pregen.fetch.pin") == 0 and _calls("pregen.fetch.pageable") == 0


def test_the_cap_is_a_share_of_host_memory():
    mem = fetch.host_memory_bytes()
    assert mem > 0
    assert fetch.pool().cap_bytes == int(fetch.CAP_SHARE * mem)
