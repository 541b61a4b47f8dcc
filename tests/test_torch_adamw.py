"""The fused AdamW's work lists (``ops/adamw.py``), built in Python, and the
optimizer's dispatch on the CPU. The kernels themselves run only on a card
(``tests/test_torch_cuda.py``, marker ``cuda``)."""

import numpy as np
import pytest
import torch

from pregen_pde_tpu_torch.ops import adamw
from pregen_pde_tpu_torch.training.optim import build_optimizer
from pregen_pde_tpu_torch.training.trainer import TrainerConfig

from torch_threads import _one_torch_thread  # noqa: F401 (autouse)

NUMELS = {"empty and one-element leaves": [0, 1, 0, 7, 1],
          "chunk edges": [8, 9, 16, 15, 17, 24],
          "a mix": [5, 0, 33, 64, 1, 2, 3, 100, 0, 8]}


@pytest.mark.parametrize("chunk", [4, 8, 12])
@pytest.mark.parametrize("numels", list(NUMELS), ids=list(NUMELS))
def test_chunks_cover_every_element_once(numels, chunk):
    """Each element of each leaf lies in exactly one chunk; a chunk is a
    non-empty run of at most ``chunk`` elements of one leaf, starting at a
    multiple of ``chunk`` (so a leaf's alignment carries to its chunks), in
    leaf order; an empty leaf has none."""
    numels = NUMELS[numels]
    rows = adamw.chunk_table(numels, chunk)
    assert rows.dtype == np.int32 and rows.shape[1] == 3
    seen = [np.zeros(n, dtype=np.int64) for n in numels]
    for leaf, start, length in rows:
        assert 0 < length <= chunk and start % chunk == 0
        seen[leaf][start:start + length] += 1
    assert all((s == 1).all() for s in seen)
    assert (np.diff(rows[:, 0]) >= 0).all()
    assert len(rows) == sum(-(-n // chunk) for n in numels)


def test_chunk_table_refuses_what_the_kernel_cannot_index():
    for bad in ([2 ** 31], [-1]):
        with pytest.raises(ValueError, match="numel"):
            adamw.chunk_table(bad)
    with pytest.raises(ValueError, match="multiple of 4"):
        adamw.chunk_table([8], chunk=6)


def _tiered_optimizer(weight_decay=0.1):
    """A small model's parameters under the four scOT tiers (names that
    ``scot_tier_of`` sends to each), two epochs of three steps."""
    from pregen_pde_tpu_torch.training.tiers import SCOT_TIER_DECAY, scot_tier_of

    gen = torch.Generator().manual_seed(3)
    names = {"patch_embed.weight": (8, 3, 2, 2), "patch_embed.bias": (8,),
             "enc_0_blk_0.attention.query.weight": (8, 8),
             "enc_0_blk_0.attention.logit_scale": (2, 1, 1),
             "enc_0_blk_0.attention.query.bias": (8,),
             "enc_0_blk_0.attention.cpb_mlp1.weight": (40, 2),
             "enc_0_blk_0.norm1.time_scale.bias": (1,),
             "enc_0_blk_0.norm1.time_bias.weight": (8, 1)}
    named = [(n, torch.nn.Parameter(torch.randn(s, generator=gen))) for n, s in names.items()]
    tiers = {"standard": 1e-3, "no_weight_decay": 2e-3, "embeddings": 3e-3,
             "time_embedding": 4e-3}
    cfg = TrainerConfig(learning_rate=1e-3, weight_decay=weight_decay, epochs=2, lr_tiers=tiers)
    return build_optimizer(cfg, 3, named, tier_fn=scot_tier_of, tier_decay=SCOT_TIER_DECAY)


class _Recorder:
    """Stands in for ``FusedAdamW`` on the CPU: the rows it would upload."""

    def __init__(self, params, m, v, group, decay):
        self.params, self.m, self.v = params, m, v
        self.leaves = adamw.leaf_table(params, m, v, group, decay)
        self.chunks = adamw.chunk_table([p.numel() for p in params], chunk=8)


def test_chunks_carry_their_leafs_group_and_decay(monkeypatch):
    """The optimizer's rows as the card would get them: every chunk's leaf
    row holds that parameter's own address, its group's index and its
    decay flag, and the moments' addresses are the optimizer's."""
    monkeypatch.setattr(adamw, "on_card", lambda params: True)
    monkeypatch.setattr(adamw, "FusedAdamW", _Recorder)
    opt = _tiered_optimizer()
    assert len(opt.groups) == 4 and len({d for g in opt.groups for d in g["decay"]}) == 2
    want = {id(p): (gi, int(d)) for gi, g in enumerate(opt.groups)
            for p, d in zip(g["params"], g["decay"])}
    rows, chunks = opt.fused.leaves, opt.fused.chunks
    for leaf, start, length in chunks:
        p = opt.params[leaf]
        row = rows[leaf]
        assert (int(row["group"]), int(row["decay"])) == want[id(p)]
        assert row["p"] == p.data_ptr()
        assert row["m"] == opt.m[id(p)].data_ptr() and row["v"] == opt.v[id(p)].data_ptr()
    assert len(chunks) == sum(-(-p.numel() // 8) for p in opt.params)


def test_reset_rebuilds_the_rows_over_the_new_moments(monkeypatch):
    monkeypatch.setattr(adamw, "on_card", lambda params: True)
    monkeypatch.setattr(adamw, "FusedAdamW", _Recorder)
    opt = _tiered_optimizer()
    first = opt.fused
    old_m = {id(p): opt.m[id(p)] for p in opt.params}  # held, so no address is reused
    opt.reset()
    assert opt.fused is not first and opt.count == 0
    for leaf, p in enumerate(opt.params):
        assert opt.fused.leaves[leaf]["m"] == opt.m[id(p)].data_ptr()
        assert opt.m[id(p)] is not old_m[id(p)]
    assert all(a == b for a, b in zip(first.leaves["p"], opt.fused.leaves["p"]))


@pytest.mark.parametrize("grad_clip", [5.0, None])
def test_cpu_takes_the_foreach_route(grad_clip):
    """On the CPU no rows are built and no kernel step is counted; the
    update is the ``_foreach`` route's (held against optax by
    ``tests/test_torch_train.py``)."""
    adamw.reset_launches()
    opt = _tiered_optimizer()
    opt.grad_clip = grad_clip
    before = [p.detach().clone() for p in opt.params]
    gen = torch.Generator().manual_seed(4)
    for _ in range(2):
        for p in opt.params[1:]:  # the first leaf has no gradient
            p.grad = torch.randn(p.shape, generator=gen)
        opt.step()
    assert opt.fused is None and opt.count == 2
    assert adamw.launches == 0
    assert all(not torch.equal(a, p) for a, p in zip(before[1:], opt.params[1:]))


def test_torch_fused_adamw_timing_route_is_the_same_update():
    """``profile_scot.library_adamw``, torch's fused AdamW kernel that the
    card's kernels are timed beside, makes the ``_foreach`` route's update
    up to rounding (its p·(1 − lr·wd) − lr·u against optax's order), with
    the clip engaged on the second of three steps: four tiers, decay on
    and off."""
    from pregen_pde_tpu_torch.profile_scot import library_adamw

    opt, lib_opt = _tiered_optimizer(), _tiered_optimizer()
    lib = library_adamw(lib_opt)
    gen = torch.Generator().manual_seed(5)
    for step in range(3):
        for p, q in zip(opt.params, lib_opt.params):
            p.grad = (4.0 if step == 1 else 0.1) * torch.randn(p.shape, generator=gen)
            q.grad = p.grad.clone()
        opt.step()
        lib()
    assert lib_opt.count == opt.count == 3
    for p, q in zip(opt.params, lib_opt.params):
        for a, b in ((p, q), (opt.m[id(p)], lib_opt.m[id(q)]), (opt.v[id(p)], lib_opt.v[id(q)])):
            torch.testing.assert_close(b.detach(), a.detach(), rtol=2e-6, atol=1e-7)
