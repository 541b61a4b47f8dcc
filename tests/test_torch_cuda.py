"""The hand-written CUDA kernels on the card (marker ``cuda``).

Each test decides inside itself whether there is a card and skips with a
reason where there is none: a CUDA kernel has no CPU mode. This file imports
no JAX, so it also runs on a GPU host without it:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from pregen_pde_tpu_torch.core import NSVorticityConfig
from pregen_pde_tpu_torch.datagen.masked_ns import MaskedNSConfig, cfl_dt, sample_masks
from pregen_pde_tpu_torch.ops import stencil
from pregen_pde_tpu_torch.solvers import ns_projection_cuda as npc
from pregen_pde_tpu_torch.solvers import spectral_ns_cuda as snc
from pregen_pde_tpu_torch.solvers.heat import HeatConfig, HeatSolver
from pregen_pde_tpu_torch.solvers.ns_projection import ProjectionConfig, ProjectionSolver
from pregen_pde_tpu_torch.solvers.spectral_ns import NSVorticitySolver
from pregen_pde_tpu_torch.utils.parity import per_snapshot_rel_l2, rel_l2, to_torch


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.cuda
@pytest.mark.parametrize("n", snc.SUPPORTED_N)
def test_fft2_passes_match_torch_fft_f64(n):
    _need_cuda()
    g = torch.Generator().manual_seed(n)
    x = torch.complex(torch.randn(2, n, n, generator=g), torch.randn(2, n, n, generator=g))
    x64 = x.to(torch.complex128)
    for inverse, ref in ((False, torch.fft.fft2(x64)), (True, torch.fft.ifft2(x64))):
        got = snc.fft2(x.cuda(), inverse=inverse).cpu()
        # f32 radix-2 roundoff, ~1.5e-7 measured on an H100
        assert rel_l2(torch.view_as_real(got), torch.view_as_real(ref)) <= 2e-6


@pytest.mark.cuda
@pytest.mark.parametrize("n", [128, 512])
@pytest.mark.parametrize("output", ["vorticity", "fields"])
def test_k1_kernel_matches_plain(output, n):
    """The kernel vs its plain version (f32, on the CPU), per snapshot: the
    resident kernel at 128², the chain at 512²."""
    _need_cuda()
    cfg = NSVorticityConfig(resolution=n, viscosity=1e-3, dt=1e-3, t_end=6e-3,
                            n_snapshots=3, include_initial=True, forcing="fno",
                            drag=0.1)
    sol = NSVorticitySolver(cfg)
    w0 = to_torch(np.random.default_rng(4).normal(size=(2, n, n)), "cuda", torch.float32)
    nu = torch.tensor([1e-3, 2e-3], device="cuda")
    snc.reset_launches()
    got = snc.build_batched_traj(sol, output=output)(w0, nu)
    torch.cuda.synchronize()
    if n in snc.RESIDENT_N:
        # one launch a call: every image, step and frame of it
        assert snc.launches == 1
    else:
        # the chain enqueues: init 2 + a bootstrap step 3, 3 per step (3
        # intervals × 2 steps), a snapshot 2 (vorticity) or 4 (fields; also
        # frame 0)
        snaps = 3 if output == "vorticity" else 4
        assert snc.launches == 5 + 3 * 6 + snaps * (2 if output == "vorticity" else 4)
    ref = snc.build_batched_traj(sol, output=output)(w0.cpu(), nu.cpu())
    assert got.shape == ref.shape
    # f32 roundoff over a few steps (~3e-7 measured on an H100)
    assert per_snapshot_rel_l2(got, ref).max() < 2e-6


@pytest.mark.cuda
@pytest.mark.parametrize("n", [128, 256])
def test_k1_per_image_steps_and_order(n):
    """Per-image ν and step counts in one launch, against the plain version
    per step group; permuting the batch permutes the output to the bit."""
    _need_cuda()
    sol = NSVorticitySolver(NSVorticityConfig(resolution=n, viscosity=1e-3, dt=1e-3,
                                              n_snapshots=2, include_initial=True,
                                              forcing="fno"))
    w0 = to_torch(np.random.default_rng(5).normal(size=(4, n, n)), "cuda", torch.float32)
    nu = torch.tensor([1e-3, 2e-3, 5e-4, 1e-3], device="cuda")
    steps = torch.tensor([3, 1, 4, 1])
    traj = snc.build_batched_traj(sol, output="fields")
    snc.reset_launches()
    got = traj(w0, nu, steps)
    torch.cuda.synchronize()
    assert snc.launches == 1
    ref = traj(w0.cpu(), nu.cpu(), steps)
    assert per_snapshot_rel_l2(got, ref).max() < 2e-6
    perm = torch.tensor([2, 0, 3, 1])
    permuted = traj(w0[perm.cuda()], nu[perm.cuda()], steps[perm])
    torch.cuda.synchronize()
    assert torch.equal(permuted, got[perm.cuda()])


@pytest.mark.cuda
def test_k1_resident_clusters():
    _need_cuda()
    # the card holds at least one cluster of each resident grid
    assert all(snc.max_active_clusters(n) > 0 for n in snc.RESIDENT_N)


# K2 against its plain float32 version, per snapshot: chip_smoke.py phase
# 8's bar, 30x the worst difference measured when both are right (2.3e-6)
K2_VS_PLAIN_BAR = 7e-5


def _k2_inputs(n, domain, B=4):
    """fpo_multi_hole (channel) or ldc masks, u_max across Re 100..10000,
    each image at its own CFL dt and its own step count."""
    pipeline = "fpo_multi_hole" if domain == "channel" else "ldc_regular"
    cfg = MaskedNSConfig(pipeline=pipeline, resolution=n)
    masks = sample_masks(torch.Generator(device="cuda").manual_seed(n), cfg, B)
    u_max = torch.linspace(100, 10000, B, device="cuda") * 1.5e-5 / 2.0
    # each image's CFL dt, capped as the pipeline caps it
    dt = torch.tensor([cfl_dt(cfg, float(u)) for u in u_max], device="cuda")
    steps = torch.arange(10, 10 - 2 * B, -2).clamp(min=1)
    return masks, u_max, steps, dt


@pytest.mark.cuda
@pytest.mark.parametrize("n", [32, 96, 128, 256])
@pytest.mark.parametrize("domain", ["channel", "cavity"])
@pytest.mark.parametrize("advection", ["muscl", "upwind1"])
def test_k2_kernel_matches_plain(n, domain, advection):
    """Per-image dt and step counts in one launch, per snapshot."""
    _need_cuda()
    sol = ProjectionSolver(ProjectionConfig(resolution=n, domain=domain, n_snapshots=3,
                                            advection=advection))
    masks, u_max, steps, dt = _k2_inputs(n, domain)
    got = npc.build_batched_traj(sol)(masks, u_max, steps, dt)
    ref = sol.make_batched_trajectory_fn()(masks, u_max, steps, dt)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (4, 4, n, n, 3)
    assert torch.isfinite(got).all()
    assert per_snapshot_rel_l2(got, ref).max() <= K2_VS_PLAIN_BAR


@pytest.mark.cuda
@pytest.mark.parametrize("domain", ["channel", "cavity"])
def test_k2_batch_permutation(domain):
    """Each image is its own cluster: permuting the batch permutes the
    output to the bit."""
    _need_cuda()
    sol = ProjectionSolver(ProjectionConfig(resolution=128, domain=domain, n_snapshots=2))
    masks, u_max, steps, dt = _k2_inputs(128, domain)
    traj = npc.build_batched_traj(sol)
    perm = torch.tensor([2, 0, 3, 1])
    got = traj(masks, u_max, steps, dt)
    permuted = traj(masks[perm.cuda()], u_max[perm.cuda()], steps[perm], dt[perm.cuda()])
    torch.cuda.synchronize()
    assert torch.equal(permuted, got[perm.cuda()])


@pytest.mark.cuda
@pytest.mark.parametrize("domain", ["channel", "cavity"])
def test_k2_writes_in_place_into_contract_rows(domain):
    """Given a 6-channel contract and permuted rows, then a two-row retry at
    dt/2 into two of the same rows, K2 stores each image's frames into
    channels 0:3 of its row: byte-equal to its default route scattered on
    the host, every other byte untouched; rows on the device raise."""
    _need_cuda()
    sol = ProjectionSolver(ProjectionConfig(resolution=128, domain=domain, n_snapshots=2))
    masks, u_max, steps, dt = _k2_inputs(128, domain)
    traj = npc.build_batched_traj(sol)
    rows = np.array([5, 0, 3, 1])
    sel, sel_rows = [1, 2], np.array([0, 3])
    ref = traj(masks, u_max, steps, dt).cpu().numpy()
    ref2 = traj(masks[sel], u_max[sel], steps[sel], dt[sel] / 2).cpu().numpy()
    out = torch.full((6, 3, 128, 128, 6), 7.0, device="cuda")
    npc.reset_launches()
    got = traj(masks, u_max, steps, dt, out=out, out_rows=rows)
    traj(masks[sel], u_max[sel], steps[sel], dt[sel] / 2, out=out, out_rows=sel_rows)
    want = np.full((6, 3, 128, 128, 6), 7.0, np.float32)
    want[rows, ..., 0:3] = ref
    want[sel_rows, ..., 0:3] = ref2
    assert got is out and npc.launches == 2
    assert out.cpu().numpy().tobytes() == want.tobytes()
    with pytest.raises(ValueError, match="on the host"):
        traj(masks, u_max, steps, dt, out=out, out_rows=torch.as_tensor(rows, device="cuda"))


@pytest.mark.cuda
def test_k2_launch_count():
    _need_cuda()
    sol = ProjectionSolver(ProjectionConfig(resolution=128, n_snapshots=2))
    npc.reset_launches()
    npc.build_batched_traj(sol)(torch.zeros((2, 128, 128), device="cuda"), None, 3, 0.01)
    masks, u_max, steps, dt = _k2_inputs(128, "channel")
    npc.build_batched_traj(sol)(masks, u_max, steps, dt)
    torch.cuda.synchronize()
    # one launch a call: every image, snapshot and step of it
    assert npc.launches == 2


# K3 against its plain version, relative L2: chip_smoke.py's bar, 30x the
# difference measured when both are right (NVIDIA H100); K3's backward a
# bar a cotangent, 2.5x the plain float32 version's own error against
# float64 (chip_smoke.py's K3_BWD_VS_PLAIN_BARS)
K3_VS_PLAIN_BAR = 2e-5
# chip_smoke.py's K4_BWD_VS_PLAIN_BARS: 2.5x the plain float32 version's own
# error against float64 at phase 17's inputs, a bar a cotangent
K4_BWD_VS_PLAIN_BARS = {"dq": 1.0e-6, "dk": 1.0e-6, "dv": 1.0e-6, "dbias": 9.1e-7}
# chip_smoke.py's K4_FWD_VS_PLAIN_BARS: 2.5x the plain float32 version's own
# error against float64 at phase 13's inputs, a bar an output
K4_FWD_VS_PLAIN_BARS = {"out": 1.27e-6, "lse": 9.0e-8}
K3_BWD_VS_PLAIN_BARS = {
    "dx": 2.5e-6, "dbias": 2.4e-6, "dscale": 4.0e-6, "dwq": 2.8e-6, "dbq": 2.8e-6,
    "dwk": 2.8e-6, "dwv": 2.5e-6, "dbv": 1.9e-6, "dwp": 2.4e-6, "dbp": 1.9e-6,
    "dln1w": 2.4e-6, "dln1b": 1.8e-6, "dw1": 3.1e-6, "db1": 2.9e-6, "dw2": 1.7e-6,
    "db2": 4.4e-7, "dln2w": 1.9e-6, "dln2b": 2.6e-7, "ddp": 2.9e-6,
}
STEP_LOSS_RTOL = 1e-5
STEP_GRAD_BAR = 1.1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("nb,h,n,hd,nw", [(64, 3, 256, 32, 4), (16, 24, 16, 32, 1),
                                          (8, 2, 16, 8, 4)])
def test_k4_kernel_matches_plain(nb, h, n, hd, nw):
    _need_cuda()
    from pregen_pde_tpu_torch.ops import window_attention as wa

    g = torch.Generator(device="cuda").manual_seed(n)
    q, k, v = (torch.randn(nb, h, n, hd, generator=g, device="cuda") for _ in range(3))
    bias = 3 * torch.randn(nw, h, n, n, generator=g, device="cuda")
    wa.reset_launches()
    got = wa.window_attention(q, k, v, bias)
    assert wa.launches == 1
    # out's bar (6.5e-7 measured at n = 256, NVIDIA H100)
    assert rel_l2(got, wa.window_attention_plain(q, k, v, bias)) <= K4_FWD_VS_PLAIN_BARS["out"]
    # a gradient through the wrapper launches the backward kernels; its bars
    # hold for the operands the model passes (q, k cosine-normalised, q times
    # a logit scale of 10), the inputs their floors were measured on
    q = torch.nn.functional.normalize(q, dim=-1) * 10.0
    k = torch.nn.functional.normalize(k, dim=-1)
    ins = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    do = torch.randn(nb, h, n, hd, generator=g, device="cuda")
    grads = torch.autograd.grad(wa.window_attention(*ins), ins, do)
    torch.cuda.synchronize()
    assert wa.bwd_launches == wa.BWD_KERNELS_PER_CALL[wa.bwd_route(n)]
    for name, a, b in zip(K4_BWD_VS_PLAIN_BARS, grads,
                          wa.window_attention_bwd_plain(q, k, v, bias, do)):
        assert a.shape == b.shape and rel_l2(a, b) <= K4_BWD_VS_PLAIN_BARS[name], name


@pytest.mark.cuda
@pytest.mark.parametrize("nb,h,n,hd,nw", [(16, 24, 16, 32, 1), (3, 24, 16, 32, 1),
                                          (12, 4, 25, 16, 2), (64, 3, 256, 32, 4),
                                          (16, 12, 64, 32, 1)])
def test_k4_backward_routes(nb, h, n, hd, nw):
    """Both backward routes, as the model calls them (q, k normalised, q at a
    logit scale of 10, the bias 16 sigmoid(CPB) plus a -100 mask): each
    cotangent against the plain version under its bar, the launches of the
    route exactly (small 1, wide 2), a rerun equal to the bit, and nothing
    saved without a gradient."""
    _need_cuda()
    import torch.nn.functional as F

    from pregen_pde_tpu_torch.ops import window_attention as wa

    g = torch.Generator(device="cuda").manual_seed(n + nb)
    rn = lambda *shape: torch.randn(*shape, generator=g, device="cuda")
    q = F.normalize(rn(nb, h, n, hd), dim=-1) * 10.0
    k = F.normalize(rn(nb, h, n, hd), dim=-1)
    v, do = rn(nb, h, n, hd), rn(nb, h, n, hd)
    bias = 16.0 * torch.sigmoid(rn(nw, h, n, n)) - 100.0 * (rn(nw, 1, n, n) > 0.5).float()
    ins = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    wa.reset_launches()
    got = torch.autograd.grad(wa.window_attention(*ins), ins, do)
    again = torch.autograd.grad(wa.window_attention(*ins), ins, do)
    torch.cuda.synchronize()
    route = wa.bwd_route(n)
    assert route == ("small" if n <= 32 else "wide")
    assert (wa.launches, wa.bwd_launches) == (2, 2 * wa.BWD_KERNELS_PER_CALL[route])
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for name, a, b in zip(K4_BWD_VS_PLAIN_BARS, got,
                          wa.window_attention_bwd_plain(q, k, v, bias, do)):
        assert rel_l2(a, b) <= K4_BWD_VS_PLAIN_BARS[name], name
    with torch.inference_mode():
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        y = wa.window_attention(q, k, v, bias)
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() - before <= y.numel() * 4 + 2 * 1024 * 1024
    assert torch.equal(y, wa.window_attention(*ins).detach())


@pytest.mark.cuda
@pytest.mark.parametrize("B,hw,c,heads,ws,nw", [(4, 32, 96, 3, 16, 4), (4, 16, 192, 6, 16, 1),
                                                (4, 8, 384, 12, 8, 1), (2, 8, 16, 2, 4, 4)])
def test_k3_kernel_matches_plain(B, hw, c, heads, ws, nw):
    _need_cuda()
    from pregen_pde_tpu_torch.ops import swin_block as sb

    g = torch.Generator(device="cuda").manual_seed(c)
    rn = lambda *s: 0.1 * torch.randn(*s, generator=g, device="cuda")
    n, hd = ws * ws, c // heads
    args = (10 * rn(B, hw, hw, c), 30 * rn(nw, heads, n, n), 1 + 9 * torch.rand(heads, device="cuda"),
            rn(heads, c, hd), rn(heads, 1, hd), rn(heads, c, hd), rn(heads, c, hd), rn(heads, 1, hd),
            rn(heads, hd, c), rn(1, c), rn(B, c) + 1, rn(B, c), rn(c, 4 * c), rn(1, 4 * c),
            rn(4 * c, c), rn(1, c), rn(B, c) + 1, rn(B, c), 1 + rn(B, 2))
    sb.reset_launches()
    got = sb.fused_swin_block(*args, heads, ws, 1e-5)
    assert sb.launches == sb.KERNELS_PER_CALL
    assert rel_l2(got, sb.swin_block_plain(*args, heads, ws, 1e-5)) <= K3_VS_PLAIN_BAR


@pytest.mark.cuda
@pytest.mark.parametrize("B,hw,c,heads,ws,nw", [(16, 32, 96, 3, 16, 4), (16, 16, 192, 6, 16, 1),
                                                (16, 8, 384, 12, 8, 1), (2, 8, 16, 2, 4, 4)])
def test_k3_backward_kernel_matches_plain(B, hw, c, heads, ws, nw):
    """All 19 cotangents of the K3 backward kernel against its plain
    version, each by its own bar, through the autograd of
    ``fused_swin_block``, with the exact kernel counts; a second call
    repeats to the bit."""
    _need_cuda()
    from pregen_pde_tpu_torch.ops import swin_block as sb

    g = torch.Generator(device="cuda").manual_seed(c + 1)
    rn = lambda *s: 0.1 * torch.randn(*s, generator=g, device="cuda")
    n, hd = ws * ws, c // heads
    args = (10 * rn(B, hw, hw, c), 30 * rn(nw, heads, n, n), 1 + 9 * torch.rand(heads, device="cuda"),
            rn(heads, c, hd), rn(heads, 1, hd), rn(heads, c, hd), rn(heads, c, hd), rn(heads, 1, hd),
            rn(heads, hd, c), rn(1, c), rn(B, c) + 1, rn(B, c), rn(c, 4 * c), rn(1, 4 * c),
            rn(4 * c, c), rn(1, c), rn(B, c) + 1, rn(B, c), 1 + rn(B, 2))
    dy = 10 * rn(B, hw, hw, c)
    ins = [a.clone().requires_grad_() for a in args]
    sb.reset_launches()
    got = torch.autograd.grad(sb.fused_swin_block(*ins, heads, ws, 1e-5), ins, dy)
    again = torch.autograd.grad(sb.fused_swin_block(*ins, heads, ws, 1e-5), ins, dy)
    torch.cuda.synchronize()
    assert (sb.launches, sb.bwd_launches) == (2 * sb.KERNELS_PER_CALL,
                                              2 * sb.BWD_KERNELS_PER_CALL)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = sb.swin_block_bwd_plain(*args, dy, heads, ws, 1e-5)
    for name, a, b in zip(sb.COTANGENTS, got, ref):
        assert a.shape == b.shape and rel_l2(a, b) <= K3_BWD_VS_PLAIN_BARS[name], name


@pytest.mark.cuda
def test_k3_backward_keeps_float32_accuracy_where_tokens_are_alike():
    """Stage 0 of scOT-B at B 4 with windows of alike tokens (a uniform
    stretch of flow: one token plus 0.1 of noise) and weights at the model's
    init law, where the attention backward's sums cancel. With each window's
    mean rows taken out of the products the cotangents that come of them
    (dscale, dq's wq and bq, dk's wk) sit no farther from float64 than
    plain float32 does (0.03-0.17 of its distance on an H100; 3xTF32 on the
    uncentred operands read 2-4x, and 13-76x on scOT-B's training step)."""
    _need_cuda()
    from pregen_pde_tpu_torch.models.scot import shift_attn_mask
    from pregen_pde_tpu_torch.ops import swin_block as sb

    g = torch.Generator(device="cuda").manual_seed(7)
    B, hw, c, heads, ws = 4, 32, 96, 3, 16
    n, dev = ws * ws, "cuda"
    rn = lambda *s: torch.randn(*s, generator=g, device=dev)
    w = lambda *s: 0.02 * rn(*s)
    zero = lambda *s: torch.zeros(*s, device=dev)
    one = lambda *s: torch.ones(*s, device=dev)
    mask = torch.from_numpy(shift_attn_mask(hw, hw, ws, ws // 2)).to(dev)
    args = (rn(1, 1, 1, c) + 0.1 * rn(B, hw, hw, c),
            16.0 * torch.sigmoid(rn(1, heads, n, n)) + mask[:, None],
            torch.full((heads,), 10.0, device=dev), w(c, c), zero(c), w(c, c), w(c, c), zero(c),
            w(c, c), zero(c), one(B, c), zero(B, c), w(4 * c, c), zero(4 * c), w(c, 4 * c),
            zero(c), one(B, c), zero(B, c), one(B, 2))
    dy = 1e-6 * rn(B, hw, hw, c)
    static = (heads, ws, 1e-5, ws // 2)

    def grads(fn, dtype):
        ins = [a.to(dtype).clone().requires_grad_() for a in args]
        return torch.autograd.grad(fn(*ins, *static), ins, dy.to(dtype))

    got = grads(sb.swin_block, torch.float32)
    f32 = grads(lambda *a: sb.swin_block_fwd_plain(*a)[0], torch.float32)
    f64 = grads(lambda *a: sb.swin_block_fwd_plain(*a)[0], torch.float64)
    for i, name in ((2, "dscale"), (3, "dwq"), (4, "dbq"), (5, "dwk")):
        kernel, plain = rel_l2(got[i], f64[i]), rel_l2(f32[i], f64[i])
        assert kernel <= plain, (name, kernel, plain)


@pytest.mark.cuda
def test_k3_inference_mode_saves_nothing():
    """Under ``torch.inference_mode()`` the forward leaves only y allocated
    and gives the y it gives under autograd, to the bit; the shift folded
    into the addressing equals roll → block → roll."""
    _need_cuda()
    from pregen_pde_tpu_torch.ops import swin_block as sb

    g = torch.Generator(device="cuda").manual_seed(5)
    rn = lambda *s: 0.1 * torch.randn(*s, generator=g, device="cuda")
    B, hw, c, heads, ws = 2, 32, 96, 3, 16
    n = ws * ws
    args = (10 * rn(B, hw, hw, c), 30 * rn(4, heads, n, n), 1 + torch.rand(heads, device="cuda"),
            rn(c, c), rn(c), rn(c, c), rn(c, c), rn(c), rn(c, c), rn(c), rn(B, c) + 1, rn(B, c),
            rn(4 * c, c), rn(4 * c), rn(c, 4 * c), rn(c), rn(B, c) + 1, rn(B, c), 1 + rn(B, 2))
    with torch.inference_mode():
        y0 = sb.swin_block(*args, heads, ws, 1e-5, 8)
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        y = sb.swin_block(*args, heads, ws, 1e-5, 8)
        torch.cuda.synchronize()
        # y rounded up to the allocator's block; the saved tensors would be
        # more than ten times y
        kept, y_bytes = torch.cuda.memory_allocated() - before, y.numel() * y.element_size()
        assert y_bytes <= kept <= max(2 * y_bytes, y_bytes + 2 ** 21)
        rolled = torch.roll(args[0], (-8, -8), (1, 2)).contiguous()
        y_roll = torch.roll(sb.swin_block(rolled, *args[1:], heads, ws, 1e-5), (8, 8), (1, 2))
    ins = [a.clone().requires_grad_() for a in args]
    y_grad = sb.swin_block(*ins, heads, ws, 1e-5, 8)
    assert torch.equal(y, y0) and torch.equal(y_grad.detach(), y) and torch.equal(y_roll, y)


@pytest.mark.cuda
def test_scot_b_train_step_kernels_match_plain():
    """One scOT-B train step (128², batch 4, drop-path on, one generator
    state in both routes): the loss and every parameter's gradient through
    the kernels against the plain route, with the exact launches."""
    _need_cuda()
    from pregen_pde_tpu_torch.ops import swin_block as sb
    from pregen_pde_tpu_torch.ops import window_attention as wa
    from pregen_pde_tpu_torch.profile_scot import seeded_scot, set_route
    from pregen_pde_tpu_torch.training.losses import relative_lp_loss

    model = seeded_scot("scot-B", 128).cuda().train()
    g = torch.Generator(device="cuda").manual_seed(1)
    x, y = (torch.randn(4, 128, 128, c, generator=g, device="cuda") for c in (7, 3))
    t = torch.rand(4, generator=g, device="cuda")
    out = {}
    for route in ("auto", "plain"):
        set_route(model, route)
        model.set_dropout_generator(torch.Generator(device="cuda").manual_seed(2))
        model.zero_grad(set_to_none=True)
        sb.reset_launches()
        wa.reset_launches()
        loss = relative_lp_loss(model(x, t).float(), y)
        loss.backward()
        loss = loss.detach()
        torch.cuda.synchronize()
        out[route] = (loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()},
                      (sb.launches, sb.bwd_launches, wa.launches, wa.bwd_launches))
    assert out["plain"][2] == (0, 0, 0, 0)
    # 48 layers at stages 0-2 take K3, 16 at stage 3 K4
    assert out["auto"][2] == (48 * sb.KERNELS_PER_CALL, 48 * sb.BWD_KERNELS_PER_CALL, 16,
                              16 * wa.BWD_KERNELS_PER_CALL["small"])
    assert abs(out["auto"][0] - out["plain"][0]) <= STEP_LOSS_RTOL * abs(out["plain"][0])
    for name, grad in out["auto"][1].items():
        assert rel_l2(grad, out["plain"][1][name]) <= STEP_GRAD_BAR, name


@pytest.mark.cuda
def test_scot_kernel_routes_match_plain():
    """A small ScOT on the card: auto (K3 at every layer, C <= 384) and
    attention-only (K4 at every layer) against the plain route, with the
    exact launch counts of one forward."""
    _need_cuda()
    from pregen_pde_tpu_torch.models.scot import ScOT, ScOTConfig
    from pregen_pde_tpu_torch.ops import swin_block as sb
    from pregen_pde_tpu_torch.ops import window_attention as wa
    from pregen_pde_tpu_torch.profile_scot import set_route

    kw = dict(image_size=16, patch_size=2, num_channels=7, num_out_channels=3, embed_dim=16,
              depths=(2, 2), num_heads=(2, 4), skip_connections=(1, 0), window_size=4)
    torch.manual_seed(0)
    model = ScOT(ScOTConfig(**kw)).cuda().eval()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.1 * torch.randn_like(p))
    x = torch.randn(2, 16, 16, 7, device="cuda")
    t = torch.rand(2, device="cuda")
    outs = {}
    with torch.inference_mode():
        for route in ("plain", "auto", "attention-only"):
            set_route(model, route)
            sb.reset_launches()
            wa.reset_launches()
            outs[route] = model(x, t)
            torch.cuda.synchronize()
            outs[route, "launches"] = (sb.launches, wa.launches)
    assert outs["plain", "launches"] == (0, 0)
    assert outs["auto", "launches"] == (8 * sb.KERNELS_PER_CALL, 0)
    assert outs["attention-only", "launches"] == (0, 8)
    for route in ("auto", "attention-only"):
        assert rel_l2(outs[route], outs["plain"]) <= 1e-4


# K5a and K5b against their plain versions (relative L2; K5b on the step's
# increment), and a heat route against the plain route per snapshot:
def _k4_model_inputs(seed, nb, h, n, hd, nw):
    """K4's operands laid out as the model passes them: q, k, v the (nb, h,
    n, hd) views of (nb, n, h·hd) projections, q and k cosine-normalised, q
    at a logit scale of 10; the bias 16σ of an (n, n, h) table permuted to
    (h, n, n) (the heads fastest), with a −100 mask at nw > 1."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    rn = lambda *shape: torch.randn(*shape, generator=g, device="cuda")
    heads = lambda t: t.reshape(nb, n, h, hd).permute(0, 2, 1, 3)
    q, k, v = (heads(rn(nb, n, h * hd)) for _ in range(3))
    q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-6) * 10.0
    k = k / (torch.linalg.vector_norm(k, dim=-1, keepdim=True) + 1e-6)
    bias = (16.0 * torch.sigmoid(rn(n, n, h).permute(2, 0, 1)))[None]
    if nw > 1:
        bias = bias - 100.0 * (rn(nw, 1, n, n) > 0.5).float()
    return q, k, v, bias


@pytest.mark.cuda
@pytest.mark.parametrize("nw", [1, 4])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("n", [16, 64, 256])
def test_k4_forward_in_the_model_layout(n, hd, nw):
    """Both forward routes (small at n = 16, wide at 64 and 256), read in
    the model's layout: out and the log-sum-exp against the plain version
    under their bars, one launch a call, two calls equal to the bit, and out
    laid out so that the model's merge of the heads is a view."""
    _need_cuda()
    from pregen_pde_tpu_torch.ops import window_attention as wa

    nb, h = 8, 3
    q, k, v, bias = _k4_model_inputs(n + hd + nw, nb, h, n, hd, nw)
    assert not (q.is_contiguous() or bias.is_contiguous())
    with torch.inference_mode():
        wa.reset_launches()
        out, lse = wa._forward_kernel(q, k, v, bias, save=True)
        again = wa.window_attention(q, k, v, bias)
        torch.cuda.synchronize()
        assert wa.launches == 2
        ref, lref = wa.window_attention_lse_plain(q, k, v, bias)
    assert rel_l2(out, ref) <= K4_FWD_VS_PLAIN_BARS["out"]
    assert rel_l2(lse, lref) <= K4_FWD_VS_PLAIN_BARS["lse"]
    assert torch.equal(again, out)
    assert again.permute(0, 2, 1, 3).reshape(nb, n, h * hd).data_ptr() == again.data_ptr()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 256])
def test_k4_inference_mode_allocates_only_out(n):
    _need_cuda()
    from pregen_pde_tpu_torch.ops import window_attention as wa

    q, k, v, bias = _k4_model_inputs(n, 8, 3, n, 32, 1)
    with torch.inference_mode():
        wa.window_attention(q, k, v, bias)  # the library loaded, the shape checked
        torch.cuda.synchronize()
        live = lambda: torch.cuda.memory_stats()["allocation.all.current"]
        before, n_before = torch.cuda.memory_allocated(), live()
        y = wa.window_attention(q, k, v, bias)
        torch.cuda.synchronize()
        # one allocation kept, out's; the caching allocator rounds a block up
        # to 512 bytes
        assert live() - n_before == 1
        assert torch.cuda.memory_allocated() - before == (y.numel() * 4 + 511) // 512 * 512


@pytest.mark.cuda
@pytest.mark.parametrize("nb,h,n,hd,nw", [(16, 24, 16, 32, 1), (64, 3, 256, 32, 4),
                                          (16, 12, 64, 64, 1)])
def test_k4_backward_from_the_model_layout(nb, h, n, hd, nw):
    """The backward from the new forward's out and log-sum-exp, all in the
    model's layout (do as the merge of the heads hands it back): each
    cotangent under its bar, the route's launches, and dq, dk, dv in the
    layout of q, k, v (no copy on the way back)."""
    _need_cuda()
    from pregen_pde_tpu_torch.ops import window_attention as wa

    q, k, v, bias = _k4_model_inputs(nb + n, nb, h, n, hd, nw)
    g = torch.Generator(device="cuda").manual_seed(n)
    do = torch.randn(nb, n, h, hd, generator=g, device="cuda").permute(0, 2, 1, 3)
    ins = [t.detach().clone().requires_grad_() for t in (q, k, v, bias)]
    wa.reset_launches()
    got = torch.autograd.grad(wa.window_attention(*ins), ins, do)
    torch.cuda.synchronize()
    assert (wa.launches, wa.bwd_launches) == (1, wa.BWD_KERNELS_PER_CALL[wa.bwd_route(n)])
    for name, a, b in zip(K4_BWD_VS_PLAIN_BARS, got,
                          wa.window_attention_bwd_plain(q, k, v, bias, do)):
        assert rel_l2(a, b) <= K4_BWD_VS_PLAIN_BARS[name], name
    assert all(gr.stride() == t.stride() for gr, t in zip(got[:3], (q, k, v)))


@pytest.mark.cuda
def test_k4_refuses_operands_it_cannot_read_in_place():
    _need_cuda()
    from pregen_pde_tpu_torch.ops import window_attention as wa

    q, k, v, bias = _k4_model_inputs(0, 4, 3, 16, 32, 1)
    with pytest.raises(ValueError, match="in place"):
        wa.window_attention(q.transpose(-1, -2).contiguous().transpose(-1, -2), k, v, bias)
    with pytest.raises(ValueError, match="float32"):
        wa.window_attention(q.double(), k.double(), v.double(), bias.double())


# chip_smoke.py phase 23's bars (K5a measured bit-identical; K5b 2.2e-6 and
# the fused route 1.1e-7 measured, NVIDIA H100)
K5A_VS_PLAIN_BAR = 1e-7
K5B_VS_PLAIN_BAR = 7e-5
HEAT_ROUTE_VS_PLAIN_BAR = 3.5e-6


def _smooth_fields(B, n, seed):
    from pregen_pde_tpu_torch.core import SpectralGrid2D
    from pregen_pde_tpu_torch.fields.grf import grf_2d

    return grf_2d(torch.Generator(device="cuda").manual_seed(seed), SpectralGrid2D(n), B)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 33, 130])
@pytest.mark.parametrize("B", [1, 3])
def test_k5a_kernel_matches_plain(B, n):
    _need_cuda()
    u = _smooth_fields(B, n, seed=n)
    stencil.reset_launches()
    got = stencil.laplacian_cuda(u, 1.0 / n)
    torch.cuda.synchronize()
    assert stencil.launches == 1 and got.shape == u.shape
    assert rel_l2(got, stencil.laplacian(u, 1.0 / n)) <= K5A_VS_PLAIN_BAR
    # a 2-D input is one image
    assert rel_l2(stencil.laplacian_cuda(u[0], 1.0 / n), got[0]) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [5, 32, 100, 128, 256, 512])
@pytest.mark.parametrize("B", [1, 32])
def test_k5a_row_and_general_routes(B, n):
    """The row route (n = 128, 256, 512: a warp a row, the wrap by shuffles)
    and the general route (any other n), one launch each."""
    _need_cuda()
    u = _smooth_fields(B, n, seed=n + B)
    stencil.reset_launches()
    got = stencil.laplacian_cuda(u, 1.0 / n)
    torch.cuda.synchronize()
    assert stencil.launches == 1 and got.shape == u.shape
    assert rel_l2(got, stencil.laplacian(u, 1.0 / n)) <= K5A_VS_PLAIN_BAR


@pytest.mark.cuda
@pytest.mark.parametrize("reaction", [0.0, 1.0])
@pytest.mark.parametrize("n", [4, 33, 130])
@pytest.mark.parametrize("B", [1, 3])
def test_k5b_kernel_matches_plain(B, n, reaction):
    _need_cuda()
    u = _smooth_fields(B, n, seed=7 * n)
    dx, D, dt = 1.0 / n, 1e-2, 1e-4
    got = stencil.heat_step_cuda(u, dx, D, dt, reaction)
    ref = stencil.heat_step(u, dx, D, dt, reaction)
    torch.cuda.synchronize()
    assert rel_l2(got - u, ref - u) <= K5B_VS_PLAIN_BAR


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [1, 4, 5])
def test_k5b_advance_ping_pong_and_frame(steps):
    """``heat_advance`` leaves its input unwritten, returns the buffer that
    holds the last step for odd and even counts, writes the frame, and
    launches one kernel a step."""
    _need_cuda()
    n = 130
    u = _smooth_fields(3, n, seed=1)
    u_copy = u.clone()
    out = torch.zeros((3, 4, n, n), device="cuda")
    stencil.reset_launches()
    got = stencil.heat_advance(u, steps, 1.0 / n, 1e-2, 1e-4, 1.0, frame=out[:, 2])
    ref = u
    for _ in range(steps):
        ref = stencil.heat_step_cuda(ref, 1.0 / n, 1e-2, 1e-4, 1.0)
    torch.cuda.synchronize()
    assert stencil.launches == 2 * steps
    assert torch.equal(got, ref) and torch.equal(out[:, 2], ref) and torch.equal(u, u_copy)
    assert (out[:, [0, 1, 3]] == 0).all()
    with pytest.raises(ValueError):
        stencil.heat_advance(u, 1, 1.0 / n, 1e-2, 1e-4, frame=out[:, :, 0])
    with pytest.raises(ValueError):
        stencil.laplacian_cuda(u.double(), 1.0 / n)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["fused", "laplacian"])
def test_heat_kernel_routes_match_plain(impl):
    """The K5b and K5a routes of ``HeatSolver`` against the plain route, per
    snapshot, with exact launch counts (K5b one a step, K5a two)."""
    _need_cuda()
    cfg = HeatConfig(resolution=64, reaction=1.0, t_end=0.02, n_snapshots=4)
    u0 = _smooth_fields(3, 64, seed=2)
    stencil.reset_launches()
    got = HeatSolver(cfg, impl=impl).make_batched_trajectory_fn()(u0)
    torch.cuda.synchronize()
    # the fused route is one resident launch for the trajectory
    assert stencil.launches == (1 if impl == "fused" else 400)
    ref = HeatSolver(cfg, impl="plain").make_batched_trajectory_fn()(u0)
    assert got.shape == ref.shape == (3, 5, 64, 64) and torch.equal(got[:, 0], u0)
    assert per_snapshot_rel_l2(got, ref).max() <= HEAT_ROUTE_VS_PLAIN_BAR


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", [(32, 128), (1, 128), (4, 256), (3, 130)])
@pytest.mark.parametrize("reaction", [0.0, 1.0])
def test_k5b_trajectory_resident_matches_plain(B, n, reaction):
    """The resident trajectory kernel (one launch for S x inner steps, the
    frames written from it) against the plain trajectory per snapshot, at
    the main path's (32, 128^2), one image, 256^2 (a cluster of blocks an
    image) and the ragged 130^2; u0 unwritten, frame 0 = u0."""
    _need_cuda()
    u0 = _smooth_fields(B, n, seed=n + B)
    u_copy = u0.clone()
    dx, D, dt = 1.0 / n, 1e-2, 1e-4
    assert stencil.trajectory_route(n) == "resident"
    stencil.reset_launches()
    got = stencil.heat_trajectory(u0, 4, 25, dx, D, dt, reaction)
    torch.cuda.synchronize()
    assert stencil.launches == 1 and got.shape == (B, 5, n, n)
    ref = stencil.heat_trajectory_plain(u0, 4, 25, dx, D, dt, reaction)
    assert torch.equal(got[:, 0], u0) and torch.equal(u0, u_copy)
    assert per_snapshot_rel_l2(got, ref).max() <= HEAT_ROUTE_VS_PLAIN_BAR


@pytest.mark.cuda
def test_k5b_trajectory_clusters_agree():
    """Every cluster size that holds 128^2 gives the trajectory of the
    default, to the bit (the same arithmetic, only the exchange differs)."""
    _need_cuda()
    u0 = _smooth_fields(3, 128, seed=9)
    ref = stencil.heat_trajectory(u0, 2, 20, 1 / 128, 1e-2, 1e-4, 1.0)
    for cs in (1, 2, 4, 8):
        assert stencil.resident_cluster(128, cs) == cs
        got = stencil.heat_trajectory(u0, 2, 20, 1 / 128, 1e-2, 1e-4, 1.0, cluster=cs)
        assert torch.equal(got, ref), cs


@pytest.mark.cuda
def test_k5b_trajectory_tiled_above_the_resident_limit():
    """Above what the resident kernel holds (512^2) the trajectory takes the
    tiled route, a launch a step, against the plain trajectory per snapshot."""
    _need_cuda()
    n = 512
    assert stencil.trajectory_route(n) == "tiled" and stencil.resident_cluster(n) == 0
    u0 = _smooth_fields(2, n, seed=3)
    out = torch.empty((2, 4, n, n), device="cuda")
    stencil.reset_launches()
    got = stencil.heat_trajectory(u0, 3, 10, 1.0 / n, 1e-2, 1e-4, 0.0, out=out)
    torch.cuda.synchronize()
    assert got is out and stencil.launches == 30
    ref = stencil.heat_trajectory_plain(u0, 3, 10, 1.0 / n, 1e-2, 1e-4, 0.0)
    assert torch.equal(got[:, 0], u0)
    assert per_snapshot_rel_l2(got, ref).max() <= HEAT_ROUTE_VS_PLAIN_BAR


@pytest.mark.cuda
def test_cylinder_and_convergence_through_k2():
    """The JAX package's bands through K2: the cylinder at Re_d 150, 128²,
    t_end 80 in one launch (St 0.1706, C_d 1.224, amplitude 0.666 measured
    on an H100) and the Richardson order in three (1.497)."""
    _need_cuda()
    from pregen_pde_tpu_torch.solvers.validation import convergence_order, run_cylinder

    npc.reset_launches()
    r = run_cylinder(150.0, n=128, t_end=80.0)
    assert npc.launches == 1 and r["steps"] == 34000
    assert r["shedding_amplitude"] > 0.2, r
    assert 0.15 < r["strouhal"] < 0.21, r
    assert 1.0 < r["cd_mean"] < 1.6, r
    npc.reset_launches()
    c = convergence_order()
    assert npc.launches == 3 and c["order"] > 1.3, c


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fno", "ffno"])
def test_fno_ffno_card_forward_matches_cpu_f64(name):
    """FNO and FFNO at their default widths, 128², B = 4, weights from seed
    0: the card's float32 forward (TF32 off) against the same model in
    float64 on the CPU, relative L2 ≤ 5e-6 (3.3e-7 to 4.9e-7 measured at
    B = 16 on an H100)."""
    _need_cuda()
    import copy

    from pregen_pde_tpu_torch.models.ffno import FFNO2d
    from pregen_pde_tpu_torch.models.fno import FNO2d
    from pregen_pde_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    torch.manual_seed(0)
    model = {"fno": FNO2d, "ffno": FFNO2d}[name](7, 3).eval()
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 128, 128, 7)).astype(np.float32)
    x[..., 4] = rng.random((4, 128, 128)) < 0.2
    x = torch.from_numpy(x)
    with torch.no_grad():
        ref = copy.deepcopy(model).double()(x.double())
        got = model.to(dev)(x.to(dev)).cpu()
    assert torch.isfinite(got).all()
    assert rel_l2(got, ref) <= 5e-6


@pytest.mark.cuda
def test_cno_card_forward_matches_cpu_f64():
    """The CLI's CNO (3 layers, multiplier 32, 6 neck blocks) at 128², B =
    2, weights from seed 0: the card's float32 forward (TF32 off) against
    the same model in float64 on the CPU, relative L2 ≤ 1e-5 (2.4e-6
    measured at B = 4 on an H100, ``chip_smoke.py`` phase 28)."""
    _need_cuda()
    import copy

    from pregen_pde_tpu_torch.models.cno import CNO
    from pregen_pde_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    torch.manual_seed(0)
    model = CNO(128, 7, out_dim=3).eval()
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 128, 128, 7)).astype(np.float32))
    t = torch.tensor([0.2, 0.7])
    with torch.no_grad():
        ref = copy.deepcopy(model).double()(x.double(), t.double())
        got = model.to(dev)(x.to(dev), t.to(dev)).cpu()
    assert torch.isfinite(got).all()
    assert rel_l2(got, ref) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["same-size", "down", "up"])
def test_filtered_lrelu_routes_agree_on_card(kind):
    """CNO's three activation shapes at 128² (the lift's 64 channels, the
    first downsampling's 32, the last upsampling's 16), B = 2: the
    ``upfirdn2d`` routes "matmul", "conv" and "blocked" on the card against
    each other and against the float64 CPU result, relative L2 ≤ 1e-5
    (float32 roundoff; the routes agreed within 2e-6 at B = 16 on an H100,
    ``chip_smoke.py`` phase 28)."""
    _need_cuda()
    from pregen_pde_tpu_torch.models.cno import CNO
    from pregen_pde_tpu_torch.ops.filtered_lrelu import filtered_lrelu
    from pregen_pde_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    torch.manual_seed(0)
    model = CNO(128, 7, out_dim=3)
    act = {"same-size": model.LiftProjectBlock_0.CNOBlock_0.AntiAliasedLReLu_0,
           "down": model.CNOBlock_0.AntiAliasedLReLu_0,
           "up": getattr(model, model.decoder[-1][2]).AntiAliasedLReLu_0}[kind]
    x = torch.randn(2, act.bias.numel(), act.in_size, act.in_size,
                    generator=torch.Generator().manual_seed(1))
    kw = dict(up=act.up, down=act.down, padding=act.padding)
    ref = filtered_lrelu(x.double(), act.fu, act.fd, **kw)
    outs = {impl: filtered_lrelu(x.to(dev), act.fu, act.fd, impl=impl, **kw).cpu()
            for impl in ("matmul", "conv", "blocked")}
    for impl, out in outs.items():
        assert out.shape == ref.shape and rel_l2(out, ref) <= 1e-5, impl
        assert rel_l2(out, outs["matmul"]) <= 1e-5, impl


# -- the generators' fetch into reused page-locked buffers (datagen/fetch.py)


def _checked_to_host(monkeypatch, module):
    """Wrap ``module.to_host`` so each fetch is held against ``.cpu().numpy()``
    of the same device tensor; → the list of fetched arrays."""
    from pregen_pde_tpu_torch.datagen import fetch

    seen = []

    def to_host(t):
        got = fetch.to_host(t)
        assert t.is_cuda and got.tobytes() == t.cpu().numpy().tobytes()
        seen.append(got.nbytes)
        return got

    monkeypatch.setattr(module, "to_host", to_host)
    return seen


@pytest.mark.cuda
@pytest.mark.parametrize("storage_dtype", ["float32", "float16"])
def test_entries_fetch_byte_equal_to_a_pageable_copy(monkeypatch, storage_dtype):
    """The spectral and masked batch entries on the card: each fetch through
    the pool is byte-equal to ``.cpu().numpy()`` of the same tensor, and the
    entries' outputs hold it."""
    _need_cuda()
    from pregen_pde_tpu_torch.datagen import masked_ns, pipeline

    seen = _checked_to_host(monkeypatch, pipeline)
    cfg = pipeline.GenerationConfig(solver=NSVorticityConfig(resolution=128, n_snapshots=3),
                                    batch_size=4, time_scale=5e-6,
                                    storage_dtype=storage_dtype)
    xi, z_re = pipeline.draw_batch_inputs(torch.Generator(device="cuda").manual_seed(5), cfg)
    out = pipeline.generate_ns_batch_from_inputs(xi, z_re, cfg)
    assert seen == [out.nbytes] and out.dtype == np.dtype(storage_dtype)
    assert np.isfinite(out).all()

    seen = _checked_to_host(monkeypatch, masked_ns)
    mcfg = MaskedNSConfig(pipeline="fpo_multi_hole", resolution=128, n_snapshots=3,
                          time_scale=2e-3)
    z_re, masks = masked_ns.draw_masked_inputs(torch.Generator(device="cuda").manual_seed(5),
                                               mcfg, 4)
    stats = masked_ns.new_stats()
    out = masked_ns.generate_masked_ns_batch_from_inputs(z_re, masks, mcfg, storage_dtype,
                                                         stats)
    # a flag a row a pass (the retried rows' on a retry), then the contract once
    assert seen[0] == 4 and seen[-1] == out.nbytes and len(seen) == stats["calls"] + 1
    assert np.isfinite(out).all()


@pytest.mark.cuda
def test_fetch_right_after_a_long_k1_call_returns_the_finished_array():
    """The copy is enqueued behind the kernel and waited for: a fresh pool's
    zeroed buffer never shows through."""
    _need_cuda()
    from pregen_pde_tpu_torch.datagen import fetch

    cfg = NSVorticityConfig(resolution=256, viscosity=1e-3, dt=1e-4, n_snapshots=4,
                            include_initial=True, forcing="fno")
    w0 = to_torch(np.random.default_rng(6).normal(size=(8, 256, 256)), "cuda", torch.float32)
    traj = snc.build_batched_traj(NSVorticitySolver(cfg), output="fields")
    traj(w0[:1], 1e-3, 1)  # built and loaded before the timed call
    torch.cuda.synchronize()
    pool = fetch.HostPool(1 << 30)
    out = traj(w0, 1e-3, 2000)  # ~0.2 s of K1, enqueued
    got = pool.fetch(out)
    torch.cuda.synchronize()
    assert got.tobytes() == out.cpu().numpy().tobytes()
    assert np.isfinite(got).all() and (got[:, -1] != 0).any(axis=(1, 2, 3)).all()
    assert pool.pinned_bytes == got.nbytes


@pytest.mark.cuda
def test_three_spectral_batches_pin_once(monkeypatch):
    """One page-locked buffer serves batch after batch of one size; nothing
    takes the pageable path."""
    _need_cuda()
    from pregen_pde_tpu_torch.datagen import fetch, pipeline
    from pregen_pde_tpu_torch.utils import trace

    monkeypatch.setattr(fetch, "_pool", None)  # a fresh pool
    cfg = pipeline.GenerationConfig(solver=NSVorticityConfig(resolution=128, n_snapshots=3),
                                    batch_size=8, time_scale=5e-6)
    gen = torch.Generator(device="cuda").manual_seed(7)
    trace.reset()
    addrs = set()
    for _ in range(3):
        out = pipeline.generate_ns_batch(gen, cfg)
        assert out.shape == (8, 4, 128, 128, 6) and np.isfinite(out).all()
        addrs.add(out.ctypes.data)
        del out
    tot = trace.totals()
    assert tot["pregen.ns.fetch"]["calls"] == 3
    assert tot["pregen.fetch.pin"]["calls"] == 1
    assert tot["pregen.fetch.pin"]["bytes"] == 8 * 4 * 128 * 128 * 6 * 4
    assert "pregen.fetch.pageable" not in tot
    assert len(addrs) == 1 and fetch.pool().pinned_bytes == 8 * 4 * 128 * 128 * 6 * 4


@pytest.mark.cuda
def test_three_masked_batches_pin_once(monkeypatch):
    """The masked entry fetches its contract into one page-locked buffer
    batch after batch (and its flags into one more); nothing takes the
    pageable path."""
    _need_cuda()
    from pregen_pde_tpu_torch.datagen import fetch, masked_ns
    from pregen_pde_tpu_torch.utils import trace

    monkeypatch.setattr(fetch, "_pool", None)  # a fresh pool
    cfg = MaskedNSConfig(pipeline="fpo_multi_hole", resolution=128, n_snapshots=3,
                         time_scale=2e-3, batch_size=8)
    gen = torch.Generator(device="cuda").manual_seed(7)
    stats = masked_ns.new_stats()
    trace.reset()
    addrs = set()
    for _ in range(3):
        out = masked_ns.generate_masked_ns_batch(gen, cfg, stats=stats)
        assert out.shape == (8, 4, 128, 128, 6) and np.isfinite(out).all()
        addrs.add(out.ctypes.data)
        del out
    tot = trace.totals()
    contract = 8 * 4 * 128 * 128 * 6 * 4
    assert stats["retries"] == 0 and tot["pregen.masked.fetch"]["calls"] == 6
    assert tot["pregen.fetch.pin"]["calls"] == 2
    assert tot["pregen.fetch.pin"]["bytes"] == contract + 8
    assert "pregen.fetch.pageable" not in tot
    assert len(addrs) == 1 and fetch.pool().pinned_bytes == contract + 8


@pytest.mark.cuda
def test_masked_entry_peak_memory_is_the_edts():
    """At B 128, 128², 21 frames, the 0.98 GiB device contract is allocated
    after the SDFs' EDT has freed its 1 GiB intermediate, and the flags read
    the contract in place: the entry's peak stays within the EDT's alone
    plus the masks."""
    _need_cuda()
    from pregen_pde_tpu_torch.datagen import masked_ns
    from pregen_pde_tpu_torch.fields.geometry import sdf_from_mask

    cfg = MaskedNSConfig(pipeline="fpo_multi_hole", resolution=128, time_scale=2e-3)
    z_re, masks = masked_ns.draw_masked_inputs(torch.Generator(device="cuda").manual_seed(8),
                                               cfg, 128)
    masked_ns.generate_masked_ns_batch_from_inputs(z_re[:2], masks[:2], cfg)  # built, loaded
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sdf_from_mask(masks)
    torch.cuda.synchronize()
    edt = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    out = masked_ns.generate_masked_ns_batch_from_inputs(z_re, masks, cfg)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert out.nbytes == 128 * 21 * 128 * 128 * 6 * 4
    assert out.nbytes < peak <= edt + masks.nbytes, (peak, edt)


# -- the fused AdamW (csrc/adamw.cu, ops/adamw.py) against the _foreach route


def _scot_b_leaves():
    """scOT-B's leaves at 128², 7 → 3 channels: (name, shape) in the model's order."""
    from pregen_pde_tpu_torch.__main__ import _make_model

    with torch.device("meta"):
        model = _make_model("scot-B", 128, in_channels=7, out_channels=3)
    return [(n, tuple(p.shape)) for n, p in model.named_parameters()]


def _adamw_copies(leaves, n, tiered=False, weight_decay=0.1, grad_clip=5.0, seed=0):
    """``n`` optimizers over identical N(0, 0.02²) copies of ``leaves`` on
    the card, the scOT main tiers (4 groups) or one group; every copy but
    the first set to the ``_foreach`` route."""
    from pregen_pde_tpu_torch.training.optim import build_optimizer
    from pregen_pde_tpu_torch.training.tiers import SCOT_TIER_DECAY, scot_main_tiers, scot_tier_of
    from pregen_pde_tpu_torch.training.trainer import TrainerConfig

    gen = torch.Generator(device="cuda").manual_seed(seed)
    weights = [(name, 0.02 * torch.randn(s, generator=gen, device="cuda")) for name, s in leaves]
    cfg = TrainerConfig(learning_rate=1e-3, weight_decay=weight_decay, grad_clip=grad_clip,
                        epochs=2, lr_tiers=scot_main_tiers(1e-3, 3e-3, 4e-3) if tiered else None)
    tier = dict(tier_fn=scot_tier_of, tier_decay=SCOT_TIER_DECAY) if tiered else {}
    opts = [build_optimizer(cfg, 3, [(name, torch.nn.Parameter(w.clone())) for name, w in weights],
                            **tier) for _ in range(n)]
    assert len(opts[0].groups) == (4 if tiered else 1)
    assert opts[0].fused is not None
    for o in opts[1:]:
        o.fused = None
    return opts


def _set_grads(opts, gen, scale, none=()):
    """The same N(0, scale²) gradient on each copy of a leaf; None for the
    leaves in ``none``. → the gradients given."""
    given = []
    for i, ps in enumerate(zip(*(o.params for o in opts))):
        g = None if i in none else scale * torch.randn(ps[0].shape, generator=gen, device="cuda")
        for p in ps:
            p.grad = None if g is None else g.clone()
        given.append(g)
    return given


def _state_bits(opt):
    """p, m and v of every leaf, as int32 bit patterns, each one flat tensor."""
    flat = lambda ts: torch.cat([t.detach().reshape(-1) for t in ts]).view(torch.int32)
    return {"p": flat(opt.params), "m": flat([opt.m[id(p)] for p in opt.params]),
            "v": flat([opt.v[id(p)] for p in opt.params])}


def _ulps(a_bits, b_bits):
    """Floats apart, from int32 bit patterns (the sign-magnitude order)."""
    order = lambda b: torch.where(b < 0, -(b.long() & 0x7FFFFFFF), b.long())
    return (order(a_bits) - order(b_bits)).abs()


@pytest.mark.cuda
@pytest.mark.parametrize("weight_decay", [0.1, 0.0], ids=["decay", "no-decay"])
@pytest.mark.parametrize("tiered", [False, True], ids=["one-group", "four-tiers"])
def test_adamw_kernel_bit_equal_to_foreach_on_scot_b(tiered, weight_decay):
    """Five steps on scOT-B's 1,580 leaves with the clip on but not engaged
    (global norm ~1.3 < 5), two leaves without a gradient on steps 2 and 4:
    p, m and v bit-equal to the ``_foreach`` route's; ``.grad`` untouched;
    two launches a step; the step allocates under 16 MB."""
    _need_cuda()
    from pregen_pde_tpu_torch.ops import adamw

    opts = _adamw_copies(_scot_b_leaves(), 2, tiered, weight_decay)
    gen = torch.Generator(device="cuda").manual_seed(1)
    adamw.reset_launches()
    for step in range(5):
        given = _set_grads(opts, gen, 1e-4, none=(3, 700) if step in (1, 3) else ())
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        opts[0].step()
        torch.cuda.synchronize()
        assert torch.cuda.max_memory_allocated() - base < 16 * 2 ** 20
        assert float(opts[0].fused.clip_out[0]) < 5.0
        opts[1].step()
        for p, g in zip(opts[0].params, given):
            assert (p.grad is None) if g is None else torch.equal(p.grad, g)
    assert adamw.launches == 2 * 5
    got, want = _state_bits(opts[0]), _state_bits(opts[1])
    for k in got:
        assert torch.equal(got[k], want[k]), (k, int(_ulps(got[k], want[k]).max()))


@pytest.mark.cuda
def test_adamw_kernel_with_the_clip_engaged(monkeypatch):
    """Five steps on scOT-B's leaves at a global norm ~12.6 > 5, four tiers:
    the kernel's norm within 1 ulp of float64's and within 2 of the
    ``_foreach`` route's own (a sum in another order); given the kernel's
    norm, that route's p, m and v are bit-equal to the kernel's; left to its
    own, its p is within 4 ulps of the parameters' largest magnitude (an
    element near nought parts by more of its own ulps: the update's
    rounding, on the update's scale, not its own)."""
    _need_cuda()
    opts = _adamw_copies(_scot_b_leaves(), 3, tiered=True)
    gen = torch.Generator(device="cuda").manual_seed(2)
    bits = lambda t: t.float().reshape(1).view(torch.int32)
    for _ in range(5):
        given = _set_grads(opts, gen, 1e-3)
        exact = torch.stack([g.double().square().sum() for g in given]).sum().sqrt()
        own = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(given)))
        opts[0].step()
        norm = opts[0].fused.clip_out[0].clone()
        assert float(norm) > 5.0
        assert int(_ulps(bits(norm), bits(exact))) <= 1
        assert int(_ulps(bits(norm), bits(own))) <= 2
        with monkeypatch.context() as m:
            m.setattr(torch.linalg, "vector_norm", lambda *a, **k: norm)
            opts[1].step()
        opts[2].step()
    got, given_norm, own_norm = (_state_bits(o) for o in opts)
    for k in got:
        assert torch.equal(got[k], given_norm[k]), k
    p, p_own = got["p"].view(torch.float32), own_norm["p"].view(torch.float32)
    top = p.abs().max()
    assert float((p - p_own).abs().max()) <= 4 * float(torch.nextafter(top, 2 * top) - top)


@pytest.mark.cuda
@pytest.mark.parametrize("grad_clip", [5.0, None], ids=["clip", "no-clip"])
def test_adamw_kernel_odd_leaves_and_a_nan(grad_clip):
    """Leaves of odd sizes at every 4-byte offset (the element-wise path and
    the ragged tails), one without a gradient, then a NaN in one gradient:
    the same bits as the ``_foreach`` route, NaN where it has NaN (every
    leaf under the clip, whose norm turns NaN; that leaf alone without it);
    one launch a step without the clip."""
    _need_cuda()
    from pregen_pde_tpu_torch.ops import adamw
    from pregen_pde_tpu_torch.training.optim import TieredAdamW, make_schedule

    gen = torch.Generator(device="cuda").manual_seed(3)
    sizes = [1, 3, 5, 16384, 16385, 40001, 7, 2]
    bases = [torch.randn(n + 3, generator=gen, device="cuda") for n in sizes]
    opts = []
    for _ in range(2):
        params = [torch.nn.Parameter(b.clone()[k % 4: k % 4 + n])
                  for k, (b, n) in enumerate(zip(bases, sizes))]
        assert len({p.data_ptr() % 16 for p in params}) == 4
        groups = [{"name": "a", "params": params[:4], "decay": [True, False, True, True],
                   "schedule": make_schedule("cosine", 1e-2, 6)},
                  {"name": "b", "params": params[4:], "decay": [False, True, True, False],
                   "schedule": make_schedule("constant", 3e-3, 6)}]
        opts.append(TieredAdamW(groups, 0.1, grad_clip))
    opts[1].fused = None
    adamw.reset_launches()
    for step in range(3):
        given = _set_grads(opts, gen, 0.5, none=(2,))
        if step == 2:
            for o in opts:
                o.params[5].grad[17] = float("nan")
        for o in opts:
            o.step()
    assert adamw.launches == 3 * (2 if grad_clip else 1)
    for k, (a, b) in enumerate(zip(opts[0].params, opts[1].params)):
        a, b = a.detach(), b.detach()
        assert torch.equal(a.isnan(), b.isnan()), k
        assert torch.equal(a[~a.isnan()], b[~b.isnan()]), k
        assert bool(a.isnan().all()) == (grad_clip is not None)
        assert bool(a.isnan().any()) == (grad_clip is not None or k == 5)
    assert given[2] is None


@pytest.mark.cuda
def test_adamw_reset_and_what_the_kernel_refuses():
    """``reset()`` zeroes the moments and rebuilds the rows: the next steps
    are bit-equal to the ``_foreach`` route's after its reset. A float64 or
    non-contiguous CUDA leaf, a non-contiguous gradient, and a moment
    rebound without ``reset()`` (the rows would update the old one), raise."""
    _need_cuda()
    from pregen_pde_tpu_torch.training.optim import TieredAdamW, make_schedule

    leaves = [(f"w{i}", s) for i, s in enumerate([(64, 48), (48,), (3, 5, 7), (1,)])]
    opts = _adamw_copies(leaves, 2)
    gen = torch.Generator(device="cuda").manual_seed(4)
    for step in range(4):
        if step == 2:
            old = opts[0].fused
            for o in opts:
                o.reset()
            assert opts[0].fused is not old and opts[0].count == 0
            assert all(float(t.abs().max()) == 0 for t in opts[0].m.values())
            opts[1].fused = None
        _set_grads(opts, gen, 0.05)  # global norm ~2.8: the clip not engaged
        for o in opts:
            o.step()
    got, want = _state_bits(opts[0]), _state_bits(opts[1])
    assert all(torch.equal(got[k], want[k]) for k in got)

    group = lambda p: [{"name": "a", "params": [p], "decay": [True],
                        "schedule": make_schedule("constant", 1e-3, 1)}]
    for p in (torch.nn.Parameter(torch.zeros(4, 3, device="cuda", dtype=torch.float64)),
              torch.nn.Parameter(torch.zeros(4, 3, device="cuda").t())):
        with pytest.raises(ValueError, match="float32, contiguous"):
            TieredAdamW(group(p), 0.1, 5.0)
    p = torch.nn.Parameter(torch.zeros(4, 3, device="cuda"))
    opt = TieredAdamW(group(p), 0.1, 5.0)
    p.grad = torch.ones(3, 4, device="cuda").t()
    with pytest.raises(ValueError, match="contiguous gradients"):
        opt.step()
    p.grad = torch.ones(4, 3, device="cuda")
    opt.step()
    opt.v[id(p)] = opt.v[id(p)].clone()
    with pytest.raises(RuntimeError, match="moment's storage moved"):
        opt.step()
    opt.reset()
    opt.step()
