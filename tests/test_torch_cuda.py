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
from pregen_pde_tpu_torch.datagen.masked_ns import MaskedNSConfig, sample_masks
from pregen_pde_tpu_torch.solvers import ns_projection_cuda as npc
from pregen_pde_tpu_torch.solvers import spectral_ns_cuda as snc
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
@pytest.mark.parametrize("output", ["vorticity", "fields"])
def test_k1_kernel_matches_plain(output):
    """The kernel vs its plain version (f32, on the CPU), per snapshot."""
    _need_cuda()
    n = 128
    cfg = NSVorticityConfig(resolution=n, viscosity=1e-3, dt=1e-3, t_end=6e-3,
                            n_snapshots=3, include_initial=True, forcing="fno",
                            drag=0.1)
    sol = NSVorticitySolver(cfg)
    w0 = to_torch(np.random.default_rng(4).normal(size=(2, n, n)), "cuda", torch.float32)
    nu = torch.tensor([1e-3, 2e-3], device="cuda")
    snc.reset_launches()
    got = snc.build_batched_traj(sol, output=output)(w0, nu)
    torch.cuda.synchronize()
    # kernels enqueued: init 2 + a bootstrap step 3, 3 per step (3 intervals
    # × 2 steps), a snapshot 2 (vorticity) or 4 (fields; also frame 0)
    snaps = 3 if output == "vorticity" else 4
    assert snc.launches == 5 + 3 * 6 + snaps * (2 if output == "vorticity" else 4)
    ref = snc.build_batched_traj(sol, output=output)(w0.cpu(), nu.cpu())
    assert got.shape == ref.shape
    # f32 roundoff over a few steps (~3e-7 measured on an H100)
    assert per_snapshot_rel_l2(got, ref).max() < 2e-6


# K2 against its plain float32 version, per snapshot: chip_smoke.py phase
# 8's bar, 30x the worst difference measured when both are right (2.3e-6)
K2_VS_PLAIN_BAR = 7e-5


@pytest.mark.cuda
@pytest.mark.parametrize("n", [32, 96, 128, 256])
@pytest.mark.parametrize("domain", ["channel", "cavity"])
def test_k2_kernel_matches_plain(n, domain):
    _need_cuda()
    B = 4
    sol = ProjectionSolver(ProjectionConfig(resolution=n, domain=domain, n_snapshots=3))
    pipeline = "fpo_multi_hole" if domain == "channel" else "ldc_regular"
    masks = sample_masks(torch.Generator(device="cuda").manual_seed(n),
                         MaskedNSConfig(pipeline=pipeline, resolution=n), B)
    u_max = torch.linspace(100, 10000, B, device="cuda") * 1.5e-5 / 2.0
    dt = 0.5 * (2.0 / n) / (3.5 * float(u_max.max()))  # the batch's smallest CFL dt
    got = npc.build_batched_traj(sol)(masks, u_max, 10, dt)
    ref = sol.make_batched_trajectory_fn()(masks, u_max, 10, dt)
    torch.cuda.synchronize()
    assert got.shape == ref.shape == (B, 4, n, n, 3)
    assert torch.isfinite(got).all()
    assert per_snapshot_rel_l2(got, ref).max() <= K2_VS_PLAIN_BAR


@pytest.mark.cuda
def test_k2_launch_count():
    _need_cuda()
    sol = ProjectionSolver(ProjectionConfig(resolution=128, n_snapshots=2))
    npc.reset_launches()
    npc.build_batched_traj(sol)(torch.zeros((2, 128, 128), device="cuda"), None, 3, 0.01)
    torch.cuda.synchronize()
    # init + frame 0, then per snapshot 3 steps × 7 launches + the frame
    assert npc.launches == 2 + 2 * (3 * 7 + 1)
