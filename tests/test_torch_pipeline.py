"""Port parity: the main path as a whole — draws → buckets → stepper →
contract → shard writer — and the port's import, build and device guards."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pregen_pde_tpu.core.config import NSVorticityConfig as JaxConfig
from pregen_pde_tpu.datagen import pipeline as jpipe
from pregen_pde_tpu_torch.core import NSVorticityConfig
from pregen_pde_tpu_torch.datagen import pipeline as tpipe
from pregen_pde_tpu_torch.datagen.writer import ShardWriter, load_shards, scan_existing_shards
from pregen_pde_tpu_torch.kernels import build as kbuild
from pregen_pde_tpu_torch.utils.parity import rel_l2, to_torch

from torch_threads import _one_torch_thread  # noqa: F401 (autouse)


def _jax_draws(key, n_traj, n):
    """The draws `generate_ns_batch` makes (`datagen/pipeline.py:239-240`,
    `fields/grf.py:54`, `solvers/schedules.py:55`)."""
    k_re, k_ic = jax.random.split(key)
    keys = jax.random.split(k_ic, n_traj)
    xi = np.stack([np.asarray(jax.random.normal(k, (n, n), dtype=jnp.float32))
                   for k in keys])
    z_re = np.asarray(jax.random.normal(k_re, (n_traj,)))
    return xi, z_re


@pytest.mark.parametrize("vary", [True, False])
def test_slice_matches_jax_generate_ns_batch(vary):
    solver_kw = dict(resolution=32)
    if not vary:  # keep the fixed horizon short: t_end 10 would be 100k steps
        solver_kw = dict(resolution=32, t_end=4e-3, n_snapshots=2)
    kw = dict(batch_size=4, time_scale=1e-6, vary_difficulty=vary)
    key = jax.random.key(3)
    ref = jpipe.generate_ns_batch(key, jpipe.GenerationConfig(
        solver=JaxConfig(**solver_kw), **kw))
    xi, z_re = _jax_draws(key, 4, 32)
    got = tpipe.generate_ns_batch_from_inputs(to_torch(xi), to_torch(z_re), tpipe.GenerationConfig(
        solver=NSVorticityConfig(**solver_kw), **kw))
    assert got.shape == ref.shape and got.dtype == ref.dtype
    assert rel_l2(got, ref) <= 1e-5
    # Re_norm, mask and SDF channels are exact
    np.testing.assert_allclose(got[..., 3:], ref[..., 3:], rtol=1e-7, atol=0)


def test_cuda_method_one_stepper_call_per_batch(monkeypatch):
    """On the CUDA method the whole batch is one stepper call, each row at
    its horizon bucket's inner steps; every row equals the bucketed plain
    path's. The kernel wrapper runs its plain version on these CPU tensors,
    behind a stub that counts the calls."""
    from pregen_pde_tpu_torch.solvers import spectral_ns_cuda as tsnc

    calls = []
    real = tsnc.build_batched_traj

    def counting(*args, **kwargs):
        traj = real(*args, **kwargs)

        def wrapped(w0, nu=None, inner_steps=None):
            calls.append(inner_steps)
            return traj(w0, nu, inner_steps)

        return wrapped

    monkeypatch.setattr(tsnc, "build_batched_traj", counting)
    cfg = tpipe.GenerationConfig(solver=NSVorticityConfig(resolution=128, n_snapshots=2),
                                 batch_size=4, time_scale=5e-7)
    xi, z_re = tpipe.draw_batch_inputs(torch.Generator().manual_seed(2), cfg)
    got = tpipe.generate_ns_batch_from_inputs(xi, z_re, dataclasses.replace(
        cfg, method="cn_ab2_cuda"))
    assert len(calls) == 1
    inner = calls[0]
    assert isinstance(inner, torch.Tensor) and inner.shape == (4,)
    assert len(torch.unique(inner)) > 1  # several buckets in the one call
    ref = tpipe.generate_ns_batch_from_inputs(xi, z_re, dataclasses.replace(
        cfg, method="cn_ab2_packed"))
    assert got.shape == ref.shape == (4, 3, 128, 128, 6)
    for row in range(4):
        assert rel_l2(got[row], ref[row]) <= 1e-6


def test_pipeline_own_draws_storage_and_guards(tmp_path):
    cfg = tpipe.GenerationConfig(solver=NSVorticityConfig(resolution=32),
                                 batch_size=3, time_scale=1e-6)
    a = tpipe.generate_ns_batch(torch.Generator().manual_seed(1), cfg)
    assert a.shape == (3, 21, 32, 32, 6) and a.dtype == np.float32
    assert np.isfinite(a).all()
    assert (a[..., 4] == 0).all() and (a[..., 5] == 1).all()
    assert ((a[..., 3] >= 0) & (a[..., 3] <= 1)).all()
    h = tpipe.generate_ns_batch(torch.Generator().manual_seed(1),
                                dataclasses.replace(cfg, storage_dtype="float16"))
    assert h.dtype == np.float16
    np.testing.assert_allclose(h.astype(np.float32), a, rtol=1e-3, atol=1e-3)
    assert tpipe.resolve_method("auto", 256, torch.device("cpu")) == "cn_ab2_packed"
    assert tpipe.resolve_method("cn_heun_packed", 256, torch.device("cpu")) == "cn_heun_packed"
    # on CUDA, "auto" is the kernel or an error, never the plain stepper
    assert tpipe.resolve_method("auto", 256, torch.device("cuda")) == "cn_ab2_cuda"
    with pytest.raises(ValueError, match="handles n in"):
        tpipe.resolve_method("auto", 384, torch.device("cuda"))
    assert tpipe.resolve_method("cn_ab2_packed", 384, torch.device("cuda")) == "cn_ab2_packed"
    with pytest.raises(NotImplementedError):
        tpipe.generate_ns_batch(torch.Generator(), tpipe.GenerationConfig(
            solver=NSVorticityConfig(resolution=32), max_steps_per_program=10), 1)

    class NativeShardWriter:  # the guard keys on the writer's type name
        pass

    with pytest.raises(ValueError, match="float32-only"):
        tpipe.generate_ns_dataset(torch.Generator(), tpipe.GenerationConfig(
            storage_dtype="float16"), 1, writer=NativeShardWriter())


def test_drop_nonfinite_matches_jax():
    arr = np.ones((4, 2, 3, 3, 6), np.float32)
    arr[1, 0, 0, 0, 0] = np.nan
    arr[3, 1, 2, 2, 5] = np.inf
    got, bad = tpipe.drop_nonfinite_trajectories(arr)
    ref, rbad = jpipe.drop_nonfinite_trajectories(arr)
    assert bad == rbad == 2
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("backend", ["auto", "python"])
def test_cli_generate_writes_readable_shards(tmp_path, backend):
    from pregen_pde_tpu_torch.__main__ import main

    out = tmp_path / "ns"
    if backend == "python":  # float16 storage routes to the Python writer
        argv_extra = ["--storage-dtype", "float16"]
    else:
        argv_extra = []
    base = ["generate", "--workload", "ns_spectral", "--resolution", "32",
            "--batch-size", "2", "--time-scale", "1e-6", "--device", "cpu",
            "--out", str(out), *argv_extra]
    main(base + ["--n", "3"])
    data = load_shards(out)
    assert data.shape == (3, 21, 32, 32, 6) and np.isfinite(data).all()
    assert scan_existing_shards(out) == (2, 3)
    main(base + ["--n", "5", "--resume"])
    assert load_shards(out).shape == (5, 21, 32, 32, 6)
    np.testing.assert_array_equal(load_shards(out)[:3], data)


def test_writer_h5_roundtrip(tmp_path):
    pytest.importorskip("h5py")
    import h5py

    w = ShardWriter(tmp_path, fmt="h5")
    w.write_batch(np.zeros((2, 3, 4, 4, 6), np.float32))
    w.write_batch(np.ones((1, 3, 4, 4, 6), np.float32))
    w.close()
    with h5py.File(tmp_path / "results.h5") as f:
        assert f["data"].shape == (3, 3, 4, 4, 6)
    with pytest.raises(FileNotFoundError):
        load_shards(tmp_path / "missing")


def test_cli_cuda_device_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the guard only fires without it")
    from pregen_pde_tpu_torch.__main__ import main

    with pytest.raises(RuntimeError, match="cuda"):
        main(["generate", "--n", "1", "--resolution", "32", "--out",
              str(tmp_path / "x"), "--device", "cuda"])
    assert not (tmp_path / "x").exists()


def test_kernel_build_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(kbuild, "CUDA_HOME_DEFAULT", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kbuild.build("spectral_ns_step", build_dir=tmp_path / "build")
    assert not (tmp_path / "build").exists()


def test_kernel_profiling_build_is_its_own_artifact():
    """A build with -D defines (profile_k2's phase clocks) hashes to another
    library than the plain build, so neither replaces the other."""
    plain = kbuild.library_path("ns_projection_step")
    prof = kbuild.library_path("ns_projection_step", defines=("NSP_PHASE_CLOCKS",))
    assert plain != prof and prof.name.startswith("ns_projection_step_")
    assert plain == kbuild.library_path("ns_projection_step", defines=())


def test_port_imports_no_jax_or_triton():
    code = (
        "import sys\n"
        "import pregen_pde_tpu_torch, pregen_pde_tpu_torch.__main__\n"
        "import pregen_pde_tpu_torch.datagen.pipeline, pregen_pde_tpu_torch.datagen.writer\n"
        "import pregen_pde_tpu_torch.solvers.spectral_ns_cuda\n"
        "import pregen_pde_tpu_torch.datagen.masked_ns, pregen_pde_tpu_torch.solvers.validation\n"
        "import pregen_pde_tpu_torch.solvers.ns_projection_cuda, pregen_pde_tpu_torch.profile_k2\n"
        "import pregen_pde_tpu_torch.utils.parity, pregen_pde_tpu_torch.utils.device\n"
        "bad = [m for m in ('jax', 'triton') if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert r.returncode == 0 and "clean" in r.stdout, r.stderr
