"""The check against faults of the timed path: a run driven on the CPU at a
tiny size (the look for a card skipped), with the port's batch entry broken
underneath, must come out not correct; a sound run and the control's
readings beside it."""

from __future__ import annotations

import numpy as np
import pytest
import torch
from bench_fixture import fixture_root

from portbench import run

CELLS = ("tiny_spectral.a", "tiny_masked.a")


def _entry_module(cell):
    if cell.startswith("tiny_spectral"):
        from pregen_pde_tpu_torch.datagen import pipeline

        return pipeline, "generate_ns_batch_from_inputs"
    from pregen_pde_tpu_torch.datagen import masked_ns

    return masked_ns, "generate_masked_ns_batch_from_inputs"


def _wrap(monkeypatch, cell, fault):
    mod, name = _entry_module(cell)
    real = getattr(mod, name)

    def broken(*args, **kwargs):
        return fault(real(*args, **kwargs))

    monkeypatch.setattr(mod, name, broken)


def _run(tmp_path, cell):
    spec = run.load_cell(cell, fixture_root(tmp_path))
    result, _ = run.run_cell(spec, 2**31 + 99, 0.0, False, torch.device("cpu"))
    return result


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tmp_path, cell):
    result = _run(tmp_path, cell)
    assert result["correct"], result["check"]
    assert result["attempted"] == 4 and result["failed"] == 0


def _half_left_out(out):
    h = len(out) // 2
    out[h:] = out[:len(out) - h]
    return out


def _answer_altered(out):
    out[1, -1, :, :, 1] *= 1.01
    return out


def _rows_swapped(out):
    out[[0, 1]] = out[[1, 0]]
    return out


def _re_channel_altered(out):
    out[2, :, :, :, 3] += 1e-6
    return out


@pytest.mark.parametrize("fault", [_half_left_out, _answer_altered, _rows_swapped,
                                   _re_channel_altered])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_batch_is_not_correct(tmp_path, monkeypatch, cell, fault):
    _wrap(monkeypatch, cell, fault)
    result = _run(tmp_path, cell)
    assert not result["correct"], (fault.__name__, result["check"])


@pytest.mark.parametrize("cell", CELLS)
def test_a_step_that_returns_its_state_is_not_correct(tmp_path, monkeypatch, cell):
    if cell.startswith("tiny_spectral"):
        from pregen_pde_tpu_torch.solvers.spectral_ns import NSVorticitySolver

        def frozen(self, method="cn_ab2_packed", inner_steps=None):
            def traj(w0, nu=None, inner_steps=None):
                T = self.cfg.n_snapshots + 1
                return w0.unsqueeze(-3).expand(*w0.shape[:-2], T, *w0.shape[-2:])
            return traj

        monkeypatch.setattr(NSVorticitySolver, "make_trajectory_fn_nu", frozen)
    else:
        from pregen_pde_tpu_torch.solvers.ns_projection import ProjectionSolver

        monkeypatch.setattr(ProjectionSolver, "step",
                            lambda self, u, v, mask, dx, dt, u_max=None, p_prev=None:
                            (u, v, torch.zeros_like(u)))
    result = _run(tmp_path, cell)
    assert not result["correct"], result["check"]


def _rows_lost(out):
    out[1, 5] = np.nan  # a row left non-finite, as if its retries were dropped
    return out


@pytest.mark.parametrize("cell", CELLS)
def test_a_finishable_row_left_non_finite_is_not_correct(tmp_path, monkeypatch, cell):
    _wrap(monkeypatch, cell, _rows_lost)
    result = _run(tmp_path, cell)
    assert result["failed"] == 1 and not result["correct"]
    assert result["check"]["lost_rows"]["value"] == 1


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(tmp_path, cell):
    """The program's own lower-precision path, its contract stored in
    float16, fails the check at a tiny size: the copy of the control that
    ``limits.py`` reads on the card at each cell's size."""
    spec = run.load_cell(cell, fixture_root(tmp_path))
    spec["config"] = {**spec["config"], "storage_dtype": "float16"}
    result, _ = run.run_cell(spec, 2**31 + 99, 0.0, False, torch.device("cpu"))
    check = result["check"]
    assert not result["correct"] and result["failed"] == 0
    assert check["aux_gap"]["value"] > 0
    uvp = "uvp_gap" if cell.startswith("tiny_spectral") else "uvp_ratio"
    print(cell, {k: v["value"] for k, v in check.items()})
    assert check[uvp]["value"] > check[uvp]["limit"]
