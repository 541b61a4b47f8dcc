"""The fixture's training cell, ``tiny_train.a``, through ``run.py`` on the
CPU (the look for a card skipped): the port's ``Trainer.train_step`` on its
``FNO2d``, checked against the plain replay of the same steps. A sound run
is correct; each fault patched into ``Trainer.train_step`` is not."""

from __future__ import annotations

import pytest
import torch
from bench_fixture import cpu_cell, fixture_root

from portbench import run
from pregen_pde_tpu_torch.training.trainer import Trainer

SEED = 2**31 + 29
SECONDS = 0.3
REAL_STEP = Trainer.train_step


def _run(tmp_path, seconds=SECONDS, seed=SEED):
    spec = cpu_cell("tiny_train.a", fixture_root(tmp_path))
    return run.run_cell(spec, seed, seconds, False, torch.device("cpu"))


def test_sound_run_is_correct(tmp_path):
    result, extra = _run(tmp_path)
    assert result["correct"], result["check"]
    assert result["failed"] == 0 and extra["check_info"]["rows_compared"] > 0
    # one update a window step, and traj_per_s counts the steps' samples
    assert extra["counters"]["optimizer_steps"] == extra["batches"]
    assert result["attempted"] == extra["batches"] * 4
    assert result["metrics"]["traj_per_s"]["value"] == pytest.approx(
        result["attempted"] / extra["window_s"])


def _with_optimizer_step(change):
    """``train_step`` with the optimizer's ``step`` replaced by
    ``change(step, optimizer)`` for the call."""
    def train_step(self, batch):
        opt = self.optimizer
        opt.step = change(type(opt).step.__get__(opt), opt)
        try:
            return REAL_STEP(self, batch)
        finally:
            del opt.step
    return train_step


def _update_skipped(step, opt):
    return lambda: None


def _update_twice(step, opt):
    def twice():
        step()
        step()
    return twice


def _learning_rate_up(step, opt):
    def scaled():
        saved = [g["schedule"] for g in opt.groups]
        for g, f in zip(opt.groups, saved):
            g["schedule"] = lambda c, f=f: 1.01 * f(c)
        try:
            step()
        finally:
            for g, f in zip(opt.groups, saved):
                g["schedule"] = f
    return scaled


def _another_steps_batch(self, batch):
    """Each step trains on the batch the step before it was given."""
    prev, self.prev_batch = getattr(self, "prev_batch", batch), batch
    return REAL_STEP(self, prev)


def _half_the_batch(self, batch):
    """The loss's mean over the first half of the samples only."""
    half = len(batch["time"]) // 2
    return REAL_STEP(self, {k: v[:half] for k, v in batch.items()})


FAULTS = {"update_skipped": _with_optimizer_step(_update_skipped),
          "update_twice": _with_optimizer_step(_update_twice),
          "learning_rate_x1.01": _with_optimizer_step(_learning_rate_up),
          "another_steps_batch": _another_steps_batch,
          "half_the_batch": _half_the_batch}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_broken_step_is_not_correct(tmp_path, monkeypatch, fault):
    monkeypatch.setattr(Trainer, "train_step", FAULTS[fault])
    result, extra = _run(tmp_path)
    assert not result["correct"], (fault, result["check"])
    assert result["failed"] == 0 and extra["check_info"]["rows_compared"] > 0


def test_a_kept_step_left_non_finite_is_not_correct(tmp_path, monkeypatch):
    """The parameters go non-finite in the second window step: its rows are
    failed, the first step's compare sound, and the lost step reads an
    unbounded gap."""
    def poisoned(self, batch):
        loss = REAL_STEP(self, batch)
        if self.optimizer.count == 3:  # the warm-up's update, then the window's two
            with torch.no_grad():
                next(self.model.parameters()).fill_(float("nan"))
        return loss

    monkeypatch.setattr(Trainer, "train_step", poisoned)
    result, extra = _run(tmp_path, seconds=1.0)
    assert extra["batches"] >= 2, "the window ran one step only"
    assert not result["correct"] and result["failed"] == result["attempted"] - 4
    assert extra["check_info"]["steps_compared"] == 1
    assert extra["check_info"]["steps_lost"] >= 1
