"""The port's fine-tuning (``pregen_pde_tpu_torch/training/finetune.py``
and the ``finetune`` subcommand) against the JAX package's on the CPU, and
the CLI with ``--model cno``.

``AdapterWrapper`` around a small CNO with both adapters against flax's in
float64 (the weights carried by ``flax_tree``, bar 1e-12 relative L2,
measured ≤ 5e-15); every parameter's fine-tuning tier against JAX's label
of its flax path; then ``train --model cno`` → ``best.pt`` → ``evaluate
--model cno`` and ``finetune --pretrained best.pt`` at 32² on the CPU, and
what the port does not take yet raising.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from pregen_pde_tpu.models import cno as jcno
from pregen_pde_tpu.training import finetune as jft
from pregen_pde_tpu.training.trainer import _label_params
from pregen_pde_tpu_torch.__main__ import main
from pregen_pde_tpu_torch.models import cno as tcno
from pregen_pde_tpu_torch.models.scot import ScOT, ScOTConfig
from pregen_pde_tpu_torch.training import finetune as tft
from pregen_pde_tpu_torch.utils.parity import rel_l2

from test_torch_cno import SMALL, flax_tree, perturbed
from test_torch_fno import _contract
from test_torch_scot import KW
from torch_threads import _one_torch_thread  # noqa: F401 (autouse)

BAR = 1e-12  # float64 roundoff; measured ≤ 5e-15


def _wrapped(in_channels=7, out_channels=3, base_in=5, base_out=2):
    torch.manual_seed(0)
    base = tcno.CNO(16, base_in, out_dim=base_out, **SMALL)
    return tft.AdapterWrapper(base, base_in_channels=base_in, in_channels=in_channels,
                              base_out_channels=base_out, out_channels=out_channels)


def test_adapter_wrapper_matches_flax():
    """Both adapters (7 → 5 channels in, 2 → 3 out) around a small CNO,
    forward against flax's ``AdapterWrapper``; with matching channels no
    adapter exists."""
    tm = perturbed(_wrapped())
    names = {k.split(".")[0] for k, _ in tm.named_parameters()}
    assert names == {"base", "in_adapter_1", "in_adapter_2", "out_adapter_1", "out_adapter_2"}
    assert tm.in_adapter_1.weight.shape == (64, 7, 1, 1)  # OIHW, as the converter lays it out
    x = np.random.default_rng(2).standard_normal((2, 16, 16, 7))
    t = np.array([0.25, 0.75])
    jm = jft.AdapterWrapper(base=jcno.CNO(in_size=16, out_dim=2, **SMALL), base_in_channels=5,
                            out_channels=3)
    ref = np.asarray(jm.apply({"params": flax_tree(tm.named_parameters())}, jnp.asarray(x),
                              jnp.asarray(t)))
    out = tm(torch.from_numpy(x), torch.from_numpy(t))
    assert out.shape == (2, 16, 16, 3) and rel_l2(out, ref) <= BAR
    bare = _wrapped(in_channels=5, out_channels=2)
    assert {k.split(".")[0] for k, _ in bare.named_parameters()} == {"base"}
    assert _wrapped(out_channels=None).has_out is False


def test_adapter_init_law():
    """flax Conv's init: lecun-normal kernels (σ = 1/√fan_in, truncated at
    2σ), zero biases."""
    m = _wrapped(in_channels=7).requires_grad_(False)
    w = m.out_adapter_2.weight  # fan_in 64
    assert float(w.abs().max()) <= 2 / 8 / 0.87962566103423978
    assert abs(float(m.in_adapter_1.weight.std()) * 7 ** 0.5 - 1.0) < 0.15  # 448 draws
    assert all(torch.equal(getattr(m, n).bias, torch.zeros_like(getattr(m, n).bias))
               for n in ("in_adapter_1", "in_adapter_2", "out_adapter_1", "out_adapter_2"))


@pytest.mark.parametrize("base", ["cno", "scot"])
def test_tiers_match_jax_labels(base):
    """Each parameter's tier is JAX's ``finetune_tier_fn`` label of its flax
    path (``_label_params``, as the JAX trainer applies it): CNO's FILM and
    norms in "norm", scOT's conditional norms in "norm", the adapters in
    "adapter", the rest in "base"."""
    if base == "cno":
        m = _wrapped()
    else:
        torch.manual_seed(0)
        m = tft.AdapterWrapper(ScOT(ScOTConfig(**KW)), base_in_channels=7, in_channels=4,
                               base_out_channels=3, out_channels=3)
    tree = flax_tree(m.named_parameters())
    labels = traverse_util.flatten_dict(_label_params(tree, jft.finetune_tier_fn))
    ours = {tuple(k.split(".")[:-1]) + (("kernel",) if k.endswith(".weight")
                                        else (k.split(".")[-1],)): tft.finetune_tier_of(k)
            for k, _ in m.named_parameters()}
    assert ours == labels
    assert set(ours.values()) == {"base", "norm", "adapter"}
    assert tft.DEFAULT_FT_TIERS == jft.DEFAULT_FT_TIERS


def _lines(capsys):
    return [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]


def test_cli_cno_train_evaluate_finetune(tmp_path, capsys):
    """On the CPU at 32² with the CLI's CNO (3 layers, multiplier 32, 6
    neck blocks): ``train --model cno`` writes ``best.pt``, ``evaluate
    --model cno`` reads it, ``finetune`` (CNO by default) starts from it
    and writes its own; ``--lr-embedding`` with CNO, the benchmark datasets
    and an orbax directory raise."""
    data = tmp_path / "d.npy"
    np.save(data, _contract(n=8, t=3, s=32, seed=3))
    ckpt, ft_ckpt = tmp_path / "ck", tmp_path / "ft"
    main(["train", "--model", "cno", "--data", str(data), "--epochs", "1", "--batch-size", "4",
          "--ckpt", str(ckpt), "--device", "cpu"])
    lines = _lines(capsys)
    assert set(lines[0]["kernel_launches"].values()) == {0}
    assert lines[1]["epoch"] == 0 and np.isfinite(lines[1]["train_loss"])
    best = torch.load(ckpt / "best.pt", weights_only=True)
    assert best["LiftProjectBlock_0.CNOBlock_0.Conv_0.weight"].shape == (64, 7, 3, 3)
    assert "ResidualBlock_8.FILM_1.GroupNorm_0.scale" in best  # 3 encoder + 6 neck blocks
    main(["evaluate", "--model", "cno", "--data", str(data), "--ckpt", str(ckpt / "best.pt"),
          "--patterns", "[1]", "--batch-size", "4", "--device", "cpu"])
    res = _lines(capsys)[1]
    assert all(np.isfinite(v) for v in res["patterns"]["[1]"].values())
    main(["finetune", "--pretrained", str(ckpt / "best.pt"), "--base-in-size", "32", "--data",
          str(data), "--epochs", "1", "--batch-size", "4", "--ckpt", str(ft_ckpt),
          "--device", "cpu"])
    lines = _lines(capsys)
    tiers = lines[0]["tier_parameters"]
    assert tiers["adapter"] == 0 and tiers["norm"] > 0 and tiers["base"] > tiers["norm"]
    assert lines[1]["epoch"] == 0 and np.isfinite(lines[1]["train_loss"])
    assert lines[-1] == {"best_mean_val_rel_%": lines[1]["mean_val_rel_%"]}
    tuned = torch.load(ft_ckpt / "best.pt", weights_only=True)
    assert set(tuned) == {f"base.{k}" for k in best}
    base = ["finetune", "--pretrained", str(ckpt / "best.pt"), "--data", str(data),
            "--device", "cpu"]
    for extra, match in ((["--dataset", "eul_kh"], "Queue 1, item 4.5"),
                         (["--num-trajectories", "2"], "Queue 1, item 4.5"),
                         (["--data-dir", str(tmp_path)], "Queue 1, item 4.5"),
                         (["--data", "eul_kh:/nowhere"], "Queue 1, item 4.5"),
                         (["--pretrained", str(tmp_path)], "orbax"),
                         (["--pretrained", str(tmp_path / "none.pt")], "no checkpoint"),
                         (["--model", "unet"], "unknown model")):
        with pytest.raises(SystemExit, match=match):
            main(base + extra)
    with pytest.raises(SystemExit, match="finetune"):
        main(["train", "--model", "cno", "--data", str(data), "--lr-embedding", "1e-4",
              "--device", "cpu"])
