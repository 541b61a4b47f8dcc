"""Port parity: the scOT evaluation slice — ``evaluate_patterns`` and
``accumulation_error`` against the JAX functions on one contract array and
the same weights (loaded through the ``.npz`` checkpoint path), and the
``evaluate`` CLI on the CPU."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from pregen_pde_tpu.evalx.inference import accumulation_error as jax_accumulation_error
from pregen_pde_tpu.evalx.rollout import evaluate_patterns as jax_evaluate_patterns
from pregen_pde_tpu.models import scot as jscot
from pregen_pde_tpu.training import datasets as jds
from pregen_pde_tpu_torch.__main__ import _make_model, main
from pregen_pde_tpu_torch.evalx.inference import accumulation_error
from pregen_pde_tpu_torch.evalx.rollout import evaluate_patterns
from pregen_pde_tpu_torch.models import scot as tscot
from pregen_pde_tpu_torch.models.convert import load_checkpoint, state_dict_from_flax
from pregen_pde_tpu_torch.training import datasets as tds

from test_torch_scot import KW, _flax_params
from torch_threads import _one_torch_thread  # noqa: F401 (autouse)

PATTERNS = [[7], [2, 2, 2, 1], [1] * 7]


def _contract(n=8, t=8, s=16, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n, t, s, s, 6)).astype(np.float32)
    data[..., 3:] = rng.uniform(0, 1, size=(n, 1, s, s, 3)).astype(np.float32)  # static channels
    return data


def _test_split(mod, data):
    cfg = mod.TimePairConfig(max_num_time_steps=data.shape[1] - 1, allowed_transitions=None,
                             n_val=2, n_test=2)
    train = mod.TimePairDataset(data, cfg, "train")
    return mod.TimePairDataset(data, cfg, "test", mean=train.mean, std=train.std)


def _flat_values(tree, prefix=""):
    if isinstance(tree, dict):
        return {k2: v for k, v in tree.items() for k2, v in _flat_values(v, f"{prefix}/{k}").items()}
    if isinstance(tree, list):
        return {k2: v for i, v in enumerate(tree)
                for k2, v in _flat_values(v, f"{prefix}/{i}").items()}
    return {prefix: tree}


def test_slice_matches_jax_evaluate(tmp_path):
    """N = 8, T = 8, 16², 6 channels; reported errors agree at rtol 1e-4 (a
    7-step rollout compounds the models' ~1e-6 roundoff)."""
    data = _contract()
    x0 = np.zeros((2, 16, 16, 7), np.float32)
    jm = jscot.ScOT(jscot.ScOTConfig(**KW))
    params = _flax_params(jm, jnp.asarray(x0), jnp.ones((2,), jnp.float32), seed=11)
    ckpt = tmp_path / "params.npz"
    np.savez(ckpt, **traverse_util.flatten_dict(params, sep="/"))
    model = tscot.ScOT(tscot.ScOTConfig(**KW))
    load_checkpoint(model, ckpt)
    for k, v in state_dict_from_flax(params).items():
        torch.testing.assert_close(model.state_dict()[k], v, rtol=0, atol=0)
    model.eval()

    jtest, ttest = _test_split(jds, data), _test_split(tds, data)
    assert (len(jtest), ttest.start, ttest.n_traj) == (len(ttest), jtest.start, jtest.n_traj)
    apply = jax.jit(jm.apply)
    ref = {"patterns": jax_evaluate_patterns(apply, params, jtest, PATTERNS, batch_size=16),
           "accumulation": jax_accumulation_error(apply, params, jtest, max_steps=7)}
    got = {"patterns": evaluate_patterns(model, ttest, PATTERNS, batch_size=16, device="cpu"),
           "accumulation": accumulation_error(model, ttest, max_steps=7, device="cpu")}
    ref_v, got_v = _flat_values(ref), _flat_values(got)
    assert ref_v.keys() == got_v.keys() and len(got_v) == 3 * 5 + 7 * 3
    for k in ref_v:
        np.testing.assert_allclose(got_v[k], ref_v[k], rtol=1e-4, err_msg=k)


def test_cli_evaluate_cpu(tmp_path, capsys):
    """``evaluate --model scot --device cpu`` on an (8, 8, 32², 6) array
    (scot = scot-T, whose grid halves three times: 32² is its smallest)."""
    data_path = tmp_path / "d.npy"
    np.save(data_path, _contract(s=32, seed=1))
    torch.manual_seed(0)
    ckpt = tmp_path / "w.pt"
    torch.save(_make_model("scot", 32).state_dict(), ckpt)
    main(["evaluate", "--model", "scot", "--data", str(data_path), "--ckpt", str(ckpt),
          "--device", "cpu", "--label-description", "[Ux,Uy],[p]"])
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    assert lines[0] == {"kernel_launches": {"swin_block": 0, "window_attention": 0}}
    res = lines[1]
    assert list(res["patterns"]) == ["[7]", "[2, 2, 2, 1]", "[1, 1, 1, 1, 1, 1, 1]"]
    assert all(list(r) == ["UxUy", "p", "all"] for r in res["patterns"].values())
    assert [a["step"] for a in res["accumulation"]] == list(range(1, 8))
    assert all(np.isfinite(v) for v in _flat_values(res).values())
    for extra, match in ((["--ar-steps", "2"], "not ported"), (["--dataset", "eul_kh"], "not ported"),
                         (["--ckpt", str(tmp_path)], "orbax")):
        argv = ["evaluate", "--model", "scot", "--data", str(data_path), "--ckpt", str(ckpt),
                "--device", "cpu", *extra]
        with pytest.raises(SystemExit, match=match):
            main(argv)
    with pytest.raises(SystemExit, match="unknown model"):
        main(["evaluate", "--model", "unet", "--data", str(data_path), "--ckpt", str(ckpt),
              "--device", "cpu"])
    if not torch.cuda.is_available():  # the default device is the card, never the CPU
        with pytest.raises(RuntimeError, match="cuda"):
            main(["evaluate", "--model", "scot", "--data", str(data_path), "--ckpt", str(ckpt)])
