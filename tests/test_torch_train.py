"""Port parity: the scOT training slice — the optimizer against optax on
identical gradient trees, the tier labels, a short ``Trainer.fit`` against
the JAX ``Trainer``, the loader's batches, the ``train``/``mix-sweep`` CLI on
the CPU, and the law of drop-path.

Weights and data are seeded numpy arrays handed to both packages; the JAX
weights are carried across with ``state_dict_from_flax``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pregen_pde_tpu.models import scot as jscot
from pregen_pde_tpu.parallel.meshes import make_mesh
from pregen_pde_tpu.training import datasets as jds
from pregen_pde_tpu.training import losses as jlosses
from pregen_pde_tpu.training import tiers as jtiers
from pregen_pde_tpu.training import trainer as jtrainer
from pregen_pde_tpu.training.native_loader import make_batch_loader
from pregen_pde_tpu_torch.__main__ import main
from pregen_pde_tpu_torch.models import scot as tscot
from pregen_pde_tpu_torch.models.convert import state_dict_from_flax
from pregen_pde_tpu_torch.training import datasets as tds
from pregen_pde_tpu_torch.training import losses as tlosses
from pregen_pde_tpu_torch.training import tiers as ttiers
from pregen_pde_tpu_torch.training import trainer as ttrainer
from pregen_pde_tpu_torch.training.optim import build_optimizer

from test_torch_scot import KW, _flax_params
from torch_threads import _one_torch_thread  # noqa: F401 (autouse)

SCHEDULES = {"cosine": ("cosine", 0.0), "warmup-cosine": ("cosine", 0.4),
             "step": ("step", 0.0), "constant": ("constant", 0.0)}
TIERS = {"standard": 1e-3, "no_weight_decay": 2e-3, "embeddings": 3e-3, "time_embedding": 4e-3}
# the global gradient norm of each of the five steps: the third exceeds the
# 5.0 clip
GRAD_NORMS = (1.0, 3.0, 20.0, 0.5, 4.0)
# the small config of tests/test_torch_scot.py cut to one layer a stage (it
# keeps a parameter of every tier, and halves the JAX compile times)
TINY = dict(KW, depths=(1, 1), drop_path_rate=0.0)


def _small_params(seed=0):
    jm = jscot.ScOT(jscot.ScOTConfig(**TINY))
    return jm, _flax_params(jm, jnp.zeros((1, 16, 16, 7)), jnp.ones((1,)), seed=seed)


# a parameter tree with scOT's names and ranks, holding a member of every
# tier and each quirk (the time-scale kernel in "standard", the CPB-MLP
# kernels in "no_weight_decay", the embedding biases decayed); scOT-T's
# whole tree is labelled in the next test
TREE = {
    "patch_embed": {"kernel": (2, 2, 7, 8), "bias": (8,)},
    "embed_norm": {"time_scale": {"kernel": (1, 8), "bias": (8,)},
                   "time_bias": {"kernel": (1, 8), "bias": (8,)}},
    "enc_0_blk_0": {
        "attention": {"query": {"kernel": (8, 8), "bias": (8,)}, "key": {"kernel": (8, 8)},
                      "logit_scale": (2, 1, 1), "cpb_mlp1": {"kernel": (2, 16), "bias": (16,)},
                      "cpb_mlp2": {"kernel": (16, 2)}},
        "norm1": {"time_scale": {"kernel": (1, 8), "bias": (8,)},
                  "time_bias": {"kernel": (1, 8), "bias": (8,)}},
        "mlp1": {"kernel": (8, 32), "bias": (32,)}},
    "skip_0_blk_0": {"layer_scale": (8,), "dwconv": {"kernel": (7, 7, 1, 8), "bias": (8,)}},
    "patch_recovery": {"kernel": (2, 2, 8, 3), "bias": (3,)},
}


@pytest.mark.parametrize("tiered", [False, True], ids=["one-tier", "four-tiers"])
@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_optimizer_matches_optax(schedule, tiered):
    """Five steps of the port's optimizer and of ``build_optimizer``'s optax
    chain (global-norm clip at 5.0, AdamW, weight decay 0.1 so that decay
    counts, 2 epochs × 3 steps) on identical random gradient trees, one of
    which is clipped: the parameters agree at rtol 1e-6."""
    kind, warmup = SCHEDULES[schedule]
    kw = dict(learning_rate=1e-3, weight_decay=0.1, epochs=2, schedule=kind, warmup_frac=warmup,
              lr_tiers=TIERS if tiered else None)
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(lambda s: rng.normal(size=s).astype(np.float32), TREE,
                                    is_leaf=lambda x: isinstance(x, tuple))
    tier = dict(tier_fn=jtiers.scot_main_tier_fn, tier_decay=jtiers.SCOT_TIER_DECAY) if tiered \
        else {}
    tx = jtrainer.build_optimizer(jtrainer.TrainerConfig(**kw), 3, params, **tier)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    state = tx.init(jparams)

    named = {k: torch.nn.Parameter(v.clone()) for k, v in state_dict_from_flax(params).items()}
    tier = dict(tier_fn=ttiers.scot_tier_of, tier_decay=ttiers.SCOT_TIER_DECAY) if tiered else {}
    opt = build_optimizer(ttrainer.TrainerConfig(**kw), 3, named.items(), **tier)
    assert len(opt.groups) == (4 if tiered else 1)

    leaves, treedef = jax.tree_util.tree_flatten(params)
    for norm in GRAD_NORMS:
        g = [rng.normal(size=leaf.shape).astype(np.float32) for leaf in leaves]
        scale = norm / np.sqrt(sum(float((x.astype(np.float64) ** 2).sum()) for x in g))
        grads = jax.tree_util.tree_unflatten(treedef, [(x * scale).astype(np.float32) for x in g])
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for name, gr in state_dict_from_flax(grads).items():
            named[name].grad = gr.clone()
        opt.step()
    ref = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, jparams))
    for name, p in named.items():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(), rtol=1e-6, atol=1e-9,
                                   err_msg=name)


def test_tier_labels_and_decay_match_jax_scot_t():
    """scOT-T's whole parameter set: the port's tier of each parameter is
    ``scot_main_tier_fn`` of its flax path, and the decay membership of the
    tiered and of the single-tier ("matrix") optimizer agrees with the JAX
    semantics leaf by leaf (the leaves' ranks agree)."""
    cfg = dict(tscot.MODEL_SIZES["T"], num_channels=7, num_out_channels=3)
    jm = jscot.ScOT(jscot.ScOTConfig(**cfg))
    shapes = jax.eval_shape(lambda k: jm.init(k, jnp.zeros((1, 128, 128, 7)), jnp.ones((1,)))[
        "params"], jax.random.key(0))
    flat = {"/".join(getattr(k, "key", str(k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)}
    labels = {"/".join(getattr(k, "key", str(k)) for k in path): lab
              for path, lab in jax.tree_util.tree_leaves_with_path(
                  jtrainer._label_params(shapes, jtiers.scot_main_tier_fn))}
    with torch.device("meta"):
        model = tscot.ScOT(tscot.ScOTConfig(**cfg))
    got = {"/".join(ttiers.flax_path(n)): ttiers.scot_tier_of(n) for n, _ in model.named_parameters()}
    assert got == labels and len(got) == len(flat)
    assert set(got.values()) == set(jtiers.SCOT_TIER_DECAY)
    params = dict(model.named_parameters())
    for name, p in params.items():
        assert p.ndim == len(flat["/".join(ttiers.flax_path(name))].shape), name
    tiered = build_optimizer(ttrainer.TrainerConfig(lr_tiers=TIERS), 1, params.items(),
                             ttiers.scot_tier_of, ttiers.SCOT_TIER_DECAY)
    single = build_optimizer(ttrainer.TrainerConfig(), 1, params.items())
    for opt, want in ((tiered, lambda path: jtiers.SCOT_TIER_DECAY[labels[path]] == "all"),
                      (single, lambda path: flat[path].ndim >= 2)):
        by_param = {id(p): d for g in opt.groups for p, d in zip(g["params"], g["decay"])}
        for name, p in params.items():
            path = "/".join(ttiers.flax_path(name))
            assert by_param[id(p)] == want(path), name


@pytest.mark.parametrize("loss", ["relative_l1", "relative_l2", "grouped", "masked_mse"])
def test_losses_match_jax(loss):
    """The three losses on the same float32 arrays, at rtol 1e-6."""
    rng = np.random.default_rng(8)
    pred, target = (rng.normal(size=(3, 8, 8, 3)).astype(np.float32) for _ in range(2))
    valid = (rng.uniform(size=(3, 8, 8, 1)) > 0.3).astype(np.float32)
    call = {"relative_l1": lambda m, *a: m.relative_lp_loss(*a, p=1),
            "relative_l2": lambda m, *a: m.relative_lp_loss(*a, p=2, reduce_batch=False),
            "grouped": lambda m, *a: m.grouped_relative_lp_loss(*a, [[0, 1], [2]]),
            "masked_mse": lambda m, *a: m.masked_mse(*a, valid if m is jlosses
                                                     else torch.from_numpy(valid))}[loss]
    ref = np.asarray(call(jlosses, jnp.asarray(pred), jnp.asarray(target)))
    got = call(tlosses, torch.from_numpy(pred), torch.from_numpy(target)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def _contract(n=10, t=5, s=16, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n, t, s, s, 6)).astype(np.float32)
    data[..., 3:] = rng.uniform(0, 1, size=(n, 1, s, s, 3)).astype(np.float32)
    return data


def _splits(mod, data):
    cfg = mod.TimePairConfig(max_num_time_steps=data.shape[1] - 1, allowed_transitions=[1],
                             n_val=2, n_test=2)
    train = mod.TimePairDataset(data, cfg, "train")
    return train, mod.TimePairDataset(data, cfg, "val", mean=train.mean, std=train.std)


def test_fit_matches_jax_trainer(tmp_path):
    """Two epochs on a (10, 5, 16², 6) contract, batch 4, the same weights
    (drop-path 0): the per-epoch train loss and mean val error against the
    JAX ``Trainer`` at rtol 1e-4; ``restore_best`` brings back the best
    epoch's parameters, which ``best.pt`` holds."""
    data = _contract()
    kw = dict(learning_rate=1e-3, epochs=2, batch_size=4)
    jm, params = _small_params(seed=3)
    jtrain, jval = _splits(jds, data)
    jloader = jds.BatchLoader(jtrain, 4, seed=0)
    jt = jtrainer.Trainer(jm, jtrainer.TrainerConfig(**kw), mesh=make_mesh(devices=jax.devices()[:1]))
    jt.init_state(next(iter(jloader)), steps_per_epoch=len(jloader))
    jt.replace_params(jax.tree_util.tree_map(jnp.asarray, params))
    ref = jt.fit(jloader, {"val": jds.BatchLoader(jval, 4, shuffle=False)})["history"]

    model = tscot.ScOT(tscot.ScOTConfig(**TINY))
    model.load_state_dict(state_dict_from_flax(params))
    ttrain, tval = _splits(tds, data)
    tloader = tds.BatchLoader(ttrain, 4, seed=0)
    tt = ttrainer.Trainer(model, ttrainer.TrainerConfig(**kw, ckpt_dir=str(tmp_path)), device="cpu")
    tt.init_state(next(iter(tloader)), steps_per_epoch=len(tloader))
    snaps = []
    got = tt.fit(tloader, {"val": tds.BatchLoader(tval, 4, shuffle=False)},
                 log_fn=lambda rec: snaps.append({k: v.clone() for k, v in
                                                  model.state_dict().items()}))["history"]
    assert [r["epoch"] for r in got] == [r["epoch"] for r in ref] == [0, 1]
    for key in ("train_loss", "val_mean_rel_%", "val_median_rel_%", "mean_val_rel_%"):
        np.testing.assert_allclose([r[key] for r in got], [r[key] for r in ref], rtol=1e-4,
                                   err_msg=key)
    best = int(np.argmin([r["mean_val_rel_%"] for r in got]))
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    tt.restore_best()
    saved = torch.load(tmp_path / ttrainer.CKPT_NAME, weights_only=True)
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, snaps[best][k], rtol=0, atol=0)
        torch.testing.assert_close(saved[k], snaps[best][k], rtol=0, atol=0)


def test_batch_loader_order_matches_jax_loader():
    """Two epochs of the port's ``BatchLoader(seed=0)`` against the JAX CLI's
    loader (``make_batch_loader(seed=0)``: the native loader where it
    builds, else the plain one) on the same shard: the same number of
    batches, each the same multiset of samples."""
    data = _contract(seed=4)
    jtrain, _ = _splits(jds, data)
    ttrain, _ = _splits(tds, data)
    jl, tl = make_batch_loader(jtrain, 4, seed=0), tds.BatchLoader(ttrain, 4, seed=0)
    assert len(jl) == len(tl) == len(ttrain) // 4
    key = lambda b: np.argsort(b["input"][:, 0, 0, 0])
    for _ in range(2):
        batches = list(zip(jl, tl))
        assert len(batches) == len(tl)
        for jb, tb in batches:
            for k in ("time", "input", "label"):
                np.testing.assert_allclose(tb[k][key(tb)], jb[k][key(jb)], rtol=1e-6, atol=1e-6)


def _cli_lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]


def test_cli_train_evaluate_mix_sweep_cpu(tmp_path, capsys):
    """``train --model scot --device cpu --ckpt`` on a (8, 3, 32², 6) shard
    (scot = scot-T, whose grid halves three times: 32² is its smallest)
    prints the launch line, one record per epoch and the best value, and
    writes ``best.pt``; ``--resume`` loads it; ``evaluate --ckpt best.pt``
    reads it; ``mix-sweep``
    prints its α line; the parts of the JAX CLI not ported raise."""
    hard, easy = tmp_path / "h.npy", tmp_path / "e.npy"
    np.save(hard, _contract(n=8, t=3, s=32, seed=5))
    np.save(easy, _contract(n=8, t=3, s=32, seed=6))
    ckpt = tmp_path / "ck"
    base = ["train", "--model", "scot", "--data", str(hard), "--batch-size", "4", "--device", "cpu"]
    main(base + ["--epochs", "1", "--ckpt", str(ckpt)])
    lines = _cli_lines(capsys)
    assert lines[0] == {"kernel_launches": {"swin_block": 0, "swin_block_bwd": 0,
                                            "window_attention": 0, "window_attention_bwd": 0,
                                            "adamw": 0}}
    assert lines[1]["epoch"] == 0 and np.isfinite(lines[1]["train_loss"])
    assert lines[2] == {"best_mean_val_rel_%": lines[1]["mean_val_rel_%"]}
    assert (ckpt / "best.pt").is_file()
    main(base + ["--epochs", "1", "--ckpt", str(ckpt), "--resume"])
    lines = _cli_lines(capsys)
    assert lines[0] == {"resumed_from": str(ckpt), "ckpt_file": str(ckpt / "best.pt")}
    assert lines[2]["epoch"] == 0  # parameters only: the epochs restart
    main(["evaluate", "--model", "scot", "--data", str(hard), "--ckpt", str(ckpt / "best.pt"),
          "--device", "cpu", "--patterns", "[2];[1,1]"])
    res = _cli_lines(capsys)[1]
    assert list(res["patterns"]) == ["[2]", "[1, 1]"]
    assert all(np.isfinite(v) for r in res["patterns"].values() for v in r.values())
    main(["mix-sweep", "--model", "scot", "--hard", str(hard), "--easy", str(easy), "--alphas",
          "0.5", "--total-trajectories", "4", "--epochs", "1", "--batch-size", "4", "--device",
          "cpu"])
    lines = _cli_lines(capsys)
    assert lines[0]["alpha"] == 0.5 and set(lines[0]) == {"alpha", "test_hard", "test_easy"}
    assert list(lines[-1]) == ["0.5"]
    assert np.isfinite(lines[-1]["0.5"]["test_hard"]["mean_rel_%"])
    for extra, match in ((["--ar-steps", "2"], "AR-rollout"), (["--dataset", "eul_kh"], "benchmark"),
                         (["--compute-dtype", "bfloat16"], "bfloat16"),
                         (["--device-resident"], "device-resident"), (["--remat"], "remat")):
        with pytest.raises(SystemExit, match=match):
            main(base + extra)
    with pytest.raises(SystemExit, match="unknown model"):
        main(["train", "--model", "unet", "--data", str(hard), "--device", "cpu"])
    if not torch.cuda.is_available():  # the default device is the card, never the CPU
        with pytest.raises(RuntimeError, match="cuda"):
            main(base[:-2])


def test_trainer_config_refuses_what_is_not_ported():
    for kw in (dict(compute_dtype="bfloat16"), dict(remat=True), dict(zero_stage=1),
               dict(fused_optimizer=True)):
        with pytest.raises(NotImplementedError, match="not ported"):
            ttrainer.TrainerConfig(**kw)
    assert ttrainer.TrainerConfig(compute_dtype="float32").compute_dtype == "float32"
    jcfg, tcfg = jtrainer.TrainerConfig(), ttrainer.TrainerConfig()
    assert {f: getattr(tcfg, f) for f in jcfg.__dataclass_fields__} == {
        f: getattr(jcfg, f) for f in jcfg.__dataclass_fields__}


def test_drop_path_law():
    """The JAX law, tested as a law (the streams cannot match threefry):
    one Bernoulli(keep) draw per sample, values in {0, 1/keep}, the kept
    fraction within 4σ of keep over 2·10⁴ draws, the same masks from the
    same seed, ones at eval; the fused layer's (B, 2) multipliers draw the
    two residual adds independently, in the plain chain's order."""
    rate, batch = 0.1, 20_000
    keep = 1.0 - rate
    dp = tscot.DropPath(rate).train()
    with pytest.raises(RuntimeError, match="Generator"):
        dp.keep_mask(4, "cpu")
    dp.generator = torch.Generator().manual_seed(5)
    m = dp.keep_mask(batch, "cpu")
    assert set(torch.unique(m).tolist()) <= {0.0, float(np.float32(1.0 / keep))}
    frac = float((m > 0).double().mean())
    assert abs(frac - keep) <= 4 * np.sqrt(keep * rate / batch)
    dp.generator = torch.Generator().manual_seed(5)
    assert torch.equal(dp.keep_mask(batch, "cpu"), m)
    x = torch.randn(batch, 3)
    dp.generator = torch.Generator().manual_seed(5)
    y = dp(x)
    torch.testing.assert_close(y, torch.where(m[:, None] > 0, x / keep, torch.zeros_like(x)),
                               rtol=0, atol=0)
    dp.eval()
    assert torch.equal(dp.keep_mask(7, "cpu"), torch.ones(7)) and dp(x) is x

    model = tscot.ScOT(tscot.ScOTConfig(**KW, drop_path_rate=0.5))
    layer = model.enc_1_blk_1  # the deepest encoder layer: the highest rate
    model.set_dropout_generator(torch.Generator().manual_seed(9))
    model.train()
    pair = torch.stack([layer.drop_path1.keep_mask(batch, "cpu"),
                        layer.drop_path2.keep_mask(batch, "cpu")], dim=1)
    k = 1.0 - layer.drop_path1.rate
    assert set(torch.unique(pair).tolist()) <= {0.0, float(np.float32(1.0 / k))}
    both = float(((pair[:, 0] > 0) & (pair[:, 1] > 0)).double().mean())
    assert abs(both - k * k) <= 4 * np.sqrt(k * k * (1 - k * k) / batch)  # independent draws
