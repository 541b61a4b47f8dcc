"""The port's scOT against the benchmark's plain reference
(``portbench/reference/scot.py``, which imports nothing of the port), on
the CPU in float64 (drop-path gradients cancel to ~1e-3 in float32): the
forward, the loss and every parameter's gradient in both lowerings, two
``Trainer.train_step``s against the reference's replay, the reference's
sample assembly against ``TimePairDataset`` and its drop-path draws
against the port's masks.

The model is small but keeps every kind of part: four stages on a 16²
grid with window 4 (stages 0-1 shift every second layer, stage 2's grid
equals its window, stage 3's window is clamped to its 2² grid), ConvNeXt
skips, the time-conditioned norms, drop-path at a rate that drops, and a
stage wider than K3's gate (C 512), so the fused lowering runs K3's and
K4's wrappers (their plain versions on the CPU)."""

import numpy as np
import pytest
import torch

from portbench.reference import scot as ref
from pregen_pde_tpu_torch.models import scot as tscot
from pregen_pde_tpu_torch.training.datasets import BatchLoader, TimePairConfig, TimePairDataset
from pregen_pde_tpu_torch.training.losses import relative_lp_loss
from pregen_pde_tpu_torch.training.trainer import Trainer, TrainerConfig

from torch_threads import _one_torch_thread  # noqa: F401 (autouse)

CFG = dict(image_size=64, patch_size=4, in_channels=7, out_channels=3, embed_dim=64,
           depths=[2, 2, 2, 2], num_heads=[2, 4, 8, 16], window_size=4, mlp_ratio=4.0,
           skip_connections=[2, 2, 2, 0], drop_path_rate=0.4, layer_norm_eps=1e-5,
           learning_rate=1e-3, weight_decay=1e-2, grad_clip=0.05)
B = 2
# float64 on both sides, the same products in another order: ~1e-15 per
# op; the whole model's forward and its gradients through 16 layers
FWD_TOL = 1e-10
GRAD_TOL = 1e-9
# Adam's first steps are near sign(g): a gradient at Adam's eps (1e-8) moves
# an update by up to 1e8 times its own rounding
PARAM_TOL = 1e-9
# the fused lowering's K3 hands back its bias cotangent in float32 (the
# kernel's contract, ``swin_block_bwd_linear_plain``), so the CPB MLPs'
# gradients there are float32-accurate: 6e-8 of the leaf's largest
# measured, and the parameters they move under Adam 6e-9
CPB_LEAF = ".attention.cpb_mlp"
CPB_GRAD_TOL = 1e-6
CPB_PARAM_TOL = 1e-7


@pytest.fixture(autouse=True)
def _float64():
    """float64 as the default dtype, so the drop-path multipliers each side
    draws (``torch.full`` of the keep probability) are float64 too."""
    dtype = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(dtype)


def port_model(impl: str) -> tscot.ScOT:
    return tscot.ScOT(tscot.ScOTConfig(
        image_size=CFG["image_size"], patch_size=CFG["patch_size"],
        num_channels=CFG["in_channels"], num_out_channels=CFG["out_channels"],
        embed_dim=CFG["embed_dim"], depths=tuple(CFG["depths"]),
        num_heads=tuple(CFG["num_heads"]), window_size=CFG["window_size"],
        drop_path_rate=CFG["drop_path_rate"], attention_impl=impl, block_impl=impl))


def weights(seed: int) -> dict:
    """Every leaf drawn (the time maps and biases too, so each path is
    exercised): N(0, 0.05²) around 1 for the time scale's bias, log 10 for
    the logit scales, 0 elsewhere; the layer scales at 0.3 so the skips'
    gradients are not 1e-6 of the rest."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in ref.param_shapes(CFG):
        centre = (1.0 if name.endswith("time_scale.bias") else
                  np.log(10.0) if name.endswith("logit_scale") else
                  0.3 if name.endswith("layer_scale") else 0.0)
        out[name] = torch.from_numpy(centre + 0.05 * rng.normal(size=shape))
    return out


def batch(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    S = CFG["image_size"]
    return {"time": rng.uniform(0.05, 1.0, size=B),
            "input": rng.normal(size=(B, S, S, CFG["in_channels"])),
            "label": rng.normal(size=(B, S, S, CFG["out_channels"]))}


def test_config_shapes_are_the_ports():
    model = port_model("plain")
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == dict(
        ref.param_shapes(CFG))
    layers = ref.swin_layers(CFG)
    assert [n for n, *_ in layers] == [n for n, _ in model.swin_layers()]
    for (name, _, shift, rate), (_, layer) in zip(layers, model.swin_layers()):
        assert (shift, rate) == (layer.shift, layer.drop_path1.rate), name
    assert {s for _, _, s, _ in layers} == {0, 2} and [s["window"] for s in ref.stages(CFG)] == [
        4, 4, 4, 2]


@pytest.mark.parametrize("impl", ["plain", "fused"])
def test_forward_loss_and_gradients_match(impl):
    model = port_model(impl).double()
    model.load_state_dict(weights(1))
    model.train()
    model.set_dropout_generator(torch.Generator().manual_seed(5))
    b = {k: torch.from_numpy(v) for k, v in batch(2).items()}
    pred = model(b["input"], b["time"])
    loss = relative_lp_loss(pred, b["label"], p=1)
    loss.backward()

    p = {n: t.clone().requires_grad_(True) for n, t in weights(1).items()}
    drop = ref.DropPath(torch.Generator().manual_seed(5))
    want = ref.forward(p, CFG, b["input"], b["time"], drop)
    want_loss = ref.relative_l1(want, b["label"])
    want_loss.backward()

    assert len(drop.draws) == 2 * sum(1 for *_, r in ref.swin_layers(CFG) if r > 0)
    assert any((d == 0).any() for d in drop.draws), "no sample was dropped"
    np.testing.assert_allclose(pred.detach().numpy(), want.detach().numpy(), rtol=FWD_TOL,
                               atol=FWD_TOL)
    assert float(loss) == pytest.approx(float(want_loss), rel=FWD_TOL)
    named = dict(model.named_parameters())
    for name, _ in ref.param_shapes(CFG):
        g, w = named[name].grad, p[name].grad
        scale = float(w.abs().max()) or 1.0
        tol = CPB_GRAD_TOL if impl == "fused" and CPB_LEAF in name else GRAD_TOL
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=tol, atol=tol * scale,
                                   err_msg=name)


@pytest.mark.parametrize("impl", ["plain", "fused"])
def test_drop_path_draws_are_the_ports_masks(impl, monkeypatch):
    """The same generator seed gives the same per-sample masks, layer by
    layer in execution order, in the port (either lowering) and the
    reference."""
    masks = []
    real = tscot.DropPath.keep_mask

    def keep_mask(self, batch, device):
        m = real(self, batch, device)
        if self.rate > 0.0 and self.training:
            masks.append(m > 0)
        return m

    monkeypatch.setattr(tscot.DropPath, "keep_mask", keep_mask)
    model = port_model(impl).double()
    model.load_state_dict(weights(3))
    model.train()
    model.set_dropout_generator(torch.Generator().manual_seed(11))
    b = {k: torch.from_numpy(v) for k, v in batch(4).items()}
    with torch.no_grad():
        model(b["input"], b["time"])
        drop = ref.DropPath(torch.Generator().manual_seed(11))
        ref.forward(weights(3), CFG, b["input"], b["time"], drop)
    assert len(masks) == len(drop.draws) == 2 * (2 * sum(CFG["depths"]) - 1)
    for mine, theirs in zip(masks, drop.draws):
        assert torch.equal(mine, theirs > 0)


@pytest.mark.parametrize("impl", ["plain", "fused"])
def test_two_train_steps_match_the_replay(impl):
    """``Trainer.train_step`` twice (the clip acting, the cosine rate over 6
    steps, decay on the matrices) against the reference's replay of the
    same batches: each step's loss, each parameter's gradient norm, and the
    parameters after the second step."""
    model = port_model(impl).double()
    model.load_state_dict(weights(6))
    trainer = Trainer(model, TrainerConfig(learning_rate=CFG["learning_rate"],
                                           weight_decay=CFG["weight_decay"], epochs=2,
                                           batch_size=B, grad_clip=CFG["grad_clip"], seed=0))
    trainer.init_state(steps_per_epoch=3)
    batches = [batch(7), batch(8)]
    names = [n for n, _ in ref.param_shapes(CFG)]
    named = dict(model.named_parameters())
    losses, grads = [], []
    for b in batches:
        losses.append(float(trainer.train_step(b)))
        grads.append([float(torch.linalg.vector_norm(named[n].grad)) for n in names])
    want = ref.replay(CFG, weights(6), batches, total_steps=6, drop_seed=1, dtype=torch.float64)
    assert np.sqrt((want["grad"][0] ** 2).sum()) > CFG["grad_clip"], "the clip did not act"
    np.testing.assert_allclose(losses, want["loss"], rtol=1e-6)  # the loss is float32
    np.testing.assert_allclose(np.array(grads), want["grad"], rtol=1e-6)
    for n in names:
        tol = CPB_PARAM_TOL if impl == "fused" and CPB_LEAF in n else PARAM_TOL
        np.testing.assert_allclose(named[n].detach().numpy(), want["params"][n].numpy(),
                                   rtol=tol, atol=tol, err_msg=n)


def test_sample_assembly_is_time_pair_datasets():
    """The reference's own assembly of a batch (the pair, the z-score over
    the whole shard, the lead-time channel) equals the loader's at the same
    indices, and the shard's statistics equal the dataset's."""
    rng = np.random.default_rng(9)
    shard = (rng.normal(size=(8, 6, 8, 8, 6)) * [2.0, 1.0, 3.0, 1.0, 1.0, 1.0]
             + [1.0, -2.0, 0.5, 0.0, 0.0, 0.0]).astype(np.float32)
    pairs_cfg = TimePairConfig(max_num_time_steps=5, allowed_transitions=[1], n_val=2, n_test=2)
    train = TimePairDataset(shard, pairs_cfg, "train")
    stats = ref.shard_stats(shard)
    assert np.array_equal(stats[0], train.mean) and np.array_equal(stats[1], train.std)
    pairs = ref.time_pairs(shard.shape[1], "one")
    assert pairs == train.time_indices and len(train) == 4 * len(pairs)
    loader = BatchLoader(train, 5, seed=3)
    order = np.arange(len(train))
    np.random.default_rng(3).shuffle(order)
    for k, got in enumerate(loader):
        want = ref.assemble(shard, stats, pairs, order[5 * k:5 * k + 5])
        for key in ("time", "input", "label"):
            assert want[key].dtype == got[key].dtype
            np.testing.assert_array_equal(want[key], got[key], err_msg=key)
    assert k == len(train) // 5 - 1
