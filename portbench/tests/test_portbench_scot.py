"""The ``scot_b.train`` cell on the CPU: the real spec, its configuration and
traffic shrunk here (a 32² grid, two layers a stage, window 4, batch 4, an
8-trajectory shard at 32²), through ``run.run_cell``. A sound run is
correct; each fault patched into the port's train step is not. Besides:
the cell's contract, the readers' kernel names against the CUDA sources,
and ``scot_roofline``'s counts by hand and against torch's FLOP counter."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys

import pytest
import torch
from bench_fixture import BENCH, ROOT, cpu_cell
from test_portbench_manifest import cell_contract
from test_portbench_train import (_another_steps_batch, _learning_rate_up, _update_skipped,
                                  _with_optimizer_step)

from portbench import roofline, run, scot_roofline
from portbench.reference import scot as ref
from pregen_pde_tpu_torch.models import scot as tscot
from pregen_pde_tpu_torch.training import trainer as ttrainer

CELL = "scot_b.train"
SEED = 2**31 + 41
SECONDS = 0.5
SMALL_MODEL = {"image_size": 32, "embed_dim": 48, "depths": [2, 2, 2, 2], "window_size": 4}
SMALL_SIZE = {"embed_dim": 48, "depths": (2, 2, 2, 2), "window_size": 4}
REAL_STEP = ttrainer.Trainer.train_step
REAL_INIT = ttrainer.Trainer.__init__


def small_root(tmp) -> object:
    """``tmp`` holding the benchmark's folder with the cell's configuration,
    its shard's configuration and its traffic shrunk."""
    dst = tmp / "portbench"
    for sub in ("drivers", "metrics", "reference", "configs", "traffic"):
        shutil.copytree(BENCH / sub, dst / sub, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")

    def edit(path, **change):
        data = json.loads((dst / path).read_text())
        data.update(change)
        (dst / path).write_text(json.dumps(data))

    edit("configs/scot_b.json", **SMALL_MODEL)
    edit("configs/fpo_multi_hole_128.json", resolution=32, hole_cells=4, max_holes=4)
    edit("traffic/scot_b.train.json", batch_size=4,
         shard={"config": "fpo_multi_hole_128", "trajectories": 8, "time_scale": 0.02})
    return tmp


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return small_root(tmp_path_factory.mktemp("scot_cell"))


@pytest.fixture(autouse=True)
def small_scot_b(monkeypatch):
    """``--model scot-B`` at the shrunk widths (``_make_model`` reads
    ``MODEL_SIZES`` when it is called)."""
    monkeypatch.setitem(tscot.MODEL_SIZES, "B", SMALL_SIZE)


def _run(root, seconds=SECONDS, trace=False):
    return run.run_cell(cpu_cell(CELL, root), SEED, seconds, trace, torch.device("cpu"))


def test_sound_run_is_correct(root):
    result, extra = _run(root)
    assert result["correct"], result["check"]
    assert result["failed"] == 0 and extra["check_info"]["rows_compared"] > 0
    assert set(result["check"]) == {"loss_gap", "grad_gap", "param_gap"}
    assert extra["check_info"]["warmup_grad_gap"] < result["check"]["grad_gap"]["limit"]
    assert extra["counters"]["optimizer_steps"] == extra["batches"]
    assert result["attempted"] == 4 * extra["batches"]
    # the kernels run on a card only
    assert extra["counters"]["k3_launches"] == extra["counters"]["k4_bwd_launches"] == 0


def test_traced_run_reads_the_metrics_a_cpu_can(root):
    """Traced on the CPU: ``train_mfu`` and ``optimizer_share`` read; the
    rooflines find no kernel on a device and read nothing."""
    result, _ = _run(root, trace=True)
    assert result["correct"], result["check"]
    m = result["metrics"]
    assert set(m) == {"train_mfu", "optimizer_share"}
    assert 0.0 < m["optimizer_share"]["value"] < 100.0 and m["train_mfu"]["value"] > 0.0


def test_a_run_loads_no_jax(root):
    """A run of the cell in a fresh process loads no module of JAX or of the
    JAX package."""
    code = f"""
import sys, torch
sys.path[:0] = [{str(ROOT)!r}, {str(BENCH / 'tests')!r}]
from bench_fixture import cpu_cell
from portbench import run
from pregen_pde_tpu_torch.models import scot
scot.MODEL_SIZES["B"] = {SMALL_SIZE!r}
from pathlib import Path
result, _ = run.run_cell(cpu_cell({CELL!r}, Path({str(root)!r})), {SEED}, 0.2, False,
                         torch.device("cpu"))
assert result["correct"], result["check"]
print(run.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


class _ScaleCotangent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return 1.01 * g


def _cotangent_up(self, batch):
    """The input cotangent of the last decoder stage's first Swin layer ×
    1.01: every gradient upstream of it 1% high, the update (nearly
    scale-free under Adam) hardly moved."""
    layer = self.model.dec_0_blk_0
    real = type(layer).forward
    layer.forward = lambda x, time=None: real(layer, _ScaleCotangent.apply(x), time)
    try:
        return REAL_STEP(self, batch)
    finally:
        del layer.forward


def _drop_path_reseeded(self, *args, **kwargs):
    REAL_INIT(self, *args, **kwargs)
    self.generator.manual_seed(self.cfg.seed + 2)


FAULTS = {"update_skipped": ("train_step", _with_optimizer_step(_update_skipped)),
          "learning_rate_x1.01": ("train_step", _with_optimizer_step(_learning_rate_up)),
          "swin_input_cotangent_x1.01": ("train_step", _cotangent_up),
          "another_steps_batch": ("train_step", _another_steps_batch),
          "drop_path_another_seed": ("__init__", _drop_path_reseeded)}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_broken_step_is_not_correct(root, monkeypatch, fault):
    name, patched = FAULTS[fault]
    monkeypatch.setattr(ttrainer.Trainer, name, patched)
    result, extra = _run(root)
    assert not result["correct"], (fault, result["check"])
    assert result["failed"] == 0 and extra["check_info"]["rows_compared"] > 0
    if fault == "swin_input_cotangent_x1.01":
        check = result["check"]["grad_gap"]
        assert check["value"] > check["limit"]


def test_the_cell_meets_the_contract():
    spec = run.load_cell(CELL)
    cell_contract(spec)
    assert spec["driver"] == "scot_train" and spec["traffic"]["batch_size"] == 16
    assert [m["name"] for m in spec["per_layer"]] == ["train_mfu", "k3_roofline", "k4_roofline",
                                                      "optimizer_share"]
    cfg = spec["config"]
    assert len(ref.param_shapes(cfg)) == cfg["parameter_leaves"] == 1580
    assert sum(torch.Size(s).numel() for _, s in ref.param_shapes(cfg)) == cfg["parameters"]


def test_the_k3_gate_is_the_ports():
    """``scot_roofline`` counts a layer as K3's by the port's own gate."""
    from pregen_pde_tpu_torch.ops import swin_block

    assert scot_roofline.MAX_FUSED_DIM == swin_block.MAX_FUSED_DIM


@pytest.mark.parametrize("kernel", ["k3", "k4"])
def test_reader_names_are_the_kernels_of_their_source(kernel):
    """Each name a reader matches is a ``__global__`` of its library, and
    each ``__global__`` there is named."""
    src = {"k3": "swin_block.cu", "k4": "window_attention.cu"}[kernel]
    text = (ROOT / "pregen_pde_tpu_torch" / "csrc" / src).read_text()
    found = {name: bool(template) for template, name in
             re.findall(r"(template <[^>]*>\n)?__global__ void (?:__launch_bounds__\([^)]*\) )?"
                        r"(\w+)\(", text)}
    names = {"k3": scot_roofline.K3_KERNELS, "k4": scot_roofline.K4_KERNELS}[kernel]
    # a template's name in the trace starts with "void " and ends in "<"
    assert {n.split("::")[1].rstrip("<("): n.startswith("void ") and n.endswith("<")
            for n in names} == found
    assert "namespace {" in text
    seen = {"k3": ["void (anonymous namespace)::gemm_kernel<2, 3, false, true, 0>"
                   "((anonymous namespace)::Gemm)",
                   "(anonymous namespace)::reduce_kernel((anonymous namespace)::Reduce)",
                   "(anonymous namespace)::wgrad_kernel((anonymous namespace)::Gemm4)",
                   "(anonymous namespace)::ln_bwd_rows_kernel((anonymous namespace)::Gemm)",
                   "void (anonymous namespace)::attn_fwd_kernel<32>(float const*, float const*, "
                   "float const*, float*, float*, int, int, (anonymous namespace)::Geom)"],
            "k4": ["void (anonymous namespace)::attn_fwd_small_kernel<32, 16>"
                   "((anonymous namespace)::Fwd)",
                   "void (anonymous namespace)::attn_bwd_small_kernel<32, 16>"
                   "((anonymous namespace)::Bwd)"]}[kernel]
    # names as the card's trace printed them (NVIDIA H100 80GB HBM3, torch 2.11)
    assert all(name.startswith(names) for name in seen)
    # no PyTorch or cuBLAS kernel starts in the anonymous namespace with these names
    for lib in ("void at::native::reduce_kernel<128, 4>(at::native::ReduceOp<float>)",
                "void at::native::(anonymous namespace)::reduce_kernel(int)",
                "sm90_xmma_gemm_f32f32_tf32f32_f32_nn_n_tilesize128x128x32",
                "void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm_128x128_16x5_nn_align4>"):
        assert not lib.startswith(names)


def test_k3_and_k4_counts_by_hand():
    """One layer of each stage of scOT-B at B 16, 128²: stages 0-2 are K3's,
    stage 3 K4's; a step makes 48 + 48 K3 calls and 16 + 16 K4 calls."""
    cfg = run.load_cell(CELL)["config"]
    st = ref.stages(cfg)
    hand = {  # M, C, n: (B·g², 96·2^i, min(16, g)²)
        0: 2.0 * 16384 * 96 * (4 * 96 + 2 * 384) + 4.0 * 16384 * 256 * 96,
        1: 2.0 * 4096 * 192 * (4 * 192 + 2 * 768) + 4.0 * 4096 * 256 * 192,
        2: 2.0 * 1024 * 384 * (4 * 384 + 2 * 1536) + 4.0 * 1024 * 64 * 384,
    }
    for i, flop in hand.items():
        x = scot_roofline._stage_shapes(cfg, 16, st[i], 0)
        assert scot_roofline.k3_forward(x)[0] == flop
        assert scot_roofline.k3_backward(x)[0] == 2 * flop + 2.0 * x["M"] * x["n"] * x["C"]
    assert hand[0] / roofline.PEAK_FLOPS == pytest.approx(3.1724e-5, rel=1e-4)  # 0.0317 ms
    x = scot_roofline._stage_shapes(cfg, 16, st[3], 0)
    assert (x["nb"], x["h"], x["n"], x["C"] // x["h"]) == (16, 24, 16, 32)
    assert scot_roofline.k4_forward(x) == (4.0 * 16 * 24 * 16 * 16 * 32,
                                           4.0 * (4 * 16 * 24 * 16 * 32 + 24 * 16 * 16))
    # a shifted stage-0 layer's bias covers its 4 windows
    shifted = scot_roofline._stage_shapes(cfg, 16, st[0], 8)
    assert shifted["bias"] == 4 * 3 * 256 * 256
    calls = scot_roofline.kernel_calls(cfg, 16)
    assert (len(calls["k3"]), len(calls["k4"])) == (96, 32)
    # 18.56 GFLOP a sample forward at B 1 (torch's counter on the plain
    # route); a step at B 16 counts the CPB MLPs once: 0.8786 TFLOP
    assert scot_roofline.forward_flop(cfg, 1) == 18_563_679_744
    assert scot_roofline.train_flop_per_sample(cfg, 16) * 16 == 878_584_061_952


@pytest.mark.parametrize("window", [4, 8])
def test_forward_flop_matches_torch_counter(window):
    """``forward_flop`` against ``torch.utils.flop_counter`` on the port's
    plain route at a small size (the CPB MLPs counted once a forward)."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = {**run.load_cell(CELL)["config"], **SMALL_MODEL, "window_size": window,
           "image_size": 64}
    model = tscot.ScOT(tscot.ScOTConfig(
        image_size=64, num_channels=7, num_out_channels=3, embed_dim=48, depths=(2, 2, 2, 2),
        window_size=window, attention_impl="plain", block_impl="plain")).eval()
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(torch.randn(2, 64, 64, 7), torch.rand(2))
    assert scot_roofline.forward_flop(cfg, 2) == counter.get_total_flops()
