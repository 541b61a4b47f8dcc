"""Two design choices of the K5b and K4-backward kernels, timed against the
variants they rejected, each built by substitutions into the checkout's
git-ignored ``_build/`` (never into ``csrc/``):

    python pregen_pde_tpu_torch/variants.py [--json out.json]

- K5b's resident trajectory (``csrc/stencil.cu``) at one block an image
  waits at ``__syncthreads``; the variant ``cluster_barrier`` waits at the
  cluster barrier (arrive, then wait) as clusters of 2-8 blocks do. µs a
  step at 128², B = 1, 8 and 32: the difference of a 1500- and a 500-step
  call, by CUDA events.
- K4's wide backward (``csrc/window_attention.cu``, n > 32) forms the
  scores S and dP on the CUDA cores in float32; the variant
  ``tf32_scores`` forms them on the tensor cores in 3xTF32, as it forms
  its products. At ``chip_smoke.py`` phase 17's stage-0 inputs and at
  n = 64: device time of a call (``torch.profiler``), and each cotangent's
  relative L2 against the plain version as a multiple of the plain float32
  version's own error against float64.

Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = {
    "cluster_barrier": ("stencil", (
        ("  if constexpr (CS > 1) asm volatile(\"barrier.cluster.arrive",
         "  if constexpr (true) asm volatile(\"barrier.cluster.arrive"),
        ("  if constexpr (CS > 1) asm volatile(\"barrier.cluster.wait",
         "  if constexpr (true) asm volatile(\"barrier.cluster.wait"),
        ("  cfg.numAttrs = CS > 1 ? 1 : 0;", "  cfg.numAttrs = 1;"))),
    "tf32_scores": ("window_attention", (
        ("  auto kern = attn_bwd_wide_kernel<HD, HD <= 32>;",
         "  auto kern = attn_bwd_wide_kernel<HD, false>;"),)),
}


def _variant(name: str, nvcc: str, flags) -> str:
    """Build csrc/<lib>.cu with the variant's substitutions → .so path."""
    lib, subs = VARIANTS[name]
    csrc = os.path.join(HERE, "pregen_pde_tpu_torch", "csrc")
    src = open(os.path.join(csrc, f"{lib}.cu")).read()
    for old, new in subs:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} is not in {lib}.cu exactly once")
        src = src.replace(old, new)
    out = os.path.join(HERE, "pregen_pde_tpu_torch", "_build", "variants", name)
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, f"{lib}.cu")
    with open(path, "w") as f:
        f.write(src)
    so = os.path.join(out, "lib.so")
    subprocess.run([nvcc, *flags, "-I", csrc, "-o", so, path], check=True, capture_output=True)
    return so


def _use(module, so: str | None) -> None:
    """Point ``module``'s wrappers at the library ``so`` (None: its own)."""
    from pregen_pde_tpu_torch.kernels import build

    build._loaded[module.LIB_NAME] = (ctypes.CDLL(so) if so else
                                      ctypes.CDLL(str(build.build(module.LIB_NAME))))
    module._typed.clear()


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="variants")
    p.add_argument("--json", help="also write the result here")
    args = p.parse_args(argv)
    sys.path.insert(0, HERE)
    import importlib.util

    import torch
    import torch.nn.functional as F

    spec = importlib.util.spec_from_file_location("smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from pregen_pde_tpu_torch.core import SpectralGrid2D
    from pregen_pde_tpu_torch.fields.grf import grf_2d
    from pregen_pde_tpu_torch.kernels import build
    from pregen_pde_tpu_torch.models.scot import shift_attn_mask
    from pregen_pde_tpu_torch.ops import stencil as st
    from pregen_pde_tpu_torch.ops import window_attention as wa
    from pregen_pde_tpu_torch.profile_scot import event_ms
    from pregen_pde_tpu_torch.utils.device import resolve_device
    from pregen_pde_tpu_torch.utils.parity import rel_l2

    dev = resolve_device("cuda:0")
    card = cs.card_line()
    print(card, flush=True)
    nvcc = build.find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        futs = {k: pool.submit(_variant, k, nvcc, build.NVCC_FLAGS) for k in VARIANTS}
        sos = {k: f.result() for k, f in futs.items()}
    res = {"card": card}

    # K5b: one block an image, __syncthreads against the cluster barrier
    u0 = grf_2d(torch.Generator(device=dev).manual_seed(5), SpectralGrid2D(128), 32)
    dx, D, dt = 1.0 / 128, 1e-2, 1e-4
    for name, so in (("kernel", None), ("cluster_barrier", sos["cluster_barrier"])):
        _use(st, so)
        row = {}
        for B in (1, 8, 32):
            ub = u0[:B].contiguous()
            t = {m: event_ms(lambda m=m: st.heat_trajectory(ub, 1, m, dx, D, dt, cluster=1), 3)
                 for m in (500, 1500)}
            row[str(B)] = (t[1500] - t[500]) / 1000 * 1e3
        res[f"k5b_us_a_step_{name}"] = row
        print(f"K5b one block an image, {name}: us a step at B = 1, 8, 32 "
              f"{json.dumps({k: round(v, 4) for k, v in row.items()})} | {card}", flush=True)
    _use(st, None)

    # K4's wide backward: float32 scores against 3xTF32 scores
    gen = torch.Generator(device=dev).manual_seed(4)
    rn = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    mask0 = torch.from_numpy(shift_attn_mask(32, 32, 16, 8)).to(dev)
    for label, nb, h, n, hd, nw in (("stage 0 shifted, B=16", 64, 3, 256, 32, 4),
                                    ("n 64, B=16", 16, 12, 64, 32, 1)):
        q = F.normalize(rn(nb, h, n, hd), dim=-1) * 10.0
        k = F.normalize(rn(nb, h, n, hd), dim=-1)
        v, do = rn(nb, h, n, hd), rn(nb, h, n, hd)
        bias = 16.0 * torch.sigmoid(rn(1, h, n, n))
        bias = bias + mask0[:, None] if nw > 1 else bias
        ref = wa.window_attention_bwd_plain(q, k, v, bias, do)
        ref64 = wa.window_attention_bwd_plain(*(t.double() for t in (q, k, v, bias, do)))
        floors = [rel_l2(a, b) for a, b in zip(ref, ref64)]
        for name, so in (("kernel", None), ("tf32_scores", sos["tf32_scores"])):
            _use(wa, so)
            out, lse = wa._forward_kernel(q, k, v, bias, save=True)
            fn = lambda: wa._backward_kernel(q, k, v, bias, out, lse, do)
            got = fn()
            ratio = {m: rel_l2(a, b) / f
                     for m, a, b, f in zip(("dq", "dk", "dv", "dbias"), got, ref, floors)}
            ms = cs.device_ms(fn, 20)
            res[f"k4_wide_{label}_{name}"] = {"device_ms": ms, "err_over_floor": ratio}
            print(f"K4 wide backward {label}, {name}: device {ms:.4f} ms; rel L2 vs plain over "
                  f"the floor {json.dumps({m: round(r, 2) for m, r in ratio.items()})} | {card}",
                  flush=True)
    _use(wa, None)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
