"""K3's backward against its per-cotangent bars, with the floors behind
them and two mutants that the bars must catch.

    python pregen_pde_tpu_torch/k3_bars.py [--tree DIR] [--json out.json]

At ``chip_smoke.py`` phase 18's inputs (stages 0 shifted, 1 and 2 at batch
16, stage 0 at batch 3) and at the card test's (``tests/test_torch_cuda.py``
``test_k3_backward_kernel_matches_plain``, its logit scales seeded here):
each of the 19 cotangents' floor, the plain float32 version's relative L2
against float64, and the kernel's relative L2 against the plain float32
version as a fraction of its bar (``chip_smoke.K3_BWD_VS_PLAIN_BARS``). Then the same for two
mutants of the kernel's source, built into the checkout's git-ignored
``_build/`` and never written into ``csrc/``: the GELU constant 0.044715 →
0.04472 in ``gelu_tanh_grad``, and LN2's affine read from the neighbouring
sample. The kernel must pass every case and each mutant fail at least one.
The kernel's cotangents come through the autograd of ``fused_swin_block``,
the JAX-shaped entry, so ``--tree`` may name another checkout of the port
(e.g. a ``git archive`` of an earlier commit): its package and kernel
source are the ones measured, against this checkout's bars. Needs one
CUDA card.
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
GELU = ("(c * (1.f + 3.f * 0.044715f * h * h));", "(c * (1.f + 3.f * 0.04472f * h * h));")
LN2_ROW = (  # LN2's affine weight read from sample b ^ 1, in either kernel's source
    ("    const float* w = p.lnw + (long long)b * N;",
     "    const float* w = p.lnw + (long long)(p.which ? (b ^ 1) : b) * N;"),
    ("  const float* wr = w + (long long)b * C;\n  float* xr = xhat",
     "  const float* wr = w + (long long)(which ? (b ^ 1) : b) * C;\n  float* xr = xhat"),
)


def _mutant(tree: str, name: str, subs, nvcc: str, nvcc_flags) -> str:
    """Build csrc/swin_block.cu of ``tree`` with one substitution → .so path."""
    csrc = os.path.join(tree, "pregen_pde_tpu_torch", "csrc")
    src = open(os.path.join(csrc, "swin_block.cu")).read()
    old, new = next((o, n) for o, n in subs if src.count(o) == 1)
    out = os.path.join(tree, "pregen_pde_tpu_torch", "_build", "k3_bars", name)
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, "swin_block.cu")
    with open(path, "w") as f:
        f.write(src.replace(old, new))
    so = os.path.join(out, "lib.so")
    subprocess.run([nvcc, *nvcc_flags, "-I", csrc, "-o", so, path], check=True,
                   capture_output=True)
    return so


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="k3_bars")
    p.add_argument("--tree", default=HERE, help="the checkout whose kernel is measured")
    p.add_argument("--json", help="also write the result here")
    args = p.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import importlib.util

    import torch

    spec = importlib.util.spec_from_file_location("smoke_bars",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)  # this checkout's bars, whatever the tree measured
    from pregen_pde_tpu_torch.kernels import build
    from pregen_pde_tpu_torch.models.scot import shift_attn_mask
    from pregen_pde_tpu_torch.ops import swin_block as sb
    from pregen_pde_tpu_torch.utils.device import resolve_device
    from pregen_pde_tpu_torch.utils.parity import rel_l2

    dev = resolve_device("cuda:0")
    card = cs.card_line()
    print(f"{card} | measuring {tree}", flush=True)
    bars = cs.K3_BWD_VS_PLAIN_BARS
    nvcc = build.find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    with ThreadPoolExecutor(3) as pool:
        muts = {"gelu": pool.submit(_mutant, tree, "gelu", (GELU,), nvcc, build.NVCC_FLAGS),
                "ln2_row": pool.submit(_mutant, tree, "ln2_row", LN2_ROW, nvcc,
                                       build.NVCC_FLAGS)}
        libs = {"kernel": str(build.build(sb.LIB_NAME))}
        libs.update({k: f.result() for k, f in muts.items()})
    mask0 = torch.from_numpy(shift_attn_mask(32, 32, 16, 8)).to(dev)

    def phase18(B, hw, c, heads, ws, nw):  # chip_smoke.py phase 18's draws
        g = torch.Generator(device=dev).manual_seed(4)
        rk = lambda *shape: torch.randn(*shape, generator=g, device=dev)
        n, hd, f = ws * ws, c // heads, 4 * c
        w = lambda *shape: 0.02 * rk(*shape) * (c ** 0.5)
        bias = 16.0 * torch.sigmoid(rk(1, heads, n, n))
        a = (rk(B, hw, hw, c), bias + mask0[:, None] if nw > 1 else bias,
             1.0 + 9.0 * torch.rand(heads, generator=g, device=dev), w(heads, c, hd),
             w(heads, 1, hd), w(heads, c, hd), w(heads, c, hd), w(heads, 1, hd), w(heads, hd, c),
             w(1, c), 1.0 + w(B, c), w(B, c), w(c, f), w(1, f), w(f, c), w(1, c), 1.0 + w(B, c),
             w(B, c), (torch.rand(B, 2, generator=g, device=dev) > 0.1).float() / 0.9)
        return a, rk(B, hw, hw, c)

    def card_test(B, hw, c, heads, ws, nw):  # the card test's shapes and draws
        g = torch.Generator(device=dev).manual_seed(c + 1)
        rn = lambda *s: 0.1 * torch.randn(*s, generator=g, device=dev)
        n, hd = ws * ws, c // heads
        a = (10 * rn(B, hw, hw, c), 30 * rn(nw, heads, n, n),
             1 + 9 * torch.rand(heads, generator=g, device=dev), rn(heads, c, hd),
             rn(heads, 1, hd), rn(heads, c, hd), rn(heads, c, hd), rn(heads, 1, hd),
             rn(heads, hd, c), rn(1, c), rn(B, c) + 1, rn(B, c), rn(c, 4 * c), rn(1, 4 * c),
             rn(4 * c, c), rn(1, c), rn(B, c) + 1, rn(B, c), 1 + rn(B, 2))
        return a, 10 * rn(B, hw, hw, c)

    cases = [("phase 18, stage 0 shifted, B=16", phase18, (16, 32, 96, 3, 16, 4)),
             ("phase 18, stage 1, B=16", phase18, (16, 16, 192, 6, 16, 1)),
             ("phase 18, stage 2, B=16", phase18, (16, 8, 384, 12, 8, 1)),
             ("phase 18, stage 0 shifted, B=3", phase18, (3, 32, 96, 3, 16, 4)),
             ("card test, stage 0", card_test, (16, 32, 96, 3, 16, 4)),
             ("card test, stage 1", card_test, (16, 16, 192, 6, 16, 1)),
             ("card test, stage 2", card_test, (16, 8, 384, 12, 8, 1)),
             ("card test, tiny", card_test, (2, 8, 16, 2, 4, 4))]
    res: dict = {"card": card, "tree": tree, "bars": bars, "cases": {}}
    fails = {tag: 0 for tag in libs}
    for label, make, shape in cases:
        args_, dy = make(*shape)
        heads, ws = shape[3], shape[4]
        ref = sb.swin_block_bwd_plain(*args_, dy, heads, ws, 1e-5)
        f64 = sb.swin_block_bwd_plain(*[a.double() for a in args_], dy.double(), heads, ws, 1e-5)
        rec = {"floor": {k: rel_l2(a, b) for k, a, b in zip(sb.COTANGENTS, ref, f64)}}
        for tag, lib in libs.items():
            build._loaded[sb.LIB_NAME] = ctypes.CDLL(lib)
            ins = [t.clone().requires_grad_() for t in args_]
            got = torch.autograd.grad(sb.fused_swin_block(*ins, heads, ws, 1e-5), ins, dy)
            frac = {k: rel_l2(a, b) / bars[k] for k, a, b in zip(sb.COTANGENTS, got, ref)}
            over = {k: round(v, 3) for k, v in frac.items() if v > 1.0}
            fails[tag] += bool(over)
            rec[tag] = frac
            worst = max(frac, key=frac.get)
            print(f"{label}: {tag} {'FAILS' if over else 'passes'} (of its bar: worst {worst} "
                  f"{frac[worst]:.3f}; over {json.dumps(over)})", flush=True)
        res["cases"][label] = rec
    res["cases_failed"] = fails
    print(json.dumps({"cases": len(cases), "cases_failed": fails}), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
