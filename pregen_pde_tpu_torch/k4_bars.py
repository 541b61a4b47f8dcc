"""K4's forward against its per-output bars, with the floors behind them
and two mutants that the bars must catch.

    python pregen_pde_tpu_torch/k4_bars.py [--json out.json]

At ``chip_smoke.py`` phase 13's inputs (its cases and draws, in the model's
layout): the floors of out and of the log-sum-exp (the plain float32
version's relative L2 against float64), and the kernel's relative L2
against the plain float32 version as a fraction of its bar
(``chip_smoke.K4_FWD_VS_PLAIN_BARS``). Then the same for two mutants of
the kernel's source, built into the checkout's git-ignored ``_build/`` and
never written into ``csrc/``: ``bias_next_slot``, the bias read from
window slot (row + 1) % nw instead of row % nw (both forward routes), and
``pv_lo_hi``, the lo×hi product dropped from each k step of the 3xTF32 sum
(``attn_mma.cuh``'s ``mma3s``: every tensor-core product of the wide route,
P·V's among them). The kernel must pass every case and each mutant fail at
least one. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import sys
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MUTANTS = {
    "bias_next_slot": (
        ("    const float* brow = a.bias.at(row % a.nw, head) + ic * a.bias.si;",
         "    const float* brow = a.bias.at((row + 1) % a.nw, head) + ic * a.bias.si;"),
        ("  const float* bm = a.bias.at(row % a.nw, head);",
         "  const float* bm = a.bias.at((row + 1) % a.nw, head);")),
    "pv_lo_hi": (("  mma_tf32(t, a.lo, h0, h1);\n", ""),),
}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="k4_bars")
    p.add_argument("--json", help="also write the result here")
    args = p.parse_args(argv)
    sys.path.insert(0, HERE)
    import torch

    spec = importlib.util.spec_from_file_location("smoke_bars",
                                                  os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from pregen_pde_tpu_torch.kernels import build
    from pregen_pde_tpu_torch.ops import window_attention as wa
    from pregen_pde_tpu_torch.utils.device import resolve_device
    from pregen_pde_tpu_torch.utils.parity import rel_l2

    dev = resolve_device("cuda:0")
    card = cs.card_line()
    print(card, flush=True)
    bars = cs.K4_FWD_VS_PLAIN_BARS
    with ThreadPoolExecutor(len(MUTANTS) + 1) as pool:
        futs = {"kernel": pool.submit(build.build, wa.LIB_NAME)}
        futs.update({name: pool.submit(build.build_variant, wa.LIB_NAME, subs, f"k4_{name}")
                     for name, subs in MUTANTS.items()})
        libs = {tag: str(f.result()) for tag, f in futs.items()}
    g = torch.Generator(device=dev).manual_seed(3)  # phase 13's draws
    res: dict = {"card": card, "bars": bars, "cases": {}}
    fails = {tag: 0 for tag in libs}
    for label, nb, h, n, hd, nw in cs.K4_FWD_CASES:
        q, k, v, bias = cs.k4_model_inputs(g, nb, h, n, hd, nw)
        with torch.inference_mode():
            ref = wa.window_attention_lse_plain(q, k, v, bias)
            f64 = wa.window_attention_lse_plain(*(t.double() for t in (q, k, v, bias)))
            rec = {"floor": {m: rel_l2(a, b) for m, a, b in zip(bars, ref, f64)}}
            for tag, so in libs.items():
                build._loaded[wa.LIB_NAME] = ctypes.CDLL(so)
                wa._typed.clear()
                got = wa._forward_kernel(q, k, v, bias, save=True)
                frac = {m: rel_l2(a, b) / bars[m] for m, a, b in zip(bars, got, ref)}
                over = {m: round(x, 3) for m, x in frac.items() if not x <= 1.0}
                fails[tag] += bool(over)
                rec[tag] = frac
                print(f"{label}: {tag} {'FAILS' if over else 'passes'} (of its bars: "
                      + ", ".join(f"{m} {x:.3g}" for m, x in frac.items())
                      + f"; floors {', '.join(f'{m} {x:.2e}' for m, x in rec['floor'].items())})",
                      flush=True)
        res["cases"][label] = rec
    res["cases_failed"] = fails
    print(json.dumps({"cases": len(cs.K4_FWD_CASES), "cases_failed": fails}), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    if fails["kernel"] or not all(fails[m] for m in MUTANTS):
        raise SystemExit("k4_bars: the kernel failed a case or a mutant passed every case")
    return res


if __name__ == "__main__":
    main()
