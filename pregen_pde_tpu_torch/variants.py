"""Design choices of the K5b, K4 and K5a kernels, timed against the
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
  its products; the variant ``bwd_bias_col_stride`` reads the bias through
  a column stride (1 here) as it did before the wrapper gave it contiguous
  rows. At ``chip_smoke.py`` phase 17's stage-0 inputs and at n = 64:
  device time of a call (``torch.profiler``), and each cotangent's
  relative L2 against the plain version as a multiple of the plain float32
  version's own error against float64.
- K4's wide forward forms S on the CUDA cores in float32 at hd <= 32; the
  variant ``fwd_tf32_scores`` forms it on the tensor cores in 3xTF32, as
  at hd = 64. At ``chip_smoke.py`` phase 13's stage-0 and n = 64 inputs,
  in the model's layout: device time, out's and the log-sum-exp's relative
  L2 against the plain version as a multiple of the floor, and the wide
  backward's cotangents, run from that forward's out and log-sum-exp, as
  fractions of ``chip_smoke.K4_BWD_VS_PLAIN_BARS`` over seeds 3-6.
- K4's forward wrapper packs its 28 arguments behind one pointer; the
  variant ``fwd_typed_args`` adds an entry point that takes them as 28
  typed ctypes arguments. At ``evaluate``'s stage 3 (nb 3, 24 heads, n 16,
  hd 32) in the model's layout: the host µs of the argument passing and
  launch alone, each way, in turns, and the whole wrapper's host µs
  (packed); the wrapper's with typed arguments is that, less the packed
  launch, plus the typed one.
- K5a's row route streams bands of 2 rows a warp at 128²; the variants
  ``k5a_band4`` and ``k5a_band8`` stream 4 and 8 (fewer halo reads, fewer
  warps). µs a call at B = 1, 8, 32 by CUDA graph replay, in turns.

Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
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
    "fwd_tf32_scores": ("window_attention", (
        ("  auto kern = attn_fwd_wide_kernel<HD, HD <= 32>;",
         "  auto kern = attn_fwd_wide_kernel<HD, false>;"),)),
    "fwd_typed_args": ("window_attention", (
        ('}  // extern "C"',
         "int window_attention_fwd_typed("
         + ", ".join(f"long long a{i}" for i in range(28)) + ") {\n"
         + "  const long long p[28] = {" + ", ".join(f"a{i}" for i in range(28)) + "};\n"
         + "  return window_attention_fwd(p);\n}\n\n}  // extern \"C\""),)),
    "bwd_bias_col_stride": ("window_attention", (
        ("__ldg(bmat + qi * B.si + kj)", "__ldg(bmat + qi * B.si + kj * B.sj)"),
        ("__ldg((top ? b0row : b1row) + cc)", "__ldg((top ? b0row : b1row) + cc * B.sj)"))),
    "k5a_band4": ("stencil", (("constexpr int kLapBand = 2;", "constexpr int kLapBand = 4;"),)),
    "k5a_band8": ("stencil", (("constexpr int kLapBand = 2;", "constexpr int kLapBand = 8;"),)),
}


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
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        futs = {k: pool.submit(build.build_variant, lib, subs, k)
                for k, (lib, subs) in VARIANTS.items()}
        sos = {k: str(f.result()) for k, f in futs.items()}
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

    # K5a's row route: bands of 2 rows a warp against 4 and 8, in turns
    for name in ("kernel", "k5a_band4", "k5a_band8", "k5a_band8", "k5a_band4", "kernel"):
        _use(st, sos.get(name))
        row = {str(B): cs.graph_ms(lambda ub=u0[:B].contiguous(): st.laplacian_cuda(ub, dx)) * 1e3
               for B in (1, 8, 32)}
        res.setdefault(f"k5a_us_{name}", []).append(row)
        print(f"K5a, {name}: us a call at 128^2, B = 1, 8, 32 (CUDA graph replay) "
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
        for name, so in (("kernel", None), ("tf32_scores", sos["tf32_scores"]),
                         ("bwd_bias_col_stride", sos["bwd_bias_col_stride"])):
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

    # K4's wide forward: float32 scores against 3xTF32 scores, in the model's
    # layout; the backward run from each forward's out and lse, over seeds
    for label, nb, h, n, hd, nw in cs.K4_FWD_CASES[:3]:
        for seed in (3, 4, 5, 6):
            q, k, v, bias = cs.k4_model_inputs(torch.Generator(device=dev).manual_seed(seed),
                                               nb, h, n, hd, nw)
            do = torch.randn(q.shape, device=dev,
                             generator=torch.Generator(device=dev).manual_seed(100 + seed))
            with torch.inference_mode():
                ref = wa.window_attention_lse_plain(q, k, v, bias)
                ref64 = wa.window_attention_lse_plain(*(t.double() for t in (q, k, v, bias)))
                floors = [rel_l2(a, b) for a, b in zip(ref, ref64)]
                bref = wa.window_attention_bwd_plain(q, k, v, bias, do)
                for name, so in (("kernel", None), ("fwd_tf32_scores", sos["fwd_tf32_scores"])):
                    _use(wa, so)
                    got = wa._forward_kernel(q, k, v, bias, save=True)
                    ratio = {m: rel_l2(a, b) / f
                             for m, a, b, f in zip(("out", "lse"), got, ref, floors)}
                    bwd = {m: rel_l2(a, b) / cs.K4_BWD_VS_PLAIN_BARS[m]
                           for m, a, b in zip(("dq", "dk", "dv", "dbias"),
                                              wa._backward_kernel(q, k, v, bias, *got, do),
                                              bref)}
                    rec = {"err_over_floor": ratio, "bwd_of_bar": bwd}
                    if seed == 3:
                        rec["device_ms"] = cs.device_ms(
                            lambda: wa.window_attention(q, k, v, bias), 20)
                    res[f"k4_fwd_{label}_seed{seed}_{name}"] = rec
                    ms = f"device {rec['device_ms']:.4f} ms; " if seed == 3 else ""
                    print(f"K4 wide forward {label}, seed {seed}, {name}: {ms}rel L2 vs plain "
                          f"over the floor {json.dumps({m: round(r, 2) for m, r in ratio.items()})}"
                          f"; the backward from it, of its bars "
                          f"{json.dumps({m: round(r, 2) for m, r in bwd.items()})} | {card}",
                          flush=True)
    _use(wa, None)

    # K4's forward wrapper at stage 3: packed against typed arguments
    q, k, v, bias = cs.k4_model_inputs(torch.Generator(device=dev).manual_seed(3), 3, 24, 16,
                                       32, 1)
    with torch.inference_mode():
        wrapper = min(cs.host_us(lambda: wa.window_attention(q, k, v, bias)) for _ in range(3))
        out = wa._forward_kernel(q, k, v, bias)[0]  # the thread's buffer holds its arguments
        fargs = wa._FWD_ARGS.unpack_from(wa._bufs.fwd)
        lib = ctypes.CDLL(sos["fwd_typed_args"])
        packed, typed = lib.window_attention_fwd, lib.window_attention_fwd_typed
        packed.argtypes = [ctypes.c_void_p]
        typed.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 22
        packed.restype = typed.restype = ctypes.c_int
        buf = (ctypes.c_longlong * 28)()
        addr = ctypes.addressof(buf)
        calls = {"packed": lambda: (wa._FWD_ARGS.pack_into(buf, 0, *fargs), packed(addr)),
                 "typed": lambda: typed(*fargs)}
        us = {}
        for name in ("packed", "typed", "typed", "packed"):
            us.setdefault(name, []).append(cs.host_us(calls[name]))
        assert torch.equal(out, wa.window_attention(q, k, v, bias))
    us = {m: min(x) for m, x in us.items()}
    res["k4_fwd_args_host_us"] = {"wrapper_packed": wrapper, "launch_packed": us["packed"],
                                  "launch_typed": us["typed"],
                                  "wrapper_typed": wrapper - us["packed"] + us["typed"]}
    print(f"K4 forward wrapper at stage 3, B = 3, host us a call: packed {wrapper:.2f} "
          f"(its argument passing and launch {us['packed']:.2f}); typed "
          f"{wrapper - us['packed'] + us['typed']:.2f} (its {us['typed']:.2f}) | {card}",
          flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
