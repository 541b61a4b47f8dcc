"""K3 and the scOT-B forward and train step in two checkouts, in turns.

    python -m pregen_pde_tpu_torch.compare_scot PARENT_DIR CHANGE_DIR \
        [--pairs 2] [--json out.json]

Each checkout (e.g. a ``git archive`` of a commit) runs, in fresh
processes of its own: K3's forward (inference mode) and backward (autograd
of one recorded forward, ``retain_graph``) through ``fused_swin_block``,
the JAX-shaped entry both checkouts have, at scOT-B's stages 0 (shifted),
1 and 2 at batch 16 and stage 0 at batch 3, by CUDA events and as the
device time of their kernels (``torch.profiler``; the events include the
host's enqueue where the host is the slower); then
``profile_scot`` (parts 1 and 4: one forward per route, the train step,
their device-busy ms and idle share). ``--pairs`` pairs alternate the order
(parent first, then change first, ...). Prints the card line and one JSON
line with every run's numbers. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

# K3 alone, on the packed operands of the JAX package's signature
K3_TIMING = r"""
import json, torch
from pregen_pde_tpu_torch.models.scot import shift_attn_mask
from pregen_pde_tpu_torch.ops import swin_block as sb
from pregen_pde_tpu_torch.profile_scot import event_ms
from pregen_pde_tpu_torch.utils.device import resolve_device
dev = resolve_device("cuda:0")
gen = torch.Generator(device=dev).manual_seed(4)
rn = lambda *s: torch.randn(*s, generator=gen, device=dev)

def device_ms(fn, reps):  # the kernels' device time a call, apart from the host's enqueue
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ks = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.time_range.end - e.time_range.start for e in ks) / 1e3 / reps

mask = torch.from_numpy(shift_attn_mask(32, 32, 16, 8)).to(dev)
res = {}
for label, B, hw, c, heads, ws, nw in (("stage 0 shifted, B=16", 16, 32, 96, 3, 16, 4),
                                       ("stage 1, B=16", 16, 16, 192, 6, 16, 1),
                                       ("stage 2, B=16", 16, 8, 384, 12, 8, 1),
                                       ("stage 0 shifted, B=3", 3, 32, 96, 3, 16, 4)):
    n, hd, f = ws * ws, c // heads, 4 * c
    w = lambda *s: 0.02 * rn(*s) * (c ** 0.5)
    bias = 16.0 * torch.sigmoid(rn(1, heads, n, n))
    args = (rn(B, hw, hw, c), bias + mask[:, None] if nw > 1 else bias,
            1.0 + 9.0 * torch.rand(heads, generator=gen, device=dev), w(heads, c, hd),
            w(heads, 1, hd), w(heads, c, hd), w(heads, c, hd), w(heads, 1, hd), w(heads, hd, c),
            w(1, c), 1.0 + w(B, c), w(B, c), w(c, f), w(1, f), w(f, c), w(1, c), 1.0 + w(B, c),
            w(B, c), torch.ones(B, 2, device=dev))
    with torch.inference_mode():
        fwd_call = lambda: sb.fused_swin_block(*args, heads, ws, 1e-5)
        fwd = event_ms(fwd_call, 20)
        fwd_dev = device_ms(fwd_call, 20)
    ins = [a.clone().requires_grad_() for a in args]
    y = sb.fused_swin_block(*ins, heads, ws, 1e-5)
    dy = rn(B, hw, hw, c)
    bwd_call = lambda: torch.autograd.grad(y, ins, dy, retain_graph=True)
    res[label] = {"fwd_ms": fwd, "fwd_device_ms": fwd_dev, "bwd_ms": event_ms(bwd_call, 10),
                  "bwd_device_ms": device_ms(bwd_call, 10)}
print("K3 " + json.dumps(res), flush=True)
"""


def _k3(tree: str) -> dict:
    r = subprocess.run([sys.executable, "-c", K3_TIMING], cwd=tree, capture_output=True,
                       text=True, timeout=900)
    lines = [l for l in r.stdout.splitlines() if l.startswith("K3 ")]
    if r.returncode != 0 or not lines:
        raise RuntimeError(f"K3 timing in {tree} rc {r.returncode}:\n{r.stderr[-4000:]}")
    return json.loads(lines[0][3:])


def _profile(tree: str) -> dict:
    """``profile_scot``'s forward (part 1) and train-step (part 4) numbers."""
    with tempfile.TemporaryDirectory() as work:
        out = os.path.join(work, "p.json")
        r = subprocess.run([sys.executable, "-m", "pregen_pde_tpu_torch.profile_scot", "--json",
                            out], cwd=tree, capture_output=True, text=True, timeout=1800)
        if r.returncode != 0:
            raise RuntimeError(f"profile_scot in {tree} rc {r.returncode}:\n{r.stderr[-4000:]}")
        with open(out) as f:
            res = json.load(f)
    brief = lambda p: {k: p[k] for k in ("wall_ms", "busy_ms", "idle_share")}
    step = res["train_step_B16"]
    return {"forward_ms": {f"B{b}": {r: res[f"B{b}"][f"{r}_ms"] for r in ("auto", "plain")}
                           for b in (16, 3)},
            "forward_B16_profiled": brief(res["B16"]["auto_profiled"]),
            "train_step_ms": {r: step[f"{r}_ms"] for r in ("auto", "attention-only", "plain")},
            "train_two_steps_profiled": brief(step["auto_profiled"]),
            "train_top_kernels": step["auto_profiled"]["top"]}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(prog="pregen_pde_tpu_torch.compare_scot")
    p.add_argument("parent")
    p.add_argument("change")
    p.add_argument("--pairs", type=int, default=2)
    p.add_argument("--json", help="also write the result here")
    args = p.parse_args(argv)

    from pregen_pde_tpu_torch.profile_k1 import _card

    card = _card()
    print(card, flush=True)
    trees = {"parent": os.path.abspath(args.parent), "change": os.path.abspath(args.change)}
    runs = {side: [] for side in trees}
    for i in range(args.pairs):
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        for side in order:
            run = {"k3": _k3(trees[side]), "profile": _profile(trees[side])}
            runs[side].append(run)
            print(f"{side}: {json.dumps(run)}", flush=True)
    res = {"card": card, "pairs": args.pairs, "runs": runs}
    print(json.dumps(res), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
