#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]   # from the repository root; one card

Phases (any failure exits nonzero; no phase catches a failure):

1. identify the card (``nvidia-smi`` name and power limit);
2. build the CUDA kernels from ``pregen_pde_tpu_torch/csrc`` (seconds printed);
3. the kernel's 2-D forward/inverse FFT passes vs ``torch.fft`` in float64,
   n ∈ {128, 256, 512, 1024}: relative L2 ≤ 2e-6;
4. K1 (the CN+AB2 stepper; at 256² the cluster-resident kernel, one
   launch a call) vs its plain version at the north-star configuration
   (256², ν-scan, dt 1e-4, 2500 steps, 50 snapshots, FNO forcing), B=4:
   per-snapshot relative L2 against the float64 plain version (worst over
   the batch), in vorticity and fields output; bars at snapshot 50: ≤ 2×
   the plain float32 path's own error and ≤ 2.6e-4 (the f32 floor on record
   is 1.28e-4, PERF_TPU_HISTORY.md:792-818); and K1 against the plain
   float32 version on the same inputs, ≤ 1e-5 at every snapshot. Then the
   main path's shape: B=8, fields, 20 snapshots × 275 steps (the shortest
   horizon at time-scale 5e-4), ν = 1/Re across the Re range, K1 vs plain
   float32 ≤ 1e-5 at every snapshot. Then the main path's own batch (32
   images of ``generate``'s seed-0 draws: its GRF initial fields, Re and
   per-image inner steps at time-scale 1e-5, 5–13 steps a snapshot) as
   one call: exactly one launch counted, per snapshot ≤ 1e-5 against the
   plain float32 version run per horizon bucket as the plain methods run
   them. Then the chain, the route of n ∈ {512, 1024}: 512², B=2, fields,
   3 × 5 steps, ≤ 1e-5 per snapshot, its launches exactly;
5. the main path: ``python -m pregen_pde_tpu_torch generate --workload
   ns_spectral --n 32 --resolution 256 --batch-size 32`` in a subprocess,
   whose shard must be (32, 21, 256, 256, 6), finite, mask ≡ 0, SDF ≡ 1,
   Re_norm in [0, 1], and whose K1 launch count must be exactly 1 (the
   batch is one call);
6. north-star throughput (B=32) of K1 and of the plain version in both
   outputs, and K1 vs plain float32 on those inputs (relative L2 ≤ 1e-5 at
   every snapshot); the chain at the north star (fields), held to the same
   bar; µs per trajectory-step at 256², B = 1, 8, 32, the resident kernel
   against the chain (CUDA events, the difference of a 300- and a 100-step
   call); the main path's batch at time-scale 5e-4 as the one call
   ``generate`` makes, against its bound.

7. K2 (the Chorin projection stepper, one cluster-resident launch a call)
   is built in phase 2, in parallel with K1 (one ``nvcc`` each); its build
   seconds and how many clusters the card holds at 32², 128², 256² are
   printed here;
8. K2 against its plain float32 version on the same inputs, per-snapshot
   relative L2 of the (u, v, p) frames, worst over the batch, ≤ 7e-5 at
   every snapshot: (a) channel 128², B=8, ``fpo_multi_hole`` masks, u_max
   across Re 100…10000, the batch's smallest CFL dt, 20 snapshots × 50
   steps; (b) cavity 128², B=4, the same Re range; (c) channel 256², B=4,
   5 × 20 steps; (d) the masked main path's own batch (``fpo_multi_hole``,
   B=32, 128², its Re draws) at time-scale 0.01: every trajectory at its
   CFL sub-bucket's dt and inner steps, longest first, in one launch
   (exactly one counted); (e) the masked main path's mode at B = 32 and
   128 (the plan's batch at time-scale 0.01): K2 writing its frames in
   place into channels 0:3 of a 6-channel contract at the plan's rows in
   launch order, then a dt/2 retry of two rows into the same contract,
   exactly two launches, byte-equal to K2's default route scattered at
   those rows, channels 3-5 untouched, and against the plain version
   writing the same contract: each row within the bar, or, where plain
   float32 is itself farther than the bar from the plain float64 route (a
   row whose flow amplifies roundoff), K2 no farther from float64 than
   plain float32. Then K2's interior divergence (inlet-aware,
   [2:-2, 2:-2]) on a no-hole channel must be ≤ 2× the plain version's;
9. the Ghia cavity through K2 at 128², Re 100 and 400: centreline
   deviations < 0.05/0.03 and < 0.07/0.06 (u/v), extrema within 8%;
9a. the other two physical checks of the JAX package through K2: the
   cylinder at Re_d 150, 128², t_end 80 (34,000 steps, a frame every step,
   6.7 GB on the card, the probe and drag series reduced there) in exactly
   one launch, with the JAX bands St in (0.15, 0.21), C_d in (1.0, 1.6) and
   a probe amplitude > 0.2; and the Richardson triplet on 32/64/128 in
   exactly three launches, order > 1.3;
10. the masked main path: ``generate --workload fpo_multi_hole --n 32
    --resolution 128 --batch-size 32 --time-scale 1.0`` and ``--workload
    ldc_regular --n 8 --batch-size 8`` in subprocesses; each shard must be
    (N, 21, 128, 128, 6), finite, with a binary mask (0 for ldc, ≥ 2·16²
    hole cells per multi-hole trajectory), an SDF in [−1, 1] that is < 0
    exactly where the mask is 1, Re_norm in [0, 1], the inlet (fpo: u on
    column 0 = parabolic_inlet × Re·ν/L) or the lid (ldc: u on the top row
    = u_max) in every frame at relative 1e-5, and K2 launched exactly once
    a batch and once a retry attempt (the CLI's ``calls``);
11. K2 and the plain version in µs per trajectory-step at B = 1, 8, 32
    (128², ``fpo_multi_hole`` masks, Re 5000, 1000 steps), K2 at B = 32
    against its float32 and its 3xTF32 bound, and the main path's batch at
    time-scale 1.0 as its one call. The end states are printed against each
    other and against K2 with u_max moved by one ulp, for information only:
    1000 steps there are 60 time units, longer than the shedding flow keeps
    float32 roundoff small (NVIDIA H100: K2 vs plain 3.1e-5 at B=1 and
    8.3e-4 at B=32, the earlier seven-launch chain).

12. K3 (the Swin-V2 block) and K4 (window attention) are built in phase 2
    beside K1 and K2; their build seconds are printed here;
13. K4's forward in the model's layout (q, k, v the permuted views of
    their projections, q and k cosine-normalised at a logit scale of 10,
    the bias 16σ(CPB) with the heads fastest, plus the shift mask) against
    its plain version at scOT-B's stage 0 at batch 16 (nb 64, 3 heads, n
    256, hd 32; nw 4 and 1), stage 2 on the attention-only route (nb 16,
    12 heads, n 64), scOT-L's stage 2 (nb 16, 12 heads, n 64, hd 64), stage
    3 at batch 16 and the evaluate main path's stage 3 (batch 3): out and
    the log-sum-exp each under its own bar (``K4_FWD_VS_PLAIN_BARS``), the
    plain float32 version's own error against float64 (its floor) printed
    beside each; one launch a call, a rerun equal to the bit, only out
    allocated under ``torch.inference_mode()`` (one allocation kept, of
    out's bytes rounded up to the allocator's 512-byte block), and the model's merge of
    the heads a view of out; K4 by events (with the wrapper), its device
    time and the wrapper's host µs a call, the plain version and
    ``scaled_dot_product_attention`` (scale 1, float mask) timed against
    the float32 and 3xTF32 bounds; with ``--parent DIR`` also that
    checkout's K4 (its wrapper and copies) on the same inputs, in turns,
    its source built into this checkout's ``_build/`` (nothing is written
    under DIR);
14. K3 against its plain version (relative L2 ≤ 2e-5) at stages 0 (nw 4
    and 1), 1 and 2 at batch 16, (16, 32², 96), (16, 16², 192), (16, 8²,
    384), and stages 0–2 at the main path's batch 3, with the weights in
    the layouts the model passes; under ``torch.inference_mode()`` a call
    leaves only y allocated (nothing saved), and the same call under
    autograd gives the same y to the bit; K3 and plain timed against both
    bounds, float32 and 3xTF32;
15. the whole scOT-B forward at 128², batch 16, one seeded weight set, in
    three routes: auto (K3 at the 48 layers of C ≤ 384, K4 in the 16 of
    stage 3), attention-only (K4 at all 64) and plain; each kernel route
    against plain (relative L2 ≤ 2.5e-5), the launches of one forward exactly
    (auto 240 K3 kernels = 48 × 5 and 16 K4; attention-only 64 K4), each
    route timed (events and device time); then every K4 call of one
    forward of each kernel route again, three times, on the operands the
    model passed, under the profiler: its kernels are K4's and nothing else
    (no copy), exactly as many as K4's launch counter says were enqueued
    (a profiler session that records fewer device events than that is
    taken again, at most three sessions; more, or another kernel, fails at
    once);
16. the scOT main path: ``evaluate --model scot-B`` in a subprocess on
    phase 10's ``fpo_multi_hole`` shard with that seeded weight set as a
    ``.pt`` (written to a temp dir, deleted after): finite errors for the 3
    default patterns and the 7 accumulation steps, the exact K3 and K4
    launches of its 19 forwards, and agreement with an in-process
    evaluation of the same data through the plain route (reported errors
    within relative 1e-4);
17. K4's backward against its plain version at the train main path's
    stage 3 (nb 16, 24 heads, n 16: the small route, one launch) and at
    stage 0 (nb 64, 3 heads, n 256, nw 4: the wide route, two launches) at
    batch 16, from the forward kernel's own output and log-sum-exp: each
    of dq, dk, dv and dbias by relative L2 under its own bar
    (``K4_BWD_VS_PLAIN_BARS``), the plain float32 version's own error
    against float64 (its floor) printed beside it, the route's launches
    exactly, two calls bitwise equal; the kernel (events and device time),
    the plain version and the backward of ``scaled_dot_product_attention``
    with the bias as a float mask that requires a gradient timed against
    the float32 and 3xTF32 bounds;
18. K3's backward against its plain version at stages 0 (shifted, nw 4),
    1 and 2 of scOT-B at batch 16 and stage 0 at batch 3, through autograd
    as the model calls it: each of the 19 cotangents by relative L2 under
    its own bar (``K3_BWD_VS_PLAIN_BARS``), two calls bitwise equal, the
    launches exactly (5 forward, 8 backward a call); kernel and plain timed
    against both bounds;
19. one scOT-B training step (128², batch 16, drop-path on, the same
    seeded weights, batch and generator state) through the kernels and
    through the plain route: the loss within relative 1e-5, every
    parameter's gradient within relative L2 1.1e-3 (the worst printed), the
    exact launches of one step (K3 48 × 5 forward and 48 × 8 backward, K4
    16 and 16 × 1); both routes timed;
19a. the fused AdamW (``csrc/adamw.cu``, two launches a step) against its
    plain version, the ``_foreach`` route, on scOT-B's 1,580 leaves (157.7
    M parameters, N(0, 0.02²)) under the four scOT tiers with decay: five
    steps of N(0, 10⁻⁸) gradients from the same state (global norm ~1.3,
    the clip at 5 not engaged; two leaves without a gradient on steps 2
    and 4): p, m and v bit-equal, ``.grad`` untouched, 2 launches a step;
    then both routes and torch's own fused AdamW kernel (``_fused_adamw_``,
    ``profile_scot.library_adamw``; its update rounds differently, its
    parting from the kernel's p printed) timed by events, as the host's
    enqueue, and as device time by events with the enqueue off the clock
    (``queued_ms``), against the bytes bound (p, g, m, v read and p, m, v
    written once, g read once more for the norm);
20. the train main path: ``train --model scot-B --epochs 1 --batch-size 16
    --ckpt <tmp>`` in a subprocess on phase 10's shard (32 steps, 3 val
    batches): the exact launches of all four kernels and the fused AdamW's
    (2 a step), finite loss and val
    numbers, ``best.pt`` written; then ``evaluate --ckpt <tmp>/best.pt``
    prints finite errors;
21. ``mix-sweep --model scot-B --alphas 0.5 --total-trajectories 16
    --epochs 1`` in a subprocess, hard = phase 10's ``fpo_multi_hole``
    shard, easy = 16 ``fpo_regular`` trajectories generated here: finite
    numbers for both test splits, every kernel launched (the AdamW's too).

22. K5a (the periodic Laplacian) and K5b (the fused Heun heat step) are
    built in phase 2 beside the others; their build seconds are printed;
23. K5a and K5b (one step, the tiled kernel) against their plain versions
    at (B=32, 128²), (B=4, 256²) and the ragged (B=3, 130²) on GRF fields,
    K5b with reaction 0 and 1: K5a relative L2 ≤ 1e-7, K5b's increment (the
    step minus u) ≤ 7e-5; the resident trajectory (one launch, 4 × 50
    steps) at (4, 256²) and (3, 130²), k = 0 and 1, per snapshot ≤ 3.5e-6
    against the plain trajectory; the heat trajectory at B=32, 128² through
    ``HeatSolver(impl="fused")`` (20 × 500 steps, one resident launch) and
    ``impl="laplacian"`` (20 × 50, two launches a step) against
    ``impl="plain"``, per snapshot ≤ 3.5e-6; K5a's floor (its plain version
    against float64) beside its bar, and a K5a mutant (the wrap of the top
    row read from row n − 2, built in phase 2) failing the bar; K5a at B =
    1, 8, 32 at 128² and B = 32 at 256² and 512² by CUDA graph replay
    against its bytes bound, and at (1, 4²), next to no work, for what a
    graph node costs; K5a, one tiled K5b step,
    their plain versions and a circular ``nn.Conv2d`` with the 5-point
    weights (K5a's yardstick, TF32 off) timed by CUDA graph replay (device
    time, without the host's enqueue); the main path's trajectory call by
    CUDA events against its FLOP bound and the plain trajectory; µs a step
    at B = 1, 8, 32, the resident kernel in clusters of 1, 2, 4 and 8
    blocks an image against the tiled route (the difference of a 1500- and
    a 500-step call). K5a's launches in the kernels line are those of the
    laplacian route's run, its path (JAX's ``use_pallas=True``); K5b's
    those of phase 24;
24. the heat main path: ``generate --workload heat --n 32 --resolution 128
    --batch-size 32`` in a subprocess: a finite (32, 21, 128, 128) shard,
    exactly 10,000 K5b launches and no other kernel's, every trajectory's
    mean within 3e-4 of its initial rms, its variance falling at every
    snapshot;
25. ``generate --workload burgers --n 32 --resolution 1024`` and ``--workload
    darcy --n 32 --resolution 128`` (plain PyTorch on the card, as the JAX
    package runs them outside any kernel): finite (32, 21, 1024) and (32, 2,
    128, 128) shards, a > 0 and u ≥ 0, and the card's float32 u of two
    trajectories against a float64 CPU solve of the same a, relative L2
    ≤ 2e-5.
26. FNO (modes 12, width 32, 4 layers) and FFNO (modes 12, width 48, 4
    layers) at 128², B = 16, weights from seed 0, their spectral
    convolutions through ``torch.fft``: the card's forward in float32 (TF32
    off) against the same model in float64 on the CPU, relative L2 under
    ``MODEL_VS_F64_BARS``, and every parameter's gradient of a relative-L2
    loss (dropout off) under its own bar in ``MODEL_GRAD_VS_F64_BARS`` (each
    bar about 10× the value measured on an H100; the values are printed
    every run); ms per forward and per AdamW train step by events and as
    device time. No hand-written kernel is on this path: the JAX package
    computes both models in XLA;
27. the CLI on phase 10's ``fpo_multi_hole`` shard: ``train`` with no
    ``--model`` (FNO, the JAX CLI's default) ``--epochs 1 --batch-size 16
    --ckpt``, then ``evaluate --ckpt best.pt`` with no ``--model``, then
    ``mix-sweep --model ffno --alphas 0.5 --total-trajectories 16 --epochs
    1`` with phase 21's ``fpo_regular`` shard as the easy half: each exits
    0 and prints finite errors.
28. CNO as the CLI builds it (3 layers, multiplier 32, 6 neck blocks,
    128², 7 channels in, 3 out), weights from seed 0: the card's forward in
    float32 (TF32 off) against the same model in float64 on the CPU at B =
    4, relative L2 under ``CNO_VS_F64_BAR``, and every parameter's gradient
    of a relative-L2 loss under the bar of its kind
    (``CNO_GRAD_VS_F64_BARS``, each about 10× the value measured on an
    H100), with the count of leaky-ReLU inputs whose sign differs between
    the two and the gradients of a float64 run on the card's signs; then
    ms per forward and per AdamW step at B = 16 (``upfirdn2d`` "auto", the
    dense operators) by events and as device time; then one filtered_lrelu
    at each of the model's three shapes (the lift's 64 channels at 128²,
    the first downsampling's 32 at 128² → 64², the last upsampling's 16 at
    64² → 128²) on each ``upfirdn2d`` route, the routes agreeing within
    2e-6, as device time beside the dense operators' and the taps' FLOP.
    No hand-written kernel is on this path: the JAX package computes CNO
    and its ops in XLA;
29. the CLI with CNO on phase 10's and 21's shards: ``train --model cno
    --epochs 1 --batch-size 16 --ckpt``, ``evaluate --model cno --ckpt
    best.pt``, ``mix-sweep --model cno --alphas 0.5 --total-trajectories
    16 --epochs 1`` and ``finetune --model cno`` from a seeded CNO of 5
    input and 2 output channels saved here (both adapters run): each exits
    0 and prints finite numbers; the walls with start-up and ``finetune``'s
    parameters per tier are printed.

The 1e-5 bar of K1 against the plain float32 version is about 30× what the
two differ by when both are right (2.4e-7 vorticity, 3.6e-7 fields at the
north star, NVIDIA H100): a kernel error of its own of 1e-5 fails it. The
7e-5 bar of K2 is about 30× its worst case when both are right (2.3e-6 at
phase 8 (a), growing over the snapshots, for the earlier float32 chain; the
cluster kernel's 3xTF32 products read 4.0e-6 there; NVIDIA H100). Two
mutants of the cluster kernel failed phase 8 by ≥ 10⁴× the bar: the
cavity's zero mode left alone, and a halo row off by one.

K3's and the whole model's bars are about 30× what each differs from its
plain version by when both are right (7.0e-7 and 8.4e-7 worst, NVIDIA
H100); the evaluate bar leaves ~100× over 9.3e-7 for the 7-step
rollouts. The backward bars are about 30× the worst differences of the
first run of phases 17–19 (one train step's gradients 3.6e-5 at a logit
scale, median 2.3e-7; NVIDIA H100); the loss agreed to the bit, and its bar
is 30× the forward's 3e-7. K4's forward has a bar an output (out and the
log-sum-exp), 2.5× the plain float32 version's own error against float64
at phase 13's inputs (the worst of its cases; NVIDIA H100), in place of one
bar at 1.5e-5, 30× its first run's difference: ``k4_bars.py`` shows two
mutants failing them (the bias read from the next window slot; the lo×hi
term dropped from every 3xTF32 k step, P·V's included). K4's backward, like
K3's, has a bar a cotangent, 2.5× the plain float32 version's own error
against float64 at phase 17's inputs (the worst of its two cases; NVIDIA
H100). K3's backward
has a bar a cotangent, 2.5× the plain float32 version's own error against
float64 at phase 18's inputs (worst of its three batch-16 stages): one bar
for all 19 at 30× the noisiest let a GELU-constant mutant through, which
moves the cotangents by at most 3.3× their floors; 2.5× fails it on five
(db1, dw1, dbp, dbv, dln1b), and a LayerNorm affine read from the wrong
sample by 10⁵×, while the earlier float32 kernel read ≤ 1.9× and the
3xTF32 kernel ≤ 2.0× (NVIDIA H100). K5a
agreed with its plain version to the bit (the same float32 operations, none
contractible), so its bar is a float32 ulp, below its plain version's own
error against float64 (3.6e-6 at 128²), and a wrap read from the wrong row
reads far above it; K5b's and the heat routes' bars
are about 30× their first run's worst (2.2e-6 increment; 1.1e-7 fused, 7.0e-8
laplacian route), the mean drift's 30× 9.3e-6 and Darcy's 30× 5.8e-7 (NVIDIA
H100). Each kernel's ``bound_ms`` is the larger of its bytes (inputs read
once, outputs written once) over 3.35 TB/s and its float32 operations over
67 TFLOP/s, computed from the shapes of the call that is timed; K2's and
K3's entries also carry ``bound_3xtf32_ms``, their products' FLOP three
times over the 495 TFLOP/s of TF32 on the tensor cores.

K2's entry of the kernels line also carries the launches of phase 9a's
validation paths (``validation_launches``).

Prints a kernels JSON line and the card line, then, as its last line,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
It imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
FFT_BAR = 2e-6
K1_ABS_BAR = 2.6e-4
K1_VS_PLAIN_BAR = 1e-5
K2_VS_PLAIN_BAR = 7e-5
GHIA_BARS = {100: (0.05, 0.03), 400: (0.07, 0.06)}
# the JAX package's bands (tests/test_ns_projection.py:124-136)
CYLINDER_BANDS = {"strouhal": (0.15, 0.21), "cd_mean": (1.0, 1.6), "amplitude": 0.2}
CONVERGENCE_ORDER_BAR = 1.3
# phase 26: FNO and FFNO on the card (float32, TF32 off) against the same
# model in float64 on the CPU, relative L2 of the forward, about 10x the
# measured value at 128², B = 16, seed 0 (NVIDIA H100)
MODEL_VS_F64_BARS = {
    "fno": 5e-6,    # measured 4.91e-07
    "ffno": 3.3e-6,  # measured 3.27e-07
}
# each parameter's gradient of a relative-L2 loss, card vs CPU float64, as
# measured at phase 26's inputs (NVIDIA H100); the bar is 10x each
MODEL_GRAD_VS_F64_MEASURED = {
    "fno": {
        "Dense_0.bias": 5.28e-08, "Dense_0.weight": 1.92e-07, "Dense_1.bias": 4.54e-08,
        "Dense_1.weight": 1.89e-07, "Dense_2.bias": 5.68e-08, "Dense_2.weight": 1.97e-07,
        "Dense_3.bias": 5.84e-08, "Dense_3.weight": 2.05e-07, "Dense_4.bias": 6.86e-08,
        "Dense_4.weight": 1.87e-07, "Dense_5.bias": 1.92e-07, "Dense_5.weight": 1.82e-07,
        "Dense_6.bias": 3.79e-08, "Dense_6.weight": 2.82e-07,
        "SpectralConv2d_0.w_neg_im": 2.24e-07, "SpectralConv2d_0.w_neg_re": 1.78e-07,
        "SpectralConv2d_0.w_pos_im": 1.65e-07, "SpectralConv2d_0.w_pos_re": 7.41e-08,
        "SpectralConv2d_1.w_neg_im": 1.87e-07, "SpectralConv2d_1.w_neg_re": 1.69e-07,
        "SpectralConv2d_1.w_pos_im": 1.55e-07, "SpectralConv2d_1.w_pos_re": 7.84e-08,
        "SpectralConv2d_2.w_neg_im": 1.99e-07, "SpectralConv2d_2.w_neg_re": 2.00e-07,
        "SpectralConv2d_2.w_pos_im": 1.65e-07, "SpectralConv2d_2.w_pos_re": 7.16e-08,
        "SpectralConv2d_3.w_neg_im": 1.86e-07, "SpectralConv2d_3.w_neg_re": 1.81e-07,
        "SpectralConv2d_3.w_pos_im": 1.56e-07, "SpectralConv2d_3.w_pos_re": 9.26e-08,
    },
    "ffno": {
        "ff_0_0.bias": 2.09e-07, "ff_0_0.g": 3.41e-07, "ff_0_0.v": 3.42e-07,
        "ff_0_1.bias": 1.61e-07, "ff_0_1.g": 3.46e-07, "ff_0_1.v": 3.36e-07,
        "ff_1_0.bias": 2.27e-07, "ff_1_0.g": 3.16e-07, "ff_1_0.v": 3.43e-07,
        "ff_1_1.bias": 1.85e-07, "ff_1_1.g": 3.82e-07, "ff_1_1.v": 3.38e-07,
        "ff_2_0.bias": 1.86e-07, "ff_2_0.g": 3.68e-07, "ff_2_0.v": 3.36e-07,
        "ff_2_1.bias": 1.73e-07, "ff_2_1.g": 3.04e-07, "ff_2_1.v": 3.39e-07,
        "ff_3_0.bias": 3.80e-07, "ff_3_0.g": 5.05e-07, "ff_3_0.v": 5.11e-07,
        "ff_3_1.bias": 2.29e-07, "ff_3_1.g": 4.64e-07, "ff_3_1.v": 5.00e-07,
        "head_0.bias": 3.53e-07, "head_0.g": 4.07e-07, "head_0.v": 4.17e-07,
        "head_1.bias": 1.72e-07, "head_1.g": 3.90e-07, "head_1.v": 5.80e-07,
        "in_proj.bias": 1.66e-07, "in_proj.g": 4.47e-07, "in_proj.v": 5.17e-07,
        "w_x_im": 1.25e-06, "w_x_re": 1.01e-06, "w_y_im": 1.19e-06, "w_y_re": 1.12e-06,
    },
}
MODEL_GRAD_VS_F64_BARS = {name: {k: 10 * v for k, v in leaves.items()}
                          for name, leaves in MODEL_GRAD_VS_F64_MEASURED.items()}
# phase 28: the CLI's CNO on the card (float32, TF32 off) against the same
# model in float64 on the CPU, 128², B = 4, seed 0: the forward's bar, about
# 10x the value measured on an NVIDIA H100
CNO_VS_F64_BAR = 2.4e-5  # measured 2.383e-06
# each parameter's gradient of a relative-L2 loss, card vs CPU float64, the
# worst of each kind (``cno_leaf_kind``) as measured at phase 28's inputs
# (NVIDIA H100); for a leaf with no gradient in exact arithmetic (a
# convolution's bias before a per-channel norm) the card's gradient's norm
# over the whole gradient's; FILM's inp2lat layers (Dense_0, Dense_2) have
# an exact 0 under the zero-initialised heads. The bar is 10x each. These
# errors come from the leaky ReLU: 33 of its 95,205,632 inputs had opposite
# signs on the two; a float64 run on the card's signs agrees far closer
# (printed each run)
CNO_GRAD_VS_F64_MEASURED = {
    "CNOBlock.AntiAliasedLReLu_0.bias": 7.43e-04, "CNOBlock.Conv_0.bias": 3.40e-09,
    "CNOBlock.Conv_0.weight": 6.07e-04, "CNOBlock.FILM_0.Dense_0.bias": 0.00e+00,
    "CNOBlock.FILM_0.Dense_0.weight": 0.00e+00, "CNOBlock.FILM_0.Dense_1.bias": 7.18e-04,
    "CNOBlock.FILM_0.Dense_1.weight": 7.18e-04, "CNOBlock.FILM_0.Dense_2.bias": 0.00e+00,
    "CNOBlock.FILM_0.Dense_2.weight": 0.00e+00, "CNOBlock.FILM_0.Dense_3.bias": 7.43e-04,
    "CNOBlock.FILM_0.Dense_3.weight": 7.43e-04, "CNOBlock.FILM_0.GroupNorm_0.bias": 7.43e-04,
    "CNOBlock.FILM_0.GroupNorm_0.scale": 7.18e-04,
    "LiftProjectBlock.CNOBlock_0.AntiAliasedLReLu_0.bias": 4.50e-04,
    "LiftProjectBlock.CNOBlock_0.Conv_0.bias": 4.50e-04,
    "LiftProjectBlock.CNOBlock_0.Conv_0.weight": 5.15e-04,
    "LiftProjectBlock.Conv_0.bias": 4.54e-04, "LiftProjectBlock.Conv_0.weight": 5.33e-04,
    "ResidualBlock.AntiAliasedLReLu_0.bias": 7.94e-04, "ResidualBlock.Conv_0.bias": 1.48e-08,
    "ResidualBlock.Conv_0.weight": 6.34e-04, "ResidualBlock.Conv_1.bias": 3.43e-09,
    "ResidualBlock.Conv_1.weight": 5.81e-04, "ResidualBlock.FILM_0.Dense_0.bias": 0.00e+00,
    "ResidualBlock.FILM_0.Dense_0.weight": 0.00e+00,
    "ResidualBlock.FILM_0.Dense_1.bias": 6.16e-04,
    "ResidualBlock.FILM_0.Dense_1.weight": 6.16e-04,
    "ResidualBlock.FILM_0.Dense_2.bias": 0.00e+00,
    "ResidualBlock.FILM_0.Dense_2.weight": 0.00e+00,
    "ResidualBlock.FILM_0.Dense_3.bias": 7.94e-04,
    "ResidualBlock.FILM_0.Dense_3.weight": 7.94e-04,
    "ResidualBlock.FILM_0.GroupNorm_0.bias": 7.94e-04,
    "ResidualBlock.FILM_0.GroupNorm_0.scale": 6.16e-04,
    "ResidualBlock.FILM_1.Dense_0.bias": 0.00e+00,
    "ResidualBlock.FILM_1.Dense_0.weight": 0.00e+00,
    "ResidualBlock.FILM_1.Dense_1.bias": 6.57e-04,
    "ResidualBlock.FILM_1.Dense_1.weight": 6.57e-04,
    "ResidualBlock.FILM_1.Dense_2.bias": 0.00e+00,
    "ResidualBlock.FILM_1.Dense_2.weight": 0.00e+00,
    "ResidualBlock.FILM_1.Dense_3.bias": 6.53e-04,
    "ResidualBlock.FILM_1.Dense_3.weight": 6.53e-04,
    "ResidualBlock.FILM_1.GroupNorm_0.bias": 6.53e-04,
    "ResidualBlock.FILM_1.GroupNorm_0.scale": 6.57e-04,
}
CNO_GRAD_VS_F64_BARS = {k: 10 * v for k, v in CNO_GRAD_VS_F64_MEASURED.items()}
K3_VS_PLAIN_BAR = 2e-5
SCOT_VS_PLAIN_BAR = 2.5e-5
EVAL_VS_PLAIN_RTOL = 1e-4
# K4's forward, one bar an output: 2.5x the plain float32 version's own
# relative L2 against float64, the worst of phase 13's cases (the floor
# beside each; NVIDIA H100); the single bar before was 1.5e-5
K4_FWD_VS_PLAIN_BARS = {
    "out": 1.27e-6,  # floor 5.10e-07
    "lse": 9.0e-8,   # floor 3.63e-08
}
# phase 13's cases, K4 in the model's layout: (label, nb, h, n, hd, nw)
K4_FWD_CASES = (("stage 0 shifted, B=16", 64, 3, 256, 32, 4),
                ("stage 0, B=16", 64, 3, 256, 32, 1),
                ("stage 2 attention-only, B=16", 16, 12, 64, 32, 1),
                ("scOT-L stage 2, B=16", 16, 12, 64, 64, 1),
                ("stage 3, B=16", 16, 24, 16, 32, 1),
                ("stage 3, B=3 (main path)", 3, 24, 16, 32, 1))
# K4's backward, one bar a cotangent: 2.5x the plain float32 version's own
# relative L2 against float64, the worst of phase 17's two cases (the floor
# beside each; NVIDIA H100)
K4_BWD_VS_PLAIN_BARS = {
    "dq": 1.0e-6,     # floor 4.13e-07
    "dk": 1.0e-6,     # floor 4.11e-07
    "dv": 1.0e-6,     # floor 4.03e-07
    "dbias": 9.1e-7,  # floor 3.64e-07
}
# K3's backward, one bar a cotangent: 2.5x the plain float32 version's own
# relative L2 against float64, the worst of phase 18's three B=16 stages
# (the floor beside each; NVIDIA H100, TF32 off)
K3_BWD_VS_PLAIN_BARS = {
    "dx": 2.5e-6,     # floor 9.93e-07
    "dbias": 2.4e-6,  # floor 9.58e-07
    "dscale": 4.0e-6,  # floor 1.60e-06
    "dwq": 2.8e-6,    # floor 1.10e-06
    "dbq": 2.8e-6,    # floor 1.12e-06
    "dwk": 2.8e-6,    # floor 1.10e-06
    "dwv": 2.5e-6,    # floor 9.64e-07
    "dbv": 1.9e-6,    # floor 7.55e-07
    "dwp": 2.4e-6,    # floor 9.56e-07
    "dbp": 1.9e-6,    # floor 7.42e-07
    "dln1w": 2.4e-6,  # floor 9.59e-07
    "dln1b": 1.8e-6,  # floor 6.82e-07
    "dw1": 3.1e-6,    # floor 1.21e-06
    "db1": 2.9e-6,    # floor 1.15e-06
    "dw2": 1.7e-6,    # floor 6.40e-07
    "db2": 4.4e-7,    # floor 1.75e-07
    "dln2w": 1.9e-6,  # floor 7.42e-07
    "dln2b": 2.6e-7,  # floor 1.00e-07
    "ddp": 2.9e-6,    # floor 1.13e-06
}
STEP_LOSS_RTOL = 1e-5
STEP_GRAD_BAR = 1.1e-3
K5A_VS_PLAIN_BAR = 1e-7
# a mutant of K5a's row route that phase 23 must catch: the top row's upper
# neighbour (the wrap) read from row n - 2 instead of n - 1
K5A_WRONG_WRAP = ("      y = y < 0 ? y + n : y >= n ? y - n : y;",
                  "      y = y < 0 ? y + n - 1 : y >= n ? y - n : y;")
K5B_VS_PLAIN_BAR = 7e-5
HEAT_ROUTE_VS_PLAIN_BAR = 3.5e-6
HEAT_MEAN_DRIFT_BAR = 3e-4
DARCY_F32_VS_F64_BAR = 2e-5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12          # H100 SXM float32 outside the tensor cores
TF32_FLOPS = 495e12        # H100 SXM TF32 on the tensor cores, dense


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0 or not r.stdout.strip():
        fail(f"nvidia-smi failed: rc {r.returncode} {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    """(ms, what bounds it): the least time the card could take."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def k4_model_inputs(gen, nb: int, h: int, n: int, hd: int, nw: int):
    """K4's q, k, v and bias drawn from ``gen`` and laid out as the model
    passes them (``models/scot.py``): q, k, v the (nb, h, n, hd) views of
    (nb, n, h·hd) projections, q and k cosine-normalised, q at a logit scale
    of 10; the bias 16σ of a (n, n, h) table permuted to (h, n, n), as the
    CPB gather gives it (heads fastest), plus scOT-B stage 0's shift mask
    at nw = 4 (n = 256)."""
    import torch

    from pregen_pde_tpu_torch.models.scot import shift_attn_mask

    dev = gen.device
    rn = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    heads = lambda t: t.reshape(nb, n, h, hd).permute(0, 2, 1, 3)
    q, k, v = (heads(rn(nb, n, h * hd)) for _ in range(3))
    q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + 1e-6) * 10.0
    k = k / (torch.linalg.vector_norm(k, dim=-1, keepdim=True) + 1e-6)
    bias = (16.0 * torch.sigmoid(rn(n, n, h).permute(2, 0, 1)))[None]
    if nw > 1:
        bias = bias + torch.from_numpy(shift_attn_mask(32, 32, 16, 8)).to(dev)[:, None]
    return q, k, v, bias


def host_us(fn, reps: int = 200) -> float:
    """The host's µs a call of ``fn`` (its enqueue: no synchronisation
    inside the timed calls)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return t


def k3_linear(sb, args):
    """The K3 operands of the JAX package's packed layouts in the layouts
    the model passes (``nn.Linear`` weights, flat biases)."""
    (x, bias, scale, wq, bq, wk, wv, bv, wp, bp, ln1w, ln1b, w1, b1, w2, b2, ln2w, ln2b,
     dp) = args
    lq, lbq, lk, lv, lbv, lp, lbp, l1, lb1, l2, lb2 = sb.linear_from_packs(wq, bq, wk, wv, bv, wp,
                                                                           bp, w1, b1, w2, b2)
    return (x, bias, scale, lq, lbq, lk, lv, lbv, lp, lbp, ln1w, ln1b, l1, lb1, l2, lb2, ln2w,
            ln2b, dp)


def device_ms(fn, reps: int = 10) -> float:
    """The device time of ``fn``'s kernels a call (``torch.profiler``: the
    sum of their durations over ``reps`` calls), apart from the host's
    enqueue, which event timing includes when the host is the slower."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.time_range.end - e.time_range.start for e in kernels) / 1e3 / reps


def device_kernel_names(fn, launched, kernel: str, tries: int = 3) -> tuple[list, int, int]:
    """(the names of the device kernels ``fn`` runs, by ``torch.profiler``;
    how many kernels the launch counters say ``fn`` enqueued, read by
    ``launched()`` after it (``fn`` resets the counters first); the
    sessions it took). A session that records fewer device events than
    were enqueued is the profiler's miss, not ``fn``'s (this script's runs
    on an NVIDIA H100 saw one record none, and one 47 of 48), and is
    profiled again, up to ``tries`` sessions. A session that records as
    many or more, or a kernel whose name lacks ``kernel``, is returned at
    once for the caller to judge."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, tries + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        enqueued = launched()
        if len(names) >= enqueued or not all(kernel in nm for nm in names):
            break
    return names, enqueued, attempt


def queued_ms(fn, host_s: float, reps: int = 4) -> float:
    """The device's ms a call of ``fn`` by CUDA events, the host's enqueue
    kept off the clock: the card sleeps (``torch.cuda._sleep``, cycles at
    no more than 2 GHz) while the host enqueues all ``reps`` calls, ``host_s``
    seconds a call as measured, and the first event follows the sleep. The
    profiler's device time can miss a kernel (phase 15); this cannot."""
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int((2 * reps * host_s + 0.02) * 2e9))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def timed(fn, reps: int = 1):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) / reps


def parent_k4(tree: str, so: str):
    """The K4 wrapper module of the checkout ``tree`` (e.g. a ``git archive``
    of the parent commit) bound to ``so``, its kernel source's build, to
    time beside this tree's in one process."""
    import ctypes
    import importlib.util
    import types

    spec = importlib.util.spec_from_file_location(
        "parent_window_attention",
        os.path.join(tree, "pregen_pde_tpu_torch", "ops", "window_attention.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lib = ctypes.CDLL(str(so))
    mod._build = types.SimpleNamespace(load=lambda name: lib)
    return mod


def main(argv=None) -> None:
    import argparse

    import torch

    ap = argparse.ArgumentParser(prog="chip_smoke.py")
    ap.add_argument("--parent", help="another checkout (e.g. a git archive of the parent "
                                     "commit) whose K4 forward phase 13 times beside this one")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing to test",
              file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, ROOT)
    try:
        import pregen_pde_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        sys.exit(3)
    import numpy as np

    from pregen_pde_tpu_torch.core import NSVorticityConfig
    from pregen_pde_tpu_torch.datagen.pipeline import (
        GenerationConfig, _inner_steps, draw_batch_inputs)
    from pregen_pde_tpu_torch.datagen.writer import load_shards
    from pregen_pde_tpu_torch.fields.grf import grf_2d, grf_filter
    from pregen_pde_tpu_torch.kernels import build
    from pregen_pde_tpu_torch.solvers import ns_projection_cuda as npc
    from pregen_pde_tpu_torch.solvers import schedules
    from pregen_pde_tpu_torch.solvers import spectral_ns_cuda as snc
    from pregen_pde_tpu_torch.solvers.spectral_ns import NSVorticitySolver
    from pregen_pde_tpu_torch.utils.device import resolve_device, set_precision_policy
    from pregen_pde_tpu_torch.utils.parity import per_snapshot_rel_l2, rel_l2

    # -- 1. the card ----------------------------------------------------------
    card = card_line()
    dev = resolve_device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    say(f"[1] card: {card} | torch: {kind} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | {json.dumps(set_precision_policy(dev))}")

    # -- 2. build: one nvcc per source, all started together ---------------------
    t0_build = t0 = time.perf_counter()
    from pregen_pde_tpu_torch.ops import swin_block as sb
    from pregen_pde_tpu_torch.ops import window_attention as wa

    from pregen_pde_tpu_torch.ops import adamw, stencil

    names = (snc.LIB_NAME, npc.LIB_NAME, sb.LIB_NAME, wa.LIB_NAME, stencil.LIB_NAME,
             adamw.LIB_NAME)
    pool = ThreadPoolExecutor(max_workers=len(names))
    builds = {name: pool.submit(build.build, name) for name in names}
    # K5a's wrong-wrap mutant (phase 23) and, with --parent, that tree's K4
    builds["k5a_wrong_wrap"] = pool.submit(build.build_variant, stencil.LIB_NAME,
                                           (K5A_WRONG_WRAP,), "k5a_wrong_wrap")
    if args.parent:
        builds["parent_k4"] = pool.submit(build.build_variant, wa.LIB_NAME, (), "parent_k4",
                                          os.path.abspath(args.parent))
    builds[snc.LIB_NAME].result()
    build.load(snc.LIB_NAME)
    say(f"[2] built {snc.LIB_NAME} (sm_90a) in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {build.build_seconds[snc.LIB_NAME]:.2f} s)")

    # -- 3. FFT passes vs torch.fft in float64 ----------------------------------
    gcpu = torch.Generator().manual_seed(0)
    for n in snc.SUPPORTED_N:
        x = torch.complex(torch.randn(2, n, n, generator=gcpu),
                          torch.randn(2, n, n, generator=gcpu))
        x64 = x.to(torch.complex128)
        xd = x.to(dev)
        for inverse, ref in ((False, torch.fft.fft2(x64)), (True, torch.fft.ifft2(x64))):
            got = snc.fft2(xd, inverse=inverse)
            torch.cuda.synchronize()
            err = rel_l2(torch.view_as_real(got.cpu()), torch.view_as_real(ref))
            say(f"[3] fft2 n={n} {'inverse' if inverse else 'forward'}: "
                f"rel L2 {err:.3e} (bar {FFT_BAR:.0e})")
            if not err <= FFT_BAR:
                fail(f"fft2 n={n} inverse={inverse} rel L2 {err} > {FFT_BAR}")

    # -- 4. K1 vs its plain version at the north-star configuration ------------
    cfg = NSVorticityConfig(resolution=256, viscosity=1e-4, dt=1e-4, t_end=0.25,
                            n_snapshots=50, forcing="fno", include_initial=True)
    sol = NSVorticitySolver(cfg)
    gdev = torch.Generator(device=dev).manual_seed(0)
    w0_4 = grf_2d(gdev, sol.grid, 4)
    nu_4 = torch.tensor([1e-4, 2e-4, 5e-4, 1e-3], device=dev)

    def plain(solver, w0, nu, fields, steps=None):
        snaps = solver._build_traj_packed(steps, scheme="ab2")(w0, nu)
        if not fields:
            return snaps
        f = solver.fields_from_vorticity(snaps)
        return torch.stack([f["u"], f["v"], f["p"]], dim=-1)

    def k1_vs_plain(k1, p32, label):
        """K1 against the plain float32 version on the same inputs."""
        err = per_snapshot_rel_l2(k1, p32)
        if not err.max() <= K1_VS_PLAIN_BAR:
            fail(f"K1 vs plain f32 ({label}): worst snapshot {err.max():.3e} > "
                 f"{K1_VS_PLAIN_BAR:.0e} (per snapshot: {err.tolist()})")
        return err

    for output in ("vorticity", "fields"):
        fields = output == "fields"
        oracle = plain(sol, w0_4.double(), nu_4.double(), fields)
        p32 = plain(sol, w0_4, nu_4, fields)
        k1 = snc.build_batched_traj(sol, output=output)(w0_4, nu_4)
        torch.cuda.synchronize()
        if not torch.isfinite(k1).all():
            fail(f"K1 {output}: non-finite output")
        e_k1 = per_snapshot_rel_l2(k1, oracle)
        e_p32 = per_snapshot_rel_l2(p32, oracle)
        e_kp = k1_vs_plain(k1, p32, f"north star, {output}, B=4")
        for s in (1, 25, 50):
            say(f"[4] {output} snapshot {s}: K1 {e_k1[s]:.3e} | plain f32 "
                f"{e_p32[s]:.3e} (vs plain f64) | K1 vs plain f32 {e_kp[s]:.3e}")
        if not (e_k1[50] <= 2 * e_p32[50] and e_k1[50] <= K1_ABS_BAR):
            fail(f"K1 {output} snapshot 50 error {e_k1[50]:.3e} vs plain f32 "
                 f"{e_p32[50]:.3e} (bars: ≤ 2× plain, ≤ {K1_ABS_BAR})")
        say(f"[4] {output}: K1 vs plain f32 worst snapshot {e_kp.max():.3e} "
            f"(bar {K1_VS_PLAIN_BAR:.0e})")

    # the main path's shape: what one horizon bucket of `generate` runs
    sol_m = NSVorticitySolver(NSVorticityConfig(resolution=256, forcing="fno"))
    w0_8 = grf_2d(gdev, sol_m.grid, 8)
    re_8 = torch.linspace(schedules.RE_MIN, schedules.RE_MAX, 8, dtype=torch.float64)
    nu_8 = schedules.viscosity_from_re(re_8).to(device=dev, dtype=torch.float32)
    k1 = snc.build_batched_traj(sol_m, output="fields")(w0_8, nu_8, 275)
    p32 = plain(sol_m, w0_8, nu_8, True, steps=275)
    torch.cuda.synchronize()
    if not torch.isfinite(k1).all():
        fail("K1 fields at the main path's shape: non-finite output")
    e_kp = k1_vs_plain(k1, p32, "main-path shape, fields, B=8")
    say(f"[4] main-path shape (fields, B=8, 20 × 275 steps, Re 100…10000): "
        f"K1 vs plain f32 snapshots 1 / 10 / 20: {e_kp[1]:.3e} / {e_kp[10]:.3e} / "
        f"{e_kp[20]:.3e}, worst {e_kp.max():.3e} (bar {K1_VS_PLAIN_BAR:.0e})")
    say(f"[4] precision tiers -> kernel path: {json.dumps(snc.PRECISIONS)} "
        f"(all three run the one float32 CUDA-core path)")

    def main_batch(time_scale):
        """The main path's first batch as ``generate --n 32 --batch-size 32``
        draws it (the CLI's seed for --seed 0): its initial fields, ν and
        per-image inner steps at ``time_scale``."""
        gcfg = GenerationConfig(solver=NSVorticityConfig(resolution=256), batch_size=32,
                                time_scale=time_scale)
        seed = int(np.random.SeedSequence([0, 0]).generate_state(1)[0])
        xi, z_re = draw_batch_inputs(torch.Generator(device=dev).manual_seed(seed), gcfg)
        re = schedules.sample_reynolds(z=z_re, mean=gcfg.re_mean, std=gcfg.re_std)
        end_t = (schedules.end_time_from_re(re) * time_scale).cpu().numpy()
        msol = NSVorticitySolver(gcfg.solver)
        w0 = grf_filter(xi.to(torch.float32), msol.grid, gcfg.grf_alpha, gcfg.grf_tau,
                        gcfg.grf_sigma)
        inner = torch.as_tensor([_inner_steps(h, gcfg.solver) for h in end_t])
        return msol, w0, schedules.viscosity_from_re(re).to(torch.float32), inner, end_t

    # the main path's own batch as one launch, against the plain version
    # run per horizon bucket (as the plain methods run it)
    msol, w0_m, nu_m, inner_m, end_t = main_batch(1e-5)
    snc.reset_launches()
    k1 = snc.build_batched_traj(msol, output="fields")(w0_m, nu_m, inner_m)
    torch.cuda.synchronize()
    if snc.launches != 1:
        fail(f"K1, the main path's batch: {snc.launches} launches for one call")
    p32 = torch.empty_like(k1)
    for h in np.unique(end_t):
        rows = torch.as_tensor(np.nonzero(end_t == h)[0], device=dev)
        p32[rows] = plain(msol, w0_m[rows], nu_m[rows], True, steps=int(inner_m[rows[0].item()]))
    if not torch.isfinite(k1).all():
        fail("K1, the main path's batch: non-finite output")
    e_kp = k1_vs_plain(k1, p32, "the main path's batch in one launch")
    say(f"[4] the main path's batch (32 images, generate's seed-0 draws, time-scale 1e-5: "
        f"{len(np.unique(end_t))} horizon buckets, {int(inner_m.min())}..{int(inner_m.max())} "
        f"steps a snapshot x 20) in one launch (exactly one counted): K1 vs plain f32 per "
        f"bucket, per-snapshot rel L2 first / mid / last {e_kp[1]:.3e} / {e_kp[10]:.3e} / "
        f"{e_kp[20]:.3e}, worst {e_kp.max():.3e} (bar {K1_VS_PLAIN_BAR:.0e})")

    # the chain, K1's route at n in {512, 1024}
    sol_c = NSVorticitySolver(NSVorticityConfig(resolution=512, viscosity=1e-3, dt=1e-3,
                                                t_end=1.5e-2, n_snapshots=3,
                                                include_initial=True, forcing="fno"))
    w0_c = grf_2d(gdev, sol_c.grid, 2)
    nu_c = torch.tensor([1e-3, 5e-4], device=dev)
    snc.reset_launches()
    k1 = snc.build_batched_traj(sol_c, output="fields")(w0_c, nu_c)
    torch.cuda.synchronize()
    # init 2 + a bootstrap step 3, 3 a step (3 x 5), a fields snapshot 4 (x 4)
    if snc.launches != 5 + 3 * 15 + 4 * 4:
        fail(f"K1 chain 512^2: {snc.launches} launches, not {5 + 3 * 15 + 4 * 4}")
    e_kp = k1_vs_plain(k1, plain(sol_c, w0_c, nu_c, True), "the chain at 512^2")
    say(f"[4] the chain at 512^2 (fields, B=2, 3 x 5 steps, {snc.launches} launches): K1 vs "
        f"plain f32 worst snapshot {e_kp.max():.3e} (bar {K1_VS_PLAIN_BAR:.0e})")

    # -- 5. the main path, through the CLI ----------------------------------------
    snc.reset_launches()
    work = tempfile.mkdtemp(prefix="smoke_", dir=build.BUILD_DIR)
    try:
        cmd = [sys.executable, "-m", "pregen_pde_tpu_torch", "generate",
               "--workload", "ns_spectral", "--n", "32", "--resolution", "256",
               "--batch-size", "32", "--out", os.path.join(work, "ns")]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900)
        gen_s = time.perf_counter() - t0
        if r.returncode != 0:
            fail(f"generate rc {r.returncode}:\n{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
        counts = [json.loads(l)["kernel_launches"] for l in r.stdout.splitlines()
                  if l.startswith('{"kernel_launches"')]
        if len(counts) != 1:
            fail(f"generate printed no launch line:\n{r.stdout[-2000:]}")
        launches = int(counts[0][snc.LIB_NAME])
        data = load_shards(os.path.join(work, "ns"))
        if data.shape != (32, 21, 256, 256, 6):
            fail(f"shard shape {data.shape}")
        if not np.isfinite(data).all():
            fail("shard holds non-finite values")
        if not ((data[..., 4] == 0).all() and (data[..., 5] == 1).all()):
            fail("mask/SDF channels are not 0/1")
        re = data[..., 3]
        if not ((re >= 0).all() and (re <= 1).all()):
            fail("Re_norm outside [0, 1]")
        if launches != 1:
            fail(f"the main path launched K1 {launches} times, not once (one call a batch)")
        say(f"[5] generate --n 32 --resolution 256 --batch-size 32 (time-scale "
            f"5e-4, varied difficulty): {gen_s:.2f} s wall incl. start-up and "
            f"build, {32 / gen_s:.3f} traj/s; K1 launches {launches}; shard "
            f"{data.shape} finite, mask 0, SDF 1, Re_norm in "
            f"[{re.min():.4f}, {re.max():.4f}] | {card}")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # -- 6. north-star throughput, B=32; the resident kernel against the chain -----------
    w0 = grf_2d(gdev, sol.grid, 32)
    times = {}
    outs = {}
    for output in ("vorticity", "fields"):
        fields = output == "fields"
        k1 = snc.build_batched_traj(sol, output=output)
        k1(w0, None, 1)  # warm-up: constants, allocator, FFT plans
        plain(sol, w0, None, fields, steps=1)
        outs[output, "k1"], times[output, "k1"] = timed(lambda: k1(w0))
        outs[output, "plain"], times[output, "plain"] = timed(
            lambda: plain(sol, w0, None, fields))
        err = k1_vs_plain(outs[output, "k1"], outs[output, "plain"],
                          f"north star, {output}, B=32")
        say(f"[6] north star {output} B=32 2500 steps: K1 "
            f"{32 / times[output, 'k1']:.3f} traj/s ({times[output, 'k1'] * 1e3:.1f} ms) | "
            f"plain {32 / times[output, 'plain']:.3f} traj/s "
            f"({times[output, 'plain'] * 1e3:.1f} ms) | K1 vs plain f32 max "
            f"per-snapshot rel L2 {err.max():.3e} | {card}")
    k1c = snc.build_batched_traj(sol, output="fields", route="chain")
    k1c(w0, None, 1)
    out_c, t_chain = timed(lambda: k1c(w0))
    err = k1_vs_plain(out_c, outs["fields", "plain"], "north star, fields, B=32, the chain")
    del out_c
    max_abs = float((outs["fields", "k1"] - outs["fields", "plain"]).abs().max())
    # K1's work: per image-step two packed inverse and one forward complex
    # FFT of n² points (5 n² log2 n² FLOP each; the pointwise algebra is not
    # counted); bytes: w0 and ν in, the (B, 51, n, n, 3) fields out
    n = sol.grid.n
    fft_flop = 3 * 5 * n * n * np.log2(n * n)
    k1_bound = bound(w0.numel() * 4 + outs["fields", "k1"].numel() * 4, 32 * 2500 * fft_flop)
    del outs
    say(f"[6] north star fields B=32: resident {times['fields', 'k1'] * 1e3:.1f} ms | chain "
        f"{t_chain * 1e3:.1f} ms (chain vs plain f32 {err.max():.3e}) | bound "
        f"{k1_bound[0]:.2f} ms ({k1_bound[1]}; {k1_bound[0] / (times['fields', 'k1'] * 1e3):.1%}"
        f" reached) | {card}")

    def us_per_traj_step(fn, B, short=100, long=300):
        def run(steps):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn(steps)
            b.record()
            torch.cuda.synchronize()
            return a.elapsed_time(b)

        run(short)  # warm-up
        return (run(long) - run(short)) / (long - short) / B * 1e3

    sol1 = NSVorticitySolver(NSVorticityConfig(resolution=256, n_snapshots=1,
                                               include_initial=False))
    k1_r = snc.build_batched_traj(sol1)
    k1_c = snc.build_batched_traj(sol1, route="chain")
    per_step = {}
    for B in (1, 8, 32):
        wb = grf_2d(gdev, sol1.grid, B)
        per_step[B] = (us_per_traj_step(lambda k: k1_r(wb, None, k), B),
                       us_per_traj_step(lambda k: k1_c(wb, None, k), B))
        bound_us = fft_flop / F32_FLOPS * 1e6
        say(f"[6] 256^2 B={B}: resident {per_step[B][0]:.3f} us/traj-step | chain "
            f"{per_step[B][1]:.3f} us/traj-step | bound {bound_us:.4f} us/traj-step "
            f"(operations) | {card}")
    # the main path's batch at time-scale 5e-4 as the one call of generate
    msol, w0_m, nu_m, inner_m, _ = main_batch(5e-4)
    k1_m = snc.build_batched_traj(msol, output="fields")
    k1_m(w0_m[:1], nu_m[:1], 1)
    snc.reset_launches()
    out_m, t_m = timed(lambda: k1_m(w0_m, nu_m, inner_m))
    img_steps = int(inner_m.sum()) * msol.cfg.n_snapshots
    m_bound = bound(w0_m.numel() * 4 + out_m.numel() * 4, img_steps * fft_flop)
    if snc.launches != 1 or not torch.isfinite(out_m).all():
        fail(f"the main path's batch: {snc.launches} launches, finite "
             f"{bool(torch.isfinite(out_m).all())}")
    del out_m
    say(f"[6] the main path's batch (32 images, time-scale 5e-4, {img_steps} image-steps, "
        f"{int(inner_m.min()) * 20}..{int(inner_m.max()) * 20} steps a trajectory) as one "
        f"launch: {t_m * 1e3:.1f} ms ({t_m / img_steps * 1e6:.3f} us/image-step) | bound "
        f"{m_bound[0]:.2f} ms ({m_bound[1]}; {m_bound[0] / (t_m * 1e3):.1%} reached) | {card}")
    k1_line = {
        "name": snc.LIB_NAME,
        "route": "cuda",
        "source": "pregen_pde_tpu_torch/csrc/spectral_ns_step.cu",
        "replaces": "pregen_pde_tpu/solvers/spectral_ns_pallas.py:511",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": times["fields", "k1"] * 1e3,
        "plain_ms": times["fields", "plain"] * 1e3,
        "bound_ms": k1_bound[0],
        "bound_by": k1_bound[1],
        "library_ms": None,
        "chain_ms": t_chain * 1e3,
        "main_path_batch_ms": t_m * 1e3,
        "main_path_batch_bound_ms": m_bound[0],
        "us_per_traj_step_resident_chain": {str(B): list(v) for B, v in per_step.items()},
    }
    k2_line, fpo = k2_phases(dev, card, builds[npc.LIB_NAME], t0_build)
    k3_line, k4_line = scot_phases(dev, card, builds, t0_build, fpo, args.parent)
    k3_bwd_line, k4_bwd_line, adamw_line, fpo_regular = train_phases(dev, card, fpo)
    k5a_line, k5b_line = heat_phases(dev, card, builds[stencil.LIB_NAME], t0_build,
                                     builds["k5a_wrong_wrap"])
    pool.shutdown()
    simple_phases(card)
    fno_phases(dev, card, fpo, fpo_regular)
    cno_phases(dev, card, fpo, fpo_regular)
    say(json.dumps({"kernels": [k1_line, k2_line, k3_line, k4_line, k3_bwd_line, k4_bwd_line,
                                k5a_line, k5b_line, adamw_line]}))
    say(card)
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


def k2_phases(dev, card: str, k2_build, t0_build: float) -> dict:
    """Phases 7-11: K2 and the masked-geometry main path. → K2's entry of
    the kernels line."""
    import numpy as np
    import torch

    from pregen_pde_tpu_torch.datagen.masked_ns import (
        MaskedNSConfig, cfl_dt, draw_masked_inputs, plan_rows, sample_masks)
    from pregen_pde_tpu_torch.datagen.writer import load_shards
    from pregen_pde_tpu_torch.kernels import build
    from pregen_pde_tpu_torch.solvers import ns_projection_cuda as npc
    from pregen_pde_tpu_torch.solvers import schedules
    from pregen_pde_tpu_torch.solvers import spectral_ns_cuda as snc
    from pregen_pde_tpu_torch.solvers.ns_projection import (
        ProjectionConfig, ProjectionSolver, parabolic_inlet)
    from pregen_pde_tpu_torch.solvers.validation import (
        convergence_order, run_cavity, run_cylinder)
    from pregen_pde_tpu_torch.utils.parity import per_snapshot_rel_l2

    # -- 7. K2's build (started in phase 2) -----------------------------------------
    k2_build.result()
    build.load(npc.LIB_NAME)
    say(f"[7] built {npc.LIB_NAME} (sm_90a): done {time.perf_counter() - t0_build:.2f} s "
        f"after the parallel builds started (nvcc {build.build_seconds[npc.LIB_NAME]:.2f} s); "
        f"clusters resident at once: " + ", ".join(
            f"{n}^2 {npc.max_active_clusters(n)}" for n in (32, 128, 256)))

    gen = torch.Generator(device=dev).manual_seed(2)

    def inputs(n, domain, B, re):
        cfg = MaskedNSConfig(pipeline="fpo_multi_hole" if domain == "channel"
                             else "ldc_regular", resolution=n)
        masks = sample_masks(gen, cfg, B)
        u_max = np.asarray(re, np.float64) * cfg.viscosity / cfg.length
        dt = min(cfl_dt(cfg, float(u)) for u in u_max)  # the batch's smallest CFL dt
        return masks, torch.as_tensor(u_max, dtype=torch.float32, device=dev), dt

    def k2_vs_plain(k2, p32, label):
        torch.cuda.synchronize()
        if not torch.isfinite(k2).all():
            fail(f"K2 {label}: non-finite output")
        err = per_snapshot_rel_l2(k2, p32)
        if not err.max() <= K2_VS_PLAIN_BAR:
            fail(f"K2 vs plain f32 ({label}): worst snapshot {err.max():.3e} > "
                 f"{K2_VS_PLAIN_BAR:.0e} (per snapshot: {err.tolist()})")
        return err

    # -- 8. K2 against its plain float32 version --------------------------------------
    re_range = lambda B: np.linspace(schedules.RE_MIN, schedules.RE_MAX, B)
    max_abs = None
    for label, n, domain, B, S, inner in (("a", 128, "channel", 8, 20, 50),
                                           ("b", 128, "cavity", 4, 20, 50),
                                           ("c", 256, "channel", 4, 5, 20)):
        sol = ProjectionSolver(ProjectionConfig(resolution=n, domain=domain, n_snapshots=S))
        masks, u_max, dt = inputs(n, domain, B, re_range(B))
        k2 = npc.build_batched_traj(sol)(masks, u_max, inner, dt)
        p32 = sol.make_batched_trajectory_fn()(masks, u_max, inner, dt)
        err = k2_vs_plain(k2, p32, f"({label}) {domain} {n}^2 B={B}")
        if max_abs is None:  # the main path's shape: the kernels line's error
            max_abs = float((k2 - p32).abs().max())
        say(f"[8] ({label}) {domain} {n}^2 B={B} {S} x {inner} steps dt {dt:.5g}: K2 vs "
            f"plain f32 per-snapshot rel L2 first / mid / last {err[1]:.3e} / "
            f"{err[S // 2]:.3e} / {err[S]:.3e}, worst {err.max():.3e} "
            f"(bar {K2_VS_PLAIN_BAR:.0e}); max abs {float((k2 - p32).abs().max()):.3e}")

    def main_plan(time_scale, B=32):
        """The masked main path's batch: fpo_multi_hole masks and Re draws,
        each trajectory at its sub-bucket's dt and inner steps, longest
        first, as generate_masked_ns_batch makes its one call."""
        cfg = MaskedNSConfig(pipeline="fpo_multi_hole", resolution=128, time_scale=time_scale)
        z_re, masks = draw_masked_inputs(gen, cfg, B)
        re = schedules.sample_reynolds(z=z_re, mean=cfg.re_mean, std=cfg.re_std)
        u_max = re.cpu().numpy() * cfg.viscosity / cfg.length
        end_t = schedules.end_time_from_re(re).cpu().numpy() * time_scale
        pr = plan_rows(u_max, end_t, cfg)
        order = np.argsort(-pr["inner"], kind="stable")
        rows = pr["rows"][order]
        return (cfg, masks[torch.as_tensor(rows, device=dev)],
                torch.as_tensor(u_max[rows], dtype=torch.float32, device=dev),
                torch.as_tensor(pr["inner"][order]), torch.as_tensor(pr["dt"][order]),
                len(pr["plan"]), rows)

    cfg_d, masks, u_max, inner, dts, n_sub, _ = main_plan(0.01)
    sol = ProjectionSolver(ProjectionConfig(resolution=128, n_snapshots=cfg_d.n_snapshots))
    npc.reset_launches()
    k2 = npc.build_batched_traj(sol)(masks, u_max, inner, dts)
    if npc.launches != 1:
        fail(f"K2 (d): {npc.launches} launches for one call")
    p32 = sol.make_batched_trajectory_fn()(masks, u_max, inner, dts)
    err = k2_vs_plain(k2, p32, "(d) the main path's plan")
    say(f"[8] (d) fpo_multi_hole 128^2 B=32, the main path's plan at time-scale 0.01 in one "
        f"launch: {n_sub} sub-buckets, dt {float(dts.min()):.5g}..{float(dts.max()):.5g}, "
        f"{int(inner.min())}..{int(inner.max())} steps a snapshot x {cfg_d.n_snapshots}: K2 vs "
        f"plain f32 per-snapshot rel L2 first / mid / last {err[1]:.3e} / "
        f"{err[cfg_d.n_snapshots // 2]:.3e} / {err[-1]:.3e}, worst {err.max():.3e} "
        f"(bar {K2_VS_PLAIN_BAR:.0e})")

    # (e) the masked main path's mode: K2 writing in place into channels 0:3
    # of a 6-channel contract at the plan's rows, then a dt/2 retry of two
    # rows into the same contract. Against the plain version writing the same
    # contract a row is held to the bar, or, where the plain float32 version
    # is itself farther than the bar from float64 (a row whose flow amplifies
    # roundoff over the horizon), K2 no farther from float64 than it
    def row_gap(a, b):  # (B,) the worst snapshot's relative L2 of each row
        num = (a - b).flatten(2).norm(dim=2)
        return (num / b.flatten(2).norm(dim=2).clamp_min(1e-300)).max(dim=1).values.cpu().numpy()

    for B in (32, 128):
        cfg_e, masks, u_max, inner, dts, n_sub, rows = main_plan(0.01, B)
        sol = ProjectionSolver(ProjectionConfig(resolution=128, n_snapshots=cfg_e.n_snapshots))
        k2 = npc.build_batched_traj(sol)
        plain = sol.make_batched_trajectory_fn()
        sel = np.array([1, B - 2])
        sel_d = torch.as_tensor(sel, device=dev)
        retry = (masks[sel_d], u_max[sel_d], inner[sel], dts[sel] / 2)
        rows_d, sel_rows_d = (torch.as_tensor(r, device=dev) for r in (rows, rows[sel]))
        ref = k2(masks, u_max, inner, dts)
        ref2 = k2(*retry)
        gen_c = torch.Generator(device=dev).manual_seed(B)
        blank = torch.randn((B, cfg_e.n_snapshots + 1, 128, 128, 6), generator=gen_c,
                            device=dev)
        contract, contract_p = blank.clone(), blank.clone()
        npc.reset_launches()
        got = k2(masks, u_max, inner, dts, out=contract, out_rows=rows)
        k2(*retry, out=contract, out_rows=rows[sel])
        launched = npc.launches
        plain(masks, u_max, inner, dts, out=contract_p, out_rows=rows)
        plain(*retry, out=contract_p, out_rows=rows[sel])
        want = blank.clone()
        want[rows_d, ..., 0:3] = ref
        want[sel_rows_d, ..., 0:3] = ref2
        torch.cuda.synchronize()
        if got is not contract or launched != 2:
            fail(f"K2 (e) B={B}: {launched} launches for a pass and a retry, or a new tensor")
        if not torch.equal(contract[..., 3:], blank[..., 3:]):
            fail(f"K2 (e) B={B}: channels 3-5 of the contract changed")
        if contract.cpu().numpy().tobytes() != want.cpu().numpy().tobytes():
            bad = (contract != want).flatten(1).any(dim=1).nonzero().flatten().tolist()
            fail(f"K2 (e) B={B}: the contract is not byte-equal to the default route "
                 f"scattered at the plan's rows (rows differing: {bad})")
        del want, ref, ref2
        p64 = torch.empty((B, cfg_e.n_snapshots + 1, 128, 128, 3), dtype=torch.float64,
                          device=dev)
        p64[rows_d] = plain(masks.double(), u_max.double(), inner, dts)
        p64[sel_rows_d] = plain(retry[0].double(), retry[1].double(), *retry[2:])
        k2_uvp, p32_uvp = contract[..., 0:3].double(), contract_p[..., 0:3].double()
        if not (torch.isfinite(k2_uvp).all() and torch.isfinite(p64).all()):
            fail(f"K2 (e) B={B}: non-finite output")
        e32, e64, p32_64 = row_gap(k2_uvp, p32_uvp), row_gap(k2_uvp, p64), row_gap(p32_uvp, p64)
        held = (e32 <= K2_VS_PLAIN_BAR) | (e64 <= p32_64)
        w = int(np.argmax(e32))
        if not held.all():
            fail(f"K2 (e) B={B}: rows {np.nonzero(~held)[0].tolist()} beyond the bar against "
                 f"plain f32 and farther than it from f64 (K2 vs f32 {e32[~held].tolist()}, "
                 f"K2 vs f64 {e64[~held].tolist()}, f32 vs f64 {p32_64[~held].tolist()})")
        say(f"[8] (e) fpo_multi_hole 128^2 B={B}, the main path's plan at time-scale 0.01 "
            f"({n_sub} sub-buckets) written in place into a 6-channel contract at its rows, "
            f"then a dt/2 retry of rows {rows[sel].tolist()}: {launched} launches, byte-equal "
            f"to the default route scattered, channels 3-5 untouched; against plain f32 in "
            f"place worst row rel L2 {e32[w]:.3e} (bar {K2_VS_PLAIN_BAR:.0e}; "
            f"{int((e32 > K2_VS_PLAIN_BAR).sum())} rows beyond it, each no farther from f64 "
            f"than plain f32); that row from f64: K2 {e64[w]:.3e}, plain f32 {p32_64[w]:.3e}")
        del blank, contract, contract_p, p64, k2_uvp, p32_uvp

    # interior divergence on a no-hole channel, inlet-aware
    n = 128
    sol = ProjectionSolver(ProjectionConfig(resolution=n, n_snapshots=5))
    u_max = torch.tensor([5000.0, 10000.0], device=dev) * 1.5e-5 / 2.0
    dt = cfl_dt(MaskedNSConfig(), float(u_max.max()))
    zero = torch.zeros((2, n, n), device=dev)
    dx = sol.cfg.length / n
    inlet = torch.as_tensor(parabolic_inlet(n, 1.0), dtype=torch.float64, device=dev)

    def interior_div(frames):
        f = frames[:, -1].double()
        div = sol.divergence(f[..., 0], f[..., 1], dx)
        div[..., :, 0] -= inlet * u_max.double()[:, None] / dx
        return float(div[..., 2:-2, 2:-2].abs().max())

    d_k2 = interior_div(npc.build_batched_traj(sol)(zero, u_max, 20, dt))
    d_plain = interior_div(sol.make_batched_trajectory_fn()(zero, u_max, 20, dt))
    say(f"[8] no-hole channel 128^2, Re 5000/10000, 5 x 20 steps: interior divergence "
        f"K2 {d_k2:.3e} | plain f32 {d_plain:.3e} (bar: K2 <= 2x plain)")
    if not d_k2 <= 2.0 * d_plain:
        fail(f"K2 interior divergence {d_k2:.3e} > 2x plain {d_plain:.3e}")

    # -- 9. Ghia cavity through K2 --------------------------------------------------------
    for re, (tol_u, tol_v) in GHIA_BARS.items():
        t0 = time.perf_counter()
        r = run_cavity(re, n=128, device=dev)
        secs = time.perf_counter() - t0
        ext = {k: (r[f"{k}_model"], r[f"{k}_ghia"]) for k in ("u_min", "v_min", "v_max")}
        say(f"[9] Ghia Re={re} 128^2 through K2: max dev u {r['max_abs_dev_u']:.4f} "
            f"(bar {tol_u}) v {r['max_abs_dev_v']:.4f} (bar {tol_v}); extrema "
            + ", ".join(f"{k} {m:.4f} vs {g:.4f}" for k, (m, g) in ext.items())
            + f"; {r['steps']} steps dt {r['dt']:.5g} in {secs:.2f} s | {card}")
        if not (r["max_abs_dev_u"] < tol_u and r["max_abs_dev_v"] < tol_v):
            fail(f"Ghia Re={re}: deviations {r['max_abs_dev_u']}, {r['max_abs_dev_v']}")
        for k, (m, g) in ext.items():
            if not abs(m - g) <= 0.08 * abs(g):
                fail(f"Ghia Re={re}: {k} {m} vs {g} beyond 8%")

    # -- 9a. the cylinder and the Richardson triplet through K2 ----------------------------
    npc.reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    r = run_cylinder(150.0, n=128, t_end=80.0, device=dev)
    secs = time.perf_counter() - t0
    cyl_launches = npc.launches
    say(f"[9a] cylinder Re_d 150 128^2 t_end 80 through K2: St {r['strouhal']:.4f} (band "
        f"{CYLINDER_BANDS['strouhal']}), C_d {r['cd_mean']:.4f} (band "
        f"{CYLINDER_BANDS['cd_mean']}), probe amplitude {r['shedding_amplitude']:.4f} (bar > "
        f"{CYLINDER_BANDS['amplitude']}); "
        f"{r['steps']} steps dt {r['dt']:.5g}, a frame every step, {cyl_launches} K2 launch, "
        f"{secs:.2f} s, peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB | {card}")
    lo_st, hi_st = CYLINDER_BANDS["strouhal"]
    lo_cd, hi_cd = CYLINDER_BANDS["cd_mean"]
    if not (cyl_launches == 1 and r["steps"] == 34000 and lo_st < r["strouhal"] < hi_st
            and lo_cd < r["cd_mean"] < hi_cd
            and r["shedding_amplitude"] > CYLINDER_BANDS["amplitude"]):
        fail(f"cylinder through K2: {cyl_launches} launches, {r}")
    npc.reset_launches()
    t0 = time.perf_counter()
    c = convergence_order(device=dev)
    secs = time.perf_counter() - t0
    conv_launches = npc.launches
    say(f"[9a] grid convergence 32/64/128 through K2: order {c['order']:.4f} (bar > "
        f"{CONVERGENCE_ORDER_BAR}), e_coarse {c['e_coarse']:.4e}, e_fine {c['e_fine']:.4e}, "
        f"{c['steps']} steps a grid, {conv_launches} K2 launches, {secs:.2f} s | {card}")
    if not (conv_launches == 3 and c["order"] > CONVERGENCE_ORDER_BAR):
        fail(f"grid convergence through K2: {conv_launches} launches, {c}")

    # -- 10. the masked main path, through the CLI -----------------------------------------
    snc.reset_launches()
    npc.reset_launches()
    k2_launches = 0
    fpo = None  # the fpo_multi_hole shard, evaluated by phase 16
    work = tempfile.mkdtemp(prefix="smoke_masked_", dir=build.BUILD_DIR)
    try:
        for workload, n_traj in (("fpo_multi_hole", 32), ("ldc_regular", 8)):
            out = os.path.join(work, workload)
            cmd = [sys.executable, "-m", "pregen_pde_tpu_torch", "generate", "--workload",
                   workload, "--n", str(n_traj), "--resolution", "128", "--batch-size",
                   str(n_traj), "--time-scale", "1.0", "--out", out]
            t0 = time.perf_counter()
            r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
            wall = time.perf_counter() - t0
            if r.returncode != 0:
                fail(f"generate {workload} rc {r.returncode}:\n{r.stdout[-2000:]}\n"
                     f"{r.stderr[-4000:]}")
            lines = [json.loads(l) for l in r.stdout.splitlines() if l.startswith("{")]
            count = [l["kernel_launches"][npc.LIB_NAME] for l in lines
                     if "kernel_launches" in l]
            stats = [l["masked_ns"] for l in lines if "masked_ns" in l]
            if len(count) != 1 or len(stats) != 1:
                fail(f"generate {workload} printed no launch/stats line:\n{r.stdout[-2000:]}")
            if count[0] <= 0 or count[0] != stats[0]["calls"]:
                fail(f"the {workload} main path launched K2 {count[0]} times, not once a "
                     f"batch and once a retry attempt ({stats[0]['calls']} calls)")
            k2_launches += count[0]
            data = load_shards(out)
            check_masked_shard(data, workload, n_traj, parabolic_inlet, schedules)
            if workload == "fpo_multi_hole":
                fpo = data
            say(f"[10] generate --workload {workload} --n {n_traj} --resolution 128 "
                f"--batch-size {n_traj} --time-scale 1.0: {wall:.2f} s wall incl. start-up "
                f"and build, {n_traj / wall:.3f} traj/s; {stats[0]['sub_buckets']} "
                f"sub-buckets, {stats[0]['retries']} retries "
                f"({stats[0]['retried_trajectories']} trajectories); K2 launches "
                f"{count[0]} = calls (batches + retry attempts) {stats[0]['calls']}; shard {data.shape} finite, mask/SDF/Re/"
                f"{'inlet' if workload != 'ldc_regular' else 'lid'} checks passed | {card}")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # -- 11. K2 time against the plain version -----------------------------------------------
    # 1000 steps at Re 5000's CFL dt are 60 time units, past the time over
    # which the shedding flow keeps float32 roundoff small: the end states
    # are printed against the plain version and against K2 with u_max moved
    # by one ulp, for information; phase 8 holds K2 to its bar.
    sol = ProjectionSolver(ProjectionConfig(resolution=128, n_snapshots=1))
    k2 = npc.build_batched_traj(sol)
    p = sol.make_batched_trajectory_fn()
    steps = 1000
    res = {}
    for B in (1, 8, 32):
        masks, u_max, dt = inputs(128, "channel", B, np.full(B, 5000.0))
        k2(masks, u_max, 10, dt)  # warm-up: constants, allocator
        p(masks, u_max, 2, dt)
        out_k2, t_k2 = timed(lambda: k2(masks, u_max, steps, dt))
        out_p, t_p = timed(lambda: p(masks, u_max, steps, dt))
        nudged = k2(masks, u_max * (1.0 + 2.0 ** -23), steps, dt)
        res[B] = (t_k2, t_p)
        say(f"[11] 128^2 fpo_multi_hole B={B} {steps} steps: K2 "
            f"{t_k2 / (steps * B) * 1e6:.3f} us/traj-step ({t_k2 * 1e3:.2f} ms) | plain "
            f"{t_p / (steps * B) * 1e6:.3f} us/traj-step ({t_p * 1e3:.1f} ms) | end state, "
            f"worst rel L2: K2 vs plain f32 {per_snapshot_rel_l2(out_k2, out_p)[1]:.3e}, "
            f"K2 vs K2 with u_max + 1 ulp {per_snapshot_rel_l2(out_k2, nudged)[1]:.3e} "
            f"(information) | {card}")
    # the main path's batch at time-scale 1.0 (the reference's horizons) as
    # the one call generate_masked_ns_batch makes; its longest trajectory
    # sets the time while the card holds every image's cluster at once
    cfg_m, masks, u_max, inner, dts, n_sub, _ = main_plan(1.0)
    sol_m = ProjectionSolver(ProjectionConfig(resolution=128, n_snapshots=cfg_m.n_snapshots))
    k2_m = npc.build_batched_traj(sol_m)
    _, t_m = timed(lambda: k2_m(masks, u_max, inner, dts))
    img_steps = int(inner.sum()) * cfg_m.n_snapshots
    longest = int(inner.max()) * cfg_m.n_snapshots
    say(f"[11] the main path's plan, fpo_multi_hole 128^2 B=32 time-scale 1.0, {n_sub} "
        f"sub-buckets in one launch: {t_m:.3f} s for {img_steps} trajectory-steps "
        f"({t_m / img_steps * 1e6:.3f} us/traj-step), longest trajectory {longest} steps "
        f"({t_m / longest * 1e6:.3f} us a step of it) | {card}")
    t_k2, t_p = res[32]
    # K2's work at B = 32: four (n x n)(n x n) products per image-step
    # (8 n^3 FLOP; the stencils are not counted); bytes: masks, u_max, dt and
    # the steps in, the (B, 2, n, n, 3) frames out. Bounds: float32 at 67
    # TFLOP/s, and the 3xTF32 route's 3 x 8 n^3 at 495 TFLOP/s
    k2_bytes = 32 * 128 * 128 * 4 + 3 * 32 * 4 + 32 * 2 * 128 * 128 * 3 * 4
    k2_bound = bound(k2_bytes, 32 * steps * 8 * 128**3)
    k2_bound_tf32 = max(k2_bytes / HBM_BYTES_PER_S,
                        3 * 32 * steps * 8 * 128**3 / TF32_FLOPS) * 1e3
    say(f"[11] K2 at B=32, {steps} steps: {t_k2 * 1e3:.3f} ms against its float32 bound "
        f"{k2_bound[0]:.3f} ms ({k2_bound[0] / (t_k2 * 1e3):.1%}) and its 3xTF32 bound "
        f"{k2_bound_tf32:.3f} ms ({k2_bound_tf32 / (t_k2 * 1e3):.1%}) | {card}")
    return {
        "name": npc.LIB_NAME,
        "route": "cuda",
        "source": "pregen_pde_tpu_torch/csrc/ns_projection_step.cu",
        "replaces": "pregen_pde_tpu/solvers/ns_projection_pallas.py:55",
        "launches": k2_launches,
        "max_abs_err": max_abs,
        "ms": t_k2 * 1e3,
        "plain_ms": t_p * 1e3,
        "bound_ms": k2_bound[0],
        "bound_by": k2_bound[1],
        "bound_3xtf32_ms": k2_bound_tf32,
        "library_ms": None,
        "validation_launches": {"cylinder": cyl_launches, "convergence_order": conv_launches},
    }, fpo


def scot_phases(dev, card: str, builds: dict, t0_build: float, fpo,
                parent_tree: str | None = None) -> tuple[dict, dict]:
    """Phases 12-16: K3, K4 and the scOT evaluate main path. → K3's and
    K4's entries of the kernels line (at the main path's shapes)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from pregen_pde_tpu_torch.__main__ import _evaluate_ckpt
    from pregen_pde_tpu_torch.kernels import build
    from pregen_pde_tpu_torch.models.scot import shift_attn_mask
    from pregen_pde_tpu_torch.ops import swin_block as sb
    from pregen_pde_tpu_torch.ops import window_attention as wa
    from pregen_pde_tpu_torch.profile_scot import ROUTES, event_ms, seeded_scot, set_route
    from pregen_pde_tpu_torch.utils.parity import rel_l2

    # -- 12. K3's and K4's builds (started in phase 2) -------------------------------------
    for name in (sb.LIB_NAME, wa.LIB_NAME):
        builds[name].result()
        build.load(name)
        say(f"[12] built {name} (sm_90a): done {time.perf_counter() - t0_build:.2f} s after "
            f"the parallel builds started (nvcc {build.build_seconds[name]:.2f} s)")

    gen = torch.Generator(device=dev).manual_seed(3)
    rn = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    mask0 = torch.from_numpy(shift_attn_mask(32, 32, 16, 8)).to(dev)  # stage 0: nw = 4

    def bias_of(h, n, nw):
        b = 16.0 * torch.sigmoid(rn(1, h, n, n))
        return b + mask0[:, None] if nw > 1 else b

    # -- 13. K4's forward in the model's layout against its plain version --------------------
    # each case: per-output bars over the floors, one launch a call and nothing
    # else allocated; events (with the wrapper), device time, the wrapper's
    # host µs, plain, SDPA (the library yardstick) and the parent's kernel
    # (--parent: its wrapper copies the operands first) in turns
    parent = parent_k4(parent_tree, builds["parent_k4"].result()) if parent_tree else None
    k4_line = None
    g13 = torch.Generator(device=dev).manual_seed(3)
    for label, nb, h, n, hd, nw in K4_FWD_CASES:
        q, k, v, bias = k4_model_inputs(g13, nb, h, n, hd, nw)
        call = lambda: wa.window_attention(q, k, v, bias)
        with torch.inference_mode():
            wa.reset_launches()
            out, lse = wa._forward_kernel(q, k, v, bias, save=True)
            torch.cuda.synchronize()
            live = lambda: torch.cuda.memory_stats()["allocation.all.current"]
            before, n_before = torch.cuda.memory_allocated(), live()
            got = call()
            torch.cuda.synchronize()
            kept, n_kept = torch.cuda.memory_allocated() - before, live() - n_before
            launched = wa.launches
            ref, lref = wa.window_attention_lse_plain(q, k, v, bias)
            r64, l64 = wa.window_attention_lse_plain(*(t.double() for t in (q, k, v, bias)))
            errs = {"out": rel_l2(out, ref), "lse": rel_l2(lse, lref)}
            floors = {"out": rel_l2(ref, r64), "lse": rel_l2(lref, l64)}
            over = {m: e for m, e in errs.items() if not e <= K4_FWD_VS_PLAIN_BARS[m]}
            if not (torch.isfinite(out).all() and torch.isfinite(lse).all()) or over:
                fail(f"K4 vs plain ({label}): over their bars {json.dumps(over)} (all "
                     f"{json.dumps(errs)}; bars {json.dumps(K4_FWD_VS_PLAIN_BARS)})")
            # the model's permute(0, 2, 1, 3).reshape(nb, n, c) of out is a view
            merged = got.permute(0, 2, 1, 3).reshape(nb, n, h * hd)
            # one allocation kept, out's: the caching allocator rounds a block up
            # to 512 bytes, and a large block (> 1 MB) reused from its cache
            # keeps a tail under 1 MB unsplit
            block = (got.numel() * 4 + 511) // 512 * 512
            if not (launched == 2 and torch.equal(got, out) and merged.data_ptr() == got.data_ptr()
                    and n_kept == 1 and block <= kept < block + 2 ** 20):
                fail(f"K4 ({label}): {launched} launches for two calls, a rerun equal "
                     f"{torch.equal(got, out)}, out merged in place "
                     f"{merged.data_ptr() == got.data_ptr()}, {n_kept} allocations and "
                     f"{kept} bytes kept for a {block}-byte out")
            qv, kv, vv = (t.view(nb // nw, nw, h, n, hd) for t in (q, k, v))
            sdpa = lambda: F.scaled_dot_product_attention(qv, kv, vv, attn_mask=bias, scale=1.0)
            lib_err = rel_l2(sdpa().reshape(nb, h, n, hd), ref)
            reps = 50 if n >= 256 else 200
            t = {}
            for side in ("change", "parent", "parent", "change") if parent else ("change",):
                fn = call if side == "change" else lambda: parent.window_attention(q, k, v, bias)
                t.setdefault(side, []).append((event_ms(fn, reps), device_ms(fn, 20)))
            t_k, d_k = (min(x) for x in zip(*t["change"]))
            h_us = host_us(call)
            t_p = event_ms(lambda: wa.window_attention_plain(q, k, v, bias), 20)
            t_l = event_ms(sdpa, 20)
            if parent:
                p_err = rel_l2(parent.window_attention(q, k, v, bias), ref)
                t_par, d_par = (min(x) for x in zip(*t["parent"]))
                h_par = host_us(lambda: parent.window_attention(q, k, v, bias))
        flops = 4.0 * nb * h * n * n * hd
        b_ms, b_by = bound(4 * (4 * q.numel() + bias.numel()), flops)
        b3_ms = max(4 * (4 * q.numel() + bias.numel()) / HBM_BYTES_PER_S,
                    3 * flops / TF32_FLOPS) * 1e3
        say(f"[13] K4 {label} (nb {nb}, h {h}, n {n}, hd {hd}, nw {nw}; the model's layout, "
            f"{'small' if n <= wa.SMALL_MAX_N else 'wide'} route): rel L2 vs plain "
            + ", ".join(f"{m} {errs[m]:.3e} (bar {K4_FWD_VS_PLAIN_BARS[m]:.3g}, floor "
                        f"{floors[m]:.2e})" for m in errs)
            + f", SDPA vs plain {lib_err:.3e}; 1 launch a call, only out allocated, merged "
            f"in place; K4 {t_k:.4f} ms (device {d_k:.4f} ms, the wrapper's host "
            f"{h_us:.1f} us) | plain {t_p:.4f} ms | SDPA {t_l:.4f} ms | bound {b_ms:.4f} ms "
            f"({b_by}), 3xTF32 {b3_ms:.4f} ms | {card}")
        if parent:
            say(f"[13]   parent K4 ({parent_tree}) on the same inputs, in turns: "
                f"{t_par:.4f} ms (device {d_par:.4f} ms, its copies included; its wrapper's host "
                f"{h_par:.1f} us; rel L2 vs plain {p_err:.3e}); this tree {t_k:.4f} ms (device "
                f"{d_k:.4f} ms) | {card}")
        if label.endswith("(main path)"):
            k4_line = {"name": wa.LIB_NAME, "route": "cuda",
                       "source": "pregen_pde_tpu_torch/csrc/window_attention.cu",
                       "replaces": "pregen_pde_tpu/ops/window_attention.py:136",
                       "max_abs_err": float((out - ref).abs().max()), "ms": t_k,
                       "device_ms": d_k, "host_us": h_us, "plain_ms": t_p, "bound_ms": b_ms,
                       "bound_by": b_by, "bound_3xtf32_ms": b3_ms, "library_ms": t_l}
        del q, k, v, bias, out, lse, got, ref, r64

    # -- 14. K3 against its plain version ----------------------------------------------------------
    k3_line = None
    for label, B, hw, c, heads, ws, nw in (("stage 0 shifted, B=16", 16, 32, 96, 3, 16, 4),
                                           ("stage 0, B=16", 16, 32, 96, 3, 16, 1),
                                           ("stage 1, B=16", 16, 16, 192, 6, 16, 1),
                                           ("stage 2, B=16", 16, 8, 384, 12, 8, 1),
                                           ("stage 1, B=3", 3, 16, 192, 6, 16, 1),
                                           ("stage 2, B=3", 3, 8, 384, 12, 8, 1),
                                           ("stage 0 shifted, B=3 (main path)", 3, 32, 96, 3, 16,
                                            4)):
        n, hd, f = ws * ws, c // heads, 4 * c
        w = lambda *shape: 0.02 * rn(*shape) * (c ** 0.5)
        args = (rn(B, hw, hw, c), bias_of(heads, n, nw)[:nw], 1.0 + 9.0 * torch.rand(
                    heads, generator=gen, device=dev),
                w(heads, c, hd), w(heads, 1, hd), w(heads, c, hd), w(heads, c, hd),
                w(heads, 1, hd), w(heads, hd, c), w(1, c), 1.0 + w(B, c), w(B, c), w(c, f),
                w(1, f), w(f, c), w(1, c), 1.0 + w(B, c), w(B, c), torch.ones(B, 2, device=dev))
        lin = k3_linear(sb, args)  # the layouts the model passes
        with torch.inference_mode():
            got = sb.swin_block(*lin, heads, ws, 1e-5)
            ref = sb.swin_block_plain(*args, heads, ws, 1e-5)
            err = rel_l2(got, ref)
            if not (torch.isfinite(got).all() and err <= K3_VS_PLAIN_BAR):
                fail(f"K3 vs plain ({label}): rel L2 {err:.3e} > {K3_VS_PLAIN_BAR:.1e}")
            # inference mode saves nothing: the call leaves only y allocated
            y = None
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            y = sb.swin_block(*lin, heads, ws, 1e-5)
            torch.cuda.synchronize()
            kept = torch.cuda.memory_allocated() - before
            t_k = event_ms(lambda: sb.swin_block(*lin, heads, ws, 1e-5), 20)
            d_k = device_ms(lambda: sb.swin_block(*lin, heads, ws, 1e-5), 20)
            t_p = event_ms(lambda: sb.swin_block_fwd_plain(*lin, heads, ws, 1e-5), 20)
        # under autograd the same y, and the saved tensors besides
        ins = [t.clone().requires_grad_() if t.is_floating_point() else t for t in lin]
        y_grad = sb.swin_block(*ins, heads, ws, 1e-5)
        # y rounded up to the caching allocator's block (2 MiB above 1 MiB);
        # the saved tensors would be more than ten times y
        y_bytes = y.numel() * y.element_size()
        if not (torch.equal(y, got) and torch.equal(y_grad.detach(), got)
                and y_bytes <= kept <= max(2 * y_bytes, y_bytes + 2 ** 21)):
            fail(f"K3 ({label}): inference mode kept {kept} bytes (y is {y_bytes}), or y "
                 f"differs between calls or under autograd")
        del ins, y_grad
        M = B * hw * hw
        # x in, y out, the weights, the bias and the per-sample affines, once
        nbytes = 4 * (2 * M * c + 4 * c * c + 2 * c * f + 5 * c + f + args[1].numel() + 4 * B * c)
        flops = 2.0 * M * c * (3 * c + c + 2 * f) + 4.0 * M * n * c
        b_ms, b_by = bound(nbytes, flops)
        b3_ms = 3 * flops / TF32_FLOPS * 1e3
        say(f"[14] K3 {label} ({B}, {hw}², C {c}, {heads} heads, ws {ws}, nw {nw}): rel L2 vs "
            f"plain {err:.3e} (bar {K3_VS_PLAIN_BAR:.0e}); inference mode kept only y; K3 "
            f"{t_k:.4f} ms (its kernels' device time {d_k:.4f} ms) | plain {t_p:.4f} ms | bound "
            f"{b_ms:.4f} ms ({b_by}), 3xTF32 "
            f"{b3_ms:.4f} ms | {card}")
        if label.endswith("(main path)"):
            k3_line = {"name": sb.LIB_NAME, "route": "cuda",
                       "source": "pregen_pde_tpu_torch/csrc/swin_block.cu",
                       "replaces": "pregen_pde_tpu/ops/swin_block.py:229",
                       "max_abs_err": float((got - ref).abs().max()), "ms": t_k,
                       "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
                       "bound_3xtf32_ms": b3_ms, "library_ms": None}

    # -- 15. the whole scOT-B forward in three routes ------------------------------------------------
    model = seeded_scot("scot-B", 128, seed=0)
    n_params = sum(prm.numel() for prm in model.parameters())
    work = tempfile.mkdtemp(prefix="smoke_scot_", dir=build.BUILD_DIR)
    try:
        ckpt = os.path.join(work, "scot_b_seed0.pt")
        torch.save(model.state_dict(), ckpt)
        model = model.to(dev).eval()
        x = rn(16, 128, 128, 7)
        t = torch.rand(16, generator=gen, device=dev)
        # (K3 kernels, K4 launches) of one forward in each route
        wants = {"auto": (48 * sb.KERNELS_PER_CALL, 16), "attention-only": (0, 64),
                 "plain": (0, 0)}
        outs, times, dev_times = {}, {}, {}
        import pregen_pde_tpu_torch.models.scot as scot_mod

        calls = {}  # each K4 route's attention calls of one forward, as the model made them

        def recording(q, k, v, bias):
            calls[route].append((q, k, v, bias))
            return wa.window_attention(q, k, v, bias)

        for route in ROUTES:
            set_route(model, route)
            want = wants[route]
            with torch.inference_mode():
                sb.reset_launches()
                wa.reset_launches()
                calls[route] = []
                scot_mod.window_attention = recording
                try:
                    outs[route] = model(x, t)
                finally:
                    scot_mod.window_attention = wa.window_attention
                torch.cuda.synchronize()
                got = (sb.launches, wa.launches)
                if got != want:
                    fail(f"scOT-B {route}: one forward launched (K3, K4) = {got}, want {want}")
                times[route] = event_ms(lambda: model(x, t), 5)
                dev_times[route] = device_ms(lambda: model(x, t), 3)
            if not torch.isfinite(outs[route]).all():
                fail(f"scOT-B {route}: non-finite output")
        # inside a K4 attention call no kernel runs but K4's: each recorded
        # call again, on the model's own operands, three times
        for route in ("auto", "attention-only"):
            def again():
                wa.reset_launches()
                with torch.inference_mode():
                    for _ in range(3):
                        for args_ in calls[route]:
                            wa.window_attention(*args_)

            want = 3 * len(calls[route])
            names, enqueued, tries = device_kernel_names(again, lambda: wa.launches, "attn_fwd")
            if enqueued != want:
                fail(f"scOT-B {route}: 3 x its {len(calls[route])} K4 calls counted {enqueued} "
                     f"launches, not {want}")
            if len(names) < want and all("attn_fwd" in nm for nm in names):
                fail(f"scOT-B {route}: the profiler recorded {len(names)} of the {want} K4 "
                     f"kernels enqueued in each of {tries} sessions")
            if len(names) != want or not all("attn_fwd" in nm for nm in names):
                fail(f"scOT-B {route}: 3 x its {len(calls[route])} K4 calls ran {len(names)} "
                     f"kernels: {sorted(set(names))}")
            kinds = sorted({nm.split("<")[0].split("::")[-1] for nm in names})
            say(f"[15] scOT-B {route}: 3 x its {len(calls[route])} K4 attention calls ran "
                f"{len(names)} kernels, all K4's ({', '.join(kinds)}): no copy (profiled "
                f"{tries} time{'s' if tries > 1 else ''})")
        del calls
        for route in ("auto", "attention-only"):
            err = rel_l2(outs[route], outs["plain"])
            say(f"[15] scOT-B ({n_params / 1e6:.1f} M params) 128², B=16, {route}: rel L2 vs "
                f"plain {err:.3e} (bar {SCOT_VS_PLAIN_BAR:.1e}); launches of one forward (K3 "
                f"kernels, K4) {wants[route]}")
            if not err <= SCOT_VS_PLAIN_BAR:
                fail(f"scOT-B {route} vs plain: rel L2 {err:.3e} > {SCOT_VS_PLAIN_BAR:.1e}")
        say("[15] scOT-B 128², B=16, one forward: " + " | ".join(
            f"{r} {ms:.3f} ms (device {dev_times[r]:.3f} ms)" for r, ms in times.items())
            + f" | {card}")
        del model, outs

        # -- 16. the main path: evaluate through the CLI ------------------------------------------
        data_path = os.path.join(work, "fpo_multi_hole.npy")
        np.save(data_path, fpo)
        cmd = [sys.executable, "-m", "pregen_pde_tpu_torch", "evaluate", "--model", "scot-B",
               "--data", data_path, "--ckpt", ckpt, "--batch-size", "16"]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if r.returncode != 0:
            fail(f"evaluate rc {r.returncode}:\n{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
        lines = [json.loads(l) for l in r.stdout.splitlines() if l.startswith("{")]
        counts = [l["kernel_launches"] for l in lines if "kernel_launches" in l]
        results = [l for l in lines if "patterns" in l]
        if len(counts) != 1 or len(results) != 1:
            fail(f"evaluate printed no launch or result line:\n{r.stdout[-2000:]}")
        res, counts = results[0], counts[0]
        # 3 test trajectories in one batch: 1 + 4 + 7 pattern steps + 7 accumulation steps
        forwards = 19
        want = {sb.LIB_NAME: forwards * 48 * sb.KERNELS_PER_CALL, wa.LIB_NAME: forwards * 16}
        if counts != want:
            fail(f"evaluate launches {counts}, want {want}")
        values = flat_numbers(res)
        if (list(res["patterns"]) != ["[7]", "[2, 2, 2, 1]", "[1, 1, 1, 1, 1, 1, 1]"]
                or len(res["accumulation"]) != 7 or not np.isfinite(values).all()):
            fail(f"evaluate result malformed or non-finite: {json.dumps(res)[:2000]}")
        with torch.inference_mode():
            plain = _evaluate_ckpt(ckpt, "scot-B", fpo, "[7];[2,2,2,1];[1,1,1,1,1,1,1]", 16,
                                   dev, impl="plain")
        rel = np.abs(values - flat_numbers(plain)) / np.maximum(np.abs(flat_numbers(plain)),
                                                                 1e-30)
        say(f"[16] evaluate --model scot-B on fpo_multi_hole (32 traj, 21 frames, 128²; 3 test "
            f"trajectories): {wall:.2f} s wall incl. start-up and loading; launches {counts}; "
            f"[7] median rel {res['patterns']['[7]']['median_rel_%']:.4f} %, accumulation step 7 "
            f"median {res['accumulation'][6]['median_rel_%']:.4f} %; kernels vs in-process "
            f"plain route: worst relative difference of the {values.size} reported numbers "
            f"{rel.max():.3e} (bar {EVAL_VS_PLAIN_RTOL:.0e}) | {card}")
        if not rel.max() <= EVAL_VS_PLAIN_RTOL:
            fail(f"evaluate through the kernels vs the plain route: {rel.max():.3e} > "
                 f"{EVAL_VS_PLAIN_RTOL:.0e}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    k3_line["launches"] = counts[sb.LIB_NAME]
    k4_line["launches"] = counts[wa.LIB_NAME]
    return k3_line, k4_line


def train_phases(dev, card: str, fpo) -> tuple[dict, dict, dict, object]:
    """Phases 17-21: the backward kernels of K4 and K3, one scOT-B train
    step in two routes, the fused AdamW, and the ``train`` and ``mix-sweep``
    main paths. → the kernels line's entries of K3's and K4's backward and
    of the AdamW, and phase 21's ``fpo_regular`` shard."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from pregen_pde_tpu_torch.kernels import build
    from pregen_pde_tpu_torch.models.scot import shift_attn_mask
    from pregen_pde_tpu_torch.ops import adamw
    from pregen_pde_tpu_torch.ops import swin_block as sb
    from pregen_pde_tpu_torch.ops import window_attention as wa
    from pregen_pde_tpu_torch.profile_scot import event_ms, seeded_scot, set_route
    from pregen_pde_tpu_torch.training.losses import relative_lp_loss
    from pregen_pde_tpu_torch.utils.parity import rel_l2

    gen = torch.Generator(device=dev).manual_seed(4)
    rn = lambda *shape: torch.randn(*shape, generator=gen, device=dev)
    mask0 = torch.from_numpy(shift_attn_mask(32, 32, 16, 8)).to(dev)  # stage 0: nw = 4

    # -- 17. K4 backward against its plain version; SDPA's backward as the yardstick ----------
    k4_line = None
    for label, nb, h, n, hd, nw in (("stage 3, B=16 (main path)", 16, 24, 16, 32, 1),
                                    ("stage 0 shifted, B=16", 64, 3, 256, 32, 4)):
        q = F.normalize(rn(nb, h, n, hd), dim=-1) * 10.0
        k = F.normalize(rn(nb, h, n, hd), dim=-1)
        v, do = rn(nb, h, n, hd), rn(nb, h, n, hd)
        bias = 16.0 * torch.sigmoid(rn(1, h, n, n))
        bias = bias + mask0[:, None] if nw > 1 else bias
        out, lse = wa._forward_kernel(q, k, v, bias, save=True)
        route = wa.bwd_route(n)
        wa.reset_launches()
        got = wa._backward_kernel(q, k, v, bias, out, lse, do)
        torch.cuda.synchronize()
        launched = wa.bwd_launches
        again = wa._backward_kernel(q, k, v, bias, out, lse, do)
        ref = wa.window_attention_bwd_plain(q, k, v, bias, do)
        ref64 = wa.window_attention_bwd_plain(*(t.double() for t in (q, k, v, bias, do)))
        torch.cuda.synchronize()
        names = tuple(K4_BWD_VS_PLAIN_BARS)
        errs = {m: rel_l2(a, b) for m, a, b in zip(names, got, ref)}
        floors = {m: rel_l2(a, b) for m, a, b in zip(names, ref, ref64)}
        over = {m: e for m, e in errs.items() if not e <= K4_BWD_VS_PLAIN_BARS[m]}
        if not all(torch.isfinite(g).all() for g in got) or over:
            fail(f"K4 backward vs plain ({label}): over their bars {json.dumps(over)} (all "
                 f"{json.dumps(errs)}; bars {json.dumps(K4_BWD_VS_PLAIN_BARS)})")
        if launched != wa.BWD_KERNELS_PER_CALL[route]:
            fail(f"K4 backward ({label}, {route} route): {launched} launches, want "
                 f"{wa.BWD_KERNELS_PER_CALL[route]}")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"K4 backward ({label}): a rerun differs (not bitwise repeatable)")
        lead = lambda t: t.detach().reshape(nb // nw, nw, h, n, -1).requires_grad_()
        qv, kv, vv = lead(q), lead(k), lead(v)
        bias_l = bias.detach().clone().requires_grad_()
        lib_out = F.scaled_dot_product_attention(qv, kv, vv, attn_mask=bias_l, scale=1.0)
        lib_in, dov = (qv, kv, vv, bias_l), do.reshape(lib_out.shape)
        lib = torch.autograd.grad(lib_out, lib_in, dov, retain_graph=True, allow_unused=True)
        lib_bias = "with" if lib[3] is not None else "WITHOUT"
        reps = 20 if n == 256 else 100
        kernel = lambda: wa._backward_kernel(q, k, v, bias, out, lse, do)
        t_k = event_ms(kernel, reps)
        d_k = device_ms(kernel, 20)
        t_p = event_ms(lambda: wa.window_attention_bwd_plain(q, k, v, bias, do), reps)
        t_l = event_ms(lambda: torch.autograd.grad(lib_out, lib_in, dov, retain_graph=True,
                                                   allow_unused=True), reps)
        # q, k, v, o, do read and dq, dk, dv written, the bias and lse read and
        # dbias written; the logits once, then dv, dp, dq, dk: 10 n² hd a (row, head)
        flops = 10.0 * nb * h * n * n * hd
        b_ms, b_by = bound(4 * (8 * q.numel() + 2 * bias.numel() + lse.numel()), flops)
        b3_ms = 3 * flops / TF32_FLOPS * 1e3
        say(f"[17] K4 backward {label} (nb {nb}, h {h}, n {n}, hd {hd}, nw {nw}; {route} route, "
            f"{launched} launch{'es' if launched > 1 else ''}): rel L2 vs plain "
            + ", ".join(f"{m} {errs[m]:.3e} (bar {K4_BWD_VS_PLAIN_BARS[m]:.1e}, floor "
                        f"{floors[m]:.2e})" for m in names)
            + f"; bitwise repeatable; K4 bwd {t_k:.4f} ms (device {d_k:.4f} ms) | plain "
            f"{t_p:.4f} ms | SDPA backward ({lib_bias} a bias gradient) {t_l:.4f} ms | bound "
            f"{b_ms:.4f} ms ({b_by}), 3xTF32 {b3_ms:.4f} ms | {card}")
        if k4_line is None:
            k4_line = {"name": f"{wa.LIB_NAME}_bwd", "route": "cuda",
                       "source": "pregen_pde_tpu_torch/csrc/window_attention.cu",
                       "replaces": "pregen_pde_tpu/ops/window_attention.py:160",
                       "max_abs_err": max(float((a - b).abs().max()) for a, b in zip(got, ref)),
                       "ms": t_k, "device_ms": d_k, "plain_ms": t_p, "bound_ms": b_ms,
                       "bound_by": b_by, "bound_3xtf32_ms": b3_ms, "library_ms": t_l}
        del got, again, ref, ref64, lib, lib_out

    # -- 18. K3 backward against its plain version --------------------------------------------------
    # each case draws its inputs from its own generator (seed 4), the inputs
    # on which the bars' floors were measured
    k3_line = None
    for label, B, hw, c, heads, ws, nw in (("stage 0 shifted, B=16 (main path)", 16, 32, 96, 3,
                                            16, 4),
                                           ("stage 1, B=16", 16, 16, 192, 6, 16, 1),
                                           ("stage 2, B=16", 16, 8, 384, 12, 8, 1),
                                           ("stage 0 shifted, B=3", 3, 32, 96, 3, 16, 4)):
        g18 = torch.Generator(device=dev).manual_seed(4)
        rk = lambda *shape: torch.randn(*shape, generator=g18, device=dev)
        n, hd, f = ws * ws, c // heads, 4 * c
        w = lambda *shape: 0.02 * rk(*shape) * (c ** 0.5)
        bias = 16.0 * torch.sigmoid(rk(1, heads, n, n))
        args = (rk(B, hw, hw, c), bias + mask0[:, None] if nw > 1 else bias,
                1.0 + 9.0 * torch.rand(heads, generator=g18, device=dev),
                w(heads, c, hd), w(heads, 1, hd), w(heads, c, hd), w(heads, c, hd),
                w(heads, 1, hd), w(heads, hd, c), w(1, c), 1.0 + w(B, c), w(B, c), w(c, f),
                w(1, f), w(f, c), w(1, c), 1.0 + w(B, c), w(B, c),
                (torch.rand(B, 2, generator=g18, device=dev) > 0.1).float() / 0.9)
        dy = rk(B, hw, hw, c)
        lin = k3_linear(sb, args)
        # through autograd, as the model calls it: launches counted exactly
        ins = [t.clone().requires_grad_() for t in lin]
        sb.reset_launches()
        got = torch.autograd.grad(sb.swin_block(*ins, heads, ws, 1e-5), ins, dy)
        again = torch.autograd.grad(sb.swin_block(*ins, heads, ws, 1e-5), ins, dy)
        torch.cuda.synchronize()
        launched = (sb.launches, sb.bwd_launches)
        if launched != (2 * sb.KERNELS_PER_CALL, 2 * sb.BWD_KERNELS_PER_CALL):
            fail(f"K3 backward ({label}): two calls launched (fwd, bwd) {launched}, want "
                 f"{(2 * sb.KERNELS_PER_CALL, 2 * sb.BWD_KERNELS_PER_CALL)}")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"K3 backward ({label}): a rerun differs (not bitwise repeatable)")
        _, saved_p = sb.swin_block_fwd_plain(*lin, heads, ws, 1e-5, save=True)
        (x_, bias_, scale_, wq_, _, wk_, wv_, _, wp_, _, l1w, l1b, w1_, _, w2_, _, l2w, l2b,
         dp_) = lin
        plain_bwd = lambda: sb.swin_block_bwd_linear_plain(
            x_, dy, bias_, scale_, wq_, wk_, wv_, wp_, w1_, w2_, l1w, l1b, l2w, l2b, dp_, saved_p,
            heads, ws, 1e-5)
        ref = plain_bwd()
        errs = {name: rel_l2(a, b) for name, a, b in zip(sb.COTANGENTS, got, ref)}
        over = {k: v for k, v in errs.items() if not v <= K3_BWD_VS_PLAIN_BARS[k]}
        if not all(torch.isfinite(g).all() for g in got) or over:
            fail(f"K3 backward vs plain ({label}): over their bars {json.dumps(over)} (bars "
                 f"{json.dumps({k: K3_BWD_VS_PLAIN_BARS[k] for k in over})}; all: "
                 f"{json.dumps(errs)})")
        with torch.no_grad():
            _, saved = sb._forward_kernel(lin, heads, ws, 1e-5, 0, True)
        t_k = event_ms(lambda: sb._backward_kernel(lin, saved, dy, heads, ws, 1e-5, 0), 10)
        d_k = device_ms(lambda: sb._backward_kernel(lin, saved, dy, heads, ws, 1e-5, 0), 10)
        t_p = event_ms(plain_bwd, 10)
        M = B * hw * hw
        # x, dy in and dx out; the weights in and their gradients out; the
        # bias in and out; the per-sample affines and dp in and out; what the
        # forward saved in (qkv, o, x^1, x2, hpre, x^2, the lse and rstds).
        # FLOP: twice the forward's products (activation and weight
        # gradients), the attention's dv, dp, dq, dk and the P it takes again
        nbytes = 4 * (3 * M * c + 2 * (4 * c * c + 2 * c * f + 5 * c + f + args[1].numel())
                      + 8 * B * c + 4 * B + M * (7 * c + f + 2) + B * (hw // ws) ** 2 * heads * n)
        flops = 4.0 * M * c * (4 * c + 2 * f) + 10.0 * M * n * c
        b_ms, b_by = bound(nbytes, flops)
        b3_ms = 3 * flops / TF32_FLOPS * 1e3
        worst = max(errs, key=lambda k: errs[k] / K3_BWD_VS_PLAIN_BARS[k])
        say(f"[18] K3 backward {label} ({B}, {hw}², C {c}, {heads} heads, ws {ws}, nw {nw}): "
            f"19 cotangents vs plain, each under its own bar, nearest {worst} rel L2 "
            f"{errs[worst]:.3e} (bar {K3_BWD_VS_PLAIN_BARS[worst]:.1e}); bitwise repeatable; "
            f"launches {sb.KERNELS_PER_CALL} forward, {sb.BWD_KERNELS_PER_CALL} backward; K3 bwd "
            f"{t_k:.4f} ms (device {d_k:.4f} ms) | plain {t_p:.4f} ms | bound {b_ms:.4f} ms "
            f"({b_by}), 3xTF32 "
            f"{b3_ms:.4f} ms | {card}")
        say(f"[18]   all: {json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})}")
        if k3_line is None:
            k3_line = {"name": f"{sb.LIB_NAME}_bwd", "route": "cuda",
                       "source": "pregen_pde_tpu_torch/csrc/swin_block.cu",
                       "replaces": "pregen_pde_tpu/ops/swin_block.py:460",
                       "max_abs_err": max(float((a - b).abs().max()) for a, b in zip(got, ref)),
                       "ms": t_k, "plain_ms": t_p, "bound_ms": b_ms, "bound_by": b_by,
                       "bound_3xtf32_ms": b3_ms, "library_ms": None}
        del ins, got, again, saved, saved_p, ref

    # -- 19. one scOT-B train step, kernels against the plain route ------------------------------
    model = seeded_scot("scot-B", 128, seed=0).to(dev).train()
    x, t, y = rn(16, 128, 128, 7), torch.rand(16, generator=gen, device=dev), rn(16, 128, 128, 3)
    res = {}

    def step(route):
        set_route(model, route)
        model.set_dropout_generator(torch.Generator(device=dev).manual_seed(7))
        model.zero_grad(set_to_none=True)
        loss = relative_lp_loss(model(x, t).float(), y)
        loss.backward()
        return loss.detach()

    for route in ("auto", "plain"):
        sb.reset_launches()
        wa.reset_launches()
        loss = step(route)
        torch.cuda.synchronize()
        launches = (sb.launches, sb.bwd_launches, wa.launches, wa.bwd_launches)
        grads = {name: p.grad.clone() for name, p in model.named_parameters()}
        res[route] = (float(loss), grads, launches, event_ms(lambda: step(route), 3))
    # stages 0-2 hold 16 layers each (16 x 32², 16², 8² tokens), stage 3 16
    k3_bwd_step = 48 * sb.BWD_KERNELS_PER_CALL
    # stage 3's windows (n = 16) take K4's small backward route
    want = (48 * sb.KERNELS_PER_CALL, k3_bwd_step, 16, 16 * wa.BWD_KERNELS_PER_CALL["small"])
    if res["auto"][2] != want or res["plain"][2] != (0, 0, 0, 0):
        fail(f"scOT-B train step launches (K3, K3 bwd, K4, K4 bwd): auto {res['auto'][2]}, "
             f"want {want}; plain {res['plain'][2]}, want zeros")
    loss_rel = abs(res["auto"][0] - res["plain"][0]) / abs(res["plain"][0])
    gerrs = {name: rel_l2(g, res["plain"][1][name]) for name, g in res["auto"][1].items()}
    gworst = max(gerrs, key=gerrs.get)
    finite = all(torch.isfinite(g).all() for g in res["auto"][1].values())
    say(f"[19] scOT-B train step 128², B=16, drop-path on, one generator state: loss kernels "
        f"{res['auto'][0]:.7f} vs plain {res['plain'][0]:.7f} (rel {loss_rel:.3e}, bar "
        f"{STEP_LOSS_RTOL:.0e}); gradients of {len(gerrs)} parameters, worst {gworst} rel L2 "
        f"{gerrs[gworst]:.3e} (bar {STEP_GRAD_BAR:.1e}), median "
        f"{float(np.median(list(gerrs.values()))):.3e}; launches of one step (K3, K3 bwd, K4, "
        f"K4 bwd) {res['auto'][2]}; forward+backward kernels {res['auto'][3]:.1f} ms | plain "
        f"{res['plain'][3]:.1f} ms | {card}")
    if not (finite and loss_rel <= STEP_LOSS_RTOL and gerrs[gworst] <= STEP_GRAD_BAR):
        fail(f"scOT-B train step, kernels vs plain: loss rel {loss_rel:.3e}, worst gradient "
             f"{gworst} {gerrs[gworst]:.3e}, finite {finite}")
    del model, res
    adamw_line = adamw_phase(dev, card)

    # -- 20. the train main path through the CLI, then evaluate of its best.pt ---------------------
    work = tempfile.mkdtemp(prefix="smoke_train_", dir=build.BUILD_DIR)
    try:
        hard = os.path.join(work, "fpo_multi_hole.npy")
        np.save(hard, fpo)
        ckpt = os.path.join(work, "ckpt")
        cmd = [sys.executable, "-m", "pregen_pde_tpu_torch", "train", "--model", "scot-B",
               "--data", hard, "--epochs", "1", "--batch-size", "16", "--ckpt", ckpt]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if r.returncode != 0:
            fail(f"train rc {r.returncode}:\n{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
        lines = [json.loads(l) for l in r.stdout.splitlines() if l.startswith("{")]
        counts = [l["kernel_launches"] for l in lines if "kernel_launches" in l]
        epochs = [l for l in lines if "epoch" in l]
        best = [l for l in lines if "best_mean_val_rel_%" in l]
        if len(counts) != 1 or len(epochs) != 1 or len(best) != 1:
            fail(f"train printed no launch, epoch or best line:\n{r.stdout[-2000:]}")
        counts, rec = counts[0], epochs[0]
        # 26 train trajectories × 20 one-step pairs = 520 samples: 32 steps;
        # 3 val trajectories: 60 samples, 3 batches (drop_last, as in JAX)
        steps, val_batches = 32, 3
        want = {sb.LIB_NAME: (steps + val_batches) * 48 * sb.KERNELS_PER_CALL,
                f"{sb.LIB_NAME}_bwd": steps * k3_bwd_step,
                wa.LIB_NAME: (steps + val_batches) * 16,
                f"{wa.LIB_NAME}_bwd": steps * 16 * wa.BWD_KERNELS_PER_CALL["small"],
                adamw.LIB_NAME: steps * 2}  # the clip's norm and the update
        if counts != want:
            fail(f"train launches {counts}, want {want}")
        numbers = [rec["train_loss"], rec["val_mean_rel_%"], rec["val_median_rel_%"],
                   best[0]["best_mean_val_rel_%"]]
        if not np.isfinite(numbers).all():
            fail(f"train printed non-finite numbers: {rec}")
        if not os.path.isfile(os.path.join(ckpt, "best.pt")):
            fail("train --ckpt wrote no best.pt")
        say(f"[20] train --model scot-B --data fpo_multi_hole (32 traj, 21 frames, 128²) --epochs 1 "
            f"--batch-size 16: {wall:.2f} s wall incl. start-up and the best.pt write; "
            f"{steps} steps in {rec['time_s']:.2f} s ({rec['time_s'] / steps * 1e3:.1f} ms a step "
            f"with the loader); train loss {rec['train_loss']:.5f}, val mean "
            f"{rec['val_mean_rel_%']:.4f} %; launches {counts} | {card}")
        cmd = [sys.executable, "-m", "pregen_pde_tpu_torch", "evaluate", "--model", "scot-B",
               "--data", hard, "--ckpt", os.path.join(ckpt, "best.pt"), "--batch-size", "16"]
        r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            fail(f"evaluate of best.pt rc {r.returncode}:\n{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
        results = [json.loads(l) for l in r.stdout.splitlines() if l.startswith('{"patterns"')]
        if len(results) != 1 or not np.isfinite(flat_numbers(results[0])).all():
            fail(f"evaluate of best.pt: no finite result:\n{r.stdout[-2000:]}")
        say(f"[20] evaluate --ckpt best.pt: [7] median rel "
            f"{results[0]['patterns']['[7]']['median_rel_%']:.4f} %, all "
            f"{flat_numbers(results[0]).size} numbers finite")
        k3_line["launches"] = counts[f"{sb.LIB_NAME}_bwd"]
        k4_line["launches"] = counts[f"{wa.LIB_NAME}_bwd"]
        adamw_line["launches"] = counts[adamw.LIB_NAME]

        # -- 21. mix-sweep through the CLI: hard fpo_multi_hole, easy fpo_regular ----------------
        easy = os.path.join(work, "fpo_regular")
        cmd = [sys.executable, "-m", "pregen_pde_tpu_torch", "generate", "--workload",
               "fpo_regular", "--n", "16", "--resolution", "128", "--batch-size", "16",
               "--time-scale", "0.1", "--out", easy]
        r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            fail(f"generate fpo_regular rc {r.returncode}:\n{r.stderr[-4000:]}")
        from pregen_pde_tpu_torch.datagen.writer import load_shards

        easy_npy = os.path.join(work, "fpo_regular.npy")
        easy_data = load_shards(easy)
        np.save(easy_npy, easy_data)
        cmd = [sys.executable, "-m", "pregen_pde_tpu_torch", "mix-sweep", "--model", "scot-B",
               "--hard", hard, "--easy", easy_npy, "--alphas", "0.5", "--total-trajectories",
               "16", "--epochs", "1", "--batch-size", "16"]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if r.returncode != 0:
            fail(f"mix-sweep rc {r.returncode}:\n{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
        lines = [json.loads(l) for l in r.stdout.splitlines() if l.startswith("{")]
        alpha = [l for l in lines if l.get("alpha") == 0.5]
        counts = [l["kernel_launches"] for l in lines if "kernel_launches" in l]
        if len(alpha) != 1 or lines[-1].keys() != {"0.5"} or len(counts) != 1:
            fail(f"mix-sweep output malformed:\n{r.stdout[-2000:]}")
        split_numbers = [v for s in ("test_hard", "test_easy") for v in alpha[0][s].values()]
        if not (np.isfinite(split_numbers).all() and all(v > 0 for v in counts[0].values())):
            fail(f"mix-sweep: non-finite test numbers or a kernel never launched: {lines}")
        say(f"[21] mix-sweep --model scot-B --alphas 0.5 --total-trajectories 16 --epochs 1 (hard "
            f"fpo_multi_hole, easy fpo_regular 16 traj at time-scale 0.1): {wall:.2f} s wall; "
            f"test_hard mean {alpha[0]['test_hard']['mean_rel_%']:.4f} %, test_easy mean "
            f"{alpha[0]['test_easy']['mean_rel_%']:.4f} %; launches {counts[0]} | {card}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return k3_line, k4_line, adamw_line, easy_data


def adamw_phase(dev, card: str) -> dict:
    """Phase 19a: the fused AdamW against the ``_foreach`` route on scOT-B's
    leaves, bit for bit, then timed beside torch's fused AdamW kernel. →
    the kernels line's entry."""
    import torch

    from pregen_pde_tpu_torch.__main__ import _make_model
    from pregen_pde_tpu_torch.ops import adamw
    from pregen_pde_tpu_torch.profile_scot import event_ms, library_adamw
    from pregen_pde_tpu_torch.training.optim import build_optimizer
    from pregen_pde_tpu_torch.training.tiers import SCOT_TIER_DECAY, scot_main_tiers, scot_tier_of
    from pregen_pde_tpu_torch.training.trainer import TrainerConfig

    with torch.device("meta"):
        shapes = [(n, p.shape) for n, p in _make_model("scot-B", 128, in_channels=7,
                                                       out_channels=3).named_parameters()]
    gen = torch.Generator(device=dev).manual_seed(11)
    weights = [0.02 * torch.randn(s, generator=gen, device=dev) for _, s in shapes]
    cfg = TrainerConfig(learning_rate=1e-3, weight_decay=0.1, grad_clip=5.0, epochs=2,
                        lr_tiers=scot_main_tiers(1e-3, 3e-3, 4e-3))
    routes = ("kernel", "plain", "library")
    opts = {r: build_optimizer(cfg, 5, [(n, torch.nn.Parameter(w.clone()))
                                        for (n, _), w in zip(shapes, weights)],
                               tier_fn=scot_tier_of, tier_decay=SCOT_TIER_DECAY) for r in routes}
    del weights
    if opts["kernel"].fused is None or len(opts["kernel"].groups) != 4:
        fail("the optimizer over scOT-B's leaves on the card did not take the fused AdamW")
    opts["plain"].fused = opts["library"].fused = None
    steps = {"kernel": opts["kernel"].step, "plain": opts["plain"].step,
             "library": library_adamw(opts["library"])}
    n_params = sum(p.numel() for p in opts["kernel"].params)

    def set_grads(none=()):
        """The same N(0, 10⁻⁸) gradient on each route's leaf (the library's
        takes zeros where the others have none). → the kernel's gradients."""
        given = []
        for i, ps in enumerate(zip(*(opts[r].params for r in routes))):
            g = 1e-4 * torch.randn(ps[0].shape, generator=gen, device=dev)
            for r, p in zip(routes, ps):
                p.grad = g.clone() if i not in none else (
                    torch.zeros_like(g) if r == "library" else None)
            given.append(None if i in none else g)
        return given

    bits = lambda ts: torch.cat([t.detach().reshape(-1) for t in ts]).view(torch.int32)
    state = lambda o: {"p": bits(o.params), "m": bits([o.m[id(p)] for p in o.params]),
                       "v": bits([o.v[id(p)] for p in o.params])}
    adamw.reset_launches()
    norms = []
    for k in range(5):
        given = set_grads(none=(3, 700) if k in (1, 3) else ())
        for r in routes:
            steps[r]()
        norms.append(float(opts["kernel"].fused.clip_out[0]))
        if not all((p.grad is None) if g is None else torch.equal(p.grad, g)
                   for p, g in zip(opts["kernel"].params, given)):
            fail("the fused AdamW changed a .grad")
    torch.cuda.synchronize()
    got, want = state(opts["kernel"]), state(opts["plain"])
    differ = {k: int((got[k] != want[k]).sum()) for k in got}
    p_k, p_l = got["p"].view(torch.float32), state(opts["library"])["p"].view(torch.float32)
    top = p_k.abs().max()
    lib_ulps = float((p_k - p_l).abs().max() / (torch.nextafter(top, 2 * top) - top))
    say(f"[19a] fused AdamW on scOT-B's {len(shapes)} leaves ({n_params:,} parameters), four "
        f"tiers, decay on, 5 steps, global norm {min(norms):.4f}..{max(norms):.4f} (clip 5.0): "
        f"elements of p, m, v differing from the _foreach route {differ} (bar 0); launches "
        f"{adamw.launches} (want 10); torch's _fused_adamw_ parts from the kernel's p by "
        f"{lib_ulps:.1f} ulps of max|p| (it rounds otherwise; not a bar)")
    if any(differ.values()) or adamw.launches != 10 or not max(norms) < 5.0:
        fail(f"fused AdamW vs the _foreach route: differing elements {differ}, launches "
             f"{adamw.launches} (want 10), norms {norms}")
    del got, want, p_k, p_l
    times = {}
    for r in routes:
        set_grads()
        host = host_us(steps[r], 10) / 1e3
        # the _foreach route waits on the card within a step, so its queue
        # drains: its device time by events would hold the host's too
        times[r] = (event_ms(steps[r], 10),
                    None if r == "plain" else queued_ms(steps[r], host / 1e3), host)
    # p, g, m, v read and p, m, v written once, g read once more for the norm;
    # the clip and the update take ~20 float32 operations an element
    b_ms, b_by = bound(8 * 4 * n_params, 20 * n_params)
    say(f"[19a] one step by events / device / host enqueue: kernel "
        f"{' / '.join(f'{t:.3f}' for t in times['kernel'])} ms | plain (_foreach) "
        f"{times['plain'][0]:.3f} / - / {times['plain'][2]:.3f} ms | torch _fused_adamw_ "
        f"{' / '.join(f'{t:.3f}' for t in times['library'])} ms | bound {b_ms:.3f} ms ({b_by}; "
        f"{b_ms / times['kernel'][1]:.1%} of it reached on the device) | {card}")
    del opts, steps
    torch.cuda.empty_cache()
    return {"name": adamw.LIB_NAME, "route": "cuda",
            "source": "pregen_pde_tpu_torch/csrc/adamw.cu", "replaces": None,
            "max_abs_err": 0.0, "ms": times["kernel"][0], "device_ms": times["kernel"][1],
            "host_ms": times["kernel"][2], "plain_ms": times["plain"][0],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": times["library"][0],
            "library_device_ms": times["library"][1], "library_parts_by_ulps": lib_ulps}


def graph_ms(fn, reps: int = 200) -> float:
    """Device ms a call of ``fn``: ``reps`` calls captured in one CUDA graph
    and replayed, so the host's enqueue time (which exceeds a microsecond
    kernel's) is not counted. Timing only; the port runs no graph."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):  # warm-up outside the capture: allocator, cuDNN plans
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(3):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (3 * reps)


def heat_phases(dev, card: str, stencil_build, t0_build: float,
                mutant_build) -> tuple[dict, dict]:
    """Phases 22-24: K5a and K5b against their plain versions, the heat
    routes, and the heat main path. → K5a's and K5b's entries of the
    kernels line."""
    import ctypes

    import numpy as np
    import torch

    from pregen_pde_tpu_torch.core import SpectralGrid2D
    from pregen_pde_tpu_torch.datagen.writer import load_shards
    from pregen_pde_tpu_torch.fields.grf import grf_2d
    from pregen_pde_tpu_torch.kernels import build
    from pregen_pde_tpu_torch.ops import stencil as st
    from pregen_pde_tpu_torch.solvers.heat import HeatConfig, HeatSolver
    from pregen_pde_tpu_torch.utils.parity import per_snapshot_rel_l2, rel_l2

    # -- 22. the stencil library's build (started in phase 2) -----------------------------------
    stencil_build.result()
    build.load(st.LIB_NAME)
    say(f"[22] built {st.LIB_NAME} (sm_90a): done {time.perf_counter() - t0_build:.2f} s after "
        f"the parallel builds started (nvcc {build.build_seconds[st.LIB_NAME]:.2f} s)")

    # -- 23. K5a and K5b against their plain versions; the heat routes -----------------------------
    gen = torch.Generator(device=dev).manual_seed(5)
    D, dt = HeatConfig.diffusivity, HeatConfig.dt
    k5a_err = k5b_err = None
    for B, n in ((32, 128), (4, 256), (3, 130)):
        u = grf_2d(gen, SpectralGrid2D(n), B)  # the heat main path's initial fields
        dx = 1.0 / n
        got, ref = st.laplacian_cuda(u, dx), st.laplacian(u, dx)
        err = rel_l2(got, ref)
        floor = rel_l2(ref, st.laplacian(u.double(), dx))
        max_abs = float((got - ref).abs().max())
        if not (torch.isfinite(got).all() and err <= K5A_VS_PLAIN_BAR):
            fail(f"K5a vs plain (B={B}, {n}^2): rel L2 {err:.3e} > {K5A_VS_PLAIN_BAR:.1e}")
        if k5a_err is None:
            k5a_err = max_abs
        say(f"[23] K5a B={B} {n}^2 ({'row' if n % 128 == 0 else 'general'} route): rel L2 vs "
            f"plain {err:.3e} (bar {K5A_VS_PLAIN_BAR:.1e}; the plain float32 version's own "
            f"against float64 {floor:.2e}), max abs {max_abs:.3e} of max |lap| "
            f"{float(ref.abs().max()):.3e}")
        if (B, n) == (32, 128):
            # the bar catches a wrap read from the wrong row (built in phase 2)
            main_lib = build._loaded[st.LIB_NAME]
            build._loaded[st.LIB_NAME] = ctypes.CDLL(str(mutant_build.result()))
            try:
                m_err = rel_l2(st.laplacian_cuda(u, dx), ref)
            finally:
                build._loaded[st.LIB_NAME] = main_lib
            if not m_err > K5A_VS_PLAIN_BAR:
                fail(f"K5a's wrong-wrap mutant passed its bar: rel L2 {m_err:.3e}")
            say(f"[23] K5a mutant (the top row's upper neighbour read from row n - 2) B={B} "
                f"{n}^2: rel L2 vs plain {m_err:.3e}, {m_err / K5A_VS_PLAIN_BAR:.1e}x the bar: "
                f"caught")
        for react in (0.0, 1.0):
            got, ref = st.heat_step_cuda(u, dx, D, dt, react), st.heat_step(u, dx, D, dt, react)
            err = rel_l2(got - u, ref - u)  # the step's increment, not the field it moves
            max_abs = float((got - ref).abs().max())
            if not (torch.isfinite(got).all() and err <= K5B_VS_PLAIN_BAR):
                fail(f"K5b vs plain (B={B}, {n}^2, k={react}): increment rel L2 {err:.3e} > "
                     f"{K5B_VS_PLAIN_BAR:.1e}")
            if k5b_err is None:
                k5b_err = max_abs
            say(f"[23] K5b B={B} {n}^2 k={react}: increment rel L2 vs plain {err:.3e} (bar "
                f"{K5B_VS_PLAIN_BAR:.1e}), max abs {max_abs:.3e}")

    # the resident trajectory (one launch) against the plain trajectory per
    # snapshot beyond the main path's shape: 256^2 (a cluster an image) and
    # the ragged 130^2, k = 0 and 1
    for B, n in ((4, 256), (3, 130)):
        u = grf_2d(gen, SpectralGrid2D(n), B)
        for react in (0.0, 1.0):
            st.reset_launches()
            got = st.heat_trajectory(u, 4, 50, 1.0 / n, D, dt, react)
            torch.cuda.synchronize()
            launched = st.launches
            err = per_snapshot_rel_l2(got, st.heat_trajectory_plain(u, 4, 50, 1.0 / n, D, dt,
                                                                    react))
            if not (launched == 1 and torch.isfinite(got).all()
                    and err.max() <= HEAT_ROUTE_VS_PLAIN_BAR):
                fail(f"K5b trajectory (B={B}, {n}^2, k={react}): {launched} launches, worst "
                     f"snapshot {err.max():.3e} > {HEAT_ROUTE_VS_PLAIN_BAR:.1e}")
            say(f"[23] K5b trajectory B={B} {n}^2 k={react} 4 x 50 steps, resident in clusters of "
                f"{st.resident_cluster(n)}: 1 launch, per-snapshot rel L2 vs plain worst "
                f"{err.max():.3e} (bar {HEAT_ROUTE_VS_PLAIN_BAR:.1e})")

    # the heat routes at the main path's shape: fused (K5b) and laplacian (K5a) vs plain
    u0 = grf_2d(gen, SpectralGrid2D(128), 32)
    runs = {}
    for impl, t_end in (("fused", 1.0), ("plain", 1.0), ("laplacian", 0.1), ("plain", 0.1)):
        sol = HeatSolver(HeatConfig(resolution=128, t_end=t_end), impl=impl)
        st.reset_launches()
        t0 = time.perf_counter()
        runs[impl, t_end] = sol.make_batched_trajectory_fn()(u0)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        S, inner = sol.steps()
        # the fused route is one resident launch a trajectory
        expect = {"fused": 1, "laplacian": 2 * S * inner, "plain": 0}[impl]
        if st.launches != expect:
            fail(f"heat route {impl}: {st.launches} stencil launches, expected {expect}")
        if impl == "laplacian":
            k5a_launches = st.launches
        say(f"[23] HeatSolver(impl={impl!r}) B=32 128^2 {S} x {inner} steps: {secs:.3f} s, "
            f"{st.launches} stencil launches")
    for impl, t_end in (("fused", 1.0), ("laplacian", 0.1)):
        got, ref = runs[impl, t_end], runs["plain", t_end]
        if not torch.isfinite(got).all():
            fail(f"heat route {impl}: non-finite output")
        err = per_snapshot_rel_l2(got, ref)
        if not err.max() <= HEAT_ROUTE_VS_PLAIN_BAR:
            fail(f"heat route {impl} vs plain: worst snapshot {err.max():.3e} > "
                 f"{HEAT_ROUTE_VS_PLAIN_BAR:.1e} (per snapshot: {err.tolist()})")
        say(f"[23] heat route {impl} vs plain f32, per-snapshot rel L2 first / mid / last "
            f"{err[1]:.3e} / {err[10]:.3e} / {err[20]:.3e}, worst {err.max():.3e} (bar "
            f"{HEAT_ROUTE_VS_PLAIN_BAR:.1e})")
    k5b_err = max(k5b_err, float((runs["fused", 1.0] - runs["plain", 1.0]).abs().max()))
    del runs

    # times at the main path's shape (B = 32, 128^2): device time by CUDA graph
    # replay; eager wall per call beside it
    from pregen_pde_tpu_torch.profile_scot import event_ms

    u, dx = u0, 1.0 / 128
    conv = torch.nn.Conv2d(1, 1, 3, padding=1, padding_mode="circular", bias=False).to(dev)
    with torch.no_grad():
        conv.weight.copy_(torch.tensor([[0.0, 1.0, 0.0], [1.0, -4.0, 1.0], [0.0, 1.0, 0.0]],
                                       device=dev) / (dx * dx))
    with torch.no_grad():
        lib_err = rel_l2(conv(u[:, None])[:, 0], st.laplacian(u, dx))
        t = {"k5a": graph_ms(lambda: st.laplacian_cuda(u, dx)),
             "k5a_plain": graph_ms(lambda: st.laplacian(u, dx)),
             "conv": graph_ms(lambda: conv(u[:, None])),
             "k5b": graph_ms(lambda: st.heat_step_cuda(u, dx, D, dt)),
             "k5b_plain": graph_ms(lambda: st.heat_step(u, dx, D, dt)),
             "k5b_eager": event_ms(lambda: st.heat_step_cuda(u, dx, D, dt), 200),
             "k5b_advance": event_ms(lambda: st.heat_advance(u, 500, dx, D, dt), 5) / 500,
             "k5a_eager": event_ms(lambda: st.laplacian_cuda(u, dx), 200),
             # the main path's call: the whole 20 x 500-step trajectory of the batch
             "traj": event_ms(lambda: st.heat_trajectory(u, 20, 500, dx, D, dt), 5)}
        _, t_traj_plain = timed(lambda: st.heat_trajectory_plain(u, 20, 500, dx, D, dt))
    nbytes = 2 * 4 * u.numel()  # u read once, the result written once
    a_ms, a_by = bound(nbytes, 6.0 * u.numel())
    # K5b at k = 0: two rhs (6 FLOP of the stencil, 1 of D), u1 (2), the update (3)
    b_ms, b_by = bound(nbytes, 19.0 * u.numel())
    # the trajectory: u0 read, 21 frames written; 19 FLOP a point a step
    tr_ms, tr_by = bound(4 * 22 * u.numel(), 19.0 * u.numel() * 10_000)
    say(f"[23] K5a B=32 128^2: {t['k5a']:.5f} ms (eager {t['k5a_eager']:.5f}) | plain "
        f"{t['k5a_plain']:.5f} ms | circular Conv2d {t['conv']:.5f} ms (vs plain rel L2 "
        f"{lib_err:.1e}, TF32 off) | bound {a_ms:.5f} ms ({a_by}) | {card}")
    say(f"[23] K5b tiled, one step, B=32 128^2: {t['k5b']:.5f} ms (eager {t['k5b_eager']:.5f}; "
        f"in heat_advance's 500-step call {t['k5b_advance']:.5f}) | plain {t['k5b_plain']:.5f} "
        f"ms | bound {b_ms:.5f} ms ({b_by}) | {card}")
    say(f"[23] K5b trajectory B=32 128^2 20 x 500 steps, one resident launch (clusters of "
        f"{st.resident_cluster(128)}): {t['traj']:.3f} ms ({t['traj'] / 10:.4f} us a step) | "
        f"plain {t_traj_plain * 1e3:.1f} ms | the tiled route {t['k5b_advance'] * 1e4:.2f} ms | "
        f"bound {tr_ms:.4f} ms ({tr_by}; {tr_ms / t['traj']:.1%} reached) | {card}")

    # us a step, resident (each cluster size that holds 128^2) against tiled:
    # the difference of a 1500- and a 500-step call, one snapshot each
    def us_a_step(fn, short=500, long=1500):
        return (event_ms(lambda: fn(long), 3) - event_ms(lambda: fn(short), 3)) / (long - short) * 1e3

    per_step = {}
    for B in (1, 8, 32):
        ub = u0[:B].contiguous()
        row = {f"resident_cs{cs}": us_a_step(
            lambda m, cs=cs: st.heat_trajectory(ub, 1, m, dx, D, dt, cluster=cs))
            for cs in (1, 2, 4, 8)}
        row["tiled"] = us_a_step(lambda m: st.heat_advance(ub, m, dx, D, dt))
        per_step[B] = row
        say(f"[23] K5b us a step at B={B} 128^2: "
            + ", ".join(f"{k} {v:.4f}" for k, v in row.items())
            + f" (default clusters of {st.resident_cluster(128)}) | {card}")
    # K5a across batch and grid (row route), device time against the bytes
    # bound; a 4^2 image, next to no work, shows what a graph node costs
    sweep = {}
    for B, n in ((1, 4), (1, 128), (8, 128), (32, 128), (32, 256), (32, 512)):
        ub = grf_2d(gen, SpectralGrid2D(n), B)
        ms = graph_ms(lambda: st.laplacian_cuda(ub, 1.0 / n))
        bnd = bound(2 * 4 * ub.numel(), 6.0 * ub.numel())[0]
        sweep[f"{B}x{n}"] = {"ms": ms, "bound_ms": bnd}
        say(f"[23] K5a B={B} {n}^2: {ms:.5f} ms by graph replay | bound {bnd:.5f} ms (bytes; "
            f"{bnd / ms:.1%} reached) | {card}")
    k5a_line = {"name": f"{st.LIB_NAME}_laplacian", "route": "cuda",
                "source": "pregen_pde_tpu_torch/csrc/stencil.cu",
                "replaces": "pregen_pde_tpu/ops/stencil.py:42", "launches": k5a_launches,
                "max_abs_err": k5a_err, "ms": t["k5a"], "plain_ms": t["k5a_plain"],
                "bound_ms": a_ms, "bound_by": a_by, "library_ms": t["conv"], "sweep": sweep}
    k5b_line = {"name": f"{st.LIB_NAME}_heat_trajectory", "route": "cuda",
                "source": "pregen_pde_tpu_torch/csrc/stencil.cu",
                "replaces": "pregen_pde_tpu/ops/stencil.py:83",
                "max_abs_err": k5b_err, "ms": t["traj"], "plain_ms": t_traj_plain * 1e3,
                "bound_ms": tr_ms, "bound_by": tr_by, "library_ms": None,
                "step_tiled_ms": t["k5b"], "us_a_step": {str(B): v for B, v in per_step.items()}}

    # -- 24. the heat main path, through the CLI -------------------------------------------------
    work = tempfile.mkdtemp(prefix="smoke_heat_", dir=build.BUILD_DIR)
    try:
        out = os.path.join(work, "heat")
        cmd = [sys.executable, "-m", "pregen_pde_tpu_torch", "generate", "--workload", "heat",
               "--n", "32", "--resolution", "128", "--batch-size", "32", "--out", out]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
        wall = time.perf_counter() - t0
        if r.returncode != 0:
            fail(f"generate heat rc {r.returncode}:\n{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
        counts = [json.loads(l)["kernel_launches"] for l in r.stdout.splitlines()
                  if l.startswith('{"kernel_launches"')]
        if len(counts) != 1:
            fail(f"generate heat printed no launch line:\n{r.stdout[-2000:]}")
        # one resident K5b launch for the batch's 20 snapshots x 500 steps
        if counts[0] != {"spectral_ns_step": 0, "ns_projection_step": 0, st.LIB_NAME: 1}:
            fail(f"generate heat launches {counts[0]}, expected 1 of {st.LIB_NAME} only")
        data = load_shards(out)
        if data.shape != (32, 21, 128, 128) or not np.isfinite(data).all():
            fail(f"heat shard {data.shape}, finite {np.isfinite(data).all()}")
        d = data.astype(np.float64)
        rms0 = np.sqrt((d[:, 0] ** 2).mean(axis=(1, 2)))
        mean = d.mean(axis=(2, 3))
        drift = (np.abs(mean - mean[:, :1]).max(axis=1) / rms0).max()
        if not drift <= HEAT_MEAN_DRIFT_BAR:
            fail(f"heat: the mean moved by {drift:.3e} of the initial rms > "
                 f"{HEAT_MEAN_DRIFT_BAR:.1e}")
        var = d.var(axis=(2, 3))
        if not (np.diff(var, axis=1) < 0).all():
            fail("heat: the spatial variance grew in some snapshot (pure diffusion, k = 0)")
        k5b_line["launches"] = counts[0][st.LIB_NAME]
        say(f"[24] generate --workload heat --n 32 --resolution 128 --batch-size 32: {wall:.2f} s "
            f"wall incl. start-up, {32 / wall:.3f} traj/s; K5b launches {counts[0][st.LIB_NAME]}; "
            f"shard {data.shape} finite; mean drift {drift:.3e} of the initial rms (bar "
            f"{HEAT_MEAN_DRIFT_BAR:.1e}); variance falls every snapshot, last/first "
            f"{(var[:, -1] / var[:, 0]).max():.4f} | {card}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return k5a_line, k5b_line


def simple_phases(card: str) -> None:
    """Phase 25: Burgers and Darcy through the CLI."""
    import numpy as np
    import torch

    from pregen_pde_tpu_torch.datagen.writer import load_shards
    from pregen_pde_tpu_torch.kernels import build
    from pregen_pde_tpu_torch.solvers.darcy import DarcyConfig, solve_darcy
    from pregen_pde_tpu_torch.utils.parity import rel_l2

    work = tempfile.mkdtemp(prefix="smoke_simple_", dir=build.BUILD_DIR)
    try:
        shards = {}
        for workload, res, shape in (("burgers", 1024, (32, 21, 1024)),
                                     ("darcy", 128, (32, 2, 128, 128))):
            out = os.path.join(work, workload)
            cmd = [sys.executable, "-m", "pregen_pde_tpu_torch", "generate", "--workload",
                   workload, "--n", "32", "--resolution", str(res), "--batch-size", "32",
                   "--out", out]
            t0 = time.perf_counter()
            r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=300)
            wall = time.perf_counter() - t0
            if r.returncode != 0:
                fail(f"generate {workload} rc {r.returncode}:\n{r.stdout[-2000:]}\n"
                     f"{r.stderr[-4000:]}")
            data = shards[workload] = load_shards(out)
            if data.shape != shape or not np.isfinite(data).all():
                fail(f"{workload} shard {data.shape}, finite {np.isfinite(data).all()}")
            say(f"[25] generate --workload {workload} --n 32 --resolution {res} --batch-size 32: "
                f"{wall:.2f} s wall incl. start-up, {32 / wall:.3f} traj/s; shard {data.shape} "
                f"finite | {card}")
        a, u = shards["darcy"][:, 0], shards["darcy"][:, 1]
        if not (a.min() > 0 and u.min() >= 0):
            fail(f"darcy: a min {a.min()}, u min {u.min()} (need a > 0, u >= 0)")
        # the card's float32 solve against a float64 solve on the CPU, same a
        ref = solve_darcy(torch.from_numpy(a[:2].astype(np.float64)), DarcyConfig(resolution=128))
        errs = [rel_l2(u[i], ref[i]) for i in range(2)]
        if not max(errs) <= DARCY_F32_VS_F64_BAR:
            fail(f"darcy: float32 u vs float64 solve rel L2 {errs} > {DARCY_F32_VS_F64_BAR:.1e}")
        say(f"[25] darcy: a in [{a.min():.4f}, {a.max():.4f}], u in [{u.min():.3e}, "
            f"{u.max():.5f}]; u (card, float32) vs float64 CPU solve, trajectories 0 and 1: rel "
            f"L2 {errs[0]:.3e}, {errs[1]:.3e} (bar {DARCY_F32_VS_F64_BAR:.1e})")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def model_phase(dev, card: str) -> None:
    """Phase 26: FNO and FFNO at their default widths, 128², B = 16, weights
    from seed 0, on the card against the same model in float64 on the CPU:
    the forward and every parameter's gradient of a relative-L2 loss (in
    ``eval()``, so FFNO's dropout is off), each under its bar; then ms per
    forward and per AdamW train step by events and as device time."""
    import copy

    import numpy as np
    import torch

    from pregen_pde_tpu_torch.models.ffno import FFNO2d
    from pregen_pde_tpu_torch.models.fno import FNO2d
    from pregen_pde_tpu_torch.profile_scot import event_ms
    from pregen_pde_tpu_torch.training.losses import relative_lp_loss
    from pregen_pde_tpu_torch.utils.parity import rel_l2

    rng = np.random.default_rng(0)
    x = rng.standard_normal((16, 128, 128, 7)).astype(np.float32)
    x[..., 4] = rng.random((16, 128, 128)) < 0.2  # the contract's hole mask
    y = rng.standard_normal((16, 128, 128, 3)).astype(np.float32)
    xc, yc = torch.from_numpy(x), torch.from_numpy(y)
    xd, yd = xc.to(dev), yc.to(dev)

    def forward_and_grads(model, xx, yy):
        """The forward and each parameter's gradient of the relative L2 loss
        (p = 2: the L1 loss's sign flips where pred ≈ y would swamp a
        float32-against-float64 comparison)."""
        model.zero_grad(set_to_none=True)
        out = model(xx)
        relative_lp_loss(out, yy, p=2).backward()
        return out.detach(), {k: q.grad for k, q in model.named_parameters()}

    for name, cls in (("fno", FNO2d), ("ffno", FFNO2d)):
        torch.manual_seed(0)  # weights from seed 0, as the CLI's
        model = cls(7, 3).eval()
        ref, ref_grads = forward_and_grads(copy.deepcopy(model).double(), xc.double(),
                                           yc.double())
        model = model.to(dev)
        got, grads = forward_and_grads(model, xd, yd)
        torch.cuda.synchronize()
        err = rel_l2(got.cpu(), ref)
        bar = MODEL_VS_F64_BARS[name]
        say(f"[26] {name} 128², B=16, seed 0: card (float32, TF32 off) vs CPU float64 forward "
            f"rel L2 {err:.3e} (bar {bar:.1e}) | {card}")
        if not (torch.isfinite(got).all() and err <= bar):
            fail(f"{name}: card vs CPU float64 forward rel L2 {err:.3e} > {bar:.1e}")
        grad_bars = MODEL_GRAD_VS_F64_BARS[name]
        if set(grad_bars) != set(grads):
            fail(f"{name}: gradient bars for {sorted(grad_bars)}, parameters {sorted(grads)}")
        worst = []
        for k, g in grads.items():
            gerr = rel_l2(g.cpu(), ref_grads[k])
            worst.append((gerr / grad_bars[k], k, gerr))
            if not (torch.isfinite(g).all() and gerr <= grad_bars[k]):
                fail(f"{name}: gradient of {k} card vs CPU float64 rel L2 {gerr:.3e} > "
                     f"{grad_bars[k]:.1e}")
        say(f"[26] {name} gradients of a relative-L2 loss, card vs CPU float64, per parameter: "
            + ", ".join(f"{k} {e:.2e}" for _, k, e in sorted(worst, key=lambda w: w[1]))
            + f"; closest to its bar {max(worst)[1]} at {max(worst)[0]:.2f} of it | {card}")
        with torch.no_grad():
            fwd = (event_ms(lambda: model(xd), 10), device_ms(lambda: model(xd)))
        model.train()
        if name == "ffno":  # the backcast dropout is on in training
            model.set_dropout_generator(torch.Generator(device=dev).manual_seed(1))
        opt = torch.optim.AdamW(model.parameters(), lr=1e-4)

        def step():
            loss = relative_lp_loss(model(xd), yd, p=1)
            opt.zero_grad()
            loss.backward()
            opt.step()

        train = (event_ms(step, 10), device_ms(step))
        say(f"[26] {name} 128², B=16: forward {fwd[0]:.3f} ms by events, {fwd[1]:.3f} ms "
            f"device; train step {train[0]:.3f} ms by events, {train[1]:.3f} ms device | {card}")
        del model, opt


def fno_phases(dev, card: str, fpo, fpo_regular) -> None:
    """Phases 26-27: FNO and FFNO, the JAX CLI's default model and its
    factorised sibling (plain PyTorch: the JAX package runs them in XLA,
    outside any Pallas kernel), on the card against float64 on the CPU and
    timed; then ``train``, ``evaluate`` and ``mix-sweep`` with them through
    the CLI on phase 10's and phase 21's shards."""
    import numpy as np

    model_phase(dev, card)

    # -- 27. the CLI with FNO by default, and FFNO ---------------------------------------------
    from pregen_pde_tpu_torch.kernels import build

    work = tempfile.mkdtemp(prefix="smoke_fno_", dir=build.BUILD_DIR)
    try:
        hard = os.path.join(work, "fpo_multi_hole.npy")
        easy = os.path.join(work, "fpo_regular.npy")
        np.save(hard, fpo)
        np.save(easy, fpo_regular)
        ckpt = os.path.join(work, "ckpt")

        def cli(*argv):
            cmd = [sys.executable, "-m", "pregen_pde_tpu_torch", *argv]
            t0 = time.perf_counter()
            r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
            wall = time.perf_counter() - t0
            if r.returncode != 0:
                fail(f"{argv[0]} rc {r.returncode}:\n{r.stdout[-2000:]}\n"
                     f"{r.stderr[-4000:]}")
            return [json.loads(l) for l in r.stdout.splitlines() if l.startswith("{")], wall

        lines, wall = cli("train", "--data", hard, "--epochs", "1", "--batch-size", "16",
                          "--ckpt", ckpt)
        rec = [l for l in lines if "epoch" in l]
        counts = [l["kernel_launches"] for l in lines if "kernel_launches" in l]
        if len(rec) != 1 or len(counts) != 1:
            fail(f"train (FNO) printed no epoch or launch line: {lines}")
        numbers = [rec[0]["train_loss"], rec[0]["val_mean_rel_%"]]
        if not (np.isfinite(numbers).all() and os.path.isfile(os.path.join(ckpt, "best.pt"))):
            fail(f"train (FNO): non-finite numbers or no best.pt: {lines}")
        say(f"[27] train (no --model: FNO) --data fpo_multi_hole --epochs 1 --batch-size 16: "
            f"{wall:.2f} s wall incl. start-up; {rec[0]['time_s']:.2f} s for the epoch's steps; "
            f"train loss {rec[0]['train_loss']:.5f}, val mean {rec[0]['val_mean_rel_%']:.4f} %; "
            f"launches {counts[0]} (FNO's model runs no hand-written kernel; its optimizer "
            f"the fused AdamW) | {card}")
        lines, wall = cli("evaluate", "--data", hard, "--ckpt", os.path.join(ckpt, "best.pt"),
                          "--batch-size", "16")
        res = [l for l in lines if "patterns" in l]
        if len(res) != 1 or not np.isfinite(flat_numbers(res[0])).all():
            fail(f"evaluate (FNO) of best.pt: no finite result: {lines}")
        say(f"[27] evaluate (no --model: FNO) --ckpt best.pt: {wall:.2f} s wall incl. start-up; "
            f"[7] median rel {res[0]['patterns']['[7]']['median_rel_%']:.4f} %, all "
            f"{flat_numbers(res[0]).size} numbers finite | {card}")
        lines, wall = cli("mix-sweep", "--model", "ffno", "--hard", hard, "--easy", easy,
                          "--alphas", "0.5", "--total-trajectories", "16", "--epochs", "1",
                          "--batch-size", "16")
        alpha = [l for l in lines if l.get("alpha") == 0.5]
        if len(alpha) != 1 or lines[-1].keys() != {"0.5"}:
            fail(f"mix-sweep (FFNO) output malformed: {lines}")
        split_numbers = [v for k in ("test_hard", "test_easy") for v in alpha[0][k].values()]
        if not np.isfinite(split_numbers).all():
            fail(f"mix-sweep (FFNO): non-finite test numbers: {lines}")
        say(f"[27] mix-sweep --model ffno --alphas 0.5 --total-trajectories 16 --epochs 1: "
            f"{wall:.2f} s wall incl. start-up; test_hard mean "
            f"{alpha[0]['test_hard']['mean_rel_%']:.4f} %, test_easy mean "
            f"{alpha[0]['test_easy']['mean_rel_%']:.4f} % | {card}")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def cno_leaf_kind(name: str) -> str:
    """A CNO parameter's kind: its name with the model-level block's number
    dropped (``ResidualBlock_4.FILM_1.Dense_2.weight`` →
    ``ResidualBlock.FILM_1.Dense_2.weight``)."""
    head, rest = name.split(".", 1)
    return f"{head.rsplit('_', 1)[0]}.{rest}"


def cno_model_phase(dev, card: str) -> None:
    """Phase 28: the CLI's CNO at 128² on the card against float64 on the
    CPU, timed; then one filtered_lrelu at each of its three shapes on each
    ``upfirdn2d`` route."""
    import copy
    import dataclasses

    import numpy as np
    import torch

    from pregen_pde_tpu_torch.models.cno import CNO
    from pregen_pde_tpu_torch.ops import bias_act as ba
    from pregen_pde_tpu_torch.ops.filtered_lrelu import filtered_lrelu
    from pregen_pde_tpu_torch.profile_scot import event_ms
    from pregen_pde_tpu_torch.training.losses import relative_lp_loss
    from pregen_pde_tpu_torch.utils.parity import rel_l2

    def draw(b, seed):
        rng = np.random.default_rng(seed)
        x = rng.standard_normal((b, 128, 128, 7)).astype(np.float32)
        x[..., 4] = rng.random((b, 128, 128)) < 0.2  # the contract's hole mask
        t = rng.random(b).astype(np.float32)
        y = rng.standard_normal((b, 128, 128, 3)).astype(np.float32)
        return torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(y)

    lrelu = ba.activation_funcs["lrelu"]

    def forward_and_grads(model, x, t, y, take_signs=None):
        """The forward, each parameter's gradient of the relative L2 loss (p
        = 2) and the sign of every leaky ReLU's input, a call each; with
        ``take_signs`` (such a list), each leaky ReLU takes those signs in
        place of its input's."""
        signs, given = [], iter(take_signs or ())

        def recording(z, alpha):
            signs.append(z >= 0)
            pos = next(given).to(z.device) if take_signs is not None else signs[-1]
            return torch.where(pos, z, z * alpha)

        model.zero_grad(set_to_none=True)
        ba.activation_funcs["lrelu"] = dataclasses.replace(lrelu, func=recording)
        try:
            out = model(x, t)
        finally:
            ba.activation_funcs["lrelu"] = lrelu
        relative_lp_loss(out, y, p=2).backward()
        return out.detach(), {k: q.grad for k, q in model.named_parameters()}, signs

    # -- 28. the CLI's CNO: the card against float64 on the CPU ------------------------------
    torch.manual_seed(0)  # weights from seed 0, as the CLI's
    model = CNO(128, 7, out_dim=3).eval()
    n_params = sum(q.numel() for q in model.parameters())
    xc, tc, yc = draw(4, 0)
    model64 = copy.deepcopy(model).double()
    x64, t64, y64 = xc.double(), tc.double(), yc.double()
    t0 = time.perf_counter()
    ref, ref_grads, ref_signs = forward_and_grads(model64, x64, t64, y64)
    cpu_s = time.perf_counter() - t0
    model = model.to(dev)
    got, grads, got_signs = forward_and_grads(model, xc.to(dev), tc.to(dev), yc.to(dev))
    torch.cuda.synchronize()
    got_signs = [g.cpu() for g in got_signs]
    flips = sum(int((a != b).sum()) for a, b in zip(got_signs, ref_signs))
    points = sum(b.numel() for b in ref_signs)
    # float64 again, each leaky ReLU on the card's signs: what the flips account for
    _, same_sign_grads, _ = forward_and_grads(model64, x64, t64, y64, take_signs=got_signs)
    n_calls = len(ref_signs)
    del got_signs, ref_signs, model64
    err = rel_l2(got.cpu(), ref)
    say(f"[28] CNO (the CLI's: 3 layers, multiplier 32, 6 neck blocks, {n_params / 1e6:.2f} M "
        f"params) 128², B=4, seed 0: card (float32, TF32 off) vs CPU float64 forward rel L2 "
        f"{err:.3e} (bar {CNO_VS_F64_BAR:.1e}); leaky-ReLU inputs of opposite sign on the "
        f"two: {flips} of {points} ({n_calls} calls); CPU float64 forward and backward "
        f"{cpu_s:.1f} s | {card}")
    if not (torch.isfinite(got).all() and err <= CNO_VS_F64_BAR):
        fail(f"CNO: card vs CPU float64 forward rel L2 {err:.3e} > {CNO_VS_F64_BAR:.1e}")
    total = float(torch.sqrt(sum((g.double() ** 2).sum() for g in ref_grads.values())))
    worst, same_sign = {}, []
    for k, g in grads.items():
        r = ref_grads[k]
        if float(r.norm()) <= 1e-9 * total:  # no gradient in exact arithmetic
            gerr = float(g.double().norm()) / total
        else:
            gerr = rel_l2(g.cpu(), r)
        if not torch.isfinite(g).all():
            fail(f"CNO: gradient of {k} on the card is not finite")
        kind = cno_leaf_kind(k)
        worst[kind] = max(worst.get(kind, 0.0), gerr)
        if float(r.norm()) > 1e-9 * total:
            same_sign.append(rel_l2(g.cpu(), same_sign_grads[k]))
    if set(worst) != set(CNO_GRAD_VS_F64_BARS):
        fail(f"CNO: gradient bars for {sorted(CNO_GRAD_VS_F64_BARS)}, kinds {sorted(worst)}")
    say("[28] CNO gradients of a relative-L2 loss, card vs CPU float64, the worst of each kind: "
        + ", ".join(f"{k} {e:.2e}" for k, e in sorted(worst.items())) + f" | {card}")
    # a kind measured at exactly 0 (FILM's inp2lat layers under zero heads) has bar 0
    ratio = {k: e / CNO_GRAD_VS_F64_BARS[k] if CNO_GRAD_VS_F64_BARS[k] else 0.0
             for k, e in worst.items()}
    closest = max(ratio, key=ratio.get)
    say(f"[28] closest to its bar: {closest} at {ratio[closest]:.2f} of it; against float64 "
        f"on the card's leaky-ReLU signs the worst gradient is {max(same_sign):.2e} (the "
        f"{flips} flips account for the rest)")
    for k, e in worst.items():
        if not e <= CNO_GRAD_VS_F64_BARS[k]:
            fail(f"CNO: gradient of {k} card vs CPU float64 {e:.3e} > "
                 f"{CNO_GRAD_VS_F64_BARS[k]:.1e}")
    del ref, ref_grads, grads, got, same_sign_grads

    # ms a forward and an AdamW step at the CLI's batch, B = 16, upfirdn2d "auto" (matmul)
    xd, td, yd = (a.to(dev) for a in draw(16, 1))
    with torch.no_grad():
        fwd = (event_ms(lambda: model(xd, td), 10), device_ms(lambda: model(xd, td)))
    model.train()
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4)

    def step():
        loss = relative_lp_loss(model(xd, td), yd, p=1)
        opt.zero_grad()
        loss.backward()
        opt.step()

    train = (event_ms(step, 10), device_ms(step))
    say(f"[28] CNO 128², B=16, upfirdn2d auto (dense operators): forward {fwd[0]:.3f} ms by "
        f"events, {fwd[1]:.3f} ms device; AdamW train step {train[0]:.3f} ms by events, "
        f"{train[1]:.3f} ms device | {card}")
    del opt

    # one filtered_lrelu at each of the model's three shapes, on each route: the
    # lift's (same size, the widest), the first downsampling and the last upsampling
    acts = {"same-size": model.LiftProjectBlock_0.CNOBlock_0.AntiAliasedLReLu_0,
            "down": model.CNOBlock_0.AntiAliasedLReLu_0,
            "up": getattr(model, model.decoder[-1][2]).AntiAliasedLReLu_0}
    gen = torch.Generator(device=dev).manual_seed(2)
    for kind, act in acts.items():
        c, n_in, n_out = act.bias.numel(), act.in_size, act.out_size
        label = f"{kind} {c} ch {n_in}² → {n_out}²"
        x = torch.randn(16, c, n_in, n_in, generator=gen, device=dev)
        times, outs = {}, {}
        with torch.no_grad():
            for impl in ("auto", "matmul", "conv", "blocked"):
                fn = lambda: filtered_lrelu(x, act.fu, act.fd, act.bias, up=act.up,
                                            down=act.down, padding=act.padding, gain=2 ** 0.5,
                                            slope=0.2, impl=impl)
                outs[impl] = fn()
                times[impl] = device_ms(fn)
        for impl in ("matmul", "conv", "blocked"):
            e = rel_l2(outs[impl].cpu(), outs["auto"].cpu())
            if not e <= 2e-6:
                fail(f"filtered_lrelu {label}: route {impl} vs auto rel L2 {e:.3e} > 2e-6")
        # work: the dense operators' products against the taps' (each output of
        # a pass reads taps/up inputs on the way up, taps on the way down)
        tu, td_ = act.fu.shape[0], act.fd.shape[0]
        m_up = n_in * act.up + act.padding[0] + act.padding[1] - tu + 1
        bcs = 16 * c
        dense = 2 * bcs * (n_in * n_in * m_up + n_in * m_up * m_up
                           + m_up * m_up * n_out + m_up * n_out * n_out)
        taps = 2 * bcs * (n_in * m_up * tu / act.up + m_up * m_up * tu / act.up
                          + m_up * n_out * td_ + n_out * n_out * td_)
        nbytes = 4 * bcs * (n_in * n_in + n_out * n_out)
        b_ms, b_by = bound(nbytes, taps)
        say(f"[28] filtered_lrelu {label} (B=16, up {act.up} × {tu} taps, down {act.down} × "
            f"{td_} taps): device ms auto {times['auto']:.3f} | matmul {times['matmul']:.3f} | "
            f"conv {times['conv']:.3f} | blocked {times['blocked']:.3f}; the dense operators "
            f"{dense / 1e9:.2f} GFLOP against the taps' {taps / 1e9:.3f} "
            f"({dense / taps:.1f}x); bound {b_ms:.4f} ms ({b_by}, the taps' work) | {card}")
    del model


def cno_phases(dev, card: str, fpo, fpo_regular) -> None:
    """Phases 28-29: CNO, the reference's third model family and the
    default of ``finetune`` (plain PyTorch: the JAX package runs it in XLA,
    outside any Pallas kernel), on the card against float64 on the CPU and
    timed; then ``train``, ``evaluate``, ``mix-sweep`` and ``finetune`` with
    it through the CLI on phase 10's and phase 21's shards."""
    import numpy as np
    import torch

    from pregen_pde_tpu_torch.kernels import build
    from pregen_pde_tpu_torch.models.cno import CNO

    cno_model_phase(dev, card)

    # -- 29. the CLI with CNO -------------------------------------------------------------------
    work = tempfile.mkdtemp(prefix="smoke_cno_", dir=build.BUILD_DIR)
    try:
        hard = os.path.join(work, "fpo_multi_hole.npy")
        easy = os.path.join(work, "fpo_regular.npy")
        np.save(hard, fpo)
        np.save(easy, fpo_regular)
        ckpt = os.path.join(work, "ckpt")

        def cli(*argv):
            cmd = [sys.executable, "-m", "pregen_pde_tpu_torch", *argv]
            t0 = time.perf_counter()
            r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
            wall = time.perf_counter() - t0
            if r.returncode != 0:
                fail(f"{argv[0]} --model cno rc {r.returncode}:\n{r.stdout[-2000:]}\n"
                     f"{r.stderr[-4000:]}")
            return [json.loads(l) for l in r.stdout.splitlines() if l.startswith("{")], wall

        def epoch_line(lines, what):
            rec = [l for l in lines if "epoch" in l]
            if len(rec) != 1 or not np.isfinite([rec[0]["train_loss"],
                                                 rec[0]["val_mean_rel_%"]]).all():
                fail(f"{what} (CNO): no finite epoch record: {lines}")
            return rec[0]

        lines, wall = cli("train", "--model", "cno", "--data", hard, "--epochs", "1",
                          "--batch-size", "16", "--ckpt", ckpt)
        rec = epoch_line(lines, "train")
        if not os.path.isfile(os.path.join(ckpt, "best.pt")):
            fail(f"train (CNO) wrote no best.pt: {lines}")
        say(f"[29] train --model cno --data fpo_multi_hole --epochs 1 --batch-size 16: "
            f"{wall:.2f} s wall incl. start-up; {rec['time_s']:.2f} s for the epoch's steps; "
            f"train loss {rec['train_loss']:.5f}, val mean {rec['val_mean_rel_%']:.4f} % | {card}")
        lines, wall = cli("evaluate", "--model", "cno", "--data", hard, "--ckpt",
                          os.path.join(ckpt, "best.pt"), "--batch-size", "16")
        res = [l for l in lines if "patterns" in l]
        if len(res) != 1 or not np.isfinite(flat_numbers(res[0])).all():
            fail(f"evaluate (CNO) of best.pt: no finite result: {lines}")
        say(f"[29] evaluate --model cno --ckpt best.pt: {wall:.2f} s wall incl. start-up; [7] "
            f"median rel {res[0]['patterns']['[7]']['median_rel_%']:.4f} %, all "
            f"{flat_numbers(res[0]).size} numbers finite | {card}")
        lines, wall = cli("mix-sweep", "--model", "cno", "--hard", hard, "--easy", easy,
                          "--alphas", "0.5", "--total-trajectories", "16", "--epochs", "1",
                          "--batch-size", "16")
        alpha = [l for l in lines if l.get("alpha") == 0.5]
        if len(alpha) != 1 or lines[-1].keys() != {"0.5"}:
            fail(f"mix-sweep (CNO) output malformed: {lines}")
        if not np.isfinite([v for k in ("test_hard", "test_easy")
                            for v in alpha[0][k].values()]).all():
            fail(f"mix-sweep (CNO): non-finite test numbers: {lines}")
        say(f"[29] mix-sweep --model cno --alphas 0.5 --total-trajectories 16 --epochs 1: "
            f"{wall:.2f} s wall incl. start-up; test_hard mean "
            f"{alpha[0]['test_hard']['mean_rel_%']:.4f} %, test_easy mean "
            f"{alpha[0]['test_easy']['mean_rel_%']:.4f} % | {card}")
        # a pretrained base of other channel counts, so that both adapters run
        base = os.path.join(work, "base.pt")
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            torch.save(CNO(128, 5, out_dim=2).state_dict(), base)
        lines, wall = cli("finetune", "--model", "cno", "--pretrained", base,
                          "--base-in-channels", "5", "--base-out-channels", "2", "--data", hard,
                          "--epochs", "1", "--batch-size", "16")
        rec = epoch_line(lines, "finetune")
        tiers = [l["tier_parameters"] for l in lines if "tier_parameters" in l]
        if len(tiers) != 1 or min(tiers[0].values()) <= 0 or "best_mean_val_rel_%" not in lines[-1]:
            fail(f"finetune (CNO) output malformed, or a tier empty: {lines}")
        say(f"[29] finetune --model cno --pretrained base.pt (5 → 2 channels; the data's 7 → 3: "
            f"both adapters) --epochs 1 --batch-size 16: {wall:.2f} s wall incl. start-up; "
            f"{rec['time_s']:.2f} s for the epoch's steps; parameters per tier "
            f"{json.dumps(tiers[0])}; train loss {rec['train_loss']:.5f}, val mean "
            f"{rec['val_mean_rel_%']:.4f} % | {card}")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def flat_numbers(res: dict):
    """Every number of an evaluate result, in a fixed order."""
    import numpy as np

    out = []
    for key in sorted(res["patterns"]):
        out += [v for _, v in sorted(res["patterns"][key].items())]
    for step in res["accumulation"]:
        out += [v for _, v in sorted(step.items())]
    return np.asarray(out, np.float64)


def check_masked_shard(data, workload: str, n_traj: int, parabolic_inlet, schedules) -> None:
    """Phase 10's checks of one masked-geometry shard."""
    import numpy as np

    n = 128
    if data.shape != (n_traj, 21, n, n, 6):
        fail(f"{workload} shard shape {data.shape}")
    if not np.isfinite(data).all():
        fail(f"{workload} shard holds non-finite values")
    mask, sdf, re_norm = data[..., 4], data[..., 5], data[..., 3]
    if not np.isin(mask, (0.0, 1.0)).all():
        fail(f"{workload}: mask is not binary")
    holes = mask[:, 0].sum(axis=(1, 2))
    if workload == "ldc_regular" and holes.max() != 0:
        fail("ldc_regular: mask is not all fluid")
    if workload == "fpo_multi_hole" and holes.min() < 2 * 16 * 16:
        fail(f"fpo_multi_hole: {holes.min()} hole cells < 2·16²")
    if not (sdf.min() >= -1.0 and sdf.max() <= 1.0 and ((sdf < 0) == (mask == 1)).all()):
        fail(f"{workload}: SDF outside [-1, 1] or not < 0 exactly where mask = 1")
    if not (re_norm.min() >= 0.0 and re_norm.max() <= 1.0):
        fail(f"{workload}: Re_norm outside [0, 1]")
    # the flow agrees with the Re channel: Umax = Re·ν/L (ν = 1.5e-5, L = 2)
    u_max = schedules.denormalize_re(re_norm[:, 0, 0, 0].astype(np.float64)) * 1.5e-5 / 2.0
    u = data[..., 0].astype(np.float64)
    if workload == "ldc_regular":
        got, ref = u[:, :, -1, :], np.broadcast_to(u_max[:, None, None], u[:, :, -1, :].shape)
    else:
        inlet = parabolic_inlet(n, 1.0).astype(np.float64)[1:n - 1]
        got, ref = u[:, :, 1:n - 1, 0], inlet[None, None, :] * u_max[:, None, None]
    rel = np.abs(got - ref).max(axis=(1, 2)) / np.abs(ref).max(axis=(1, 2))
    if not rel.max() <= 1e-5:
        fail(f"{workload}: {'lid' if workload == 'ldc_regular' else 'inlet'} u differs "
             f"from Re·ν/L by rel {rel.max():.3e} > 1e-5")


if __name__ == "__main__":
    main()
