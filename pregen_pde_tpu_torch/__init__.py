"""pregen_pde_tpu_torch — the PyTorch + CUDA port of ``pregen_pde_tpu``.

The JAX package beside it is the reference; each module here mirrors the
module of the same path there and is held against it by the
``tests/test_torch_*.py`` parity tests.

- ``core``     — configs and spectral grids (the port's own copy).
- ``native``   — the C++ shard writer, built with g++ at first use.
- ``utils``    — device/dtype policy, numpy↔torch parity helpers.
- ``fields``   — GRF initial conditions; box, disk and hole masks and the
  batched SDF.
- ``solvers``  — difficulty schedules, the pseudo-spectral NS solver on
  ``torch.fft`` and the masked-geometry projection solver (the plain
  versions), the hand-written CUDA CN+AB2 stepper (``spectral_ns_cuda``)
  and Chorin projection stepper (``ns_projection_cuda``), sources under
  ``csrc/``, and the Ghia cavity validation.
- ``datagen``  — horizon-bucketed batch generation (spectral NS and the
  masked FPO/LDC generators) into the ``(N, T, H, W, 6)`` contract and the
  shard writers.
- ``ops``      — the CPB bias gather and the wrappers of the hand-written
  CUDA window attention (K4) and Swin-V2 block (K3) forwards.
- ``models``   — scOT (``ScOT``) and the flax-checkpoint converter.
- ``training`` — time-pair datasets and error metrics (numpy).
- ``evalx``    — AR rollout patterns and the accumulation error.

Entry points: ``python -m pregen_pde_tpu_torch generate --workload
{ns_spectral,fpo_regular,fpo_hole,fpo_multi_hole,ldc_regular}`` and
``python -m pregen_pde_tpu_torch evaluate --model scot-B``. The package
imports nothing of JAX and nothing of the JAX package.
"""

__version__ = "0.1.0"
