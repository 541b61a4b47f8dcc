"""pregen_pde_tpu_torch — the PyTorch + CUDA port of ``pregen_pde_tpu``.

The JAX package beside it is the reference; each module here mirrors the
module of the same path there and is held against it by the
``tests/test_torch_*.py`` parity tests.

- ``core``     — re-exports the JAX package's numpy-only config and grid.
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

Entry point: ``python -m pregen_pde_tpu_torch generate --workload
{ns_spectral,fpo_regular,fpo_hole,fpo_multi_hole,ldc_regular}``. The
package never imports ``jax``.
"""

__version__ = "0.1.0"
