"""pregen_pde_tpu_torch — the PyTorch + CUDA port of ``pregen_pde_tpu``.

The JAX package beside it is the reference; each module here mirrors the
module of the same path there and is held against it by the
``tests/test_torch_*.py`` parity tests.

- ``core``     — re-exports the JAX package's numpy-only config and grid.
- ``utils``    — device/dtype policy, numpy↔torch parity helpers.
- ``fields``   — GRF initial conditions, no-hole mask and SDF.
- ``solvers``  — difficulty schedules, the pseudo-spectral NS solver on
  ``torch.fft`` (the plain versions) and the hand-written CUDA CN+AB2
  stepper (``spectral_ns_cuda``, sources under ``csrc/``).
- ``datagen``  — horizon-bucketed batch generation into the
  ``(N, T, H, W, 6)`` contract and the shard writers.

Entry point: ``python -m pregen_pde_tpu_torch generate --workload ns_spectral``.
The package never imports ``jax``.
"""

__version__ = "0.1.0"
