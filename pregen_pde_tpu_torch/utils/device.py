"""Device and dtype policy.

Every function of the port takes an explicit ``device``; nothing picks one
behind the caller's back. On CUDA the float32 policy is stated and set:
matmuls and cuDNN convolutions run in full float32, never TF32 (TF32 keeps
~3 decimal digits and would sit far above the solver's 1e-4 f32 floor).
"""

from __future__ import annotations

import torch


def resolve_device(name: str | torch.device) -> torch.device:
    """``torch.device`` for ``name``; raises if CUDA is asked for and absent
    (a CUDA run never carries on silently on the CPU)."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(name)!r} requested but torch.cuda.is_available() "
                "is False on this host"
            )
        set_precision_policy(device)
    return device


def set_precision_policy(device: torch.device) -> dict:
    """Turn TF32 off for matmuls and cuDNN on CUDA; return the policy."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return {
        "device": str(device),
        "matmul_allow_tf32": bool(torch.backends.cuda.matmul.allow_tf32),
        "cudnn_allow_tf32": bool(torch.backends.cudnn.allow_tf32),
    }


def real_dtype(dtype: torch.dtype) -> torch.dtype:
    """Float dtype matching a real or complex dtype's precision."""
    return {torch.complex64: torch.float32, torch.complex128: torch.float64}.get(
        dtype, dtype
    )
