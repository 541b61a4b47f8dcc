"""Checkpoints of the port's models (scOT, FNO, FFNO, CNO, and any of them
wrapped in fine-tuning adapters): a flax parameter tree → the port's
state_dict, and the ``--ckpt`` loader of ``evaluate`` (and ``--pretrained``
of ``finetune``).

The port's modules carry the flax names (``models/scot.py``, ``fno.py``,
``ffno.py``, ``cno.py``, ``training/finetune.py``), so a flax path maps to a
state_dict key by joining with ``.``; only the layouts differ:

- Dense ``kernel`` (in, out) → ``weight`` (out, in);
- Conv ``kernel`` HWIO → ``weight`` OIHW (the depthwise (7, 7, 1, C), CNO's
  3×3 and the adapters' 1×1 too);
- the patch recovery's ConvTranspose ``kernel`` (k, k, in, out), applied by
  flax without a flip → a ``ConvTranspose2d`` ``weight`` (in, out, k, k),
  flipped in both spatial axes;
- every other leaf (``logit_scale``, ``layer_scale``, ``scale``/``bias`` of
  an unconditioned LayerNorm, ``mask_token``, ``pos_embed``, batch-norm
  affines, FNO's and FFNO's spectral weights, ``WNDense``'s ``v`` (in, out)
  and ``g``, CNO's GroupNorm/LayerNorm ``scale``/``bias``, activation
  biases, ``bn_scale``/``bn_bias`` and the ViT's ``pos_embedding``) as it
  is.

The kernel and plain routes of scOT share this one state_dict, as the JAX
routes share one tree; FNO's and FFNO's ``torch.fft`` route reads the tree
of JAX's truncated-DFT route as it is.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

RECOVERY = "patch_recovery"


def flatten(params: dict, prefix: str = "") -> dict:
    """Nested dict of arrays → {"a/b/c": array}; a flat dict passes through."""
    out = {}
    for k, v in params.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, path))
        else:
            out[path] = v
    return out


def state_dict_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """A flax parameter tree of scOT, FNO, FFNO or CNO (nested, or flattened with
    ``/``-joined paths) of numpy arrays → the port's state_dict of the same
    model (float32)."""
    sd = {}
    for path, value in flatten(params).items():
        parts = path.split("/")
        a = np.array(value, dtype=np.float32)  # a writable copy
        if parts[-1] == "kernel":
            parts[-1] = "weight"
            if a.ndim == 2:
                a = a.T
            elif a.ndim == 4 and parts[0] == RECOVERY:
                a = a[::-1, ::-1].transpose(2, 3, 0, 1)
            elif a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            else:
                raise ValueError(f"unexpected kernel rank {a.ndim} at {path}")
        sd[".".join(parts)] = torch.from_numpy(np.ascontiguousarray(a))
    return sd


def load_checkpoint(model: torch.nn.Module, path: str | Path) -> None:
    """Load ``path`` into ``model`` (strict): an ``.npz`` of the flax tree
    flattened with ``/`` (``flax.traverse_util.flatten_dict(params,
    sep="/")``), or a ``.pt`` state_dict of the port."""
    path = Path(path)
    if not path.is_file():
        raise FileNotFoundError(f"no checkpoint file at {path}")
    if path.suffix == ".npz":
        with np.load(path) as z:
            sd = state_dict_from_flax({k: z[k] for k in z.files})
    elif path.suffix == ".pt":
        sd = torch.load(path, map_location="cpu", weights_only=True)
    else:
        raise ValueError(f"--ckpt takes a .npz of the flax tree or a .pt state_dict; got {path} "
                         "(orbax checkpoint directories are not read yet)")
    model.load_state_dict(sd, strict=True)
