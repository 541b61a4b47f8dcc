"""Main-path multi-tier learning-rate groups (counterpart of the JAX
package's ``training/tiers.py``), applied to the port's parameter names.

The reference scOT trainer (`scOT/trainer.py:77-227`) builds up to four
param groups:

- ``embeddings``      — torch names containing "embeddings" or
  "patch_recovery" → ``learning_rate_embedding_recovery``, weight decay ON
  for every member (biases included);
- ``standard``        — HF decay params (everything except LayerNorm params
  and names containing the substring "bias") → base lr, decay ON;
- ``time_embedding``  — ConditionalLayerNorm params that are not decay
  params → ``learning_rate_time_embedding``, decay OFF;
- ``no_weight_decay`` — the rest → base lr, decay OFF.

Two reference quirks are kept: the conditional norm's *scale* Linear
(``time_scale``) has its kernel in **standard** while its bias and the whole
``time_bias`` Linear land in **time_embedding**; and the CPB-MLP kernels
(torch module ``continuous_position_bias_mlp``, whose name trips the
literal "bias" test) go to **no_weight_decay**.

The port's parameter names are the flax paths joined with ``.``, with a
Dense or Conv ``kernel`` named ``weight`` (``models/convert.py``);
``flax_path`` maps them back, so the labels are the JAX function's own.
"""

from __future__ import annotations

_EMBEDDING_KEYS = (
    "patch_embed",
    "embed_norm",
    "pos_embed",
    "mask_token",
    "patch_recovery",
    "recovery_mixup",
)


def scot_main_tier_fn(path: tuple[str, ...]) -> str:
    """flax param path → tier name, the reference's `scOT/trainer.py:91-122`
    order under its pinned transformers==4.29.2 decay filter."""
    joined = "/".join(path)
    if any(k in joined for k in _EMBEDDING_KEYS):
        return "embeddings"
    if "cpb_mlp1" in path or "cpb_mlp2" in path:
        return "no_weight_decay"
    if (path[-1] == "kernel" and "time_bias" not in path) or \
            path[-1] in ("logit_scale", "layer_scale"):
        return "standard"
    if "time_scale" in path or "time_bias" in path:
        return "time_embedding"
    return "no_weight_decay"


# per-tier weight-decay semantics for `build_optimizer` (one decay flag per
# param group, as torch sets it)
SCOT_TIER_DECAY = {
    "standard": "all",
    "no_weight_decay": "none",
    "embeddings": "all",
    "time_embedding": "none",
}


def scot_main_tiers(lr: float, lr_embedding: float | None,
                    lr_time_embedding: float | None) -> dict[str, float]:
    """lr → tier map of the groups the reference creates for a flag
    combination (`trainer.py:82-199`)."""
    return {
        "standard": lr,
        "no_weight_decay": lr,
        "embeddings": lr_embedding if lr_embedding is not None else lr,
        "time_embedding": lr_time_embedding if lr_time_embedding is not None else lr,
    }


def flax_path(name: str) -> tuple[str, ...]:
    """A port parameter name → its flax path ("a.b.weight" → ("a", "b",
    "kernel"))."""
    parts = name.split(".")
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return tuple(parts)


def scot_tier_of(name: str) -> str:
    """A port parameter name → its tier (``scot_main_tier_fn`` of its flax
    path)."""
    return scot_main_tier_fn(flax_path(name))
