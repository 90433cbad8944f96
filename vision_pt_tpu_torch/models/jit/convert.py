"""JiT parameter layouts: the reference's checkpoint layout, the JAX package's
parameters, and the port's ``state_dict`` (the port's own copy of the rules in
``vision_pt_tpu/models/jit/convert.py``).

The port's modules carry the JAX package's names and head-dim layout, in
torch's tensor layout:

- ``Linear.weight`` is (out, in); the JAX ``kernel`` is (in, out).
- ``patch_embedder.proj_1`` / ``proj_2`` are Linears over flattened patches;
  the reference stores them as (bott, C, P, P) and (hidden, bott, 1, 1) convs.
- ``time_embedder.linear_1/2`` (and ``image_size_embedder``) are the
  reference's ``mlp.0/.2``.
- RoPE runs rotate-half on a DEINTERLEAVED head dim, so the q/k projections
  and qk-norm gains hold the reference's rows permuted within each head;
  attention scores are unchanged (q and k permute alike). PoPE's full-dim
  phases take no permutation (``rope_head_dim=None``), so its q/k rows and
  ``pope_bias`` (H, D) keep the reference's order.
- The variants' parameters (``skip_merge``, the sandwich norms, the U-JiT
  block lists, the IG and LoIG heads, ``pope_bias``) carry the same names in
  all three layouts and take the general rules above.
"""

from __future__ import annotations

import numpy as np
import torch

_MLP_SEQ_TO_LINEAR = [
    ("time_embedder.mlp.0.", "time_embedder.linear_1."),
    ("time_embedder.mlp.2.", "time_embedder.linear_2."),
    ("image_size_embedder.mlp.0.", "image_size_embedder.linear_1."),
    ("image_size_embedder.mlp.2.", "image_size_embedder.linear_2."),
]

_ROPE_PERMUTE_SUFFIXES = (
    ".to_q.weight", ".to_k.weight", ".to_q.bias", ".to_k.bias",
    ".q_norm.weight", ".k_norm.weight",
)


def _rope_deint_perm(head_dim: int, inverse: bool = False) -> np.ndarray:
    perm = np.concatenate([np.arange(0, head_dim, 2), np.arange(1, head_dim, 2)])
    return np.argsort(perm) if inverse else perm


def _permute_rope_param(value: np.ndarray, head_dim: int,
                        inverse: bool = False) -> np.ndarray:
    """Permute the out-features axis (rows of a 2-D weight) within each head."""
    perm = _rope_deint_perm(head_dim, inverse)
    if value.ndim == 1:
        return value.reshape(-1, head_dim)[:, perm].reshape(value.shape)
    return value.reshape(-1, head_dim, value.shape[1])[:, perm, :].reshape(value.shape)


def _np(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def reference_to_port(sd: dict, rope_head_dim: int | None = None) -> dict[str, torch.Tensor]:
    """Reference checkpoint layout -> the port's ``state_dict`` layout.
    ``rope_head_dim`` folds the deinterleave permutation into q/k (None for
    models that do not run RoPE)."""
    out: dict[str, torch.Tensor] = {}
    for key, value in sd.items():
        value = _np(value)
        if rope_head_dim is not None and key.endswith(_ROPE_PERMUTE_SUFFIXES):
            value = _permute_rope_param(value, rope_head_dim)
        for old, new in _MLP_SEQ_TO_LINEAR:
            if old in key:
                key = key.replace(old, new)
                break
        if key.endswith("patch_embedder.proj_1.weight") and value.ndim == 4:
            value = value.reshape(value.shape[0], -1)  # (bott, C*P*P)
        elif key.endswith("patch_embedder.proj_2.weight") and value.ndim == 4:
            value = value[:, :, 0, 0]  # (hidden, bott)
        out[key] = torch.from_numpy(np.array(value))
    return out


def port_to_reference(sd: dict, patch_size: int, in_channels: int,
                      rope_head_dim: int | None = None) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` layout -> reference checkpoint layout."""
    out: dict[str, torch.Tensor] = {}
    for key, value in sd.items():
        value = _np(value)
        for old, new in _MLP_SEQ_TO_LINEAR:
            if new in key:
                key = key.replace(new, old)
                break
        if key.endswith("patch_embedder.proj_1.weight") and value.ndim == 2:
            value = value.reshape(value.shape[0], in_channels, patch_size, patch_size)
        elif key.endswith("patch_embedder.proj_2.weight") and value.ndim == 2:
            value = value[:, :, None, None]
        if rope_head_dim is not None and key.endswith(_ROPE_PERMUTE_SUFFIXES):
            value = _permute_rope_param(value, rope_head_dim, inverse=True)
        out[key] = torch.from_numpy(np.array(value))
    return out


def from_jax_state(flat: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """The JAX package's parameters (``flatten_state`` keys, as numpy) -> the
    port's ``state_dict``: ``X.kernel`` (in, out) becomes ``X.weight``
    (out, in), ``embedding`` becomes ``embedding.weight``; every other
    parameter keeps its name and layout."""
    out: dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        value = np.asarray(value)
        if key.endswith(".kernel") and value.ndim == 2:
            key, value = key[: -len(".kernel")] + ".weight", value.T
        elif key == "embedding" or key.endswith(".embedding"):
            key = key + ".weight"
        out[key] = torch.from_numpy(np.array(value))
    return out
