"""Polar positional embedding (PoPE, arXiv 2509.10534) (port of
``vision_pt_tpu/models/jit/extension/pope.py``).

PoPE takes softplus(x) as a complex magnitude and rotates it by one phase per
head-dim channel (full-dim frequencies, not pairs), so q and k double to
2 * head_dim, laid out as interleaved (re, im) pairs like the JAX package's;
v keeps head_dim. A learned per-head phase bias, clipped to +-pi, turns K
only. The normalized variant rescales each token segment's positions to a
fixed span. PoPE attention always runs the plain attention, as the JAX
package runs it on XLA: the packed kernel takes one head dim for q, k and v.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ....ops.attention import dot_product_attention
from ..denoiser import Attention


def apply_pope(x: torch.Tensor, freqs: torch.Tensor,
               learned_bias: torch.Tensor | None = None) -> torch.Tensor:
    """x (B, S, H, D), freqs (S, D, 2) cos/sin, learned_bias (H, D) ->
    (B, S, H, 2 * D) in x's dtype; the softplus and the rotation run in
    fp32."""
    sp = F.softplus(x.float())
    cos = freqs[..., 0][None, :, None, :].float()
    sin = freqs[..., 1][None, :, None, :].float()
    if learned_bias is not None:
        b = learned_bias.float()[None, None, :, :]
        cos_b, sin_b = torch.cos(b), torch.sin(b)
        cos, sin = cos * cos_b - sin * sin_b, cos * sin_b + sin * cos_b
    out = torch.stack([sp * cos, sp * sin], dim=-1)
    return out.reshape(*x.shape[:-1], x.shape[-1] * 2).to(x.dtype)


class PopeEmbedder:
    """Full-dim phase tables, host-side NumPy: (seq, sum(axes_dims), 2)."""

    def __init__(self, pope_theta: float = 256.0,
                 axes_dims: tuple[int, ...] = (64, 128, 128),
                 axes_lens: tuple[int, ...] = (256, 128, 128),
                 zero_centered: tuple[bool, ...] = (False, True, True),
                 do_normalize: tuple[bool, ...] = (False, True, True),
                 normalize_by: float = 64.0):
        self.pope_theta = pope_theta
        self.axes_dims = tuple(axes_dims)
        self.axes_lens = tuple(axes_lens)
        self.zero_centered = tuple(zero_centered)
        self.do_normalize = tuple(do_normalize)
        self.normalize_by = normalize_by
        self.num_axes = len(axes_dims)

    def _omega(self, dim: int) -> np.ndarray:
        return 1.0 / (self.pope_theta ** (np.arange(0, dim, 1, dtype=np.float64) / dim))

    def _axis_freqs(self, positions: np.ndarray, dim: int) -> np.ndarray:
        angles = np.outer(positions.astype(np.float64), self._omega(dim))
        return np.stack([np.cos(angles), np.sin(angles)], axis=-1).astype(np.float32)

    def __call__(self, position_ids: np.ndarray) -> np.ndarray:
        parts = [self._axis_freqs(position_ids[..., i], dim)
                 for i, dim in enumerate(self.axes_dims)]
        return np.concatenate(parts, axis=-2)

    def prepare_image_position_ids(self, height: int, width: int,
                                   patch_size: int, global_index: int) -> np.ndarray:
        h, w = height // patch_size, width // patch_size
        pos = np.zeros((h, w, self.num_axes), dtype=np.float32)
        pos[:, :, 0] = global_index
        pos[:, :, 1] = np.arange(h // 2 - h, h // 2, dtype=np.float32)[:, None]
        pos[:, :, 2] = np.arange(w // 2 - w, w // 2, dtype=np.float32)[None, :]
        return pos.reshape(-1, self.num_axes)

    def prepare_context_position_ids(self, seq_len: int,
                                     global_index: int = 0) -> np.ndarray:
        pos = np.zeros((seq_len, self.num_axes), dtype=np.float32)
        pos[:, 0] = global_index
        pos[:, 1] = np.arange(seq_len)
        pos[:, 2] = np.arange(seq_len)
        return pos


class NormalizedPopeEmbedder(PopeEmbedder):
    """Positions of each normalized axis rescaled to ``normalize_by`` over the
    segment's own span, so a segment is embedded before concatenation."""

    def _axis_freqs_normalized(self, positions: np.ndarray, dim: int) -> np.ndarray:
        span = positions.max() - positions.min()
        if span != 0:
            positions = positions / span * self.normalize_by
        return self._axis_freqs(positions, dim)

    def __call__(self, position_ids: np.ndarray) -> np.ndarray:
        parts = [
            self._axis_freqs_normalized(position_ids[..., i], dim)
            if self.do_normalize[i] else self._axis_freqs(position_ids[..., i], dim)
            for i, dim in enumerate(self.axes_dims)
        ]
        return np.concatenate(parts, axis=-2)

    def prepare_image_position_ids(self, height: int, width: int,
                                   patch_size: int, global_index: int) -> np.ndarray:
        """Symmetric fractional centering."""
        h, w = height // patch_size, width // patch_size
        pos = np.zeros((h, w, self.num_axes), dtype=np.float32)
        pos[:, :, 0] = global_index
        pos[:, :, 1] = (np.arange(h, dtype=np.float32) - (h - 1) / 2)[:, None]
        pos[:, :, 2] = (np.arange(w, dtype=np.float32) - (w - 1) / 2)[None, :]
        return pos.reshape(-1, self.num_axes)


class PopeAttention(Attention):
    """Attention with PoPE's q/k transform and the learned K phase bias
    ``pope_bias`` (H, D), fp32 whatever the parameter dtype. q/k run at
    2 * head_dim (scale (2 * head_dim) ** -0.5), v at head_dim.

    Under tensor parallelism ``pope_bias`` stays whole, as the JAX rules
    keep it (H * D under 2**14 elements at every shipped width): each rank
    takes the rows of its own heads, and the gradient, which holds only
    those rows, is summed over the tensor ranks with the QKNorm gains'."""

    tensor_partial = (*Attention.tensor_partial, "pope_bias")

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.pope_bias = nn.Parameter(
            torch.zeros(self.num_heads, self.head_dim, dtype=torch.float32))

    def _local_bias(self, heads: int) -> torch.Tensor:
        """The rows of ``pope_bias`` for this rank's ``heads`` heads (all
        of them off a tensor-parallel mesh)."""
        if heads == self.num_heads:
            return self.pope_bias
        start = heads * self.to_q.weight.device_mesh.get_local_rank()
        return self.pope_bias[start:start + heads]

    def _pope_qk(self, q, k, query_freqs, key_freqs):
        if self.q_norm is not None:
            q = self.q_norm(q)
            k = self.k_norm(k)
        bias = torch.clamp(self._local_bias(k.shape[2]), -math.pi, math.pi)
        return (apply_pope(q, query_freqs),
                apply_pope(k, key_freqs, learned_bias=bias))

    def forward(self, hidden_states, rope_freqs, kv_lens=None, key_mask=None):
        b, s, _ = hidden_states.shape
        q = self._split_heads(self.to_q(hidden_states))
        k = self._split_heads(self.to_k(hidden_states))
        v = self._split_heads(self.to_v(hidden_states))
        q, k = self._pope_qk(q, k, rope_freqs, rope_freqs)
        if key_mask is not None:
            attn = dot_product_attention(q, k, v, mask=key_mask, backend="xla")
        else:
            attn = dot_product_attention(q, k, v, kv_lens=kv_lens, backend="xla")
        return self.to_o(attn.to(hidden_states.dtype).reshape(b, s, -1))
