"""Multi-axis rotary position embeddings, Flux style (port of
``vision_pt_tpu/ops/rope.py``).

The frequency tables are host-side NumPy, identical to the JAX package's:
(seq, head_dim // 2, 2) with cos at ``[..., 0]`` and sin at ``[..., 1]``.
``apply_rope`` rotates **interleaved** (even, odd) feature pairs in fp32 and
casts back, not the half-split pairs most PyTorch code rotates.
"""

from __future__ import annotations

import numpy as np
import torch


def image_position_indices(height: int, width: int, rope_axes: int = 3,
                           y_index: int = 1, x_index: int = 2) -> np.ndarray:
    """(zero, y, x) position ids of a (height // 2, width // 2) token grid
    (the latent sides come pre-doubled), flattened row-major."""
    pos = np.zeros((height // 2, width // 2, rope_axes), dtype=np.float32)
    pos[..., y_index] += np.arange(height // 2, dtype=np.float32)[:, None]
    pos[..., x_index] += np.arange(width // 2, dtype=np.float32)[None, :]
    return pos.reshape(-1, rope_axes)


def _axis_frequencies(pos: np.ndarray, dim: int, theta: float) -> np.ndarray:
    """cos/sin table of one position axis, (seq, dim // 2, 2)."""
    assert dim % 2 == 0, "dim must be even"
    scale = np.arange(0, dim, 2, dtype=np.float64) / dim
    omega = 1.0 / (theta**scale)
    angles = np.outer(pos.astype(np.float64), omega)
    return np.stack([np.cos(angles), np.sin(angles)], axis=-1).astype(np.float32)


def get_rope_frequencies(position_indices: np.ndarray, dim_sizes: list[int],
                         theta: float = 10000.0) -> np.ndarray:
    """The per-axis tables concatenated, (seq, sum(dim_sizes) // 2, 2)."""
    assert len(dim_sizes) == position_indices.shape[-1]
    return np.concatenate([_axis_frequencies(position_indices[..., i], dim, theta)
                           for i, dim in enumerate(dim_sizes)], axis=-2)


def apply_rope(x: torch.Tensor, freqs: torch.Tensor) -> torch.Tensor:
    """Rotate x's interleaved (even, odd) feature pairs.

    x: (..., seq, head_dim); freqs: (seq, head_dim // 2, 2), broadcastable
    against x's leading dims. fp32 arithmetic, the result in x's dtype."""
    x32 = x.float()
    freqs = freqs.to(x.device, torch.float32)
    cos, sin = freqs[..., 0], freqs[..., 1]
    x_even, x_odd = x32[..., 0::2], x32[..., 1::2]
    out = torch.stack([x_even * cos - x_odd * sin, x_even * sin + x_odd * cos], dim=-1)
    return out.reshape(x.shape).to(x.dtype)


def apply_rope_qk(q: torch.Tensor, k: torch.Tensor,
                  freqs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The same table applied to q and k."""
    return apply_rope(q, freqs), apply_rope(k, freqs)


class RoPEFrequency:
    """Frequency-table builder: the tables depend only on the sequence's
    geometry, so they are computed on the host once per shape."""

    def __init__(self, dim_sizes: list[int], theta: float = 10000.0):
        self.dim_sizes = list(dim_sizes)
        self.theta = theta

    def get_image_position_indices(self, height: int, width: int, y_index: int = 1,
                                   x_index: int = 2) -> np.ndarray:
        return image_position_indices(height, width, len(self.dim_sizes), y_index, x_index)

    def get_text_position_indices(self, seq_len: int) -> np.ndarray:
        return np.zeros((seq_len, len(self.dim_sizes)), dtype=np.float32)

    def __call__(self, position_indices: np.ndarray,
                 device: str | torch.device | None = None) -> torch.Tensor:
        return torch.as_tensor(
            get_rope_frequencies(position_indices, self.dim_sizes, self.theta), device=device)
