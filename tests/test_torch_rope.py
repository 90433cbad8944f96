"""The port's ``ops/rope.py`` against the JAX package's, on the CPU.

The frequency tables are host-side NumPy in both packages and must be equal
bit for bit; ``apply_rope`` rotates interleaved (even, odd) pairs, not the
half-split ones, so it is held against JAX on a table with a distinct cos /
sin for every pair, within 1e-6 of the largest element (fp32 both sides;
bf16 inputs within one bf16 rounding).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_pt_tpu.ops import rope as jrope
from vision_pt_tpu_torch.ops import rope


def test_image_position_indices_equal():
    for args in ((8, 12), (6, 4, 2, 0, 1), (10, 10, 3, 2, 1)):
        np.testing.assert_array_equal(rope.image_position_indices(*args),
                                      jrope.image_position_indices(*args))


@pytest.mark.parametrize("dims", [[8, 12, 12], [32, 32], [16]])
def test_frequency_tables_equal(dims):
    pos = np.random.default_rng(0).integers(-20, 40, size=(37, len(dims))).astype(np.float32)
    np.testing.assert_array_equal(rope.get_rope_frequencies(pos, dims, 500.0),
                                  jrope.get_rope_frequencies(pos, dims, 500.0))
    builder, jbuilder = rope.RoPEFrequency(dims), jrope.RoPEFrequency(dims)
    grid = builder.get_image_position_indices(12, 8) if len(dims) == 3 else pos
    np.testing.assert_array_equal(builder(grid).numpy(), np.asarray(jbuilder(grid)))
    np.testing.assert_array_equal(builder.get_text_position_indices(5),
                                  jbuilder.get_text_position_indices(5))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["bhsd", "bshd_broadcast"])
def test_apply_rope_rotates_interleaved_pairs_as_jax(dtype, layout):
    rng = np.random.default_rng(1)
    s, d = 9, 16
    angles = rng.uniform(-3, 3, size=(s, d // 2))  # a distinct angle per pair
    freqs = np.stack([np.cos(angles), np.sin(angles)], -1).astype(np.float32)
    shape = (2, 3, s, d) if layout == "bhsd" else (2, s, 3, d)
    table = freqs if layout == "bhsd" else freqs[:, None]
    x = rng.normal(size=shape).astype(np.float32)
    q, k = rng.normal(size=(2,) + shape).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jrope.apply_rope(jnp.asarray(x, jdt), jnp.asarray(table)), np.float32)
    got = rope.apply_rope(torch.from_numpy(x).to(tdt), torch.from_numpy(table))
    assert got.dtype == tdt and got.shape == shape
    tol = 1e-6 if dtype == "float32" else 8e-3
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())
    jq, jk = jrope.apply_rope_qk(jnp.asarray(q), jnp.asarray(k), jnp.asarray(table))
    tq, tk = rope.apply_rope_qk(torch.from_numpy(q), torch.from_numpy(k),
                                torch.from_numpy(table))
    for ours, theirs in ((tq, jq), (tk, jk)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=0, atol=1e-6 * 4)
    # the half-split rotation (first half against second) is another function
    xt, cos, sin = torch.from_numpy(x), torch.from_numpy(table[..., 0]), torch.from_numpy(
        table[..., 1])
    lo, hi = xt[..., :d // 2], xt[..., d // 2:]
    half = torch.cat([lo * cos - hi * sin, lo * sin + hi * cos], -1)
    assert not np.allclose(half.numpy(), want, atol=1e-2)


def test_rotation_keeps_the_norm_of_each_pair():
    x = torch.randn(1, 4, 6, 8)
    freqs = rope.RoPEFrequency([8])(np.arange(6, dtype=np.float32)[:, None])
    out = rope.apply_rope(x, freqs)
    pairs = lambda t: t.reshape(*t.shape[:-1], -1, 2).norm(dim=-1)  # noqa: E731
    torch.testing.assert_close(pairs(out), pairs(x))
