"""The port's packed short attention (plain PyTorch version, which the wrapper
runs for CPU tensors) against the JAX package's Pallas kernel in interpret
mode, on the same inputs made with numpy.

Tolerances: fp32 1e-5 (same arithmetic, sums in another order); bf16 2e-2
(the unnormalised weights are rounded to bf16 before the PV product on both
sides, at places that may differ by one rounding)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_pt_tpu.ops.short_attention import (
    short_attention_packed as jax_short_attention_packed,
)
from vision_pt_tpu_torch.ops.short_attention import (
    short_attention_packed,
    short_attention_packed_reference,
)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
CASES = [
    # (batch, sq, sk, heads, dim, kv_lens)
    (2, 37, 37, 2, 64, [37, 21]),  # S not a multiple of 8, paired heads
    (2, 24, 24, 3, 32, [0, 17]),  # odd heads (unpaired), a kv_len of 0
    (3, 16, 40, 2, 64, [40, 0, 9]),  # Sq != Sk
    (2, 40, 16, 1, 128, None),  # Sq > Sk, D = 128, no kv_lens
]


def _inputs(batch, sq, sk, heads, dim, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return [
        rng.normal(size=(batch, s, heads * dim)).astype(np.float32) * 2.0
        for s in (sq, sk, sk)
    ]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bounded", [True, False])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c[:5])))
def test_plain_matches_jax_kernel(case, bounded, dtype):
    batch, sq, sk, heads, dim, kv_lens = case
    q, k, v = _inputs(batch, sq, sk, heads, dim, dtype)
    jlens = None if kv_lens is None else jnp.asarray(kv_lens, jnp.int32)
    tlens = None if kv_lens is None else torch.tensor(kv_lens)
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    theirs = jax_short_attention_packed(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), heads, jlens,
        interpret=True, bounded=bounded,
    )
    ours = short_attention_packed(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)), heads, tlens,
        bounded=bounded,
    )
    assert ours.dtype == tdt and ours.shape == (batch, sq, heads * dim)
    theirs = np.asarray(theirs.astype(jnp.float32))
    ours = ours.float().numpy()
    assert np.isfinite(ours).all()
    rows = np.ones(batch, bool) if kv_lens is None else np.asarray(kv_lens) > 0
    np.testing.assert_allclose(ours[rows], theirs[rows],
                               atol=TOL[dtype], rtol=TOL[dtype])
    # a kv_len == 0 row is 0 in both modes. The JAX kernel gives 0 only when
    # bounded; unbounded it returns the mean of v over the padded block.
    assert (ours[~rows] == 0).all()
    if bounded:
        np.testing.assert_array_equal(theirs[~rows], 0.0)


def test_kv_lens_clamp_to_sk():
    q, k, v = (torch.from_numpy(x) for x in _inputs(2, 8, 8, 1, 64, "float32"))
    big = short_attention_packed_reference(q, k, v, 1, torch.tensor([100, 8]))
    full = short_attention_packed_reference(q, k, v, 1, None)
    torch.testing.assert_close(big, full, rtol=0, atol=0)


def test_wrapper_raises_on_device_it_has_no_kernel_for():
    q = torch.zeros(1, 8, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        short_attention_packed(q, q, q, 1)
