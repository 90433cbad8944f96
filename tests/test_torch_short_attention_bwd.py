"""The backward of the port's packed short attention (its plain PyTorch
version, which the autograd Function runs for CPU tensors) against the
gradient of the JAX package's Pallas kernel in interpret mode, on the same
numpy-made inputs and output cotangent.

Tolerances, absolute and relative: fp32 1e-5 (same arithmetic, sums in
another order; measured 1.2e-5 absolute on gradients of size ~11); bf16 2e-2
(p and ds are rounded to bf16 before their products on both sides and the
gradients are rounded to bf16; where a sum in another order flips one
rounding the two differ by one bf16 step, measured 7.8e-3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_pt_tpu.ops.short_attention import (
    short_attention_packed as jax_short_attention_packed,
)
from vision_pt_tpu_torch.ops.short_attention import (
    short_attention_packed,
    short_attention_packed_bwd,
    short_attention_packed_bwd_reference,
    short_attention_packed_with_lse,
)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
CASES = [
    # (batch, sq, sk, heads, dim, kv_lens), as in the forward's test
    (2, 37, 37, 2, 64, [37, 21]),  # S not a multiple of 8, paired heads
    (2, 24, 24, 3, 32, [0, 17]),  # odd heads (unpaired), a kv_len of 0
    (3, 16, 40, 2, 64, [40, 0, 9]),  # Sq != Sk
    (2, 40, 16, 1, 128, None),  # Sq > Sk, D = 128, no kv_lens
]


def _inputs(batch, sq, sk, heads, dim, seed=0):
    rng = np.random.default_rng(seed)
    return [
        rng.normal(size=(batch, s, heads * dim)).astype(np.float32) * scale
        for s, scale in ((sq, 2.0), (sk, 2.0), (sk, 2.0), (sq, 1.0))
    ]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bounded", [True, False])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c[:5])))
def test_plain_backward_matches_jax_kernel(case, bounded, dtype):
    batch, sq, sk, heads, dim, kv_lens = case
    q, k, v, do = _inputs(batch, sq, sk, heads, dim)
    jlens = None if kv_lens is None else jnp.asarray(kv_lens, jnp.int32)
    tlens = None if kv_lens is None else torch.tensor(kv_lens)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def jax_fn(q, k, v):
        return jax_short_attention_packed(q, k, v, heads, jlens,
                                          interpret=True, bounded=bounded)

    _, vjp = jax.vjp(jax_fn, *(jnp.asarray(x, jdt) for x in (q, k, v)))
    theirs = vjp(jnp.asarray(do, jdt))

    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_() for x in (q, k, v))
    out = short_attention_packed(tq, tk, tv, heads, tlens, bounded=bounded)
    out.backward(torch.from_numpy(do).to(tdt))
    _, lse = short_attention_packed_with_lse(
        tq.detach(), tk.detach(), tv.detach(), heads, tlens, bounded=bounded)
    explicit = short_attention_packed_bwd_reference(
        tq.detach(), tk.detach(), tv.detach(), lse,
        torch.from_numpy(do).to(tdt), heads, tlens, bounded=bounded,
    )
    rows = np.ones(batch, bool) if kv_lens is None else np.asarray(kv_lens) > 0
    for name, ours, ref, again in zip("qkv", (tq.grad, tk.grad, tv.grad),
                                      theirs, explicit):
        assert ours.dtype == tdt
        # autograd runs exactly the explicit backward
        torch.testing.assert_close(ours, again, rtol=0, atol=0)
        ours = ours.float().numpy()
        ref = np.asarray(ref.astype(jnp.float32))
        assert np.isfinite(ours).all(), name
        np.testing.assert_allclose(ours[rows], ref[rows], atol=TOL[dtype],
                                   rtol=TOL[dtype], err_msg=f"d{name}")
        # a kv_len == 0 row gets zero grads in both modes; the JAX kernel
        # gives zeros there only when bounded
        assert (ours[~rows] == 0).all(), name
        if bounded:
            np.testing.assert_array_equal(ref[~rows], 0.0)


def test_key_rows_past_kv_len_get_exactly_zero_grads():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(2, 20, 20, 2, 64))
    lens = torch.tensor([13, 20])
    for bounded in (True, False):
        _, lse = short_attention_packed_with_lse(q, k, v, 2, lens,
                                                 bounded=bounded)
        _, dk, dv = short_attention_packed_bwd_reference(q, k, v, lse, do, 2,
                                                         lens, bounded=bounded)
        assert (dk[0, 13:] == 0).all() and (dv[0, 13:] == 0).all()
        assert (dk[0, :13] != 0).any() and (dk[1] != 0).any()


@pytest.mark.parametrize("bounded", [True, False])
def test_plain_backward_is_the_gradient_of_the_plain_forward(bounded):
    """float64 gradcheck of the autograd Function on the CPU: the explicit
    backward is the derivative of the plain forward (the bounded clip is
    not reached at these logits)."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.tensor(rng.normal(size=(2, 7, 2 * 8)), dtype=torch.float64,
                            requires_grad=True) for _ in range(3))
    lens = torch.tensor([7, 4])
    assert torch.autograd.gradcheck(
        lambda q, k, v: short_attention_packed(q, k, v, 2, lens, bounded=bounded),
        (q, k, v), eps=1e-6, atol=1e-7, rtol=1e-5,
    )


def test_backward_wrapper_raises_on_device_it_has_no_kernel_for():
    q = torch.zeros(1, 8, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        short_attention_packed_bwd(q, q, q, q[:, :, 0], q, 1)
