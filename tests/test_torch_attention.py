"""The port's plain attention (``xla_attention_remat``: forward, and the
backward that recomputes the probabilities) against the JAX package's
``dot_product_attention`` and its ``jax.vjp``, on the same numpy-made inputs.

Tolerances, absolute and relative: fp32 1e-5 (same arithmetic, sums in
another order); bf16 2e-2 (the weights, ``p`` and ``ds`` are rounded to bf16
before their products on both sides, and so are the results; a sum in
another order can flip one bf16 rounding)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_pt_tpu.ops.attention import dot_product_attention as jax_attention
from vision_pt_tpu_torch.ops.attention import dot_product_attention

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
B, SQ, SK, H, D = 2, 11, 13, 2, 8


def _case(kind, rng):
    """(jax kwargs, torch kwargs, whether the mask takes a gradient)."""
    if kind == "bool_mask":
        mask = np.ones((B, SK), bool)
        mask[0, 9:] = False
        return {"mask": jnp.asarray(mask)}, {"mask": torch.from_numpy(mask)}
    if kind == "kv_lens":
        lens = np.asarray([13, 5], np.int32)
        return ({"kv_lens": jnp.asarray(lens)},
                {"kv_lens": torch.from_numpy(lens)})
    if kind == "additive_mask":
        bias = rng.normal(size=(B, 1, SQ, SK)).astype(np.float32)
        return {"mask": jnp.asarray(bias)}, {"mask": torch.from_numpy(bias)}
    if kind == "additive_key_bias":
        bias = rng.normal(size=(B, SK)).astype(np.float32)
        return {"mask": jnp.asarray(bias)}, {"mask": torch.from_numpy(bias)}
    return {}, {"is_causal": True} if kind == "causal" else {}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["bool_mask", "kv_lens", "additive_mask",
                                  "additive_key_bias", "causal"])
def test_remat_backward_matches_jax_vjp(kind, dtype):
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=(B, s, H, D)).astype(np.float32) * 2.0
               for s in (SQ, SK, SK))
    dout = rng.normal(size=(B, SQ, H, D)).astype(np.float32)
    jkw, tkw = _case(kind, rng)
    if kind == "causal":
        jkw = {"is_causal": True}
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    attention_dtype = None if dtype == "float32" else jdt

    mask = jkw.pop("mask", None)
    additive = mask is not None and mask.dtype != jnp.bool_

    def jax_fn(q, k, v, mask):
        return jax_attention(q, k, v, mask=mask, backend="xla",
                             attention_dtype=attention_dtype, **jkw)

    primals = [jnp.asarray(x, jdt) for x in (q, k, v)] + [mask]
    theirs_out, vjp = jax.vjp(jax_fn, *primals)
    theirs = vjp(jnp.asarray(dout, jdt))

    tensors = [torch.from_numpy(x).to(tdt).requires_grad_() for x in (q, k, v)]
    tmask = tkw.pop("mask", None)
    if additive:
        tmask.requires_grad_()
    ours_out = dot_product_attention(
        *tensors, mask=tmask, backend="xla",
        attention_dtype=None if dtype == "float32" else tdt, **tkw,
    )
    ours_out.backward(torch.from_numpy(dout).to(tdt))
    ours = [t.grad for t in tensors] + [tmask.grad if additive else None]

    tol = TOL[dtype]
    np.testing.assert_allclose(ours_out.detach().float().numpy(),
                               np.asarray(theirs_out.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    for name, a, b in zip(("dq", "dk", "dv", "dmask"), ours, theirs):
        if name == "dmask" and not additive:
            continue
        assert a.dtype == (torch.float32 if name == "dmask" else tdt), name
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b.astype(jnp.float32)),
                                   atol=tol, rtol=tol, err_msg=name)


def test_remat_saves_no_square_tensor():
    """Only (B, S, H, D) tensors and the (B, H, Sq, 1) log-sum-exp are kept
    between the forward and the backward."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.tensor(rng.normal(size=(1, 64, 2, 8)), dtype=torch.float32,
                            requires_grad=True) for _ in range(3))
    saved = []

    def pack(x):
        saved.append(tuple(x.shape))
        return x

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
        out = dot_product_attention(q, k, v, backend="xla",
                                    attention_dtype=None)
    out.sum().backward()
    assert all(64 * 64 not in (s[-1] * s[-2],) for s in saved if len(s) == 4), saved
    assert (1, 2, 64, 1) in saved
