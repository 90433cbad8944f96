"""The row statistics that the port's short-attention forwards write for
their backwards, and the backwards built on them:

- the (B, H, Sq) log-sum-exp of ``short_attention_packed_with_lse`` (kernel
  #1's plain version) and of the ``short`` backend's ``*_with_lse`` forwards
  (#3, #5) against a float64 recomputation from the same inputs: bounded,
  log(max(sum_j exp(clip(s)), 2^-100)); unbounded, the log-sum-exp of the
  valid logits; a kv_len 0 row log(2^-100) bounded and -1e30 unbounded;
- the explicit backwards (#2, #4, #6's plain versions) from that lse against
  ``jax.vjp`` of the JAX package's ``short_attention_packed`` and
  ``short_attention_bhsd`` (Pallas, interpret mode), in fp32, bf16 and fp16.

Tolerances: the lse, 1e-5 relative and 1e-6 absolute (fp32 sums of the same
exponentials against float64). The backwards, absolute and relative: fp32
1e-5, bf16 2e-2 (as ``tests/test_torch_short_attention_bwd.py``), fp16 2e-3
(as ``tests/test_torch_fp16_attention.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vision_pt_tpu.ops.short_attention as jax_short
from vision_pt_tpu_torch.ops import short_attention as short

TOL = {"float32": 1e-5, "bfloat16": 2e-2, "float16": 2e-3}
NEG_INF = -1e30


def _inputs(shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _lse64(q, k, heads, kv_lens, bounded):
    """float64 row log-sum-exp of packed (B, S, H*D) inputs."""
    batch, sq, width = q.shape
    dim = width // heads
    qh = q.reshape(batch, sq, heads, dim).astype(np.float64)
    kh = k.reshape(batch, k.shape[1], heads, dim).astype(np.float64)
    s = np.einsum("bqhd,bkhd->bhqk", qh, kh) * dim**-0.5
    out = np.empty(s.shape[:3])
    for b in range(batch):
        n = s.shape[-1] if kv_lens is None else min(kv_lens[b], s.shape[-1])
        x = s[b, :, :, :n]
        if bounded:
            out[b] = np.log(np.maximum(np.exp(np.clip(x, -60, 60)).sum(-1), 2.0**-100))
        else:
            out[b] = (np.logaddexp.reduce(x, axis=-1) if n else NEG_INF)
    return out


@pytest.mark.parametrize("bounded", [True, False])
@pytest.mark.parametrize("case", [(3, 37, 37, 2, 64, [37, 0, 20]),
                                  (2, 16, 40, 1, 128, None)],
                         ids=["s37_kv0", "sq16_sk40_d128"])
def test_packed_lse_against_float64(case, bounded):
    batch, sq, sk, heads, dim, kv_lens = case
    q, k, v = _inputs([(batch, sq, heads * dim), (batch, sk, heads * dim),
                       (batch, sk, heads * dim)])
    lens = None if kv_lens is None else torch.tensor(kv_lens)
    out, lse = short.short_attention_packed_with_lse(
        *(torch.from_numpy(x) for x in (q, k, v)), heads, lens, bounded=bounded)
    assert lse.dtype == torch.float32 and tuple(lse.shape) == (batch, heads, sq)
    want = _lse64(q, k, heads, kv_lens, bounded)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-6)
    if kv_lens is not None:
        assert float(lse[1].max()) == float(np.float32(np.log(2.0**-100)
                                                       if bounded else NEG_INF))
        assert bool((out[1] == 0).all())
    # the same output as the forward that writes no lse
    again = short.short_attention_packed(*(torch.from_numpy(x) for x in (q, k, v)),
                                         heads, lens, bounded=bounded)
    torch.testing.assert_close(out, again, rtol=0, atol=0)


def test_short_backend_lse_in_both_layouts():
    """The BSHD and BHSD forwards write the same (B, H, Sq) lse, the
    unbounded packed one."""
    q, k, v = _inputs([(2, 24, 2, 64), (2, 30, 2, 64), (2, 30, 2, 64)], seed=3)
    lens = torch.tensor([30, 0])
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    _, lse = short.short_attention_with_lse(tq, tk, tv, lens)
    _, lse_t = short.short_attention_bhsd_with_lse(
        *(x.transpose(1, 2) for x in (tq, tk, tv)), lens)
    want = _lse64(q.reshape(2, 24, 128), k.reshape(2, 30, 128), 2, [30, 0], False)
    np.testing.assert_allclose(lse.numpy(), want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(lse, lse_t, rtol=0, atol=0)


def _grads_match(ours, theirs, live, dtype):
    for name, a, b in zip("qkv", ours, theirs):
        a = a.float().numpy()
        b = np.asarray(b.astype(jnp.float32))
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a[live], b[live], atol=TOL[dtype],
                                   rtol=TOL[dtype], err_msg=f"d{name}")
        assert (a[~live] == 0).all(), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("bounded", [True, False])
def test_packed_backward_from_lse_matches_jax_vjp(bounded, dtype):
    batch, sq, sk, heads, dim, kv_lens = 3, 37, 45, 2, 64, [45, 0, 21]
    width = heads * dim
    q, k, v, do = _inputs([(batch, sq, width), (batch, sk, width),
                           (batch, sk, width), (batch, sq, width)], seed=1)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jlens = jnp.asarray(kv_lens, jnp.int32)

    def jax_fn(q, k, v):
        return jax_short.short_attention_packed(q, k, v, heads, jlens,
                                                interpret=True, bounded=bounded)

    _, vjp = jax.vjp(jax_fn, *(jnp.asarray(x, jdt) for x in (q, k, v)))
    theirs = vjp(jnp.asarray(do, jdt))
    tq, tk, tv, tdo = (torch.from_numpy(x).to(tdt) for x in (q, k, v, do))
    lens = torch.tensor(kv_lens)
    _, lse = short.short_attention_packed_with_lse(tq, tk, tv, heads, lens,
                                                   bounded=bounded)
    ours = short.short_attention_packed_bwd(tq, tk, tv, lse, tdo, heads, lens,
                                            bounded=bounded)
    assert all(g.dtype == tdt for g in ours)
    _grads_match(ours, theirs, np.asarray(kv_lens) > 0, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_bhsd_backward_from_lse_matches_jax_vjp(dtype):
    batch, heads, sq, sk, dim, kv_lens = 2, 2, 40, 40, 64, [40, 13]
    q, k, v, do = _inputs([(batch, heads, sq, dim), (batch, heads, sk, dim),
                           (batch, heads, sk, dim), (batch, heads, sq, dim)], seed=2)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jlens = jnp.asarray(kv_lens, jnp.int32)
    _, vjp = jax.vjp(
        lambda q, k, v: jax_short.short_attention_bhsd(q, k, v, jlens, None, True),
        *(jnp.asarray(x, jdt) for x in (q, k, v)))
    theirs = vjp(jnp.asarray(do, jdt))
    tq, tk, tv, tdo = (torch.from_numpy(x).to(tdt) for x in (q, k, v, do))
    lens = torch.tensor(kv_lens)
    _, lse = short.short_attention_bhsd_with_lse(tq, tk, tv, lens)
    ours = short.short_attention_bhsd_bwd(tq, tk, tv, lse, tdo, lens)
    _grads_match(ours, theirs, np.ones(batch, bool), dtype)


@pytest.mark.parametrize("bhsd", [None, False, True], ids=["packed", "bshd", "bhsd"])
def test_fp32_backward_saves_no_lse_and_ignores_one(bhsd):
    """fp32 recomputes its statistics: the autograd forward writes no lse
    (saved as None), and the explicit backward gives the same bits with or
    without one; bf16 still saves an lse."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs([(2, 13, 2, 64)] * 4, seed=5))
    lens = torch.tensor([13, 6])
    if bhsd is None:
        q, k, v, do = (x.reshape(2, 13, 128) for x in (q, k, v, do))
        fwd = lambda *x: short.short_attention_packed(*x, 2, lens, bounded=True)
        with_lse = lambda *x: short.short_attention_packed_with_lse(*x, 2, lens, bounded=True)
        bwd = lambda q, k, v, lse, do: short.short_attention_packed_bwd(
            q, k, v, lse, do, 2, lens, bounded=True)
    else:
        if bhsd:
            q, k, v, do = (x.transpose(1, 2) for x in (q, k, v, do))
        fwd = lambda *x: (short.short_attention_bhsd if bhsd else short.short_attention)(*x, lens)
        with_lse = lambda *x: (short.short_attention_bhsd_with_lse if bhsd
                               else short.short_attention_with_lse)(*x, lens)
        bwd = lambda q, k, v, lse, do: (short.short_attention_bhsd_bwd if bhsd
                                        else short.short_attention_bwd)(q, k, v, lse, do, lens)
    for dtype, saves_lse in ((torch.float32, False), (torch.bfloat16, True)):
        leaves = [x.to(dtype).requires_grad_() for x in (q, k, v)]
        out = fwd(*leaves)
        assert (out.grad_fn.saved_tensors[4] is not None) == saves_lse
        out.backward(do.to(dtype))
        if dtype == torch.float32:
            _, lse = with_lse(*(x.detach() for x in leaves))
            for again in (bwd(*(x.detach() for x in leaves), None, do),
                          bwd(*(x.detach() for x in leaves), lse, do)):
                for leaf, g in zip(leaves, again):
                    torch.testing.assert_close(leaf.grad, g, rtol=0, atol=0)
