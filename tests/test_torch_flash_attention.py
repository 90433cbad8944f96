"""The port's flash attention (its plain PyTorch versions, which the autograd
Function runs for CPU tensors) against the JAX package's Pallas flash kernel
in interpret mode with 64 x 64 blocks, forward and ``jax.vjp``, on the same
numpy-made inputs and output cotangent; and the dispatcher's routing to it.

Tolerances, absolute and relative: fp32 1e-5 (same arithmetic, sums in
another order); bf16 2e-2 (the weights are rounded to bf16 before the PV
product against the running max of a 64-key block in the JAX kernel and
against the row max here, ``ds`` is rounded to bf16 on both sides, and the
results are rounded to bf16)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_pt_tpu.ops.flash_attention import flash_attention as jax_flash
from vision_pt_tpu_torch.ops import attention as tattn
from vision_pt_tpu_torch.ops.flash_attention import (
    NEG_INF,
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_reference,
    flash_attention_reference,
    flash_attention_with_lse,
)
from tests.test_torch_sdxl_distributed import one_torch_thread  # noqa: F401,E402

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
CASES = [
    # (batch, sq, sk, heads, dim, kv_lens, causal)
    (2, 64, 64, 2, 64, [64, 0], False),  # one block, a kv_len of 0
    (2, 100, 100, 1, 64, [100, 37], False),  # ragged S
    (1, 192, 192, 2, 64, None, True),  # causal, three blocks
    (2, 100, 100, 2, 64, [100, 61], True),  # causal with kv_lens
    (2, 64, 192, 1, 128, [150, 0], False),  # Sq != Sk, D = 128
    (2, 100, 64, 1, 64, [64, 40], False),  # Sq > Sk
    (1, 129, 129, 1, 64, [128], False),  # one key past a 128-key tile
    (2, 257, 257, 2, 64, [257, 129], True),  # causal, kv_len one past a tile
    (2, 200, 320, 1, 128, [255, 0], False),  # Sq != Sk, D = 128, a zero row
]


def _inputs(batch, sq, sk, heads, dim, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(batch, s, heads, dim)).astype(np.float32)
            for s in (sq, sk, sk, sq)]


def _lens(kv_lens, framework):
    if kv_lens is None:
        return None
    if framework == "jax":
        return jnp.asarray(kv_lens, jnp.int32)
    return torch.tensor(kv_lens)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c[:5]))
                         + ("_causal" if c[6] else ""))
def test_plain_versions_match_jax_kernel(case, dtype):
    batch, sq, sk, heads, dim, kv_lens, causal = case
    q, k, v, do = _inputs(batch, sq, sk, heads, dim)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jlens = _lens(kv_lens, "jax")

    def jax_fn(q, k, v):
        return jax_flash(q, k, v, jlens, causal=causal, block_q=64, block_k=64,
                         interpret=True)

    jout, vjp = jax.vjp(jax_fn, *(jnp.asarray(x, jdt) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(do, jdt))

    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_() for x in (q, k, v))
    tlens = _lens(kv_lens, "torch")
    out = flash_attention(tq, tk, tv, tlens, causal=causal)
    out.backward(torch.from_numpy(do).to(tdt))
    assert out.dtype == tdt and out.shape == (batch, sq, heads, dim)
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(jout.astype(jnp.float32)),
                               atol=TOL[dtype], rtol=TOL[dtype])
    # autograd runs exactly the explicit backward
    ref_out, lse = flash_attention_reference(tq.detach(), tk.detach(),
                                             tv.detach(), tlens, causal=causal)
    explicit = flash_attention_bwd(tq.detach(), tk.detach(), tv.detach(),
                                   ref_out, lse, torch.from_numpy(do).to(tdt),
                                   tlens, causal=causal)
    for name, ours, again, theirs in zip("qkv", (tq.grad, tk.grad, tv.grad),
                                         explicit, jgrads):
        assert ours.dtype == tdt
        torch.testing.assert_close(ours, again, rtol=0, atol=0)
        ours = ours.float().numpy()
        assert np.isfinite(ours).all(), name
        np.testing.assert_allclose(ours, np.asarray(theirs.astype(jnp.float32)),
                                   atol=TOL[dtype], rtol=TOL[dtype],
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_lse_and_zero_rows(causal):
    """The LSE is the log-sum-exp of the valid logits; a kv_len 0 row gives
    output 0, an LSE of -1e30 and exactly zero gradients, and key rows past
    kv_len get exactly zero dk, dv."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(3, 40, 40, 2, 64, seed=2))
    lens = torch.tensor([40, 0, 23])
    out, lse = flash_attention_reference(q, k, v, lens, causal=causal)
    assert lse.shape == (3, 2, 40) and lse.dtype == torch.float32
    logits = np.einsum("bqhd,bkhd->bhqk", q.double().numpy(),
                       k.double().numpy()) * 64**-0.5
    for b, n in enumerate(lens.tolist()):
        for i in range(40):
            cols = min(n, i + 1) if causal else n
            if cols == 0:
                continue
            want = np.logaddexp.reduce(logits[b, :, i, :cols], axis=-1)
            np.testing.assert_allclose(lse[b, :, i].numpy(), want, rtol=1e-5, atol=1e-6)
    assert bool((out[1] == 0).all()) and bool((lse[1] == NEG_INF).all())
    dq, dk, dv = flash_attention_bwd_reference(q, k, v, out, lse, do, lens,
                                               causal=causal)
    for g in (dq, dk, dv):
        assert bool(torch.isfinite(g).all()) and bool((g[1] == 0).all())
    assert bool((dk[2, 23:] == 0).all()) and bool((dv[2, 23:] == 0).all())
    assert bool((dk[2, :23] != 0).any())


@pytest.mark.parametrize("causal", [False, True])
def test_plain_backward_gradcheck(causal):
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.normal(size=(2, 5, 2, 8))).requires_grad_()
    k = torch.from_numpy(rng.normal(size=(2, 7, 2, 8))).requires_grad_()
    v = torch.from_numpy(rng.normal(size=(2, 7, 2, 8))).requires_grad_()
    lens = torch.tensor([7, 4])
    assert torch.autograd.gradcheck(
        lambda q, k, v: flash_attention(q, k, v, lens, causal=causal),
        (q, k, v), eps=1e-6, atol=1e-6,
    )


def test_lse_is_not_differentiable():
    q = torch.randn(1, 8, 1, 64, requires_grad=True)
    out, lse = flash_attention_with_lse(q, q, q)
    assert out.requires_grad and not lse.requires_grad


def test_no_fallback_off_the_cpu():
    """A tensor that is neither on the CPU nor on a CUDA device has no kernel:
    the wrappers raise instead of running the plain versions."""
    q = torch.empty(1, 8, 1, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention_bwd(q, q, q, q, torch.empty(1, 1, 8, device="meta"), q)


# ------------------------------------------------------------------ dispatch


@pytest.fixture
def flash_calls(monkeypatch):
    calls = []
    real = tattn.flash_attention

    def counting(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(tattn, "flash_attention", counting)
    return calls


def _qkv(sq, sk=None, dim=64, seed=3):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(1, s, 1, dim)).astype(np.float32))
            for s in (sq, sk or sq, sk or sq)]


@pytest.mark.parametrize("sq,sk,dim,masked,on_cuda,want", [
    (1024, 1024, 64, False, True, "flash"),
    (1024, 1100, 128, False, True, "flash"),
    (1023, 1024, 64, False, True, "xla"),
    (1024, 1023, 64, False, True, "xla"),
    (1024, 1024, 64, True, True, "xla"),
    (1024, 1024, 32, False, True, "xla"),
    (1024, 1024, 64, False, False, "xla"),
], ids=["flash", "flash_d128", "short_q", "short_k", "mask", "d32", "cpu"])
def test_auto_routes_like_the_jax_gate(flash_calls, monkeypatch, sq, sk, dim,
                                       masked, on_cuda, want):
    monkeypatch.setattr(tattn, "_on_cuda", lambda x: on_cuda)
    q, k, v = _qkv(sq, sk, dim)
    mask = torch.ones(1, sk, dtype=torch.bool) if masked else None
    lens = None if masked else torch.tensor([sk - 5])
    with tattn.attention_dtype(None):
        out = tattn.dot_product_attention(q, k, v, mask=mask, kv_lens=lens)
        plain = tattn.dot_product_attention(q, k, v, mask=mask, kv_lens=lens,
                                            backend="xla")
    assert len(flash_calls) == (want == "flash")
    torch.testing.assert_close(out, plain, rtol=1e-5, atol=1e-5)


def test_flash_backend_takes_no_mask(flash_calls):
    q, k, v = _qkv(16)
    with pytest.raises(ValueError, match="not a full mask"):
        tattn.dot_product_attention(q, k, v, mask=torch.ones(1, 16, dtype=torch.bool),
                                    backend="flash")
    out = tattn.dot_product_attention(q, k, v, backend="flash", is_causal=True)
    assert out.dtype == torch.float32 and len(flash_calls) == 1
    with pytest.raises(ValueError, match="sequence_parallel"):
        tattn.dot_product_attention(q, k, v, backend="ring")
