"""The port's ``short`` attention backend (``short_attention`` on (B, S, H, D),
``short_attention_bhsd`` on (B, H, S, D), and
``dot_product_attention(backend="short")``) against the JAX package's Pallas
kernels in interpret mode, forward and gradients, on the same numpy-made
inputs and output cotangent. On the CPU the port's wrappers run their plain
PyTorch versions, which ``chip_smoke.py`` holds against the CUDA kernels.

The JAX ``short_attention_bhsd`` picks between two TPU schedules of one
function (``_use_all_heads``: one program per batch element, or per batch
element and head); both are run here by patching that rule.

Tolerances, absolute and relative: fp32 1e-5 (the same arithmetic, sums in
another order), bf16 2e-2 (the weights, p and ds are rounded to bf16 before
their products on both sides, at places that may differ by one rounding), as
in ``tests/test_torch_short_attention.py``. A row with kv_len 0 is exactly 0
in the port, output and gradients; the unbounded JAX kernels give the mean of
v over the padded block there (a kept divergence), so the other rows are
compared and these asserted 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vision_pt_tpu.ops.short_attention as jax_short
from vision_pt_tpu.ops.attention import (
    dot_product_attention as jax_dot_product_attention,
)
from vision_pt_tpu_torch.ops import short_attention as short
from vision_pt_tpu_torch.ops.attention import dot_product_attention

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
DIM = 64
CASES = [
    # (batch, sq, sk, heads, kv_lens)
    (2, 8, 8, 2, None),  # S 8, every key
    (2, 37, 37, 2, [37, 21]),  # S not a multiple of 8, a partial kv_len
    (2, 266, 266, 2, [266, 0]),  # JiT-B/16's S, a kv_len of 0
    (3, 16, 40, 2, [40, 0, 9]),  # Sq != Sk
]
IDS = ["s8", "s37", "s266", "sq16_sk40"]


def _inputs(batch, sq, sk, heads, seed=0):
    """q, k, v, do in (B, S, H, D), float32."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(batch, s, heads, DIM)).astype(np.float32) * scale
            for s, scale in ((sq, 2.0), (sk, 2.0), (sk, 2.0), (sq, 1.0))]


def _jax_run(fn, arrays, do, dtype):
    jdt = getattr(jnp, dtype)
    out, vjp = jax.vjp(fn, *(jnp.asarray(x, jdt) for x in arrays))
    grads = vjp(jnp.asarray(do, jdt))
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *grads)]


def _torch_run(fn, arrays, do, dtype):
    tdt = getattr(torch, dtype)
    leaves = [torch.from_numpy(x).to(tdt).requires_grad_() for x in arrays]
    out = fn(*leaves)
    assert out.dtype == tdt and out.shape == leaves[0].shape
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(do).to(tdt))
    assert all(g.dtype == tdt for g in grads)
    return [x.detach().float().numpy() for x in (out, *grads)]


def _assert_match(ours, theirs, kv_lens, dtype):
    """Batch elements with kv_len > 0 agree; the others are 0 in the port,
    output and every gradient."""
    batch = ours[0].shape[0]
    live = np.ones(batch, bool) if kv_lens is None else np.asarray(kv_lens) > 0
    for name, a, b in zip(("out", "dq", "dk", "dv"), ours, theirs):
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a[live], b[live], atol=TOL[dtype],
                                   rtol=TOL[dtype], err_msg=name)
        assert (a[~live] == 0).all(), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bshd_matches_jax(case, dtype):
    batch, sq, sk, heads, kv_lens = case
    *qkv, do = _inputs(batch, sq, sk, heads)
    jlens = None if kv_lens is None else jnp.asarray(kv_lens, jnp.int32)
    tlens = None if kv_lens is None else torch.tensor(kv_lens)
    theirs = _jax_run(
        lambda q, k, v: jax_short.short_attention(q, k, v, jlens, None, True),
        qkv, do, dtype)
    ours = _torch_run(lambda q, k, v: short.short_attention(q, k, v, tlens),
                      qkv, do, dtype)
    _assert_match(ours, theirs, kv_lens, dtype)


@pytest.mark.parametrize("all_heads", [True, False], ids=["all_heads", "per_head"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bhsd_matches_jax_on_both_schedules(case, dtype, all_heads, monkeypatch):
    taken = []

    def rule(qb, kb):
        taken.append(all_heads)
        return all_heads

    monkeypatch.setattr(jax_short, "_use_all_heads", rule)
    batch, sq, sk, heads, kv_lens = case
    *qkv, do = (np.ascontiguousarray(x.transpose(0, 2, 1, 3))
                for x in _inputs(batch, sq, sk, heads))
    jlens = None if kv_lens is None else jnp.asarray(kv_lens, jnp.int32)
    tlens = None if kv_lens is None else torch.tensor(kv_lens)
    theirs = _jax_run(
        lambda q, k, v: jax_short.short_attention_bhsd(q, k, v, jlens, None, True),
        qkv, do, dtype)
    assert taken == [all_heads] * 2  # the forward and the backward
    ours = _torch_run(lambda q, k, v: short.short_attention_bhsd(q, k, v, tlens),
                      qkv, do, dtype)
    _assert_match(ours, theirs, kv_lens, dtype)


@pytest.mark.parametrize("attention_dtype", [None, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_dot_product_attention_short_matches_jax(attention_dtype):
    """fp32 inputs, cast to the attention dtype first on both sides; the
    output comes back in fp32."""
    batch, sq, sk, heads, kv_lens = CASES[1]
    *qkv, do = _inputs(batch, sq, sk, heads, seed=1)
    dtype = "float32" if attention_dtype is None else "bfloat16"
    jax_dtype = None if attention_dtype is None else jnp.bfloat16
    theirs = _jax_run(
        lambda q, k, v: jax_dot_product_attention(
            q, k, v, kv_lens=jnp.asarray(kv_lens, jnp.int32), backend="short",
            attention_dtype=jax_dtype),
        qkv, do, "float32")
    ours = _torch_run(
        lambda q, k, v: dot_product_attention(
            q, k, v, kv_lens=torch.tensor(kv_lens), backend="short",
            attention_dtype=attention_dtype),
        qkv, do, "float32")
    _assert_match(ours, theirs, kv_lens, dtype)


@pytest.mark.parametrize("kwargs", [
    {"mask": np.ones((2, 8), bool)},
    {"is_causal": True},
], ids=["mask", "causal"])
def test_dot_product_attention_short_takes_kv_lens_only(kwargs):
    q = np.zeros((2, 8, 2, DIM), np.float32)
    match = r"short backend takes kv_lens only \(no mask/causal\)"
    with pytest.raises(ValueError, match=match):
        jax_dot_product_attention(
            *(jnp.asarray(q),) * 3, backend="short",
            **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
               for k, v in kwargs.items()})
    with pytest.raises(ValueError, match=match):
        dot_product_attention(
            *(torch.from_numpy(q),) * 3, backend="short",
            **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
               for k, v in kwargs.items()})


def test_bhsd_of_a_transposed_view_equals_bshd():
    """The BHSD entry reads any strides: the transposed view of BSHD tensors
    gives the BSHD entry's output and gradients, transposed."""
    *qkv, do = (torch.from_numpy(x) for x in _inputs(2, 37, 37, 2))
    lens = torch.tensor([37, 5])
    leaves = [x.clone().requires_grad_() for x in qkv]
    out = short.short_attention(*leaves, lens)
    grads = torch.autograd.grad(out, leaves, do)
    leaves_t = [x.clone().requires_grad_() for x in qkv]
    out_t = short.short_attention_bhsd(*(x.transpose(1, 2) for x in leaves_t), lens)
    grads_t = torch.autograd.grad(out_t, leaves_t, do.transpose(1, 2))
    for a, b in zip((out, *grads), (out_t.transpose(1, 2), *grads_t)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_plain_backward_is_the_autograd_backward():
    *qkv, do = (torch.from_numpy(x) for x in _inputs(2, 16, 24, 2))
    lens = torch.tensor([24, 11])
    leaves = [x.clone().requires_grad_() for x in qkv]
    auto = torch.autograd.grad(short.short_attention(*leaves, lens), leaves, do)
    _, lse = short.short_attention_with_lse(*qkv, lens)
    explicit = short.short_attention_bwd(*qkv, lse, do, lens)
    for a, b in zip(auto, explicit):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert short.short_attention.launches == 0  # the CPU launches no kernel


def test_wrappers_raise_on_device_they_have_no_kernel_for():
    q = torch.zeros(1, 8, 1, DIM, device="meta")
    for fn in (short.short_attention, short.short_attention_bhsd):
        with pytest.raises(ValueError, match="no kernel"):
            fn(q, q, q)
    with pytest.raises(ValueError, match="no kernel"):
        short.short_attention_bwd(q, q, q, q[:, :, :, 0], q)


@pytest.mark.parametrize("make, match", [
    # fp16 is taken, but not beside bf16 (and float64 not at all)
    (lambda: (torch.zeros(1, 8, 2, 64, dtype=torch.float16),
              torch.zeros(1, 8, 2, 64, dtype=torch.bfloat16)),
     "bfloat16, float16, float32"),
    (lambda: torch.zeros(1, 8, 2, 32, dtype=torch.bfloat16), "64 or 128"),
    (lambda: torch.zeros(1, 8, 2, 68, dtype=torch.bfloat16)[..., :64], "aligned"),
], ids=["fp16", "d32", "misaligned"])
def test_kernel_check_names_what_it_takes(make, match):
    """What the CUDA wrappers refuse before a launch (the check runs on any
    device; on the card it raises before the kernel)."""
    made = make()
    q, k = made if isinstance(made, tuple) else (made, made)
    with pytest.raises(ValueError, match=match):
        short._check_strided(q, k, k)
    if q.dtype == torch.float16:  # fp16 alone is taken
        short._check_strided(q, q, q)
