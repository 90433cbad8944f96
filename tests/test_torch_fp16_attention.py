"""fp16 through the port's attention kernels: the plain PyTorch versions of
the packed short attention (kernels #1, #2; bounded and not) and of flash
attention (#7, #8), which the wrappers run for CPU tensors and which
``chip_smoke.py`` holds the fp16 CUDA kernels against, against the JAX
package's Pallas kernels in interpret mode with float16 inputs (they are
dtype-generic: outputs take the inputs' type), forward and gradients, on the
same numpy-made inputs and output cotangent.

Tolerance, absolute and relative, fp16: 2e-3. The weights (and ``p`` and
``ds`` in the backwards) are rounded to fp16 before their products on both
sides, at places that may differ by one rounding (2^-11, 4.9e-4 relative),
and the results are rounded to fp16: the largest error measured here is
4.4e-4 of (1 + |JAX's value|), a fifth of the limit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_pt_tpu.ops.flash_attention import flash_attention as jax_flash
from vision_pt_tpu.ops.short_attention import (
    short_attention_packed as jax_short_attention_packed,
)
from vision_pt_tpu_torch.ops.flash_attention import flash_attention
from vision_pt_tpu_torch.ops.short_attention import (
    _check_strided,
    short_attention_packed,
)

TOL = 2e-3
PACKED_CASES = [
    # (batch, sq, sk, heads, dim, kv_lens)
    (2, 37, 37, 2, 64, [37, 21]),  # S not a multiple of 8, paired heads
    (3, 16, 40, 2, 64, [40, 0, 9]),  # Sq != Sk, a kv_len of 0
    (2, 40, 16, 1, 128, None),  # Sq > Sk, D = 128, no kv_lens
]
FLASH_CASES = [
    # (batch, sq, sk, heads, dim, kv_lens, causal)
    (2, 100, 100, 1, 64, [100, 37], False),  # ragged S
    (2, 100, 100, 2, 64, [100, 61], True),  # causal with kv_lens
    (2, 64, 192, 1, 128, [150, 0], False),  # Sq != Sk, D = 128, a kv_len of 0
    (1, 129, 129, 1, 64, [128], False),  # one key past a 128-key tile
    (2, 257, 257, 2, 64, [257, 129], True),  # causal, kv_len one past a tile
    (2, 200, 320, 1, 128, [255, 0], False),  # Sq != Sk, D = 128, a zero row
]


def _inputs(shapes, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) * scale for s in shapes]


def _close(ours, theirs, rows, name):
    ours = ours.float().numpy()
    theirs = np.asarray(theirs.astype(jnp.float32))
    assert np.isfinite(ours).all(), name
    np.testing.assert_allclose(ours[rows], theirs[rows], atol=TOL, rtol=TOL,
                               err_msg=name)


@pytest.mark.parametrize("bounded", [True, False])
@pytest.mark.parametrize("case", PACKED_CASES,
                         ids=lambda c: "x".join(map(str, c[:5])))
def test_packed_fp16_matches_jax_kernel(case, bounded):
    batch, sq, sk, heads, dim, kv_lens = case
    width = heads * dim
    # unit-variance inputs: logits of a few units, as QKNorm keeps them; the
    # bounded mode's unnormalised weights exp(s) are rounded to fp16 on both
    # sides and would overflow its 65504 past s = 11
    q, k, v, do = _inputs([(batch, sq, width), (batch, sk, width),
                           (batch, sk, width), (batch, sq, width)])
    jlens = None if kv_lens is None else jnp.asarray(kv_lens, jnp.int32)
    tlens = None if kv_lens is None else torch.tensor(kv_lens)

    def jax_fn(q, k, v):
        return jax_short_attention_packed(q, k, v, heads, jlens, interpret=True,
                                          bounded=bounded)

    jout, vjp = jax.vjp(jax_fn, *(jnp.asarray(x, jnp.float16) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(do, jnp.float16))

    leaves = [torch.from_numpy(x).half().requires_grad_() for x in (q, k, v)]
    out = short_attention_packed(*leaves, heads, tlens, bounded=bounded)
    out.backward(torch.from_numpy(do).half())
    assert out.dtype == torch.float16
    rows = np.ones(batch, bool) if kv_lens is None else np.asarray(kv_lens) > 0
    _close(out.detach(), jout, rows, "out")
    for name, leaf, theirs in zip("qkv", leaves, jgrads):
        assert leaf.grad.dtype == torch.float16
        _close(leaf.grad, theirs, rows, f"d{name}")
        # a kv_len 0 row gets exactly zero gradients (the unbounded JAX
        # kernel differentiates uniform weights there: a kept divergence)
        assert bool((leaf.grad[torch.from_numpy(~rows)] == 0).all())


@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "x".join(map(str, c[:5]))
                         + ("_causal" if c[6] else ""))
def test_flash_fp16_matches_jax_kernel(case):
    batch, sq, sk, heads, dim, kv_lens, causal = case
    q, k, v, do = _inputs([(batch, sq, heads, dim), (batch, sk, heads, dim),
                           (batch, sk, heads, dim), (batch, sq, heads, dim)])
    jlens = None if kv_lens is None else jnp.asarray(kv_lens, jnp.int32)
    tlens = None if kv_lens is None else torch.tensor(kv_lens)

    def jax_fn(q, k, v):
        return jax_flash(q, k, v, jlens, causal=causal, block_q=64, block_k=64,
                         interpret=True)

    jout, vjp = jax.vjp(jax_fn, *(jnp.asarray(x, jnp.float16) for x in (q, k, v)))
    jgrads = vjp(jnp.asarray(do, jnp.float16))

    leaves = [torch.from_numpy(x).half().requires_grad_() for x in (q, k, v)]
    out = flash_attention(*leaves, tlens, causal=causal)
    out.backward(torch.from_numpy(do).half())
    assert out.dtype == torch.float16
    rows = np.ones(batch, bool)
    _close(out.detach(), jout, rows, "out")
    for name, leaf, theirs in zip("qkv", leaves, jgrads):
        assert leaf.grad.dtype == torch.float16
        _close(leaf.grad, theirs, rows, f"d{name}")


def test_kernels_take_fp16():
    """The checks before a launch take fp16 as they take bf16 (16-byte
    alignment), and still refuse what no kernel takes, naming what is taken."""
    from vision_pt_tpu_torch.ops.flash_attention import _check

    q = torch.zeros(1, 8, 2, 64, dtype=torch.float16)
    _check_strided(q, q, q)
    _check(q, q, q)
    for bad in (torch.zeros(1, 8, 2, 64, dtype=torch.float64),
                torch.zeros(1, 8, 2, 68, dtype=torch.float16)[..., :64]):
        for check in (_check_strided, _check):
            with pytest.raises(ValueError, match="float16|aligned"):
                check(bad, bad, bad)
