"""Why the 16-bit backward of the packed short attention (kernel #2, with
#4/#6) keeps delta = sum_j p * dp in fp32, the JAX kernel's numerics, though
it costs the dq kernel a second sweep over the keys (9 (S, S, D) products
where the function needs 5): the cheaper delta = rowsum(dO * O), which
drops that sweep (7 products), misses the JAX kernel's gradient by more
than the bf16 limit of ``tests/test_torch_short_attention_bwd.py`` (2e-2,
absolute and relative).

Each case runs three plain backwards on the same bf16 inputs, held against
``jax.vjp`` of ``short_attention_packed`` in interpret mode: the port's
(``short_attention_packed_bwd_reference``), and the same with delta taken
from O rounded to bf16 (the forward's output) or from O in fp32 (the
forward's accumulator before that rounding). Largest error in units of the
limit, over dq, dk, dv (CPU, numpy-made inputs of the backward's test):

    case (B, Sq, Sk, H, D)   bounded: kept / bf16 O / fp32 O   unbounded
    2 x 37 x 37 x 2 x 64     0.154 / 3.05 / 2.69             0.154 / 2.32 / 0.634
    2 x 24 x 24 x 3 x 32     0.000 / 3.96 / 2.53             0.000 / 1.49 / 0.599
    3 x 16 x 40 x 2 x 64     0.003 / 1.56 / 1.38             0.003 / 1.61 / 0.644
    2 x 40 x 16 x 1 x 128    0.000 / 3.20 / 1.60             0.000 / 2.10 / 0.996

Bounded mode (JiT's path) rounds the unnormalised weights before the PV
product, so O is not sum_j p v for the p the backward rebuilds, and the
difference, cancelling in dp - delta, exceeds the limit even from fp32 O.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_pt_tpu.ops.short_attention import (
    short_attention_packed as jax_short_attention_packed,
)
from vision_pt_tpu_torch.ops.short_attention import (
    BOUNDED_LOGIT_CLIP,
    LOG2E,
    _key_valid,
    _merge_heads,
    _split_heads,
    short_attention_packed_bwd_reference,
    short_attention_packed_with_lse,
)

TOL = 2e-2
CASES = [  # those of test_torch_short_attention_bwd.py
    (2, 37, 37, 2, 64, [37, 21]),
    (2, 24, 24, 3, 32, [0, 17]),
    (3, 16, 40, 2, 64, [40, 0, 9]),
    (2, 40, 16, 1, 128, None),
]


def _inputs(batch, sq, sk, heads, dim, seed=0):
    rng = np.random.default_rng(seed)
    return [
        rng.normal(size=(batch, s, heads * dim)).astype(np.float32) * scale
        for s, scale in ((sq, 2.0), (sk, 2.0), (sk, 2.0), (sq, 1.0))
    ]


def _rowsum_delta_backward(q, k, v, lse, do, out, heads, kv_lens, bounded,
                           o_fp32):
    """The port's plain backward with delta = rowsum(dO * O): O the bf16
    output ``out``, or (``o_fp32``) the forward's fp32 accumulator."""
    dt, acc = q.dtype, torch.float32
    qh, kh, vh, doh = (_split_heads(x, heads).to(acc) for x in (q, k, v, do))
    scale = qh.shape[-1] ** -0.5
    x = (qh @ kh.transpose(-1, -2)) * (scale * LOG2E)
    lim = BOUNDED_LOGIT_CLIP * LOG2E
    valid = _key_valid(kv_lens, q.shape[0], k.shape[1], q.device)
    if bounded:
        x = x.clamp(-lim, lim)
    p = torch.where(valid, torch.exp2(x - lse[..., None] * LOG2E), 0.0)
    if o_fp32:  # the forward's weights, rounded before PV, over their sum
        x_valid = torch.where(valid, x, -1e30)
        e = torch.exp2(x_valid if bounded
                       else x_valid - x_valid.amax(dim=-1, keepdim=True))
        e = torch.where(valid, e, 0.0)
        o = (e.to(dt).to(acc) @ vh) / e.sum(dim=-1, keepdim=True).clamp_min(2.0**-100)
    else:
        o = _split_heads(out, heads).to(acc)
    dv = p.to(dt).to(acc).transpose(-1, -2) @ doh
    dp = doh @ vh.transpose(-1, -2)
    ds = (p * (dp - (doh * o).sum(dim=-1, keepdim=True))).to(dt).to(acc)
    return tuple(_merge_heads(g).to(dt)
                 for g in ((ds @ kh) * scale, (ds.transpose(-1, -2) @ qh) * scale, dv))


def _limit_shares(case, bounded):
    """Largest error in units of the limit, over dq, dk, dv and the rows
    with keys: the port's backward, rowsum delta from bf16 O, from fp32 O."""
    batch, sq, sk, heads, dim, kv_lens = case
    q, k, v, do = _inputs(batch, sq, sk, heads, dim)
    jlens = None if kv_lens is None else jnp.asarray(kv_lens, jnp.int32)
    tlens = None if kv_lens is None else torch.tensor(kv_lens)
    _, vjp = jax.vjp(
        lambda q, k, v: jax_short_attention_packed(q, k, v, heads, jlens,
                                                   interpret=True, bounded=bounded),
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)))
    theirs = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(do, jnp.bfloat16))]
    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do))
    out, lse = short_attention_packed_with_lse(tq, tk, tv, heads, tlens, bounded=bounded)
    rows = np.ones(batch, bool) if kv_lens is None else np.asarray(kv_lens) > 0

    def share(grads):
        return max(float(np.max(np.abs(g.float().numpy()[rows] - r[rows])
                                / (TOL + TOL * np.abs(r[rows]))))
                   for g, r in zip(grads, theirs))

    return (share(short_attention_packed_bwd_reference(tq, tk, tv, lse, tdo, heads,
                                                       tlens, bounded=bounded)),
            *(share(_rowsum_delta_backward(tq, tk, tv, lse, tdo, out, heads, tlens,
                                           bounded, o_fp32))
              for o_fp32 in (False, True)))


@pytest.mark.parametrize("bounded", [True, False])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c[:5])))
def test_rowsum_delta_misses_the_limit_the_kept_delta_holds(case, bounded):
    kept, rowsum_bf16, rowsum_fp32 = _limit_shares(case, bounded)
    assert kept <= 1.0
    assert rowsum_bf16 > 1.0
    if bounded:
        assert rowsum_fp32 > 1.0
