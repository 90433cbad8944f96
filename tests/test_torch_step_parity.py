"""The helpers of ``vision_pt_tpu_torch/tools/bench/step_parity.py`` (the
training-step parity of ``chip_smoke.py`` and its fp16 witnesses), on the
CPU at tiny shapes: the ds recorder leaves the plain backwards' results
bit for bit and reads the same shares as a direct count; the plain-on-card
patch restores what it replaced; the error summary ranks parameters."""

import numpy as np
import pytest
import torch

from vision_pt_tpu_torch.ops import flash_attention as fa
from vision_pt_tpu_torch.ops import short_attention as sa
from vision_pt_tpu_torch.tools.bench import step_parity


def _tensors(shape, n, seed, dtype=torch.float16, scale=1.0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=shape).astype(np.float32) * scale).to(dtype)
            for _ in range(n)]


def _shares(ds):
    mag = ds.abs()[ds != 0]
    return ((mag < step_parity.F16_SUBNORMAL).float().mean().item(),
            (mag < step_parity.F16_FLUSH).float().mean().item())


@pytest.mark.parametrize("cotangent_scale", [1e-6, 1.0])
def test_ds_recorder_flash(cotangent_scale):
    q, k, v = _tensors((2, 19, 2, 64), 3, seed=1)
    (do,) = _tensors((2, 19, 2, 64), 1, seed=2, scale=cotangent_scale)
    lens = torch.tensor([19, 7])
    out, lse = fa.flash_attention_with_lse(q, k, v, lens)
    plain = fa.flash_attention_bwd(q, k, v, out, lse, do, lens)
    shares = []
    with step_parity._record_ds(shares):
        recorded = fa.flash_attention_bwd(q, k, v, out, lse, do, lens)
    assert fa.flash_attention_bwd_reference.__name__ == "flash_attention_bwd_reference"
    for a, b in zip(plain, recorded):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    f32 = torch.float32
    s = fa._logits(q, k, 64**-0.5)
    p = torch.where(fa._valid(lens, 2, 19, 19, False, "cpu"),
                    torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.to(f32), v.to(f32))
    delta = torch.einsum("bqhd,bqhd->bhq", do.to(f32), out.to(f32))
    assert shares == [pytest.approx(_shares(p * (dp - delta[..., None]) * 64**-0.5))]
    if cotangent_scale < 1:
        assert shares[0][0] == 1.0  # every ds below fp16's normal range


def test_ds_recorder_packed():
    q, k, v, do = _tensors((2, 11, 2 * 64), 4, seed=3)
    lens = torch.tensor([11, 0])
    _, lse = sa.short_attention_packed_with_lse(q, k, v, 2, lens, bounded=True)
    plain = sa.short_attention_packed_bwd(q, k, v, lse, do, 2, lens, bounded=True)
    shares = []
    with step_parity._record_ds(shares):
        recorded = sa.short_attention_packed_bwd(q, k, v, lse, do, 2, lens, bounded=True)
    for a, b in zip(plain, recorded):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert len(shares) == 1 and all(0.0 <= x <= 1.0 for x in shares[0])


def test_plain_on_card_restores_the_dispatch():
    saved = sa._wants_kernel, fa._forward, fa.flash_attention_bwd
    with step_parity._plain_on_card():
        assert not sa._wants_kernel(torch.zeros(1))
        assert fa.flash_attention_bwd is fa.flash_attention_bwd_reference
    assert (sa._wants_kernel, fa._forward, fa.flash_attention_bwd) == saved


def test_grad_errors_and_summary():
    ref = {"a": torch.ones(4), "b": torch.full((2,), 2.0), "c": torch.zeros(3)}
    ours = {"a": torch.ones(4), "b": torch.full((2,), 2.2), "c": torch.zeros(3)}
    errors = step_parity.grad_errors(ours, ref)
    assert errors["a"] == 0.0 and errors["c"] == 0.0
    assert errors["b"] == pytest.approx(0.1)
    s = step_parity.summary(errors, worst=2)
    assert s["max"] == pytest.approx(0.1) and s["worst"][0][0] == "b"
    assert s["median"] == 0.0 and len(s["worst"]) == 2
