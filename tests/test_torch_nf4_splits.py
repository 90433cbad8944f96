"""Kernel #9's split-K order: the plain version of ``dequant_matmul_4bit``
(which the wrapper runs for CPU tensors and ``chip_smoke.py`` holds the CUDA
kernel against) takes its chunk sums in the kernel's order: the plan's
(``nf4_matmul.plan``) contiguous K ranges, each summed from 0, then added in
turn. Held here against the JAX Pallas kernel in interpret mode at M 1, 154
and 257 (both sides of the 256-row block shape) with a K of 16 k-steps that
the plan cuts into several ranges, for NF4 and FP4, in bf16, fp16 and fp32;
and against a float64 product of the dequantized weight.

Tolerances, as ``tests/test_torch_nf4.py`` holds the one-range order: fp32
1e-5 of the output's largest value (the same fp32 products, the chunk sums
in another order); bf16 5e-2 (both round the result to bf16 once); fp16
2e-3 of each element plus 1e-5 of the largest value (the same codebook
rounded to fp16, one rounding of sums in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_pt_tpu.ops.quant import nf4 as jnf4
from vision_pt_tpu.ops.quant import pallas_nf4 as jpallas
from vision_pt_tpu_torch.ops.quant import layers, nf4
from vision_pt_tpu_torch.ops.quant.nf4_matmul import (
    BLOCK,
    dequant_matmul_4bit,
    dequant_matmul_4bit_reference,
    plan,
)

IN_DIM, OUT_DIM = 2048, 136  # 16 k-steps of 128 input rows


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("quant_type", ["nf4", "fp4"])
@pytest.mark.parametrize("m", [1, 154, 257])
def test_split_order_matches_jax_kernel(m, quant_type, dtype):
    assert plan(m, IN_DIM, OUT_DIM, getattr(torch, dtype))[1] > 1
    rng = np.random.default_rng(m)
    w = (rng.normal(size=(OUT_DIM, IN_DIM)) * 0.1).astype(np.float32)
    x = rng.normal(size=(m, IN_DIM)).astype(np.float32)
    packed_t, absmax_t = jnf4.quantize_4bit_device_kernel_layout(jnp.asarray(w),
                                                                 quant_type)
    want = np.asarray(jpallas.dequant_matmul_4bit(
        jnp.asarray(x, getattr(jnp, dtype)), packed_t, absmax_t,
        quant_type=quant_type, interpret=True), np.float32)
    got = dequant_matmul_4bit(torch.from_numpy(x).to(getattr(torch, dtype)),
                              torch.from_numpy(np.array(packed_t)),
                              torch.from_numpy(np.array(absmax_t)), quant_type)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (m, OUT_DIM)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    elif dtype == "float16":
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-5 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, atol=5e-2, rtol=5e-2)


def test_plan_fills_the_card_once_and_splits_whole_k_steps():
    """Block shapes by M (16-bit x: 64, 128, 256 rows; fp32 x: 64), as many
    ranges as one wave of blocks holds (two blocks a streaming multiprocessor
    for the 64-row shape, one for the others), each of at least two
    k-steps."""
    bf16 = torch.bfloat16
    assert plan(64, 8192, 8192, bf16) == (0, 2)  # 128 column tiles of 64
    assert plan(154, 2048, 1280, bf16) == (2, 3)  # 40 tiles of 32 columns
    assert plan(154, 2048, 640, bf16) == (2, 6)  # 20 tiles
    assert plan(100, 2048, 1280, bf16)[0] == 1
    assert plan(1024, 2048, 1280, bf16) == (2, 1)  # 160 tiles fill the card
    assert plan(154, 2048, 1280, torch.float32)[0] == 0
    assert plan(1, 2048, 136, bf16) == (0, 8)  # capped at 16 k-steps / 2
    assert plan(1, 128, 8, bf16) == (0, 1)  # one k-step: one range


def test_split_sums_are_the_product_of_the_dequantized_weight():
    rng = np.random.default_rng(7)
    w = torch.from_numpy((rng.normal(size=(OUT_DIM, IN_DIM)) * 0.1).astype(np.float32))
    packed_t, absmax_t = nf4.quantize_4bit_device_kernel_layout(w)
    x = torch.from_numpy(rng.normal(size=(257, IN_DIM)).astype(np.float32))
    y = dequant_matmul_4bit_reference(x, packed_t, absmax_t)
    dense = layers._dequant_deint(packed_t, absmax_t, "nf4", torch.float64)
    want = x.double() @ dense.T
    torch.testing.assert_close(y.double(), want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    assert IN_DIM % (2 * BLOCK) == 0
