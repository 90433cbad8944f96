"""The port's int8 quantized-training matmul (``ops/quant/int8_training.py``)
against ``vision_pt_tpu/ops/quant/int8_training.py``, on the CPU, with
numpy-made inputs:

- the int8 codes and scales equal, and the int32 product bit-equal to the
  JAX package's ``lax.dot_general``;
- the outputs of ``int8_matmul`` and ``Int8TrainLinear`` equal in fp32 (the
  same int32 product rescaled by the same fp32 ops) and within one bf16
  rounding (2^-8 relative) in bf16;
- the straight-through gradients within 1e-5 relative (fp32 products in
  another order);
- ``quantize_training_inplace`` swaps the same linears, keeps their
  parameters, and a swapped tower trains.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from vision_pt_tpu.ops.quant import int8_training as jint8
from vision_pt_tpu_torch.models.sdxl.convert import from_jax_state
from vision_pt_tpu.utils.state_dict import flatten_state
from vision_pt_tpu_torch.ops.linear import Linear
from vision_pt_tpu_torch.ops.quant.int8_training import (
    Int8TrainLinear,
    _rowwise_quant,
    int8_matmul,
    int8_product,
    quantize_training_inplace,
)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _arrays(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) * (1 + i) for i, s in enumerate(shapes)]


def _to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().numpy()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,k,n", [(32, 64, 48), (5, 24, 12), (1, 7, 3)])
def test_codes_scales_and_int32_product_bit_equal(dtype, m, k, n):
    jdt, tdt = DTYPES[dtype]
    x, w = _arrays(0, (m, k), (k, n))
    jx, jw = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    jxq, jsx = jint8._rowwise_quant(jx)
    jwq, jsw = jint8._rowwise_quant(jw.T)
    theirs = jax.lax.dot_general(jxq, jwq.T, (((1,), (0,)), ((), ())),
                                 preferred_element_type=jnp.int32)
    tx = torch.from_numpy(x).to(tdt)
    tw = torch.from_numpy(np.ascontiguousarray(w.T)).to(tdt)  # (out, in)
    xq, sx = _rowwise_quant(tx)
    wq, sw = _rowwise_quant(tw)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    np.testing.assert_array_equal(wq.numpy(), np.asarray(jwq))
    np.testing.assert_array_equal(_to_np(sx), np.asarray(jsx, np.float32))
    np.testing.assert_array_equal(_to_np(sw), np.asarray(jsw, np.float32))
    ours = int8_product(xq, wq)
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


@pytest.mark.parametrize("dtype", DTYPES)
def test_int8_matmul_and_ste_gradients_match_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    x, w, g = _arrays(1, (32, 64), (64, 48), (32, 48))
    jx, jw, jg = (jnp.asarray(a, jdt) for a in (x, w, g))
    theirs = jint8.int8_matmul(jx, jw)
    jgx, jgw = jax.grad(lambda a, b: jnp.sum((jint8.int8_matmul(a, b) * jg)
                                             .astype(jnp.float32)), (0, 1))(jx, jw)
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    tw = torch.from_numpy(np.ascontiguousarray(w.T)).to(tdt).requires_grad_()
    ours = int8_matmul(tx, tw)
    assert ours.dtype == tdt
    (ours * torch.from_numpy(g).to(tdt)).float().sum().backward()
    want = np.asarray(theirs, np.float32)
    if dtype == "float32":
        np.testing.assert_array_equal(_to_np(ours), want)
        rtol = 1e-5
    else:  # one bf16 rounding apart at most
        np.testing.assert_allclose(_to_np(ours), want, rtol=2**-8, atol=0)
        rtol = 2**-7
    # int8 dynamic quantization: about 1% off the unquantized product
    exact = x @ w
    assert np.abs(want - exact).max() / np.abs(exact).max() < 0.02
    np.testing.assert_allclose(_to_np(tx.grad), np.asarray(jgx, np.float32), rtol=rtol,
                               atol=rtol * np.abs(np.asarray(jgx, np.float32)).max())
    np.testing.assert_allclose(_to_np(tw.grad).T, np.asarray(jgw, np.float32), rtol=rtol,
                               atol=rtol * np.abs(np.asarray(jgw, np.float32)).max())


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_int8_train_linear_matches_jax(dtype):
    """``Int8TrainLinear`` against the JAX one from the same weights, a 3-D
    input, with a bias; with ``dtype`` bf16 both cast input and weight."""
    jdt = None if dtype is None else jnp.bfloat16
    tdt = None if dtype is None else torch.bfloat16
    jlin = nnx.Linear(40, 24, dtype=jdt, rngs=nnx.Rngs(0))
    jlin.bias.value = jnp.asarray(np.random.default_rng(3).normal(size=24)
                                  .astype(np.float32))
    lin = Linear(40, 24, dtype=tdt)
    lin.load_state_dict(from_jax_state(flatten_state(jlin)))
    jlin.__class__ = jint8.Int8TrainLinear
    lin.__class__ = Int8TrainLinear
    x, g = _arrays(4, (2, 9, 40), (2, 9, 24))

    def jloss(module, x):
        return jnp.sum(module(x).astype(jnp.float32) * g)

    jx = jnp.asarray(x)
    theirs = np.asarray(jlin(jx), np.float32)
    jgrads = nnx.grad(jloss)(jlin, jx)
    tx = torch.from_numpy(x)
    ours = lin(tx)
    (ours.float() * torch.from_numpy(g)).sum().backward()
    if dtype is None:
        np.testing.assert_array_equal(_to_np(ours), theirs)
        rtol = 1e-5
    else:
        np.testing.assert_allclose(_to_np(ours), theirs, rtol=2**-8,
                                   atol=2**-8 * np.abs(theirs).max())
        rtol = 2**-7
    theirs_grads = from_jax_state({k: np.asarray(v, np.float32) for k, v in
                                   flatten_state(jgrads).items()})
    for name, p in lin.named_parameters():
        want = theirs_grads[name].numpy()
        np.testing.assert_allclose(_to_np(p.grad), want, rtol=rtol,
                                   atol=rtol * np.abs(want).max())


class _JTower(nnx.Module):
    def __init__(self, rngs):
        self.proj = nnx.Linear(8, 16, rngs=rngs)
        self.blocks = nnx.List([nnx.Linear(16, 16, rngs=rngs) for _ in range(2)])
        self.out = nnx.Linear(16, 8, rngs=rngs)

    def __call__(self, x):
        h = jax.nn.gelu(self.proj(x))
        for block in self.blocks:
            h = block(h)
        return self.out(h)


class _Tower(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.proj = Linear(8, 16)
        self.blocks = torch.nn.ModuleList([Linear(16, 16) for _ in range(2)])
        self.out = Linear(16, 8)

    def forward(self, x):
        h = torch.nn.functional.gelu(self.proj(x), approximate="tanh")
        for block in self.blocks:
            h = block(h)
        return self.out(h)


@pytest.mark.parametrize("include,exclude", [(None, None), (["proj"], None),
                                             (["blocks"], ["blocks.1"])])
def test_quantize_training_inplace_swaps_like_jax(include, exclude):
    jtower, tower = _JTower(nnx.Rngs(0)), _Tower()
    tower.load_state_dict(from_jax_state(flatten_state(jtower)))
    before = {k: v.clone() for k, v in tower.state_dict().items()}
    n = quantize_training_inplace(tower, include, exclude)
    assert n == jint8.quantize_training_inplace(jtower, include, exclude) > 0
    swapped = {p for p, m in tower.named_modules() if isinstance(m, Int8TrainLinear)}
    theirs = {".".join(str(x) for x in path) for path, m in jtower.iter_modules()
              if isinstance(m, jint8.Int8TrainLinear)}
    assert swapped == theirs
    for key, value in tower.state_dict().items():
        torch.testing.assert_close(value, before[key], rtol=0, atol=0)
    x = np.random.default_rng(5).normal(size=(4, 8)).astype(np.float32)
    with torch.no_grad():
        ours = tower(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jtower(jnp.asarray(x))), rtol=1e-5,
                               atol=1e-5)


def test_a_swapped_tower_trains():
    torch.manual_seed(0)
    tower = _Tower()
    quantize_training_inplace(tower)
    x = torch.randn(64, 8)
    target = torch.sin(x)
    opt = torch.optim.Adam(tower.parameters(), lr=1e-2)
    losses = []
    for _ in range(200):
        loss = torch.mean((tower(x) - target) ** 2)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    assert losses[-1] < 0.3 * losses[0]
