"""The port's 4-bit quantization against the JAX package's, on the same
numpy-made weights and inputs: host and device quantization (codes and
absmax bit for bit), the kernel layout's repacking, the plain version of
kernel #9 (``dequant_matmul_4bit``) against the JAX Pallas kernel in
interpret mode, the quantized linear layers, and the quantization flows.

Tolerances: the plain dequant-matmul against the JAX kernel, fp32 1e-5
relative to the output's largest value (the same fp32 products, the chunk
sums taken in another order); bf16 5e-2, the JAX test's (both round the
result to bf16 once, from sums in another order); fp16 2e-3 relative to
each element (two fp16 steps: the same codebook rounded to fp16, exact fp32
products, one rounding to fp16 of sums in another order) plus 1e-5 of the
largest value; an fp32 codebook for fp16 x misses it by 3-14 times. The layers against the
JAX layers: fp32 1e-5 (the same dense dequantization, a matmul in another
order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from vision_pt_tpu.ops.quant import functional as jfunctional
from vision_pt_tpu.ops.quant import layers as jlayers
from vision_pt_tpu.ops.quant import nf4 as jnf4
from vision_pt_tpu.ops.quant import pallas_nf4 as jpallas
from vision_pt_tpu_torch.ops.linear import Linear
from vision_pt_tpu_torch.ops.quant import functional, layers, nf4, nf4_matmul
from vision_pt_tpu_torch.ops.quant.nf4_matmul import (
    dequant_matmul_4bit,
    dequant_matmul_4bit_reference,
)
from tests.test_torch_sdxl_distributed import one_torch_thread  # noqa: F401,E402

QUANT_TYPES = ["nf4", "fp4"]


def _weights(shape, seed=0, scale=0.1):
    """Normal weights with a zero block, a block of one repeated value and
    values on the codebook midpoints (the ties of the nearest-code pick)."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=shape) * scale).astype(np.float32)
    flat = w.reshape(-1)
    flat[:64] = 0.0
    flat[64:128] = 0.25
    code = np.sort(nf4.NF4_CODE)
    mids = (code[1:] + code[:-1]) * 0.5
    flat[128:128 + 15] = mids * np.abs(flat[128:192]).max()
    return w


@pytest.mark.parametrize("quant_type", QUANT_TYPES)
def test_host_and_device_quantization_match_jax(quant_type):
    w = _weights((96, 256))
    packed, state = nf4.quantize_4bit(w, quant_type=quant_type)
    jpacked, jstate = jnf4.quantize_4bit(w, quant_type=quant_type)
    np.testing.assert_array_equal(packed, jpacked)
    np.testing.assert_array_equal(state.absmax, jstate.absmax)
    dpacked, dstate = nf4.quantize_4bit_device(torch.from_numpy(w), quant_type=quant_type)
    jdpacked, jdstate = jnf4.quantize_4bit_device(jnp.asarray(w), quant_type=quant_type)
    np.testing.assert_array_equal(dpacked, jdpacked)
    np.testing.assert_array_equal(dstate.absmax, jdstate.absmax)
    np.testing.assert_array_equal(dpacked, packed)
    deq = nf4.dequantize_4bit(packed, state)
    np.testing.assert_array_equal(deq.numpy(), np.asarray(jnf4.dequantize_4bit(jpacked, jstate)))


@pytest.mark.parametrize("quant_type", QUANT_TYPES)
def test_kernel_layout_quantization_matches_jax(quant_type, monkeypatch):
    w = _weights((80, 384), seed=1)
    # three row chunks of 32, 32 and 16 rows
    monkeypatch.setattr(nf4, "_DEVICE_CHUNK_ELEMENTS", 32 * 384)
    packed_t, absmax_t = nf4.quantize_4bit_device_kernel_layout(torch.from_numpy(w),
                                                                quant_type)
    jpacked_t, jabsmax_t = jnf4.quantize_4bit_device_kernel_layout(jnp.asarray(w),
                                                                   quant_type)
    assert packed_t.dtype == torch.uint8 and tuple(packed_t.shape) == (192, 80)
    np.testing.assert_array_equal(packed_t.numpy(), np.asarray(jpacked_t))
    np.testing.assert_array_equal(absmax_t.numpy(), np.asarray(jabsmax_t))


def test_repack_round_trips():
    w = _weights((64, 256), seed=2)
    packed, _ = nf4.quantize_4bit(w)
    deint = nf4_matmul.repack_deinterleaved(packed, (64, 256))
    np.testing.assert_array_equal(deint, jpallas.repack_deinterleaved(packed, (64, 256)))
    np.testing.assert_array_equal(nf4_matmul.repack_bnb(deint), packed)
    np.testing.assert_array_equal(nf4_matmul.repack_bnb(deint), jpallas.repack_bnb(deint))
    packed_t, _ = nf4.quantize_4bit_device_kernel_layout(torch.from_numpy(w))
    np.testing.assert_array_equal(packed_t.numpy(), deint)
    assert nf4_matmul.kernel_supported(256, 136) and not nf4_matmul.kernel_supported(192, 64)
    assert not nf4_matmul.kernel_supported(256, 36)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("quant_type", QUANT_TYPES)
@pytest.mark.parametrize("in_dim", [256, 384])
def test_plain_dequant_matmul_matches_jax_kernel(in_dim, quant_type, dtype):
    m, out_dim = 37, 136
    rng = np.random.default_rng(in_dim)
    w = (rng.normal(size=(out_dim, in_dim)) * 0.1).astype(np.float32)
    x = rng.normal(size=(m, in_dim)).astype(np.float32)
    packed_t, absmax_t = jnf4.quantize_4bit_device_kernel_layout(jnp.asarray(w), quant_type)
    jdt = getattr(jnp, dtype)
    want = np.asarray(jpallas.dequant_matmul_4bit(
        jnp.asarray(x, jdt), packed_t, absmax_t, quant_type=quant_type,
        interpret=True), np.float32)
    got = dequant_matmul_4bit(torch.from_numpy(x).to(getattr(torch, dtype)),
                              torch.from_numpy(np.array(packed_t)),
                              torch.from_numpy(np.array(absmax_t)), quant_type)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (m, out_dim)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    elif dtype == "float16":
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-5 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, atol=5e-2, rtol=5e-2)


def test_plain_dequant_matmul_keeps_leading_dims_and_kernel_order():
    rng = np.random.default_rng(5)
    w = torch.from_numpy((rng.normal(size=(64, 512)) * 0.1).astype(np.float32))
    packed_t, absmax_t = nf4.quantize_4bit_device_kernel_layout(w)
    x = torch.from_numpy(rng.normal(size=(2, 3, 512)).astype(np.float32))
    y = dequant_matmul_4bit_reference(x, packed_t, absmax_t)
    dense = layers._dequant_deint(packed_t, absmax_t, "nf4", torch.float64)
    want = x.double() @ dense.T
    assert tuple(y.shape) == (2, 3, 64)
    torch.testing.assert_close(y.double(), want, rtol=0, atol=1e-5 * float(want.abs().max()))


def test_dequant_matmul_raises_off_the_cpu_without_a_kernel():
    x = torch.empty(4, 256, device="meta")
    packed_t = torch.empty(128, 64, dtype=torch.uint8, device="meta")
    absmax_t = torch.empty(4, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        dequant_matmul_4bit(x, packed_t, absmax_t)


def _linear_pair(din, dout, seed=0, bias=True):
    """A JAX nnx.Linear and the port's Linear with the same weights."""
    jlin = nnx.Linear(din, dout, use_bias=bias, rngs=nnx.Rngs(seed))
    if bias:
        jlin.bias.value = jnp.asarray(
            np.random.default_rng(seed).normal(size=dout).astype(np.float32))
    lin = Linear(din, dout, use_bias=bias)
    lin.weight.data = torch.from_numpy(np.asarray(jlin.kernel.value).T.copy())
    if bias:
        lin.bias.data = torch.from_numpy(np.asarray(jlin.bias.value).copy())
    return jlin, lin


@pytest.mark.parametrize("shape", [(256, 64), (96, 40)], ids=["kernel", "flat"])
def test_quant_linear_4bit_matches_jax(shape, monkeypatch):
    din, dout = shape
    jlin, lin = _linear_pair(din, dout)
    jq = jlayers.QuantLinear4bit.from_linear(jlin)
    q = layers.QuantLinear4bit.from_linear(lin)
    assert q.layout == jq.layout == ("kernel" if din == 256 else "flat")
    np.testing.assert_array_equal(q.packed.numpy(), np.asarray(jq.packed.value))
    np.testing.assert_array_equal(q.absmax.numpy(), np.asarray(jq.absmax.value))
    x = np.random.default_rng(1).normal(size=(3, 5, din)).astype(np.float32)
    want = np.asarray(jq(jnp.asarray(x)))
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(q(torch.from_numpy(x)).detach().numpy(), want, atol=tol)
    # the kernel's path (its plain version on the CPU) gives the same product
    monkeypatch.setattr(layers, "_on_cuda", lambda x: True)
    np.testing.assert_allclose(q(torch.from_numpy(x)).detach().numpy(), want, atol=tol)
    # the backward is g @ dequant(W), to the input only
    xt = torch.from_numpy(x).requires_grad_()
    (q(xt) ** 2).sum().backward()
    jgrad = jax.grad(lambda v: jnp.sum(jq(v) ** 2))(jnp.asarray(x))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad),
                               atol=1e-5 * np.abs(np.asarray(jgrad)).max())
    np.testing.assert_allclose(q.dequantized_kernel().numpy(),
                               np.asarray(jq.dequantized_kernel()), atol=0)
    # bnb export, and a layer loaded from it
    exported = q.export_bnb("layer.")
    jexported = jq.export_bnb("layer.")
    assert exported.keys() == jexported.keys()
    for key in exported:
        np.testing.assert_array_equal(np.asarray(exported[key]), np.asarray(jexported[key]))
    again = layers.QuantLinear4bit(din, dout)
    again.load_prequantized(exported["layer.weight"],
                            {k[len("layer.weight."):]: v for k, v in exported.items()
                             if k.startswith("layer.weight.")},
                            bias=exported["layer.bias"])
    torch.testing.assert_close(again.packed, q.packed, rtol=0, atol=0)
    torch.testing.assert_close(again.absmax, q.absmax, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["Int8", "FP8"])
def test_int8_and_fp8_linears_match_jax(kind):
    jlin, lin = _linear_pair(64, 32, seed=3)
    jq = getattr(jlayers, f"QuantLinear{kind}").from_linear(jlin)
    q = getattr(layers, f"QuantLinear{kind}").from_linear(lin)
    jweight = np.asarray(jq.qweight.value).astype(np.float32)
    weight = q.qweight.float().numpy()
    np.testing.assert_array_equal(weight, jweight if kind == "Int8" else jweight.T)
    np.testing.assert_array_equal(q.scale.numpy(), np.asarray(jq.scale.value))
    x = np.random.default_rng(4).normal(size=(4, 64)).astype(np.float32)
    want = np.asarray(jq(jnp.asarray(x)))
    np.testing.assert_allclose(q(torch.from_numpy(x)).detach().numpy(), want,
                               atol=1e-5 * np.abs(want).max())


def _tiny_unets():
    """The JAX tests' tiny SDXL UNet in both packages, same weights."""
    from vision_pt_tpu.models.sdxl import DenoiserConfig as JConfig
    from vision_pt_tpu.models.sdxl import Denoiser as JDenoiser
    from vision_pt_tpu.utils.state_dict import flatten_state
    from vision_pt_tpu_torch.models.sdxl import Denoiser, DenoiserConfig
    from vision_pt_tpu_torch.models.sdxl.convert import from_jax_state

    tiny = dict(hidden_dim=32, block_out_channels=[32, 32, 64],
                num_transformers_per_block=[1, 1, 2], num_head_channels=16,
                context_dim=32, layers_per_block=1)
    junet = JDenoiser(JConfig(**tiny), rngs=nnx.Rngs(0))
    unet = Denoiser(DenoiserConfig(**tiny)).eval()
    unet.load_state_dict(from_jax_state(
        {k: np.asarray(v) for k, v in flatten_state(junet).items()}))
    return junet, unet


def test_quantize_inplace_replaces_the_same_layers_as_jax():
    from vision_pt_tpu_torch.models.sdxl.convert import port_to_torch_key
    from vision_pt_tpu_torch.ops.attention import attention_dtype
    from vision_pt_tpu_torch.tools.inference_cli import EXCLUDE_KEYS, INCLUDE_KEYS

    junet, unet = _tiny_unets()
    jreplaced = jfunctional.quantize_inplace(junet, "bnb_nf4", INCLUDE_KEYS, EXCLUDE_KEYS)
    replaced = functional.quantize_inplace(unet, "bnb_nf4", INCLUDE_KEYS, EXCLUDE_KEYS)
    # the same layers, in the reference's torch key names
    assert sorted(map(port_to_torch_key, replaced)) == sorted(
        map(port_to_torch_key, jreplaced))
    # 7 spatial transformers (3 at 32 wide, 4 of 2 blocks at 64) hold 11
    # blocks: 8 attention and 2 feed-forward linears a block, 2 projections
    # a transformer
    assert len(replaced) == 11 * 10 + 7 * 2
    assert any(".ff.geglu.proj" in p for p in replaced)
    assert not any("time_embed" in p or "out_conv" in p for p in replaced)
    modules = dict(unet.named_modules())
    assert all(isinstance(modules[p], layers.QuantLinear4bit) for p in replaced)
    # the quantized UNets agree (the same codes, dense products on the CPU)
    rng = np.random.default_rng(0)
    args = [rng.normal(size=s).astype(np.float32)
            for s in ((2, 16, 16, 4), (2,), (2, 7, 32), (2, 1280), (2, 2), (2, 2), (2, 2))]
    args[1] = np.asarray([500.0, 10.0], np.float32)
    args[4] = args[5] = np.full((2, 2), 128.0, np.float32)
    args[6] = np.zeros((2, 2), np.float32)
    from vision_pt_tpu.ops.attention import attention_dtype as jattention_dtype

    with jattention_dtype(None):
        want = np.asarray(junet(*map(jnp.asarray, args)))
    with attention_dtype(None), torch.no_grad():
        got = unet(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4 * np.abs(want).max())


def test_quantize_state_dict_and_prequantized_load_round_trip():
    jlin_q, lin_q = _linear_pair(128, 64, seed=6)
    jlin_k, lin_k = _linear_pair(128, 64, seed=7)
    net = torch.nn.Module()
    net.to_q, net.to_k = lin_q, lin_k
    sd = {f"{n}.{p}": v.detach().numpy() for n, m in (("to_q", lin_q), ("to_k", lin_k))
          for p, v in m.named_parameters()}
    qsd = functional.quantize_state_dict(sd, "bnb_nf4", include_keys=["to_q"])
    jqsd = jfunctional.quantize_state_dict(sd, "bnb_nf4", include_keys=["to_q"])
    assert qsd.keys() == jqsd.keys()
    for key in qsd:
        np.testing.assert_array_equal(np.asarray(qsd[key]), np.asarray(jqsd[key]))
    children = {k[len("to_q.weight."):]: v for k, v in qsd.items()
                if k.startswith("to_q.weight.")}
    assert functional.detect_quant_type(children) == "bnb_nf4"
    assert functional.detect_quant_type({"weight_format": np.zeros(1)}) == "bnb_int8"
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(2, 128)).astype(np.float32))
    with torch.no_grad():
        y_full = net.to_q(x) + net.to_k(x)
    replaced = functional.replace_by_prequantized_weights(net, qsd)
    assert replaced == ["to_q"]
    assert isinstance(net.to_q, layers.QuantLinear4bit) and net.to_k is lin_k
    direct = layers.QuantLinear4bit.from_linear(lin_q)
    torch.testing.assert_close(net.to_q.packed, direct.packed, rtol=0, atol=0)
    y_q = (net.to_q(x) + net.to_k(x)).detach()
    assert float((y_q - y_full).abs().mean() / y_full.abs().mean()) < 0.2
