"""The port's JiT denoiser against the JAX package's, on one tiny config whose
JAX parameters cross over through ``convert.from_jax_state``.

fp32 runs under ``attention_dtype(None)`` on both sides and must reach
60 dB PSNR (measured 161 dB). bf16 compute with fp32 params must reach 50 dB
(measured 70 dB): every linear and elementwise op rounds to bf16, and the
two frameworks round at slightly different places."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import vision_pt_tpu.models.jit.denoiser as jden
from vision_pt_tpu.models.jit.config import DenoiserConfig as JaxDenoiserConfig
from vision_pt_tpu.ops import attention as jattn
from vision_pt_tpu.ops.short_attention import short_attention_packed as jax_packed
from vision_pt_tpu.utils.state_dict import flatten_state, load_flat_state
import vision_pt_tpu_torch.models.jit.denoiser as tden
from vision_pt_tpu_torch.models.jit.config import DenoiserConfig
from vision_pt_tpu_torch.models.jit.convert import from_jax_state
from vision_pt_tpu_torch.ops import attention as tattn

TINY = dict(
    patch_size=4, hidden_size=64, depth=3, num_heads=2, bottleneck_dim=16,
    context_dim=32, context_start_block=1, rope_axes_dims=[8, 12, 12],
    num_time_tokens=2,
)
FLOOR_DB = {"float32": 60.0, "bfloat16": 50.0}


def psnr(ours: np.ndarray, theirs: np.ndarray) -> float:
    mse = float(np.mean((ours - theirs) ** 2))
    peak = float(theirs.max() - theirs.min())
    return 10 * np.log10(peak**2 / max(mse, 1e-30))


def make_pair(dtype: str, seed: int = 0, **overrides):
    """A JAX JiT with perturbed parameters (non-unit gains, nonzero biases)
    and the port's JiT holding the same parameters."""
    cfg = {**TINY, **overrides}
    jdt = None if dtype == "float32" else getattr(jnp, dtype)
    tdt = None if dtype == "float32" else getattr(torch, dtype)
    jmodel = jden.Denoiser(JaxDenoiserConfig(**cfg), dtype=jdt, rngs=nnx.Rngs(seed))
    rng = np.random.default_rng(seed)
    flat = {}
    for key, value in flatten_state(jmodel).items():
        value = np.asarray(value)
        if "norm" in key:
            value = rng.uniform(0.5, 1.5, size=value.shape).astype(np.float32)
        elif key.endswith(".bias"):
            value = rng.normal(0, 0.02, size=value.shape).astype(np.float32)
        flat[key] = value
    load_flat_state(jmodel, flat)
    tmodel = tden.Denoiser(DenoiserConfig(**cfg), dtype=tdt, device="cpu")
    tmodel.load_state_dict(from_jax_state(flat), strict=True)
    return jmodel, tmodel


def make_inputs(batch=2, size=16, context_len=4, context_dim=32, seed=1):
    rng = np.random.default_rng(seed)
    return dict(
        image=rng.normal(size=(batch, size, size, 3)).astype(np.float32),
        timestep=rng.uniform(0, 1, size=batch).astype(np.float32),
        context=rng.normal(size=(batch, context_len, context_dim)).astype(np.float32),
        original_size=np.full((batch, 2), size, np.float32),
        target_size=np.full((batch, 2), size, np.float32),
        crop_coords=np.zeros((batch, 2), np.float32),
    )


def run_both(jmodel, tmodel, inputs, mask, dtype):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    tin = {k: torch.from_numpy(v) for k, v in inputs.items()}
    jin["image"] = jin["image"].astype(jdt)
    tin["image"] = tin["image"].to(tdt)
    jmask = None if mask is None else jnp.asarray(mask)
    tmask = None if mask is None else torch.from_numpy(mask)
    theirs = jmodel(**jin, context_mask=jmask)
    with torch.no_grad():
        ours = tmodel(**tin, context_mask=tmask)
    assert ours.shape == tuple(theirs.shape) and ours.dtype == tdt
    return ours.float().numpy(), np.asarray(theirs.astype(jnp.float32))


MASK = np.array([[1, 1, 1, 0], [1, 1, 0, 0]], np.int32)


@pytest.mark.parametrize("overrides", [
    {},
    {"use_output_bottleneck": True},
    {"do_context_fuse": True, "context_start_block": 0},
    {"norm_type": "layer"},
    {"use_pixel_shuffle": True, "timestep_scale": 1000.0},
], ids=["base", "bottleneck", "fuse", "layernorm", "shuffle"])
@pytest.mark.parametrize("with_mask", [True, False], ids=["mask", "nomask"])
def test_forward_parity_fp32(overrides, with_mask):
    jmodel, tmodel = make_pair("float32", **overrides)
    with jattn.attention_dtype(None), tattn.attention_dtype(None):
        ours, theirs = run_both(jmodel, tmodel, make_inputs(),
                                MASK if with_mask else None, "float32")
    assert psnr(ours, theirs) >= FLOOR_DB["float32"]


@pytest.mark.parametrize("with_mask", [True, False], ids=["mask", "nomask"])
def test_forward_parity_bf16(with_mask):
    jmodel, tmodel = make_pair("bfloat16")
    ours, theirs = run_both(jmodel, tmodel, make_inputs(),
                            MASK if with_mask else None, "bfloat16")
    assert np.isfinite(ours).all()
    assert psnr(ours, theirs) >= FLOOR_DB["bfloat16"]


@pytest.fixture
def packed_on_cpu(monkeypatch):
    """Open both packed-kernel gates on the CPU: the JAX side runs its Pallas
    kernel in interpret mode, the port's wrapper its plain version."""
    monkeypatch.setattr(jden, "_on_tpu", lambda: True)
    monkeypatch.setattr(jden, "short_attention_packed",
                        functools.partial(jax_packed, interpret=True))
    monkeypatch.setattr(jden, "MIN_PACKED_SEQ", 1)
    monkeypatch.setattr(tden, "_on_cuda", lambda x: True)
    monkeypatch.setattr(tden, "MIN_PACKED_SEQ", 1)
    calls = []
    real = tden.short_attention_packed

    def counting(*args, **kwargs):
        calls.append(kwargs.get("bounded"))
        return real(*args, **kwargs)

    monkeypatch.setattr(tden, "short_attention_packed", counting)
    return calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_mask", [True, False], ids=["mask", "nomask"])
def test_packed_branch_parity(packed_on_cpu, dtype, with_mask):
    jmodel, tmodel = make_pair(dtype)
    with jattn.attention_dtype(None), tattn.attention_dtype(None):
        ours, theirs = run_both(jmodel, tmodel, make_inputs(),
                                MASK if with_mask else None, dtype)
    # with a context mask only block 0 (before the context) is packed
    assert packed_on_cpu == [True] * (1 if with_mask else TINY["depth"])
    assert psnr(ours, theirs) >= FLOOR_DB[dtype]
