"""The port's JiT sampler (``JiTModel.generate``) against the JAX package's,
with the same parameters and the same injected initial noise, plus checkpoint
interop in both directions.

fp32 samplers run under ``attention_dtype(None)`` on both sides and must
reach 60 dB PSNR (measured 130-151 dB). bf16 samplers must reach 40 dB
(measured 46-55 dB): the carried image is rounded to bf16 at every Euler
step, so rounding differences of the denoiser compound over the steps."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_pt_tpu.models.jit import (
    ClassContextConfig as JaxClassContextConfig,
    DenoiserConfig as JaxDenoiserConfig,
    JiTConfig as JaxJiTConfig,
    JiTModel as JaxJiTModel,
)
from vision_pt_tpu.ops import attention as jattn
from vision_pt_tpu.utils.state_dict import flatten_state, load_flat_state
from vision_pt_tpu_torch.models.jit import (
    ClassContextConfig,
    DenoiserConfig,
    JiTConfig,
    JiTModel,
)
from vision_pt_tpu_torch.models.jit.convert import from_jax_state
from vision_pt_tpu_torch.ops import attention as tattn

TINY = dict(
    patch_size=4, hidden_size=64, depth=3, num_heads=2, bottleneck_dim=16,
    context_dim=32, context_start_block=1, rope_axes_dims=[8, 12, 12],
    num_time_tokens=2,
)
FLOOR_DB = {"float32": 60.0, "bfloat16": 40.0}
BATCH, SIZE, STEPS = 2, 16, 4


def psnr(ours: np.ndarray, theirs: np.ndarray) -> float:
    mse = float(np.mean((ours - theirs) ** 2))
    peak = float(theirs.max() - theirs.min())
    return 10 * np.log10(peak**2 / max(mse, 1e-30))


@pytest.fixture(scope="module")
def label2id(tmp_path_factory):
    path = tmp_path_factory.mktemp("jit") / "label2id.json"
    path.write_text(json.dumps({f"c{i}": i for i in range(6)}))
    return str(path)


def configs(label2id, dtype):
    return (
        JaxJiTConfig(context_encoder=JaxClassContextConfig(label2id_map_path=label2id),
                     denoiser=JaxDenoiserConfig(**TINY), dtype=dtype),
        JiTConfig(context_encoder=ClassContextConfig(label2id_map_path=label2id),
                  denoiser=DenoiserConfig(**TINY), dtype=dtype),
    )


def perturb(module, rng):
    """Non-unit norm gains and nonzero biases, so that every parameter
    matters to the comparison."""
    flat = {}
    for key, value in flatten_state(module).items():
        value = np.asarray(value)
        if "norm" in key:
            value = rng.uniform(0.5, 1.5, size=value.shape).astype(np.float32)
        elif key.endswith(".bias"):
            value = rng.normal(0, 0.02, size=value.shape).astype(np.float32)
        flat[key] = value
    load_flat_state(module, flat)
    return flat


def make_pair(label2id, dtype, seed=0):
    jconfig, tconfig = configs(label2id, dtype)
    jmodel = JaxJiTModel.new_with_config(jconfig, seed=seed)
    tmodel = JiTModel.new_with_config(tconfig, device="cpu")
    rng = np.random.default_rng(seed)
    for name in ("denoiser", "class_encoder"):
        flat = perturb(getattr(jmodel, name), rng)
        getattr(tmodel, name).load_state_dict(from_jax_state(flat), strict=True)
    return jmodel, tmodel


def noise(seed=3):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(BATCH, SIZE, SIZE, 3)).astype(np.float32)


def generate_both(jmodel, tmodel, dtype, init, **kw):
    kw = dict(prompt=["c1 c2", "c3"], width=SIZE, height=SIZE,
              num_inference_steps=STEPS, max_token_length=4,
              return_arrays=True, **kw)
    theirs = jmodel.generate(**kw, execution_dtype=getattr(jnp, dtype),
                             initial_noise=jnp.asarray(init))
    ours = tmodel.generate(**kw, execution_dtype=getattr(torch, dtype),
                           initial_noise=init)
    assert ours.shape == tuple(theirs.shape) == (BATCH, SIZE, SIZE, 3)
    assert ours.dtype == getattr(torch, dtype)
    return ours.float().numpy(), np.asarray(theirs.astype(jnp.float32))


SAMPLER_CASES = {
    "cfg": dict(cfg_scale=2.5),
    "renorm_threshold": dict(cfg_scale=2.5, do_cfg_renorm=True,
                             do_dynamic_thresholding=True),
    "per_step": dict(cfg_scale=2.5, cfg_time_range=(0.0, 0.5),
                     do_dynamic_thresholding=True),
    "no_cfg": dict(cfg_scale=1.0, negative_prompt="c5"),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(SAMPLER_CASES))
def test_generate_parity(label2id, case, dtype):
    jmodel, tmodel = make_pair(label2id, dtype)
    with jattn.attention_dtype(None), tattn.attention_dtype(None):
        ours, theirs = generate_both(jmodel, tmodel, dtype, noise(),
                                     **SAMPLER_CASES[case])
    assert np.isfinite(ours).all()
    assert psnr(ours, theirs) >= FLOOR_DB[dtype]


def _forward_both(jmodel, tmodel):
    """Class-conditioned denoiser outputs of both models on one input."""
    rng = np.random.default_rng(5)
    image = rng.normal(size=(BATCH, SIZE, SIZE, 3)).astype(np.float32)
    t = np.array([0.3, 0.7], np.float32)
    sizes = np.full((BATCH, 2), SIZE, np.float32)
    jemb, jmask = jmodel.class_encoder.encode_prompts(["c1", "c2 c4"], 4)
    temb, tmask = tmodel.class_encoder.encode_prompts(["c1", "c2 c4"], 4)
    np.testing.assert_array_equal(temb.detach().numpy(), np.asarray(jemb))
    with jattn.attention_dtype(None), tattn.attention_dtype(None):
        theirs = jmodel.denoiser(jnp.asarray(image), jnp.asarray(t), jemb,
                                 jnp.asarray(sizes), jnp.asarray(sizes),
                                 jnp.zeros((BATCH, 2)), context_mask=jmask)
        with torch.no_grad():
            ours = tmodel.denoiser(torch.from_numpy(image), torch.from_numpy(t),
                                   temb, torch.from_numpy(sizes),
                                   torch.from_numpy(sizes), torch.zeros(BATCH, 2),
                                   context_mask=tmask)
    return ours.numpy(), np.asarray(theirs)


def test_jax_checkpoint_loads_in_port(label2id, tmp_path):
    jconfig, tconfig = configs(label2id, "float32")
    jmodel = JaxJiTModel.new_with_config(jconfig, seed=1)
    rng = np.random.default_rng(1)
    perturb(jmodel.denoiser, rng)
    perturb(jmodel.class_encoder, rng)
    path = str(tmp_path / "jax.safetensors")
    jmodel.save_checkpoint(path)
    tmodel = JiTModel.from_pretrained(tconfig, path, device="cpu")
    ours, theirs = _forward_both(jmodel, tmodel)
    assert psnr(ours, theirs) >= FLOOR_DB["float32"]


def test_port_checkpoint_loads_in_jax(label2id, tmp_path):
    jconfig, tconfig = configs(label2id, "float32")
    tmodel = JiTModel.new_with_config(tconfig, seed=2, device="cpu")
    with torch.no_grad():  # non-unit gains, nonzero biases
        gen = torch.Generator().manual_seed(2)
        for name, p in tmodel.denoiser.named_parameters():
            if "norm" in name or name.endswith(".bias"):
                p.copy_(torch.rand(p.shape, generator=gen) + 0.5)
    path = str(tmp_path / "port.safetensors")
    tmodel.save_checkpoint(path)
    jmodel = JaxJiTModel.from_pretrained(jconfig, path)
    ours, theirs = _forward_both(jmodel, tmodel)
    assert psnr(ours, theirs) >= FLOOR_DB["float32"]
    # the reference layout round-trips exactly
    reloaded = JiTModel.from_pretrained(tconfig, path, device="cpu")
    for key, value in tmodel.state_dict().items():
        torch.testing.assert_close(reloaded.state_dict()[key], value, rtol=0, atol=0)


def test_text_context_is_not_ported(label2id):
    """The text context's default is a repo id, whose weights cannot be
    fetched: it raises as in the JAX package (a local directory loads, see
    ``tests/test_torch_jit_text.py``)."""
    config = JiTConfig(context_encoder={"type": "text"}, denoiser=DenoiserConfig(**TINY))
    with pytest.raises(NotImplementedError, match="weights available locally"):
        JiTModel.new_with_config(config, device="cpu")
