"""The port's SDXL sampler against the JAX package's, at the JAX tests' tiny
size (``tests/models/test_sdxl.py``: TINY_UNET, a 4-stage 8-16 wide VAE, two
2-layer CLIPs), with the JAX parameters carried across by
``convert.from_jax_state``, fp32 and ``attention_dtype(None)`` on both
sides, and the same numpy-made inputs and draws.

Tolerances, each relative to the largest value compared:
- one UNet call, the VAE and the text encoders, 1e-4: the same fp32
  arithmetic with sums, convolutions and norms in another order;
- the flash branch of the UNet, 1e-4: the port's plain flash version against
  the JAX package's plain attention (the same softmax, taken blockwise-free
  in both, in another order);
- the scheduler: its tables exactly, its steps to 1e-6;
- the whole ``generate``, 1e-4: the random-init tiny UNet is chaotic (the
  JAX tests measured ~3e-3 absolute at a latent scale of ~55 between two
  orderings of its own sampler, test_sdxl.py:305-325), yet the two packages
  agree to ~2e-6 here, with and without NF4; the two steps' noise draws
  swapped move the latents by ~0.15;
- checkpoint loading: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from vision_pt_tpu.models.sdxl import SDXLModel as JSDXLModel
from vision_pt_tpu.models.sdxl import convert as jconvert
from vision_pt_tpu.models.sdxl.config import DenoiserConfig as JDenoiserConfig
from vision_pt_tpu.models.sdxl.config import SDXLConfig as JSDXLConfig
from vision_pt_tpu.models.sdxl.denoiser import Denoiser as JDenoiser
from vision_pt_tpu.models.sdxl.scheduler import Scheduler as JScheduler
from vision_pt_tpu.ops.attention import attention_dtype as jattention_dtype
from vision_pt_tpu.ops.long_prompt import chunk_token_ids as jchunk_token_ids
from vision_pt_tpu.ops.quant import quantize_inplace as jquantize_inplace
from vision_pt_tpu.utils import state_dict as jstate_dict
from vision_pt_tpu.utils import tensor as jtensor
from vision_pt_tpu_torch.models.sdxl import (
    Denoiser,
    DenoiserConfig,
    SDXLConfig,
    SDXLModel,
    WordHashTokenizer,
)
from vision_pt_tpu_torch.models.sdxl import convert
from vision_pt_tpu_torch.models.sdxl.scheduler import Scheduler
from vision_pt_tpu_torch.ops import attention as tattn
from vision_pt_tpu_torch.ops.long_prompt import chunk_token_ids
from vision_pt_tpu_torch.ops.quant import quantize_inplace
from vision_pt_tpu_torch.tools import inference_cli
from vision_pt_tpu_torch.utils import state_dict as tstate_dict
from tests.test_torch_sdxl_distributed import one_torch_thread  # noqa: F401,E402

TINY_UNET = dict(
    hidden_dim=32,
    block_out_channels=[32, 32, 64],
    num_transformers_per_block=[1, 1, 2],
    num_head_channels=16,
    context_dim=32,
    layers_per_block=1,
)
TINY_MODEL = dict(
    checkpoint_path="",
    dtype="float32",
    denoiser={**TINY_UNET, "context_dim": 40},
    vae_config=dict(block_out_channels=(8, 16, 16, 16), layers_per_block=1,
                    norm_num_groups=4, latent_channels=4),
    # the word-hash tokenizer's ids reach 49407, so the tiny CLIPs keep the
    # real vocabulary size
    text_encoder_1_config=dict(hidden_size=16, intermediate_size=32,
                               num_hidden_layers=2, num_attention_heads=2),
    text_encoder_2_config=dict(hidden_size=24, intermediate_size=48,
                               num_hidden_layers=2, num_attention_heads=2,
                               hidden_act="gelu", projection_dim=1280),
)


def _close(got, want, rel):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def _flat(module):
    return {k: np.asarray(v) for k, v in jstate_dict.flatten_state(module).items()}


def _carry(jmodule, module):
    module.load_state_dict(convert.from_jax_state(_flat(jmodule)))


@pytest.fixture(scope="module")
def models():
    """The tiny SDXL model in both packages, with the same weights and the
    word-hash tokenizer."""
    jmodel = JSDXLModel.from_config(JSDXLConfig(**TINY_MODEL), rngs=nnx.Rngs(0))
    tokenizer = WordHashTokenizer()
    jmodel.text_encoder.tokenizer_1 = jmodel.text_encoder.tokenizer_2 = tokenizer
    model = SDXLModel.from_config(SDXLConfig(**TINY_MODEL), device="cpu",
                                  tokenizer_1=tokenizer, tokenizer_2=tokenizer)
    for name in ("denoiser", "vae"):
        _carry(getattr(jmodel, name), getattr(model, name))
    for name in ("text_encoder_1", "text_encoder_2"):
        _carry(getattr(jmodel.text_encoder, name), getattr(model.text_encoder, name))
    return jmodel, model


def _unet_inputs(batch, side, context, seed=0):
    rng = np.random.default_rng(seed)
    return [
        rng.normal(size=(batch, side, side, 4)).astype(np.float32),
        np.linspace(999.0, 10.0, batch).astype(np.float32),
        rng.normal(size=(batch, 7, context)).astype(np.float32),
        rng.normal(size=(batch, 1280)).astype(np.float32),
        np.full((batch, 2), 128.0, np.float32),
        np.full((batch, 2), 128.0, np.float32),
        np.zeros((batch, 2), np.float32),
    ]


def _unet_pair(config):
    junet = JDenoiser(JDenoiserConfig(**config), rngs=nnx.Rngs(0))
    unet = Denoiser(DenoiserConfig(**config)).eval()
    _carry(junet, unet)
    return junet, unet


@nnx.jit
def _jit_call(module, *args):
    """A JAX module's forward under ``nnx.jit`` (eager, the reference's op-by-op
    dispatch took most of these tests' time)."""
    return module(*args)


@nnx.jit
def _jax_encode(vae, image):
    dist = vae.encode(image)
    return dist.mean, dist.logvar


@nnx.jit
def _jax_decode(vae, latents):
    return vae.decode(latents)


@nnx.jit
def _jax_tiled_decode(vae, latents):
    return vae.tiled_decode(latents, tile_latent_size=8)


def _run_both(junet, unet, args):
    with jattention_dtype(None):
        want = np.asarray(_jit_call(junet, *map(jnp.asarray, args)))
    with tattn.attention_dtype(None), torch.no_grad():
        got = unet(*map(torch.from_numpy, args)).numpy()
    return got, want


def test_unet_forward_matches_jax():
    got, want = _run_both(*_unet_pair(TINY_UNET), _unet_inputs(2, 16, 32))
    assert got.shape == (2, 16, 16, 4)
    _close(got, want, 1e-4)


def test_unet_flash_branch_matches_jax(monkeypatch):
    """Head dim 64 and a 64 x 64 latent: stage 2 runs 32 x 32 = 1024 tokens,
    so with the card's gate opened ``auto`` sends its self-attention to the
    flash wrapper (its plain version on the CPU); the JAX package runs its
    plain attention there off the TPU."""
    config = {**TINY_UNET, "num_head_channels": 64, "block_out_channels": [32, 64, 64]}
    calls = []
    inner = tattn.flash_attention

    def counting(q, *args, **kwargs):
        calls.append(q.shape[1])
        return inner(q, *args, **kwargs)

    monkeypatch.setattr(tattn, "_on_cuda", lambda x: True)
    monkeypatch.setattr(tattn, "flash_attention", counting)
    got, want = _run_both(*_unet_pair(config), _unet_inputs(1, 64, 32, seed=1))
    assert calls == [1024] * 3  # one transformer down, two up
    _close(got, want, 1e-4)


def test_text_encoders_match_jax(models):
    jmodel, model = models
    prompts = ["a cat sitting on a mat " * 12, "bad"]  # 2 chunks of 75 tokens
    kw = dict(use_negative_prompts=True, max_token_length=150)
    want = jmodel.text_encoder.encode_prompts(prompts[0], prompts[1], **kw)
    with torch.no_grad():
        got = model.text_encoder.encode_prompts(prompts[0], prompts[1], **kw)
    assert got.text_encoder_1.positive_embeddings.shape == (1, 152, 16)
    for g, w in zip((*got.text_encoder_1, *got.text_encoder_2),
                    (*want.text_encoder_1, *want.text_encoder_2)):
        _close(g.numpy(), w, 1e-4)
    ids = WordHashTokenizer()(["a cat", "a much longer dog prompt"],
                              max_length=77)["input_ids"]
    jout = jmodel.text_encoder.text_encoder_2(jnp.asarray(ids))
    with torch.no_grad():
        out = model.text_encoder.text_encoder_2(torch.from_numpy(ids))
    for g, w in zip(out, jout):
        _close(g.numpy(), w, 1e-4)


def test_vae_matches_jax(models):
    jmodel, model = models
    rng = np.random.default_rng(2)
    image = rng.uniform(-1, 1, size=(1, 32, 32, 3)).astype(np.float32)
    jmean, jlogvar = _jax_encode(jmodel.vae, jnp.asarray(image))
    latents = rng.normal(size=(1, 12, 12, 4)).astype(np.float32)
    with torch.no_grad():
        dist = model.vae.encode(torch.from_numpy(image))
        decoded = model.vae.decode(torch.from_numpy(latents))
        tiled = model.vae.tiled_decode(torch.from_numpy(latents), tile_latent_size=8)
    _close(dist.mean.numpy(), jmean, 1e-4)
    _close(dist.logvar.numpy(), jlogvar, 1e-4)
    _close(decoded.numpy(), _jax_decode(jmodel.vae, jnp.asarray(latents)), 1e-4)
    assert tiled.shape == (1, 96, 96, 3)
    _close(tiled.numpy(), _jax_tiled_decode(jmodel.vae, jnp.asarray(latents)), 1e-4)


def test_scheduler_matches_jax():
    ours, theirs = Scheduler(), JScheduler()
    for steps in (2, 17, 20, 28, 50):
        t = ours.get_timesteps(steps)
        np.testing.assert_array_equal(t, theirs.get_timesteps(steps))
        np.testing.assert_array_equal(ours.get_sigmas(t), theirs.get_sigmas(t))
    sigmas = ours.get_sigmas(ours.get_timesteps(20))
    assert ours.get_max_noise_sigma(sigmas) == theirs.get_max_noise_sigma(sigmas)
    rng = np.random.default_rng(3)
    lat, pred, noise = (rng.normal(size=(1, 4, 4, 4)).astype(np.float32) for _ in range(3))
    for sigma, next_sigma in ((sigmas[0], sigmas[1]), (sigmas[-2], 0.0)):
        _close(ours.scale_model_input(torch.from_numpy(lat), sigma).numpy(),
               theirs.scale_model_input(jnp.asarray(lat), sigma), 1e-6)
        got = ours.ancestral_step(torch.from_numpy(lat), torch.from_numpy(pred),
                                  sigma, next_sigma, noise=torch.from_numpy(noise))
        want = theirs.ancestral_step(None, jnp.asarray(lat), jnp.asarray(pred),
                                     sigma, next_sigma, noise=jnp.asarray(noise))
        _close(got.numpy(), want, 1e-6)
    _close(ours.step(torch.from_numpy(lat), torch.from_numpy(pred), 10.0, 8.0).numpy(),
           theirs.step(jnp.asarray(lat), jnp.asarray(pred), 10.0, 8.0), 1e-6)


def test_encode_image_matches_jax(models):
    """PIL images through ``images_to_tensor`` and the VAE encoder; the
    latent draw is the distribution's mean plus std times the port's own
    seeded noise (the packages' generators differ)."""
    from PIL import Image

    from vision_pt_tpu_torch.utils.tensor import images_to_tensor

    jmodel, model = models
    rng = np.random.default_rng(6)
    image = Image.fromarray(rng.integers(0, 256, size=(32, 32, 3), dtype=np.uint8))
    tensor = images_to_tensor([image])
    np.testing.assert_array_equal(tensor.numpy(),
                                  np.asarray(jtensor.images_to_tensor([image])))
    with torch.no_grad():
        latents = model.encode_image(image, torch.Generator().manual_seed(0))
    jdist = jmodel.vae.encode(jnp.asarray(tensor.numpy()))
    noise = torch.randn(latents.shape, generator=torch.Generator().manual_seed(0))
    std = np.exp(0.5 * np.clip(np.asarray(jdist.logvar), -30.0, 20.0))
    want = (np.asarray(jdist.mean) + std * noise.numpy()) * 0.13025
    _close(latents.numpy(), want, 1e-4)


def test_sgm_keys_and_state_dict_round_trip(models):
    jmodel, model = models
    keys = [
        "model.diffusion_model.input_blocks.4.1.transformer_blocks.0.attn1.to_q.weight",
        "model.diffusion_model.middle_block.1.proj_in.bias",
        "model.diffusion_model.out.0.weight",
        "conditioner.embedders.0.transformer.text_model.encoder.layers.0.self_attn.q_proj.weight",
        "first_stage_model.decoder.up.0.block.1.conv1.weight",
        "first_stage_model.encoder.mid.block_1.norm1.weight",
        "first_stage_model.encoder.mid.attn_1.q.weight",
    ]
    for key in keys:
        internal = convert.convert_from_original_key(key)
        assert internal == jconvert.convert_from_original_key(key)
        assert convert.convert_to_original_key(internal) == key
        assert convert.convert_to_comfy_key(internal) == jconvert.convert_to_comfy_key(internal)
    want = jmodel.state_dict()
    got = model.state_dict()
    assert got.keys() == want.keys()
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(value), err_msg=key)


def test_open_clip_conversion_and_chunking_match_jax():
    rng = np.random.default_rng(4)
    sd = {
        "text_model.positional_embedding": rng.normal(size=(77, 8)),
        "text_model.token_embedding.weight": rng.normal(size=(10, 8)),
        "text_model.transformer.resblocks.0.attn.in_proj_weight": rng.normal(size=(24, 8)),
        "text_model.transformer.resblocks.0.attn.in_proj_bias": rng.normal(size=(24,)),
        "text_model.transformer.resblocks.0.attn.out_proj.weight": rng.normal(size=(8, 8)),
        "text_model.ln_final.weight": rng.normal(size=(8,)),
        "logit_scale": np.ones(()),
    }
    hf = tstate_dict.convert_open_clip_to_transformers(sd)
    jhf = jstate_dict.convert_open_clip_to_transformers(sd)
    assert hf.keys() == jhf.keys()
    back = tstate_dict.convert_transformers_to_open_clip(hf)
    assert back.keys() == jstate_dict.convert_transformers_to_open_clip(jhf).keys()
    for k, v in sd.items():
        if k != "logit_scale":
            np.testing.assert_array_equal(back[k], v)
    keys = ["a.attn1.to_q", "a.attn2.to_k", "b.ff.out", "time_embed.linear_1", "out_conv"]
    assert tstate_dict.get_target_keys(keys, ["attn", "ff"], ["to_k"]) == [
        "a.attn1.to_q", "b.ff.out"]
    assert tstate_dict.get_target_keys(keys, [r"^time_\w+"]) == ["time_embed.linear_1"]
    ids = np.asarray([[0, 5, 6, 7, 8, 9, 2, 1]])
    got = chunk_token_ids(ids, 0, 2, 1, max_length=6, chunk_length=3)
    want = jchunk_token_ids(ids, 0, 2, 1, max_length=6, chunk_length=3)
    np.testing.assert_array_equal(got.input_ids, want.input_ids)
    np.testing.assert_array_equal(got.attention_mask, want.attention_mask)


def _jax_draws(jmodel, steps, seed, shape):
    """What the JAX sampler draws for ``seed``: the initial latents and each
    step's ancestral noise (``jax.random.split(key(seed), steps)``)."""
    sigmas = jmodel.scheduler.get_sigmas(jmodel.scheduler.get_timesteps(steps))
    latents = jtensor.incremental_seed_randn(shape, seed=seed) * \
        jmodel.scheduler.get_max_noise_sigma(sigmas)
    keys = jax.random.split(jax.random.key(seed), steps)
    noise = [np.array(jax.random.normal(k, shape, dtype=jnp.float32)) for k in keys]
    return np.array(latents), noise


@pytest.mark.parametrize("quant_type", [None, "bnb_nf4"])
def test_generate_matches_jax(quant_type):
    jmodel = JSDXLModel.from_config(JSDXLConfig(**TINY_MODEL), rngs=nnx.Rngs(1))
    tokenizer = WordHashTokenizer()
    jmodel.text_encoder.tokenizer_1 = jmodel.text_encoder.tokenizer_2 = tokenizer
    model = SDXLModel.from_config(SDXLConfig(**TINY_MODEL), device="cpu",
                                  tokenizer_1=tokenizer, tokenizer_2=tokenizer)
    for name in ("denoiser", "vae"):
        _carry(getattr(jmodel, name), getattr(model, name))
    for name in ("text_encoder_1", "text_encoder_2"):
        _carry(getattr(jmodel.text_encoder, name), getattr(model.text_encoder, name))
    if quant_type is not None:
        keys = (inference_cli.INCLUDE_KEYS, inference_cli.EXCLUDE_KEYS)
        assert sorted(quantize_inplace(model.denoiser, quant_type, *keys)) == sorted(
            jquantize_inplace(jmodel.denoiser, quant_type, *keys))
    steps, seed = 2, 11
    latents, noise = _jax_draws(jmodel, steps, seed, (1, 8, 8, 4))
    kw = dict(prompt="a cat", negative_prompt="bad", width=64, height=64,
              num_inference_steps=steps, cfg_scale=3.0, seed=seed,
              return_latents=True)
    with jattention_dtype(None):
        want = np.asarray(jmodel.generate(**kw, execution_dtype=jnp.float32))
    with tattn.attention_dtype(None):
        got = model.generate(**kw, execution_dtype=torch.float32, latents=latents,
                             step_noise=noise)
    assert got.dtype == torch.float32
    _close(got.numpy(), want, 1e-4)


def test_bf16_sampling_keeps_the_execution_dtype(models):
    """The divergence the port fixes: under CFG the JAX sampler's fp32
    guidance scale promotes bf16 latents to fp32 and its scanned loop
    refuses the carry; the port rounds each step back to bf16."""
    jmodel, model = models
    kw = dict(prompt="a cat", width=64, height=64, num_inference_steps=2,
              cfg_scale=3.0, seed=7, return_latents=True)
    with pytest.raises(TypeError, match="carry"):
        jmodel.generate(**kw, execution_dtype=jnp.bfloat16)
    latents = model.generate(**kw, execution_dtype=torch.bfloat16)
    assert latents.dtype == torch.bfloat16 and bool(torch.isfinite(latents).all())


def test_from_checkpoint_loads_a_jax_written_sgm_file(models, tmp_path):
    from safetensors.numpy import save_file

    jmodel, _ = models
    sd = {k: np.ascontiguousarray(v) for k, v in jmodel.state_dict().items()}
    # original-format VAEs keep the attention projections as 1x1 convs
    q_key = "first_stage_model.encoder.mid.attn_1.q.weight"
    sd[q_key] = sd[q_key][:, :, None, None]
    path = str(tmp_path / "tiny_sdxl.safetensors")
    save_file(sd, path)
    loaded = SDXLModel.from_checkpoint(SDXLConfig(**{**TINY_MODEL, "checkpoint_path": path}),
                                       device="cpu")
    modules = {"denoiser": (jmodel.denoiser, loaded.denoiser),
               "vae": (jmodel.vae, loaded.vae),
               "te1": (jmodel.text_encoder.text_encoder_1, loaded.text_encoder.text_encoder_1),
               "te2": (jmodel.text_encoder.text_encoder_2, loaded.text_encoder.text_encoder_2)}
    for jmodule, module in modules.values():
        want = convert.from_jax_state(_flat(jmodule))
        got = module.state_dict()
        assert got.keys() == want.keys()
        for key, value in want.items():
            torch.testing.assert_close(got[key], value, rtol=0, atol=0, msg=key)


def test_cli_runs_on_the_cpu(models, tmp_path):
    import yaml
    from safetensors.torch import save_file

    _, model = models
    image = inference_cli.run(model, "a cat", width=64, height=64,
                              num_inference_steps=2, quant_type="bnb_nf4",
                              max_token_length=75,
                              save_path=str(tmp_path / "run.png"))
    assert tuple(image.shape) == (1, 64, 64, 3) and bool(torch.isfinite(image).all())
    assert (tmp_path / "run.png").exists()
    # the entry point, on a checkpoint and a tiny config
    fresh = SDXLModel.from_config(SDXLConfig(**TINY_MODEL), device="cpu", seed=3)
    checkpoint = str(tmp_path / "tiny.safetensors")
    save_file(fresh.state_dict(), checkpoint)
    config = tmp_path / "tiny.yml"
    config.write_text(yaml.safe_dump({k: v for k, v in TINY_MODEL.items()
                                      if k != "checkpoint_path"}))
    out = tmp_path / "cli.png"
    inference_cli.main(["--checkpoint-path", checkpoint, "--tokenizer", "word-hash",
                        "--model-config", str(config), "--width", "64",
                        "--height", "64", "--num-inference-steps", "2",
                        "--quant-type", "bnb_nf4", "--save-path", str(out),
                        "--device", "cpu"])
    assert out.exists()


def test_gradient_checkpointing_names_the_training_slice():
    """The training slice has come: per-layer recompute gives the UNet's
    output and input gradient unchanged."""
    unet = Denoiser(DenoiserConfig(**TINY_UNET))
    args = [torch.from_numpy(a) for a in _unet_inputs(2, 16, 32)]
    outs = []
    for enable in (False, True):
        unet.set_gradient_checkpointing(enable)
        assert unet.input_blocks.gradient_checkpointing is enable
        latents = args[0].clone().requires_grad_(True)
        out = unet(latents, *args[1:])
        out.square().mean().backward()
        outs.append((out.detach(), latents.grad))
    torch.testing.assert_close(outs[1][0], outs[0][0], rtol=0, atol=0)
    torch.testing.assert_close(outs[1][1], outs[0][1], rtol=1e-6, atol=1e-9)
