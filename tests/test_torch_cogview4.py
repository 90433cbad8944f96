"""The port's CogView4 sampler against the JAX package's, at the JAX tests'
tiny size (``tests/models/test_cogview4.py``: TINY, 2 layers of 4 heads x
16; the (8, 16) 4-channel VAE; a 2-layer GLM), with the JAX parameters
carried across by ``from_jax_state``, fp32 and ``attention_dtype(None)`` on
both sides, and the same numpy-made inputs and latents.

Tolerances, each relative to the largest value compared:
- the schedule (``time_shift_linear``, ``calculate_time_shift``,
  ``prepare_timesteps``) to 1e-6 and the RoPE tables exactly: the same fp32
  numpy or elementwise arithmetic;
- ``apply_rotary_emb``, 1e-6;
- one DiT call, the text encoder and the VAE decode, 1e-4: the same fp32
  arithmetic with sums, norms and convolutions in another order; also at
  S 1040 (head dim 64) through the flash branch's plain version, which the
  card's kernel takes;
- the 2-step CFG ``generate`` (injected embeddings, or the whole path
  from the word-hash tokens), 1e-4; one DiT call after NF4 or int8
  quantization, 1e-4 (both packages' codes are the same);
- checkpoint loading both ways: exact.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import nnx

from vision_pt_tpu.models.cogview4 import CogView4Config as JCogView4Config
from vision_pt_tpu.models.cogview4 import CogView4Model as JCogView4Model
from vision_pt_tpu.models.cogview4 import DenoiserConfig as JDenoiserConfig
from vision_pt_tpu.models.cogview4 import denoiser as jdenoiser
from vision_pt_tpu.models.cogview4 import pipeline as jpipeline
from vision_pt_tpu.models.cogview4.text_encoder import TextEncoder as JTextEncoder
from vision_pt_tpu.models.cogview4.text_encoder import (
    TextEncodingOutput as JTextEncodingOutput,
)
from vision_pt_tpu.models.lm.model import DecoderLM as JDecoderLM
from vision_pt_tpu.models.lm.model import DecoderLMConfig as JDecoderLMConfig
from vision_pt_tpu.ops import offload as joffload
from vision_pt_tpu.ops.attention import attention_dtype as jattention_dtype
from vision_pt_tpu.ops.quant import quantize_inplace as jquantize_inplace
from vision_pt_tpu.ops.timestep.sampling import time_shift_linear as jtime_shift_linear
from vision_pt_tpu.utils.state_dict import flatten_state
from vision_pt_tpu_torch.models.cogview4 import (
    CogView4Config,
    CogView4Model,
    DenoiserConfig,
    GLMWordHashTokenizer,
)
from vision_pt_tpu_torch.models.cogview4 import denoiser, pipeline
from vision_pt_tpu_torch.models.cogview4.text_encoder import TextEncodingOutput
from vision_pt_tpu_torch.models.lm import from_jax_state as lm_state
from vision_pt_tpu_torch.models.sdxl.convert import from_jax_state
from vision_pt_tpu_torch.ops import attention as tattn
from vision_pt_tpu_torch.ops.offload import LayerwiseOffloadStrategy
from vision_pt_tpu_torch.ops.timestep.sampling import time_shift_linear
from vision_pt_tpu_torch.tools import cogview4_quant_compare as tool

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = dict(
    patch_size=2, in_channels=4, out_channels=4, num_layers=2,
    attention_head_dim=16, num_attention_heads=4, text_embed_dim=32,
    time_embed_dim=32, condition_dim=8, rope_axes_dim=[16, 16],
)
TINY_VAE = dict(block_out_channels=(8, 16), layers_per_block=1, norm_num_groups=4,
                latent_channels=4)
# the tiny GLM of tests/models/test_cogview4.py, 32 wide as TINY's text
# embedding; the word-hash tokenizer's ids need GLM-4's vocabulary
TINY_GLM = dict(vocab_size=151552, hidden_size=32, intermediate_size=64,
                num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                head_dim=8, partial_rotary_factor=0.5, attention_bias=True,
                rms_norm_eps=1e-6, arch="glm")
TOL = 1e-4


def _close(got, want, rel=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def _flat(module):
    return {k: np.asarray(v) for k, v in flatten_state(module).items()}


def _config(cls, denoiser_cls, **extra):
    fields = dict(checkpoint_path="", dtype="float32", vae_config=TINY_VAE)
    return cls(denoiser=denoiser_cls(**TINY), **{**fields, **extra})


@pytest.fixture(scope="module")
def models():
    """The tiny model in both packages with the same weights and the GLM
    word-hash tokenizer."""
    tokenizer = GLMWordHashTokenizer()
    jmodel = JCogView4Model.from_config(_config(JCogView4Config, JDenoiserConfig),
                                        build_text_encoder=False)
    jmodel.text_encoder = JTextEncoder(
        JDecoderLM(JDecoderLMConfig(**TINY_GLM), rngs=nnx.Rngs(1)), tokenizer)
    model = CogView4Model.from_config(
        _config(CogView4Config, DenoiserConfig, text_encoder_config=TINY_GLM),
        device="cpu", tokenizer=tokenizer)
    model.denoiser.load_state_dict(from_jax_state(_flat(jmodel.denoiser)))
    model.vae.load_state_dict(from_jax_state(_flat(jmodel.vae)))
    model.text_encoder.model.load_state_dict(lm_state(_flat(jmodel.text_encoder.model)))
    return jmodel, model


def _dit_inputs(batch=2, side=8, text=6, width=32, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(batch, side, side, 4)).astype(np.float32),
            rng.normal(size=(batch, text, width)).astype(np.float32),
            np.linspace(999.0, 10.0, batch).astype(np.float32),
            np.full((batch, 2), 64.0, np.float32), np.full((batch, 2), 64.0, np.float32),
            np.zeros((batch, 2), np.float32)]


def _dit(jdit, dit, args):
    with jattention_dtype(None):
        want = nnx.jit(lambda m, *a: m(*a))(jdit, *map(jnp.asarray, args))
    with tattn.attention_dtype(None), torch.no_grad():
        got = dit(*map(torch.from_numpy, args))
    return got, want


# ------------------------------------------------------------- schedule


def test_time_shift_and_timesteps_match(models):
    jmodel, model = models
    t = np.linspace(0.05, 1.0, 9).astype(np.float32)
    for seq in (16, 256, 4096):
        mu = pipeline.calculate_time_shift(seq)
        assert mu == jpipeline.calculate_time_shift(seq)
        _close(time_shift_linear(mu, torch.from_numpy(t)),
               jtime_shift_linear(mu, jnp.asarray(t)), 1e-6)
    for steps, side in ((2, 16), (20, 1024), (7, 512)):
        got, want = model.prepare_timesteps(steps, side, side), \
            jmodel.prepare_timesteps(steps, side, side)
        np.testing.assert_array_equal(got[0], want[0])
        _close(got[1], want[1], 1e-6)
        assert got[1].dtype == np.float32 and got[1][-1] == 0.0


def test_rope_tables_and_rotary_match():
    for head_dim, grid, axes in ((16, (8, 8), (16, 16)), (128, (128, 96), (256, 256))):
        got = denoiser.RoPE(head_dim, 2, axes)(*grid)
        want = jdenoiser.RoPE(head_dim, 2, axes)(*grid)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    cos, sin = denoiser.RoPE(16, 2, (16, 16))(8, 8)
    x = np.random.default_rng(3).normal(size=(2, 16, 4, 16)).astype(np.float32)
    _close(denoiser.apply_rotary_emb(*map(torch.from_numpy, (x, cos, sin))),
           jdenoiser.apply_rotary_emb(*map(jnp.asarray, (x, cos, sin))), 1e-6)


# ------------------------------------------------------------- modules


def test_dit_forward_matches(models):
    jmodel, model = models
    got, want = _dit(jmodel.denoiser, model.denoiser, _dit_inputs())
    assert got.shape == (2, 8, 8, 4)
    _close(got, want)


def test_dit_flash_branch_matches(monkeypatch):
    """Head dim 64 at a 64 x 64 latent: S = 1024 image + 16 text tokens, the
    flash branch's plain version in the port (as on the card), the JAX
    package's plain attention."""
    cfg = {**TINY, "num_attention_heads": 1, "attention_head_dim": 64,
           "rope_axes_dim": [64, 64]}
    jdit = jdenoiser.CogView4DiT(JDenoiserConfig(**cfg), rngs=nnx.Rngs(2))
    dit = denoiser.CogView4DiT(DenoiserConfig(**cfg))
    dit.load_state_dict(from_jax_state(_flat(jdit)))
    calls = []
    reference = tattn.flash_attention

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return reference(*a, **kw)

    monkeypatch.setattr(tattn, "_on_cuda", lambda x: True)
    monkeypatch.setattr(tattn, "flash_attention", counted)
    got, want = _dit(jdit, dit.eval(), _dit_inputs(batch=1, side=64, text=16))
    assert calls == [(1, 1040, 1, 64)] * 2
    _close(got, want)


def test_text_encoder_pads_and_matches(models):
    jmodel, model = models
    prompts, negative = ["a photo of a cat", "one two three"], "blurry"
    got = model.text_encoder.encode_prompts(prompts, negative,
                                            use_negative_prompts=True)
    want = jmodel.text_encoder.encode_prompts(prompts, negative,
                                              use_negative_prompts=True)
    ids = model.text_encoder.tokenize(prompts + [negative] * 2, 1024)
    # [gMASK]<sop> + 5 words, left-padded with 151329 to 16
    assert ids.shape == (4, 16)
    assert (ids[:, :9] == 151329).all() and (ids[0, 9:11] == [151331, 151333]).all()
    assert (ids[1, :11] == 151329).all() and (ids[2, :13] == 151329).all()
    assert ((ids < 151329) | (ids == 151329) | (ids >= 151331)).all()
    for g, w in zip(got, want):
        assert tuple(g.shape) == tuple(w.shape)
    assert tuple(got.positive_embeddings.shape) == (2, 16, 32)
    _close(got.positive_embeddings, want.positive_embeddings)
    _close(got.negative_embeddings, want.negative_embeddings)
    assert got.positive_attention_mask.dtype == torch.int32
    assert int(got.negative_attention_mask.min()) == 1


def test_word_hash_tokenizer():
    tok = GLMWordHashTokenizer()
    out = tok(["a b c d e f", ""], max_length=4, padding="longest", truncation=True,
              add_special_tokens=False)["input_ids"]
    assert out.shape == (2, 4) and (out[1] == 151329).all()
    assert (out[0] < 151329).all()
    plain = tok(["x y"], padding="max_length", max_length=6)["input_ids"]
    assert plain.shape == (1, 6) and (plain[0, :2] == 151329).all()
    assert (plain[0, 2:4] == [151331, 151333]).all()


def test_vae_decode_matches(models):
    jmodel, model = models
    lat = np.random.default_rng(4).normal(size=(1, 4, 4, 4)).astype(np.float32)
    _close(model.decode_latents(torch.from_numpy(lat)),
           jmodel.vae.decode(jnp.asarray(lat) / jmodel.vae.scaling_factor))


# ------------------------------------------------------------- sampling


class _FakeEncoder:
    """Text embeddings handed in, as the JAX tests' mock does."""

    def __init__(self, emb, out_cls, wrap):
        self.emb, self.out_cls, self.wrap = emb, out_cls, wrap

    def encode_prompts(self, prompts, negative_prompts=None,
                       use_negative_prompts=False, max_token_length=16):
        pos, neg = (self.wrap(e) for e in self.emb)
        ones = self.wrap(np.ones(self.emb[0].shape[:2], np.int32))
        return self.out_cls(pos, ones, neg, ones)


def _generate(jmodel, model, monkeypatch, emb=None, steps=2, side=16):
    rng = np.random.default_rng(5)
    latent = side // model.vae.compression_ratio  # the 2-stage VAE halves once
    lat = rng.normal(size=(1, latent, latent, 4)).astype(np.float32)
    kw = dict(width=side, height=side, num_inference_steps=steps, cfg_scale=4.0,
              seed=1, return_latents=True)
    if emb is not None:
        monkeypatch.setattr(jmodel, "text_encoder",
                            _FakeEncoder(emb, JTextEncodingOutput, jnp.asarray))
        monkeypatch.setattr(model, "text_encoder",
                            _FakeEncoder(emb, TextEncodingOutput, torch.from_numpy))
    monkeypatch.setattr(jmodel, "prepare_latents",
                        lambda *a, **k: jnp.asarray(lat))
    with jattention_dtype(None):
        want = jmodel.generate("a red fox", "blurry", execution_dtype=jnp.float32, **kw)
    with tattn.attention_dtype(None):
        got = model.generate("a red fox", "blurry", execution_dtype=torch.float32,
                             latents=lat, **kw)
    return got, want


def _embeddings(seed=6):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(1, 6, 32)).astype(np.float32) for _ in range(2)]


def test_generate_with_injected_embeddings_matches(models, monkeypatch):
    got, want = _generate(*models, monkeypatch, emb=_embeddings())
    assert tuple(got.shape) == (1, 8, 8, 4)
    _close(got, want)


def test_generate_end_to_end_matches(models, monkeypatch):
    """The slice as a whole: word-hash tokens, the GLM tower, 2 CFG steps of
    the DiT and the decode."""
    jmodel, model = models
    got, want = _generate(jmodel, model, monkeypatch)
    _close(got, want)
    _close(model.decode_latents(got),
           jmodel.vae.decode(want / jmodel.vae.scaling_factor))
    images = model.decode_image(got)
    assert len(images) == 1 and images[0].size == (16, 16)


# ------------------------------------------------------------- checkpoint


def test_checkpoint_round_trips_both_ways(models, tmp_path):
    from safetensors.numpy import save_file
    from safetensors.torch import save_file as save_torch

    jmodel, model = models
    args = _dit_inputs(seed=7)
    # the JAX package's file (its own to_out.0.0 keys) into the port
    path = str(tmp_path / "jax.safetensors")
    save_file({k: np.ascontiguousarray(v) for k, v in jmodel.state_dict().items()}, path)
    cfg = _config(CogView4Config, DenoiserConfig, checkpoint_path=path)
    loaded = CogView4Model.from_checkpoint(cfg, device="cpu", seed=3,
                                           build_text_encoder=False)
    for k, v in model.denoiser.state_dict().items():
        np.testing.assert_array_equal(loaded.denoiser.state_dict()[k].numpy(), v.numpy())
    for k, v in model.vae.state_dict().items():
        np.testing.assert_array_equal(loaded.vae.state_dict()[k].numpy(), v.numpy())
    # the port's file (the original layout) into the JAX package
    sd = model.state_dict()
    assert "diffusion_model.transformer_blocks.0.attn1.to_out.0.weight" in sd
    assert "diffusion_model.transformer_blocks.1.ff.net.0.proj.bias" in sd
    assert not any(k.startswith("denoiser.") for k in sd)
    path = str(tmp_path / "port.safetensors")
    save_torch(sd, path)
    jloaded = JCogView4Model.from_config(_config(JCogView4Config, JDenoiserConfig),
                                         build_text_encoder=False,
                                         rngs=nnx.Rngs(9))
    jloaded._load_checkpoint(path)
    got, want = _dit(jloaded.denoiser, model.denoiser, args)
    np.testing.assert_array_equal(
        np.asarray(jnp.asarray(_flat(jloaded.vae)["decoder.conv_out.kernel"])),
        _flat(jmodel.vae)["decoder.conv_out.kernel"])
    _close(got, want)


def test_prequantized_checkpoint_loads(models, tmp_path):
    from safetensors.torch import save_file

    from vision_pt_tpu_torch.ops.quant import QuantLinear4bit, quantize_state_dict

    _, model = models
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    quantized = quantize_state_dict(sd, "bnb_nf4", ["attn1.to_q"])
    path = str(tmp_path / "nf4.safetensors")
    save_file({k: torch.as_tensor(np.ascontiguousarray(v)) for k, v in quantized.items()},
              path)
    cfg = _config(CogView4Config, DenoiserConfig, checkpoint_path=path)
    loaded = CogView4Model.from_checkpoint(cfg, device="cpu", build_text_encoder=False)
    blocks = loaded.denoiser.transformer_blocks
    assert all(isinstance(b.attn1.to_q, QuantLinear4bit) for b in blocks)
    args = [torch.from_numpy(a) for a in _dit_inputs(seed=8)]
    with tattn.attention_dtype(None), torch.no_grad():
        got, dense = loaded.denoiser(*args), model.denoiser(*args)
    assert float((got - dense).abs().max()) > 0
    _close(got, dense, 5e-2)  # 4-bit weights of two of the twelve products


# ------------------------------------------------------------- quantization


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_cogview4_quant_compare", ROOT / "tools" / "cogview4_quant_compare.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("quant", ["bnb_nf4", "bnb_int8"])
def test_quantize_model_matches(quant):
    jmodel = JCogView4Model.from_config(_config(JCogView4Config, JDenoiserConfig),
                                        build_text_encoder=False, rngs=nnx.Rngs(4))
    model = CogView4Model.from_config(_config(CogView4Config, DenoiserConfig),
                                      device="cpu", build_text_encoder=False)
    model.denoiser.load_state_dict(from_jax_state(_flat(jmodel.denoiser)))
    _jax_tool().quantize_model(jmodel, "bf16", quant)
    replaced = tool.quantize_model(model, "bf16", quant)
    assert replaced["text_encoder"] == [] and len(replaced["denoiser"]) == 2 * 6
    assert all(p.startswith("denoiser.transformer_blocks.") for p in replaced["denoiser"])
    got, want = _dit(jmodel.denoiser, model.denoiser, _dit_inputs(seed=9))
    _close(got, want)


def test_text_encoder_quantization_replaces_nothing(models):
    """The JAX package's walk never enters the plain-class text encoder, so
    the tool's text-encoder quantization replaces 0 linears; the port keeps
    that."""
    jmodel, model = models
    include, exclude = tool.TEXT_ENCODER_KEYS
    assert jquantize_inplace(jmodel, "bnb_nf4", include, exclude) == []
    replaced = tool.quantize_model(model, "bnb_nf4", "bf16")
    assert replaced == {"text_encoder": [], "denoiser": []}
    assert type(model.text_encoder.model.layers[0].self_attn.q_proj).__name__ == "Linear"


# ------------------------------------------------------------- offload


@pytest.mark.parametrize("layers,groups", [(28, 4), (5, 2), (7, 3), (4, 4)])
def test_offload_group_table_matches(layers, groups):
    got = LayerwiseOffloadStrategy.from_num_groups(layers, groups, enabled=False)
    want = joffload.LayerwiseOffloadStrategy.from_num_groups(layers, groups,
                                                             enabled=False)
    assert got.offload_args == want.offload_args
    assert [list(g) for g in got.layer_groups] == [list(g) for g in want.layer_groups]
    assert [got.should_offload(i) for i in range(layers)] == \
        [want.should_offload(i) for i in range(layers)]


def test_offload_is_a_no_op_on_the_cpu(models):
    _, model = models
    args = [torch.from_numpy(a) for a in _dit_inputs(seed=10)]
    with tattn.attention_dtype(None), torch.no_grad():
        plain = model.denoiser(*args)
        strategy = LayerwiseOffloadStrategy.from_num_groups(2, 2)
        model.denoiser.set_offload_strategy(strategy)
        try:
            with model.denoiser.while_offloaded(list(model.denoiser.transformer_blocks)):
                offloaded = model.denoiser(*args)
        finally:
            model.denoiser.set_offload_strategy(None)
    assert strategy.enabled is False
    assert torch.equal(plain, offloaded)


# ------------------------------------------------------------- entry points


def test_entry_points_need_cuda_or_an_explicit_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        CogView4Model(_config(CogView4Config, DenoiserConfig), build_text_encoder=False)


def test_tool_main_runs_on_the_cpu(models, tmp_path, capsys):
    _, model = models
    from safetensors.torch import save_file

    checkpoint = str(tmp_path / "tiny.safetensors")
    save_file(model.state_dict(), checkpoint)
    config = tmp_path / "tiny.yml"
    config.write_text(yaml.safe_dump(dict(
        dtype="float32", denoiser=TINY, vae_config=dict(TINY_VAE,
                                                        block_out_channels=[8, 16]),
        text_encoder_config=TINY_GLM)))
    out = tmp_path / "out"
    tool.main(["--model_path", checkpoint, "--model-config", str(config),
               "--tokenizer", "word-hash", "--device", "cpu", "--height", "16",
               "--width", "16", "--num_inference_steps", "2",
               "--denoiser_quants", "bf16,bnb_nf4", "--save_dir", str(out)])
    import json

    results = json.loads((out / "results.json").read_text())
    assert set(results) == {"bf16", "bnb_nf4"}
    assert results["bf16"]["psnr_vs_bf16"] == float("inf")
    assert results["bnb_nf4"]["quantized_linears"] == {"text_encoder": 0,
                                                       "denoiser": 12}
    assert (out / "denoiser-bnb_nf4.webp").exists()
    assert "bnb_nf4" in capsys.readouterr().out
