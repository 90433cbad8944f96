"""Text-conditioned JiT in the port (``models/jit/text_encoder.py`` and the
text branch of ``models/jit/pipeline.py``) against the JAX package's, on the
CPU: one HF-style directory of a tiny Qwen3 tower (2 layers, hidden 32,
Qwen's full 151,936-token vocabulary so the word-hash ids fit), written
from numpy draws, loaded by both ``from_local``.

Tolerances, relative to the largest value compared:
- the penultimate hidden states, 1e-5 in fp32 (the same arithmetic with
  sums in another order);
- the sampler, the PSNR floors of ``tests/test_torch_jit_pipeline.py``:
  60 dB in fp32, 40 dB in bf16.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from vision_pt_tpu.models.jit import (
    DenoiserConfig as JaxDenoiserConfig,
    JiTConfig as JaxJiTConfig,
    JiTModel as JaxJiTModel,
    TextContextConfig as JaxTextContextConfig,
)
from vision_pt_tpu.models.jit import text_encoder as jte
from vision_pt_tpu.ops import attention as jattn
from vision_pt_tpu.utils.state_dict import flatten_state, load_flat_state
from vision_pt_tpu_torch.models.jit import (
    DenoiserConfig,
    JiTConfig,
    JiTModel,
    TextContextConfig,
)
from vision_pt_tpu_torch.models.jit import text_encoder as te
from vision_pt_tpu_torch.models.jit.convert import from_jax_state
from vision_pt_tpu_torch.ops import attention as tattn
from tests.test_torch_jit_pipeline import perturb

TOWER = dict(vocab_size=151936, hidden_size=32, intermediate_size=64,
             num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
             head_dim=16, rms_norm_eps=1e-6, rope_theta=5_000_000.0)
TINY = dict(patch_size=4, hidden_size=64, depth=3, num_heads=2, bottleneck_dim=16,
            context_dim=TOWER["hidden_size"], context_start_block=1,
            rope_axes_dims=[8, 12, 12], num_time_tokens=2)
PROMPTS = ["a red fox in the snow", "lighthouse", "two cats on a blue sofa at night"]
TOL = 1e-5
FLOOR_DB = {"float32": 60.0, "bfloat16": 40.0}


def tower_state(seed: int = 0, norm_key: str = ".weight") -> dict[str, np.ndarray]:
    """The tower's parameters in HF names (``model.`` prefix, weights
    (out, in)); norm scales drawn around 1 and keyed with ``norm_key`` after
    their module path (HF files: ``.weight``; the JAX package's own test
    files: nothing)."""
    rng = np.random.default_rng(seed)
    c = TOWER
    d, f, hd = c["hidden_size"], c["intermediate_size"], c["head_dim"]
    q, kv = c["num_attention_heads"] * hd, c["num_key_value_heads"] * hd

    def w(out, inp):
        return (rng.normal(size=(out, inp)) / np.sqrt(inp)).astype(np.float32)

    def norm(n):
        return rng.uniform(0.5, 1.5, size=n).astype(np.float32)

    # the embedding table at HF's initializer range (0.02)
    sd = {"model.embed_tokens.weight":
          (0.02 * rng.normal(size=(c["vocab_size"], d))).astype(np.float32),
          f"model.norm{norm_key}": norm(d),
          "lm_head.weight": w(c["vocab_size"], d)}
    for i in range(c["num_hidden_layers"]):
        p = f"model.layers.{i}."
        sd |= {p + "self_attn.q_proj.weight": w(q, d), p + "self_attn.k_proj.weight": w(kv, d),
               p + "self_attn.v_proj.weight": w(kv, d), p + "self_attn.o_proj.weight": w(d, q),
               p + f"self_attn.q_norm{norm_key}": norm(hd),
               p + f"self_attn.k_norm{norm_key}": norm(hd),
               p + "mlp.gate_proj.weight": w(f, d), p + "mlp.up_proj.weight": w(f, d),
               p + "mlp.down_proj.weight": w(d, f),
               p + f"input_layernorm{norm_key}": norm(d),
               p + f"post_attention_layernorm{norm_key}": norm(d)}
    return sd


def write_tower(path, seed: int = 0, norm_key: str = ".weight"):
    """An HF-style Qwen3-VL directory: the text config nested as
    ``text_config``, the weights in one safetensors file; no tokenizer."""
    path.mkdir(parents=True, exist_ok=True)
    sd = tower_state(seed, norm_key)
    save_file(sd, str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps(
        {"model_type": "qwen3_vl", "text_config": TOWER}))
    return sd


@pytest.fixture(scope="module")
def tower(tmp_path_factory):
    """A directory whose norm scales are bare keys, which both packages
    load."""
    path = tmp_path_factory.mktemp("qwen") / "tower"
    write_tower(path, norm_key="")
    return path


def _close(got, want, rel=TOL):
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def _encoders(path):
    jenc = jte.TextEncoder.from_local(str(path))
    enc = te.TextEncoder.from_local(str(path))
    assert jenc.tokenizer is None and enc.tokenizer is None  # no tokenizer files
    jenc.tokenizer = enc.tokenizer = te.QwenWordHashTokenizer()
    return jenc, enc


def test_config_and_from_local_match_jax(tower):
    jenc, enc = _encoders(tower)
    assert te._config_from_hf(TOWER) == te.DecoderLMConfig(**TOWER, arch="qwen3")
    want = {k: np.asarray(v) for k, v in flatten_state(jenc.model).items()}
    sd = tower_state(norm_key="")
    got = enc.model.state_dict()
    assert len(got) == len(want) == len(sd) - 1  # lm_head left out
    for key, value in sd.items():
        if key.startswith("model."):
            key = key.removeprefix("model.")
            name = key if key.endswith(".weight") else key + ".weight"
            np.testing.assert_array_equal(got[name].numpy(), value, err_msg=key)
    ids = np.random.default_rng(1).integers(0, TOWER["vocab_size"], (2, 9))
    out = enc.model(torch.from_numpy(ids))
    jout = jenc.model(jnp.asarray(ids))
    _close(out.penultimate_hidden_state.detach(), jout.penultimate_hidden_state)
    _close(out.last_hidden_state.detach(), jout.last_hidden_state)
    for field in ("vocab_size", "hidden_size", "num_hidden_layers", "num_key_value_heads",
                  "head_dim", "rope_theta", "rms_norm_eps"):
        assert (getattr(te.QWEN3_VL_2B_TEXT_CONFIG, field)
                == getattr(jte.QWEN3_VL_2B_TEXT_CONFIG, field))


def test_hf_norm_keys_load_in_the_port_only(tmp_path):
    """A kept divergence: an HF file names the norm scales ``...norm.weight``;
    the JAX package's nnx keys have no ``.weight``, and its non-strict load
    leaves those scales at their init of ones. The port loads them."""
    sd = write_tower(tmp_path / "hf")
    jenc = jte.TextEncoder.from_local(str(tmp_path / "hf"))
    enc = te.TextEncoder.from_local(str(tmp_path / "hf"))
    jflat = flatten_state(jenc.model)
    for name in ("norm", "layers.0.input_layernorm", "layers.1.self_attn.q_norm"):
        np.testing.assert_array_equal(enc.model.state_dict()[name + ".weight"].numpy(),
                                      sd[f"model.{name}.weight"])
        np.testing.assert_array_equal(np.asarray(jflat[name]), 1.0)
    # every other tensor loads alike
    np.testing.assert_array_equal(
        enc.model.state_dict()["layers.1.mlp.down_proj.weight"].numpy(),
        np.asarray(jflat["layers.1.mlp.down_proj.kernel"]).T)


@pytest.mark.parametrize("negatives", [None, "ugly, blurry", ["x", "y y", ""], False])
def test_encode_prompts_match_jax(tower, negatives):
    jenc, enc = _encoders(tower)
    use = negatives is not False
    neg = None if negatives is False else negatives
    out = enc.encode_prompts(PROMPTS, neg, use_negative_prompts=use, max_token_length=5)
    jout = jenc.encode_prompts(PROMPTS, neg, use_negative_prompts=use, max_token_length=5)
    _close(out.positive_embeddings, jout.positive_embeddings)
    np.testing.assert_array_equal(out.positive_attention_mask.numpy(),
                                  np.asarray(jout.positive_attention_mask))
    assert out.positive_embeddings.shape == (3, 5, TOWER["hidden_size"])
    if not use:
        assert out.negative_embeddings is None and jout.negative_embeddings is None
        return
    _close(out.negative_embeddings, jout.negative_embeddings)
    np.testing.assert_array_equal(out.negative_attention_mask.numpy(),
                                  np.asarray(jout.negative_attention_mask))


def test_word_hash_tokenizer_pads_right_with_endoftext():
    ids = te.QwenWordHashTokenizer()(["a b c", "d", ""], max_length=2)["input_ids"]
    assert ids.shape == (3, 2) and ids.dtype == np.int64
    assert (ids[1, 1], ids[2, 0], ids[2, 1]) == (te.PAD_TOKEN_ID,) * 3
    assert ids[0, 0] == ids[0, 0] < te.PAD_TOKEN_ID and ids[0, 0] != ids[0, 1]
    longest = te.QwenWordHashTokenizer()(["a b c", "d"], max_length=8)["input_ids"]
    np.testing.assert_array_equal(longest[:, :2], [ids[0], ids[1]])
    assert longest.shape == (2, 3)


def test_missing_weights_and_tokenizer_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="available locally"):
        te.TextEncoder.from_remote()
    with pytest.raises(NotImplementedError, match="egress"):
        jte.TextEncoder.from_remote()
    config = JiTConfig(context_encoder=TextContextConfig(pretrained_model="org/missing"),
                       denoiser=DenoiserConfig(**TINY))
    with pytest.raises(NotImplementedError, match="org/missing"):
        JiTModel(config, device="cpu")
    write_tower(tmp_path / "t")
    enc = te.TextEncoder.from_local(str(tmp_path / "t"))
    with pytest.raises(RuntimeError, match="Qwen tokenizer"):
        enc.encode_prompts("a cat")


def _text_pair(path, dtype):
    jconfig = JaxJiTConfig(context_encoder=JaxTextContextConfig(pretrained_model=str(path)),
                           denoiser=JaxDenoiserConfig(**TINY), dtype=dtype)
    tconfig = JiTConfig(context_encoder=TextContextConfig(pretrained_model=str(path)),
                        denoiser=DenoiserConfig(**TINY), dtype=dtype)
    jmodel = JaxJiTModel.new_with_config(jconfig, seed=0)
    tmodel = JiTModel.new_with_config(tconfig, device="cpu")
    flat = perturb(jmodel.denoiser, np.random.default_rng(0))
    # the final projection widened from std 0.02 to 0.5, so the sampled
    # image spans [-1, 1] as a trained model's does: at 0.02 it is within
    # 0.05 of 0, where bf16's rounding of the carried noise at the last Euler
    # step sets the PSNR on either side (JAX bf16 against JAX fp32: 34.6 dB; 46.7 dB
    # widened, the port's bf16 against JAX's 43.9)
    flat["final_layer.linear.kernel"] = flat["final_layer.linear.kernel"] * 25.0
    load_flat_state(jmodel.denoiser, flat)
    tmodel.denoiser.load_state_dict(from_jax_state(flat), strict=True)
    jmodel.text_encoder.tokenizer = tmodel.text_encoder.tokenizer = te.QwenWordHashTokenizer()
    return jmodel, tmodel


def psnr(ours: np.ndarray, theirs: np.ndarray) -> float:
    mse = float(np.mean((ours - theirs) ** 2))
    peak = float(theirs.max() - theirs.min())
    return 10 * np.log10(peak**2 / max(mse, 1e-30))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_generate_matches_jax(tower, dtype):
    jmodel, tmodel = _text_pair(tower, dtype)
    init = np.random.default_rng(3).normal(size=(2, 16, 16, 3)).astype(np.float32)
    kw = dict(prompt=PROMPTS[:2], negative_prompt="blurry", width=16, height=16,
              num_inference_steps=3, cfg_scale=2.0, max_token_length=64,
              return_arrays=True)
    with jattn.attention_dtype(None), tattn.attention_dtype(None):
        theirs = jmodel.generate(**kw, execution_dtype=getattr(jnp, dtype),
                                 initial_noise=jnp.asarray(init))
        ours = tmodel.generate(**kw, execution_dtype=getattr(torch, dtype),
                               initial_noise=init)
    assert ours.dtype == getattr(torch, dtype) and ours.shape == (2, 16, 16, 3)
    ours, theirs = ours.float().numpy(), np.asarray(theirs.astype(jnp.float32))
    assert np.isfinite(ours).all()
    assert psnr(ours, theirs) >= FLOOR_DB[dtype]


def test_checkpoints_leave_out_the_text_encoder(tower, tmp_path):
    jmodel, tmodel = _text_pair(tower, "float32")
    keys = set(tmodel.state_dict())
    assert keys == set(jmodel.state_dict())
    assert all(k.startswith("denoiser.") for k in keys)
    tmodel.save_checkpoint(str(tmp_path / "port.safetensors"))
    jmodel.save_checkpoint(str(tmp_path / "jax.safetensors"))
    config = tmodel.config
    again = JiTModel.from_pretrained(config, str(tmp_path / "jax.safetensors"), device="cpu")
    for key, value in tmodel.state_dict().items():
        torch.testing.assert_close(again.state_dict()[key], value, rtol=0, atol=0)
    jmodel._load_checkpoint(str(tmp_path / "port.safetensors"))  # strict in JAX
