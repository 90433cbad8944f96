"""The port's decoder LM (``models/lm``) against the JAX package's and
against HF transformers, at tiny GLM and Qwen3 configs (2 layers), fp32,
with the same weights (``from_jax_state``) and numpy-made token ids.

Tolerances, relative to the largest value compared:
- the rope tables: exactly (the same fp64 numpy, rounded once);
- the last and penultimate hidden states, 1e-5: the same fp32 arithmetic
  with sums in another order (measured ~1e-7);
- against HF transformers (the HF-named keys through ``from_jax_state``),
  1e-5 as well.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from vision_pt_tpu.models.lm.model import DecoderLM as JDecoderLM
from vision_pt_tpu.models.lm.model import DecoderLMConfig as JDecoderLMConfig
from vision_pt_tpu.utils.state_dict import flatten_state
from vision_pt_tpu_torch.models.lm import DecoderLM, DecoderLMConfig, from_jax_state

CONFIGS = {
    # the JAX tests' tiny GLM (tests/models/test_cogview4.py)
    "glm": dict(vocab_size=100, hidden_size=32, intermediate_size=64,
                num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                head_dim=8, partial_rotary_factor=0.5, attention_bias=True,
                rms_norm_eps=1e-6, arch="glm"),
    "qwen3": dict(vocab_size=100, hidden_size=32, intermediate_size=64,
                  num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=1,
                  head_dim=16, rms_norm_eps=1e-6, arch="qwen3"),
}
TOL = 1e-5


def _close(got, want, rel=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def _pair(arch):
    jlm = JDecoderLM(JDecoderLMConfig(**CONFIGS[arch]), rngs=nnx.Rngs(0))
    lm = DecoderLM(DecoderLMConfig(**CONFIGS[arch]))
    state = {k: np.asarray(v) for k, v in flatten_state(jlm).items()}
    lm.load_state_dict(from_jax_state(state), strict=True)
    return jlm, lm.eval()


def _ids(seed=0, shape=(2, 11)):
    return np.random.default_rng(seed).integers(0, 100, shape)


@pytest.mark.parametrize("arch", ["glm", "qwen3"])
def test_rope_tables_match(arch):
    jlm, lm = _pair(arch)
    for got, want in zip(lm.rope_tables(13), jlm._rope_tables(13)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ["glm", "qwen3"])
def test_hidden_states_match_the_jax_package(arch):
    jlm, lm = _pair(arch)
    ids = _ids()
    want = jax.jit(lambda x: jlm(x))(jnp.asarray(ids))
    with torch.no_grad():
        got = lm(torch.from_numpy(ids))
    _close(got.last_hidden_state, want.last_hidden_state)
    _close(got.penultimate_hidden_state, want.penultimate_hidden_state)
    # the penultimate state is the one entering the last layer
    with torch.no_grad():
        x = lm.embed_tokens(torch.from_numpy(ids))
        cos, sin = (torch.from_numpy(t) for t in lm.rope_tables(ids.shape[1]))
        causal = torch.full((11, 11), torch.finfo(torch.float32).min).triu(1)
        x = lm.layers[0](x, cos, sin, causal)
    np.testing.assert_array_equal(x.numpy(), got.penultimate_hidden_state.numpy())


def _hf_model(arch):
    if arch == "glm":
        from transformers import GlmConfig, GlmModel

        c = CONFIGS["glm"]
        return GlmModel(GlmConfig(
            vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
            intermediate_size=c["intermediate_size"],
            num_hidden_layers=c["num_hidden_layers"],
            num_attention_heads=c["num_attention_heads"],
            num_key_value_heads=c["num_key_value_heads"], head_dim=c["head_dim"],
            partial_rotary_factor=0.5, attention_bias=True, rms_norm_eps=1e-6,
            rope_theta=10000.0, pad_token_id=1))
    from transformers import Qwen3Config, Qwen3Model

    c = CONFIGS["qwen3"]
    return Qwen3Model(Qwen3Config(
        vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
        intermediate_size=c["intermediate_size"],
        num_hidden_layers=c["num_hidden_layers"],
        num_attention_heads=c["num_attention_heads"],
        num_key_value_heads=c["num_key_value_heads"], head_dim=c["head_dim"],
        rms_norm_eps=1e-6, rope_theta=10000.0))


@pytest.mark.parametrize("arch", ["glm", "qwen3"])
def test_hf_named_state_loads_and_matches_transformers(arch):
    pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf = _hf_model(arch).eval()
    lm = DecoderLM(DecoderLMConfig(**CONFIGS[arch])).eval()
    # with the causal-LM prefix and a head the decoder has no use for
    state = {f"model.{k}": v.numpy() for k, v in hf.state_dict().items()}
    state["lm_head.weight"] = np.zeros((100, 32), np.float32)
    lm.load_state_dict(from_jax_state(state), strict=True)
    ids = torch.from_numpy(_ids(1, (2, 9)))
    with torch.no_grad():
        want = hf(ids, output_hidden_states=True)
        got = lm(ids)
    _close(got.penultimate_hidden_state, want.hidden_states[-2])
    _close(got.last_hidden_state, want.last_hidden_state)


def test_from_jax_state_renames_and_transposes():
    jlm, _ = _pair("qwen3")
    state = {k: np.asarray(v) for k, v in flatten_state(jlm).items()}
    port = from_jax_state(state)
    kernel = state["layers.0.mlp.gate_proj.kernel"]
    np.testing.assert_array_equal(port["layers.0.mlp.gate_proj.weight"].numpy(),
                                  kernel.T)
    assert "layers.1.input_layernorm.weight" in port
    assert "layers.0.self_attn.q_norm.weight" in port
    assert "norm.weight" in port and "embed_tokens.weight" in port
    assert set(port) == set(DecoderLM(DecoderLMConfig(**CONFIGS["qwen3"])).state_dict())
