"""The port's rewards (``reward/{utils,pickscore,functional}.py``) against the
JAX package's, on the CPU: a tiny CLIP dual tower written from numpy in the
HF layout (config.json + model.safetensors: text 32 wide, 2 layers, the real
vocabulary size so the word-hash ids fit; vision 32 wide, 2 layers, 28^2,
patch 14; projection 16), fp32 under ``attention_dtype(None)`` on both sides.

Tolerances: the converted text state exactly; the preprocessing within 2e-6
of JAX's (1024 -> 224 and 64 -> 28 bicubic, antialiased); PickScore scores
within 1e-5 of their largest magnitude and their gradients to the pixels
within 1e-4 of the largest element.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from vision_pt_tpu.ops.attention import attention_dtype as jattention_dtype
from vision_pt_tpu.reward import pickscore as jpickscore
from vision_pt_tpu.reward import load_reward_models as jload_reward_models
from vision_pt_tpu_torch.models.sdxl import WordHashTokenizer
from vision_pt_tpu_torch.models.sdxl.convert import from_jax_state
from vision_pt_tpu_torch.ops import attention as tattn
from vision_pt_tpu_torch.reward import (
    BrightnessRewardConfig,
    CallableRewardModel,
    PickScoreConfig,
    PickScoreRewardModel,
    load_reward_models,
    pickscore,
)

TEXT = dict(vocab_size=49408, hidden_size=32, intermediate_size=64, num_hidden_layers=2,
            num_attention_heads=2, max_position_embeddings=77, hidden_act="gelu")
VISION = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
              num_attention_heads=2, image_size=28, patch_size=14, hidden_act="gelu")
PROJECTION = 16
PROMPTS = ["a red fox in the snow", "portrait of a cat, detailed fur"]


def hf_clip_state(seed: int) -> dict[str, np.ndarray]:
    """A random CLIP dual tower in HF's key layout (transformers' CLIPModel),
    values drawn from numpy."""
    from transformers import CLIPConfig, CLIPModel

    config = CLIPConfig(text_config=TEXT, vision_config=VISION, projection_dim=PROJECTION)
    keys = {k: tuple(v.shape) for k, v in CLIPModel(config).state_dict().items()
            if not k.endswith("position_ids")}
    rng = np.random.default_rng(seed)
    sd = {}
    for k, shape in keys.items():
        if k.endswith(("layer_norm1.weight", "layer_norm2.weight", "layernorm.weight",
                       "layrnorm.weight", "final_layer_norm.weight")):
            sd[k] = (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        else:
            sd[k] = (rng.normal(size=shape) * (0.3 if len(shape) < 2 else
                                                shape[-1] ** -0.5)).astype(np.float32)
    sd["logit_scale"] = np.asarray(2.3, np.float32)
    return sd


def write_pickscore_dir(path, seed=5):
    path.mkdir(parents=True, exist_ok=True)
    save_file(hf_clip_state(seed), str(path / "model.safetensors"))
    (path / "config.json").write_text(json.dumps({
        "model_type": "clip", "projection_dim": PROJECTION,
        "text_config": TEXT, "vision_config": VISION}))
    return str(path)


@pytest.fixture(scope="module")
def pickscore_dir(tmp_path_factory):
    return write_pickscore_dir(tmp_path_factory.mktemp("pickscore") / "clip")


def test_convert_hf_clip_text_matches_jax():
    sd = {f"clip.{k}" if i % 2 else k: v for i, (k, v) in enumerate(hf_clip_state(1).items())}
    ours = pickscore.convert_hf_clip_text(sd)
    theirs = from_jax_state(jpickscore.convert_hf_clip_text(sd))
    assert ours.keys() == theirs.keys()
    assert not any(k.startswith("vision_model") or ".encoder." in k for k in ours)
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k].numpy(), err_msg=k)


@pytest.mark.parametrize("side,size", [(1024, 224), (64, 28)])
def test_clip_preprocess_matches_jax(side, size):
    rng = np.random.default_rng(2)
    images = rng.uniform(-1.1, 1.1, size=(2, side, side, 3)).astype(np.float32)
    want = np.asarray(jpickscore.clip_preprocess_images(jnp.asarray(images), size))
    got = pickscore.clip_preprocess_images(torch.from_numpy(images), size).numpy()
    assert got.shape == (2, size, size, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def reward_pair(pickscore_dir):
    theirs = jpickscore.PickScoreRewardModel(weights_path=pickscore_dir,
                                             tokenizer=WordHashTokenizer())
    ours = PickScoreRewardModel(weights_path=pickscore_dir, tokenizer="word-hash",
                                device="cpu")
    return theirs, ours


def test_pickscore_scores_and_pixel_gradients_match_jax(pickscore_dir):
    theirs, ours = reward_pair(pickscore_dir)
    images = np.random.default_rng(3).uniform(-1, 1, size=(2, 64, 64, 3)).astype(np.float32)
    with jattention_dtype(None):
        want = np.asarray(theirs(jnp.asarray(images), PROMPTS))
        want_grad = np.asarray(jax.grad(lambda x: jnp.sum(theirs(x, PROMPTS) *
                                                          jnp.asarray([1.0, -2.0])))(
            jnp.asarray(images)))
    pixels = torch.from_numpy(images).requires_grad_(True)
    with tattn.attention_dtype(None):
        got = ours(pixels, PROMPTS)
        (got * torch.tensor([1.0, -2.0])).sum().backward()
    assert got.shape == (2,)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert np.abs(want_grad).max() > 0
    np.testing.assert_allclose(pixels.grad.numpy(), want_grad, rtol=0,
                               atol=1e-4 * np.abs(want_grad).max())
    # logit scale and probabilities as JAX has them
    assert float(ours.model.logit_scale) == pytest.approx(2.3)
    ids = ours.tokenize(PROMPTS)
    with torch.no_grad(), tattn.attention_dtype(None):
        probs = ours.model.probs(torch.from_numpy(images), ids).numpy()
    with jattention_dtype(None):
        jprobs = np.asarray(theirs._model.probs(jnp.asarray(images), jnp.asarray(ids.numpy())))
    np.testing.assert_allclose(probs, jprobs, rtol=0, atol=1e-5)


def test_the_towers_are_frozen_and_outside_the_trainable_tree(pickscore_dir, tmp_path):
    from tests.test_torch_draft_plus import DRAFT_MODEL, port_lora_draft

    _, ours = reward_pair(pickscore_dir)
    assert all(not p.requires_grad for p in ours.model.parameters())
    workload = port_lora_draft({**DRAFT_MODEL, "reward_models": [
        {"type": "pickscore", "weights_path": pickscore_dir, "tokenizer": "word-hash"}]})
    towers = {id(p) for rm in workload.reward_models for p in rm.model.parameters()}
    assert towers and not towers & {id(p) for p in workload.trainable().parameters()}
    # gradients still reach the pixels through them
    images = torch.zeros(1, 28, 28, 3, requires_grad=True)
    workload.reward_models[0](images, ["a fox"]).sum().backward()
    assert images.grad.abs().max() > 0
    assert all(p.grad is None for rm in workload.reward_models for p in rm.model.parameters())


def test_load_reward_models(pickscore_dir):
    configs = [{"type": "brightness"},
               {"type": "pickscore", "weights_path": pickscore_dir, "tokenizer": "word-hash"},
               BrightnessRewardConfig()]
    models = load_reward_models(configs, device="cpu")
    jmodels = jload_reward_models([{"type": "brightness"}])
    assert isinstance(models[0], CallableRewardModel) and isinstance(models[2],
                                                                     CallableRewardModel)
    assert isinstance(models[1], PickScoreRewardModel)
    assert isinstance(PickScoreConfig(weights_path=pickscore_dir).load_model("cpu"),
                      PickScoreRewardModel)
    images = np.random.default_rng(4).uniform(-1, 1, size=(2, 28, 28, 3)).astype(np.float32)
    np.testing.assert_allclose(models[0](torch.from_numpy(images), PROMPTS).numpy(),
                               np.asarray(jmodels[0](jnp.asarray(images), PROMPTS)),
                               rtol=0, atol=1e-6)
    with torch.no_grad():
        direct = models[1].model.score(torch.from_numpy(images), models[1].tokenize(PROMPTS))
        np.testing.assert_array_equal(models[1](torch.from_numpy(images), PROMPTS).numpy(),
                                      direct.numpy())
    # without weights it refuses, as the JAX package does
    with pytest.raises(RuntimeError, match="downloads nothing"):
        PickScoreRewardModel()(torch.from_numpy(images), PROMPTS)

def test_the_tokenizer_defaults_to_the_weights_directory(pickscore_dir, monkeypatch):
    import transformers

    asked = []
    monkeypatch.setattr(transformers.AutoTokenizer, "from_pretrained",
                        lambda spec, **kw: asked.append((spec, kw)) or WordHashTokenizer())
    model = PickScoreRewardModel(weights_path=pickscore_dir, device="cpu")
    assert isinstance(model.tokenizer, WordHashTokenizer)
    assert asked == [(pickscore_dir, {"local_files_only": True})]
    assert isinstance(PickScoreRewardModel(tokenizer="word-hash").tokenizer, WordHashTokenizer)
