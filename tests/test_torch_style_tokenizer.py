"""The port's style tokenizer (the text encoder's ``resize_token_embeddings``
and style rows, ``adapters/style_tokenizer.py``,
``models/sdxl/adapter/style_tokenizer.py``, ``workloads/sdxl_style_tokenizer.py``
and the entry point) against the JAX package's, on the CPU: the tiny CLIPs
and UNet of ``tests/test_torch_ip_adapter.py`` with its tiny CLIP vision
tower, the word-hash tokenizer with ``<|style|>`` added (id 49408), fp32
under ``attention_dtype(None)`` on both sides.

Kept as the JAX package has them (ROADMAP Queue 3): the style rows go in
flat scan order over the batch and its chunks, so encoder 2, which sees one
placeholder a caption, gives caption 1's placeholder sample 0's row 1; and
CLIP's legacy ``argmax(input_ids)`` pooling picks the style token (49408 >
eos 49407) in encoder 2.

Tolerances: the grown tables exactly; a text encoder's outputs within 1e-5
of the largest element; the training step's loss within 1e-5 relative and
each projector gradient within 1e-4 of its largest element; adapter files
exactly.
"""

import numpy as np
import pytest
import torch
from flax import nnx

import jax.numpy as jnp
import vision_pt_tpu.workloads.sdxl_style_tokenizer as jworkload
from tests.test_torch_ip_adapter import (
    TINY_UNET,
    TREES,
    assert_step_matches,
    jax_step,
    jax_workload,
    make_batch,
    np_flat,
    numpy_sd,
    port_step,
    port_workload,
)
from tests.test_torch_sdxl_rope import logged, write_config
from tests.test_torch_sdxl_training import TINY_MODEL, make_draws
from tests.test_torch_vision_towers import CLIP_TINY, hf_clip_state, write_clip_dir
from vision_pt_tpu.adapters import style_tokenizer as jstyle
from vision_pt_tpu.models.sdxl import text_encoder as jtext
from vision_pt_tpu.models.sdxl.adapter import style_tokenizer as jsdxl_style
from vision_pt_tpu.ops.attention import attention_dtype as jattention_dtype
from vision_pt_tpu_torch.adapters import style_tokenizer
from vision_pt_tpu_torch.models.sdxl import WordHashTokenizer, text_encoder
from vision_pt_tpu_torch.models.sdxl.adapter import style_tokenizer as sdxl_style
from vision_pt_tpu_torch.models.sdxl.convert import from_jax_state
from vision_pt_tpu_torch.ops import attention as tattn
from vision_pt_tpu_torch.workloads import sdxl_style_tokenizer as workload_module
from tests.test_torch_sdxl_distributed import one_torch_thread  # noqa: F401,E402

STYLE = 49408
TE1 = TINY_MODEL["text_encoder_1_config"]
TE2 = TINY_MODEL["text_encoder_2_config"]


def clip_pair(fields, projection):
    jmodel = jtext.CLIPTextModel(jtext.CLIPTextConfig(**fields), with_projection=projection,
                                 rngs=nnx.Rngs(0))
    model = text_encoder.CLIPTextModel(text_encoder.CLIPTextConfig(**fields),
                                       with_projection=projection)
    model.load_state_dict(from_jax_state(np_flat(jmodel)), strict=True)
    return jmodel, model


def test_resize_token_embeddings_matches_jax():
    jmodel, model = clip_pair(TE1, False)
    jmodel.resize_token_embeddings(49410)
    model.resize_token_embeddings(49410)
    table = model.text_model.embeddings.token_embedding.weight
    want = np.asarray(jmodel.text_model.embeddings.token_embedding.embedding.value)
    assert table.shape == (49410, 16) and model.config.vocab_size == 49410
    np.testing.assert_allclose(table.detach().numpy(), want, rtol=0, atol=1e-7)
    np.testing.assert_array_equal(table[-1].detach().numpy(), table[-2].detach().numpy())
    # the shared default config is left alone; a smaller size is a no-op
    assert text_encoder.TEXT_ENCODER_1_CONFIG.vocab_size == 49408
    model.resize_token_embeddings(10)
    assert model.text_model.embeddings.token_embedding.weight is table


def style_ids():
    """2 samples x 2 chunks of 77: the placeholder twice in sample 0's
    first chunk, once in its second, once in sample 1's second chunk."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 49406, size=(4, 77))
    ids[:, 0], ids[:, -8:] = 49406, 49407
    ids[0, 3] = ids[0, 4] = ids[1, 10] = ids[3, 5] = STYLE
    return ids


@pytest.mark.parametrize("projection", [False, True])
def test_style_rows_replace_the_placeholder_in_flat_order(projection):
    jmodel, model = clip_pair(TE2 if projection else TE1, projection)
    for m in (jmodel, model):
        m.resize_token_embeddings(STYLE + 1)
    ids = style_ids()
    hidden = model.config.hidden_size
    styles = np.random.default_rng(1).normal(size=(2, 4, hidden)).astype(np.float32)
    with jattention_dtype(None):
        want = jmodel(jnp.asarray(ids), style_embeddings=jnp.asarray(styles),
                      style_token_id=STYLE)
    with torch.no_grad(), tattn.attention_dtype(None):
        got = model(torch.from_numpy(ids), style_embeddings=torch.from_numpy(styles),
                    style_token_id=STYLE)
        embedded = model._embed_with_style(torch.from_numpy(ids), torch.from_numpy(styles),
                                           STYLE)
    for name in ("last_hidden_state", "penultimate_hidden_state", "pooler_output",
                 "text_embeds"):
        ours, theirs = getattr(got, name), getattr(want, name)
        if theirs is None:
            assert ours is None and not projection
            continue
        theirs = np.asarray(theirs)
        np.testing.assert_allclose(ours.numpy(), theirs, rtol=0,
                                   atol=1e-5 * np.abs(theirs).max(), err_msg=name)
    # flat order: the 3rd occurrence (sample 0's second chunk) takes row 2 of
    # sample 0, the 4th (sample 1) takes sample 0's row 3, not sample 1's row 0
    position = model.text_model.embeddings.position_embedding.weight
    flat = styles.reshape(-1, hidden)
    for (row, col), k in (((0, 3), 0), ((0, 4), 1), ((1, 10), 2), ((3, 5), 3)):
        np.testing.assert_allclose(embedded[row, col].numpy(),
                                   flat[k] + position[col].detach().numpy(), atol=1e-6)
    # pooling takes argmax(ids): the placeholder's position where it stands
    np.testing.assert_array_equal(got.pooler_output[0].numpy(), got.last_hidden_state[0, 3])
    np.testing.assert_array_equal(got.pooler_output[2].numpy(), got.last_hidden_state[2, -8])


def encoder_pair():
    """TextEncoderWithStyle in both packages, the same tiny CLIPs, the
    placeholder added to fresh word-hash tokenizers."""
    j1, t1 = clip_pair(TE1, False)
    j2, t2 = clip_pair(TE2, True)
    theirs = jsdxl_style.TextEncoderWithStyle(j1, WordHashTokenizer(), j2, WordHashTokenizer())
    ours = sdxl_style.TextEncoderWithStyle(t1, WordHashTokenizer(), t2, WordHashTokenizer())
    for te in (theirs, ours):
        te.append_style_token_id("<|style|>", 4)
    assert ours.style_token_id_1 == ours.style_token_id_2 == theirs.style_token_id_1 == STYLE
    return theirs, ours


def test_tokenizer_splits_the_added_token_out():
    tokenizer = WordHashTokenizer()
    plain = tokenizer(["a cat"], max_length=8)["input_ids"]
    assert tokenizer.add_tokens("<|style|>", special_tokens=True) == 1
    assert tokenizer.add_tokens(["<|style|>"]) == 0 and len(tokenizer) == STYLE + 1
    ids = tokenizer(["a<|style|><|style|> cat"], max_length=8)["input_ids"][0]
    assert list(ids[1:5]) == [plain[0][1], STYLE, STYLE, plain[0][2]]
    assert tokenizer.convert_tokens_to_ids("<|style|>") == STYLE


def test_encode_prompts_matches_jax():
    theirs, ours = encoder_pair()
    rng = np.random.default_rng(2)
    s1, s2 = (rng.normal(size=(2, 4, d)).astype(np.float32) for d in (16, 24))
    prompts = ["a <|style|> photo of a fox " * 10, "portrait of a cat <|style|>"]
    kw = dict(negative_prompts="blurry", use_negative_prompts=True, max_token_length=150)
    with jattention_dtype(None):
        want = theirs.encode_prompts(prompts, style_tokens_1=jnp.asarray(s1),
                                     style_tokens_2=jnp.asarray(s2), **kw)
    with torch.no_grad(), tattn.attention_dtype(None):
        got = ours.encode_prompts(prompts, style_tokens_1=torch.from_numpy(s1),
                                  style_tokens_2=torch.from_numpy(s2), **kw)
    assert ours.preprocess_style_token("x <|style|>") == "x " + "<|style|>" * 4
    for part in ("text_encoder_1", "text_encoder_2"):
        for name, value in getattr(want, part)._asdict().items():
            value = np.asarray(value)
            np.testing.assert_allclose(getattr(getattr(got, part), name).numpy(), value,
                                       rtol=0, atol=1e-5 * max(np.abs(value).max(), 1),
                                       err_msg=f"{part}.{name}")


def manager_pair(seed=0):
    jmanager = jstyle.StyleTokenizerManager(jstyle.StyleTokenizerConfig(
        image_encoder={"feature_dim": 32}))
    manager = style_tokenizer.StyleTokenizerManager(style_tokenizer.StyleTokenizerConfig(
        image_encoder={"feature_dim": 32}))
    for width in (16, 24):
        jproj = jmanager.get_projector(width, rngs=nnx.Rngs(seed + width))
        manager.get_projector(width).load_state_dict(from_jax_state(np_flat(jproj)),
                                                     strict=True)
    return jmanager, manager


def test_projector_state_round_trips_both_ways():
    jmanager, manager = manager_pair()
    theirs = numpy_sd(jmanager.get_state_dict())
    assert sorted(theirs) == sorted(numpy_sd(manager.get_state_dict()))
    assert {k.split(".", 1)[0] for k in theirs} == {"projector_1", "projector_2"}
    fresh = manager_pair(seed=3)[1]
    fresh.load_adapter_state(theirs)
    for k, v in numpy_sd(fresh.get_state_dict()).items():
        np.testing.assert_array_equal(v, theirs[k], err_msg=k)
    for p in manager.projectors:
        with torch.no_grad():
            for param in p.parameters():
                param.mul_(1.5)
    written = numpy_sd(manager.get_state_dict())
    fresh_j = manager_pair(seed=4)[0]
    fresh_j.load_adapter_state(written)
    for k, v in numpy_sd(fresh_j.get_state_dict()).items():
        np.testing.assert_array_equal(v, written[k], err_msg=k)


# ------------------------------------------------------------------ the step


@pytest.fixture(scope="module")
def clip_dir(tmp_path_factory):
    return write_clip_dir(tmp_path_factory.mktemp("tower") / "clip",
                          hf_clip_state("quick_gelu", seed=9), "quick_gelu")


def style_model_config(weights_path):
    return {**TINY_MODEL, "denoiser": TINY_UNET, "max_token_length": 75,
            "adapter": {"image_encoder": {"feature_dim": CLIP_TINY["hidden_size"],
                                          "weights_path": weights_path},
                        "image_size": CLIP_TINY["image_size"]}}


STYLE_CAPTIONS = ["a <|style|> photo of a fox", "<|style|>, portrait of a cat"]


def test_training_step_matches_jax(clip_dir, monkeypatch):
    config = style_model_config(clip_dir)
    jwl = jax_workload(jworkload.SDXLStyleTokenizerTraining, config)
    jwl.model.setup_style_token()  # the JAX model builds without tokenizers
    batch = {**make_batch(reference=True), "caption": STYLE_CAPTIONS}
    jloss, jgrads, jarrays = jax_step(jwl, batch, make_draws(),
                                      [(jworkload, "uniform_randint")], monkeypatch,
                                      jwl.model.vision_encoder)
    wl = port_workload(workload_module.SDXLStyleTokenizerTraining, config, jwl.model,
                       TREES + ("projector_1", "projector_2"))
    loss, grads, arrays = port_step(wl, batch)
    for name in ("ids1", "ids2", "drop_image"):
        np.testing.assert_array_equal(arrays[name].numpy(), np.asarray(jarrays[name]))
    assert (arrays["ids1"] == STYLE).sum() == 4 * 2 and (arrays["ids2"] == STYLE).sum() == 2
    np.testing.assert_allclose(arrays["reference_pixels"].numpy(),
                               np.asarray(jarrays["reference_pixels"]), rtol=0, atol=1e-5)
    assert_step_matches((loss, grads), (jloss, jgrads))
    assert sorted(grads) == [f"projector_{i}.inner.proj.{p}" for i in (1, 2)
                             for p in ("bias", "weight")]


def test_entry_point_trains_saves_and_previews(tmp_path, clip_dir):
    from safetensors.numpy import load_file

    from vision_pt_tpu_torch.train.sdxl.style_tokenizer import main

    config = write_config(tmp_path, style_model_config(clip_dir), peft=False,
                          reference_folder=tmp_path / "references",
                          caption_processors=[{"type": "prefix", "prefix": "<|style|>, "}])
    with pytest.raises(SystemExit) as exit_info:
        main(["--config", str(config), "--device", "cpu"])
    assert exit_info.value.code == 0
    rows = [r for r in logged(tmp_path) if "train/loss" in r]
    assert rows and all(np.isfinite(r["train/loss"]) for r in rows)
    saved = sorted((tmp_path / "out").iterdir())
    assert len(saved) == 1
    assert sorted(load_file(str(saved[0]))) == [f"projector_{i}.inner.proj.{p}"
                                                for i in (1, 2) for p in ("bias", "weight")]
    assert len(list((tmp_path / "preview").iterdir())) == 1
