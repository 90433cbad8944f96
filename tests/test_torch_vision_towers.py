"""The port's vision towers (``models/clip_vision.py``, ``models/timm_vit.py``)
and ``AutoImageEncoder`` against the JAX package's, on the CPU, at tiny
sizes, fp32 under ``attention_dtype(None)`` on both sides.

Both packages take the same numpy weights through their converters: an HF
``CLIPVisionModel`` state dict (``gelu`` and ``quick_gelu``) and a timm
state dict (class-token and mean pooling, with and without the class token,
with LayerScale). Every output within 1e-5 of the JAX package's, relative to
its largest element. ``AutoImageEncoder`` reads the same files on both sides
(the key-layout sniff), and raises without weights, as the JAX package does.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from safetensors.numpy import save_file

from tests.models.test_timm_vit import DEPTH, DIM, GRID, HEADS, IMG, _timm_state_dict
from vision_pt_tpu.adapters.ip_adapter import ImageEncoderConfig as JImageEncoderConfig
from vision_pt_tpu.models import clip_vision as jclip
from vision_pt_tpu.models import timm_vit as jtimm
from vision_pt_tpu.models.auto import AutoImageEncoder as JAutoImageEncoder
from vision_pt_tpu.ops.attention import attention_dtype as jattention_dtype
from vision_pt_tpu.utils.state_dict import load_flat_state
from vision_pt_tpu_torch.adapters.ip_adapter import ImageEncoderConfig
from vision_pt_tpu_torch.models import clip_vision, timm_vit
from vision_pt_tpu_torch.models.auto import AutoImageEncoder
from vision_pt_tpu_torch.ops.attention import attention_dtype

TOL = 1e-5
CLIP_TINY = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                 num_attention_heads=2, image_size=28, patch_size=14, projection_dim=16)


def close(ours, theirs, tol=TOL):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    theirs = np.asarray(theirs)
    assert ours.shape == theirs.shape
    err = np.abs(ours - theirs).max()
    assert err <= tol * np.abs(theirs).max(), f"max abs err {err:.3g}"


def hf_clip_state(hidden_act: str, seed: int = 0) -> dict[str, np.ndarray]:
    """A random HF ``CLIPVisionModelWithProjection`` state dict, as numpy."""
    from transformers import CLIPVisionConfig as HFConfig
    from transformers import CLIPVisionModelWithProjection

    torch.manual_seed(seed)
    model = CLIPVisionModelWithProjection(HFConfig(**CLIP_TINY, hidden_act=hidden_act))
    sd = {k: v.detach().numpy().copy() for k, v in model.state_dict().items()
          if "position_ids" not in k}
    rng = np.random.default_rng(seed)
    for k in sd:  # nonzero biases and non-unit norms
        if k.endswith("bias") or "norm" in k:
            sd[k] = sd[k] + rng.normal(size=sd[k].shape).astype(np.float32) * 0.1
    return sd


def pixels(side: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((2, side, side, 3)).astype(np.float32)


@pytest.mark.parametrize("hidden_act", ["gelu", "quick_gelu"])
def test_clip_vision_matches_jax(hidden_act):
    sd = hf_clip_state(hidden_act)
    config = dict(CLIP_TINY, hidden_act=hidden_act)
    theirs_model = jclip.CLIPVisionModel(jclip.CLIPVisionConfig(**config),
                                         with_projection=True, rngs=nnx.Rngs(0))
    load_flat_state(theirs_model, jclip.convert_hf_clip_vision(sd), strict=False)
    ours_model = clip_vision.CLIPVisionModel(clip_vision.CLIPVisionConfig(**config),
                                             with_projection=True)
    ours_model.load_state_dict(
        {k: torch.from_numpy(v) for k, v in clip_vision.convert_hf_clip_vision(sd).items()},
        strict=True)
    x = pixels(28)
    with jattention_dtype(None):
        theirs = theirs_model(jnp.asarray(x))
    with attention_dtype(None), torch.no_grad():
        ours = ours_model(torch.from_numpy(x))
    close(ours.pooler_output, theirs.pooler_output)
    close(ours.last_hidden_state, theirs.last_hidden_state)
    close(ours.image_embeds, theirs.image_embeds)
    assert len(ours.hidden_states) == len(theirs.hidden_states) == 3
    for a, b in zip(ours.hidden_states, theirs.hidden_states):
        close(a, b)


def test_clip_vision_matches_hf():
    """The HF model itself on the same weights and pixels (NCHW there)."""
    from transformers import CLIPVisionConfig as HFConfig
    from transformers import CLIPVisionModel as HFModel

    sd = hf_clip_state("quick_gelu", seed=3)
    hf = HFModel(HFConfig(**CLIP_TINY, hidden_act="quick_gelu")).eval()
    hf.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()
                        if k.startswith("vision_model.")}, strict=False)
    ours_model = clip_vision.CLIPVisionModel(
        clip_vision.CLIPVisionConfig(**CLIP_TINY, hidden_act="quick_gelu"))
    ours_model.load_state_dict(
        {k: torch.from_numpy(v) for k, v in clip_vision.convert_hf_clip_vision(sd).items()
         if not k.startswith("visual_projection")}, strict=True)
    x = torch.from_numpy(pixels(28))
    with attention_dtype(None), torch.no_grad():
        ours = ours_model(x)
        theirs = hf(pixel_values=x.permute(0, 3, 1, 2))
    close(ours.pooler_output, theirs.pooler_output.numpy(), tol=1e-5)
    close(ours.last_hidden_state, theirs.last_hidden_state.numpy(), tol=1e-5)


TIMM_CASES = {  # name -> (class token, global pool, layer scale)
    "token": (True, "token", False),
    "avg_with_class_token": (True, "avg", False),
    "avg_without_class_token": (False, "avg", False),
    "layer_scale": (True, "token", True),
}


@pytest.mark.parametrize("case", sorted(TIMM_CASES))
def test_timm_vit_matches_jax(case):
    class_token, pool, layer_scale = TIMM_CASES[case]
    sd = _timm_state_dict(np.random.default_rng(4), layer_scale=layer_scale)
    if not class_token:
        del sd["cls_token"]
        sd["pos_embed"] = sd["pos_embed"][:, 1:]
    config = dict(embed_dim=DIM, depth=DEPTH, num_heads=HEADS, patch_size=8, img_size=IMG,
                  class_token=class_token, global_pool=pool, use_layer_scale=layer_scale)
    assert jtimm.infer_timm_vit_config(sd, HEADS).class_token == class_token
    assert timm_vit.infer_timm_vit_config(sd, HEADS).model_dump() == \
        jtimm.infer_timm_vit_config(sd, HEADS).model_dump()
    theirs_model = jtimm.TimmViT(jtimm.TimmViTConfig(**config), rngs=nnx.Rngs(0))
    load_flat_state(theirs_model, jtimm.convert_timm_vit(sd), strict=False)
    ours_model = timm_vit.TimmViT(timm_vit.TimmViTConfig(**config))
    missing, _ = ours_model.load_state_dict(
        {k: torch.from_numpy(v) for k, v in timm_vit.convert_timm_vit(sd).items()},
        strict=False)
    assert missing == []
    x = pixels(IMG, seed=5)
    with jattention_dtype(None):
        theirs = theirs_model(jnp.asarray(x))
    with attention_dtype(None), torch.no_grad():
        ours = ours_model(torch.from_numpy(x))
    close(ours.pooler_output, theirs.pooler_output)
    close(ours.last_hidden_state, theirs.last_hidden_state)
    for a, b in zip(ours.hidden_states, theirs.hidden_states, strict=True):
        close(a, b)


def write_clip_dir(folder, sd, hidden_act):
    folder.mkdir()
    save_file(sd, str(folder / "model.safetensors"))
    (folder / "config.json").write_text(json.dumps(
        {"vision_config": dict(CLIP_TINY, hidden_act=hidden_act)}))
    return str(folder)


@pytest.mark.parametrize("layout,feature_type", [
    ("clip", "pooler_output"), ("clip", "hidden_state"),
    ("timm", "pooler_output"), ("timm", "hidden_state")])
def test_auto_image_encoder_matches_jax(tmp_path, layout, feature_type):
    """The layout sniff picks the same tower on both sides from the same
    file, and both give the same features."""
    if layout == "clip":
        path, side = write_clip_dir(tmp_path / "clip", hf_clip_state("quick_gelu"),
                                    "quick_gelu"), 28
        extra = {}
    else:
        path, side = str(tmp_path / "timm.safetensors"), IMG
        save_file(_timm_state_dict(np.random.default_rng(6)), path)
        extra = {"num_heads": HEADS}
    fields = dict(weights_path=path, feature_type=feature_type, hidden_state_index=-2,
                  **extra)
    assert AutoImageEncoder._sniff_layout(path) == JAutoImageEncoder._sniff_layout(path) \
        == layout
    ours_encoder = AutoImageEncoder(ImageEncoderConfig(**fields), device="cpu")
    theirs_encoder = JAutoImageEncoder(JImageEncoderConfig(**fields))
    x = pixels(side, seed=7)
    with jattention_dtype(None):
        theirs = theirs_encoder(jnp.asarray(x))
    with attention_dtype(None), torch.no_grad():
        ours = ours_encoder(torch.from_numpy(x))
    close(ours, theirs)
    tower = ours_encoder.model
    assert not any(p.requires_grad for p in tower.parameters())
    if layout == "timm":
        assert tower.config.num_heads == HEADS
        assert tower.config.img_size == GRID * 8


def test_clip_config_json_keys_win_over_the_defaults(tmp_path):
    """ViT-L/14's quick_gelu and sizes come from config.json; a key it lacks
    takes the JAX package's default (ViT-H/14's gelu)."""
    path = write_clip_dir(tmp_path / "clip", hf_clip_state("quick_gelu"), "quick_gelu")
    model = clip_vision.CLIPVisionModel.from_local(path)
    assert model.config.hidden_act == "quick_gelu"
    assert model.config.hidden_size == CLIP_TINY["hidden_size"]
    assert clip_vision.CLIPVisionConfig().hidden_act == jclip.CLIPVisionConfig().hidden_act


def test_auto_image_encoder_raises_without_weights(tmp_path):
    for encoder_cls, config_cls in ((AutoImageEncoder, ImageEncoderConfig),
                                    (JAutoImageEncoder, JImageEncoderConfig)):
        kw = {"device": "cpu"} if encoder_cls is AutoImageEncoder else {}
        with pytest.raises(RuntimeError, match="weights_path"):
            encoder_cls(config_cls(), **kw)(np.zeros((1, 4, 4, 3), np.float32))
        missing = config_cls(weights_path=str(tmp_path / "missing"))
        with pytest.raises(FileNotFoundError):
            encoder_cls(missing, **kw)(np.zeros((1, 4, 4, 3), np.float32))
    injected = AutoImageEncoder(ImageEncoderConfig(), encode_fn=lambda x: x.mean((1, 2)),
                                device="cpu")
    assert injected(torch.ones(2, 4, 4, 3)).shape == (2, 3)


def test_auto_image_encoder_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AutoImageEncoder(ImageEncoderConfig())
