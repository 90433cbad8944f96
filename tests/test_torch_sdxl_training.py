"""The port's SDXL LoRA / QLoRA training step against the JAX package's
workload (``vision_pt_tpu/workloads/sdxl_text_to_image.py``), on the CPU, at
the tiny UNet and VAE of ``tests/training/test_sdxl_workload.py`` with two
2-layer CLIPs, fp32 under ``attention_dtype(None)``.

Both packages run one ``compute_loss`` on the same weights (carried by
``convert.from_jax_state``), the same numpy-made images and captions, and the
same draws: the port takes them in ``draws``, the JAX workload's
``uniform_randint`` and its ``jax.random.normal`` calls (the VAE sample and the
DDPM noise) are replaced by the same arrays. ``lora_up`` is nonzero, so every
adapter has a gradient. Tolerances: the loss within 1e-5 relative and every
LoRA gradient within 1e-4 relative L2 (fp32 sums in another order through
the VAE, the CLIPs and the UNet); the same with per-layer gradient
checkpointing, and with the UNet's attention and feed-forward linears NF4
(QLoRA; the NF4 gate opened, so kernel #9's plain version runs where the
product has at most 1024 rows).

The entry point then trains 2 steps on the CPU over a synthetic folder, with
schedule-free AdamW on random weights and with AdamW8bit on an
NF4-prequantized checkpoint, and writes a LoRA file with the JAX workload's
keys.
"""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import nnx
from PIL import Image
from safetensors.numpy import load_file

import vision_pt_tpu.models.sdxl.vae as jvae
import vision_pt_tpu.ops.loss.diffusion as jdiffusion
import vision_pt_tpu.workloads.sdxl_text_to_image as jworkload
from vision_pt_tpu.config import TrainConfig as JTrainConfig
from vision_pt_tpu.models.sdxl import SDXLModel as JSDXLModel
from vision_pt_tpu.models.sdxl.config import SDXLConfig as JSDXLConfig
from vision_pt_tpu.ops.attention import attention_dtype as jattention_dtype
from vision_pt_tpu.ops.quant import quantize_inplace as jquantize_inplace
from vision_pt_tpu.peft import AdapterParam
from vision_pt_tpu.peft import LoRAConfig as JLoRAConfig
from vision_pt_tpu.peft import replace_to_peft_layer as jreplace_to_peft_layer
from vision_pt_tpu.utils.state_dict import _path_to_key, flatten_state
from vision_pt_tpu_torch.config import TrainConfig
from vision_pt_tpu_torch.models.sdxl import SDXLModel, WordHashTokenizer
from vision_pt_tpu_torch.models.sdxl.convert import from_jax_state
from vision_pt_tpu_torch.ops import attention as tattn
from vision_pt_tpu_torch.ops.quant import layers as qlayers
from vision_pt_tpu_torch.ops.quant import quantize_inplace
from vision_pt_tpu_torch.peft import (
    LoRAConfig,
    LoRALinear,
    freeze_all_but_adapters,
    replace_to_peft_layer,
)
from vision_pt_tpu_torch.workloads.sdxl_text_to_image import (
    SDXLForTextToImageTraining,
    SDXLTrainable,
)
from tests.test_torch_sdxl_distributed import one_torch_thread  # noqa: F401,E402

TINY_UNET = dict(hidden_dim=32, block_out_channels=[32, 32, 64],
                 num_transformers_per_block=[1, 1, 1], num_head_channels=16,
                 context_dim=40, layers_per_block=1)
TINY_VAE = dict(block_out_channels=(8, 16, 16, 16), layers_per_block=1,
                norm_num_groups=4, latent_channels=4)
# the word-hash tokenizer's ids reach 49407, so the CLIPs keep the real
# vocabulary size
TINY_MODEL = dict(
    checkpoint_path="", dtype="float32", denoiser=TINY_UNET, vae_config=TINY_VAE,
    max_token_length=150,
    text_encoder_1_config=dict(hidden_size=16, intermediate_size=32,
                               num_hidden_layers=2, num_attention_heads=2),
    text_encoder_2_config=dict(hidden_size=24, intermediate_size=48,
                               num_hidden_layers=2, num_attention_heads=2,
                               hidden_act="gelu", projection_dim=1280),
)
PEFT = {"config": {"type": "lora", "rank": 2, "alpha": 1.0, "dtype": "float32"},
        "include_keys": ["attn1", "attn2", ".ff."],
        "exclude_keys": ["text_encoder", "vae"]}
QUANT_KEYS = ["attn1", "attn2", ".ff."]
# the same linears by their sgm checkpoint keys (a pattern also matches as a
# regex, and ".ff." would match "diffusion_model")
QUANT_STATE_KEYS = ["attn1.", "attn2.", "ff.net."]
BATCH, SIDE = 2, 64


def make_batch(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "image": rng.uniform(-1, 1, size=(BATCH, SIDE, SIDE, 3)).astype(np.float32),
        "caption": ["a red fox in the snow " * 12, "portrait of a cat"],
        "original_size": np.asarray([[80, 72], [64, 96]], np.int32),
        "target_size": np.full((BATCH, 2), SIDE, np.int32),
        "crop_coords_top_left": np.asarray([[8, 0], [0, 16]], np.int32),
    }


def make_draws(seed=1):
    rng = np.random.default_rng(seed)
    latent = (BATCH, SIDE // 8, SIDE // 8, 4)
    return {"vae_noise": rng.normal(size=latent).astype(np.float32),
            "timesteps": np.asarray([17, 903], np.int32),
            "noise": rng.normal(size=latent).astype(np.float32)}


class _JaxWithDraws:
    """The ``jax`` module with ``random.normal`` handing out given arrays."""

    def __init__(self, arrays):
        self._arrays = list(arrays)
        self.random = types.SimpleNamespace(normal=self._normal)

    def _normal(self, key, shape, dtype=jnp.float32):
        array = self._arrays.pop(0)
        assert tuple(array.shape) == tuple(shape)
        return jnp.asarray(array, dtype)

    def __getattr__(self, name):
        return getattr(jax, name)


def _flat_grads(grads) -> dict[str, np.ndarray]:
    return {_path_to_key(tuple(path)): np.asarray(getattr(v, "value", v))
            for path, v in nnx.to_flat_state(grads)}


def jax_tree(quantized: bool):
    """The JAX workload over the tiny model, LoRA on (after NF4 surgery for
    QLoRA), every ``lora_up`` drawn nonzero."""
    config = JTrainConfig(model=TINY_MODEL, dataset={}, peft=PEFT, seed=0)
    workload = jworkload.SDXLForTextToImageTraining(config)
    model = JSDXLModel.from_config(JSDXLConfig(**TINY_MODEL), rngs=nnx.Rngs(0))
    tokenizer = WordHashTokenizer()
    model.text_encoder.tokenizer_1 = model.text_encoder.tokenizer_2 = tokenizer
    dense = {name: flatten_state(getattr(model, name))
             for name in ("denoiser", "vae")}
    dense.update({name: flatten_state(getattr(model.text_encoder, name))
                  for name in ("text_encoder_1", "text_encoder_2")})
    if quantized:
        jquantize_inplace(model.denoiser, "bnb_nf4", include_keys=QUANT_KEYS)
    workload.model = model
    workload._full_trainable = jworkload.SDXLTrainable(
        model.denoiser, model.text_encoder.text_encoder_1,
        model.text_encoder.text_encoder_2, model.vae)
    jreplace_to_peft_layer(workload._full_trainable, PEFT["include_keys"],
                           PEFT["exclude_keys"],
                           JLoRAConfig(rank=2, dtype="float32"), seed=0)
    workload._set_is_peft(True)
    rng = np.random.default_rng(7)
    for path, module in _lora_modules(workload._full_trainable):
        module.lora_up.value = jnp.asarray(
            rng.normal(size=module.lora_up.value.shape).astype(np.float32) * 0.1)
    adapters = {k: np.asarray(v) for k, v in
                flatten_state(workload._full_trainable).items() if ".lora_" in k}
    return workload, dense, adapters


def _lora_modules(tree):
    from vision_pt_tpu.peft.functional import iter_named_modules
    from vision_pt_tpu.peft.lora import LoRALinear as JLoRALinear

    return [(p, m) for p, m in iter_named_modules(tree) if isinstance(m, JLoRALinear)]


def port_tree(dense, adapters, quantized: bool):
    """The port's workload over the same weights, LoRA on, the base frozen."""
    config = TrainConfig.model_validate(
        {"model": {**TINY_MODEL, "tokenizer": "word-hash"}, "dataset": {},
         "peft": PEFT, "seed": 0})
    workload = SDXLForTextToImageTraining(config, torch.device("cpu"))
    tokenizer = WordHashTokenizer()
    model = SDXLModel.from_config(workload.model_config, device="cpu",
                                  tokenizer_1=tokenizer, tokenizer_2=tokenizer)
    model.denoiser.load_state_dict(from_jax_state(dense["denoiser"]))
    model.vae.load_state_dict(from_jax_state(dense["vae"]))
    for name in ("text_encoder_1", "text_encoder_2"):
        getattr(model.text_encoder, name).load_state_dict(from_jax_state(dense[name]))
    if quantized:
        quantize_inplace(model.denoiser, "bnb_nf4", include_keys=QUANT_KEYS)
    workload.model = model
    workload._full_trainable = SDXLTrainable(
        model.denoiser, model.text_encoder.text_encoder_1,
        model.text_encoder.text_encoder_2, model.vae)
    replace_to_peft_layer(workload._full_trainable, PEFT["include_keys"],
                          PEFT["exclude_keys"], LoRAConfig(rank=2, dtype="float32"))
    missing, unexpected = workload._full_trainable.load_state_dict(
        from_jax_state(adapters), strict=False)
    assert not unexpected and not [k for k in missing if ".lora_" in k]
    freeze_all_but_adapters(workload._full_trainable)
    workload._is_peft = True
    return workload


@pytest.fixture(scope="module")
def jax_runs():
    """(dense weights, adapters, loss, LoRA gradients) of the JAX workload,
    per variant, computed once."""
    return {}


def jax_step(jax_runs, variant, monkeypatch):
    if variant not in jax_runs:
        workload, dense, adapters = jax_tree(variant == "qlora")
        draws = make_draws()
        key = jax.random.key(0)
        batch = workload.prepare_batch(make_batch(), key)
        monkeypatch.setattr(jworkload, "uniform_randint",
                            lambda key, n, lo, hi: jnp.asarray(draws["timesteps"]))

        def loss_fn(tree):
            monkeypatch.setattr(jvae, "jax", _JaxWithDraws([draws["vae_noise"]]))
            monkeypatch.setattr(jdiffusion, "jax", _JaxWithDraws([draws["noise"]]))
            return workload.compute_loss(tree, batch, key)[0]

        @nnx.jit
        def step(tree):
            return nnx.value_and_grad(loss_fn, argnums=nnx.DiffState(0, AdapterParam))(tree)

        with jattention_dtype(None):
            loss, grads = step(workload._full_trainable)
        monkeypatch.undo()
        jax_runs[variant] = (dense, adapters, float(loss), _flat_grads(grads))
    return jax_runs[variant]


def port_step(workload, checkpointing=False):
    if checkpointing:
        workload.enable_gradient_checkpointing()
    batch = workload.prepare_batch(make_batch())
    draws = {k: torch.from_numpy(v) for k, v in make_draws().items()}
    trainable = workload.trainable()
    with tattn.attention_dtype(None):
        loss, metrics = workload.compute_loss(trainable, batch, draws)
        loss.backward()
    grads = {k: p.grad.numpy() for k, p in trainable.named_parameters()
             if p.requires_grad}
    return float(loss.detach()), grads


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("variant,checkpointing", [
    ("lora", False), ("lora", True), ("qlora", False), ("qlora", True)])
def test_lora_loss_and_gradients_match_jax(variant, checkpointing, jax_runs,
                                           monkeypatch):
    """The port with per-layer recompute against the JAX step without it:
    the same numbers."""
    dense, adapters, jloss, jgrads = jax_step(jax_runs, variant, monkeypatch)
    quantized = variant == "qlora"
    if quantized:
        monkeypatch.setattr(qlayers, "_on_cuda", lambda x: True)
        calls = []
        real = qlayers.dequant_matmul_4bit
        monkeypatch.setattr(qlayers, "dequant_matmul_4bit",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
    workload = port_tree(dense, adapters, quantized)
    loss, grads = port_step(workload, checkpointing)
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)
    theirs = {k: v.numpy() for k, v in from_jax_state(jgrads).items()}
    assert grads.keys() == theirs.keys()
    assert len(grads) == 2 * len(_lora_paths(workload))
    for key, want in theirs.items():
        assert np.abs(want).max() > 0, key
        err = _rel_l2(grads[key], want)
        assert err <= 1e-4, f"{key}: relative L2 error {err:.2e}"
    if quantized:
        # the kernel's plain version took the products of <= 1024 rows
        # (forward, and the recompute under checkpointing)
        assert calls


def _lora_paths(workload):
    return [p for p, m in workload.trainable().named_modules() if isinstance(m, LoRALinear)]


def test_gradient_checkpointing_gives_the_same_numbers(jax_runs, monkeypatch):
    dense, adapters, _, _ = jax_step(jax_runs, "lora", monkeypatch)
    plain = port_step(port_tree(dense, adapters, False))
    remat = port_step(port_tree(dense, adapters, False), checkpointing=True)
    assert plain[0] == remat[0]
    for key, value in plain[1].items():
        np.testing.assert_allclose(remat[1][key], value, rtol=0,
                                   atol=1e-6 * np.abs(value).max())


def test_lora_only_the_adapters_move(jax_runs, monkeypatch):
    dense, adapters, _, _ = jax_step(jax_runs, "qlora", monkeypatch)
    workload = port_tree(dense, adapters, True)
    tree = workload.trainable()
    trainable = [n for n, p in tree.named_parameters() if p.requires_grad]
    assert trainable and all(".lora_" in n for n in trainable)
    assert all(n.startswith("denoiser.") for n in trainable)
    assert any(isinstance(m.linear, qlayers.QuantLinear4bit)
               for _, m in tree.named_modules() if isinstance(m, LoRALinear))


# ------------------------------------------------------------------ entry point


def write_folder(folder, count=2, size=(72, 80)):
    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(3)
    for i in range(count):
        pixels = rng.integers(0, 256, size=(*size, 3), dtype=np.uint8)
        Image.fromarray(pixels).save(folder / f"img{i}.png")
        (folder / f"img{i}.txt").write_text(f"a photo number {i}, detailed")


def write_config(tmp_path, source, optimizer=None, checkpoint_path=None,
                 checkpointing=None):
    """``source`` (a shipped SDXL config) cut to the tiny model, a synthetic
    folder and the tmp paths."""
    cfg = yaml.safe_load(open(source))
    cfg["model"] = {**TINY_MODEL, "checkpoint_path": checkpoint_path,
                    "tokenizer": "word-hash"}
    cfg["peft"]["config"].update(dtype="float32", rank=PEFT["config"]["rank"])
    write_folder(tmp_path / "images")
    cfg["dataset"].update(folder=str(tmp_path / "images"), bucket_base_size=64,
                          step=32, min_size=32, num_repeats=2, batch_size=2,
                          num_workers=2)
    if optimizer is not None:
        cfg["optimizer"]["name"] = optimizer
    cfg["num_train_epochs"] = 1
    cfg["tracker"]["log_dir"] = str(tmp_path / "logs")
    cfg["saving"]["callbacks"][0]["save_dir"] = str(tmp_path / "out")
    cfg["preview"]["callbacks"][0]["save_dir"] = str(tmp_path / "preview")
    preview = tmp_path / "preview.yml"
    preview.write_text(yaml.safe_dump([{"prompt": "a fox", "width": 64,
                                        "height": 64, "num_steps": 2,
                                        "cfg_scale": 2.0}]))
    cfg["preview"]["data"]["path"] = str(preview)
    if checkpointing is not None:
        cfg["trainer"]["checkpointing"] = checkpointing
    path = tmp_path / "config.yml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def write_nf4_checkpoint(path):
    """A random tiny checkpoint in the sgm layout, its UNet attention and
    feed-forward linears NF4-prequantized by ``quantize_state_dict``."""
    from safetensors.numpy import save_file

    from vision_pt_tpu_torch.models.sdxl import SDXLConfig
    from vision_pt_tpu_torch.ops.quant.functional import quantize_state_dict

    model = SDXLModel.from_config(SDXLConfig(**TINY_MODEL), seed=3, device="cpu")
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    unet = [k for k in sd if k.startswith("model.diffusion_model.")]
    quantized = quantize_state_dict({k: sd[k] for k in unet}, "bnb_nf4",
                                    include_keys=QUANT_STATE_KEYS)
    sd = {**{k: v for k, v in sd.items() if k not in unet}, **quantized}
    save_file({k: np.ascontiguousarray(v) for k, v in sd.items()}, str(path))
    return model


@pytest.mark.parametrize("optimizer,quantized", [
    ("schedulefree.RAdamScheduleFree", False),
    ("bitsandbytes.optim.AdamW8bit", True)])
def test_entry_point_trains_saves_and_previews(tmp_path, optimizer, quantized):
    from vision_pt_tpu_torch.models.sdxl import convert
    from vision_pt_tpu_torch.train.sdxl.text_to_image import main, run

    source = ("configs/sdxl/text_to_image_qlora_nf4.yml" if quantized
              else "configs/sdxl/text_to_image_lora.yml")
    checkpoint = None
    if quantized:
        checkpoint = tmp_path / "tiny.bnb_nf4.safetensors"
        write_nf4_checkpoint(checkpoint)
    config = write_config(tmp_path, source, optimizer,
                          str(checkpoint) if checkpoint else None)
    if not quantized:
        with pytest.raises(SystemExit) as exit_info:
            main(["--config", str(config), "--device", "cpu"])
        assert exit_info.value.code == 0
    else:
        trainer = run(str(config), device="cpu")
        # every prequantized linear loaded as NF4 with the file's codes, and
        # wrapped by a LoRA adapter
        stored = load_file(str(checkpoint))
        wrapped = {p: m.linear for p, m in trainer.model.trainable().named_modules()
                   if isinstance(m, LoRALinear)}
        nf4 = {p: q for p, q in wrapped.items()
               if isinstance(q, qlayers.QuantLinear4bit)}
        assert len(nf4) == len(wrapped) == sum(
            k.endswith(".quant_state.bitsandbytes__nf4") for k in stored)
        path, layer = sorted(nf4.items())[0]
        key = convert.convert_to_original_key(convert.port_to_torch_key(path))
        np.testing.assert_array_equal(layer.export_bnb()["weight"], stored[f"{key}.weight"])
    saved = sorted((tmp_path / "out").iterdir())
    assert len(saved) == 1 and saved[0].name.endswith("_00001e_000002s.safetensors")
    ours = load_file(str(saved[0]))
    # the JAX workload writes the same keys for the same PEFT config
    workload, _, _ = jax_tree(quantized)
    theirs = workload.get_state_dict_to_save()
    assert ours.keys() == theirs.keys()
    assert all(k.startswith("diffusion_model.") for k in ours)
    assert {ours[k].shape for k in ours if k.endswith("lora_down.weight")} \
        == {theirs[k].shape for k in theirs if k.endswith("lora_down.weight")}
    assert len(list((tmp_path / "preview").iterdir())) == 1
    logs = [json.loads(line) for line in
            next((tmp_path / "logs").glob("*.jsonl")).read_text().splitlines()]
    losses = [r["train/loss"] for r in logs if "train/loss" in r]
    assert len(losses) == 2 and all(np.isfinite(losses))
