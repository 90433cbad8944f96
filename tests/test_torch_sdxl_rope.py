"""The port's RoPE retrofit of the SDXL UNet (``models/sdxl/adapter/rope.py``
over the hooks of ``models/sdxl/denoiser.py``), the RoPE distillation
workload (``workloads/sdxl_rope_distill.py``) and its entry point, against
the JAX package's, on the CPU, at the tiny SDXL of
``tests/test_torch_sdxl_training.py`` (head dim 16, so ``rope_dims`` [8, 8]),
fp32 under ``attention_dtype(None)`` on both sides, the JAX weights carried
across by ``convert.from_jax_state``.

Tolerances: the tables exactly; a UNet forward within 1e-5 of its largest
output element; RoPE off on the same weights equals the plain UNet bit for
bit; the distillation step (teacher, student, low-res student and teacher;
LoRA rank 2 on attn1 / attn2 / .ff. with lora_up drawn nonzero, the JAX
step under ``nnx.jit``) with its loss and each metric within 1e-5 relative
and each LoRA gradient within 1e-4 relative L2 (at 128^2: at 64^2 the
low-res pass reaches a 1 x 1 bottom stage whose GroupNorm groups hold 2
values, and there both packages' fp32 gradients miss an fp64 run of the
port by 20-45%); the recomputed step equals
the plain one (loss exactly, gradients within 1e-6 of their largest
element); ``downscale`` within 2e-6 of JAX's cubic resize.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import nnx

import vision_pt_tpu.models.sdxl.vae as jvae
import vision_pt_tpu.ops.loss.diffusion as jdiffusion
import vision_pt_tpu.workloads.sdxl_rope_distill as jworkload
from tests.test_torch_ip_adapter import TINY_UNET, jit_call, np_flat
from tests.test_torch_sdxl_training import (
    PEFT,
    TINY_MODEL,
    _flat_grads,
    _JaxWithDraws,
    _lora_modules,
    _rel_l2,
    write_folder,
)
from vision_pt_tpu.config import TrainConfig as JTrainConfig
from vision_pt_tpu.models.sdxl.adapter import rope as jrope
from vision_pt_tpu.ops.attention import attention_dtype as jattention_dtype
from vision_pt_tpu.peft import AdapterParam as JAdapterParam
from vision_pt_tpu.peft import LoRAConfig as JLoRAConfig
from vision_pt_tpu.peft import replace_to_peft_layer as jreplace_to_peft_layer
from vision_pt_tpu.utils.state_dict import flatten_state
from vision_pt_tpu_torch.config import TrainConfig
from vision_pt_tpu_torch.models.sdxl import WordHashTokenizer
from vision_pt_tpu_torch.models.sdxl.adapter import rope
from vision_pt_tpu_torch.models.sdxl.config import DenoiserConfig
from vision_pt_tpu_torch.models.sdxl.convert import from_jax_state
from vision_pt_tpu_torch.models.sdxl.denoiser import Denoiser
from vision_pt_tpu_torch.ops import attention as tattn
from vision_pt_tpu_torch.peft import LoRAConfig, freeze_all_but_adapters, replace_to_peft_layer
from vision_pt_tpu_torch.workloads import sdxl_rope_distill as workload_module
from tests.test_torch_sdxl_distributed import one_torch_thread  # noqa: F401,E402

ROPE_UNET = {**TINY_UNET, "rope_dims": [8, 8]}
ROPE_MODEL = {**TINY_MODEL, "denoiser": ROPE_UNET}
BATCH, SIDE = 2, 128
TREES = ("denoiser", "vae", "text_encoder_1", "text_encoder_2")


# ------------------------------------------------------------------ tables


@pytest.mark.parametrize("origin", ["top_left", "center"])
def test_embedder_tables_equal(origin):
    for dims in ((8, 8), (32, 32)):
        ours = rope.RoPEEmbedder(dims, 500.0, origin)
        theirs = jrope.RoPEEmbedder(dims, 500.0, origin)
        for h, w in ((4, 6), (5, 3), (8, 8)):
            np.testing.assert_array_equal(ours.get_image_freqs(h, w),
                                          theirs.get_image_freqs(h, w))
            np.testing.assert_array_equal(ours.image_freqs(h, w, torch.device("cpu")).numpy(),
                                          theirs.get_image_freqs(h, w))
        for n in (7, 227):
            np.testing.assert_array_equal(ours.context_freqs(n, torch.device("cpu")).numpy(),
                                          theirs.get_context_freqs(n))
    # origin "center" shifts by ceil(h // 2): row 0 of a 5-high grid sits at -2
    centred = rope.RoPEEmbedder((2, 2), origin_position="center").get_image_freqs(5, 3)
    top = rope.RoPEEmbedder((2, 2)).get_image_freqs(5, 3)
    angle = np.arctan2(centred[0, 0, 1], centred[0, 0, 0])
    assert angle == pytest.approx(-2.0) and top[0, 0, 1] == 0.0


def test_device_tables_are_cached_once():
    embedder = rope.RoPEEmbedder((8, 8))
    a = embedder.image_freqs(6, 4, torch.device("cpu"))
    assert rope.RoPEEmbedder((8, 8)).image_freqs(6, 4, torch.device("cpu")) is a


# ------------------------------------------------------------------ the UNet


def unet_pair():
    junet = jrope.DenoiserWithRoPE(jrope.DenoiserConfigWithRoPE(**ROPE_UNET), rngs=nnx.Rngs(0))
    unet = rope.DenoiserWithRoPE(rope.DenoiserConfigWithRoPE(**ROPE_UNET)).eval()
    unet.load_state_dict(from_jax_state(np_flat(junet)), strict=True)
    return junet, unet


def unet_inputs(seed=0, side=8, context=7):
    rng = np.random.default_rng(seed)
    args = [rng.normal(size=(BATCH, side, side, 4)), np.asarray([500.0, 20.0]),
            rng.normal(size=(BATCH, context, 40)), rng.normal(size=(BATCH, 1280)),
            np.full((BATCH, 2), 128.0), np.full((BATCH, 2), 128.0), np.zeros((BATCH, 2))]
    return [np.asarray(a, np.float32) for a in args]


@pytest.mark.parametrize("enabled", [True, False])
@pytest.mark.parametrize("side", [8, 12])
def test_rope_unet_matches_jax(enabled, side):
    junet, unet = unet_pair()
    args = unet_inputs(side=side)
    junet.set_rope_enabled(enabled)
    unet.set_rope_enabled(enabled)
    with jattention_dtype(None):
        want = np.asarray(jit_call(junet, *map(jnp.asarray, args)))
    with torch.no_grad(), tattn.attention_dtype(None):
        got = unet(*map(torch.from_numpy, args)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_rope_changes_the_output():
    _, unet = unet_pair()
    args = [torch.from_numpy(a) for a in unet_inputs()]
    with torch.no_grad(), tattn.attention_dtype(None):
        on = unet(*args)
        with rope.while_rope_disabled(unet):
            off = unet(*args)
    assert (on - off).abs().max() > 1e-3 * off.abs().max()


def test_rope_off_is_the_plain_unet():
    """The hooks change nothing of the plain UNet: the same keys, and with
    RoPE off the same output bit for bit."""
    torch.manual_seed(0)
    plain = Denoiser(DenoiserConfig(**TINY_UNET)).eval()
    unet = rope.DenoiserWithRoPE(rope.DenoiserConfigWithRoPE(**ROPE_UNET, rope_enabled=False))
    assert list(unet.state_dict()) == list(plain.state_dict())
    unet.load_state_dict(plain.state_dict(), strict=True)
    args = [torch.from_numpy(a) for a in unet_inputs(3)]
    with torch.no_grad():
        assert torch.equal(unet.eval()(*args), plain(*args))


def test_flag_context_managers():
    _, unet = unet_pair()
    holder = type("Holder", (), {"denoiser": unet})()
    blocks = [m for m in unet.modules() if isinstance(m, rope._WithRoPE)]
    # a block and its two attentions, for each of the tiny UNet's 7 transformers
    assert len(blocks) == 7 * 3
    with rope.while_rope_disabled(holder):
        assert not unet.rope_enabled and not any(m.rope_enabled for m in blocks)
        with rope.while_rope_enabled(unet):
            assert all(m.rope_enabled for m in blocks)
        assert not any(m.rope_enabled for m in blocks)
    assert unet.rope_enabled and all(m.rope_enabled for m in blocks)
    with pytest.raises(KeyError), rope.while_rope_disabled(unet):
        raise KeyError
    assert all(m.rope_enabled for m in blocks)


# ------------------------------------------------------------------ the step


def make_batch(seed=0, side=SIDE):
    rng = np.random.default_rng(seed)
    return {"image": rng.uniform(-1, 1, size=(BATCH, side, side, 3)).astype(np.float32),
            "caption": ["a red fox in the snow", "portrait of a cat"],
            "original_size": np.asarray([[80, 72], [64, 97]], np.int32),
            "target_size": np.full((BATCH, 2), side, np.int32),
            "crop_coords_top_left": np.asarray([[8, 0], [0, 17]], np.int32)}


def make_draws(seed=1, side=SIDE):
    rng = np.random.default_rng(seed)
    latent, lowres = (BATCH, side // 8, side // 8, 4), (BATCH, side // 16, side // 16, 4)
    return {"vae_noise": rng.normal(size=latent).astype(np.float32),
            "timesteps": np.asarray([17, 903], np.int32),
            "noise": rng.normal(size=latent).astype(np.float32),
            "lowres_vae_noise": rng.normal(size=lowres).astype(np.float32),
            "lowres_noise": rng.normal(size=lowres).astype(np.float32)}


def jax_lora_workload(jworkload_cls, model_config, seed=7):
    """The JAX workload set up with the word-hash tokenizer, LoRA on its
    training tree with every ``lora_up`` drawn nonzero; returns it, its
    dense weights (before the surgery) and its adapters."""
    workload = jworkload_cls(JTrainConfig(model=model_config, dataset={}, peft=PEFT, seed=0))
    workload.setup_model()
    tokenizer = WordHashTokenizer()
    workload.model.text_encoder.tokenizer_1 = workload.model.text_encoder.tokenizer_2 = \
        tokenizer
    model = workload.model
    dense = {name: flatten_state(getattr(model.text_encoder if name.startswith("text")
                                         else model, name)) for name in TREES}
    jreplace_to_peft_layer(workload._full_trainable, PEFT["include_keys"],
                           PEFT["exclude_keys"], JLoRAConfig(rank=2, dtype="float32"), seed=0)
    workload._set_is_peft(True)
    rng = np.random.default_rng(seed)
    for _, module in _lora_modules(workload._full_trainable):
        module.lora_up.value = jnp.asarray(
            rng.normal(size=module.lora_up.value.shape).astype(np.float32) * 0.1)
    adapters = {k: np.asarray(v) for k, v in flatten_state(workload._full_trainable).items()
                if ".lora_" in k}
    return workload, dense, adapters


def port_lora_workload(workload_cls, model_config, dense, adapters, **config):
    """The port's workload on the CPU over the JAX weights and adapters."""
    cfg = TrainConfig.model_validate({"model": {**model_config, "tokenizer": "word-hash"},
                                      "dataset": {}, "peft": PEFT, "seed": 0, **config})
    workload = workload_cls(cfg, torch.device("cpu"))
    workload.setup_model()
    model = workload.model
    for name in TREES:
        tree = getattr(model.text_encoder if name.startswith("text") else model, name)
        tree.load_state_dict(from_jax_state(dense[name]), strict=True)
    replace_to_peft_layer(workload._full_trainable, PEFT["include_keys"], PEFT["exclude_keys"],
                          LoRAConfig(rank=2, dtype="float32"))
    missing, unexpected = workload._full_trainable.load_state_dict(
        from_jax_state(adapters), strict=False)
    assert not unexpected and not [k for k in missing if ".lora_" in k]
    freeze_all_but_adapters(workload._full_trainable)
    workload._is_peft = True
    return workload


def jax_value_and_grad(workload, batch, key, patches):
    """The JAX workload's loss, metrics and LoRA gradients under nnx.jit,
    ``patches`` (module, attribute, value) set inside the trace."""

    def loss_fn(tree):
        for module, name, value in patches():
            setattr(module, name, value)
        return workload.compute_loss(tree, batch, key)

    @nnx.jit
    def step(tree):
        return nnx.value_and_grad(loss_fn, argnums=nnx.DiffState(0, JAdapterParam),
                                  has_aux=True)(tree)

    with jattention_dtype(None):
        (loss, metrics), grads = step(workload._full_trainable)
    return float(loss), {k: float(v) for k, v in metrics.items()}, _flat_grads(grads)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX distillation step, computed once."""
    workload, dense, adapters = jax_lora_workload(jworkload.SDXLRoPEDistillTraining, ROPE_MODEL)
    draws = make_draws()
    key = jax.random.key(0)
    batch = workload.prepare_batch(make_batch(), key)
    saved = (jworkload.uniform_randint, jvae.jax, jdiffusion.jax)
    try:
        jworkload.uniform_randint = lambda *a, **k: jnp.asarray(draws["timesteps"])
        out = jax_value_and_grad(workload, batch, key, lambda: (
            (jvae, "jax", _JaxWithDraws([draws["vae_noise"], draws["lowres_vae_noise"]])),
            (jdiffusion, "jax", _JaxWithDraws([draws["noise"], draws["lowres_noise"]]))))
    finally:
        jworkload.uniform_randint, jvae.jax, jdiffusion.jax = saved
    return dense, adapters, out


def port_step(workload, batch, draws, checkpointing=False):
    if checkpointing:
        workload.enable_gradient_checkpointing()
    arrays = workload.prepare_batch(batch)
    trainable = workload.trainable()
    trainable.zero_grad(set_to_none=True)
    with tattn.attention_dtype(None):
        loss, metrics = workload.compute_loss(
            trainable, arrays, {k: torch.from_numpy(v) for k, v in draws.items()})
        loss.backward()
    grads = {k: p.grad.numpy() for k, p in trainable.named_parameters() if p.requires_grad}
    return float(loss.detach()), {k: float(v) for k, v in metrics.items()}, grads


def assert_matches_jax(ours, theirs, metric_names, grad_tol=1e-4):
    (loss, metrics, grads), (jloss, jmetrics, jgrads) = ours, theirs
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)
    assert sorted(metrics) == sorted(jmetrics) == sorted(metric_names)
    for name, value in jmetrics.items():
        assert abs(metrics[name] - value) <= 1e-5 * abs(value), name
    want = {k: v.numpy() for k, v in from_jax_state(jgrads).items()}
    assert grads.keys() == want.keys() and grads
    for key, value in want.items():
        assert np.abs(value).max() > 0, key
        err = _rel_l2(grads[key], value)
        assert err <= grad_tol, f"{key}: relative L2 error {err:.2e}"


def test_distillation_step_matches_jax(jax_run):
    dense, adapters, theirs = jax_run
    workload = port_lora_workload(workload_module.SDXLRoPEDistillTraining, ROPE_MODEL,
                                  dense, adapters)
    assert workload.model.denoiser.rope_enabled
    ours = port_step(workload, make_batch(), make_draws())
    assert_matches_jax(ours, theirs, ["l2_loss", "distill_loss", "lowres_distill_loss"])
    # the student differs from the teacher
    assert ours[1]["distill_loss"] > 0 and ours[1]["lowres_distill_loss"] > 0


def test_recomputed_step_equals_the_plain_one(jax_run):
    """Per-layer recompute reads the RoPE and PEFT flags again in the
    backward; the student passes run at their resting state, so it sees what
    the forward saw (at 64^2: the two runs are the same ops)."""
    dense, adapters, _ = jax_run
    runs = [port_step(port_lora_workload(workload_module.SDXLRoPEDistillTraining, ROPE_MODEL,
                                         dense, adapters), make_batch(side=64),
                      make_draws(side=64), checkpointing=remat) for remat in (False, True)]
    (loss, metrics, grads), (rloss, rmetrics, rgrads) = runs
    assert loss == rloss and metrics == rmetrics
    for key, value in grads.items():
        np.testing.assert_allclose(rgrads[key], value, rtol=0,
                                   atol=1e-6 * np.abs(value).max(), err_msg=key)


@pytest.mark.parametrize("side,ratio", [(64, 2.0), (1024, 2.0), (72, 3.0)])
def test_downscale_matches_jax(side, ratio):
    rng = np.random.default_rng(4)
    pixels = rng.uniform(-1, 1, size=(1, side, side + 8, 3)).astype(np.float32)
    sizes = [np.asarray([[side + 3.0, side + 1.0]], np.float32),
             np.asarray([[side, side + 8]], np.float32), np.asarray([[7.0, 5.0]], np.float32)]
    want = jworkload.downscale(jnp.asarray(pixels), *map(jnp.asarray, sizes), ratio)
    got = workload_module.downscale(torch.from_numpy(pixels), *map(torch.from_numpy, sizes),
                                    ratio)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=2e-6)
    for ours, theirs in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))


def test_draws_cover_the_low_res_pass():
    cfg = TrainConfig.model_validate({"model": {**ROPE_MODEL, "tokenizer": "word-hash"},
                                      "dataset": {}, "seed": 0})
    workload = workload_module.SDXLRoPEDistillTraining(cfg, torch.device("cpu"))
    workload.setup_model()
    arrays = workload.prepare_batch(make_batch())
    draws = workload.draw_randoms(arrays, torch.Generator().manual_seed(0))
    want = {k: v.shape for k, v in make_draws().items()}
    assert {k: tuple(v.shape) for k, v in draws.items()} == want


# ------------------------------------------------------------------ entry point


def write_config(tmp_path, model, source="configs/sdxl/text_to_image_lora.yml", peft=True,
                 reference_folder=None, **dataset):
    """``source``'s trainer settings with ``model`` (tiny), its LoRA at rank 2
    in fp32 (or none), a synthetic folder of 2 images (1 step; with
    ``reference_folder``, metadata naming references), ``dataset`` fields, a
    2-step preview and the tmp paths."""
    cfg = yaml.safe_load(open(source))
    cfg["model"] = {**model, "checkpoint_path": None, "tokenizer": "word-hash"}
    if peft:
        cfg["peft"]["config"].update(dtype="float32", rank=2)
    else:
        cfg["peft"] = None
    if reference_folder is None:
        write_folder(tmp_path / "images")
    else:
        from tests.test_torch_ip_adapter import write_images

        write_images(tmp_path / "images", reference_folder=reference_folder)
    cfg["dataset"].update(folder=str(tmp_path / "images"), bucket_base_size=64, step=32,
                          min_size=32, num_repeats=1, batch_size=2, num_workers=2, **dataset)
    cfg["num_train_epochs"] = 1
    cfg["tracker"]["log_dir"] = str(tmp_path / "logs")
    cfg["saving"]["callbacks"][0]["save_dir"] = str(tmp_path / "out")
    cfg["preview"]["callbacks"][0]["save_dir"] = str(tmp_path / "preview")
    preview = tmp_path / "preview.yml"
    preview.write_text(yaml.safe_dump([{"prompt": "a fox <|style|>", "width": 64,
                                        "height": 64, "num_steps": 2, "cfg_scale": 2.0}]))
    cfg["preview"]["data"]["path"] = str(preview)
    path = tmp_path / "config.yml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def logged(tmp_path) -> list[dict]:
    return [json.loads(line) for line in
            next((tmp_path / "logs").glob("*.jsonl")).read_text().splitlines()]


def test_entry_point_trains_saves_and_previews(tmp_path):
    from safetensors.numpy import load_file

    from vision_pt_tpu_torch.train.sdxl.rope_distill import main

    config = write_config(tmp_path, ROPE_MODEL)
    with pytest.raises(SystemExit) as exit_info:
        main(["--config", str(config), "--device", "cpu"])
    assert exit_info.value.code == 0
    rows = logged(tmp_path)
    assert [r for r in rows if "train/loss" in r] and all(
        np.isfinite(r["train/loss"]) for r in rows if "train/loss" in r)
    assert any("train/lowres_distill_loss" in r for r in rows)
    saved = sorted((tmp_path / "out").iterdir())
    assert len(saved) == 1
    sd = load_file(str(saved[0]))
    assert sd and all(".lora_" in k or k.endswith(".alpha") for k in sd)
    assert len(list((tmp_path / "preview").iterdir())) == 1


def test_entry_points_default_to_cuda(monkeypatch, tmp_path):
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = write_config(tmp_path, ROPE_MODEL)
    for entry in ("rope_distill", "draft_plus", "style_tokenizer"):
        run = importlib.import_module(f"vision_pt_tpu_torch.train.sdxl.{entry}").run
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run(str(config))
