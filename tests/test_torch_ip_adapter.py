"""The port's IP-Adapter (``adapters/ip_adapter.py``, the UNet's plumbing,
``models/sdxl/adapter/ip_adapter.py``, ``workloads/sdxl_ip_adapter.py`` and
the three entry points) against the JAX package's, on the CPU, at the tiny
UNet of ``tests/models/test_ip_adapter.py`` and a tiny CLIP vision tower
(2 layers, 32 wide, 28^2), fp32 under ``attention_dtype(None)`` on both
sides, the JAX weights carried across by ``convert.from_jax_state``.

Tolerances: a UNet forward within 1e-5 of the largest output element; a
training step's loss within 1e-5 relative and each adapter and projector
gradient within 1e-4 of its largest element (fp32 sums in another order
through the VAE, the CLIPs and the UNet); a 2-step CFG ``generate``
within 1e-4 of the largest latent (the chaotic random UNet, as in
``tests/test_torch_sdxl.py``); adapter files and the JAX resize at the
tower's sides exactly or to 1e-5.
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
from safetensors.numpy import load_file, save_file

import vision_pt_tpu.models.sdxl.vae as jvae
import vision_pt_tpu.ops.loss.diffusion as jdiffusion
import vision_pt_tpu.workloads.sdxl_ip_adapter as jworkload
from tests.test_torch_sdxl import _jax_draws
from tests.test_torch_sdxl_training import TINY_MODEL, _flat_grads, _JaxWithDraws, make_draws
from tests.test_torch_vision_towers import CLIP_TINY, hf_clip_state, write_clip_dir
from vision_pt_tpu.adapters import ip_adapter as jip
from vision_pt_tpu.config import TrainConfig as JTrainConfig
from vision_pt_tpu.models.sdxl.adapter import ip_adapter as jsdxl_ip
from vision_pt_tpu.models.sdxl.config import DenoiserConfig as JDenoiserConfig
from vision_pt_tpu.models.sdxl.convert import unet_torch_to_nnx
from vision_pt_tpu.models.sdxl.denoiser import Denoiser as JDenoiser
from vision_pt_tpu.ops.attention import attention_dtype as jattention_dtype
from vision_pt_tpu.peft import AdapterParam as JAdapterParam
from vision_pt_tpu.utils.state_dict import flatten_state, load_flat_state
from vision_pt_tpu_torch.adapters import ip_adapter
from vision_pt_tpu_torch.config import TrainConfig
from vision_pt_tpu_torch.models.sdxl import WordHashTokenizer
from vision_pt_tpu_torch.models.sdxl.adapter.ip_adapter import SDXLModelWithIPAdapter
from vision_pt_tpu_torch.models.sdxl.config import DenoiserConfig
from vision_pt_tpu_torch.models.sdxl.convert import from_jax_state
from vision_pt_tpu_torch.models.sdxl.denoiser import Denoiser
from vision_pt_tpu_torch.ops import attention as tattn
from vision_pt_tpu_torch.peft import (
    AdapterParam,
    adapter_parameters,
    calculate_trainable_parameters,
)
from vision_pt_tpu_torch.workloads import sdxl_ip_adapter as workload_module
from tests.test_torch_sdxl_distributed import one_torch_thread  # noqa: F401,E402

TINY_UNET = dict(hidden_dim=32, block_out_channels=[32, 32, 64],
                 num_transformers_per_block=[1, 1, 1], num_head_channels=16,
                 context_dim=40, layers_per_block=1)
VARIANTS = ["original", "adaln_zero", "tanh_gate", "gate", "flamingo", "time_gate", "peft"]
# the zero-initialised adapter weights, drawn nonzero so every branch counts
ZERO_INIT = ("tanh_gate", "gate.weight", "time_gate", "norm.scale_shift", "norm.gate",
             "lora_up")
BATCH, SIDE = 2, 64


def np_flat(module) -> dict[str, np.ndarray]:
    return {k: np.array(v) for k, v in flatten_state(module).items()}


def numpy_sd(sd) -> dict[str, np.ndarray]:
    """As numpy, contiguous (as the saving callbacks write it)."""
    return {k: np.ascontiguousarray(v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                                    else v) for k, v in sd.items()}


def draw_zero_init(jmodule, seed=5):
    """Every zero-initialised adapter weight of the JAX tree drawn nonzero."""
    rng = np.random.default_rng(seed)
    flat = np_flat(jmodule)
    drawn = {k: (rng.normal(size=v.shape) * 0.3).astype(v.dtype)
             for k, v in flat.items() if any(z in k for z in ZERO_INIT)}
    load_flat_state(jmodule, drawn, strict=False)


@nnx.jit
def jit_call(module, *args, **kwargs):
    return module(*args, **kwargs)


def adapter_config(variant, module=ip_adapter, **kw):
    peft = {"type": "lora", "rank": 2, "dtype": "float32"} if variant == "peft" else None
    return module.IPAdapterConfig(variant=variant, num_ip_tokens=4, dtype="float32",
                                  peft=peft, time_embedding_dim=TINY_UNET["hidden_dim"] * 4,
                                  **kw)


def unet_inputs(seed=0, ip_tail=False):
    rng = np.random.default_rng(seed)
    args = [rng.normal(size=(BATCH, 16, 16, 4)), np.asarray([500.0, 20.0]),
            rng.normal(size=(BATCH, 7, 40)), rng.normal(size=(BATCH, 1280)),
            np.full((BATCH, 2), 128.0), np.full((BATCH, 2), 128.0), np.zeros((BATCH, 2))]
    ip_tokens = rng.normal(size=(BATCH, 4, 40)).astype(np.float32)
    return [np.asarray(a, np.float32) for a in args], ip_tokens


def adapted_pair(variant):
    """The tiny UNet in both packages with the variant applied over every
    attn2 (paths rooted at a holder, as at the pipeline), the same weights."""
    junet = JDenoiser(JDenoiserConfig(**TINY_UNET), rngs=nnx.Rngs(0))
    jholder = types.SimpleNamespace(denoiser=junet)
    jmanager = jip.IPAdapterManager(jip.get_ip_adapter_class(variant),
                                    adapter_config(variant, jip))
    jpaths = jmanager.apply_adapter(jholder, rngs=nnx.Rngs(1))
    draw_zero_init(junet)
    unet = Denoiser(DenoiserConfig(**TINY_UNET)).eval()
    holder = types.SimpleNamespace(denoiser=unet)
    manager = ip_adapter.IPAdapterManager(ip_adapter.get_ip_adapter_class(variant),
                                          adapter_config(variant))
    paths = manager.apply_adapter(holder)
    missing, unexpected = unet.load_state_dict(from_jax_state(np_flat(junet)), strict=False)
    # LoRA's alpha is a buffer here, a constant (not a Param) in the JAX package
    assert not unexpected and all(k.endswith("_lora.alpha") for k in missing)
    return (junet, jmanager, jpaths), (unet, manager, paths)


@pytest.mark.parametrize("variant", VARIANTS)
def test_variant_matches_jax(variant):
    (junet, jmanager, jpaths), (unet, manager, paths) = adapted_pair(variant)
    assert paths == jpaths and len(paths) == 7
    assert all(p.startswith("denoiser.") and p.endswith(".attn2") for p in paths)
    assert sorted(manager.module_dict) == sorted(jmanager.module_dict)
    args, ip_tokens = unet_inputs()
    if variant == "adaln_zero":  # the image tokens ride the context's tail
        args[2] = np.concatenate([args[2], ip_tokens], axis=1)
        jkw = kw = {}
    else:
        jkw = {"cross_attention_kwargs": {"ip_tokens": jnp.asarray(ip_tokens)}}
        kw = {"cross_attention_kwargs": {"ip_tokens": torch.from_numpy(ip_tokens)}}
    with jattention_dtype(None):
        want = np.asarray(jit_call(junet, *map(jnp.asarray, args), **jkw))
    with tattn.attention_dtype(None), torch.no_grad():
        got = unet(*map(torch.from_numpy, args), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    # the trainable set: the adapters' own weights, as the JAX package's
    # AdapterParams, and nothing of the base attention
    trained = {id(p) for p in adapter_parameters(unet)}
    ours = {n for n, p in unet.named_parameters() if id(p) in trained}
    keys = _adapter_keys(junet)
    theirs = set(from_jax_state({k: v for k, v in np_flat(junet).items() if k in keys}))
    assert ours == theirs and ours
    assert not any(".to_q." in n or ".to_k." in n or ".to_out." in n for n in ours)


def _adapter_keys(jmodule):
    state = nnx.state(jmodule, JAdapterParam)
    from vision_pt_tpu.utils.state_dict import _path_to_key

    return {_path_to_key(tuple(p)) for p, _ in nnx.to_flat_state(state)}


@pytest.mark.parametrize("variant", VARIANTS)
def test_adapter_state_round_trips_both_ways(variant):
    """The escaped-path adapter file: the JAX package's loads into the port
    and the port's into the JAX package, with the same keys and values."""
    (junet, jmanager, _), (unet, manager, _) = adapted_pair(variant)
    theirs = numpy_sd(jmanager.get_state_dict())
    assert all("!" in k.split(".")[0] for k in theirs)
    fresh_pair = adapted_pair(variant)
    fresh_jmanager, fresh_manager = fresh_pair[0][1], fresh_pair[1][1]
    # perturb the fresh port side, then load the JAX file into it
    with torch.no_grad():
        for p in adapter_parameters(fresh_pair[1][0]):
            p.add_(1.0)
    fresh_manager.load_adapter_state(theirs)
    ours = numpy_sd(fresh_manager.get_state_dict())
    assert ours.keys() == theirs.keys()
    for k in theirs:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    # and the port's file into a JAX tree perturbed the same way
    flat = np_flat(fresh_pair[0][0])
    keys = _adapter_keys(fresh_pair[0][0])
    load_flat_state(fresh_pair[0][0], {k: v + 1.0 for k, v in flat.items() if k in keys},
                    strict=False)
    fresh_jmanager.load_adapter_state(numpy_sd(manager.get_state_dict()))
    back = numpy_sd(fresh_jmanager.get_state_dict())
    for k in theirs:
        np.testing.assert_array_equal(back[k], theirs[k], err_msg=k)


def test_original_variant_starts_from_the_base_weights():
    unet = Denoiser(DenoiserConfig(**TINY_UNET))
    holder = types.SimpleNamespace(denoiser=unet)
    manager = ip_adapter.IPAdapterManager(adapter_config=ip_adapter.IPAdapterConfig())
    manager.apply_adapter(holder)
    adapter = next(iter(manager.module_dict.values()))
    assert adapter.to_k_ip.dtype == torch.bfloat16  # the config's default dtype
    assert torch.equal(adapter.to_k_ip, adapter.to_k.weight.T.to(torch.bfloat16))
    assert torch.equal(adapter.to_v_ip, adapter.to_v.weight.T.to(torch.bfloat16))
    assert isinstance(adapter.to_k_ip, AdapterParam)
    assert not isinstance(adapter.to_k.weight, AdapterParam)


@pytest.mark.parametrize("variant", [v for v in VARIANTS if v != "adaln_zero"])
def test_without_ip_tokens_the_unet_is_the_base_model(variant):
    """Applied but given no image tokens, the UNet computes exactly what the
    base model computes on the same weights."""
    unet = Denoiser(DenoiserConfig(**TINY_UNET)).eval()
    args, _ = unet_inputs(seed=3)
    tensors = list(map(torch.from_numpy, args))
    with torch.no_grad():
        base = unet(*tensors)
        manager = ip_adapter.IPAdapterManager(adapter_config=adapter_config(variant))
        manager.apply_adapter(types.SimpleNamespace(denoiser=unet))
        adapted = unet(*tensors)
    assert torch.equal(adapted, base)


def test_resize_matches_jax_at_the_towers_sides():
    x = np.random.default_rng(0).uniform(-1, 1, size=(2, 1024, 1024, 3)).astype(np.float32)
    for side in (224, 448):
        want = np.asarray(jax.image.resize(jnp.asarray(x), (2, side, side, 3), "linear"))
        got = workload_module.resize_images(torch.from_numpy(x), side).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ------------------------------------------------------------------ the step


@pytest.fixture(scope="module")
def clip_dir(tmp_path_factory):
    return write_clip_dir(tmp_path_factory.mktemp("tower") / "clip",
                          hf_clip_state("quick_gelu", seed=9), "quick_gelu")


def ip_model_config(weights_path, variant="original"):
    return {**TINY_MODEL, "denoiser": TINY_UNET, "adapter": {
        **adapter_config(variant).model_dump(exclude={"image_encoder"}),
        "image_size": CLIP_TINY["image_size"],
        "image_encoder": {"feature_dim": CLIP_TINY["hidden_size"],
                          "weights_path": weights_path}}}


def make_batch(reference=False, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"image": rng.uniform(-1, 1, size=(BATCH, SIDE, SIDE, 3)).astype(np.float32),
             "caption": ["a red fox in the snow", "portrait of a cat"],
             "original_size": np.asarray([[80, 72], [64, 96]], np.int32),
             "target_size": np.full((BATCH, 2), SIDE, np.int32),
             "crop_coords_top_left": np.asarray([[8, 0], [0, 16]], np.int32)}
    if reference:
        batch["reference_image"] = rng.uniform(-1, 1, size=(BATCH, 40, 40, 3)).astype(
            np.float32)
    return batch


def carry(jmodel, model, trees):
    """The JAX pipeline's weights into the port's, tree by tree."""
    for name in trees:
        text = name.startswith("text_encoder_")
        jtree = getattr(jmodel.text_encoder if text else jmodel, name)
        tree = getattr(model.text_encoder if text else model, name)
        tree.load_state_dict(from_jax_state(np_flat(jtree)), strict=True)


TREES = ("denoiser", "vae", "text_encoder_1", "text_encoder_2")


def jax_workload(jworkload_cls, model_config, monkeypatch_targets=()):
    workload = jworkload_cls(JTrainConfig(model=model_config, dataset={}, seed=0))
    workload.setup_model()
    tokenizer = WordHashTokenizer()
    workload.model.text_encoder.tokenizer_1 = workload.model.text_encoder.tokenizer_2 = \
        tokenizer
    return workload


def jax_step(workload, batch, draws, timestep_patches, monkeypatch, encoder):
    """The JAX workload's loss and AdapterParam gradients under nnx.jit, with
    the draws handed in (the VAE sample's and the DDPM noise by replacing
    ``jax.random.normal`` of those modules, the timesteps by ``patches``)."""
    key = jax.random.key(0)
    arrays = workload.prepare_batch(batch, key)
    encoder(arrays["reference_pixels"])  # build the tower outside the trace
    for module, name in timestep_patches:
        monkeypatch.setattr(module, name, lambda *a, **k: jnp.asarray(draws["timesteps"]))

    def loss_fn(tree):
        monkeypatch.setattr(jvae, "jax", _JaxWithDraws([draws["vae_noise"]]))
        monkeypatch.setattr(jdiffusion, "jax", _JaxWithDraws([draws["noise"]]))
        return workload.compute_loss(tree, arrays, key)[0]

    @nnx.jit
    def step(tree):
        return nnx.value_and_grad(loss_fn, argnums=nnx.DiffState(0, JAdapterParam))(tree)

    with jattention_dtype(None):
        loss, grads = step(workload._full_trainable)
    monkeypatch.undo()
    return float(loss), _flat_grads(grads), arrays


def port_workload(workload_cls, model_config, jmodel, trees):
    config = TrainConfig.model_validate({"model": {**model_config, "tokenizer": "word-hash"},
                                         "dataset": {}, "seed": 0})
    workload = workload_cls(config, torch.device("cpu"))
    workload.setup_model()
    carry(jmodel, workload.model, trees)
    return workload


def port_step(workload, batch, checkpointing=False):
    if checkpointing:
        workload.enable_gradient_checkpointing()
    arrays = workload.prepare_batch(batch)
    draws = {k: torch.from_numpy(v) for k, v in make_draws().items()}
    trainable = workload.trainable()
    trainable.zero_grad(set_to_none=True)
    with tattn.attention_dtype(None):
        loss, _ = workload.compute_loss(trainable, arrays, draws)
        loss.backward()
    grads = {k: p.grad.numpy() for k, p in trainable.named_parameters() if p.requires_grad}
    return float(loss.detach()), grads, arrays


def assert_step_matches(ours, theirs):
    (loss, grads), (jloss, jgrads) = ours, theirs
    assert abs(loss - jloss) <= 1e-5 * abs(jloss)
    want = {k: v.numpy() for k, v in from_jax_state(jgrads).items()}
    assert grads.keys() == want.keys()
    for key, value in want.items():
        assert np.abs(value).max() > 0, key
        np.testing.assert_allclose(grads[key], value, rtol=0,
                                   atol=1e-4 * np.abs(value).max(), err_msg=key)


@pytest.fixture(scope="module")
def ip_runs():
    return {}


def ip_step_pair(ip_runs, clip_dir, monkeypatch, variant="original"):
    """The SDXLIPAdapterSelfTraining step in both packages, same weights
    (adapters drawn nonzero), batch and draws; the JAX side computed once."""
    if variant not in ip_runs:
        config = ip_model_config(clip_dir, variant)
        jwl = jax_workload(jworkload.SDXLIPAdapterSelfTraining, config)
        draw_zero_init(jwl.model.denoiser)
        draws = make_draws()
        loss, grads, arrays = jax_step(jwl, make_batch(), draws,
                                       [(jworkload, "uniform_randint")], monkeypatch,
                                       jwl.model.encoder)
        ip_runs[variant] = (jwl, loss, grads, arrays)
    return ip_runs[variant]


@pytest.mark.parametrize("variant", ["original", "time_gate"])
def test_self_training_step_matches_jax(variant, ip_runs, clip_dir, monkeypatch):
    jwl, jloss, jgrads, jarrays = ip_step_pair(ip_runs, clip_dir, monkeypatch, variant)
    wl = port_workload(workload_module.SDXLIPAdapterSelfTraining,
                       ip_model_config(clip_dir, variant), jwl.model,
                       TREES + ("image_proj",))
    loss, grads, arrays = port_step(wl, make_batch())
    np.testing.assert_array_equal(arrays["drop_image"].numpy(), np.asarray(jarrays["drop_image"]))
    np.testing.assert_allclose(arrays["reference_pixels"].numpy(),
                               np.asarray(jarrays["reference_pixels"]), rtol=0, atol=1e-5)
    assert_step_matches((loss, grads), (jloss, jgrads))
    assert all(k.startswith(("denoiser.", "image_proj.")) for k in grads)
    # the trainable count is the JAX package's
    from vision_pt_tpu.peft import calculate_trainable_parameters as jcount

    ours = calculate_trainable_parameters(wl.trainable())
    theirs = jcount(jwl.trainable())
    assert (ours.trainable_params, ours.all_param) == (theirs.trainable_params,
                                                       theirs.all_param)


def test_recomputed_step_equals_the_plain_one(ip_runs, clip_dir, monkeypatch):
    """Per-layer recompute carries the image tokens and the time embedding
    (time_gate reads it) through ``torch.utils.checkpoint``."""
    jwl = ip_step_pair(ip_runs, clip_dir, monkeypatch, "time_gate")[0]
    config = ip_model_config(clip_dir, "time_gate")
    runs = [port_step(port_workload(workload_module.SDXLIPAdapterSelfTraining, config,
                                     jwl.model, TREES + ("image_proj",)), make_batch(),
                      checkpointing=remat) for remat in (False, True)]
    (loss, grads, _), (rloss, rgrads, _) = runs
    assert loss == rloss
    for key, value in grads.items():
        assert np.abs(value).max() > 0, key
        np.testing.assert_allclose(rgrads[key], value, rtol=0,
                                   atol=1e-6 * np.abs(value).max(), err_msg=key)


def ip_pipelines(clip_dir):
    """SDXLModelWithIPAdapter in both packages, adapters applied, the same
    weights (gates and all drawn), the word-hash tokenizer."""
    from vision_pt_tpu.models.sdxl.adapter.ip_adapter import (
        SDXLModelWithIPAdapterConfig as JConfig,
    )
    from vision_pt_tpu_torch.models.sdxl.adapter.ip_adapter import (
        SDXLModelWithIPAdapterConfig,
    )

    config = ip_model_config(clip_dir, "tanh_gate")
    jmodel = jsdxl_ip.SDXLModelWithIPAdapter(JConfig(**config), rngs=nnx.Rngs(1))
    jmodel.init_adapter()
    draw_zero_init(jmodel.denoiser)
    tokenizer = WordHashTokenizer()
    jmodel.text_encoder.tokenizer_1 = jmodel.text_encoder.tokenizer_2 = tokenizer
    model = SDXLModelWithIPAdapter.from_config(
        SDXLModelWithIPAdapterConfig(**config), device="cpu", tokenizer_1=tokenizer,
        tokenizer_2=tokenizer)
    model.init_adapter()
    carry(jmodel, model, TREES + ("image_proj",))
    return jmodel, model


def test_generate_with_reference_tokens_matches_jax(clip_dir):
    jmodel, model = ip_pipelines(clip_dir)
    reference = Image.fromarray(
        np.random.default_rng(2).integers(0, 256, size=(30, 20, 3), dtype=np.uint8))
    with jattention_dtype(None):
        jtokens = np.asarray(jmodel.encode_reference_images([reference]))
    with tattn.attention_dtype(None), torch.no_grad():
        tokens = model.encode_reference_images([reference])
    np.testing.assert_allclose(tokens.numpy(), jtokens, rtol=0,
                               atol=1e-5 * np.abs(jtokens).max())
    steps, seed = 2, 11
    latents, noise = _jax_draws(jmodel, steps, seed, (1, 8, 8, 4))
    kw = dict(prompt="a cat", negative_prompt="bad", width=64, height=64,
              num_inference_steps=steps, cfg_scale=3.0, seed=seed, return_latents=True)
    with jattention_dtype(None):
        want = np.asarray(jmodel.generate(**kw, reference_images=[reference],
                                          execution_dtype=jnp.float32))
        plain = np.asarray(jmodel.generate(**kw, execution_dtype=jnp.float32))
    with tattn.attention_dtype(None):
        got = model.generate(**kw, reference_images=[reference],
                             execution_dtype=torch.float32, latents=latents,
                             step_noise=noise).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    assert np.abs(want - plain).max() > 1e-2  # the image tokens move the sample


def test_bf16_sampling_with_image_tokens_keeps_the_execution_dtype(clip_dir):
    """The kept divergence of the port's sampler holds with image tokens:
    the JAX step-wise loop goes on in fp32 after CFG's fp32 guidance scale,
    the port rounds each step back to bf16."""
    jmodel, model = ip_pipelines(clip_dir)
    reference = Image.new("RGB", (24, 24), (200, 30, 40))
    kw = dict(prompt="a cat", width=64, height=64, num_inference_steps=2, cfg_scale=3.0,
              seed=7, return_latents=True, reference_images=[reference])
    assert jmodel.generate(**kw, execution_dtype=jnp.bfloat16).dtype == jnp.float32
    latents = model.generate(**kw, execution_dtype=torch.bfloat16)
    assert latents.dtype == torch.bfloat16 and bool(torch.isfinite(latents).all())


def test_adapter_file_round_trips_both_ways(clip_dir, tmp_path):
    """``ip_adapter.*`` + ``image_proj.*``: the JAX package's file loads into
    the port exactly, the port's into the JAX package. One kept divergence:
    the JAX loader drops ``image_proj.norm.weight`` (its converter maps a 1-D
    ``norm.weight`` to a LayerNorm scale only under a dotted norm prefix), so
    that tensor keeps the JAX tree's own value."""
    jmodel, model = ip_pipelines(clip_dir)
    with torch.no_grad():
        model.image_proj.norm.weight.mul_(1.5)  # as training moves it
    theirs = numpy_sd(jmodel.adapter_state_dict())
    path = tmp_path / "jax_adapter.safetensors"
    save_file(theirs, str(path))
    fresh = ip_pipelines(clip_dir)[1]
    with torch.no_grad():
        for p in fresh.image_proj.parameters():
            p.add_(1.0)
    fresh.load_adapter_state_dict(load_file(str(path)))
    ours = numpy_sd(fresh.adapter_state_dict())
    assert ours.keys() == theirs.keys()
    for k in theirs:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    assert sum(k.startswith("ip_adapter.") for k in ours) == 7 * 3  # k, v, tanh gate
    assert {k for k in ours if k.startswith("image_proj.")} == {
        "image_proj.proj.weight", "image_proj.proj.bias", "image_proj.norm.weight",
        "image_proj.norm.bias"}
    # the port's file into the JAX package, as its _load_checkpoint reads it
    written = numpy_sd(model.adapter_state_dict())
    jfresh = ip_pipelines(clip_dir)[0]
    before = np_flat(jfresh.image_proj)["norm.scale"].copy()
    jfresh.manager.load_adapter_state({k[len("ip_adapter."):]: v for k, v in written.items()
                                       if k.startswith("ip_adapter.")})
    load_flat_state(jfresh.image_proj,
                    unet_torch_to_nnx({k[len("image_proj."):]: v for k, v in written.items()
                                       if k.startswith("image_proj.")}), strict=False)
    back = numpy_sd(jfresh.adapter_state_dict())
    for k in written:
        if k == "image_proj.norm.weight":
            np.testing.assert_array_equal(back[k], before)
            assert not np.array_equal(back[k], written[k])
        else:
            np.testing.assert_array_equal(back[k], written[k], err_msg=k)


# ------------------------------------------------------------------ entry points


def write_images(folder, count=2, size=(72, 80), reference_folder=None):
    """Images with captions, or (with ``reference_folder``) with metadata
    JSONs naming a reference image and tag groups."""
    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(3)
    for i in range(count):
        Image.fromarray(rng.integers(0, 256, size=(*size, 3), dtype=np.uint8)).save(
            folder / f"img{i}.png")
        if reference_folder is None:
            (folder / f"img{i}.txt").write_text(f"a photo number {i}, detailed")
            continue
        reference_folder.mkdir(parents=True, exist_ok=True)
        ref = reference_folder / f"ref{i}.png"
        Image.fromarray(rng.integers(0, 256, size=(50, 30 + 10 * i, 3),
                                     dtype=np.uint8)).save(ref)
        (folder / f"img{i}.json").write_text(json.dumps({
            "reference_image": str(ref), "character": [f"character {i}"],
            "general": ["solo", "smile"], "meta": ["highres"], "people": ["1girl"]}))


def write_config(tmp_path, model, reference=False):
    """``configs/sdxl/text_to_image_lora.yml``'s trainer settings with the
    adapter's ``model``, no LoRA, a synthetic folder of 2 images (1 step),
    a 2-step preview and the tmp paths."""
    cfg = yaml.safe_load(open("configs/sdxl/text_to_image_lora.yml"))
    cfg["model"] = {**model, "tokenizer": "word-hash"}
    cfg["peft"] = None
    write_images(tmp_path / "images",
                 reference_folder=tmp_path / "references" if reference else None)
    cfg["dataset"].update(folder=str(tmp_path / "images"), bucket_base_size=64, step=32,
                          min_size=32, num_repeats=1, batch_size=2, num_workers=2)
    cfg["num_train_epochs"] = 1
    cfg["tracker"]["log_dir"] = str(tmp_path / "logs")
    cfg["saving"]["callbacks"][0]["save_dir"] = str(tmp_path / "out")
    cfg["preview"]["callbacks"][0]["save_dir"] = str(tmp_path / "preview")
    preview = tmp_path / "preview.yml"
    preview.write_text(yaml.safe_dump([{"prompt": "a fox", "width": 64, "height": 64,
                                        "num_steps": 2, "cfg_scale": 2.0}]))
    cfg["preview"]["data"]["path"] = str(preview)
    path = tmp_path / "config.yml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def trained_file(tmp_path) -> dict[str, np.ndarray]:
    saved = sorted((tmp_path / "out").iterdir())
    assert len(saved) == 1
    logs = [json.loads(line) for line in
            next((tmp_path / "logs").glob("*.jsonl")).read_text().splitlines()]
    losses = [r["train/loss"] for r in logs if "train/loss" in r]
    assert len(losses) == 1 and np.isfinite(losses).all()
    assert len(list((tmp_path / "preview").iterdir())) == 1
    return load_file(str(saved[0]))


@pytest.mark.parametrize("entry", ["ip_adapter_self", "ip_adapter_ref", "ip_adapter_kyara"])
def test_entry_point_trains_one_step_and_saves(entry, tmp_path, clip_dir):
    import importlib

    module = importlib.import_module(f"vision_pt_tpu_torch.train.sdxl.{entry}")
    config = write_config(tmp_path, ip_model_config(clip_dir), reference=entry != "ip_adapter_self")
    with pytest.raises(SystemExit) as exit_info:
        module.main(["--config", str(config), "--device", "cpu"])
    assert exit_info.value.code == 0
    sd = trained_file(tmp_path)
    assert sum(k.startswith("ip_adapter.") for k in sd) == 7 * 2
    assert sum(k.startswith("image_proj.") for k in sd) == 4
    assert all(k.startswith(("ip_adapter.", "image_proj.")) for k in sd)


def test_kyara_drops_no_image(clip_dir):
    config = TrainConfig.model_validate({
        "model": {**ip_model_config(clip_dir), "tokenizer": "word-hash"}, "dataset": {}})
    wl = workload_module.SDXLIPAdapterKyaraTraining(config, torch.device("cpu"))
    wl.setup_model()
    assert wl.model_config.drop_image_rate == 0.0
    assert not workload_module.drop_image(wl._drop_rng, wl.model_config.drop_image_rate, 64,
                                          torch.device("cpu")).any()


def test_entry_points_default_to_cuda(monkeypatch, tmp_path, clip_dir):
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = write_config(tmp_path, ip_model_config(clip_dir))
    for entry in ("ip_adapter_self", "ip_adapter_ref", "ip_adapter_kyara",
                  "prompt_free_self", "prompt_free_ref"):
        run = importlib.import_module(f"vision_pt_tpu_torch.train.sdxl.{entry}").run
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            run(str(config))
