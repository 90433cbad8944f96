"""The port's PFG (``adapters/prompt_free.py``, ``models/sdxl/adapter/prompt_free.py``,
``workloads/sdxl_prompt_free.py`` and the two entry points) against the JAX
package's, on the CPU, at the tiny SDXL of ``tests/test_torch_ip_adapter.py``
and the tiny timm ViT of ``tests/models/test_timm_vit.py`` (2 blocks, 32
wide, 32^2, patch 8), fp32 under ``attention_dtype(None)`` on both sides.

Tolerances: the projectors within 1e-5 of the largest output element; the
training step (``test_pfg_self_training_loss_and_save``'s config: gaussian
timesteps around 100, 2 image tokens) with its loss within 1e-5 relative and
each projector gradient within 1e-4 of its largest element; a 2-step CFG
``generate`` from a reference image within 1e-4 of the largest latent; the
adapter file exactly.
"""

import numpy as np
import pytest
import torch
from flax import nnx
from PIL import Image
from safetensors.numpy import save_file

import jax.numpy as jnp
import vision_pt_tpu.workloads.sdxl_prompt_free as jworkload
from tests.models.test_timm_vit import DIM, HEADS, IMG, _timm_state_dict
from tests.test_torch_ip_adapter import (
    TINY_UNET,
    TREES,
    carry,
    jax_step,
    jax_workload,
    make_batch,
    np_flat,
    numpy_sd,
    port_step,
    port_workload,
    trained_file,
    write_config,
    assert_step_matches,
)
from tests.test_torch_sdxl import _jax_draws
from tests.test_torch_sdxl_training import TINY_MODEL, make_draws
from vision_pt_tpu.adapters import prompt_free as jpf
from vision_pt_tpu.ops.attention import attention_dtype as jattention_dtype
from vision_pt_tpu_torch.adapters import prompt_free
from vision_pt_tpu_torch.models.sdxl import WordHashTokenizer
from vision_pt_tpu_torch.models.sdxl.adapter.prompt_free import (
    SDXLModelWithPFG,
    SDXLModelWithPFGConfig,
)
from vision_pt_tpu_torch.models.sdxl.convert import from_jax_state
from vision_pt_tpu_torch.ops import attention as tattn
from vision_pt_tpu_torch.peft import LoRAConfig, replace_to_peft_layer
from vision_pt_tpu_torch.workloads import sdxl_prompt_free as workload_module
from tests.test_torch_sdxl_distributed import one_torch_thread  # noqa: F401,E402

PROJECTOR_ARGS = {"linear": {}, "mlp": {"hidden_dim": 48}, "resampler": {"num_heads": 4}}
CONTEXT = TINY_UNET["context_dim"]


def projector_pair(ptype, seed=0):
    jconfig = jpf.PFGConfig(image_encoder={"feature_dim": DIM}, num_image_tokens=3,
                            projector_type=ptype, projector_args=PROJECTOR_ARGS[ptype])
    jmanager = jpf.PFGManager(jconfig)
    jproj = jmanager.get_projector(CONTEXT, rngs=nnx.Rngs(seed))
    manager = prompt_free.PFGManager(prompt_free.PFGConfig(**jconfig.model_dump()))
    proj = manager.get_projector(CONTEXT)
    proj.load_state_dict(from_jax_state(np_flat(jproj)), strict=True)
    return (jmanager, jproj), (manager, proj)


@pytest.mark.parametrize("ptype", sorted(PROJECTOR_ARGS))
@pytest.mark.parametrize("sequence", [False, True])
def test_projector_matches_jax(ptype, sequence):
    (_, jproj), (_, proj) = projector_pair(ptype)
    shape = (2, 5, DIM) if sequence else (2, DIM)
    features = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    want = np.asarray(jproj(jnp.asarray(features)).image_tokens)
    with torch.no_grad():
        got = proj(torch.from_numpy(features)).image_tokens.numpy()
    assert got.shape == (2, 3, CONTEXT)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("ptype", sorted(PROJECTOR_ARGS))
def test_manager_state_round_trips_both_ways(ptype):
    """``projector.*`` in the torch layout: the JAX package's loads into the
    port exactly and the port's into the JAX package, except the
    resampler's ``norm.weight``, which the JAX loader drops (the kept
    divergence of ``test_adapter_file_round_trips_both_ways``)."""
    (jmanager, jproj), (manager, proj) = projector_pair(ptype)
    with torch.no_grad():
        for p in proj.parameters():
            p.mul_(1.5)
    theirs = numpy_sd(jmanager.get_state_dict())
    assert all(k.startswith("projector.") for k in theirs)
    fresh_manager = projector_pair(ptype, seed=3)[1][0]
    fresh_manager.load_adapter_state(theirs)
    ours = numpy_sd(fresh_manager.get_state_dict())
    assert ours.keys() == theirs.keys()
    for k in theirs:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    written = numpy_sd(manager.get_state_dict())
    fresh_jmanager = projector_pair(ptype, seed=4)[0][0]
    before = numpy_sd(fresh_jmanager.get_state_dict())
    fresh_jmanager.load_adapter_state(written)
    back = numpy_sd(fresh_jmanager.get_state_dict())
    for k in written:
        if k == "projector.norm.weight":
            np.testing.assert_array_equal(back[k], before[k])
        else:
            np.testing.assert_array_equal(back[k], written[k], err_msg=k)


# ------------------------------------------------------------------ the step


@pytest.fixture(scope="module")
def timm_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("tower") / "vit_timm.safetensors"
    save_file(_timm_state_dict(np.random.default_rng(8)), str(path))
    return str(path)


def pfg_model_config(weights_path, **adapter):
    return {**TINY_MODEL, "denoiser": TINY_UNET, "max_token_length": 75,
            "drop_image_rate": 0.1, "timestep_sampling": "gaussian",
            "timestep_sampling_args": {"mean": 100, "std": 100},
            "adapter": {"image_encoder": {"type": "timm", "feature_dim": DIM,
                                          "num_heads": HEADS,
                                          "weights_path": weights_path},
                        "num_image_tokens": 2, "image_size": IMG, **adapter}}


@pytest.fixture(scope="module")
def pfg_run(timm_file):
    return {}


@pytest.mark.parametrize("reference", [False, True])
def test_pfg_training_step_matches_jax(reference, pfg_run, timm_file, monkeypatch):
    jcls, cls = ((jworkload.SDXLPFGRefTraining, workload_module.SDXLPFGRefTraining)
                 if reference else (jworkload.SDXLPFGSelfTraining,
                                    workload_module.SDXLPFGSelfTraining))
    config = pfg_model_config(timm_file)
    jwl = jax_workload(jcls, config)
    draws = make_draws()
    batch = make_batch(reference=reference)
    jloss, jgrads, jarrays = jax_step(jwl, batch, draws, [(jworkload, "gaussian_randint")],
                                      monkeypatch, jwl.model.vision_encoder)
    wl = port_workload(cls, config, jwl.model, TREES + ("projector",))
    loss, grads, arrays = port_step(wl, batch)
    np.testing.assert_array_equal(arrays["drop_image"].numpy(),
                                  np.asarray(jarrays["drop_image"]))
    np.testing.assert_allclose(arrays["reference_pixels"].numpy(),
                               np.asarray(jarrays["reference_pixels"]), rtol=0, atol=1e-5)
    assert_step_matches((loss, grads), (jloss, jgrads))
    assert sorted(grads) == ["projector.proj.bias", "projector.proj.weight"]
    pfg_run[reference] = (jwl, wl)


def test_gaussian_timesteps_follow_the_config(timm_file):
    from vision_pt_tpu_torch.config import TrainConfig

    config = TrainConfig.model_validate({"model": {**pfg_model_config(timm_file),
                                                   "tokenizer": "word-hash"}, "dataset": {}})
    wl = workload_module.SDXLPFGSelfTraining(config, torch.device("cpu"))
    wl.setup_model()
    t = wl.sample_timesteps(torch.Generator().manual_seed(0), 4096)
    assert t.dtype == torch.int32 and 0 <= int(t.min()) and int(t.max()) <= 1000
    idx = np.arange(0, 1001, dtype=np.float64)  # the categorical's own mean
    weights = np.exp(-0.5 * np.square((idx - 100) / 100))
    assert abs(float(t.float().mean()) - (idx * weights).sum() / weights.sum()) < 5.0


def test_save_with_peft_adds_the_unet_lora_under_the_jax_keys(pfg_run, timm_file,
                                                              monkeypatch):
    """With ``peft`` set, the file holds the projector and the UNet's LoRA
    under the JAX workload's keys."""
    from vision_pt_tpu.peft import LoRAConfig as JLoRAConfig
    from vision_pt_tpu.peft import replace_to_peft_layer as jreplace

    if False not in pfg_run:
        test_pfg_training_step_matches_jax(False, pfg_run, timm_file, monkeypatch)
    jwl, wl = pfg_run[False]
    peft = {"config": {"type": "lora", "rank": 2}, "include_keys": ["attn1", "attn2"],
            "exclude_keys": ["text_encoder", "vae"]}
    jwl.config = jwl.config.model_copy(update={"peft": peft})
    wl.config = wl.config.model_copy(update={"peft": peft})
    jreplace(jwl._full_trainable, peft["include_keys"], peft["exclude_keys"],
             JLoRAConfig(rank=2, dtype="float32"), seed=0)
    replace_to_peft_layer(wl._full_trainable, peft["include_keys"], peft["exclude_keys"],
                          LoRAConfig(rank=2, dtype="float32"))
    theirs, ours = jwl.get_state_dict_to_save(), wl.get_state_dict_to_save()
    assert ours.keys() == theirs.keys()
    assert sum(k.endswith("lora_down.weight") for k in ours) == 2 * 7 * 4
    assert {tuple(ours[k].shape) for k in ours} == {tuple(np.shape(theirs[k])) for k in theirs}


def pfg_pipelines(timm_file):
    from vision_pt_tpu.models.sdxl.adapter.prompt_free import SDXLModelWithPFG as JModel
    from vision_pt_tpu.models.sdxl.adapter.prompt_free import (
        SDXLModelWithPFGConfig as JConfig,
    )

    config = pfg_model_config(timm_file)
    jmodel = JModel(JConfig(**config), rngs=nnx.Rngs(1))
    tokenizer = WordHashTokenizer()
    jmodel.text_encoder.tokenizer_1 = jmodel.text_encoder.tokenizer_2 = tokenizer
    model = SDXLModelWithPFG.from_config(SDXLModelWithPFGConfig(**config), device="cpu",
                                         tokenizer_1=tokenizer, tokenizer_2=tokenizer)
    carry(jmodel, model, TREES + ("projector",))
    return jmodel, model


def test_generate_with_a_reference_image_matches_jax(timm_file):
    jmodel, model = pfg_pipelines(timm_file)
    reference = Image.fromarray(
        np.random.default_rng(2).integers(0, 256, size=(40, 24, 3), dtype=np.uint8))
    steps, seed = 2, 11
    latents, noise = _jax_draws(jmodel, steps, seed, (1, 8, 8, 4))
    kw = dict(prompt="a cat", negative_prompt="bad", width=64, height=64,
              num_inference_steps=steps, cfg_scale=3.0, seed=seed, return_latents=True)
    with jattention_dtype(None):
        want = np.asarray(jmodel.generate(**kw, reference_image=reference,
                                          execution_dtype=jnp.float32))
    with tattn.attention_dtype(None):
        got = model.generate(**kw, reference_image=reference, execution_dtype=torch.float32,
                             latents=latents, step_noise=noise).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_generate_appends_the_tokens_to_the_positive_context(timm_file, monkeypatch):
    """One reference for two prompts: its tokens tiled over the prompts and
    appended to their context; the negative half gets zeros."""
    model = pfg_pipelines(timm_file)[1]
    contexts = []
    forward = model.denoiser.forward
    monkeypatch.setattr(model.denoiser, "forward",
                        lambda *a, **k: contexts.append(a[2]) or forward(*a, **k))
    tokens = torch.randn(1, 2, CONTEXT)
    model.generate(["a cat", "a dog"], width=64, height=64, num_inference_steps=1,
                   cfg_scale=3.0, execution_dtype=torch.float32, image_tokens=tokens,
                   return_latents=True)
    model.generate(["a cat", "a dog"], width=64, height=64, num_inference_steps=1,
                   cfg_scale=3.0, execution_dtype=torch.float32, return_latents=True)
    context, plain = contexts
    assert context.shape == (4, plain.shape[1] + 2, CONTEXT)
    torch.testing.assert_close(context[:, :-2], plain, rtol=0, atol=0)
    torch.testing.assert_close(context[:2, -2:], tokens.expand(2, -1, -1), rtol=0, atol=0)
    assert not context[2:, -2:].any()


@pytest.mark.parametrize("entry", ["prompt_free_self", "prompt_free_ref"])
def test_entry_point_trains_one_step_and_saves(entry, tmp_path, timm_file):
    import importlib

    module = importlib.import_module(f"vision_pt_tpu_torch.train.sdxl.{entry}")
    config = write_config(tmp_path, pfg_model_config(timm_file),
                          reference=entry == "prompt_free_ref")
    with pytest.raises(SystemExit) as exit_info:
        module.main(["--config", str(config), "--device", "cpu"])
    assert exit_info.value.code == 0
    sd = trained_file(tmp_path)
    assert sorted(sd) == ["projector.proj.bias", "projector.proj.weight"]
    assert sd["projector.proj.weight"].shape == (2 * CONTEXT, DIM)
