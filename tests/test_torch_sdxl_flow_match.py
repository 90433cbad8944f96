"""The port's SDXL flow-match conversion (``models/sdxl/adapter/flow_match.py``,
``workloads/sdxl_flow_match.py``, ``train/sdxl/flow_match.py``) against the JAX
package's, on the CPU, at the tiny SDXL of ``tests/test_torch_sdxl_training.py``
in fp32 under ``attention_dtype(None)``.

- ``prepare_timesteps``: equal, element for element;
- ``_treat_fm_loss`` in its three branches (velocity/velocity, image/velocity,
  image/image), with t = 1 clean and t = 0 clean, on numpy-made tensors:
  within 1e-6 relative (the same fp32 elementwise ops in another library);
- one LoRA ``compute_loss`` step from images, the same weights, batch and
  draws (the port takes them in ``draws``; on the JAX side the workload's
  ``sample_timestep`` and the ``jax.random.normal`` of the VAE sample and of
  the flow-match noising hand out the same arrays), in each branch: the loss
  within 1e-4 relative and every LoRA gradient within 1e-3 relative L2 (fp32
  sums in another order through the VAE, the CLIPs and the UNet);
- ``SDXLFlowMatch.generate`` for 3 steps from the same initial latents, both
  prediction types, with and without CFG: the final latents within 1e-4
  relative L2;
- the entry point training 2 steps on a synthetic folder with the shipped
  config cut to the tiny model, saving the JAX workload's LoRA keys and
  previewing; a cached-latent batch is refused.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx
from safetensors.numpy import load_file

import vision_pt_tpu.models.sdxl.vae as jvae
import vision_pt_tpu.ops.loss.flow_match as jflow
import vision_pt_tpu.workloads.sdxl_flow_match as jworkload
from tests import test_torch_sdxl_training as base
from vision_pt_tpu.config import TrainConfig as JTrainConfig
from vision_pt_tpu.models.sdxl.adapter.flow_match import (
    SDXLFlowMatch as JSDXLFlowMatch,
)
from vision_pt_tpu.models.sdxl.adapter.flow_match import (
    SDXLFlowMatchConfig as JSDXLFlowMatchConfig,
)
from vision_pt_tpu.ops.attention import attention_dtype as jattention_dtype
from vision_pt_tpu.peft import AdapterParam
from vision_pt_tpu.peft import LoRAConfig as JLoRAConfig
from vision_pt_tpu.peft import replace_to_peft_layer as jreplace_to_peft_layer
from vision_pt_tpu.utils.state_dict import flatten_state
from vision_pt_tpu_torch.config import TrainConfig
from vision_pt_tpu_torch.models.sdxl import WordHashTokenizer
from vision_pt_tpu_torch.models.sdxl.adapter import SDXLFlowMatch, SDXLFlowMatchConfig
from vision_pt_tpu_torch.models.sdxl.convert import from_jax_state
from vision_pt_tpu_torch.ops import attention as tattn
from vision_pt_tpu_torch.peft import LoRAConfig, freeze_all_but_adapters, replace_to_peft_layer
from vision_pt_tpu_torch.workloads.sdxl_flow_match import SDXLForFlowMatchingTraining
from vision_pt_tpu_torch.workloads.sdxl_text_to_image import SDXLTrainable
from tests.test_torch_sdxl_distributed import one_torch_thread  # noqa: F401,E402

BRANCHES = [("velocity", "velocity"), ("image", "velocity"), ("image", "image")]
T = np.asarray([0.31, 0.87], np.float32)  # the sampler's t, before * 1000


def _model_fields(prediction, loss, clean_at_zero=False):
    return {**base.TINY_MODEL, "model_prediction": prediction, "loss_type": loss,
            "clean_at_zero": clean_at_zero}


def _rel(a, b):
    return abs(a - b) / abs(b)


def test_prepare_timesteps_equal():
    port = SDXLFlowMatch.__new__(SDXLFlowMatch)
    theirs = JSDXLFlowMatch.prepare_timesteps(None, 16)
    ours = port.prepare_timesteps(16)
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert ours[0][0] == 1000.0 and ours[0][-1] == 1.0 and ours[1][-1] == 0.0


@pytest.mark.parametrize("clean_at_zero", [False, True])
@pytest.mark.parametrize("prediction,loss", BRANCHES)
def test_treat_fm_loss_matches_jax(prediction, loss, clean_at_zero):
    fields = _model_fields(prediction, loss, clean_at_zero)
    jwork = jworkload.SDXLForFlowMatchingTraining(
        JTrainConfig(model=fields, dataset={}, seed=0))
    work = SDXLForFlowMatchingTraining(
        TrainConfig.model_validate({"model": fields, "dataset": {}, "seed": 0}),
        torch.device("cpu"))
    rng = np.random.default_rng(11)
    shape = (2, 8, 8, 4)
    pred, latents, noise = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    t = T if not clean_at_zero else np.asarray([0.0, 0.6], np.float32)
    tt = t.reshape(-1, 1, 1, 1)
    noisy = (tt * latents + (1 - tt) * noise if not clean_at_zero
             else (1 - tt) * latents + tt * noise).astype(np.float32)
    theirs = float(jwork._treat_fm_loss(*(jnp.asarray(x) for x in
                                          (pred, latents, noise, noisy, t))))
    ours = float(work._treat_fm_loss(*(torch.from_numpy(x) for x in
                                       (pred, latents, noise, noisy, t))))
    assert _rel(ours, theirs) <= 1e-6, (ours, theirs)


# ------------------------------------------------------------------ the step


def make_draws(seed=1):
    rng = np.random.default_rng(seed)
    latent = (base.BATCH, base.SIDE // 8, base.SIDE // 8, 4)
    return {"vae_noise": rng.normal(size=latent).astype(np.float32),
            "t": T, "noise": rng.normal(size=latent).astype(np.float32)}


def jax_tree(fields):
    """The JAX flow-match workload over the tiny model, LoRA on, every
    ``lora_up`` drawn nonzero."""
    config = JTrainConfig(model=fields, dataset={}, peft=base.PEFT, seed=0)
    workload = jworkload.SDXLForFlowMatchingTraining(config)
    model = JSDXLFlowMatch.from_config(
        JSDXLFlowMatchConfig(**{k: v for k, v in fields.items() if k != "loss_type"}),
        rngs=nnx.Rngs(0))
    tokenizer = WordHashTokenizer()
    model.text_encoder.tokenizer_1 = model.text_encoder.tokenizer_2 = tokenizer
    dense = {name: flatten_state(getattr(model, name)) for name in ("denoiser", "vae")}
    dense.update({name: flatten_state(getattr(model.text_encoder, name))
                  for name in ("text_encoder_1", "text_encoder_2")})
    workload.model = model
    workload._full_trainable = jworkload.SDXLTrainable(
        model.denoiser, model.text_encoder.text_encoder_1,
        model.text_encoder.text_encoder_2, model.vae)
    jreplace_to_peft_layer(workload._full_trainable, base.PEFT["include_keys"],
                           base.PEFT["exclude_keys"],
                           JLoRAConfig(rank=2, dtype="float32"), seed=0)
    workload._set_is_peft(True)
    rng = np.random.default_rng(7)
    for _, module in base._lora_modules(workload._full_trainable):
        module.lora_up.value = jnp.asarray(
            rng.normal(size=module.lora_up.value.shape).astype(np.float32) * 0.1)
    adapters = {k: np.asarray(v) for k, v in
                flatten_state(workload._full_trainable).items() if ".lora_" in k}
    return workload, dense, adapters


def port_tree(fields, dense, adapters):
    config = TrainConfig.model_validate(
        {"model": {**fields, "tokenizer": "word-hash"}, "dataset": {},
         "peft": base.PEFT, "seed": 0})
    workload = SDXLForFlowMatchingTraining(config, torch.device("cpu"))
    workload.setup_model()
    model = workload.model
    assert isinstance(model, SDXLFlowMatch)
    model.denoiser.load_state_dict(from_jax_state(dense["denoiser"]))
    model.vae.load_state_dict(from_jax_state(dense["vae"]))
    for name in ("text_encoder_1", "text_encoder_2"):
        getattr(model.text_encoder, name).load_state_dict(from_jax_state(dense[name]))
    replace_to_peft_layer(workload._full_trainable, base.PEFT["include_keys"],
                          base.PEFT["exclude_keys"], LoRAConfig(rank=2, dtype="float32"))
    missing, unexpected = workload._full_trainable.load_state_dict(
        from_jax_state(adapters), strict=False)
    assert not unexpected and not [k for k in missing if ".lora_" in k]
    freeze_all_but_adapters(workload._full_trainable)
    workload._is_peft = True
    return workload


def jax_step(fields, monkeypatch):
    workload, dense, adapters = jax_tree(fields)
    draws = make_draws()
    key = jax.random.key(0)
    batch = workload.prepare_batch(base.make_batch(), key)
    monkeypatch.setattr(jworkload, "sample_timestep",
                        lambda key, n, kind, **kw: jnp.asarray(draws["t"]))

    def loss_fn(tree):
        monkeypatch.setattr(jvae, "jax", base._JaxWithDraws([draws["vae_noise"]]))
        monkeypatch.setattr(jflow, "jax", base._JaxWithDraws([draws["noise"]]))
        return workload.compute_loss(tree, batch, key)[0]

    @nnx.jit
    def step(tree):
        return nnx.value_and_grad(loss_fn, argnums=nnx.DiffState(0, AdapterParam))(tree)

    with jattention_dtype(None):
        loss, grads = step(workload._full_trainable)
    monkeypatch.undo()
    return dense, adapters, float(loss), base._flat_grads(grads)


def port_step(workload):
    batch = workload.prepare_batch(base.make_batch())
    d = make_draws()
    draws = {"vae_noise": torch.from_numpy(d["vae_noise"]),
             "timesteps": torch.from_numpy(d["t"]) * 1000.0,
             "noise": torch.from_numpy(d["noise"])}
    trainable = workload.trainable()
    with tattn.attention_dtype(None):
        loss, _ = workload.compute_loss(trainable, batch, draws)
        loss.backward()
    return float(loss.detach()), {k: p.grad.numpy() for k, p in
                                  trainable.named_parameters() if p.requires_grad}


@pytest.mark.parametrize("prediction,loss", BRANCHES)
def test_lora_step_matches_jax(prediction, loss, monkeypatch):
    fields = _model_fields(prediction, loss)
    dense, adapters, jloss, jgrads = jax_step(fields, monkeypatch)
    workload = port_tree(fields, dense, adapters)
    ours, grads = port_step(workload)
    assert _rel(ours, jloss) <= 1e-4, (ours, jloss)
    theirs = {k: v.numpy() for k, v in from_jax_state(jgrads).items()}
    assert grads.keys() == theirs.keys() and len(grads) > 0
    for key, want in theirs.items():
        assert np.abs(want).max() > 0, key
        err = base._rel_l2(grads[key], want)
        assert err <= 1e-3, f"{key}: relative L2 error {err:.2e}"


def test_draws_and_cached_latents(monkeypatch):
    """The step's draws: the VAE noise and latent noise at the latent shape,
    the timesteps t * 1000 in (0, 1000); a batch of cached latents is
    refused."""
    fields = _model_fields("velocity", "velocity")
    workload = SDXLForFlowMatchingTraining(
        TrainConfig.model_validate({"model": {**fields, "tokenizer": "word-hash"},
                                    "dataset": {}, "seed": 0}), torch.device("cpu"))
    workload.setup_model()
    batch = workload.prepare_batch(base.make_batch())
    draws = workload.draw_randoms(batch, torch.Generator().manual_seed(0))
    latent = (base.BATCH, base.SIDE // 8, base.SIDE // 8, 4)
    assert draws["vae_noise"].shape == draws["noise"].shape == latent
    t = draws["timesteps"]
    assert t.dtype == torch.float32 and t.shape == (base.BATCH,)
    assert bool(((t > 0) & (t < 1000)).all())
    cached = {**base.make_batch(), "latents": np.zeros(latent, np.float32)}
    del cached["image"]
    prepared = workload.prepare_batch(cached)
    with pytest.raises(ValueError, match="cached latents"):
        workload.compute_loss(workload.trainable(), prepared, draws)


# ------------------------------------------------------------------ generate


@pytest.mark.parametrize("prediction", ["velocity", "image"])
@pytest.mark.parametrize("cfg_scale", [1.0, 3.0])
def test_generate_matches_jax(prediction, cfg_scale, monkeypatch):
    fields = {**base.TINY_MODEL, "model_prediction": prediction}
    jmodel = JSDXLFlowMatch.from_config(JSDXLFlowMatchConfig(**fields), rngs=nnx.Rngs(0))
    tokenizer = WordHashTokenizer()
    jmodel.text_encoder.tokenizer_1 = jmodel.text_encoder.tokenizer_2 = tokenizer
    model = SDXLFlowMatch.from_config(SDXLFlowMatchConfig(**fields), device="cpu",
                                      tokenizer_1=tokenizer, tokenizer_2=tokenizer)
    model.denoiser.load_state_dict(from_jax_state(flatten_state(jmodel.denoiser)))
    model.vae.load_state_dict(from_jax_state(flatten_state(jmodel.vae)))
    for name in ("text_encoder_1", "text_encoder_2"):
        getattr(model.text_encoder, name).load_state_dict(
            from_jax_state(flatten_state(getattr(jmodel.text_encoder, name))))
    init = np.random.default_rng(5).normal(size=(1, 8, 8, 4)).astype(np.float32)
    monkeypatch.setattr(JSDXLFlowMatch, "prepare_latents",
                        lambda self, *a, **k: jnp.asarray(init))
    kwargs = dict(prompt="a red fox in the snow", negative_prompt="blurry",
                  width=64, height=64, num_inference_steps=3, cfg_scale=cfg_scale,
                  return_latents=True)
    with jattention_dtype(None):
        theirs = np.asarray(jmodel.generate(**kwargs, execution_dtype=jnp.float32))
    with tattn.attention_dtype(None):
        ours = model.generate(**kwargs, execution_dtype=torch.float32,
                              latents=init).numpy()
    assert ours.shape == theirs.shape == init.shape
    assert base._rel_l2(ours, theirs) <= 1e-4
    assert base._rel_l2(ours, init) > 1e-2  # the sampler moved them
    if cfg_scale > 1 and prediction == "velocity":
        images = model.generate(**{**kwargs, "return_latents": False}, latents=init)
        assert len(images) == 1 and images[0].size == (64, 64)


# ------------------------------------------------------------------ entry point


def test_entry_point_trains_saves_and_previews(tmp_path):
    from vision_pt_tpu_torch.train.sdxl.flow_match import main

    config = base.write_config(tmp_path, "configs/sdxl/flow_match/config.yml")
    with pytest.raises(SystemExit) as exit_info:
        main(["--config", str(config), "--device", "cpu"])
    assert exit_info.value.code == 0
    saved = sorted((tmp_path / "out").iterdir())
    assert len(saved) == 1 and saved[0].name.endswith("_00001e_000002s.safetensors")
    ours = load_file(str(saved[0]))
    workload, _, _ = jax_tree(_model_fields("velocity", "velocity"))
    theirs = workload.get_state_dict_to_save()
    assert ours.keys() == theirs.keys()
    assert all(k.startswith("diffusion_model.") for k in ours)
    assert len(list((tmp_path / "preview").iterdir())) == 1
    logs = [json.loads(line) for line in
            next((tmp_path / "logs").glob("*.jsonl")).read_text().splitlines()]
    losses = [r["train/loss"] for r in logs if "train/loss" in r]
    assert len(losses) == 2 and all(np.isfinite(losses))
