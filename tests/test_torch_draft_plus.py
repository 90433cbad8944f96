"""The port's DRaFT+ workload (``workloads/sdxl_draft_plus.py``) and its
entry point against the JAX package's, on the CPU, at the tiny SDXL of
``tests/test_torch_sdxl_training.py``: 3 sampler steps, truncation 1, CFG 5,
64^2, the brightness reward, LoRA rank 2 on attn1 / attn2 / .ff. with
``lora_up`` drawn nonzero, fp32 under ``attention_dtype(None)`` on both
sides, the JAX step under ``nnx.jit`` with its draws (the initial latents
and each ancestral step's noise) handed in.

Tolerances: the loss and its three metrics (reward, reward_loss,
draft_reg_loss) within 1e-5 relative; each LoRA gradient within 5e-4
relative L2 (it runs through two CFG-5 sampler steps and the VAE decoder:
both packages' fp32 gradients sit up to 2.1e-4 from an fp64 run of the
port, JAX's up to 8e-5); the recomputed step equals the plain one (loss exactly,
gradients within 1e-6 of their largest element).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vision_pt_tpu.models.sdxl.scheduler as jscheduler
import vision_pt_tpu.workloads.sdxl_draft_plus as jworkload
from tests.test_torch_sdxl_rope import (
    assert_matches_jax,
    jax_lora_workload,
    jax_value_and_grad,
    logged,
    port_lora_workload,
    write_config,
)
from tests.test_torch_sdxl_training import PEFT, TINY_MODEL
from vision_pt_tpu_torch.config import TrainConfig
from vision_pt_tpu_torch.models.sdxl import Scheduler
from vision_pt_tpu_torch.ops import attention as tattn
from vision_pt_tpu_torch.peft import LoRAConfig, freeze_all_but_adapters, replace_to_peft_layer
from vision_pt_tpu_torch.workloads import sdxl_draft_plus as workload_module

STEPS, SIDE = 3, 64
DRAFT_MODEL = {**TINY_MODEL, "total_steps": STEPS, "truncation_steps": 1, "cfg_scale": 5.0,
               "sample_height": SIDE, "sample_width": SIDE,
               "reward_models": [{"type": "brightness"}]}
CAPTIONS = ["a red fox in the snow", "portrait of a cat"]


class _JaxWithNormals:
    """The ``jax`` module whose ``random.normal`` hands out given arrays in
    turn (the other ``random`` functions are JAX's)."""

    def __init__(self, arrays):
        self._arrays = list(arrays)
        self.random = types.SimpleNamespace(
            normal=self._normal, split=jax.random.split, fold_in=jax.random.fold_in)

    def _normal(self, key, shape, dtype=jnp.float32):
        array = self._arrays.pop(0)
        assert tuple(array.shape) == tuple(shape)
        return jnp.asarray(array, dtype)

    def __getattr__(self, name):
        return getattr(jax, name)


# leading spacing gives 3 steps 4 timesteps (1000, 667, 334, 1), in both
# packages; the last 4 - (3 - 1) = 2 are differentiated
TIMESTEPS = len(Scheduler().get_timesteps(STEPS))


def make_draws(seed=1):
    rng = np.random.default_rng(seed)
    shape = (len(CAPTIONS), SIDE // 8, SIDE // 8, 4)
    return {"latents": rng.normal(size=shape).astype(np.float32),
            "step_noise": [rng.normal(size=shape).astype(np.float32)
                           for _ in range(TIMESTEPS)]}


@pytest.fixture(scope="module")
def jax_run():
    workload, dense, adapters = jax_lora_workload(jworkload.SDXLDRaFTPlusTraining, DRAFT_MODEL)
    draws = make_draws()
    key = jax.random.key(0)
    batch = workload.prepare_batch({"caption": CAPTIONS}, key)
    saved = (jworkload.jax, jscheduler.jax)
    try:
        out = jax_value_and_grad(workload, batch, key, lambda: (
            (jworkload, "jax", _JaxWithNormals([draws["latents"]])),
            (jscheduler, "jax", _JaxWithNormals(draws["step_noise"]))))
    finally:
        jworkload.jax, jscheduler.jax = saved
    return dense, adapters, out


def port_step(workload, draws, checkpointing=False):
    if checkpointing:
        workload.enable_gradient_checkpointing()
    arrays = workload.prepare_batch({"caption": CAPTIONS})
    trainable = workload.trainable()
    trainable.zero_grad(set_to_none=True)
    tensors = {"latents": torch.from_numpy(draws["latents"]),
               "step_noise": [torch.from_numpy(n) for n in draws["step_noise"]]}
    with tattn.attention_dtype(None):
        loss, metrics = workload.compute_loss(trainable, arrays, tensors)
        loss.backward()
    grads = {k: p.grad.numpy() for k, p in trainable.named_parameters() if p.requires_grad}
    return float(loss.detach()), {k: float(v) for k, v in metrics.items()}, grads


def test_loss_metrics_and_lora_gradients_match_jax(jax_run):
    dense, adapters, theirs = jax_run
    workload = port_lora_workload(workload_module.SDXLDRaFTPlusTraining, DRAFT_MODEL, dense,
                                  adapters)
    ours = port_step(workload, make_draws())
    assert_matches_jax(ours, theirs, ["reward", "reward_loss", "draft_reg_loss"], grad_tol=5e-4)
    assert ours[1]["reward_loss"] == -ours[1]["reward"] and ours[1]["draft_reg_loss"] > 0


def test_recomputed_step_equals_the_plain_one(jax_run):
    """One sampler step, the differentiated one, with and without per-layer
    recompute."""
    dense, adapters, _ = jax_run
    model = {**DRAFT_MODEL, "total_steps": 1}
    draws = {k: v[:1] if k == "step_noise" else v for k, v in make_draws().items()}
    runs = [port_step(port_lora_workload(workload_module.SDXLDRaFTPlusTraining, model,
                                         dense, adapters), draws, checkpointing=remat)
            for remat in (False, True)]
    (loss, metrics, grads), (rloss, rmetrics, rgrads) = runs
    assert loss == rloss and metrics == rmetrics
    for key, value in grads.items():
        np.testing.assert_allclose(rgrads[key], value, rtol=0,
                                   atol=1e-6 * np.abs(value).max(), err_msg=key)


def test_only_the_tail_keeps_a_graph(jax_run):
    """The early steps run without autograd: only the tail's predictions
    have a graph (here the last 2 of 4 steps), each followed by the
    reference call without one."""
    dense, adapters, _ = jax_run
    workload = port_lora_workload(workload_module.SDXLDRaFTPlusTraining, DRAFT_MODEL, dense,
                                  adapters)
    graphs = []
    real = workload.model.denoiser.forward

    def forward(*args, **kwargs):
        out = real(*args, **kwargs)
        graphs.append(out.requires_grad)
        return out

    workload.model.denoiser.forward = forward
    port_step(workload, make_draws())
    assert TIMESTEPS == 4 and graphs == [False, False] + [True, False] * 2


def test_draws_are_the_latents_and_each_steps_noise():
    workload = port_lora_draft(DRAFT_MODEL)
    arrays = workload.prepare_batch({"caption": CAPTIONS})
    draws = workload.draw_randoms(arrays, torch.Generator().manual_seed(0))
    want = make_draws()
    assert tuple(draws["latents"].shape) == want["latents"].shape
    assert [tuple(n.shape) for n in draws["step_noise"]] == [n.shape for n in want["step_noise"]]
    # [positive; negative], each caption in 150 // 75 = 2 chunks of 77
    assert arrays["original_size"].shape[0] == 2 * len(CAPTIONS)
    assert tuple(arrays["ids1"].shape) == (2 * len(CAPTIONS) * 2, 77)


def port_lora_draft(model_config):
    """A port DRaFT+ workload on the CPU, random weights, LoRA on."""
    config = TrainConfig.model_validate({"model": {**model_config, "tokenizer": "word-hash"},
                                         "dataset": {}, "peft": PEFT, "seed": 0})
    workload = workload_module.SDXLDRaFTPlusTraining(config, torch.device("cpu"))
    workload.setup_model()
    replace_to_peft_layer(workload._full_trainable, PEFT["include_keys"], PEFT["exclude_keys"],
                          LoRAConfig(rank=2, dtype="float32"))
    freeze_all_but_adapters(workload._full_trainable)
    workload._is_peft = True
    return workload


@pytest.mark.parametrize("reward", ["brightness", "pickscore"])
def test_entry_point_trains_saves_and_previews(reward, tmp_path):
    from safetensors.numpy import load_file

    from tests.test_torch_reward import write_pickscore_dir
    from vision_pt_tpu_torch.train.sdxl.draft_plus import main

    rewards = [{"type": "brightness"}]
    if reward == "pickscore":
        rewards = [{"type": "pickscore", "weights_path": write_pickscore_dir(tmp_path / "clip"),
                    "tokenizer": "word-hash"}]
    config = write_config(tmp_path, {**DRAFT_MODEL, "total_steps": 2,
                                     "reward_models": rewards})
    with pytest.raises(SystemExit) as exit_info:
        main(["--config", str(config), "--device", "cpu"])
    assert exit_info.value.code == 0
    rows = [r for r in logged(tmp_path) if "train/loss" in r]
    assert rows and all(np.isfinite([r["train/loss"], r["train/reward"],
                                     r["train/draft_reg_loss"]]).all() for r in rows)
    saved = sorted((tmp_path / "out").iterdir())
    assert len(saved) == 1 and all(".lora_" in k or k.endswith(".alpha")
                                   for k in load_file(str(saved[0])))
    assert len(list((tmp_path / "preview").iterdir())) == 1
