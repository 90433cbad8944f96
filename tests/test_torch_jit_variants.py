"""The port's JiT variant workloads and entry points against the JAX
package's ``workloads/jit_variants.py``, on the CPU.

One training step of each of the six workloads (U-JiT, ARB U-JiT, Cross,
with RoPE and with PoPE, IG, LoIG, TREAD) on the same parameters and batch, with the JAX step's draws
(timesteps, noise and TREAD's route permutation, from the JAX keys) handed to
the port. fp32 under ``attention_dtype(None)``: the loss within 1e-5 and
every gradient within 1e-4 relative L2 (the same arithmetic in another
order of sums). The ``packed`` cases open the packed-kernel gate on the CPU,
so the kernels' plain versions (forward and backward, TREAD's with suffix
kv_lens) run where the card runs #1/#2. Then each new entry point end to end
on the CPU (2 or 4 steps, a save, a preview), the x-loss config cut to a
tiny denoiser among them, and IG-guided sampling against the JAX package's.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import nnx
from PIL import Image

import vision_pt_tpu.workloads.jit_variants as jvariants
from vision_pt_tpu.config import TrainConfig as JaxTrainConfig
from vision_pt_tpu.ops import attention as jattn
from vision_pt_tpu.utils.state_dict import _path_to_key, flatten_state, load_flat_state
import vision_pt_tpu_torch.models.jit.denoiser as tden
import vision_pt_tpu_torch.workloads.jit_variants as tvariants
from vision_pt_tpu_torch.config import TrainConfig
from vision_pt_tpu_torch.models.jit.convert import from_jax_state
from vision_pt_tpu_torch.ops import attention as tattn
from vision_pt_tpu_torch.ops.timestep.sampling import sample_timestep
from tests.test_torch_sdxl_distributed import one_torch_thread  # noqa: F401,E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
LOSS_TOL, GRAD_TOL, SAMPLE_TOL = 1e-5, 1e-4, 1e-5  # relative, fp32
TINY = dict(
    patch_size=4, hidden_size=64, depth=4, num_heads=2, bottleneck_dim=16,
    context_dim=32, context_start_block=1, rope_axes_dims=[8, 12, 12],
    num_time_tokens=2,
)
BATCH, SIZE = 2, 16
PATCHES = (SIZE // TINY["patch_size"]) ** 2

# case -> (workload class, in both packages; denoiser fields; model fields)
WORKLOADS = {
    "ujit": ("JiTForUJiTTraining", {"depth": 1, "num_blocks": 4}, {}),
    "arb_ujit": ("JiTForArbUJiTTraining", {"depth": 1, "num_blocks": 3,
                                           "norm_position": "pre"},
                 {"lowres_loss": [0.5]}),
    "cross": ("JiTForCrossTraining", {}, {}),
    "cross_pope": ("JiTForCrossTraining", {"positional_encoding": "pope"}, {}),
    "ig": ("JiTForIGTraining", {"intermediate_output_idx": 1},
           {"ig_scale": 1.5, "intermediate_loss_weight": 0.7}),
    "loig": ("JiTForLoIGTraining", {"internal_rank": 4},
             {"loig_loss_weight": 0.6}),
    "tread": ("JiTForTreadTraining", {"tread_start_block": 1,
                                      "tread_end_block": 3}, {}),
}
# packed launches of one step with the gate open: Cross's three
# self-attention blocks, IG's and LoIG's block 0 (before the context), all
# four of TREAD's blocks (suffix kv_lens); none of U-JiT's (every block
# masked) or PoPE's (plain attention)
PACKED_CALLS = {"cross": 3, "ig": 1, "loig": 1, "tread": 4}
STEP_CASES = [(name, "plain") for name in sorted(WORKLOADS)] + [
    (name, "packed") for name in sorted(PACKED_CALLS)]


def rel_l2(ours, theirs) -> float:
    ours, theirs = np.asarray(ours, np.float64), np.asarray(theirs, np.float64)
    return float(np.linalg.norm(ours - theirs) / max(np.linalg.norm(theirs), 1e-30))


@pytest.fixture(scope="module")
def label2id(tmp_path_factory):
    path = tmp_path_factory.mktemp("labels") / "label2id.json"
    path.write_text(json.dumps({f"c{i}": i for i in range(4)}))
    return str(path)


def config_dict(name, label2id):
    _, denoiser, model = WORKLOADS[name]
    return {
        "model": {
            "context_encoder": {"type": "class", "label2id_map_path": label2id},
            "denoiser": {**TINY, **denoiser}, "max_token_length": 4,
            "drop_context_rate": 0.0, **model,
        },
        "dataset": {}, "seed": 0,
    }


def make_batch(name):
    rng = np.random.default_rng(0)
    batch = {"image": rng.uniform(-1, 1, size=(BATCH, SIZE, SIZE, 3)).astype(np.float32),
             "caption": ["c1", "c2 c3"]}
    if name == "arb_ujit":
        batch.update(original_size=np.array([[24, 16], [16, 20]], np.int32),
                     target_size=np.full((BATCH, 2), SIZE, np.int32),
                     crop_coords_top_left=np.array([[4, 0], [0, 2]], np.int32))
    return batch


def jax_draws(name, key):
    """The draws of the JAX workload's ``compute_loss`` under ``key``."""
    if name == "tread":
        k_t, k_noise, k_route = jax.random.split(jax.random.fold_in(key, 1), 3)
    else:
        k_t, k_noise = jax.random.split(jax.random.fold_in(key, 1))
    draws = {"timesteps": np.array(jax.random.normal(k_t, (BATCH,), jnp.float32)),
             "noise": np.array(jax.random.normal(
                 k_noise, (BATCH, SIZE, SIZE, 3), jnp.float32))}
    if name == "tread":
        draws["route_perm"] = np.array(jax.random.permutation(k_route, PATCHES))
    return draws


_JAX_STEPS = {}


def jax_step(name, label2id):
    """(parameters, loss, gradients) of one JAX step under ``nnx.jit``,
    computed once a module."""
    if name not in _JAX_STEPS:
        workload = getattr(jvariants, WORKLOADS[name][0])(
            JaxTrainConfig.model_validate(config_dict(name, label2id)))
        workload.setup_model()
        trainable = workload.trainable()
        rng = np.random.default_rng(1)
        flat = {}
        for key, value in flatten_state(trainable).items():
            value = np.asarray(value)
            if "pope_bias" in key:
                value = rng.uniform(-1, 1, size=value.shape).astype(np.float32)
            elif "norm" in key:
                value = rng.uniform(0.5, 1.5, size=value.shape).astype(np.float32)
            elif key.endswith(".bias"):
                value = rng.normal(0, 0.02, size=value.shape).astype(np.float32)
            flat[key] = value
        load_flat_state(trainable, flat)
        key = jax.random.key(7)
        batch = workload.prepare_batch(make_batch(name), key)

        def loss_fn(t):
            return workload.compute_loss(t, batch, key)

        @nnx.jit
        def step(t):
            return nnx.value_and_grad(loss_fn, has_aux=True)(t)

        with jattn.attention_dtype(None):
            (loss, _), grads = step(trainable)
        grads = {_path_to_key(tuple(path)): np.asarray(getattr(v, "value", v))
                 for path, v in nnx.to_flat_state(grads)}
        _JAX_STEPS[name] = (flat, float(loss), grads, jax_draws(name, key))
    return _JAX_STEPS[name]


@pytest.mark.parametrize("name,gate", STEP_CASES)
def test_training_step_matches_jax(name, gate, label2id, monkeypatch):
    flat, jloss, jgrads, draws = jax_step(name, label2id)
    calls = []
    if gate == "packed":
        monkeypatch.setattr(tden, "_on_cuda", lambda x: True)
        monkeypatch.setattr(tden, "MIN_PACKED_SEQ", 1)
        real = tden.short_attention_packed
        monkeypatch.setattr(tden, "short_attention_packed",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
    workload = getattr(tvariants, WORKLOADS[name][0])(
        TrainConfig.model_validate(config_dict(name, label2id)), torch.device("cpu"))
    workload.setup_model()
    trainable = workload.trainable()
    trainable.load_state_dict(from_jax_state(flat), strict=True)
    batch = workload.prepare_batch(make_batch(name))
    ours = {
        "timesteps": sample_timestep(None, BATCH,
                                     workload.model_config.timestep_sampling,
                                     draw=torch.from_numpy(draws["timesteps"])),
        "noise": torch.from_numpy(draws["noise"]),
    }
    if name == "tread":
        ours["route_perm"] = torch.from_numpy(draws["route_perm"])
    with tattn.attention_dtype(None):
        loss, metrics = workload.compute_loss(trainable, batch, ours)
        loss.backward()
    assert len(calls) == PACKED_CALLS.get(name, 0) * (gate == "packed")
    assert abs(loss.item() - jloss) <= LOSS_TOL * abs(jloss)
    theirs = {k: v.numpy() for k, v in from_jax_state(jgrads).items()}
    params = dict(trainable.named_parameters())
    assert params.keys() == theirs.keys()
    for key, value in theirs.items():
        grad = params[key].grad
        ours_grad = np.zeros_like(value) if grad is None else grad.numpy()
        assert rel_l2(ours_grad, value) <= GRAD_TOL, key
    assert all(np.isfinite(float(v)) for v in metrics.values())


@pytest.mark.parametrize("name", ["ujit", "arb_ujit", "cross", "tread"])
def test_gradient_checkpointing_gives_the_same_step(name, label2id, monkeypatch):
    """The variants that run their blocks through ``JiT._run_block``: one
    step with per-block recompute equals the step without it, the loss
    exactly and every gradient within 1e-6 of its largest element, on the
    same weights and draws. (The JAX variants ignore the flag, so the port
    holds itself.)"""
    workload = getattr(tvariants, WORKLOADS[name][0])(
        TrainConfig.model_validate(config_dict(name, label2id)), torch.device("cpu"))
    workload.setup_model()
    trainable = workload.trainable()
    batch = workload.prepare_batch(make_batch(name))
    rng = np.random.default_rng(3)
    draws = {"timesteps": torch.from_numpy(rng.uniform(0.1, 0.9, BATCH).astype(np.float32)),
             "noise": torch.from_numpy(
                 rng.normal(size=(BATCH, SIZE, SIZE, 3)).astype(np.float32))}
    if name == "tread":
        draws["route_perm"] = torch.from_numpy(rng.permutation(PATCHES))
    recomputed = []
    real = tden.checkpoint
    monkeypatch.setattr(tden, "checkpoint",
                        lambda *a, **k: recomputed.append(1) or real(*a, **k))

    def step():
        trainable.zero_grad(set_to_none=True)
        loss, _ = workload.compute_loss(trainable, batch, draws)
        loss.backward()
        return loss.item(), {n: p.grad.clone() for n, p in trainable.named_parameters()
                             if p.grad is not None}

    plain = step()
    assert not recomputed
    workload.enable_gradient_checkpointing()
    remat = step()
    assert recomputed
    assert remat[0] == plain[0]
    assert remat[1].keys() == plain[1].keys() and plain[1]
    for key, value in plain[1].items():
        torch.testing.assert_close(remat[1][key], value, rtol=0,
                                   atol=1e-6 * float(value.abs().max()))


def test_tread_draws_a_route_permutation(label2id):
    workload = tvariants.JiTForTreadTraining(
        TrainConfig.model_validate(config_dict("tread", label2id)), torch.device("cpu"))
    workload.setup_model()
    batch = workload.prepare_batch(make_batch("tread"))
    draws = [workload.draw_randoms(batch, torch.Generator().manual_seed(s))
             for s in (0, 0, 1)]
    perm = draws[0]["route_perm"]
    assert sorted(perm.tolist()) == list(range(PATCHES))
    assert torch.equal(perm, draws[1]["route_perm"])
    assert not torch.equal(perm, draws[2]["route_perm"])


# ------------------------------------------------------------------ sampling


@pytest.mark.parametrize("name", ["ig", "loig"])
def test_guided_sampling_matches_jax(name, label2id, monkeypatch):
    """IG-guided and CFG sampling, 2 Euler steps in fp32, the JAX package's
    initial noise handed to both."""
    flat = jax_step(name, label2id)[0]
    jworkload = getattr(jvariants, WORKLOADS[name][0])(
        JaxTrainConfig.model_validate(config_dict(name, label2id)))
    jworkload.setup_model()
    load_flat_state(jworkload.trainable(), flat)
    tworkload = getattr(tvariants, WORKLOADS[name][0])(
        TrainConfig.model_validate(config_dict(name, label2id)), torch.device("cpu"))
    tworkload.setup_model()
    tworkload.trainable().load_state_dict(from_jax_state(flat), strict=True)
    noise = np.random.default_rng(3).normal(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    monkeypatch.setattr(jworkload.model, "prepare_noisy_image",
                        lambda *a, **k: jnp.asarray(noise))
    kw = dict(prompt=["c1", "c2 c3"], width=SIZE, height=SIZE,
              num_inference_steps=2, cfg_scale=2.0, ig_scale=2.0,
              max_token_length=4, ig_time_range=(0.0, 0.6),
              return_arrays=True)
    with jattn.attention_dtype(None), tattn.attention_dtype(None):
        theirs = np.asarray(jworkload.model.generate(execution_dtype=jnp.float32, **kw))
        ours = tworkload.model.generate(execution_dtype=torch.float32,
                                        initial_noise=noise, **kw).numpy()
        unguided = tworkload.model.generate(
            execution_dtype=torch.float32, initial_noise=noise,
            **{**kw, "ig_scale": 1.0}).numpy()
    assert rel_l2(ours, theirs) <= SAMPLE_TOL
    assert np.abs(unguided - ours).max() > 1e-4


# ------------------------------------------------------------------ entry points

SQUARE_ENTRY_POINTS = {
    "class_to_image_ujit": {"depth": 1, "num_blocks": 4},
    "class_to_image_cross": {},
    "class_to_image_ig": {"intermediate_output_idx": 1},
    "class_to_image_loig": {"internal_rank": 4},
    "class_to_image_tread": {"tread_start_block": 1, "tread_end_block": 2},
}


def _run(module: str, path, device="cpu"):
    import importlib

    return importlib.import_module(f"vision_pt_tpu_torch.train.jit.{module}").run(
        str(path), device=device)


def write_square_config(tmp_path, denoiser: dict):
    """``configs/jit/synthetic_class_to_image.yml`` at a tiny size: 8
    synthetic 32^2 images in batches of 4, one epoch (2 steps), a save and
    a 2-step preview at its end."""
    cfg = yaml.safe_load((ROOT / "configs/jit/synthetic_class_to_image.yml").read_text())
    (tmp_path / "label2id.json").write_text(json.dumps({f"c{i}": i for i in range(4)}))
    cfg["model"]["context_encoder"]["label2id_map_path"] = str(tmp_path / "label2id.json")
    cfg["model"]["denoiser"].update({
        **dict(patch_size=8, hidden_size=64, depth=3, num_heads=2,
               bottleneck_dim=16, context_dim=32, rope_axes_dims=[8, 12, 12]),
        **denoiser})
    cfg["dataset"].update(num_items=8, image_size=32, batch_size=4)
    cfg["num_train_epochs"] = 1
    cfg["scheduler"]["args"]["num_warmup_steps"] = 1
    cfg["saving"]["strategy"] = {"per_epochs": 1}
    cfg["saving"]["callbacks"][0]["save_dir"] = str(tmp_path / "out")
    cfg["preview"]["strategy"] = {"per_epochs": 1}
    cfg["preview"]["callbacks"][0]["save_dir"] = str(tmp_path / "preview")
    cfg["preview"]["data"]["data"][0].update(width=32, height=32, num_steps=2)
    cfg["tracker"].update(log_dir=str(tmp_path / "logs"), loggers=["jsonl"])
    path = tmp_path / "config.yml"
    path.write_text(yaml.safe_dump(cfg))
    return path


@pytest.mark.parametrize("module", sorted(SQUARE_ENTRY_POINTS))
def test_square_entry_points_train_save_and_preview(module, tmp_path):
    path = write_square_config(tmp_path, SQUARE_ENTRY_POINTS[module])
    trainer = _run(module, path)
    assert trainer.global_step == 2
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == [
        "ema_jit_synth_00001e_000002s.safetensors",
        "jit_synth_00001e_000002s.safetensors"]
    assert len(list((tmp_path / "preview").iterdir())) == 1
    records = [json.loads(line) for line in
               (tmp_path / "logs/verify_run.metrics.jsonl").read_text().splitlines()]
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    assert len(losses) == 2 and np.isfinite(losses).all()


X_LOSS_LABELS = ["1girl", "solo", "blue_hair", "blonde_hair", "smile"]


def write_x_loss_config(tmp_path, denoiser: dict):
    """``configs/jit/x_loss/config.yml`` as shipped but for the denoiser's
    widths, the data (8 synthetic 64^2 ``.webp`` images with ``.tags.json``
    metadata and a label2id of their tags), one epoch (4 steps of 2), a
    preview of the shipped prompts at 64^2 in 2 steps at the epoch's end,
    and the output paths."""
    images = tmp_path / "images"
    images.mkdir()
    rng = np.random.default_rng(0)
    for i in range(8):
        Image.fromarray(rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)).save(
            images / f"{i}.webp")
        tags = " ".join(rng.choice(X_LOSS_LABELS, 3, replace=False))
        (images / f"{i}.tags.json").write_text(json.dumps({"tags": tags}))
    (tmp_path / "label2id.json").write_text(
        json.dumps({tag: i for i, tag in enumerate(X_LOSS_LABELS)}))
    cfg = yaml.safe_load((ROOT / "configs/jit/x_loss/config.yml").read_text())
    cfg["model"]["denoiser"].update(hidden_size=64, num_heads=2, context_dim=32,
                                    rope_axes_dims=[8, 12, 12], **denoiser)
    cfg["model"]["context_encoder"]["label2id_map_path"] = str(tmp_path / "label2id.json")
    cfg["dataset"].update(folder=str(images), bucket_base_size=64, step=32,
                          min_size=64, batch_size=2)
    cfg["tracker"]["log_dir"] = str(tmp_path / "logs")
    cfg["saving"]["callbacks"][0]["save_dir"] = str(tmp_path / "out")
    cfg["preview"]["callbacks"][0]["save_dir"] = str(tmp_path / "preview")
    cfg["preview"]["strategy"]["per_steps"] = None
    preview = yaml.safe_load((ROOT / "configs/jit/x_loss/preview.yml").read_text())
    for job in preview:
        job.update(width=64, height=64, num_steps=2)
    (tmp_path / "preview.yml").write_text(yaml.safe_dump(preview))
    cfg["preview"]["data"]["path"] = str(tmp_path / "preview.yml")
    cfg["num_train_epochs"] = 1
    path = tmp_path / "config.yml"
    path.write_text(yaml.safe_dump(cfg))
    return path


def test_x_loss_config_fields_as_shipped():
    """The YAML names no depth or context_start_block, so the denoiser
    defaults apply: 24 blocks, the class context from block 0 (every block
    masked, so plain attention throughout, as in the JAX package)."""
    shipped = yaml.safe_load((ROOT / "configs/jit/x_loss/config.yml").read_text())
    model = tvariants.JiTConfigForArbTraining.model_validate(shipped["model"])
    jmodel = jvariants.JiTConfigForArbTraining.model_validate(shipped["model"])
    assert model.denoiser.model_dump() == jmodel.denoiser.model_dump()
    d = model.denoiser
    assert (d.depth, d.context_start_block, d.hidden_size, d.num_heads,
            d.patch_size) == (24, 0, 768, 12, 16)
    assert (model.loss_target, model.timestep_sampling, model.dtype) == (
        "image", "scale_shift_sigmoid", "bfloat16")
    assert shipped["trainer"]["gradient_checkpointing"] is True


@pytest.mark.parametrize("module,denoiser", [
    ("arb_class_to_image", {"depth": 2}),
    ("arb_class_to_image_ujit", {"depth": 1, "num_blocks": 4}),
], ids=["x_loss", "ujit"])
def test_arb_entry_points_train_the_x_loss_config(module, denoiser, tmp_path):
    path = write_x_loss_config(tmp_path, denoiser)
    trainer = _run(module, path)
    assert trainer.global_step == 4
    assert trainer.model.model.denoiser.gradient_checkpointing
    assert [p.name for p in (tmp_path / "out").iterdir()] == [
        "jit-animeface_00001e_000004s.safetensors"]
    assert len(list((tmp_path / "preview").iterdir())) == 2
    records = [json.loads(line) for line in
               (tmp_path / "logs/JiT/AnimeFace/01.metrics.jsonl").read_text().splitlines()]
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    assert len(losses) == 4 and np.isfinite(losses).all()


@pytest.mark.parametrize("module", sorted([*SQUARE_ENTRY_POINTS,
                                           "arb_class_to_image",
                                           "arb_class_to_image_ujit"]))
def test_new_entry_points_default_to_cuda(module, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = write_square_config(tmp_path, {})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _run(module, path, device=None)
