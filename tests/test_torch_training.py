"""The port's training path against the JAX package's, on the CPU, at a tiny
JiT size, with numpy-made inputs and JAX's own random draws handed to both.

- the timestep samplers and the flow-match noising, with the JAX draws
  injected: 1e-6 (fp32 elementwise ops in another order);
- every ported learning-rate schedule: 1e-5 relative (optax evaluates in
  fp32, the port in fp64);
- five training steps of the JAX ``Trainer`` and the port's ``Trainer``
  (AdamW, clip 1.0, cosine with warmup, EMA, class-context drops) from the
  same weights (``convert.from_jax_state``) and the same batches, fp32 under
  ``attention_dtype(None)``: the loss of every step and the final
  parameters and EMA within 1e-4 relative (fp32 sums in another order,
  carried through five Adam updates);
- the port's trainer entry point end to end with
  ``configs/jit/synthetic_class_to_image.yml``, and the trainer's options.
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from flax import nnx

from vision_pt_tpu.config import TrainConfig as JaxTrainConfig
from vision_pt_tpu.data.square_class_image import (
    SyntheticClassImageDatasetConfig as JaxSynthetic,
)
from vision_pt_tpu.ops import attention as jattn
from vision_pt_tpu.ops.loss import flow_match as jflow
from vision_pt_tpu.ops.timestep import sampling as jsampling
from vision_pt_tpu.training import scheduler as jscheduler
from vision_pt_tpu.training.trainer import Trainer as JaxTrainer
from vision_pt_tpu.utils.state_dict import _path_to_key, flatten_state
from vision_pt_tpu.workloads.jit_class_to_image import (
    JiTForClassToImageTraining as JaxWorkload,
)
import vision_pt_tpu_torch.models.jit.denoiser as tden
from vision_pt_tpu_torch.config import TrainConfig
from vision_pt_tpu_torch.data.square_class_image import SyntheticClassImageDatasetConfig
from vision_pt_tpu_torch.models.jit.convert import from_jax_state
from vision_pt_tpu_torch.ops import attention as tattn
from vision_pt_tpu_torch.ops.loss import flow_match as tflow
from vision_pt_tpu_torch.ops.timestep import sampling as tsampling
from vision_pt_tpu_torch.ops.short_attention import short_attention_packed
from vision_pt_tpu_torch.training import scheduler as tscheduler
from vision_pt_tpu_torch.training.optimizer import get_optimizer
from vision_pt_tpu_torch.training.trainer import Trainer
from vision_pt_tpu_torch.workloads.jit_class_to_image import (
    JiTForClassToImageTraining,
)
from tests.test_torch_sdxl_distributed import one_torch_thread  # noqa: F401,E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
SEED, BATCH, SIZE, STEPS = 0, 4, 32, 5
TINY = dict(patch_size=8, hidden_size=64, depth=2, num_heads=2,
            bottleneck_dim=16, context_dim=32, context_start_block=1,
            rope_axes_dims=[8, 12, 12], num_time_tokens=2)


# ------------------------------------------------------------------ ops


SAMPLERS = [
    # (name, kwargs, base draw kind)
    ("sigmoid", {"sigmoid_scale": 1.3}, "normal"),
    ("shift_sigmoid", {}, "normal"),
    ("flux_shift", {}, "normal"),
    ("scale_shift_sigmoid", {}, "normal"),
    ("scale_shift_sigmoid", {"std": 1.1, "mean": 0.2}, "normal"),
    ("uniform", {}, "uniform"),
    ("shift_uniform", {"shift": 3.0}, "uniform"),
    ("fraction_uniform", {}, "randint"),
    ("shift_fraction_uniform", {"divisible": [4, 6]}, "randint"),
]


@pytest.mark.parametrize("name,kwargs,kind", SAMPLERS,
                         ids=[f"{s[0]}{i}" for i, s in enumerate(SAMPLERS)])
def test_timestep_samplers_match_jax(name, kwargs, kind):
    key, n = jax.random.key(11), 8
    extra = {"height": 32, "width": 48} if name == "flux_shift" else {}
    theirs = np.asarray(jsampling.sample_timestep(key, n, name, **extra, **kwargs))
    if kind == "normal":
        draw = jax.random.normal(key, (n,), dtype=jnp.float32)
    elif kind == "uniform":
        draw = jax.random.uniform(key, (n,), dtype=jnp.float32)
    else:
        fractions = jsampling._create_fractions(kwargs.get("divisible",
                                                           tuple(range(20, 30))))
        draw = jax.random.randint(key, (n,), 0, fractions.shape[0])
    ours = tsampling.sample_timestep(None, n, name, **extra, **kwargs,
                                     draw=torch.from_numpy(np.array(draw)))
    assert ours.dtype == torch.float32 and ours.shape == (n,)
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=1e-6, atol=1e-6)
    # without a draw the sampler takes the generator's
    gen = torch.Generator().manual_seed(0)
    t = tsampling.sample_timestep(gen, n, name, **extra, **kwargs)
    assert t.shape == (n,) and bool(((t >= 0) & (t <= 1)).all())


def test_discrete_samplers_match_jax():
    key, n = jax.random.key(3), 16
    draw = jax.random.normal(key, (n,), dtype=jnp.float32)
    theirs = np.asarray(jsampling.sigmoid_randint(key, n, 10, 900, 1.5))
    ours = tsampling.sigmoid_randint(None, n, 10, 900, 1.5,
                                     draw=torch.from_numpy(np.array(draw)))
    np.testing.assert_array_equal(ours.numpy(), theirs)
    ints = jax.random.randint(key, (n,), 5, 50, dtype=jnp.int32)
    np.testing.assert_array_equal(
        tsampling.uniform_randint(None, n, 5, 50, draw=torch.from_numpy(np.array(ints))).numpy(),
        np.asarray(jsampling.uniform_randint(key, n, 5, 50)),
    )
    gen = torch.Generator().manual_seed(0)
    g = tsampling.gaussian_randint(gen, 64, 0, 1000)
    assert g.dtype == torch.int32 and int(g.min()) >= 0 and int(g.max()) <= 1000


@pytest.mark.parametrize("clean_at_zero", [False, True])
def test_flow_match_matches_jax(clean_at_zero):
    rng = np.random.default_rng(0)
    latents = rng.normal(size=(3, 8, 8, 3)).astype(np.float32)
    t = rng.uniform(size=(3,)).astype(np.float32)
    key = jax.random.key(5)
    draw = np.array(jax.random.normal(key, latents.shape, dtype=jnp.float32))
    jn, jnoise = jflow.prepare_scaled_noised_latents(
        key, jnp.asarray(latents), jnp.asarray(t), noise_scale=1.7,
        clean_at_zero=clean_at_zero,
    )
    tn, tnoise = tflow.prepare_scaled_noised_latents(
        None, torch.from_numpy(latents), torch.from_numpy(t), noise_scale=1.7,
        clean_at_zero=clean_at_zero, draw=torch.from_numpy(draw.copy()),
    )
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tnoise.numpy(), np.asarray(jnoise), rtol=1e-6, atol=1e-6)
    jn2, _ = jflow.prepare_noised_latents(key, jnp.asarray(latents), jnp.asarray(t), 0.5)
    tn2, _ = tflow.prepare_noised_latents(None, torch.from_numpy(latents),
                                          torch.from_numpy(t), 0.5,
                                          draw=torch.from_numpy(draw))
    np.testing.assert_allclose(tn2.numpy(), np.asarray(jn2), rtol=1e-6, atol=1e-6)
    x0 = rng.normal(size=latents.shape).astype(np.float32)
    for fn in ("convert_x0_to_velocity",):
        theirs = getattr(jflow, fn)(jnp.asarray(x0), jnp.asarray(latents),
                                    jnp.asarray(t), clean_at_zero=clean_at_zero)
        ours = getattr(tflow, fn)(torch.from_numpy(x0), torch.from_numpy(latents),
                                  torch.from_numpy(t), clean_at_zero=clean_at_zero)
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        float(tflow.loss_with_predicted_velocity(torch.from_numpy(latents),
                                                 torch.from_numpy(draw),
                                                 torch.from_numpy(x0))),
        float(jflow.loss_with_predicted_velocity(jnp.asarray(latents),
                                                 jnp.asarray(draw), jnp.asarray(x0))),
        rtol=1e-6,
    )


SCHEDULES = [
    (None, {}),
    ("constant", {}),
    ("constant_with_warmup", {"num_warmup_steps": 4}),
    ("linear", {"num_warmup_steps": 3}),
    ("cosine", {"num_warmup_steps": 4}),
    ("cosine", {}),
    ("cosine_with_restarts", {"num_warmup_steps": 2, "num_cycles": 3}),
    ("polynomial", {"num_warmup_steps": 5, "power": 2.0, "lr_end": 1e-5}),
]


@pytest.mark.parametrize("name,args", SCHEDULES,
                         ids=[f"{s[0]}{i}" for i, s in enumerate(SCHEDULES)])
def test_lr_schedules_match_optax(name, args):
    theirs = jscheduler.get_lr_schedule(2e-3, name, dict(args), total_steps=30)
    ours = tscheduler.get_lr_schedule(2e-3, name, dict(args), total_steps=30)
    steps = range(0, 35)
    np.testing.assert_allclose([ours(s) for s in steps],
                               [float(theirs(s)) for s in steps],
                               rtol=1e-5, atol=1e-12)


def test_adamw_has_optax_defaults():
    p = torch.nn.Parameter(torch.zeros(3))
    opt = get_optimizer("torch.optim.AdamW", [p], {"betas": (0.9, 0.95)}, lr=1e-3)
    group = opt.param_groups[0]
    assert isinstance(opt, torch.optim.AdamW)
    assert (group["weight_decay"], group["eps"], group["betas"]) == (1e-4, 1e-8, (0.9, 0.95))
    # came maps onto optax.contrib.came, which the JAX package's optax lacks
    with pytest.raises(ValueError, match="came not available"):
        get_optimizer("came", [p])


def test_adamw_step_matches_optax():
    """Three AdamW updates with a schedule read at optax's count."""
    rng = np.random.default_rng(0)
    w0 = rng.normal(size=(5,)).astype(np.float32)
    grads = [rng.normal(size=(5,)).astype(np.float32) for _ in range(3)]
    schedule = tscheduler.get_lr_schedule(1e-2, "cosine", {"num_warmup_steps": 1},
                                          total_steps=3)
    tx = optax.adamw(jscheduler.get_lr_schedule(1e-2, "cosine",
                                                {"num_warmup_steps": 1},
                                                total_steps=3))
    jw, state = jnp.asarray(w0), None
    state = tx.init(jw)
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = get_optimizer("adamw", [p])
    for n, g in enumerate(grads):
        upd, state = tx.update(jnp.asarray(g), state, jw)
        jw = optax.apply_updates(jw, upd)
        p.grad = torch.from_numpy(g)
        opt.param_groups[0]["lr"] = schedule(n)
        opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jw), rtol=1e-6, atol=1e-7)


def test_folder_dataset_matches_jax(tmp_path):
    """Same files, same seed: the same pixels and captions, batch by batch,
    through randomised caption processors."""
    from PIL import Image

    from vision_pt_tpu.data.square_class_image import (
        SquareClassImageDatasetConfig as JaxFolder,
    )
    from vision_pt_tpu_torch.data.square_class_image import (
        SquareClassImageDatasetConfig,
    )

    rng = np.random.default_rng(0)
    (tmp_path / "img").mkdir()
    (tmp_path / "tags").mkdir()
    for i, (w, h) in enumerate([(40, 30), (24, 36), (32, 32), (50, 20), (30, 30)]):
        pixels = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        Image.fromarray(pixels).save(tmp_path / "img" / f"{i}.png")
        if i != 4:  # an image without tags is skipped
            (tmp_path / "tags" / f"{i}.json").write_text(json.dumps({
                "rating": "general", "character_tags": {f"char{i}": 1.0},
                "general_tags": {"red": 0.9, f"tag{i}": 0.5, "blue": 0.3},
            }))
    cfg = {
        "folder": str(tmp_path / "img"), "tags_folder": str(tmp_path / "tags"),
        "image_size": 16, "batch_size": 3, "num_repeats": 2, "seed": 5,
        "caption_processors": [
            {"type": "shuffle", "split_separator": " "},
            {"type": "prefix_random", "prefix": ["a ", "b "]},
            {"type": "tag_drop", "drop_rate": 0.3, "separator": ", "},
            {"type": "replace", "source": "red", "target": "crimson"},
        ],
    }
    theirs = JaxFolder.model_validate(cfg).get_dataset()
    ours = SquareClassImageDatasetConfig.model_validate(cfg).get_dataset()
    assert len(ours) == len(theirs) == 3
    for epoch in range(2):
        theirs.set_epoch(epoch)
        ours.set_epoch(epoch)
        for a, b in zip(ours, theirs, strict=True):
            np.testing.assert_array_equal(a["image"], b["image"])
            assert a["image"].shape[1:] == (16, 16, 3)
            assert a["caption"] == b["caption"]


# ------------------------------------------------------------------ parity


def _config_dict(label2id, accumulation):
    return {
        "model": {
            "context_encoder": {"type": "class", "label2id_map_path": label2id},
            "denoiser": TINY,
            "max_token_length": 4,
            "drop_context_rate": 0.3,
        },
        "dataset": {"num_classes": 4, "num_items": BATCH * STEPS,
                    "image_size": SIZE, "batch_size": BATCH},
        "optimizer": {"name": "adamw", "args": {"lr": 2e-3}},
        "scheduler": {"name": "cosine", "args": {"num_warmup_steps": 2}},
        "saving": None,
        "trainer": {"clip_grad_norm": 1.0, "use_ema": True, "ema_decay": 0.9,
                    "gradient_accumulation_steps": accumulation},
        "seed": SEED,
        "num_train_epochs": 1,
    }


def _jax_draws():
    """The timestep and noise draws of JAX trainer steps 1..STEPS:
    ``split(fold_in(fold_in(key(seed), n), 1))``."""
    draws = []
    for n in range(1, STEPS + 1):
        key = jax.random.fold_in(jax.random.key(SEED), n)
        k_t, k_noise = jax.random.split(jax.random.fold_in(key, 1))
        draws.append({
            "timesteps": np.array(jax.random.normal(k_t, (BATCH,), jnp.float32)),
            "noise": np.array(jax.random.normal(
                k_noise, (BATCH, SIZE, SIZE, 3), jnp.float32)),
        })
    return draws


def _record_losses(trainer, losses):
    inner = trainer.train_step

    def recording(*args, **kwargs):
        loss, metrics = inner(*args, **kwargs)
        losses.append(float(loss))
        return loss, metrics

    trainer.train_step = recording


@pytest.fixture(scope="module")
def label2id(tmp_path_factory):
    path = tmp_path_factory.mktemp("labels") / "label2id.json"
    path.write_text(json.dumps({f"c{i}": i for i in range(4)}))
    return str(path)


_JAX_RUNS = {}


def _jax_run(label2id, accumulation):
    """Initial parameters, per-step losses, final parameters and EMA of the
    JAX trainer (cached per accumulation setting)."""
    if accumulation not in _JAX_RUNS:
        cfg = _config_dict(label2id, accumulation)
        config = JaxTrainConfig.model_validate(cfg)
        trainer = JaxTrainer(config)
        trainer.register_train_dataset_class(JaxSynthetic)
        trainer.register_model_class(JaxWorkload)
        trainer.before_train()
        init = {k: np.asarray(v) for k, v in flatten_state(trainer.model.trainable()).items()}
        losses = []
        _record_losses(trainer, losses)
        with jattn.attention_dtype(None):
            trainer.training_loop()
        trainer.sync_module_state()
        final = {k: np.asarray(v) for k, v in flatten_state(trainer.model.trainable()).items()}
        ema = {_path_to_key(tuple(path)): np.asarray(getattr(v, "value", v))
               for path, v in nnx.to_flat_state(trainer.ema_state)}
        _JAX_RUNS[accumulation] = (init, losses, final, ema)
    return _JAX_RUNS[accumulation]


def _port_run(label2id, accumulation, init):
    draws = _jax_draws()

    class Injected(JiTForClassToImageTraining):
        def setup_model(self):
            super().setup_model()
            self.trainable().load_state_dict(from_jax_state(init), strict=True)

        def draw_randoms(self, batch, generator):
            d = draws[self._current_step - 1]
            return {
                "timesteps": tsampling.sample_timestep(
                    generator, BATCH, self.model_config.timestep_sampling,
                    draw=torch.from_numpy(d["timesteps"])),
                "noise": torch.from_numpy(d["noise"]),
            }

    config = TrainConfig.model_validate(_config_dict(label2id, accumulation))
    trainer = Trainer(config, device="cpu")
    trainer.register_train_dataset_class(SyntheticClassImageDatasetConfig)
    trainer.register_model_class(Injected)
    trainer.before_train()
    losses = []
    _record_losses(trainer, losses)
    with tattn.attention_dtype(None):
        trainer.training_loop()
    params = {k: v.detach().numpy() for k, v in trainer.model.trainable().state_dict().items()}
    ema = {k: v.numpy() for k, v in trainer.ema_state.items()}
    return losses, params, ema


def _assert_close_tree(ours, theirs_jax, what):
    theirs = {k: v.numpy() for k, v in from_jax_state(theirs_jax).items()}
    assert ours.keys() == theirs.keys()
    for key in theirs:
        a, b = ours[key], theirs[key]
        err = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12)
        assert err <= 1e-4, f"{what} {key}: relative L2 error {err:.2e}"


@pytest.mark.parametrize("variant", ["plain", "packed_gate", "accumulation"])
def test_training_steps_match_jax(variant, label2id, monkeypatch):
    accumulation = 2 if variant == "accumulation" else 1
    init, jlosses, jfinal, jema = _jax_run(label2id, accumulation)
    if variant == "packed_gate":
        # the context-free block takes the packed attention path, run on
        # the CPU by the plain versions of both kernels
        monkeypatch.setattr(tden, "_on_cuda", lambda x: True)
        monkeypatch.setattr(tden, "MIN_PACKED_SEQ", 1)
        calls = []
        real = tden.short_attention_packed
        monkeypatch.setattr(tden, "short_attention_packed",
                            lambda *a, **k: calls.append(1) or real(*a, **k))
    losses, params, ema = _port_run(label2id, accumulation, init)
    if variant == "packed_gate":
        assert len(calls) == STEPS  # block 0 of each step
    assert len(losses) == len(jlosses) == STEPS
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    _assert_close_tree(params, jfinal, "params")
    _assert_close_tree(ema, jema, "ema")
    moved = [k for k, v in from_jax_state(init).items()
             if not np.array_equal(v.numpy(), params[k])]
    assert len(moved) > len(params) // 2


# ------------------------------------------------------------------ trainer


def _write_synthetic_config(tmp_path, **overrides):
    cfg = yaml.safe_load((ROOT / "configs/jit/synthetic_class_to_image.yml").read_text())
    (tmp_path / "label2id.json").write_text(json.dumps({f"c{i}": i for i in range(4)}))
    cfg["model"]["context_encoder"]["label2id_map_path"] = str(tmp_path / "label2id.json")
    cfg["saving"]["callbacks"][0]["save_dir"] = str(tmp_path / "out")
    cfg["preview"]["callbacks"][0]["save_dir"] = str(tmp_path / "preview")
    cfg["tracker"]["log_dir"] = str(tmp_path / "logs")
    cfg["tracker"]["loggers"] = ["jsonl"]
    cfg["trainer"].update(overrides)
    path = tmp_path / "config.yml"
    path.write_text(yaml.safe_dump(cfg))
    return path, cfg


def test_entry_point_trains_saves_and_previews(tmp_path):
    from vision_pt_tpu_torch.models.jit import JiTConfig, JiTModel
    from vision_pt_tpu_torch.train.jit.class_to_image import run

    path, cfg = _write_synthetic_config(tmp_path)
    trainer = run(str(path), device="cpu")
    assert trainer.global_step == 8  # 64 items / 16 per batch, 2 epochs
    saved = sorted(p.name for p in (tmp_path / "out").iterdir())
    assert saved == ["ema_jit_synth_00002e_000008s.safetensors",
                     "jit_synth_00002e_000008s.safetensors"]
    assert len(list((tmp_path / "preview").iterdir())) == 1
    records = [json.loads(line) for line in
               (tmp_path / "logs/verify_run.metrics.jsonl").read_text().splitlines()]
    steps = [r for r in records if "train/loss" in r]
    assert len(steps) == 8 and all(np.isfinite(r["train/loss"]) for r in steps)
    assert all(0 < r["train/qk_logit_bound"] < 60 for r in steps)
    model = JiTModel.from_pretrained(JiTConfig.model_validate(cfg["model"]),
                                     str(tmp_path / "out" / saved[1]), device="cpu")
    state = trainer.model.model.state_dict()
    for key, value in model.state_dict().items():
        torch.testing.assert_close(value, state[key], rtol=0, atol=0)


def _trainer(tmp_path, num_items=32, image_size=16, batch_size=8,
             context_start_block=0, **trainer):
    path, cfg = _write_synthetic_config(tmp_path, **trainer)
    cfg["model"]["denoiser"].update(patch_size=8, hidden_size=64, depth=2,
                                    num_heads=2, bottleneck_dim=16,
                                    context_dim=32, rope_axes_dims=[8, 12, 12],
                                    context_start_block=context_start_block)
    cfg.update(saving=None, preview=None, tracker=None, scheduler=None,
               num_train_epochs=2)
    cfg["dataset"] = {"num_classes": 4, "num_items": num_items,
                      "image_size": image_size, "batch_size": batch_size}
    trainer = Trainer(TrainConfig.model_validate(cfg), device="cpu")
    trainer.register_train_dataset_class(SyntheticClassImageDatasetConfig)
    trainer.register_model_class(JiTForClassToImageTraining)
    trainer.before_train()
    return trainer


def test_training_loss_decreases(tmp_path):
    trainer = _trainer(tmp_path)
    losses = []
    for _ in range(4):
        for batch in trainer.train_dataset:
            loss, _ = trainer.train_step(trainer.model.prepare_batch(batch),
                                         trainer._next_generator())
            losses.append(float(loss))
    assert np.mean(losses[-4:]) < np.mean(losses[:4])


def test_debug_mode_1step(tmp_path):
    trainer = _trainer(tmp_path, num_items=16, debug_mode="1step")
    trainer.training_loop()
    assert trainer.global_step == 1


@pytest.mark.parametrize("mode", ["dataset", "sanity_check"])
def test_debug_modes_train_nothing(tmp_path, mode, capsys):
    trainer = _trainer(tmp_path, num_items=16, debug_mode=mode)
    before = [p.detach().clone() for p in trainer.model.trainable().parameters()]
    if mode == "dataset":
        trainer.training_loop()
        assert "batch 1: image=(8, 16, 16, 3)" in capsys.readouterr().out
    else:
        trainer.model.sanity_check()
    assert trainer.global_step == 0
    after = list(trainer.model.trainable().parameters())
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_gradient_accumulation_applies_every_k_steps(tmp_path):
    trainer = _trainer(tmp_path, num_items=16, batch_size=4,
                       gradient_accumulation_steps=2, clip_grad_norm=1.0,
                       use_ema=True, ema_decay=0.9)
    first = next(iter(trainer.model.trainable().parameters()))
    name = next(iter(trainer.ema_state))
    snapshots = []
    inner = trainer.train_step

    def observing(batch, generator, at_accum_boundary=True):
        out = inner(batch, generator, at_accum_boundary)
        snapshots.append((at_accum_boundary, first.detach().clone(),
                          trainer.ema_state[name].clone(), trainer._updates))
        assert np.isfinite(float(out[0]))
        return out

    trainer.train_step = observing
    trainer.training_loop()
    assert trainer.global_step == 8
    assert [s[0] for s in snapshots[:4]] == [False, True, False, True]
    assert [s[3] for s in snapshots] == [0, 1, 1, 2, 2, 3, 3, 4]
    # parameters and EMA frozen on non-boundary micro-steps
    assert torch.equal(snapshots[1][1], snapshots[2][1])
    assert torch.equal(snapshots[1][2], snapshots[2][2])
    assert not torch.equal(snapshots[2][2], snapshots[3][2])


def test_gradient_clipping_uses_optax_formula(tmp_path):
    trainer = _trainer(tmp_path, num_items=8, clip_grad_norm=1e-3,
                       clip_grad_value=0.5)
    seen = []
    real = trainer.optimizer.step

    def step():
        grads = [p.grad for p in trainer._params]
        seen.append(float(torch.nn.utils.get_total_norm(grads)))
        assert max(float(g.abs().max()) for g in grads) <= 0.5
        real()

    trainer.optimizer.step = step
    batch = trainer.model.prepare_batch(next(iter(trainer.train_dataset)))
    _, metrics = trainer.train_step(batch, trainer._next_generator())
    assert float(metrics["grad_norm"]) > 1e-3
    np.testing.assert_allclose(seen, [1e-3], rtol=1e-5)


def test_gradient_checkpointing_matches_plain_backward(tmp_path):
    trainer = _trainer(tmp_path, num_items=8)
    batch = trainer.model.prepare_batch(next(iter(trainer.train_dataset)))
    trainable = trainer.model.trainable()
    grads = []
    for remat in (False, True):
        trainable.denoiser.set_gradient_checkpointing(remat)
        draws = trainer.model.draw_randoms(batch, torch.Generator().manual_seed(1))
        loss, _ = trainer.model.compute_loss(trainable, batch, draws)
        trainable.zero_grad(set_to_none=True)
        loss.backward()
        grads.append([p.grad.clone() for p in trainable.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_gradient_checkpointing_recomputes_packed_attention(tmp_path, monkeypatch):
    """With the packed gate open, a checkpointed block runs the attention
    forward twice (forward and recompute) and its backward once."""
    monkeypatch.setattr(tden, "_on_cuda", lambda x: True)
    monkeypatch.setattr(tden, "MIN_PACKED_SEQ", 1)
    trainer = _trainer(tmp_path, num_items=8, gradient_checkpointing=True,
                       context_start_block=1)
    forward, backward = [], []
    real_fwd = short_attention_packed.__globals__["_forward"]
    real_bwd = short_attention_packed.__globals__["short_attention_packed_bwd"]
    monkeypatch.setitem(short_attention_packed.__globals__, "_forward",
                        lambda *a: forward.append(1) or real_fwd(*a))
    monkeypatch.setitem(short_attention_packed.__globals__,
                        "short_attention_packed_bwd",
                        lambda *a: backward.append(1) or real_bwd(*a))
    batch = trainer.model.prepare_batch(next(iter(trainer.train_dataset)))
    loss, _ = trainer.train_step(batch, trainer._next_generator())
    assert np.isfinite(float(loss))
    # block 0 is context-free (packed path); block 1 has a key mask
    assert (len(forward), len(backward)) == (2, 1)
