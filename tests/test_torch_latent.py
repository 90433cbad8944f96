"""The port's latent JiT path against the JAX package's, on the CPU.

- a cache written by JAX's ``cache_latents`` (tiny VAE, fp16 and bf16) gives
  bit-equal batches through both packages' ``CachedLatentDatasetConfig``,
  epoch after epoch;
- the denoiser of a tiny latent config (patch 2, 4 channels, a 64 x 64
  latent, so S >= 1024) with both flash gates opened on the CPU: JAX runs its
  Pallas flash kernel in interpret mode, the port its plain versions;
  >= 60 dB fp32 and >= 50 dB bf16, as for the pixel-space denoiser;
- five steps of the JAX Trainer and the port's Trainer with the ARB workload
  (lowres loss on) over one cached-latent dataset, from the same weights and
  draws: losses and final parameters within 1e-4 relative, as for the pixel
  trainer;
- the sanity-check repair, on both sides; ``configs/jit/latent_arb_1024.yml``
  through both config schemas and the weight converter at its full size; the
  entry point end to end on a tiny copy of that config.
"""

import hashlib
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax import nnx

import vision_pt_tpu.models.jit.denoiser as jden
import vision_pt_tpu.ops.attention as jattn
from vision_pt_tpu.config import TrainConfig as JaxTrainConfig
from vision_pt_tpu.data.latent_cache import (
    CachedLatentDatasetConfig as JaxLatentDataset,
)
from vision_pt_tpu.models.jit.config import DenoiserConfig as JaxDenoiserConfig
from vision_pt_tpu.training.trainer import Trainer as JaxTrainer
from vision_pt_tpu.utils.state_dict import flatten_state
from vision_pt_tpu.workloads.jit_class_to_image import (
    JiTForClassToImageTraining as JaxClassWorkload,
)
from vision_pt_tpu.workloads.jit_variants import (
    JiTConfigForArbTraining as JaxArbConfig,
    JiTForArbClassToImageTraining as JaxArbWorkload,
)
import vision_pt_tpu_torch.models.jit.denoiser as tden
from vision_pt_tpu_torch.config import TrainConfig
from vision_pt_tpu_torch.data.latent_cache import (
    CachedLatentDatasetConfig,
    cache_latents,
)
from vision_pt_tpu_torch.models.jit.convert import from_jax_state
from vision_pt_tpu_torch.ops import attention as tattn
from vision_pt_tpu_torch.ops.timestep import sampling as tsampling
from vision_pt_tpu_torch.training.trainer import Trainer
from vision_pt_tpu_torch.workloads.jit_class_to_image import (
    JiTForClassToImageTraining,
)
from vision_pt_tpu_torch.workloads.jit_variants import (
    JiTConfigForArbTraining,
    JiTForArbClassToImageTraining,
    _area_downsample,
)
from tests.test_torch_jit_denoiser import FLOOR_DB, make_pair, psnr

ROOT = pathlib.Path(__file__).resolve().parent.parent
LATENT_CONFIG = ROOT / "configs/jit/latent_arb_1024.yml"
TINY_LATENT = dict(patch_size=2, in_channels=4, out_channels=4, hidden_size=64,
                   depth=2, num_heads=2, bottleneck_dim=16, context_dim=32,
                   context_start_block=0, rope_axes_dims=[8, 12, 12],
                   num_time_tokens=2)
SEED, BATCH, SIDE, STEPS = 0, 4, 16, 5


def write_cache(cache_dir, num_items, side, seed=0, dtype="float16"):
    """A latent cache in the JAX package's layout: (side, side, 4) mean and
    std per item, captions over four classes with 1-3 tags."""
    rng = np.random.default_rng(seed)
    cache_dir = pathlib.Path(cache_dir)
    cache_dir.mkdir(parents=True, exist_ok=True)
    rows = []
    for i in range(num_items):
        mean = rng.normal(size=(side, side, 4)).astype(np.float16)
        std = rng.uniform(0.05, 0.3, size=(side, side, 4)).astype(np.float16)
        caption = " ".join(f"c{(i + j) % 4}" for j in range(1 + i % 3))
        row = {"caption": caption, "height": 8 * side, "width": 8 * side,
               "original_size": [8 * side, 8 * side],
               "target_size": [8 * side, 8 * side],
               "crop_coords_top_left": [0, 0], "scaling_factor": 0.13025,
               "dtype": dtype}
        name = hashlib.sha1(f"{i}".encode()).hexdigest() + ".npz"
        np.savez(cache_dir / name, mean=mean, std=std)
        rows.append({**row, "file": name, "latent_height": side,
                     "latent_width": side})
    (cache_dir / "manifest.jsonl").write_text(
        "".join(json.dumps(r) + "\n" for r in rows))
    return str(cache_dir)


@pytest.fixture(scope="module")
def label2id(tmp_path_factory):
    path = tmp_path_factory.mktemp("labels") / "label2id.json"
    path.write_text(json.dumps({f"c{i}": i for i in range(4)}))
    return str(path)


# ------------------------------------------------------------------ data


@pytest.fixture(scope="module")
def jax_caches(tmp_path_factory):
    """Caches written by the JAX package's ``cache_latents`` with the tiny
    VAE of ``tests/test_latent_cache.py``, in fp16 and bf16."""
    import ml_dtypes
    from PIL import Image

    from vision_pt_tpu.data.latent_cache import cache_latents as jax_cache_latents
    from vision_pt_tpu.data.text_to_image import TextToImageDatasetConfig
    from vision_pt_tpu.models.sdxl.vae import VAE
    from tests.test_latent_cache import TINY_VAE

    root = tmp_path_factory.mktemp("latent_cache")
    folder = root / "imgs"
    folder.mkdir()
    rng = np.random.default_rng(0)
    for i, (w, h) in enumerate([(320, 256), (256, 320), (256, 256), (320, 256),
                                (256, 256), (256, 320)]):
        Image.fromarray(rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)
                        ).save(folder / f"img{i}.png")
        (folder / f"img{i}.txt").write_text(f"caption {i}, tag{i % 2}")
    dataset = TextToImageDatasetConfig(
        folder=str(folder), batch_size=2, bucket_base_size=256, step=64,
        min_size=128, shuffle=False,
    ).get_dataset()
    vae = VAE(**TINY_VAE, rngs=nnx.Rngs(0))
    caches = {}
    for name, dtype in (("float16", np.float16), ("bfloat16", ml_dtypes.bfloat16)):
        caches[name] = str(root / name)
        jax_cache_latents(dataset, vae, caches[name], progress=False, dtype=dtype)
    return caches


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_datasets_read_one_cache_bit_equal(jax_caches, dtype):
    cfg = {"cache_dir": jax_caches[dtype], "batch_size": 2, "shuffle": True,
           "seed": 3, "num_workers": 2,
           "caption_processors": [{"type": "shuffle"}]}
    theirs = JaxLatentDataset.model_validate(cfg).get_dataset()
    ours = CachedLatentDatasetConfig.model_validate(cfg).get_dataset()
    assert len(ours) == len(theirs) >= 3
    first = None
    for epoch in range(2):
        theirs.set_epoch(epoch)
        ours.set_epoch(epoch)
        batches = []
        for a, b in zip(ours, theirs, strict=True):
            assert a.keys() == b.keys()
            assert a["latents"].dtype == np.float32 and a["latents"].shape[-1] == 4
            for key in a:
                if isinstance(a[key], np.ndarray):
                    np.testing.assert_array_equal(a[key], b[key])
                else:
                    assert a[key] == b[key]
            batches.append(a["latents"])
        if first is None:
            first = batches
    # a new epoch draws new latents from the same distributions
    assert not any(np.array_equal(x, y) for x, y in zip(first, batches)
                   if x.shape == y.shape)


def test_cache_latents_waits_for_the_vae():
    """The writer takes a VAE and stores fp16 or bf16 only (the writer
    itself: tests/test_torch_cache_latents.py)."""
    with pytest.raises(ValueError, match="float16 or bfloat16"):
        cache_latents(None, None, "unused", dtype=torch.float32)


def test_area_downsample_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 8, 12, 4)).astype(np.float32)
    ours = _area_downsample(torch.from_numpy(x), 0.25).numpy()
    theirs = np.asarray(nnx.avg_pool(jnp.asarray(x), window_shape=(4, 4),
                                     strides=(4, 4)))
    np.testing.assert_allclose(ours, theirs, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------------ denoiser


@pytest.fixture
def flash_on_cpu(monkeypatch):
    """Open both flash gates on the CPU: the JAX dispatcher runs its Pallas
    kernel in interpret mode (the dispatcher passes ``interpret=`` itself, so
    the wrapper overrides it), the port's wrapper its plain versions."""
    real_jax, real_port = jattn.flash_attention, tattn.flash_attention
    calls = {"jax": 0, "port": 0}

    def jax_flash(*args, **kwargs):
        calls["jax"] += 1
        return real_jax(*args, **{**kwargs, "interpret": True})

    def port_flash(*args, **kwargs):
        calls["port"] += 1
        return real_port(*args, **kwargs)

    monkeypatch.setattr(jattn, "_on_tpu", lambda: True)
    monkeypatch.setattr(jattn, "flash_attention", jax_flash)
    monkeypatch.setattr(tattn, "_on_cuda", lambda x: True)
    monkeypatch.setattr(tattn, "flash_attention", port_flash)
    return calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_latent_denoiser_parity_through_flash(flash_on_cpu, dtype):
    cfg = {**TINY_LATENT, "num_heads": 1, "rope_axes_dims": [16, 24, 24]}
    jmodel, tmodel = make_pair(dtype, **cfg)
    rng = np.random.default_rng(1)
    inputs = dict(
        image=rng.normal(size=(2, 64, 64, 4)).astype(np.float32),
        timestep=rng.uniform(0, 1, size=2).astype(np.float32),
        context=rng.normal(size=(2, 4, 32)).astype(np.float32),
        original_size=np.full((2, 2), 512, np.float32),
        target_size=np.full((2, 2), 512, np.float32),
        crop_coords=np.zeros((2, 2), np.float32),
    )
    mask = np.array([[1, 1, 1, 0], [1, 0, 0, 0]], np.int32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    tin = {k: torch.from_numpy(v) for k, v in inputs.items()}
    jin["image"], tin["image"] = jin["image"].astype(jdt), tin["image"].to(tdt)
    with jattn.attention_dtype(None), tattn.attention_dtype(None):
        theirs = jmodel(**jin, context_mask=jnp.asarray(mask))
        with torch.no_grad():
            ours = tmodel(**tin, context_mask=torch.from_numpy(mask))
    # S = 1024 patches + 6 + 2 time + 4 context tokens: every block is flash
    assert flash_on_cpu == {"jax": cfg["depth"], "port": cfg["depth"]}
    assert ours.shape == (2, 64, 64, 4) and ours.dtype == tdt
    value = psnr(ours.float().numpy(), np.asarray(theirs.astype(jnp.float32)))
    assert value >= FLOOR_DB[dtype], value


# ------------------------------------------------------------------ trainer


def _config_dict(label2id, cache_dir):
    return {
        "model": {
            "context_encoder": {"type": "class", "label2id_map_path": label2id},
            "denoiser": TINY_LATENT,
            "max_token_length": 4,
            "drop_context_rate": 0.3,
            "lowres_loss": [0.5],
        },
        "dataset": {"cache_dir": cache_dir, "batch_size": BATCH, "seed": 2,
                    "num_workers": 2},
        "optimizer": {"name": "adamw", "args": {"lr": 2e-3}},
        "scheduler": {"name": "cosine", "args": {"num_warmup_steps": 2}},
        "saving": None,
        "trainer": {"clip_grad_norm": 1.0},
        "seed": SEED,
        "num_train_epochs": 1,
    }


def _jax_draws():
    """The draws of JAX trainer steps 1..STEPS, as the ARB workload splits
    them: ``split(fold_in(fold_in(key(seed), n), 1))``."""
    draws = []
    for n in range(1, STEPS + 1):
        key = jax.random.fold_in(jax.random.key(SEED), n)
        k_t, k_noise = jax.random.split(jax.random.fold_in(key, 1))
        draws.append({
            "timesteps": np.array(jax.random.normal(k_t, (BATCH,), jnp.float32)),
            "noise": np.array(jax.random.normal(
                k_noise, (BATCH, SIDE, SIDE, 4), jnp.float32)),
        })
    return draws


def _recording(trainer, losses):
    inner = trainer.train_step

    def recording(*args, **kwargs):
        loss, metrics = inner(*args, **kwargs)
        losses.append(float(loss))
        return loss, metrics

    trainer.train_step = recording


def test_latent_trainer_matches_jax(label2id, tmp_path):
    cache = write_cache(tmp_path / "cache", BATCH * STEPS, SIDE)
    cfg = _config_dict(label2id, cache)

    jtrainer = JaxTrainer(JaxTrainConfig.model_validate(cfg))
    jtrainer.register_train_dataset_class(JaxLatentDataset)
    jtrainer.register_model_class(JaxArbWorkload)
    jtrainer.before_train()
    init = {k: np.asarray(v) for k, v in flatten_state(jtrainer.model.trainable()).items()}
    jlosses = []
    _recording(jtrainer, jlosses)
    with jattn.attention_dtype(None):
        jtrainer.training_loop()
    jtrainer.sync_module_state()
    jfinal = from_jax_state(flatten_state(jtrainer.model.trainable()))

    draws = _jax_draws()

    class Injected(JiTForArbClassToImageTraining):
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

    trainer = Trainer(TrainConfig.model_validate(cfg), device="cpu")
    trainer.register_train_dataset_class(CachedLatentDatasetConfig)
    trainer.register_model_class(Injected)
    trainer.before_train()
    losses = []
    _recording(trainer, losses)
    with tattn.attention_dtype(None):
        trainer.training_loop()

    assert len(losses) == len(jlosses) == STEPS
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    params = trainer.model.trainable().state_dict()
    assert params.keys() == jfinal.keys()
    start = from_jax_state(init)
    moved = 0
    for key, theirs in jfinal.items():
        ours, theirs = params[key].detach().numpy(), theirs.numpy()
        err = np.linalg.norm(ours - theirs) / max(np.linalg.norm(theirs), 1e-12)
        assert err <= 1e-4, f"{key}: relative L2 error {err:.2e}"
        moved += not np.array_equal(start[key].numpy(), ours)
    assert moved > len(params) // 2


# ------------------------------------------------------------------ repair


def test_sanity_check_repair(label2id):
    """The JAX package's check feeds a 3-channel image and fails for a
    4-channel latent model; the port's takes the denoiser's channels."""
    cfg = JaxTrainConfig.model_validate(_config_dict(label2id, "unused"))
    jax_workload = JaxClassWorkload(cfg)
    jax_workload.setup_model()
    with pytest.raises(TypeError, match="dot_general"):
        jax_workload.sanity_check()

    for denoiser in (TINY_LATENT, {**TINY_LATENT, "in_channels": 3,
                                   "out_channels": 3, "patch_size": 24}):
        tcfg = TrainConfig.model_validate(
            _config_dict(label2id, "unused") | {"model": {
                **_config_dict(label2id, "unused")["model"], "denoiser": denoiser}})
        workload = JiTForClassToImageTraining(tcfg, torch.device("cpu"))
        workload.setup_model()
        workload.sanity_check()


# ------------------------------------------------------------------ config


def test_latent_config_through_both_schemas_and_the_converter():
    """``latent_arb_1024.yml`` as shipped: depth 24, hidden 768, 12 heads,
    patch 2, 4 channels, context from block 0; the JAX parameters of that
    model (shapes only) map onto the port's, key for key."""
    model = yaml.safe_load(LATENT_CONFIG.read_text())["model"]
    jcfg = JaxArbConfig.model_validate(model).denoiser
    tcfg = JiTConfigForArbTraining.model_validate(model).denoiser
    assert jcfg.model_dump() == tcfg.model_dump()
    assert (tcfg.depth, tcfg.hidden_size, tcfg.num_heads, tcfg.patch_size,
            tcfg.in_channels, tcfg.context_start_block, tcfg.num_time_tokens) == (
        24, 768, 12, 2, 4, 0, 4)

    abstract = nnx.eval_shape(
        lambda: jden.Denoiser(JaxDenoiserConfig(**jcfg.model_dump()),
                              rngs=nnx.Rngs(0)))
    converted = {}
    for key, value in flatten_state(abstract).items():
        # one parameter at a time: the model is 175 M parameters
        ((name, tensor),) = from_jax_state(
            {key: np.zeros(value.shape, np.float32)}).items()
        converted[name] = tuple(tensor.shape)
    with torch.device("meta"):
        port = tden.Denoiser(tcfg, device="meta")
    expected = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    assert converted == expected
    assert converted["patch_embedder.proj_1.weight"] == (128, 16)
    assert sum(int(np.prod(s)) for s in converted.values()) > 170_000_000


# ------------------------------------------------------------------ entry


def test_entry_point_trains_and_saves(label2id, tmp_path):
    from vision_pt_tpu_torch.models.jit import JiTConfig, JiTModel
    from vision_pt_tpu_torch.train.jit.latent_class_to_image import run

    cfg = yaml.safe_load(LATENT_CONFIG.read_text())
    cfg["model"]["denoiser"].update(TINY_LATENT)
    cfg["model"]["context_encoder"]["label2id_map_path"] = label2id
    cfg["model"]["max_token_length"] = 4
    cfg["dataset"].update(cache_dir=write_cache(tmp_path / "cache", 8, 8),
                          batch_size=4)
    cfg["saving"]["callbacks"][0]["save_dir"] = str(tmp_path / "out")
    cfg["tracker"]["log_dir"] = str(tmp_path / "logs")
    cfg["num_train_epochs"] = 1
    path = tmp_path / "latent.yml"
    path.write_text(yaml.safe_dump(cfg))
    trainer = run(str(path), device="cpu")
    assert trainer.global_step == 2
    saved = sorted(p.name for p in (tmp_path / "out").iterdir())
    assert saved == ["jit-latent-1024_00001e_000002s.safetensors"]
    records = [json.loads(line) for line in
               (tmp_path / "logs/JiT/latent-1024.metrics.jsonl").read_text().splitlines()]
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    assert len(losses) == 2 and np.isfinite(losses).all()
    model = JiTModel.from_pretrained(JiTConfig.model_validate(cfg["model"]),
                                     str(tmp_path / "out" / saved[0]), device="cpu")
    state = trainer.model.model.state_dict()
    for key, value in model.state_dict().items():
        torch.testing.assert_close(value, state[key], rtol=0, atol=0)
