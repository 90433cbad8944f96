"""The port's latent-cache writer (``data/latent_cache.py:cache_latents`` and
``tools/data/cache_latents.py``) against the JAX package's, on the CPU, on a
folder of synthetic images of three aspect ratios (one 256^2 bucket):

- with the same tiny VAE weights (carried by ``convert.from_jax_state``),
  both writers give the same manifest rows, and means and stds within the
  store's rounding: one fp16 ulp (2^-10 relative) or one bf16 ulp (2^-7),
  plus 1e-5 absolute for the fp32 encode's last bits;
- with an encoder whose arithmetic is exact on both sides, the two caches
  are identical to the byte: manifest text, file names (the JAX package's
  hash) and arrays;
- each package's reader reads the other's cache to the same batches;
- the command-line tool takes the VAE from an sgm single-file checkpoint
  through the port's key conversion, and the port's latent trainer trains
  from the cache it writes.
"""

import json

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
import yaml
from flax import nnx
from PIL import Image

from vision_pt_tpu.data.latent_cache import (
    CachedLatentDatasetConfig as JaxLatentDataset,
)
from vision_pt_tpu.data.latent_cache import cache_latents as jax_cache_latents
from vision_pt_tpu.data.text_to_image import (
    TextToImageDatasetConfig as JaxTextToImageDataset,
)
from vision_pt_tpu.models.sdxl import vae as jvae
from vision_pt_tpu.utils.state_dict import flatten_state
from vision_pt_tpu_torch.data.latent_cache import CachedLatentDatasetConfig, cache_latents
from vision_pt_tpu_torch.data.text_to_image import TextToImageDatasetConfig
from vision_pt_tpu_torch.models.sdxl.convert import from_jax_state
from vision_pt_tpu_torch.models.sdxl.vae import VAE, DiagonalGaussian

TINY_VAE = dict(block_out_channels=(8, 16, 16, 16), layers_per_block=1,
                norm_num_groups=4, latent_channels=4)
SIZES = [(320, 256), (256, 320), (256, 256), (320, 256), (256, 256), (256, 320)]
DATASET = dict(batch_size=2, bucket_base_size=256, step=64, min_size=128, shuffle=False,
               num_workers=2)
STORES = {"float16": (np.float16, torch.float16, 2**-10),
          "bfloat16": (ml_dtypes.bfloat16, torch.bfloat16, 2**-7)}


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    folder = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(0)
    for i, (w, h) in enumerate(SIZES):
        Image.fromarray(rng.integers(0, 255, size=(h, w, 3), dtype=np.uint8)
                        ).save(folder / f"img{i}.png")
        (folder / f"img{i}.txt").write_text(
            " ".join(f"c{(i + j) % 4}" for j in range(1 + i % 3)))
    return str(folder)


def _datasets(folder):
    return (JaxTextToImageDataset(folder=folder, **DATASET).get_dataset(),
            TextToImageDatasetConfig(folder=folder, **DATASET).get_dataset())


def _read(cache_dir):
    rows = [json.loads(line) for line in
            open(f"{cache_dir}/manifest.jsonl").read().splitlines()]
    arrays = []
    for row in rows:
        with np.load(f"{cache_dir}/{row['file']}") as z:
            arrays.append((z["mean"], z["std"]))
    return rows, arrays


def _as_float(array, row):
    if row["dtype"] == "bfloat16":
        array = array.view(ml_dtypes.bfloat16)
    return array.astype(np.float32)


@pytest.mark.parametrize("store", STORES)
def test_cache_matches_jax(folder, store, tmp_path):
    np_dtype, torch_dtype, ulp = STORES[store]
    jmodel = jvae.VAE(**TINY_VAE, rngs=nnx.Rngs(0))
    model = VAE(**TINY_VAE).eval()
    model.load_state_dict(from_jax_state(flatten_state(jmodel)))
    jdata, data = _datasets(folder)
    jax_cache_latents(jdata, jmodel, str(tmp_path / "jax"), dtype=np_dtype,
                      progress=False)
    cache_latents(data, model, str(tmp_path / "port"), dtype=torch_dtype, progress=False)
    theirs, their_arrays = _read(tmp_path / "jax")
    ours, our_arrays = _read(tmp_path / "port")
    assert len(ours) == len(theirs) == len(SIZES)
    for a, b, (am, ast), (bm, bst) in zip(ours, theirs, our_arrays, their_arrays):
        assert {k: v for k, v in a.items() if k != "file"} == \
            {k: v for k, v in b.items() if k != "file"}
        assert a["dtype"] == store and am.dtype == bm.dtype
        for x, y in ((am, bm), (ast, bst)):
            x, y = _as_float(x, a), _as_float(y, b)
            np.testing.assert_allclose(x, y, rtol=ulp, atol=1e-5)
        if am.tobytes()[:256] == bm.tobytes()[:256]:
            assert a["file"] == b["file"]


class _JaxExact(nnx.Module):
    """An encoder exact in fp32 on both sides: the mean is a strided crop
    halved, the logvar 0."""

    scaling_factor = 0.13025

    def encode(self, images):
        x = images[:, ::8, ::8, :]
        mean = jnp.concatenate([x, x[..., :1]], axis=-1) * 0.5
        return jvae.DiagonalGaussian(mean, jnp.zeros_like(mean))


class _Exact(torch.nn.Module):
    scaling_factor = 0.13025

    def __init__(self):
        super().__init__()
        self.anchor = torch.nn.Parameter(torch.zeros(1))

    def encode(self, images):
        x = images[:, ::8, ::8, :]
        mean = torch.cat([x, x[..., :1]], dim=-1) * 0.5
        return DiagonalGaussian(mean, torch.zeros_like(mean))


@pytest.mark.parametrize("store", STORES)
def test_same_outputs_give_the_same_cache_bytes(folder, store, tmp_path):
    np_dtype, torch_dtype, _ = STORES[store]
    jdata, data = _datasets(folder)
    jax_cache_latents(jdata, _JaxExact(), str(tmp_path / "jax"), dtype=np_dtype,
                      progress=False)
    cache_latents(data, _Exact(), str(tmp_path / "port"), dtype=torch_dtype,
                  progress=False)
    assert (tmp_path / "port/manifest.jsonl").read_text() == \
        (tmp_path / "jax/manifest.jsonl").read_text()
    theirs, their_arrays = _read(tmp_path / "jax")
    ours, our_arrays = _read(tmp_path / "port")
    for (am, ast), (bm, bst) in zip(our_arrays, their_arrays):
        assert am.dtype == bm.dtype
        assert am.tobytes() == bm.tobytes() and ast.tobytes() == bst.tobytes()


@pytest.mark.parametrize("store", STORES)
def test_readers_read_each_others_cache(folder, store, tmp_path):
    np_dtype, torch_dtype, _ = STORES[store]
    model = VAE(**TINY_VAE, generator=torch.Generator().manual_seed(3)).eval()
    cache_latents(_datasets(folder)[1], model, str(tmp_path / "port"),
                  dtype=torch_dtype, progress=False)
    cfg = {"cache_dir": str(tmp_path / "port"), "batch_size": 2, "shuffle": True,
           "seed": 3, "num_workers": 2}
    theirs = JaxLatentDataset.model_validate(cfg).get_dataset()
    ours = CachedLatentDatasetConfig.model_validate(cfg).get_dataset()
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs, strict=True):
        assert a.keys() == b.keys()
        assert a["latents"].shape[-1] == 4 and np.isfinite(a["latents"]).all()
        for key in a:
            if isinstance(a[key], np.ndarray):
                np.testing.assert_array_equal(a[key], b[key])
            else:
                assert a[key] == b[key]


def test_tool_takes_the_checkpoint_and_the_trainer_reads_its_cache(folder, tmp_path):
    """``python -m vision_pt_tpu_torch.tools.data.cache_latents`` with an sgm
    checkpoint of the tiny SDXL writes what ``cache_latents`` writes with that
    model's VAE; the latent trainer then trains 3 steps from it."""
    from safetensors.numpy import save_file

    from tests.test_torch_latent import LATENT_CONFIG, TINY_LATENT
    from tests.test_torch_sdxl_training import TINY_MODEL
    from vision_pt_tpu_torch.models.sdxl import SDXLConfig, SDXLModel
    from vision_pt_tpu_torch.tools.data.cache_latents import main
    from vision_pt_tpu_torch.train.jit.latent_class_to_image import run

    sdxl = SDXLModel.from_config(SDXLConfig(**TINY_MODEL), seed=4, device="cpu")
    checkpoint = tmp_path / "tiny.safetensors"
    save_file({k: np.ascontiguousarray(v.numpy()) for k, v in sdxl.state_dict().items()},
              str(checkpoint))
    with pytest.raises(SystemExit) as exit_info:
        main(["--folder", folder, "--cache-dir", str(tmp_path / "tool"),
              "--checkpoint", str(checkpoint), "--vae-config", json.dumps(TINY_VAE),
              "--bucket-base-size", "256", "--min-size", "128", "--batch-size", "2",
              "--num-workers", "2", "--device", "cpu"])
    assert exit_info.value.code == 0
    cache_latents(_datasets(folder)[1], sdxl.vae, str(tmp_path / "direct"),
                  progress=False)
    tool_rows, tool_arrays = _read(tmp_path / "tool")
    rows, arrays = _read(tmp_path / "direct")
    assert tool_rows == rows
    for (am, ast), (bm, bst) in zip(tool_arrays, arrays):
        np.testing.assert_array_equal(am, bm)
        np.testing.assert_array_equal(ast, bst)

    label2id = tmp_path / "label2id.json"
    label2id.write_text(json.dumps({f"c{i}": i for i in range(4)}))
    cfg = yaml.safe_load(LATENT_CONFIG.read_text())
    cfg["model"]["denoiser"].update(TINY_LATENT)
    cfg["model"]["context_encoder"]["label2id_map_path"] = str(label2id)
    cfg["model"]["max_token_length"] = 4
    cfg["dataset"].update(cache_dir=str(tmp_path / "tool"), batch_size=2)
    cfg["saving"]["callbacks"][0]["save_dir"] = str(tmp_path / "out")
    cfg["tracker"]["log_dir"] = str(tmp_path / "logs")
    cfg["num_train_epochs"] = 1
    path = tmp_path / "latent.yml"
    path.write_text(yaml.safe_dump(cfg))
    trainer = run(str(path), device="cpu")
    assert trainer.global_step == 3  # 6 latents, batches of 2
    records = [json.loads(line) for line in
               (tmp_path / "logs/JiT/latent-1024.metrics.jsonl").read_text().splitlines()]
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    assert len(losses) == 3 and np.isfinite(losses).all()
