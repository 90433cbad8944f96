"""The port stands alone: it imports nothing of JAX, Flax, Optax or the JAX
package, and its entry points run on the CUDA device unless the caller asks
for the CPU."""

import json
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "vision_pt_tpu_torch"
FORBIDDEN = re.compile(r"^(jax|jaxlib|flax|optax|vision_pt_tpu)(\.|$)")

_PROBE = """
import importlib, json, pkgutil, sys
import vision_pt_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    vision_pt_tpu_torch.__path__, "vision_pt_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print(json.dumps({"imported": names, "modules": sorted(sys.modules)}))
"""


def test_importing_the_whole_port_loads_no_jax():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True,
        text=True, check=True, timeout=120,
    )
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert "vision_pt_tpu_torch.models.jit.pipeline" in report["imported"]
    assert "vision_pt_tpu_torch.ops.short_attention" in report["imported"]
    assert "vision_pt_tpu_torch.training.trainer" in report["imported"]
    assert "vision_pt_tpu_torch.train.jit.class_to_image" in report["imported"]
    for name in ("ops.flash_attention", "data.latent_cache",
                 "workloads.jit_variants", "train.jit.latent_class_to_image",
                 "ops.quant.nf4", "ops.quant.nf4_matmul", "ops.quant.layers",
                 "ops.quant.functional", "ops.long_prompt", "ops.linear",
                 "utils.state_dict", "models.sdxl.config",
                 "models.sdxl.text_encoder", "models.sdxl.denoiser",
                 "models.sdxl.vae", "models.sdxl.scheduler",
                 "models.sdxl.convert", "models.sdxl.pipeline",
                 "tools.inference_cli", "tools.bench",
                 "tools.bench.attention_pairing_probe",
                 "tools.bench.attention_roofline", "benchmarks",
                 "models.jit.extension.pope", "models.jit.extension.uvit",
                 "models.jit.extension.cross", "models.jit.extension.ig",
                 "models.jit.extension.loig", "models.jit.extension.tread",
                 "train.jit.arb_class_to_image",
                 "train.jit.arb_class_to_image_ujit",
                 "train.jit.class_to_image_ujit",
                 "train.jit.class_to_image_cross",
                 "train.jit.class_to_image_ig",
                 "train.jit.class_to_image_loig",
                 "train.jit.class_to_image_tread", "models.lm.model",
                 "models.cogview4.config", "models.cogview4.text_encoder",
                 "models.cogview4.denoiser", "models.cogview4.pipeline",
                 "ops.offload", "tools.cogview4_quant_compare", "ops.rope",
                 "models.sdxl.adapter.rope", "models.sdxl.adapter.style_tokenizer",
                 "adapters.style_tokenizer", "reward", "reward.utils", "reward.pickscore",
                 "reward.functional", "workloads.sdxl_rope_distill",
                 "workloads.sdxl_draft_plus", "workloads.sdxl_style_tokenizer",
                 "train.sdxl.rope_distill", "train.sdxl.draft_plus",
                 "train.sdxl.style_tokenizer", "tools.bench.draft_plus_gap",
                 "utils.memory", "utils.safetensors", "utils.grid", "utils.video",
                 "tools.quantize_model", "tools.inference_server",
                 "tools.inference_client", "tools.snapshot_max_memory",
                 "tools.bench.check_memory", "tools.bench.sdxl_quant",
                 "tools.checkpoint.import_sdxl", "tools.checkpoint.change_dtype",
                 "tools.checkpoint.to_safetensors", "tools.model.inspect_weights",
                 "tools.model.expand_patch_embed", "tools.visualize.images_to_gif",
                 "tools.data.create_buckets_cache", "tools.data.create_label2id",
                 "tools.data.create_label2id_sfw", "models.jit.text_encoder",
                 "ops.loss", "ops.loss.shortcut", "ops.loss.perceptual",
                 "ops.timestep", "ops.timestep.schedule", "data.native_image",
                 "data.worker_pool", "data.datapool", "data.text_to_image",
                 "tools.data.download"):
        assert f"vision_pt_tpu_torch.{name}" in report["imported"]
    leaked = [m for m in report["modules"] if FORBIDDEN.match(m)]
    assert leaked == []


def test_port_sources_import_no_jax():
    pattern = re.compile(
        r"^\s*(?:from|import)\s+(jax|jaxlib|flax|optax|vision_pt_tpu)\b(?!_torch)",
        re.M,
    )
    offenders = [
        str(path.relative_to(ROOT))
        for path in sorted(PORT.rglob("*.py"))
        if pattern.search(path.read_text())
    ]
    assert offenders == []


def test_chip_smoke_imports_no_jax():
    pattern = re.compile(
        r"^\s*(?:from|import)\s+(jax|jaxlib|flax|optax|vision_pt_tpu)\b(?!_torch)",
        re.M,
    )
    assert not pattern.search((ROOT / "chip_smoke.py").read_text())


def test_kernel_sources_build_from_the_package_alone():
    """Every CUDA source and header of ``csrc`` (``hopper.cuh`` among them)
    includes only headers of ``csrc`` or of the toolkit, and each library's
    name hashes its source and every header, so an edit of a shared header
    rebuilds every kernel."""
    import hashlib

    from vision_pt_tpu_torch.ops import _build

    csrc = PORT / "csrc"
    headers = sorted(csrc.glob("*.cuh"))
    assert "hopper.cuh" in {h.name for h in headers}
    for path in sorted(csrc.glob("*.cu")) + headers:
        for name in re.findall(r'^#include "([^"]+)"', path.read_text(), re.M):
            assert (csrc / name).exists(), (path.name, name)
    for src in sorted(csrc.glob("*.cu")):
        digest = hashlib.sha256(src.read_bytes())
        for header in headers:
            digest.update(header.read_bytes())
        assert _build._target(src.stem)[1].name == (
            f"lib{src.stem}-{digest.hexdigest()[:16]}.so")


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda(no_cuda, tmp_path):
    from vision_pt_tpu_torch.models.jit import (
        ClassContextConfig,
        DenoiserConfig,
        JiTConfig,
        JiTModel,
    )
    from vision_pt_tpu_torch.config import TrainConfig
    from vision_pt_tpu_torch.models.jit import TextContextConfig
    from vision_pt_tpu_torch.models.sdxl import SDXLConfig, SDXLModel
    from vision_pt_tpu_torch.ops.loss.perceptual import LPIPS, PerceptualLoss
    from vision_pt_tpu_torch.tools.checkpoint.import_sdxl import run_import
    from vision_pt_tpu_torch.tools.inference_cli import main as inference_main
    from vision_pt_tpu_torch.tools.inference_server import T2IModel
    from vision_pt_tpu_torch.tools.quantize_model import quantize_file
    from vision_pt_tpu_torch.train.jit.class_to_image import run
    from vision_pt_tpu_torch.train.jit.latent_class_to_image import (
        run as latent_run,
    )
    from vision_pt_tpu_torch.training.trainer import Trainer
    from vision_pt_tpu_torch.utils import resolve_device

    label2id = tmp_path / "label2id.json"
    label2id.write_text(json.dumps({"c0": 0}))
    config = JiTConfig(
        context_encoder=ClassContextConfig(label2id_map_path=str(label2id)),
        denoiser=DenoiserConfig(patch_size=4, hidden_size=64, depth=1,
                                num_heads=2, rope_axes_dims=[8, 12, 12]),
    )
    train_config = {"model": config.model_dump(), "dataset": {"type": "synthetic"}}
    yml = tmp_path / "train.yml"
    yml.write_text(json.dumps(train_config))  # JSON is YAML
    server_yml = tmp_path / "server.yml"
    server_yml.write_text(json.dumps({"model": {"checkpoint_path": str(tmp_path / "w"),
                                                "tokenizer": "word-hash"},
                                      "dataset": {}}))
    weights = tmp_path / "w.safetensors"
    from safetensors.numpy import save_file

    save_file({"model.diffusion_model.a.weight": np.ones((2, 2), np.float32)},
              str(weights))
    for make in (
        lambda: resolve_device(None),
        lambda: JiTModel.new_with_config(config),
        lambda: JiTModel(config),
        lambda: JiTModel(config.model_copy(update={"context_encoder": TextContextConfig(
            pretrained_model=str(tmp_path))})),
        lambda: LPIPS(params={"convs": [], "lins": []}),
        lambda: PerceptualLoss({"lpips": 1.0}, lpips_weights_path=str(tmp_path / "w.pth")),
        lambda: JiTModel.from_pretrained(config, str(tmp_path / "missing.safetensors")),
        lambda: Trainer(TrainConfig.model_validate(train_config)),
        lambda: run(str(yml)),
        lambda: latent_run(str(yml)),
        lambda: SDXLModel(SDXLConfig(checkpoint_path="")),
        lambda: SDXLModel.from_config(SDXLConfig(checkpoint_path="")),
        lambda: inference_main(["--checkpoint-path", str(tmp_path / "missing"),
                                "--tokenizer", "word-hash"]),
        lambda: T2IModel(str(server_yml)),
        lambda: quantize_file(str(weights), str(tmp_path / "out.safetensors")),
        lambda: run_import(SDXLConfig(checkpoint_path=str(weights)), str(tmp_path)),
    ):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    assert resolve_device("cpu") == torch.device("cpu")
