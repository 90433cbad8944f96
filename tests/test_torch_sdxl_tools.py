"""The port's SDXL checkpoint-import and quantization-bench tools
(``vision_pt_tpu_torch/tools/checkpoint/import_sdxl.py``,
``vision_pt_tpu_torch/tools/bench/sdxl_quant.py``) against the JAX package's
(``tools/checkpoint/import_sdxl.py``, ``tools/bench/sdxl_quant.py``), loaded
by path and called in-process on the tiny SDXL of ``test_torch_sdxl.py``.

Tolerance: the import tool's image statistic 0.05 (a pixel standard
deviation over uint8 images from fp32 samplers that agree within 1e-4, so
within one level); everything else exactly.
"""

import json

import numpy as np
import pytest
import torch

from tests.test_torch_tools import jax_tool


@pytest.fixture(scope="module")
def tiny_checkpoint(tmp_path_factory):
    """The tiny SDXL of ``tests/test_torch_sdxl.py`` written by the JAX
    package in the sgm layout, with its config."""
    from flax import nnx
    from safetensors.numpy import save_file

    from tests.test_torch_sdxl import TINY_MODEL
    from vision_pt_tpu.models.sdxl import SDXLModel as JSDXLModel
    from vision_pt_tpu.models.sdxl.config import SDXLConfig as JSDXLConfig

    jmodel = JSDXLModel.from_config(JSDXLConfig(**TINY_MODEL), rngs=nnx.Rngs(0))
    sd = {k: np.ascontiguousarray(v) for k, v in jmodel.state_dict().items()}
    q_key = "first_stage_model.encoder.mid.attn_1.q.weight"
    sd[q_key] = sd[q_key][:, :, None, None]
    path = str(tmp_path_factory.mktemp("tiny") / "tiny_sdxl.safetensors")
    save_file(sd, path)
    return path, jmodel


def test_import_sdxl_matches_jax(tiny_checkpoint, tmp_path, monkeypatch):
    """Both tools' ``run_import`` on one sgm file: strict load, a denoiser
    forward at the full latent shape, a 2-step fp32 generate (the port given
    the JAX sampler's draws for the seed) whose image statistics agree; then
    the port's quant matrix."""
    import types

    import jax.numpy as jnp
    from flax import nnx

    from tests.test_torch_sdxl import TINY_MODEL, _jax_draws
    from vision_pt_tpu.models.sdxl.config import SDXLConfig as JSDXLConfig
    from vision_pt_tpu.models.sdxl.scheduler import Scheduler as JScheduler
    from vision_pt_tpu_torch.models.sdxl import SDXLConfig, SDXLModel, WordHashTokenizer
    from vision_pt_tpu_torch.ops import attention as tattn
    from vision_pt_tpu_torch.tools.checkpoint import import_sdxl

    tiny_checkpoint = tiny_checkpoint[0]
    kw = dict(prompt="a cat", negative_prompt="bad", cfg_scale=3.0,
              num_inference_steps=2, height=64, width=64, seed=7)
    jimport = jax_tool("tools/checkpoint/import_sdxl.py")

    def words(model):
        """The word-hash tokenizers, and the tool's UNet forward under
        ``nnx.jit`` (eager, it compiles op by op: 17 s against 4); the
        sampler, jitted itself, then calls the UNet as it is."""
        model.text_encoder.tokenizer_1 = model.text_encoder.tokenizer_2 = WordHashTokenizer()
        cls = type(model.denoiser)
        jitted = nnx.jit(cls.__call__)

        def first_call(self, *args, **kwargs):
            self.__class__ = cls
            return jitted(self, *args, **kwargs)

        model.denoiser.__class__ = type(cls.__name__, (cls,), {"__call__": first_call})

    from vision_pt_tpu.ops.attention import attention_dtype as jattention_dtype

    with jattention_dtype(None):
        want = jimport.run_import(
            JSDXLConfig(**{**TINY_MODEL, "checkpoint_path": tiny_checkpoint}),
            str(tmp_path / "jax"), attach_tokenizers=words,
            execution_dtype=jnp.float32, **kw)
    config = SDXLConfig(**{**TINY_MODEL, "checkpoint_path": tiny_checkpoint})
    latents, noise = _jax_draws(types.SimpleNamespace(scheduler=JScheduler()), 2, 7,
                                (1, 8, 8, 4))
    generate = SDXLModel.generate
    monkeypatch.setattr(SDXLModel, "generate", lambda self, **kw: generate(
        self, **kw, latents=latents, step_noise=noise))
    with tattn.attention_dtype(None):
        got = import_sdxl.run_import(config, str(tmp_path / "port"), device="cpu",
                                     execution_dtype=torch.float32, **kw)
    monkeypatch.undo()
    assert sorted(got) == sorted(want)
    assert got["denoiser_forward"] == want["denoiser_forward"] == "ok"
    assert abs(got["bf16"]["pixel_std"] - want["bf16"]["pixel_std"]) <= 0.05
    assert json.loads((tmp_path / "port" / "report.json").read_text())["bf16"] == got["bf16"]

    matrix = import_sdxl.run_import(config, str(tmp_path / "matrix"), device="cpu",
                                    quant_matrix=True, **{**kw, "num_inference_steps": 1})
    for cell in ("bf16", *import_sdxl.QUANT_TYPES):
        assert (tmp_path / "matrix" / f"{cell}.webp").exists(), cell
        assert matrix[cell]["pixel_std"] > 0, cell


def test_sdxl_quant_matches_jax(tiny_checkpoint, tmp_path):
    """The run names, the layers each cell quantizes, and the record of one
    cell on the CPU (its peak ``None`` without a card,
    ``static_denoiser_step_hbm`` ``None`` by design). The UNet's cell
    quantizes the JAX tool's linears; its text-encoder cell replaces none in
    the JAX package (its ``SDXLModel`` and ``TextEncoder`` are plain
    classes that ``quantize_inplace`` does not enter), and the port keeps
    the option working: every attention and MLP linear of both CLIPs."""
    from tests.test_torch_sdxl import TINY_MODEL
    from vision_pt_tpu_torch.models.sdxl import SDXLConfig, SDXLModel, WordHashTokenizer
    from vision_pt_tpu_torch.ops.quant.layers import QuantLinear4bit, QuantLinearInt8
    from vision_pt_tpu_torch.tools.bench import sdxl_quant

    jbench = jax_tool("tools/bench/sdxl_quant.py")
    for args in (("bf16", "bnb_nf4", True), ("bnb_int8", "bf16", False)):
        assert sdxl_quant.get_run_name(*args) == jbench.get_run_name(*args)
    assert (sdxl_quant.DEFAULT_PROMPT, sdxl_quant.DEFAULT_NEGATIVE) == (
        jbench.DEFAULT_PROMPT, jbench.DEFAULT_NEGATIVE)
    from vision_pt_tpu.ops.quant import quantize_inplace as jquantize_inplace

    path, jmodel = tiny_checkpoint
    calls = []

    def counting(*args, **kwargs):
        calls.append(jquantize_inplace(*args, **kwargs))
        return calls[-1]

    import vision_pt_tpu.ops.quant as jquant

    # the JAX tool imports quantize_inplace when it runs
    real, jquant.quantize_inplace = jquant.quantize_inplace, counting
    try:
        jbench.quantize_model(jmodel, "bnb_int8", "bnb_nf4")
    finally:
        jquant.quantize_inplace = real
    jax_text, jax_unet = (len(c) for c in calls)
    tokenizer = WordHashTokenizer()
    model = SDXLModel.from_checkpoint(
        SDXLConfig(**{**TINY_MODEL, "checkpoint_path": path}), device="cpu",
        tokenizer_1=tokenizer, tokenizer_2=tokenizer)
    sdxl_quant.quantize_model(model, "bnb_int8", "bnb_nf4")
    names = {n for n, m in model.denoiser.named_modules() if isinstance(m, QuantLinear4bit)}
    assert names and all(("attn1" in n or "attn2" in n or ".ff." in n) for n in names)
    assert len(names) == jax_unet and jax_text == 0
    te = [m for enc in (model.text_encoder.text_encoder_1, model.text_encoder.text_encoder_2)
          for m in enc.modules() if isinstance(m, QuantLinearInt8)]
    assert len(te) == 2 * 2 * (4 + 2)  # 2 encoders x 2 layers x (q, k, v, out, fc1, fc2)
    record = sdxl_quant.run_cell(model, "cell", tmp_path, height=64, width=64,
                                 num_inference_steps=1)
    assert record["peak_hbm_bytes"] is None and record["static_denoiser_step_hbm"] is None
    assert json.loads((tmp_path / "cell.json").read_text()) == record
    assert (tmp_path / "cell.webp").exists()
