"""The port's inference server and client
(``vision_pt_tpu_torch/tools/inference_{server,client}.py``) against the
JAX package's ``tools/inference_server.py``, loaded by path and driven
in-process.

- The batcher: the JAX tests' three cases on both classes, with the same
  fake generator; the groupings must be the same.
- HTTP over a loopback socket with the tiny SDXL of
  ``tests/test_torch_sdxl.py`` on the CPU, NF4-prequantized by the port's
  ``quantize_model`` tool and carrying a LoRA that the port's QLoRA trainer
  saved: health, 200 with webp, 422, 404.
- Both servers on the same tiny weights (the JAX model's sgm state dict)
  and the same draws (the port is handed the JAX sampler's latents and
  step noise for the seed), fp32: the float images handed to the webp
  encoder agree within 1e-4 of their largest value, the sampler tolerance
  of ``tests/test_torch_sdxl.py``, and the uint8 images within one level.
"""

import importlib.util
import json
import threading
import time
import types
import urllib.error
import urllib.request
from io import BytesIO
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from vision_pt_tpu_torch.tools import inference_client, inference_server

ROOT = Path(__file__).resolve().parents[1]


def _jax_server():
    spec = importlib.util.spec_from_file_location(
        "jax_inference_server", ROOT / "tools" / "inference_server.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX_SERVER = _jax_server()
SERVERS = {"jax": JAX_SERVER, "port": inference_server}


# ------------------------------------------------------------ the batcher


def _groupings(server):
    calls = []

    def fake_generate(params_list):
        calls.append(sorted(p.prompt for p in params_list))
        time.sleep(0.02)
        return [f"img:{p.prompt}".encode() for p in params_list]

    batcher = server.Batcher(fake_generate, max_batch=4, max_delay_ms=80.0)
    P = server.GenerationParams
    same = dict(width=64, height=64, inference_steps=2, cfg_scale=3.0)
    futs = [batcher.submit(P(prompt=f"p{i}", **same)) for i in range(3)]
    other = batcher.submit(P(prompt="odd", width=128, height=64, inference_steps=2,
                             cfg_scale=3.0))
    seeded = batcher.submit(P(prompt="seeded", seed=7, **same))
    assert [f.result(timeout=10) for f in futs] == [b"img:p0", b"img:p1", b"img:p2"]
    assert other.result(timeout=10) == b"img:odd"
    assert seeded.result(timeout=10) == b"img:seeded"
    return sorted(calls)


def test_batcher_groups_compatible_requests_as_jax():
    """Concurrent seedless requests of one key run as ONE call; another
    shape and a seeded request run alone; both classes group alike."""
    groups = _groupings(inference_server)
    assert groups == _groupings(JAX_SERVER) == [["odd"], ["p0", "p1", "p2"], ["seeded"]]


def test_batch_key_never_mixes_seed1_with_seedless():
    for name, server in SERVERS.items():
        P, key = server.GenerationParams, server.Batcher.batch_key
        same = dict(prompt="x", width=64, height=64, inference_steps=2, cfg_scale=3.0)
        # True == 1 in Python: a naive `seed is None or seed` key collides
        assert key(P(seed=1, **same)) != key(P(seed=None, **same)), name
        assert key(P(seed=None, **same)) == key(P(seed=None, **same)), name
    for seed in (None, 0, 1, 5):
        params = dict(prompt="x", width=128, height=64, inference_steps=3,
                      cfg_scale=4.5, seed=seed)
        assert inference_server.Batcher.batch_key(
            inference_server.GenerationParams(**params)) == JAX_SERVER.Batcher.batch_key(
            JAX_SERVER.GenerationParams(**params))


def test_batcher_delivers_exceptions_per_request():
    for server in SERVERS.values():
        def broken_generate(params_list):
            raise RuntimeError("boom")

        batcher = server.Batcher(broken_generate, max_batch=2, max_delay_ms=10.0)
        futs = [batcher.submit(server.GenerationParams(
            prompt=f"x{i}", width=64, height=64, inference_steps=1, cfg_scale=1.5))
            for i in range(2)]
        for fut in futs:
            with pytest.raises(RuntimeError, match="boom"):
                fut.result(timeout=10)


def test_generation_params_match_jax():
    from pydantic import ValidationError

    want = JAX_SERVER.GenerationParams(prompt="a").model_dump()
    assert inference_server.GenerationParams(prompt="a").model_dump() == want
    assert inference_server.DEFAULT_NEGATIVE == JAX_SERVER.DEFAULT_NEGATIVE
    for server in SERVERS.values():
        with pytest.raises(ValidationError, match="divisible by 64"):
            server.GenerationParams(prompt="a", width=100)


# ------------------------------------------------------------ the tiny QLoRA server


@pytest.fixture(scope="module")
def qlora(tmp_path_factory):
    """The tiny SDXL in the sgm layout, NF4-prequantized by the port's
    ``quantize_model`` tool, a LoRA that the port's QLoRA entry point
    trained on it (2 steps), and a server config that names both."""
    from safetensors.torch import save_file

    from tests.test_torch_sdxl_training import QUANT_STATE_KEYS, TINY_MODEL, write_config
    from vision_pt_tpu_torch.models.sdxl import SDXLConfig, SDXLModel
    from vision_pt_tpu_torch.tools.quantize_model import quantize_file
    from vision_pt_tpu_torch.train.sdxl.text_to_image import run

    tmp = tmp_path_factory.mktemp("qlora")
    dense, nf4 = tmp / "tiny.safetensors", tmp / "tiny.bnb_nf4.safetensors"
    model = SDXLModel.from_config(SDXLConfig(**TINY_MODEL), seed=3, device="cpu")
    save_file({k: v.contiguous() for k, v in model.state_dict().items()}, str(dense))
    stats = quantize_file(str(dense), str(nf4), "bnb_nf4",
                          ["model.diffusion_model.*" + k for k in QUANT_STATE_KEYS], [],
                          device="cpu")
    config = write_config(tmp, "configs/sdxl/text_to_image_qlora_nf4.yml",
                          checkpoint_path=str(nf4))
    run(str(config), device="cpu")
    lora = next((tmp / "out").iterdir())
    server_config = tmp / "server.yml"
    server_config.write_text(yaml.safe_dump({
        "model": {**TINY_MODEL, "checkpoint_path": str(nf4), "tokenizer": "word-hash"},
        "dataset": {}}))
    return types.SimpleNamespace(config=str(server_config), lora=str(lora), stats=stats)


def _post(url: str, body: bytes):
    req = urllib.request.Request(f"{url}/predict", data=body,
                                 headers={"Content-Type": "application/json"})
    return urllib.request.urlopen(req)


def test_http_roundtrip_serves_the_qlora_model(qlora):
    """The NF4 file loads as NF4, the LoRA on top; the port's client gets a
    webp at the asked size over a real socket; a malformed body gets 422, an
    unknown path 404."""
    from vision_pt_tpu_torch.ops.quant.layers import QuantLinear4bit
    from vision_pt_tpu_torch.peft.lora import LoRALinear

    assert qlora.stats["quantized"] > 0
    t2i = inference_server.T2IModel(qlora.config, qlora.lora, max_batch=4,
                                    max_delay_ms=30.0, device="cpu")
    wrapped = [m for m in t2i.model.denoiser.modules() if isinstance(m, LoRALinear)]
    assert wrapped and all(isinstance(m.linear, QuantLinear4bit) for m in wrapped)
    server = inference_server.serve(t2i, "127.0.0.1", 0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        with urllib.request.urlopen(f"{url}/health") as resp:
            assert json.loads(resp.read())["status"] == "ok"
        images, status = inference_client.generate_image(url, "a cat", "bad", 64, 128, 2,
                                                         3.0)
        assert images[0].format == "WEBP" and images[0].size == (64, 128)
        assert status.startswith("Elapsed time: ")
        body = json.dumps({"prompt": "a cat", "width": 64, "height": 64,
                           "inference_steps": 2, "cfg_scale": 3.0, "seed": 1}).encode()
        with _post(url, body) as resp:
            assert resp.headers["Content-Type"] == "image/webp"
            image = Image.open(BytesIO(resp.read()))
        assert image.size == (64, 64)
        pixels = np.asarray(image.convert("RGB"), np.float32)
        assert np.isfinite(pixels).all() and pixels.std() > 0
        for bad in (b'{"width": 63}', b"not json", b'{"prompt": "x", "height": 100}'):
            with pytest.raises(urllib.error.HTTPError) as exc_info:
                _post(url, bad)
            assert exc_info.value.code == 422
            assert "error" in json.loads(exc_info.value.read())
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            urllib.request.urlopen(f"{url}/nowhere")
        assert exc_info.value.code == 404
    finally:
        server.shutdown()
        server.server_close()


def _capture_floats(monkeypatch, module):
    """Record every float image ``module.tensor_to_images`` converts."""
    seen = []
    convert = module.tensor_to_images

    def recording(tensor):
        seen.append(np.asarray(tensor.float() if isinstance(tensor, torch.Tensor)
                               else tensor, np.float32).copy())
        return convert(tensor)

    monkeypatch.setattr(module, "tensor_to_images", recording)
    return seen


def test_lora_changes_the_image(qlora, monkeypatch):
    """The trained LoRA loads through ``--peft-path`` (every adapter in the
    file, its weights as saved) and moves the seeded image."""
    from safetensors.torch import load_file

    from vision_pt_tpu_torch.peft.lora import LoRALinear
    from vision_pt_tpu_torch.utils import tensor as ttensor

    seen = _capture_floats(monkeypatch, ttensor)
    params = inference_server.GenerationParams(prompt="a cat", width=64, height=64,
                                               inference_steps=2, cfg_scale=3.0, seed=4)
    plain = inference_server.T2IModel(qlora.config, device="cpu")
    plain.generate(params)
    with_lora = inference_server.T2IModel(qlora.config, qlora.lora, device="cpu")
    with_lora.generate(params)
    saved = load_file(qlora.lora)
    ups = sorted(k for k in saved if k.endswith("lora_up.weight"))
    layers = {n: m for n, m in with_lora.model.denoiser.named_modules()
              if isinstance(m, LoRALinear)}
    assert len(layers) == len(ups) > 0
    assert any(float(m.lora_up.weight.detach().abs().max()) > 0 for m in layers.values())
    assert len(seen) == 2
    assert np.abs(seen[1] - seen[0]).max() > 1e-3


def test_server_images_match_jax(tmp_path, monkeypatch):
    """The JAX and port servers on the same tiny weights and draws, fp32:
    the seeded request's float image, its uint8 image and the response."""
    import jax.numpy as jnp
    from flax import nnx
    from safetensors.numpy import save_file

    from tests.test_torch_sdxl import TINY_MODEL, _jax_draws
    from vision_pt_tpu.models.sdxl import SDXLModel as JSDXLModel
    from vision_pt_tpu.models.sdxl.config import SDXLConfig as JSDXLConfig
    from vision_pt_tpu.ops.attention import attention_dtype as jattention_dtype
    from vision_pt_tpu.utils import tensor as jtensor
    from vision_pt_tpu_torch.models.sdxl import WordHashTokenizer
    from vision_pt_tpu_torch.ops import attention as tattn
    from vision_pt_tpu_torch.utils import tensor as ttensor

    jmodel = JSDXLModel.from_config(JSDXLConfig(**TINY_MODEL), rngs=nnx.Rngs(0))
    jmodel.text_encoder.tokenizer_1 = jmodel.text_encoder.tokenizer_2 = WordHashTokenizer()
    sd = {k: np.ascontiguousarray(v) for k, v in jmodel.state_dict().items()}
    q_key = "first_stage_model.encoder.mid.attn_1.q.weight"
    sd[q_key] = sd[q_key][:, :, None, None]
    save_file(sd, str(tmp_path / "tiny.safetensors"))
    config = tmp_path / "server.yml"
    config.write_text(yaml.safe_dump({"model": {
        **TINY_MODEL, "checkpoint_path": str(tmp_path / "tiny.safetensors"),
        "tokenizer": "word-hash"}, "dataset": {}}))

    jt2i = JAX_SERVER.T2IModel.__new__(JAX_SERVER.T2IModel)
    jt2i.model, jt2i._lock = jmodel, threading.Lock()
    jt2i.batcher = JAX_SERVER.Batcher(jt2i._generate_batch)
    jgenerate = jmodel.generate

    def jax_fp32(**kw):
        with jattention_dtype(None):
            return jgenerate(**kw, execution_dtype=jnp.float32)

    jmodel.generate = jax_fp32
    t2i = inference_server.T2IModel(str(config), device="cpu")
    steps, seed = 2, 11
    latents, noise = _jax_draws(jmodel, steps, seed, (1, 8, 8, 4))
    generate = t2i.model.generate

    def port_fp32(**kw):
        with tattn.attention_dtype(None):
            return generate(**kw, execution_dtype=torch.float32, latents=latents,
                            step_noise=noise)

    t2i.model.generate = port_fp32
    theirs = _capture_floats(monkeypatch, jtensor)
    ours = _capture_floats(monkeypatch, ttensor)
    kw = dict(prompt="a cat", negative_prompt="bad", width=64, height=64,
              inference_steps=steps, cfg_scale=3.0, seed=seed)
    want = jt2i.generate(JAX_SERVER.GenerationParams(**kw))
    got = t2i.generate(inference_server.GenerationParams(**kw))
    assert len(theirs) == len(ours) == 1
    assert ours[0].shape == theirs[0].shape == (1, 64, 64, 3)
    np.testing.assert_allclose(ours[0], theirs[0], rtol=0,
                               atol=1e-4 * np.abs(theirs[0]).max())
    as_uint8 = [np.clip((x[0][0] + 1.0) * 127.5, 0, 255).astype(np.uint8)
                for x in (ours, theirs)]
    assert np.abs(as_uint8[0].astype(np.int16) - as_uint8[1]).max() <= 1
    # each response is its image, webp at quality 90; equal images, equal bytes
    assert Image.open(BytesIO(got)).size == (64, 64)
    assert got == inference_server.encode_webp(Image.fromarray(as_uint8[0]))
    assert want == inference_server.encode_webp(Image.fromarray(as_uint8[1]))
    if np.array_equal(*as_uint8):
        assert got == want
