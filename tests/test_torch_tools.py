"""The port's file tools, bench tools and utils
(``vision_pt_tpu_torch/tools``, ``vision_pt_tpu_torch/utils``) against the
JAX package's (``tools/``, ``vision_pt_tpu/utils``), loaded by path and
called in-process on the same inputs.

Tolerances: every file tool and util exactly (the same bytes, tensors,
JSON or stdout lines); ``expand_patch_embed``'s resize 1e-5 relative L2
(PyTorch's antialiased bicubic / bilinear and ``nearest-exact`` against
``jax.image.resize``: the same kernels, summed in another order). The SDXL
import and quantization bench tools are held in ``test_torch_sdxl_tools.py``.
"""

import importlib.util
import json
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

ROOT = Path(__file__).resolve().parents[1]


def jax_tool(relpath: str):
    """A JAX tool module, loaded from its file."""
    path = ROOT / relpath
    name = "jax_tool_" + relpath.replace("/", "_").removesuffix(".py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_click(command, args, capsys) -> list[str]:
    """Run a click command in-process; returns its stdout lines."""
    capsys.readouterr()
    command.main(args=[str(a) for a in args], standalone_mode=False)
    return capsys.readouterr().out.splitlines()


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


# ------------------------------------------------------------ quantize_model


def _unet_state():
    rng = np.random.default_rng(0)
    return {
        "model.diffusion_model.blk.weight": rng.standard_normal((64, 128)).astype(np.float32),
        "model.diffusion_model.blk.bias": rng.standard_normal((64,)).astype(np.float32),
        "model.diffusion_model.odd.weight": rng.standard_normal((10, 30)).astype(np.float32),
        "model.diffusion_model.out.weight": rng.standard_normal((8, 8)).astype(np.float32),
        "model.diffusion_model.time_embed.0.weight":
            rng.standard_normal((16, 8)).astype(np.float32),
        "first_stage_model.conv.weight": rng.standard_normal((4, 4)).astype(np.float32),
    }


@pytest.mark.parametrize("quant_type", ["bnb_nf4", "bnb_fp4"])
@pytest.mark.parametrize("path", ["numpy", "device_codes"])
def test_quantize_model_matches_jax(tmp_path, capsys, quant_type, path):
    """The same keys and identical bytes for every packed, absmax and
    quant-state tensor; the excluded and unmatched keys untouched. The
    ``numpy`` case is the tool with ``--device cpu``; ``device_codes`` runs
    the card path's quantizer (``quantize_state_dict(device=...)``) on the
    CPU."""
    from safetensors.numpy import load_file, save_file

    from vision_pt_tpu_torch.ops.quant.functional import quantize_state_dict
    from vision_pt_tpu_torch.tools import quantize_model

    sd = _unet_state()
    src = tmp_path / "unet.safetensors"
    save_file(sd, str(src))
    jax_out, out = tmp_path / "jax.safetensors", tmp_path / "port.safetensors"
    jax_lines = run_click(jax_tool("tools/quantize_model.py").main,
                          ["--model-path", src, "--save-path", jax_out,
                           "--quant-type", quant_type], capsys)
    if path == "numpy":
        lines = run_click(quantize_model.main,
                          ["--model-path", src, "--save-path", out,
                           "--quant-type", quant_type, "--device", "cpu"], capsys)
        assert lines == [line.replace(str(jax_out), str(out)) for line in jax_lines]
        got = load_file(str(out))
    else:
        got = quantize_state_dict(sd, quant_type, list(quantize_model.INCLUDE_KEYS),
                                  list(quantize_model.EXCLUDE_KEYS), device="cpu")
    want = load_file(str(jax_out))
    assert sorted(got) == sorted(want)
    quantized = [k for k in want if "quant_state" in k]
    assert len(quantized) == 2  # blk and odd; out., time_embed and the VAE excluded
    for key, value in want.items():
        mine = np.asarray(got[key])
        assert mine.dtype == value.dtype and mine.shape == value.shape, key
        assert mine.tobytes() == value.tobytes(), key
    for key in ("model.diffusion_model.out.weight",
                "model.diffusion_model.time_embed.0.weight",
                "first_stage_model.conv.weight", "model.diffusion_model.blk.bias"):
        np.testing.assert_array_equal(got[key], sd[key])


# ------------------------------------------------ change_dtype, inspect, to_safetensors


def _weights_file(path):
    from safetensors.numpy import save_file

    rng = np.random.default_rng(1)
    save_file({"a.weight": rng.standard_normal((4, 6)).astype(np.float32),
               "b.ids": np.arange(3, dtype=np.int64),
               "c.scale": np.full((5,), 0.25, np.float16)}, str(path))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_change_dtype_matches_jax(tmp_path, capsys, dtype):
    from safetensors.torch import load_file

    from vision_pt_tpu_torch.tools.checkpoint import change_dtype

    src = tmp_path / "w.safetensors"
    _weights_file(src)
    jax_out, out = tmp_path / "jax.safetensors", tmp_path / "port.safetensors"
    jax_lines = run_click(jax_tool("tools/checkpoint/change_dtype.py").main,
                          ["-i", src, "-o", jax_out, "--dtype", dtype], capsys)
    lines = run_click(change_dtype.main, ["-i", src, "-o", out, "--dtype", dtype], capsys)
    assert lines == [line.replace(str(jax_out), str(out)) for line in jax_lines]
    got, want = load_file(str(out)), load_file(str(jax_out))
    assert sorted(got) == sorted(want)
    assert got["b.ids"].dtype == torch.int64  # integers untouched
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key


def test_inspect_weights_matches_jax(tmp_path, capsys):
    from vision_pt_tpu_torch.tools.model import inspect_weights

    src = tmp_path / "w.safetensors"
    _weights_file(src)
    jax_main = jax_tool("tools/model/inspect_weights.py").main
    for args in (["-i", src], ["-i", src, "--stats"], ["-i", src, "-f", "weight"]):
        want = run_click(jax_main, args, capsys)
        assert run_click(inspect_weights.main, args, capsys) == want
    assert "a.weight  (4, 6)  float32" in want[0]


def test_to_safetensors_matches_jax(tmp_path, capsys):
    from safetensors.numpy import load_file

    from vision_pt_tpu_torch.tools.checkpoint import to_safetensors

    pt = tmp_path / "model.pt"
    torch.save({"state_dict": {"w": torch.ones(2, 2),
                               "h": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
                               "n": torch.arange(4)}, "step": 3}, pt)
    jax_out, out = tmp_path / "jax.safetensors", tmp_path / "port.safetensors"
    jax_lines = run_click(jax_tool("tools/checkpoint/to_safetensors.py").main,
                          ["-i", pt, "-o", jax_out], capsys)
    lines = run_click(to_safetensors.main, ["-i", pt, "-o", out], capsys)
    assert lines == [line.replace(str(jax_out), str(out)) for line in jax_lines]
    got, want = load_file(str(out)), load_file(str(jax_out))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key])


# ------------------------------------------------------------ expand_patch_embed


@pytest.mark.parametrize("mode", ["bicubic", "bilinear", "nearest"])
@pytest.mark.parametrize("sizes", [(16, 32), (32, 16)], ids=["up", "down"])
def test_expand_patch_embed_matches_jax(tmp_path, capsys, mode, sizes):
    """All three modes, up and down, within 1e-5 relative L2 of
    ``jax.image.resize``."""
    from safetensors.numpy import load_file, save_file

    from vision_pt_tpu_torch.tools.model import expand_patch_embed

    old, new = sizes
    rng = np.random.default_rng(2)
    sd = {
        "denoiser.patch_embedder.proj_1.weight":
            rng.standard_normal((8, 3, old, old)).astype(np.float32),
        "denoiser.final_layer.linear.weight":
            rng.standard_normal((old * old * 3, 8)).astype(np.float32),
        "denoiser.final_layer.linear.bias":
            rng.standard_normal((old * old * 3,)).astype(np.float32),
        "denoiser.other": rng.standard_normal((3,)).astype(np.float32),
    }
    src = tmp_path / "jit.safetensors"
    save_file(sd, str(src))
    jax_out, out = tmp_path / "jax.safetensors", tmp_path / "port.safetensors"
    args = ["-p", new, "-m", mode]
    jax_lines = run_click(jax_tool("tools/model/expand_patch_embed.py").main,
                          ["-i", src, "-o", jax_out, *args], capsys)
    lines = run_click(expand_patch_embed.main, ["-i", src, "-o", out, *args], capsys)
    assert lines == [line.replace(str(jax_out), str(out)) for line in jax_lines]
    got, want = load_file(str(out)), load_file(str(jax_out))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].shape == want[key].shape and got[key].dtype == np.float32, key
        assert _rel_l2(got[key], want[key]) <= 1e-5, (key, _rel_l2(got[key], want[key]))
    assert got["denoiser.patch_embedder.proj_1.weight"].shape == (8, 3, new, new)


# ------------------------------------------------------------ images_to_gif


def test_images_to_gif_matches_jax(tmp_path, capsys):
    from vision_pt_tpu_torch.tools.visualize import images_to_gif

    frames = tmp_path / "frames"
    frames.mkdir()
    rng = np.random.default_rng(3)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, (20, 28, 3), dtype=np.uint8)).save(
            frames / f"{i:03d}.png")
    (frames / "notes.txt").write_text("not a frame")
    jax_out, out = tmp_path / "jax.gif", tmp_path / "port.gif"
    args = ["--duration", 120, "--max-size", 16]
    jax_lines = run_click(jax_tool("tools/visualize/images_to_gif.py").main,
                          ["-i", frames, "-o", jax_out, *args], capsys)
    lines = run_click(images_to_gif.main, ["-i", frames, "-o", out, *args], capsys)
    assert lines == [line.replace(str(jax_out), str(out)) for line in jax_lines]
    assert out.read_bytes() == jax_out.read_bytes()
    gif = Image.open(out)
    gif.seek(2)


# ------------------------------------------------------------ data tools


def _tag_files(folder: Path) -> None:
    folder.mkdir()
    (folder / "sub").mkdir()
    for i in range(7):
        rating = ["general", "sensitive", "explicit", "questionable"][i % 4]
        data = {"rating": rating,
                "character_tags": {"hatsune_miku": 1} if i < 5 else {"kagamine_rin": 1},
                "copyright_tags": {"vocaloid": 1} if i % 2 else {},
                "general_tags": {"1girl": 1, "long_hair": 1} if i < 6 else {"rare_tag": 1}}
        where = folder / "sub" if i % 3 == 0 else folder
        (where / f"{i}.json").write_text(json.dumps(data))
    (folder / "broken.json").write_text("{not json")


@pytest.mark.parametrize("thresholds", [("-g", 5, "-c", 1), ("-g", 1, "-c", 10)])
def test_create_label2id_matches_jax(tmp_path, capsys, thresholds):
    from vision_pt_tpu_torch.tools.data import create_label2id

    tags = tmp_path / "tags"
    _tag_files(tags)
    (tags / "broken.json").unlink()  # the tool reads every JSON it finds
    jax_out, out = tmp_path / "jax.json", tmp_path / "port.json"
    jax_lines = run_click(jax_tool("tools/data/create_label2id.py").main,
                          ["-t", tags, "-o", jax_out, *thresholds], capsys)
    lines = run_click(create_label2id.main, ["-t", tags, "-o", out, *thresholds], capsys)
    assert lines == [line.replace(str(jax_out), str(out)) for line in jax_lines]
    assert out.read_text() == jax_out.read_text()
    assert "hatsune_miku" in json.loads(out.read_text())


def test_create_label2id_sfw_matches_jax(tmp_path, capsys):
    from vision_pt_tpu_torch.tools.data import create_label2id_sfw

    tags = tmp_path / "tags"
    _tag_files(tags)
    jax_out, out = tmp_path / "jax.json", tmp_path / "port.json"
    args = ["-g", 2, "-ch", 1, "-cp", 1, "--num_workers", 2]
    jax_lines = run_click(jax_tool("tools/data/create_label2id_sfw.py").main,
                          ["-i", tags, "-o", jax_out, *args], capsys)
    lines = run_click(create_label2id_sfw.main, ["-i", tags, "-o", out, *args], capsys)
    assert lines == [line.replace(str(jax_out), str(out)) for line in jax_lines]
    assert out.read_text() == jax_out.read_text()
    labels = json.loads(out.read_text())
    assert "hatsune miku" in labels and "explicit" not in labels


def test_create_buckets_cache_matches_jax(tmp_path, capsys):
    from vision_pt_tpu_torch.tools.data import create_buckets_cache

    folder = tmp_path / "imgs"
    (folder / "nested").mkdir(parents=True)
    for i in range(4):
        where = folder / "nested" if i == 3 else folder
        Image.new("RGB", (64 + i * 8, 48)).save(where / f"{i}.png")
        if i != 1:
            (where / f"{i}.txt").write_text("caption")
    (folder / "1.json").write_text("{}")
    Image.new("RGB", (8, 8)).save(folder / "lonely.png")  # no caption: skipped
    jax_out, out = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    jax_lines = run_click(jax_tool("tools/data/create_buckets_cache.py").main,
                          ["-i", folder, "-o", jax_out, "--num_workers", 2], capsys)
    lines = run_click(create_buckets_cache.main,
                      ["-i", folder, "-o", out, "--num_workers", 2], capsys)
    assert lines == [line.replace(str(jax_out), str(out)) for line in jax_lines]
    assert out.read_text() == jax_out.read_text()
    assert len(out.read_text().splitlines()) == 4


# ------------------------------------------------------------ utils


def test_grid_safetensors_and_video_match_jax(tmp_path):
    from safetensors.numpy import save_file

    from vision_pt_tpu.utils import grid as jgrid
    from vision_pt_tpu.utils import safetensors as jsafetensors
    from vision_pt_tpu_torch.utils import grid, safetensors

    rng = np.random.default_rng(4)
    images = [Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
              for h, w in ((12, 10), (8, 14), (12, 12), (5, 5), (9, 3))]
    for kw in ({}, {"padding": 0, "fill": 255}):
        want = np.asarray(jgrid.images_to_grid_image(images, **kw))
        np.testing.assert_array_equal(np.asarray(grid.images_to_grid_image(images, **kw)),
                                      want)

    path = tmp_path / "w.safetensors"
    save_file({"model.a.b": np.ones(3, np.float32), "model.model.c": np.zeros(2, np.int32)},
              str(path))
    renames = {"model.": "denoiser.", "a.": "x."}
    want = jsafetensors.load_file_with_rename_key_map(path, renames)
    got = safetensors.load_file_with_rename_key_map(path, renames)
    assert sorted(got) == sorted(want) == ["denoiser.model.c", "denoiser.x.b"]
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


def test_video_matches_jax(tmp_path):
    pytest.importorskip("cv2")
    from vision_pt_tpu.utils import video as jvideo
    from vision_pt_tpu_torch.utils import video

    rng = np.random.default_rng(5)
    frames = [Image.fromarray(rng.integers(0, 256, (32, 48, 3), dtype=np.uint8))
              for _ in range(4)]
    want = Path(jvideo.write_images_as_video(frames, str(tmp_path / "jax.mp4"), fps=4))
    got = Path(video.write_images_as_video(frames, str(tmp_path / "port.mp4"), fps=4))
    assert got.suffix == want.suffix and got.stat().st_size > 0
    assert got.read_bytes() == want.read_bytes()


# ------------------------------------------------------------ memory


def test_memory_utils_match_jax():
    """``compiled_memory_analysis`` is measured, not static: on the CPU it
    runs the callable and counts its arguments and outputs (no allocator
    peak there), a positive total; a call that raises gives ``None``."""
    from vision_pt_tpu.utils import memory as jmemory
    from vision_pt_tpu_torch.utils import memory

    for n in (None, 0, 1000, 5 * 2**20, 3.5 * 2**30, 7 * 2**40):
        assert memory.format_bytes(n) == jmemory.format_bytes(n)
    x = torch.zeros(256, 512)
    mem = memory.compiled_memory_analysis(lambda t: (t @ t.T).sum(dim=0), x)
    assert mem["argument_bytes"] == 256 * 512 * 4
    assert mem["output_bytes"] == 256 * 4 and mem["temp_bytes"] == 0
    assert mem["total_bytes"] == 256 * 512 * 4 + 256 * 4 > 0
    assert memory.compiled_memory_analysis(lambda t: t @ t, x) is None
    same = memory.compiled_memory_analysis(lambda t: t.view(-1), x)
    assert same["alias_bytes"] == x.nbytes and same["total_bytes"] == x.nbytes
    record = memory.peak_hbm_record(lambda t: t + 1, x)
    assert record["static"]["total_bytes"] == 2 * x.nbytes
    assert record["live_peak_bytes"] is None  # no card here


def _pprof(samples: list[list[int]]) -> bytes:
    """A minimal pprof Profile: a sample type (field 1) and one Sample
    (field 2) per entry, its values (field 2) as varints."""
    def varint(v):
        out = bytearray()
        while True:
            b = v & 0x7F
            v >>= 7
            out.append(b | (0x80 if v else 0))
            if not v:
                return bytes(out)

    def field(num, payload):
        return varint(num << 3 | 2) + varint(len(payload)) + payload

    raw = field(1, varint(1 << 3) + varint(1) + varint(2 << 3) + varint(2))
    for values in samples:
        body = field(1, varint(7))  # location ids, packed
        for v in values:
            body += varint(2 << 3) + varint(v)
        raw += field(2, body)
    return raw + varint(9 << 3) + varint(12345)  # time_nanos


def test_memory_tools_match_jax(tmp_path, capsys):
    import gzip

    from vision_pt_tpu_torch.tools import snapshot_max_memory
    from vision_pt_tpu_torch.tools.bench import check_memory

    jsnapshot = jax_tool("tools/snapshot_max_memory.py")
    jcheck = jax_tool("tools/bench/check_memory.py")
    for n in (0, 1023, 1024, 3 * 2**20 + 5, 2**50):
        assert snapshot_max_memory.format_bytes(n) == jsnapshot.format_bytes(n)
        assert check_memory.format_bytes(n) == jcheck.format_bytes(n)
    plain, zipped = tmp_path / "a.memory.prof", tmp_path / "b.memory.prof"
    raw = _pprof([[3, 4096], [1, 1000000], [2, 77]])
    plain.write_bytes(raw)
    zipped.write_bytes(gzip.compress(raw))
    for path in (plain, zipped):
        assert (snapshot_max_memory.profile_total_bytes(str(path))
                == jsnapshot.profile_total_bytes(str(path)) == 4096 + 1000000 + 77)
        want = run_click(jsnapshot.main, [path], capsys)
        assert run_click(snapshot_max_memory.main, [path], capsys) == want

    # the allocator snapshot: 300 live at the end; the trace reached 1,300
    snapshot = {"segments": [{"blocks": [{"size": 200, "state": "active_allocated"},
                                         {"size": 100, "state": "active_allocated"},
                                         {"size": 512, "state": "inactive"}]}],
                "device_traces": [[{"action": "alloc", "size": 1000},
                                   {"action": "alloc", "size": 200},
                                   {"action": "free_requested", "size": 1000},
                                   {"action": "free_completed", "size": 1000},
                                   {"action": "alloc", "size": 100}]]}
    path = tmp_path / "snapshot.pickle"
    path.write_bytes(pickle.dumps(snapshot))
    assert snapshot_max_memory.snapshot_peak_bytes(snapshot) == 1200
    assert run_click(snapshot_max_memory.main, [path], capsys) == [
        "allocator snapshot peak: 1.17 KB"]
    assert snapshot_max_memory.live_stats() == []  # no card here
    assert run_click(check_memory.main, ["--expr", "torch.zeros(4)"], capsys) == [
        "[before] no CUDA device: no memory stats",
        "[after] no CUDA device: no memory stats"]
