"""The port's dataset pools and post selection (``data/datapool.py``) and
its download tool (``tools/data/download.py``) against the JAX package's:
the cases of ``tests/test_download.py`` run on both sides, with the same
selections, files and metadata, and the tool's four commands over a local
mirror print the same lines and write the same folders. Nothing is
fetched: without ``--mirror`` both tools raise.
"""

import importlib.util
import json
from pathlib import Path

import pyarrow as pa
import pyarrow.parquet as pq
import pytest
from PIL import Image

from vision_pt_tpu.data import datapool as jpool
from vision_pt_tpu_torch.data import datapool as pool
from vision_pt_tpu_torch.tools.data import download

ROOT = Path(__file__).resolve().parents[1]
ROWS = [
    {"id": 1, "created_at": "2021-06-01T10:00:00.000Z",
     "tag_string_meta": "highres", "another_id": [10, 11]},
    {"id": 2, "created_at": "2022-01-01T00:00:00.000Z",
     "tag_string_meta": "highres duplicate", "another_id": [11]},
    {"id": 3, "created_at": "2019-01-01T00:00:00.000Z",
     "tag_string_meta": "", "another_id": None},
    {"id": 4, "created_at": "2023-05-05T12:00:00.000Z",
     "tag_string_meta": "absurdres", "another_id": [12]},
    {"id": 5, "created_at": "2023-06-05T12:00:00.000Z",
     "tag_string_meta": "watermark highres", "another_id": []},
]
SIDES = {"port": pool, "jax": jpool}


def _mirror(path, ids):
    path.mkdir(parents=True, exist_ok=True)
    for i in ids:
        Image.new("RGB", (8, 8), (i % 255, 0, 0)).save(path / f"{i}.webp")
    return path


def _parquet(path, rows, **kw):
    pq.write_table(pa.Table.from_pylist(rows), path, **kw)
    return path


def _tree(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_filter_posts_parquet_date_and_meta_tags(tmp_path):
    meta = _parquet(tmp_path / "meta.parquet", ROWS)
    tables = {}
    for name, module in SIDES.items():
        cache = tmp_path / f"{name}.parquet"
        tables[name] = module.filter_posts_parquet(meta, "2020-01-01", "2025-12-31",
                                                   limit=10, cache_parquet_path=cache)
        assert cache.exists()
    # 2 (duplicate), 3 (date) and 5 (watermark) left out; 'absurdres' is not
    # 'lowres' (whole-token match)
    assert sorted(tables["port"]["id"].to_pylist()) == [1, 4]
    assert tables["port"].equals(tables["jax"])
    assert pq.read_table(tmp_path / "port.parquet").equals(pq.read_table(tmp_path / "jax.parquet"))


def test_filter_posts_null_meta_dropped_and_streaming_limit(tmp_path):
    rows = [{"id": i, "created_at": f"2022-01-{(i % 27) + 1:02d}T00:00:00.000Z",
             "tag_string_meta": None if i == 3 else "highres"} for i in range(1, 60)]
    meta = _parquet(tmp_path / "meta.parquet", rows, row_group_size=10)
    for module in SIDES.values():
        ids = module.filter_posts_parquet(meta, "2020-01-01", "2025-12-31", 100)["id"].to_pylist()
        assert 3 not in ids and len(ids) == 58
        assert module.filter_posts_parquet(meta, "2020-01-01", "2025-12-31", 7).num_rows == 7
        empty = module.filter_posts_parquet(meta, "1990-01-01", "1990-12-31", 5,
                                            cache_parquet_path=tmp_path / "empty.parquet")
        assert empty.num_rows == 0 and (tmp_path / "empty.parquet").exists()


@pytest.mark.parametrize("max_id,limit", [(1000, 10), (5, 10), (391069, 3)])
def test_trailing_id_selection(max_id, limit):
    assert pool.select_trailing_ids(max_id, limit) == jpool.select_trailing_ids(max_id, limit)
    assert pool.select_trailing_ids(1000, 10) == range(990, 1000)


def test_download_posts_layout_and_resume(tmp_path):
    mirror = _mirror(tmp_path / "mirror", [1, 4, 7])
    posts = {1: {"id": 1, "rating": "g"}, 4: {"id": 4, "rating": "g"}, 9: {"id": 9}}
    for name, module in SIDES.items():
        out = tmp_path / name / "images"
        assert module.download_posts(module.LocalMirrorPool(mirror), posts, out) == 2
        assert json.loads((out / "1.json").read_text())["rating"] == "g"
        assert module.download_posts(module.LocalMirrorPool(mirror), posts, out) == 0
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    assert sorted(_tree(tmp_path / "port")) == ["images/1.json", "images/1.webp",
                                                 "images/4.json", "images/4.webp"]


def test_download_posts_backfills_missing_metadata(tmp_path):
    mirror = _mirror(tmp_path / "mirror", [1, 2])
    posts = {1: {"id": 1, "rating": "g"}, 2: {"id": 2, "rating": "s"}}
    for name, module in SIDES.items():
        out = tmp_path / name / "images"
        out.mkdir(parents=True)
        (out / "1.webp").write_bytes((mirror / "1.webp").read_bytes())  # its json lost
        assert module.download_posts(module.LocalMirrorPool(mirror), posts, out) == 2
        assert json.loads((out / "1.json").read_text())["rating"] == "g"
        assert module.download_posts(module.LocalMirrorPool(mirror), posts, out) == 0
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")


def test_styled_pair_selection_and_missing_mirror(tmp_path):
    meta = _parquet(tmp_path / "meta.parquet", ROWS)
    images = tmp_path / "imgs"
    images.mkdir()
    Image.new("RGB", (8, 8)).save(images / "11.webp")  # already there
    assert pool.select_styled_pair_ids(meta, images) == [10, 12]
    assert jpool.select_styled_pair_ids(meta, images) == [10, 12]
    with pytest.raises(FileNotFoundError, match="does not exist"):
        pool.LocalMirrorPool(tmp_path / "nowhere")


def test_hf_pool_is_an_explicit_gate():
    with pytest.raises(RuntimeError, match="egress") as err:
        pool.HFDataPool()
    assert "cheesechaser" in str(err.value) and "--mirror" in str(err.value)


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_download_tool",
                                                  ROOT / "tools" / "data" / "download.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run(command, args, capsys):
    command.main(args=args, standalone_mode=False)
    return capsys.readouterr().out


def test_download_tool_mirror_commands_match_jax(tmp_path, capsys):
    jtool = _jax_tool()
    mirror = _mirror(tmp_path / "mirror", [1, 2, 4, 10, 12, 997, 998])
    meta = _parquet(tmp_path / "meta.parquet", ROWS)
    for name, tool in (("port", download), ("jax", jtool)):
        out = tmp_path / name
        printed = [
            _run(tool.main, ["konachan", "-o", str(out / "kona"), "--limit", "4",
                             "--max-id", "999", "--mirror", str(mirror)], capsys),
            _run(tool.main, ["safebooru-parquet", "-i", str(meta), "-o", str(out / "sbp"),
                             "--limit", "5", "--mirror", str(mirror)], capsys),
            # a second run takes the cached selection and fetches nothing
            _run(tool.main, ["safebooru-parquet", "-i", str(meta), "-o", str(out / "sbp"),
                             "--limit", "1", "--mirror", str(mirror)], capsys),
            _run(tool.main, ["safebooru", "--output", str(out / "sb"), "--metadata-parquet",
                             str(meta), "--mirror", str(mirror)], capsys),
            _run(tool.main, ["styled-images", "--metadata", str(meta), "--images_dir",
                             str(out / "styled"), "--mirror", str(mirror)], capsys),
        ]
        if name == "port":
            ours = [p.replace(str(out), "OUT") for p in printed]
            assert "downloaded 2 images" in ours[0]  # 995-998: 997, 998 in the mirror
            assert "downloaded 0 images" in ours[2] and "IGNORED" in ours[2]
            # another_id 10, 11 and 12; the mirror lacks 11
            assert ours[4] == "Found 3 posts to download.\ndownloaded 2 images to OUT/styled\n"
        else:
            assert [p.replace(str(out), "OUT") for p in printed] == ours
    port, jax = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert port.keys() == jax.keys()
    for key in port:
        if not key.endswith(".parquet"):
            assert port[key] == jax[key], key
    assert pq.read_table(tmp_path / "port" / "sbp" / "cache.parquet").equals(
        pq.read_table(tmp_path / "jax" / "sbp" / "cache.parquet"))


def test_download_tool_without_mirror_raises(tmp_path):
    with pytest.raises(RuntimeError, match="egress"):
        download.main.main(args=["konachan", "-o", str(tmp_path), "--limit", "1"],
                           standalone_mode=False)
