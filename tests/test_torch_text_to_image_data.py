"""The port's text-to-image bucket dataset (``data/{tags,aspect_ratio_bucket,
text_to_image}.py``) against the JAX package's, on the CPU: the same buckets
and assignments for the configs' parameters, and over one synthetic folder
and seed the same batches (captions, size conditioning, crop coordinates and
pixels), exactly. Both sides decode through PIL here
(``use_native_loader=False``); ``tests/test_torch_feed.py`` holds the C
loader's path and the uint8 output.
"""

import json

import numpy as np
import pytest
from PIL import Image

from vision_pt_tpu.data import aspect_ratio_bucket as jarb
from vision_pt_tpu.data import tags as jtags
from vision_pt_tpu.data.text_to_image import TextToImageDatasetConfig as JDatasetConfig
from vision_pt_tpu_torch.data import aspect_ratio_bucket as arb
from vision_pt_tpu_torch.data import tags
from vision_pt_tpu_torch.data.text_to_image import TextToImageDatasetConfig

# (bucket_base_size, step, min_size): the SDXL LoRA/QLoRA configs, the
# defaults, the JAX tests' small one, a tiny one
BUCKET_PARAMS = [(1024, 128, 384), (1024, 64, 384), (1024, 64, 64), (64, 32, 32)]


@pytest.mark.parametrize("base,step,min_size", BUCKET_PARAMS)
def test_buckets_and_assignment_match_jax(base, step, min_size):
    ours = arb.generate_buckets(base * base, base, step, min_size)
    theirs = jarb.generate_buckets(base * base, base, step, min_size)
    np.testing.assert_array_equal(ours, theirs)
    config = arb.AspectRatioBucketConfig(bucket_base_size=base, step=step,
                                         min_size=min_size)
    np.testing.assert_array_equal(config.buckets, theirs)
    manager, jmanager = arb.AspectRatioBucketManager(ours), jarb.AspectRatioBucketManager(theirs)
    assert len(manager) == len(jmanager) and list(manager) == list(jmanager)
    rng = np.random.default_rng(base + step)
    sizes = rng.integers(min_size, 3 * base, size=(64, 2))
    sizes = np.concatenate([sizes, [[base, base], [2 * base, base], [base, 3 * base]]])
    for w, h in sizes:
        try:
            want = jmanager.find_nearest(int(w), int(h))
        except ValueError:
            with pytest.raises(ValueError):
                manager.find_nearest(int(w), int(h))
            continue
        assert manager.find_nearest(int(w), int(h)) == want
    fits = [(w, h) for w, h in sizes if (ours[:, 0] <= w).any() and
            ((ours[:, 0] <= w) & (ours[:, 1] <= h)).any()]
    w, h = np.asarray(fits).T
    np.testing.assert_array_equal(manager.find_nearest_batch(w, h),
                                  jmanager.find_nearest_batch(w, h))
    with pytest.raises(ValueError):
        manager.find_nearest(min_size - 1, min_size - 1)


@pytest.mark.parametrize("general,character,rating,score", [
    (["1girl", "solo", "red_hair", "2boys"], ["hatsune_miku"], "general", None),
    (["smile", "6+others"], [], "explicit", 60),
    (["^_^", "x_x", "long_hair"], ["a_b"], "q", 30),
    ([], [], "s", 7),
    (["3girls"], ["c"], "e", -2),
    (["cat"], [], "general", 1),
])
def test_tag_formatting_matches_jax(general, character, rating, score):
    for fn in ("map_replace_underscore",):
        assert getattr(tags, fn)(general) == getattr(jtags, fn)(general)
    assert tags.PEOPLE_TAGS == jtags.PEOPLE_TAGS
    ours = tags.format_general_character_tags(
        tags.map_replace_underscore(general), character, rating, score=score)
    theirs = jtags.format_general_character_tags(
        jtags.map_replace_underscore(general), character, rating, score=score)
    assert ours == theirs


def write_folder(folder):
    """Images of several aspects, with .txt captions and the metadata JSON
    formats the dataset reads; one image without either is left out."""
    folder.mkdir()
    (folder / "sub").mkdir()
    rng = np.random.default_rng(0)
    sizes = [(96, 64), (64, 96), (80, 80), (130, 70), (70, 70), (64, 64),
             (100, 90), (40, 50)]
    for i, (w, h) in enumerate(sizes):
        where = folder / "sub" if i % 3 == 2 else folder
        pixels = rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)
        Image.fromarray(pixels).save(where / f"img{i}.png")
        if i % 4 == 0:
            (where / f"img{i}.txt").write_text(f"photo of thing {i}, red, blue")
        elif i % 4 == 1:
            (where / f"img{i}.json").write_text(json.dumps({
                "tag_string": "x", "tag_string_general": "1girl solo red_hair",
                "tag_string_copyright": "series_a", "tag_string_character": "hero_b",
                "rating": "q"}))
        elif i % 4 == 2:
            (where / f"img{i}.json").write_text(json.dumps({
                "tagger": {"general": ["smile", "2boys"], "character": ["c"]},
                "rating": "general"}))
        elif i != 7:
            (where / f"img{i}.json").write_text(json.dumps({
                "captions": ["first caption", "second caption", "third"]}))
    return folder


CONFIG = {
    "batch_size": 2, "num_repeats": 2, "seed": 3, "bucket_base_size": 64,
    "step": 16, "min_size": 32, "num_workers": 2,
    "caption_processors": [{"type": "shuffle", "split_separator": ", "},
                           {"type": "tag_drop", "drop_rate": 0.3, "separator": ", "}],
}


def _assert_same_batches(ours, theirs, epochs=2):
    assert len(ours) == len(theirs) > 0
    for epoch in range(epochs):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for a, b in zip(ours, theirs, strict=True):
            assert a.keys() == b.keys()
            assert a["caption"] == b["caption"]
            for key in ("image", "original_size", "target_size", "crop_coords_top_left"):
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("do_upscale", [False, True])
def test_batches_match_jax(tmp_path, do_upscale):
    folder = write_folder(tmp_path / "images")
    cfg = {**CONFIG, "folder": str(folder), "do_upscale": do_upscale,
           "use_native_loader": False}
    ours = TextToImageDatasetConfig.model_validate(cfg).get_dataset()
    theirs = JDatasetConfig.model_validate(cfg).get_dataset()
    _assert_same_batches(ours, theirs)
    batch = next(iter(ours))
    assert batch["image"].dtype == np.float32 and batch["image"].ndim == 4
    assert -1.0 <= batch["image"].min() and batch["image"].max() <= 1.0
    # a mid-epoch resume starts where the unbroken epoch is
    ours.set_epoch(1)
    full = [b["caption"] for b in ours]
    ours.set_epoch(1)
    assert [b["caption"] for b in ours.iter_from(2)] == full[2:]


def test_imagesize_cache_serves_the_same_batches(tmp_path):
    folder = write_folder(tmp_path / "images")
    cache = tmp_path / "sizes.jsonl"
    cfg = {**CONFIG, "folder": str(folder), "imagesize_cache_path": str(cache),
           "use_native_loader": False}
    first = TextToImageDatasetConfig.model_validate(cfg).get_dataset()
    assert cache.exists() and len(cache.read_text().splitlines()) == 7
    # an image added later is not walked: the cache lists the folder
    Image.new("RGB", (64, 64)).save(folder / "late.png")
    (folder / "late.txt").write_text("late")
    # the port's cache is read by the JAX package as it is
    theirs = JDatasetConfig.model_validate(cfg).get_dataset()
    again = TextToImageDatasetConfig.model_validate(cfg).get_dataset()
    _assert_same_batches(again, theirs, epochs=1)
    _assert_same_batches(again, first, epochs=1)
    assert sum(ds.bucket.num_items for ds in again.datasets) == 7
