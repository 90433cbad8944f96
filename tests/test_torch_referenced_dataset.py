"""The port's referenced text-to-image dataset (``data/referenced_text_to_image.py``)
against the JAX package's, on the CPU: ``compose_caption`` under one seed,
and over one synthetic folder (images with metadata JSONs naming a reference
image and tag groups) and seed the same batches (captions, size
conditioning, crop coordinates, pixels and reference images), exactly. The
JAX side decodes through PIL (its C decoder switched off), as the port
always does.
"""

import numpy as np
import pytest

from tests.test_torch_ip_adapter import write_images
from vision_pt_tpu.data import native_image
from vision_pt_tpu.data import referenced_text_to_image as jref
from vision_pt_tpu_torch.data import referenced_text_to_image as ref
from vision_pt_tpu_torch.data.transforms import ColorChannelSwap, PaddedResize


def test_compose_caption_matches_jax():
    groups = dict(copyright=["series a", "series b"], character=["alice", "bob", "carol"],
                  general=["smile", "solo", "red hair", "outdoors"], meta=["highres"],
                  people=["1girl", "1boy"])
    for seed in range(4):
        got = ref.compose_caption(**groups, rng=np.random.default_rng(seed))
        want = jref.compose_caption(**groups, rng=np.random.default_rng(seed))
        assert got == want
    assert ref.compose_caption([], [], ["x"], [], ["1girl"]) == "1girl, x"


def test_padded_resize_and_channel_swap_match_jax():
    from PIL import Image

    from vision_pt_tpu.data import transforms as jtransforms

    img = Image.fromarray(np.random.default_rng(0).integers(0, 256, (30, 50, 3), np.uint8))
    for size, fill in ((28, 255), (64, 0)):
        np.testing.assert_array_equal(np.asarray(PaddedResize(size, fill)(img)),
                                      np.asarray(jtransforms.PaddedResize(size, fill)(img)))
    arr = np.random.default_rng(1).random((4, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(ColorChannelSwap()(arr), jtransforms.ColorChannelSwap()(arr))


@pytest.mark.parametrize("reference_size,background", [(224, 0), (32, 255)])
def test_batches_match_jax(tmp_path, monkeypatch, reference_size, background):
    monkeypatch.setattr(native_image, "native_available", lambda: False)
    write_images(tmp_path / "images", count=5, reference_folder=tmp_path / "refs")
    # an image without metadata and one whose metadata names no reference
    # are left out on both sides
    write_images(tmp_path / "images" / "plain", count=1)
    (tmp_path / "images" / "img4.json").write_text('{"general": ["solo"]}')
    fields = dict(folder=str(tmp_path / "images"), bucket_base_size=64, step=32,
                  min_size=32, batch_size=2, num_repeats=2, seed=5,
                  reference_size=reference_size, background_color=background)
    ours = ref.ReferencedTextToImageDatasetConfig(**fields).get_dataset()
    theirs = jref.ReferencedTextToImageDatasetConfig(**fields).get_dataset()
    assert len(ours) == len(theirs) == 4
    seen = []
    for epoch in range(2):
        ours.set_epoch(epoch)
        theirs.set_epoch(epoch)
        for got, want in zip(ours, theirs, strict=True):
            assert got.keys() == want.keys()
            assert got["caption"] == want["caption"]
            for key in ("image", "reference_image", "original_size", "target_size",
                        "crop_coords_top_left"):
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
            assert got["reference_image"].shape == (2, reference_size, reference_size, 3)
            seen += got["caption"]
    assert len(seen) == 16
    assert all(c.startswith("1girl, character ") for c in seen)
