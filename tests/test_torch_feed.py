"""The port's image feed against the JAX package's, on the CPU: the C loader
(``data/native_image.py``, built from ``native/image_loader.cpp`` into the
port's own build directory), the worker pool (``data/worker_pool.py``) and
the uint8 and C-loader paths of ``TextToImageBucket``
(``data/text_to_image.py``). Everything compared is integer or
bit-for-bit: each comparison is exact.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from vision_pt_tpu.data import native_image as jnative
from vision_pt_tpu.data import worker_pool as jpool
from vision_pt_tpu.data.text_to_image import TextToImageBucket as JBucket
from vision_pt_tpu_torch.data import native_image as native
from vision_pt_tpu_torch.data import worker_pool as pool
from vision_pt_tpu_torch.data.text_to_image import TextToImageBucket

FORMATS = {"jpg": dict(quality=85), "png": {}, "webp": dict(quality=80)}


def _write(folder, fmt: str, size=(96, 72), seed=0):
    """A textured image of ``size`` (w, h) from numpy draws."""
    folder.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    w, h = size
    xs, ys = np.meshgrid(np.linspace(0, 6, w), np.linspace(0, 6, h))
    base = np.stack([127 + 100 * np.sin(xs * (1 + c) + ys + rng.uniform(0, 6))
                     for c in range(3)], axis=-1)
    arr = np.clip(base + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)
    path = folder / f"img_{seed}_{w}x{h}.{fmt}"
    Image.fromarray(arr).save(path, **FORMATS[fmt])
    return path


def test_loader_builds_into_the_port_build_directory():
    assert native.native_available(), native.build_error()
    assert native.build_error() is None
    path = native.library_path()
    assert path.exists() and path.parent.name == "build"
    assert path.parent.parent.name == "csrc" and path.parent.parent.parent.name == (
        "vision_pt_tpu_torch")
    assert native.SOURCE.name == "image_loader.cpp" and native.SOURCE.parent.name == "native"


@pytest.mark.parametrize("fmt", list(FORMATS))
@pytest.mark.parametrize("size,target", [((96, 72), (64, 64)), ((200, 120), (48, 32)),
                                         ((333, 517), (64, 96))])
def test_loader_matches_jax(tmp_path, fmt, size, target):
    path = _write(tmp_path, fmt, size)
    assert native.supports(path) and jnative.supports(path)
    assert native.probe_size(path) == jnative.probe_size(path) == size
    tw, th = target
    cw, ch = native.cover_dims(*size, tw, th)
    assert (cw, ch) == jnative.cover_dims(*size, tw, th)
    for crop in ((0, 0), (cw - tw, ch - th), ((cw - tw) // 2, (ch - th) // 3)):
        got = native.load_cover_crop(path, tw, th, *crop)
        want = jnative.load_cover_crop(path, tw, th, *crop)
        assert got.shape == (th, tw, 3) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_loader_declines_what_it_cannot_read(tmp_path):
    bmp = tmp_path / "a.bmp"
    Image.new("RGB", (8, 8)).save(bmp)
    broken = tmp_path / "b.jpg"
    broken.write_bytes(b"not a jpeg")
    for module in (native, jnative):
        assert module.probe_size(bmp) is None and module.load_cover_crop(bmp, 4, 4, 0, 0) is None
        assert module.probe_size(broken) is None
        assert module.load_cover_crop(broken, 4, 4, 0, 0) is None


def _folder(tmp_path, count=6):
    """Mixed formats and sizes, all larger than the 64 x 48 bucket."""
    fmts = list(FORMATS)
    sizes = [(96, 72), (130, 70), (80, 100)]
    return [{"image": str(_write(tmp_path, fmts[i % 3], sizes[i % 3], seed=i)),
             "caption": f"caption {i}"} for i in range(count)]


@pytest.mark.parametrize("output_dtype", ["float32", "uint8"])
@pytest.mark.parametrize("use_native_loader", [True, False])
def test_bucket_paths_match_jax(tmp_path, monkeypatch, output_dtype, use_native_loader):
    items = _folder(tmp_path)
    kw = dict(items=items, batch_size=3, width=64, height=48, do_upscale=False, seed=4,
              use_native_loader=use_native_loader, output_dtype=output_dtype)
    ours, theirs = TextToImageBucket(**kw), JBucket(**kw)
    calls = {"port": 0}
    load = native.load_cover_crop

    def counted(*args):
        calls["port"] += 1
        return load(*args)

    monkeypatch.setattr(native, "load_cover_crop", counted)
    for epoch in (0, 1):
        ours.epoch = theirs.epoch = epoch
        for b in range(ours.num_batches):
            got, want = ours.get_batch(b), theirs.get_batch(b)
            assert got.keys() == want.keys()
            assert got["caption"] == want["caption"]
            for key in ("image", "original_size", "target_size", "crop_coords_top_left"):
                assert got[key].dtype == want[key].dtype
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
            assert got["image"].dtype == np.dtype(output_dtype)
    assert calls["port"] == (12 if use_native_loader else 0)
    with pytest.raises(ValueError, match="output_dtype"):
        TextToImageBucket(**{**kw, "output_dtype": "float16"})


def test_bucket_keeps_pil_for_an_upscale(tmp_path, monkeypatch):
    """An image smaller than the bucket, without ``do_upscale``, takes PIL
    on both sides."""
    items = [{"image": str(_write(tmp_path, "jpg", (40, 30))), "caption": "small"}]
    monkeypatch.setattr(native, "load_cover_crop", lambda *a: pytest.fail("C path"))
    for upscale in (False, True):
        kw = dict(items=items, batch_size=1, width=64, height=48, do_upscale=upscale)
        if upscale:
            monkeypatch.undo()
        got = TextToImageBucket(**kw).get_batch(0)
        want = JBucket(**kw).get_batch(0)
        for key in ("image", "original_size", "crop_coords_top_left"):
            np.testing.assert_array_equal(got[key], want[key])


def _make_batch(idx: int) -> dict:
    rng = np.random.default_rng(idx)
    return {"image": rng.integers(0, 255, size=(4, 8, 8, 3)).astype(np.uint8),
            "sizes": np.full((4, 2), idx, dtype=np.int32),
            "caption": [f"batch {idx} item {i}" for i in range(4)]}


def _drain(p, n=None):
    out = []
    for batch, release in p:
        out.append({k: v.copy() if isinstance(v, np.ndarray) else v for k, v in batch.items()})
        release()
        if n is not None and len(out) == n:
            break
    return out


@pytest.mark.parametrize("workers,depth", [(1, 2), (3, 3)])
def test_pool_delivers_the_jax_pools_batches_in_order(workers, depth):
    indices = [3, 0, 5, 1, 1, 4, 2, 6]
    with pool.BatchWorkerPool(_make_batch, indices, num_workers=workers, depth=depth) as p:
        assert len(p._shms) == depth + workers
        ours = _drain(p)
        assert p.batches_delivered == len(indices)
        assert p.worker_decode_s > 0 and p.consumer_wait_s >= 0
    with jpool.BatchWorkerPool(_make_batch, indices, num_workers=workers, depth=depth) as p:
        theirs = _drain(p)
    assert len(ours) == len(theirs) == len(indices)
    for got, want, index in zip(ours, theirs, indices):
        assert got.keys() == want.keys()
        for key in ("image", "sizes"):
            np.testing.assert_array_equal(got[key], want[key])
        assert got["caption"] == want["caption"] == _make_batch(index)["caption"]


def test_pool_recycles_slots_and_streams_forever():
    slots = set()
    with pool.BatchWorkerPool(_make_batch, pool.infinite_indices(3), num_workers=1,
                              depth=2) as p:
        def first(batch):
            slots.add(batch["sizes"].__array_interface__["data"][0])
            return int(batch["sizes"][0, 0])

        it = p.iter_device(first)
        seen = [next(it) for _ in range(10)]
    assert seen == [0, 1, 2] * 3 + [0]
    assert len(slots) <= 3 + 1  # 3 slots and the in-process probe batch
    assert p.batches_delivered >= 10


def test_pool_propagates_a_worker_error_and_is_loud_on_a_shape_change():
    def bad(idx):
        if idx == 2:
            raise ValueError("decode exploded")
        return _make_batch(idx)

    def varying(idx):
        b = _make_batch(idx)
        if idx == 1:
            b["image"] = b["image"][:2]
        return b

    with pool.BatchWorkerPool(bad, range(4), num_workers=1, depth=2) as p:
        with pytest.raises(RuntimeError, match="decode exploded"):
            _drain(p)
    with pool.BatchWorkerPool(varying, range(3), num_workers=1, depth=2) as p:
        with pytest.raises(RuntimeError, match="fixed shapes"):
            _drain(p)
    assert pool.pool_cpu_budget() == jpool.pool_cpu_budget() >= 1


def _dies(idx: int) -> dict:
    if idx == 2:
        os._exit(3)  # as a worker killed by SIGBUS on a full /dev/shm
    return _make_batch(idx)


def test_pool_raises_when_a_worker_dies():
    with pool.BatchWorkerPool(_dies, range(4), num_workers=1, depth=2) as p:
        with pytest.raises(RuntimeError, match="exited with code 3"):
            _drain(p)


def test_pool_carries_a_uint8_bucket_and_to_device_copies(tmp_path):
    bucket = TextToImageBucket(items=_folder(tmp_path, 8), batch_size=4, width=64,
                               height=48, do_upscale=False, seed=0, output_dtype="uint8")
    expected = [bucket.get_batch(i) for i in range(bucket.num_batches)]
    with pool.BatchWorkerPool(bucket.get_batch, range(bucket.num_batches),
                              num_workers=2, depth=2) as p:
        got = list(p.iter_device(lambda b: pool.to_device(b, "cpu")))
    for batch, want in zip(got, expected, strict=True):
        assert isinstance(batch["image"], torch.Tensor) and batch["image"].dtype == torch.uint8
        for key in ("image", "original_size", "crop_coords_top_left"):
            # every array is a copy: the slots were recycled and unlinked
            assert isinstance(batch[key], torch.Tensor)
            np.testing.assert_array_equal(batch[key].numpy(), want[key])
        assert batch["caption"] == want["caption"]
