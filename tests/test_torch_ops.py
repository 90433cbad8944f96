"""The port's ops against the JAX package's, on the same numpy inputs.

fp32 ops agree to 1e-5 or better (same arithmetic, reductions in another
order). bf16 ops are compared at 2e-2: each side rounds to bf16 after every
elementwise op, but XLA may fuse and skip an intermediate rounding."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_pt_tpu.models.jit import denoiser as jden
from vision_pt_tpu.ops import norm as jnorm
from vision_pt_tpu.ops import patch as jpatch
from vision_pt_tpu.ops.timestep.embedding import (
    get_timestep_embedding as jax_timestep_embedding,
)
from vision_pt_tpu_torch.models.jit import denoiser as tden
from vision_pt_tpu_torch.ops import norm as tnorm
from vision_pt_tpu_torch.ops import patch as tpatch
from vision_pt_tpu_torch.ops.timestep.embedding import get_timestep_embedding

rng = np.random.default_rng(0)


def _close(ours, theirs, tol=1e-5):
    np.testing.assert_allclose(
        ours.detach().float().numpy(), np.asarray(theirs, dtype=np.float32),
        atol=tol, rtol=tol,
    )


def _set_affine(jmod, tmod, dim):
    """Give both norms the same non-trivial parameters."""
    for name in ("weight", "bias", "alpha", "shift"):
        if getattr(tmod, name, None) is None:
            continue
        size = dim if name in ("weight", "bias") else 1
        value = rng.uniform(0.5, 1.5, size=size).astype(np.float32)
        getattr(jmod, name).value = jnp.asarray(value)
        with torch.no_grad():
            getattr(tmod, name).copy_(torch.from_numpy(value))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm_type", ["layer", "rms", "dyt", "derf"])
def test_norms(norm_type, dtype):
    dim = 48
    x = rng.normal(size=(2, 5, dim)).astype(np.float32) * 3
    jmod = jnorm.get_norm_layer(norm_type, dim, eps=1e-6)
    tmod = tnorm.get_norm_layer(norm_type, dim, eps=1e-6)
    _set_affine(jmod, tmod, dim)
    theirs = jmod(jnp.asarray(x, getattr(jnp, dtype)))
    ours = tmod(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert ours.dtype == getattr(torch, dtype)
    _close(ours, theirs.astype(jnp.float32), 1e-5 if dtype == "float32" else 2e-2)


def test_functional_norms_without_affine():
    x = rng.normal(size=(3, 16)).astype(np.float32)
    _close(tnorm.fp32_rms_norm(torch.from_numpy(x)), jnorm.fp32_rms_norm(jnp.asarray(x)))
    _close(tnorm.fp32_layer_norm(torch.from_numpy(x)),
           jnorm.fp32_layer_norm(jnp.asarray(x)))
    with pytest.raises(ValueError):
        tnorm.get_norm_layer("batch", 4)


def test_patchify_unpatchify_roundtrip():
    image = rng.normal(size=(2, 8, 12, 3)).astype(np.float32)
    ours = tpatch.patchify(torch.from_numpy(image), 4)
    theirs = jpatch.patchify(jnp.asarray(image), 4)
    assert (ours.grid_height, ours.grid_width) == (theirs.grid_height, theirs.grid_width)
    _close(ours.patches, theirs.patches, 0)
    back = tpatch.unpatchify(ours.patches, ours.grid_height, ours.grid_width, 4, 3)
    _close(back, jpatch.unpatchify(theirs.patches, 2, 3, 4, 3), 0)
    _close(back, image, 0)


def test_pixel_shuffle_nhwc():
    x = rng.normal(size=(2, 3, 4, 12)).astype(np.float32)
    ours = tpatch.pixel_shuffle_nhwc(torch.from_numpy(x), 2)
    _close(ours, jpatch.pixel_shuffle_nhwc(jnp.asarray(x), 2), 0)
    nchw = torch.nn.functional.pixel_shuffle(torch.from_numpy(x).permute(0, 3, 1, 2), 2)
    _close(ours, nchw.permute(0, 2, 3, 1).numpy(), 0)


@pytest.mark.parametrize("dim,flip,shift", [(256, True, 0.0), (33, False, 1.0)])
def test_timestep_embedding(dim, flip, shift):
    t = rng.uniform(0, 1000, size=(3, 6)).astype(np.float32)
    ours = get_timestep_embedding(torch.from_numpy(t), dim, flip_sin_to_cos=flip,
                                  downscale_freq_shift=shift)
    theirs = jax_timestep_embedding(jnp.asarray(t), dim, flip_sin_to_cos=flip,
                                    downscale_freq_shift=shift)
    assert ours.shape == (3, 6, dim)
    # sin/cos of arguments up to 1e3 in fp32: absolute error ~1e-4
    _close(ours, theirs, 2e-4)


def test_rope_embedder_tables():
    j = jden.RopeEmbedder(axes_dims=(8, 12, 12))
    t = tden.RopeEmbedder(axes_dims=(8, 12, 12))
    for fn, args in (("prepare_image_position_ids", (32, 48, 8, 3)),
                     ("prepare_context_position_ids", (7, 1))):
        pos_j, pos_t = getattr(j, fn)(*args), getattr(t, fn)(*args)
        np.testing.assert_array_equal(pos_t, pos_j)
        np.testing.assert_array_equal(t(pos_t), j(pos_j))


def _freqs(seq, head_dim):
    emb = tden.RopeEmbedder(axes_dims=(head_dim // 2, head_dim // 4, head_dim // 4))
    return emb(emb.prepare_context_position_ids(seq))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope(dtype):
    x = rng.normal(size=(2, 10, 3, 32)).astype(np.float32)
    freqs = _freqs(10, 32)
    ours = tden.apply_rope(torch.from_numpy(x).to(getattr(torch, dtype)),
                           torch.from_numpy(freqs))
    theirs = jden.apply_rope(jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(freqs))
    _close(ours, theirs.astype(jnp.float32), 1e-5 if dtype == "float32" else 2e-2)


def test_rms_rope_bf16():
    d = 64
    x = rng.normal(size=(2, 12, 2, d)).astype(np.float32)
    gain = rng.uniform(0.5, 1.5, size=d).astype(np.float32)
    freqs = _freqs(12, d)
    jn = jnorm.FP32RMSNorm(d, eps=1e-6)
    jn.weight.value = jnp.asarray(gain)
    tn = tnorm.FP32RMSNorm(d, eps=1e-6)
    with torch.no_grad():
        tn.weight.copy_(torch.from_numpy(gain))
    theirs = jden._rms_rope(jnp.asarray(x, jnp.bfloat16), jn, jnp.asarray(freqs))
    ours = tden._rms_rope(torch.from_numpy(x).bfloat16(), tn, torch.from_numpy(freqs))
    assert ours.dtype == torch.bfloat16
    _close(ours, theirs.astype(jnp.float32), 2e-2)
