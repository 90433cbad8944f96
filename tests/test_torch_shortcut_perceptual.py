"""The port's shortcut and perceptual losses (``ops/loss/shortcut.py``,
``ops/loss/perceptual.py``) and inference schedules
(``ops/timestep/schedule.py``) against the JAX package's, on the CPU with
numpy-made inputs.

Tolerances, relative to the largest value compared:
- the shortcut durations with the same injected draws, and the targets and
  loss over an analytic denoiser written alike in both frameworks, 1e-6;
  over the tiny JiT denoiser of ``tests/test_torch_jit_denoiser.py``, 1e-5
  (fp32 sums in another order);
- the drawn exponents' frequencies within 5 standard errors of the sqrt
  weights;
- SSIM and LPIPS (random VGG16 weights in each of the three file layouts
  ``load_lpips_weights`` reads) 1e-5 in fp32;
- both schedules exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_pt_tpu.ops.loss import perceptual as jperc
from vision_pt_tpu.ops.loss import shortcut as jshort
from vision_pt_tpu.ops.timestep import schedule as jschedule
from vision_pt_tpu.ops import attention as jattn
from vision_pt_tpu_torch.ops import attention as tattn
from vision_pt_tpu_torch.ops.loss import perceptual as perc
from vision_pt_tpu_torch.ops.loss import shortcut as short
from vision_pt_tpu_torch.ops.timestep import get_flux_schedule, get_linear_schedule
from tests.test_torch_jit_denoiser import make_pair

B = 6


def _close(got, want, rel):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30))


# ------------------------------------------------------------ schedules


@pytest.mark.parametrize("steps,seq,shift", [(20, 256, True), (7, 4096, True),
                                             (28, 1024, False), (1, 64, True)])
def test_schedules_match_jax_exactly(steps, seq, shift):
    got = get_flux_schedule(steps, seq, shift=shift)
    assert got == jschedule.get_flux_schedule(steps, seq, shift=shift)
    assert len(got) == steps + 1 and got[0] == 1.0 and got[-1] == 0.0
    np.testing.assert_array_equal(get_linear_schedule(steps, 0.9, 0.1),
                                  jschedule.get_linear_schedule(steps, 0.9, 0.1))


# ------------------------------------------------------------ shortcut


@pytest.mark.parametrize("min_pow,max_pow", [(0, 7), (2, 5)])
def test_durations_with_injected_draws_match_jax(monkeypatch, min_pow, max_pow):
    rng = np.random.default_rng(min_pow)
    idx = rng.integers(0, max_pow - min_pow, B)
    raw = rng.integers(0, 2**max_pow, B)
    monkeypatch.setattr(jax.random, "categorical",
                        lambda key, logits, shape: jnp.asarray(idx, jnp.int32))
    monkeypatch.setattr(jax.random, "randint",
                        lambda key, shape, lo, hi: jnp.asarray(raw, jnp.int32))
    want = jshort.prepare_random_shortcut_durations(jax.random.key(0), B, min_pow, max_pow)
    got = short.prepare_random_shortcut_durations(
        None, B, min_pow, max_pow, exponent=torch.from_numpy(idx + min_pow),
        raw=torch.from_numpy(raw))
    for field in got._fields:
        _close(getattr(got, field), np.asarray(getattr(want, field)), 1e-6)
    assert got.inference_steps.dtype == torch.int32
    assert got.departure_timesteps.dtype == torch.float32


def test_drawn_exponents_follow_the_sqrt_weights():
    n = 200_000
    gen = torch.Generator().manual_seed(0)
    got = short.prepare_random_shortcut_durations(gen, n, 0, 7)
    counts = np.bincount(got.shortcut_exponent.numpy(), minlength=7) / n
    weights = np.sqrt(np.maximum(np.arange(7), 1e-20))
    p = weights / weights.sum()
    assert counts[0] == 0.0  # weight 1e-10
    np.testing.assert_array_less(np.abs(counts - p), 5 * np.sqrt(p * (1 - p) / n) + 1e-12)
    # the departure is a / steps with a in 1..steps
    a = got.departure_timesteps * got.inference_steps
    assert torch.equal(a, a.round()) and (a >= 1).all()
    assert (a <= got.inference_steps).all()
    # the JAX package's draws (another stream) have the same law
    jexp = np.asarray(jshort.sample_weighted_inference_step_exponent(
        jax.random.key(0), n, 0, 7))
    np.testing.assert_array_less(np.abs(np.bincount(jexp, minlength=7) / n - p),
                                 5 * np.sqrt(p * (1 - p) / n) + 1e-12)


def _analytic(lib):
    """v = tanh(x) (1 + t) + 0.1 mean(ehs) dt, per sample."""
    def denoiser(x, ehs, t, dt):
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        m = ehs.mean(axis=(1, 2)) if lib is jnp else ehs.mean(dim=(1, 2))
        return lib.tanh(x) * (1 + t.reshape(shape)) + 0.1 * (m * dt).reshape(shape)
    return denoiser


def _targets_and_loss(denoiser, lib, x, ehs, t, dt, double, cfg):
    pst = short if lib is torch else jshort
    first, second = pst.prepare_self_consistency_targets(denoiser, x, ehs, t, dt, cfg)
    target = pst.get_shortcut_target_velocity(first, second)
    loss = pst.loss_with_shortcut_self_consistency(first, second, double)
    return first, second, target, loss


def _inputs(seed=0, shape=(B, 8, 8, 3)):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=(B, 5, 32)).astype(np.float32),
            rng.uniform(0.3, 1.0, B).astype(np.float32),
            (1.0 / 2.0 ** rng.integers(0, 4, B)).astype(np.float32),
            rng.normal(size=shape).astype(np.float32))


@pytest.mark.parametrize("cfg", [1.0, 2.5])
def test_targets_and_loss_match_jax(cfg):
    x, ehs, t, dt, double = _inputs()
    want = _targets_and_loss(_analytic(jnp), jnp, *map(jnp.asarray, (x, ehs, t, dt, double)),
                             cfg)
    dbl = torch.from_numpy(double).requires_grad_(True)
    got = _targets_and_loss(_analytic(torch), torch,
                            *map(torch.from_numpy, (x, ehs, t, dt)), dbl, cfg)
    for g, w in zip(got, want):
        _close(g, np.asarray(w), 1e-6)
    # the teacher's predictions are detached; the loss reaches the double
    assert not got[0].requires_grad and not got[1].requires_grad
    got[3].backward()
    want_grad = jax.grad(lambda d: jshort.loss_with_shortcut_self_consistency(
        want[0], want[1], d))(jnp.asarray(double))
    _close(dbl.grad, np.asarray(want_grad), 1e-6)


def test_targets_over_the_jit_denoiser_match_jax():
    jmodel, tmodel = make_pair("float32")
    x, _, t, dt, double = _inputs(1, (B, 16, 16, 3))
    ctx = np.random.default_rng(2).normal(size=(B, 4, 32)).astype(np.float32)
    sizes = np.full((B, 2), 16.0, np.float32)
    crop = np.zeros((B, 2), np.float32)

    @jax.jit
    def jden(x, ehs, t, dt):  # the JiT denoiser has no duration input
        return jmodel(image=x, timestep=t, context=ehs, original_size=jnp.asarray(sizes),
                      target_size=jnp.asarray(sizes), crop_coords=jnp.asarray(crop))

    def tden(x, ehs, t, dt):
        return tmodel(x, t, ehs, torch.from_numpy(sizes), torch.from_numpy(sizes),
                      torch.from_numpy(crop))

    with jattn.attention_dtype(None), tattn.attention_dtype(None):
        want = _targets_and_loss(jden, jnp, *map(jnp.asarray, (x, ctx, t, dt, double)), 1.0)
        got = _targets_and_loss(tden, torch, *map(torch.from_numpy, (x, ctx, t, dt, double)),
                                1.0)
    for g, w in zip(got, want):
        _close(g, np.asarray(w), 1e-5)


# ------------------------------------------------------------ perceptual


def _vgg_state(seed=0):
    """Random VGG16 convs by ``features`` index and heads by stage."""
    rng = np.random.default_rng(seed)
    convs = {}
    for stage, idxs in zip(perc._VGG16_STAGES, perc._VGG16_CONV_IDX):
        for (cin, cout), idx in zip(stage, idxs):
            convs[idx] = (rng.normal(0, np.sqrt(2.0 / (9 * cin)), (cout, cin, 3, 3)),
                          rng.normal(0, 0.05, cout))
    lins = [rng.uniform(0, 0.2, (1, s[-1][1], 1, 1)) for s in perc._VGG16_STAGES]
    return convs, lins


def write_lpips(path, layout: str, seed: int = 0) -> str:
    """An LPIPS-VGG file: ``lpips`` (the lpips package's / torchmetrics'
    keys, .pth), ``torchvision`` (VGG16 ``features`` only, .pth; heads
    default to 1/C) or ``safetensors`` (slice-local conv indices and
    ``lins.{k}`` heads)."""
    convs, lins = _vgg_state(seed)
    sd = {}
    for k, idxs in enumerate(perc._VGG16_CONV_IDX):
        for idx in idxs:
            w, b = (torch.from_numpy(a.astype(np.float32)) for a in convs[idx])
            name = {"lpips": f"net.slice{k + 1}.{idx}",
                    "torchvision": f"features.{idx}",
                    "safetensors": f"slice{k + 1}.{idx - perc._SLICE_START[k]}"}[layout]
            sd[name + ".weight"], sd[name + ".bias"] = w, b
        head = torch.from_numpy(lins[k].astype(np.float32))
        if layout == "lpips":
            sd[f"lin{k}.model.1.weight"] = head
        elif layout == "safetensors":
            sd[f"lins.{k}.model.1.weight"] = head
    if layout == "safetensors":
        from safetensors.torch import save_file

        save_file(sd, str(path) + ".safetensors")
        return str(path) + ".safetensors"
    torch.save(sd, str(path) + ".pth")
    return str(path) + ".pth"


def _images(seed, shape=(2, 32, 48, 3)):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    y = np.clip(x + rng.normal(0, 0.3, shape), -1, 1).astype(np.float32)
    return x, y


@pytest.mark.parametrize("data_range,kernel_size", [(2.0, 11), (1.0, 7)])
def test_ssim_matches_jax(data_range, kernel_size):
    x, y = _images(0, (3, 24, 20, 3))
    got = perc.ssim(torch.from_numpy(x), torch.from_numpy(y), data_range, kernel_size)
    want = jperc.ssim(jnp.asarray(x), jnp.asarray(y), data_range, kernel_size)
    _close(got, np.asarray(want), 1e-5)
    _close(perc.ssim_loss(torch.from_numpy(x), torch.from_numpy(y)),
           np.asarray(jperc.ssim_loss(jnp.asarray(x), jnp.asarray(y))), 1e-5)
    np.testing.assert_allclose(perc.ssim(torch.from_numpy(x), torch.from_numpy(x)).numpy(),
                               1.0, atol=1e-5)


@pytest.mark.parametrize("layout", ["lpips", "torchvision", "safetensors"])
def test_lpips_weights_and_distance_match_jax(tmp_path, layout):
    path = write_lpips(tmp_path / "vgg", layout)
    params = perc.load_lpips_weights(path)
    jparams = jperc.load_lpips_weights(path)
    for stage, jstage in zip(params["convs"], jparams["convs"]):
        for (w, b), (jw, jb) in zip(stage, jstage):
            np.testing.assert_array_equal(w.numpy().transpose(2, 3, 1, 0), np.asarray(jw))
            np.testing.assert_array_equal(b.numpy(), np.asarray(jb))
    for lin, jlin in zip(params["lins"], jparams["lins"]):
        np.testing.assert_array_equal(lin.numpy(), np.asarray(jlin))
    if layout == "torchvision":
        assert float(params["lins"][0][0]) == 1.0 / 64
    x, y = ((a + 1) / 2 for a in _images(1))
    got = perc.LPIPS(params=params, device="cpu")(torch.from_numpy(x), torch.from_numpy(y))
    want = jax.jit(jperc.LPIPS(params=jparams).__call__)(jnp.asarray(x), jnp.asarray(y))
    _close(got, np.asarray(want), 1e-5)
    assert (got > 0).all()


def test_perceptual_loss_matches_jax(tmp_path):
    path = write_lpips(tmp_path / "vgg", "lpips")
    weights = {"ssim": 0.7, "lpips": 1.3}
    x, y = _images(2)
    got = perc.PerceptualLoss(weights, lpips_weights_path=path, device="cpu")(
        torch.from_numpy(x), torch.from_numpy(y))
    want = jax.jit(jperc.PerceptualLoss(weights, lpips_weights_path=path).__call__)(
        jnp.asarray(x), jnp.asarray(y))
    assert got.keys() == want.keys() == {"ssim", "lpips", "total"}
    for key in got:
        _close(got[key], np.asarray(want[key]), 1e-5)
    # only the default SSIM needs no weights; LPIPS without weights raises
    assert perc.PerceptualLoss().weights == {"ssim": 1.0}
    with pytest.raises(ValueError, match="local disk"):
        perc.PerceptualLoss({"lpips": 1.0}, device="cpu")
    with pytest.raises(ValueError, match="local disk"):
        jperc.PerceptualLoss({"lpips": 1.0})
    with pytest.raises(ValueError, match="Unknown perceptual loss"):
        perc.PerceptualLoss({"mse": 1.0})(torch.from_numpy(x), torch.from_numpy(y))


def test_lpips_is_differentiable(tmp_path):
    params = perc.load_lpips_weights(write_lpips(tmp_path / "vgg", "safetensors"))
    x, y = ((a + 1) / 2 for a in _images(3, (1, 16, 16, 3)))
    xt = torch.from_numpy(x).requires_grad_(True)
    perc.lpips_from_params(params, xt, torch.from_numpy(y)).sum().backward()
    jparams = jperc.load_lpips_weights(str(tmp_path / "vgg.safetensors"))
    want = jax.jit(jax.grad(lambda a: jperc.lpips_from_params(
        jparams, a, jnp.asarray(y)).sum()))(jnp.asarray(x))
    _close(xt.grad, np.asarray(want), 1e-5)
