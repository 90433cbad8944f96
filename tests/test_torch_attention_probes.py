"""The port's two attention probes (kernels #10 and #11; their plain PyTorch
versions, which the wrappers run for CPU tensors and ``chip_smoke.py`` holds
against the CUDA kernels) against the JAX probes on the same numpy-made
input, and the bench helpers behind the roofline probe's training step.

#10: ``run_variant_reference`` against the JAX pairing probe's two kernel
bodies (``_base_kernel`` and ``_paired_kernel``, one function in two TPU
schedules), each run in a ``pl.pallas_call(..., interpret=True)`` built here
with ``run_variant``'s specs (``tools/bench/attention_pairing_probe.py:
143-156``) over the module's globals set small. ``tools/bench`` is not a
package, so the module is loaded by path; its import sets
``jax_compilation_cache_dir``, which is put back.

#11: the JAX roofline probe's dots-only kernel is nested in its ``main()``
and cannot be imported, so its seven products are restated here in ``jnp``
(``tools/bench/attention_roofline.py:155-194``).

Both at S that cut the CUDA kernels' 64-row tiles (37, 65, 129) as well as
at the JAX tests' own sizes; the plain versions' ``kv_len`` (the check
``chip_smoke.py`` makes that the limits fail a kernel one key short) against
a numpy restatement; and the wrappers' refusals of what the kernels do not
take.

Tolerances: fp32 1e-5 relative (the same arithmetic, sums in another order),
bf16 2e-2 (roundings at places that may differ by one: the JAX #11 rounds
each of its four outputs and adds in bf16, the port sums in fp32 and rounds
once), each with an absolute part of the same size times the RMS of the
reference (outputs of #11 reach the hundreds)."""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from vision_pt_tpu_torch.benchmarks import _jit_train_setup
from vision_pt_tpu_torch.models.jit import DenoiserConfig
from vision_pt_tpu_torch.tools.bench import attention_pairing_probe as pairing
from vision_pt_tpu_torch.tools.bench import attention_roofline as roofline

ROOT = pathlib.Path(__file__).resolve().parent.parent
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
BATCH, SEQ, HEADS, DIM = 2, 24, 2, 64


@pytest.fixture(scope="module")
def jax_pairing():
    """The JAX pairing probe, loaded by path with its import's config change
    put back."""
    prev = jax.config.jax_compilation_cache_dir
    path = ROOT / "tools" / "bench" / "attention_pairing_probe.py"
    spec = importlib.util.spec_from_file_location("jax_attention_pairing_probe", path)
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)
    return module


def _x(seq=SEQ, seed=0, std=1.0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(BATCH, seq, HEADS * DIM)).astype(np.float32) * std


def _assert_close(ours, theirs, dtype):
    ours = np.asarray(ours, np.float32)
    theirs = np.asarray(theirs, np.float32)
    assert np.isfinite(ours).all()
    tol = TOL[dtype]
    rms = float(np.sqrt(np.mean(theirs**2)))
    np.testing.assert_allclose(ours, theirs, rtol=tol, atol=tol * rms)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("body", ["_base_kernel", "_paired_kernel"])
@pytest.mark.parametrize("seq", [SEQ, 37, 65, 129])
def test_pairing_probe_plain_matches_jax(jax_pairing, monkeypatch, seq, body, dtype):
    for name, value in dict(B=BATCH, S=seq, H=HEADS, D=DIM, E=HEADS * DIM,
                            SCALE=DIM**-0.5).items():
        monkeypatch.setattr(jax_pairing, name, value)
    # std 0.5: at std 1 and D 64 each row's p is nearly one-hot, and dq + dk
    # come from dp - delta with both near 64, where fp32 sums in another
    # order differ by 1e-5 of the result (measured 5.9x the fp32 limit);
    # at std 0.5 the largest error is 0.05 of it
    x = _x(seq=seq, std=0.5)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    spec = pl.BlockSpec((1, seq, HEADS * DIM), lambda b: (b, 0, 0))
    theirs = pl.pallas_call(
        getattr(jax_pairing, body), grid=(BATCH,), in_specs=[spec],
        out_specs=[spec, spec],
        out_shape=[jax.ShapeDtypeStruct(jx.shape, jx.dtype)] * 2,
        interpret=True,
    )(jx)
    ours = pairing.run_variant_reference(torch.from_numpy(x).to(getattr(torch, dtype)),
                                         HEADS)
    for a, b in zip(ours, theirs):
        assert a.dtype == getattr(torch, dtype) and a.shape == x.shape
        _assert_close(a.float().numpy(), b.astype(jnp.float32), dtype)


def _jax_dots_only(x, heads, dim):
    """``_dots_only_kernel`` (tools/bench/attention_roofline.py:155-194),
    restated over a whole (B, S, H*D) array, and ``dots_variant``'s sum of
    its four outputs (:263)."""
    def dot(a, b, dims):
        return jax.lax.dot_general(a, b, (dims, ((), ())),
                                   preferred_element_type=jnp.float32)

    outs = []
    for xb in x:
        per_head = []
        for h in range(heads):
            qh = kh = vh = doh = xb[:, h * dim:(h + 1) * dim]
            s = dot(qh, kh, ((1,), (1,)))                 # fwd QK^T
            o = dot(s.astype(qh.dtype), vh, ((1,), (0,)))  # fwd PV
            s2 = dot(qh, kh, ((1,), (1,)))                # bwd QK^T recompute
            p = s2.astype(qh.dtype)
            dv = dot(p, doh, ((0,), (0,)))                # p^T do
            dp = dot(doh, vh, ((1,), (1,)))               # do v^T
            ds = dp.astype(qh.dtype)
            dq = dot(ds, kh, ((1,), (0,)))                # ds k
            dk = dot(ds, qh, ((0,), (0,)))                # ds^T q
            o, dq, dk, dv = (t.astype(x.dtype) for t in (o, dq, dk, dv))
            per_head.append((o + dq + dk + dv).astype(x.dtype))
        outs.append(jnp.concatenate(per_head, axis=1))
    return jnp.stack(outs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seq", [32, 37, 65, 129])
def test_dots_probe_plain_matches_jax(seq, dtype):
    x = _x(seq=seq, seed=1)
    theirs = _jax_dots_only(jnp.asarray(x, getattr(jnp, dtype)), HEADS, DIM)
    ours = roofline.dots_variant_reference(
        torch.from_numpy(x).to(getattr(torch, dtype)), HEADS)
    assert ours.dtype == getattr(torch, dtype) and ours.shape == x.shape
    _assert_close(ours.float().numpy(), theirs.astype(jnp.float32), dtype)


def test_probe_wrappers_take_the_plain_version_on_the_cpu_only():
    x = torch.from_numpy(_x())
    for a, b in zip(pairing.run_variant(x, HEADS),
                    pairing.run_variant_reference(x, HEADS)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(roofline.dots_variant(x, HEADS),
                               roofline.dots_variant_reference(x, HEADS),
                               rtol=0, atol=0)
    assert pairing.run_variant.launches == roofline.dots_variant.launches == 0
    meta = torch.zeros(1, 8, 128, device="meta")
    for fn in (pairing.run_variant, roofline.dots_variant):
        with pytest.raises(ValueError, match="no kernel"):
            fn(meta, HEADS)


def _numpy_heads(x):
    """(B, H, S, D) float64 heads of a (B, S, H*D) array."""
    b, s, _ = x.shape
    return x.astype(np.float64).reshape(b, s, HEADS, DIM).transpose(0, 2, 1, 3)


def _numpy_merge(t):
    b, h, s, d = t.shape
    return t.transpose(0, 2, 1, 3).reshape(b, s, h * d)


def test_pairing_probe_plain_kv_len_drops_the_last_keys():
    """``kv_len`` n: the softmax runs over keys [0, n) only, and the key rows
    from n on get no dv, dk; n = S is the probe's own function, bit for bit."""
    x = _x(seq=37, seed=2, std=0.5)
    n = 36
    q = _numpy_heads(x)
    k = v = q[:, :, :n]  # do = q: every row
    scale = DIM**-0.5
    s = np.clip(q @ k.transpose(0, 1, 3, 2) * scale * pairing.LOG2E,
                -pairing.CLIP, pairing.CLIP)
    e = np.exp2(s)
    denom = e.sum(-1, keepdims=True)
    p = e / denom
    dp = q @ v.transpose(0, 1, 3, 2)
    delta = (p * dp).sum(-1, keepdims=True)
    ds = p * (dp - delta)
    o = (e @ v) / denom
    dq = ds @ k * scale
    dv = np.zeros_like(q)
    dk = np.zeros_like(q)
    dv[:, :, :n] = p.transpose(0, 1, 3, 2) @ q
    dk[:, :, :n] = ds.transpose(0, 1, 3, 2) @ q * scale
    ours = pairing.run_variant_reference(torch.from_numpy(x), HEADS, kv_len=n)
    for a, b in zip(ours, (_numpy_merge(o + dv), _numpy_merge(dq + dk))):
        _assert_close(a.numpy(), b, "float32")
    full = torch.from_numpy(x)
    for a, b in zip(pairing.run_variant_reference(full, HEADS, kv_len=37),
                    pairing.run_variant_reference(full, HEADS)):
        assert torch.equal(a, b)


def test_dots_probe_plain_kv_len_drops_the_last_keys():
    """``kv_len`` n: s and dp over keys [0, n) only, and the key rows from n
    on get no dv, dk; n = S is the probe's own function, bit for bit."""
    x = _x(seq=65, seed=3)
    n = 64
    q = _numpy_heads(x)
    k = v = q[:, :, :n]
    s = q @ k.transpose(0, 1, 3, 2)
    dp = q @ v.transpose(0, 1, 3, 2)
    out = s @ v + dp @ k
    out[:, :, :n] += s.transpose(0, 1, 3, 2) @ q + dp.transpose(0, 1, 3, 2) @ q
    ours = roofline.dots_variant_reference(torch.from_numpy(x), HEADS, kv_len=n)
    _assert_close(ours.numpy(), _numpy_merge(out), "float32")
    full = torch.from_numpy(x)
    assert torch.equal(roofline.dots_variant_reference(full, HEADS, kv_len=65),
                       roofline.dots_variant_reference(full, HEADS))


def test_probe_wrappers_refuse_what_their_kernels_do_not_take():
    """Off the CPU a wrapper launches its kernel or raises: it names a device
    that is not CUDA, a dtype other than bfloat16 and a head dim other than
    64 (here on the meta device, where no kernel runs)."""
    def meta(width, dtype):
        return torch.zeros(2, 40, width, device="meta", dtype=dtype)

    for fn in (pairing.run_variant, roofline.dots_variant):
        with pytest.raises(ValueError, match=r"float32: the kernel takes .*bfloat16"):
            fn(meta(HEADS * DIM, torch.float32), HEADS)
        with pytest.raises(ValueError, match=r"float16: the kernel takes"):
            fn(meta(HEADS * DIM, torch.float16), HEADS)
        with pytest.raises(ValueError, match=r"\(2, 40, 160\).*H\*64"):
            fn(meta(HEADS * 80, torch.bfloat16), HEADS)
        with pytest.raises(ValueError, match=r"^no kernel for device meta$"):
            fn(meta(HEADS * DIM, torch.bfloat16), HEADS)
        with pytest.raises(ValueError, match="the kernel takes"):
            fn(torch.zeros(40, HEADS * DIM, device="meta", dtype=torch.bfloat16),
               HEADS)
    assert pairing.run_variant.launches == roofline.dots_variant.launches == 0


def test_probe_main_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (pairing.main, roofline.main):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            main()


TINY = DenoiserConfig(patch_size=4, hidden_size=64, depth=2, num_heads=2,
                      rope_axes_dims=[8, 12, 12])


def test_jit_train_setup_steps_on_the_cpu():
    """The headline training step, tiny: finite losses, the parameters move,
    and the same seeds give the same step."""
    first = _jit_train_setup(TINY, 2, 16, dtype=None, param_dtype=torch.float32,
                             device="cpu")
    before = [p.detach().clone() for p in first.model.parameters()]
    losses = [float(first.step(i)) for i in range(3)]
    assert np.isfinite(losses).all() and len(set(losses)) == 3
    assert any(not torch.equal(a, b) for a, b in zip(before, first.model.parameters()))
    again = _jit_train_setup(TINY, 2, 16, dtype=None, param_dtype=torch.float32,
                             device="cpu")
    assert float(again.step(0)) == losses[0]
