"""The port's ring attention (``ops/ring_attention.py``) and its
``sequence_parallel`` dispatch, on a 4-rank gloo group on the CPU, against
the JAX package's ``ring_attention_sharded`` on ``make_mesh({"data": -1,
"seq": 4})`` (the 8-device CPU mesh) and against the port's plain attention.

One spawn of 4 processes runs every case (each rank writes its results to a
file); the tests read them. fp32 within 1e-5 (outputs) and 1e-4
(gradients). bf16 (odd batch) against the fp32 ring on the same
bf16-rounded inputs, in units of the ``kernel`` phase's limit
2e-2 * (RMS(ref) + |ref|): within 1, or within 1.5 times JAX's own bf16
ring where bf16 alone takes that past 1 (dq: the bf16-rounded output enters
the backward's delta in both packages; measured 1.15 in JAX, 1.15 here).
The JAX side runs in this process while the ranks work; the ranks import no
JAX.
"""

import datetime
import os
import time

import numpy as np
import pytest
import torch

WORLD = 4
B, S, H, D = 2, 64, 3, 8
BF16_TOL = 2e-2


def _inputs(batch, s, seed):
    rng = np.random.default_rng(seed)
    q, k, v, w = (rng.normal(size=(batch, s, H, D)).astype(np.float32) for _ in range(4))
    return q, k, v, w


KV_LENS = np.array([37, 0, 64], np.int32)  # 37 crosses a shard edge; one row empty
# plain attention gives a row with no valid key the mean of v, the ring 0
# (as the JAX package's ring and flash kernel do): held against plain on the
# other rows
PLAIN_ROWS = {"fp32": slice(None), "kv_lens": [0, 2]}


# ------------------------------------------------------------------ ranks


def _ring_case(mesh, q, k, v, w, kv_lens, dtype):
    from vision_pt_tpu_torch.ops.ring_attention import ring_attention_sharded

    q, k, v = (torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v))
    lens = None if kv_lens is None else torch.from_numpy(kv_lens)
    out = ring_attention_sharded(q, k, v, mesh, "seq", kv_lens=lens)
    (out.float() * torch.from_numpy(w)).sum().backward()
    return {"out": out.detach().float().numpy(),
            **{f"d{n}": x.grad.float().numpy() for n, x in zip("qkv", (q, k, v))}}


def _plain_case(q, k, v, w, kv_lens):
    from vision_pt_tpu_torch.ops.attention import plain_attention

    q, k, v = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    lens = None if kv_lens is None else torch.from_numpy(kv_lens)
    out = plain_attention(q, k, v, kv_lens=lens)
    (out * torch.from_numpy(w)).sum().backward()
    return {"out": out.detach().numpy(),
            **{f"d{n}": x.grad.numpy() for n, x in zip("qkv", (q, k, v))}}


def _dispatch_case(mesh):
    from vision_pt_tpu_torch.ops import attention as tattn

    q, k, _, _ = _inputs(2, S, 3)
    q, k = torch.from_numpy(q), torch.from_numpy(k)
    q30 = q[:, :30].contiguous()
    mask = torch.ones(2, S, dtype=torch.bool)
    results = {}
    with tattn.attention_dtype(None):
        plain = tattn.dot_product_attention(q, q, q, backend="xla")
        with tattn.sequence_parallel(mesh):
            before = tattn.ring_dispatch_count()
            out = tattn.dot_product_attention(q, q, q)
            results["auto_rings"] = tattn.ring_dispatch_count() - before
            results["auto_err"] = float((out - plain).abs().max())
            before = tattn.ring_dispatch_count()
            fallbacks = {
                "mask": (tattn.dot_product_attention(q, q, q, mask=mask),
                         tattn.dot_product_attention(q, q, q, mask=mask, backend="xla")),
                "causal": (tattn.dot_product_attention(q, q, q, is_causal=True),
                           tattn.dot_product_attention(q, q, q, is_causal=True,
                                                       backend="xla")),
                "cross": (tattn.dot_product_attention(q, k[:, :32], k[:, :32]),
                          tattn.dot_product_attention(q, k[:, :32], k[:, :32],
                                                      backend="xla")),
                "indivisible": (tattn.dot_product_attention(q30, q30, q30),
                                tattn.dot_product_attention(q30, q30, q30, backend="xla")),
            }
            results["fallback_rings"] = tattn.ring_dispatch_count() - before
            results["fallback_err"] = {n: float((a - b).abs().max())
                                       for n, (a, b) in fallbacks.items()}
            try:
                tattn.dot_product_attention(q30, q30, q30, backend="ring")
                results["ring_raises"] = None
            except ValueError as e:
                results["ring_raises"] = str(e)
    return results


def _block_case(mesh, block_state, x, kv_lens):
    from vision_pt_tpu_torch.models.jit.convert import from_jax_state
    from vision_pt_tpu_torch.models.jit.denoiser import JiTBlock, RopeEmbedder
    from vision_pt_tpu_torch.ops import attention as tattn

    block = JiTBlock(hidden_dim=64, num_heads=2)
    block.load_state_dict(from_jax_state(block_state), strict=True)
    embedder = RopeEmbedder(axes_dims=(16, 8, 8))
    freqs = torch.from_numpy(embedder(embedder.prepare_context_position_ids(x.shape[1])))
    x = torch.from_numpy(x).requires_grad_()
    with tattn.attention_dtype(None), tattn.sequence_parallel(mesh):
        before = tattn.ring_dispatch_count()
        out = block(x, freqs, kv_lens=torch.from_numpy(kv_lens))
        loss = (out**2).sum()
        loss.backward()
        rings = tattn.ring_dispatch_count() - before
    return {"out": out.detach().numpy(), "loss": float(loss), "dx": x.grad.numpy(),
            "grads": {n: p.grad.numpy() for n, p in block.named_parameters()},
            "rings": rings}


def _rank_main(rank, store, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    inputs = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    block_state, block_x, block_lens = inputs["state"], inputs["x"], inputs["kv_lens"]
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=60))
    from vision_pt_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh({"data": 1, "seq": WORLD})
    q, k, v, w = _inputs(B, S, 0)
    q3, k3, v3, w3 = _inputs(3, S, 1)
    cases = {
        "fp32": lambda: _ring_case(mesh, q, k, v, w, None, torch.float32),
        "kv_lens": lambda: _ring_case(mesh, q3, k3, v3, w3, KV_LENS, torch.float32),
        "bf16_odd_batch": lambda: _ring_case(mesh, q3, k3, v3, w3, KV_LENS,
                                             torch.bfloat16),
        "dispatch": lambda: _dispatch_case(mesh),
        "block": lambda: _block_case(mesh, block_state, block_x, block_lens),
    }
    results = {}
    for name, case in cases.items():
        try:
            results[name] = case()
        except Exception as e:  # recorded; the test of the case reports it
            results[name] = {"error": f"{type(e).__name__}: {e}"}
    try:
        from vision_pt_tpu_torch.ops.ring_attention import ring_attention_sharded

        x30 = torch.zeros(2, 30, H, D)
        ring_attention_sharded(x30, x30, x30, mesh)
        results["indivisible"] = None
    except AssertionError as e:
        results["indivisible"] = str(e)
    torch.save(results, os.path.join(out_dir, f"rank{rank}.pt"))
    dist.destroy_process_group()


def _spawn(out_dir, inputs):
    """Start the ranks on ``inputs`` (handed over in a file: arguments
    larger than a pipe's buffer hold each start until the child has
    imported); returns a function that waits for them (at most 240 s) and
    loads every rank's results."""
    import torch.multiprocessing as mp

    torch.save(inputs, os.path.join(out_dir, "inputs.pt"))
    store = os.path.join(out_dir, "store")
    ctx = mp.start_processes(_rank_main, args=(store, out_dir), nprocs=WORLD,
                             join=False, start_method="spawn")

    def wait():
        deadline = time.monotonic() + 240
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError("the gloo ranks did not finish in 240 s")
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(WORLD)]

    return wait


# ------------------------------------------------------------------ JAX side


def _jax_block():
    """A JAX JiT block with perturbed gains and biases, its inputs, and its
    one-device output, loss and gradients (fp32)."""
    import jax
    import jax.numpy as jnp
    from flax import nnx

    from vision_pt_tpu.models.jit.denoiser import JiTBlock, RopeEmbedder
    from vision_pt_tpu.ops.attention import attention_dtype
    from vision_pt_tpu.utils.state_dict import _path_to_key, flatten_state, load_flat_state

    block = JiTBlock(hidden_dim=64, num_heads=2, rngs=nnx.Rngs(0))
    rng = np.random.default_rng(5)
    flat = {}
    for key, value in flatten_state(block).items():
        value = np.asarray(value)
        if "norm" in key:
            value = rng.uniform(0.5, 1.5, size=value.shape).astype(np.float32)
        elif key.endswith(".bias"):
            value = rng.normal(0, 0.02, size=value.shape).astype(np.float32)
        flat[key] = value
    load_flat_state(block, flat)
    embedder = RopeEmbedder(axes_dims=(16, 8, 8))
    freqs = jnp.asarray(embedder(embedder.prepare_context_position_ids(S)))
    x = rng.normal(size=(2, S, 64)).astype(np.float32)
    kv_lens = np.array([S, S - 17], np.int32)
    graphdef, params = nnx.split(block)

    def loss_fn(params, x):
        return (nnx.merge(graphdef, params)(x, freqs, kv_lens=jnp.asarray(kv_lens)) ** 2).sum()

    def out_fn(params, x):
        return nnx.merge(graphdef, params)(x, freqs, kv_lens=jnp.asarray(kv_lens))

    with attention_dtype(None):  # jitted: eager, the block takes 15 s
        out = jax.jit(out_fn)(params, jnp.asarray(x))
        loss, (gp, gx) = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1)))(
            params, jnp.asarray(x))
    grads = {_path_to_key(tuple(p)): np.asarray(v.value)
             for p, v in nnx.to_flat_state(gp)}
    return flat, x, kv_lens, {"out": np.asarray(out), "loss": float(loss),
                              "dx": np.asarray(gx), "grads": grads}


def _jax_ring(q, k, v, w, kv_lens, dtype):
    import jax
    import jax.numpy as jnp

    from vision_pt_tpu.ops.ring_attention import ring_attention_sharded
    from vision_pt_tpu.parallel.mesh import make_mesh

    mesh = make_mesh({"data": -1, "seq": 4})
    lens = None if kv_lens is None else jnp.asarray(kv_lens)

    def loss(q, k, v):
        out = ring_attention_sharded(q, k, v, mesh, "seq", kv_lens=lens)
        return (out.astype(jnp.float32) * w).sum(), out

    args = [jnp.asarray(x, dtype) for x in (q, k, v)]
    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        *args)
    return {"out": np.asarray(out.astype(jnp.float32)),
            **{f"d{n}": np.asarray(g.astype(jnp.float32)) for n, g in zip("qkv", grads)}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax.numpy as jnp

    out_dir = str(tmp_path_factory.mktemp("ring"))
    state, x, lens, block_ref = _jax_block()
    wait = _spawn(out_dir, {"state": state, "x": x, "kv_lens": lens})
    q, k, v, w = _inputs(B, S, 0)
    q3, k3, v3, w3 = _inputs(3, S, 1)
    jax_refs = {
        "fp32": _jax_ring(q, k, v, w, None, jnp.float32),
        "kv_lens": _jax_ring(q3, k3, v3, w3, KV_LENS, jnp.float32),
        "bf16_odd_batch": _jax_ring(q3, k3, v3, w3, KV_LENS, jnp.bfloat16),
        "bf16_inputs_fp32": _jax_ring(*(np.asarray(jnp.asarray(x, jnp.bfloat16),
                                                   np.float32) for x in (q3, k3, v3)),
                                      w3, KV_LENS, jnp.float32),
        "block": block_ref,
    }
    plain = {"fp32": _plain_case(q, k, v, w, None),
             "kv_lens": _plain_case(q3, k3, v3, w3, KV_LENS)}
    ranks = wait()
    return ranks, jax_refs, plain


def _ok(result):
    assert "error" not in result, result["error"]
    return result


def _close(ours, theirs, atol, what):
    np.testing.assert_allclose(ours, theirs, rtol=atol, atol=atol, err_msg=what)


@pytest.mark.parametrize("case", ["fp32", "kv_lens"])
def test_ring_forward_matches_jax_and_plain(runs, case):
    ranks, jax_refs, plain = runs
    for rank in ranks:  # every seq rank holds the whole output
        ours = _ok(rank[case])
        rows = PLAIN_ROWS[case]
        _close(ours["out"], jax_refs[case]["out"], 1e-5, "vs JAX")
        _close(ours["out"][rows], plain[case]["out"][rows], 1e-5, "vs plain")
    if case == "kv_lens":  # the row with no valid key is 0, as in JAX
        assert np.all(ranks[0][case]["out"][1] == 0)


@pytest.mark.parametrize("case", ["fp32", "kv_lens"])
def test_ring_gradients_match_jax_and_plain(runs, case):
    ranks, jax_refs, plain = runs
    for rank in ranks:
        ours = _ok(rank[case])
        rows = PLAIN_ROWS[case]
        for g in ("dq", "dk", "dv"):
            _close(ours[g], jax_refs[case][g], 1e-4, f"{g} vs JAX")
            _close(ours[g][rows], plain[case][g][rows], 1e-4, f"{g} vs plain")
    if case == "kv_lens":  # keys past kv_len get no gradient
        ours = ranks[0][case]
        assert np.all(ours["dk"][0, 37:] == 0) and np.all(ours["dv"][0, 37:] == 0)
        assert np.all(ours["dq"][1] == 0)


def test_ring_bf16_odd_batch_within_the_kernel_limit(runs):
    ranks, jax_refs, _ = runs
    ours, theirs = _ok(ranks[0]["bf16_odd_batch"]), jax_refs["bf16_odd_batch"]
    for name in ("out", "dq", "dk", "dv"):
        ref = jax_refs["bf16_inputs_fp32"][name]
        limit = BF16_TOL * (np.sqrt(np.mean(ref**2)) + np.abs(ref))
        ours_units = np.max(np.abs(ours[name] - ref) / limit)
        jax_units = np.max(np.abs(theirs[name] - ref) / limit)
        assert ours_units <= max(1.0, 1.5 * jax_units), (name, ours_units, jax_units)


def test_ring_needs_a_divisible_sequence(runs):
    ranks, _, _ = runs
    assert all("not divisible by mesh axis seq=4" in r["indivisible"] for r in ranks)


def test_sequence_parallel_dispatch(runs):
    ranks, _, _ = runs
    for rank in ranks:
        d = _ok(rank["dispatch"])
        assert d["auto_rings"] == 1 and d["auto_err"] <= 1e-5
        assert d["fallback_rings"] == 0
        assert max(d["fallback_err"].values()) == 0.0, d["fallback_err"]
        assert "divisible" in d["ring_raises"]


def test_jit_block_forward_and_backward_under_the_ring(runs):
    ranks, jax_refs, _ = runs
    ref = jax_refs["block"]
    from vision_pt_tpu_torch.models.jit.convert import from_jax_state

    ref_grads = {k: v.numpy() for k, v in from_jax_state(ref["grads"]).items()}
    for rank in ranks:
        ours = _ok(rank["block"])
        assert ours["rings"] == 1  # the block's one attention
        _close(ours["out"], ref["out"], 1e-5, "out")
        np.testing.assert_allclose(ours["loss"], ref["loss"], rtol=1e-5)
        _close(ours["dx"], ref["dx"], 1e-4, "dx")
        assert ours["grads"].keys() == ref_grads.keys()
        for name, g in ref_grads.items():
            _close(ours["grads"][name], g, 1e-4, name)
