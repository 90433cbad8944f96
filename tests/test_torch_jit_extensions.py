"""The port's JiT variants (PoPE, U-JiT, Cross-JiT, IG, LoIG, TREAD) against
the JAX package's, on the JAX tests' tiny config, with JAX parameters
crossing over through ``convert.from_jax_state`` and inputs made with numpy.

Tolerances: fp32 on both sides under ``attention_dtype(None)``; the forward
within 1e-5 relative L2 (measured 3e-8 to 1.1e-7: both sides compute the
same fp32 arithmetic and differ only in the order of sums); PoPE's tables
within 1e-6 absolute (both are NumPy in float64 rounded to fp32)."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import vision_pt_tpu.models.jit.config as jcfg
import vision_pt_tpu.models.jit.denoiser as jden
import vision_pt_tpu.models.jit.extension.cross as jcross
import vision_pt_tpu.models.jit.extension.ig as jig
import vision_pt_tpu.models.jit.extension.loig as jloig
import vision_pt_tpu.models.jit.extension.pope as jpope
import vision_pt_tpu.models.jit.extension.tread as jtread
import vision_pt_tpu.models.jit.extension.uvit as juvit
from vision_pt_tpu.models.jit.pipeline import JiTModel as JaxJiTModel
from vision_pt_tpu.ops import attention as jattn
from vision_pt_tpu.ops.short_attention import short_attention_packed as jax_packed
from vision_pt_tpu.utils.state_dict import flatten_state, load_flat_state
import vision_pt_tpu_torch.models.jit.config as tcfg
import vision_pt_tpu_torch.models.jit.denoiser as tden
import vision_pt_tpu_torch.models.jit.extension.cross as tcross
import vision_pt_tpu_torch.models.jit.extension.ig as tig
import vision_pt_tpu_torch.models.jit.extension.loig as tloig
import vision_pt_tpu_torch.models.jit.extension.pope as tpope
import vision_pt_tpu_torch.models.jit.extension.tread as ttread
import vision_pt_tpu_torch.models.jit.extension.uvit as tuvit
from vision_pt_tpu_torch.models.jit.convert import from_jax_state
from vision_pt_tpu_torch.models.jit.pipeline import JiTModel
from vision_pt_tpu_torch.ops import attention as tattn
from tests.test_torch_sdxl_distributed import one_torch_thread  # noqa: F401,E402

TINY = dict(
    patch_size=4, hidden_size=64, depth=4, num_heads=2, bottleneck_dim=16,
    context_dim=32, context_start_block=1, rope_axes_dims=[8, 12, 12],
    num_time_tokens=2,
)
FWD_TOL = 1e-5  # relative L2, fp32
TABLE_ATOL = 1e-6

# variant -> (JAX denoiser, JAX config, port denoiser, port config,
#             JAX pipeline, port pipeline)
FAMILY = {
    "jit": (jden.JiT, jcfg.DenoiserConfig, tden.JiT, tcfg.DenoiserConfig,
            jcfg.JiTConfig, JaxJiTModel, tcfg.JiTConfig, JiTModel),
    "ujit": (juvit.UJiT, juvit.UJiTDenoiserConfig, tuvit.UJiT,
             tuvit.UJiTDenoiserConfig, juvit.UJiTConfig, juvit.UJiTModel,
             tuvit.UJiTConfig, tuvit.UJiTModel),
    "cross": (jcross.CrossJiT, jcross.CrossJiTDenoiserConfig, tcross.CrossJiT,
              tcross.CrossJiTDenoiserConfig, jcross.CrossJiTConfig,
              jcross.CrossJiTModel, tcross.CrossJiTConfig, tcross.CrossJiTModel),
    "ig": (jig.IGJiT, jig.IGJiTDenoiserConfig, tig.IGJiT, tig.IGJiTDenoiserConfig,
           jig.IGJiTConfig, jig.IGJiTModel, tig.IGJiTConfig, tig.IGJiTModel),
    "loig": (jloig.LoIGJiT, jloig.LoIGJiTDenoiserConfig, tloig.LoIGJiT,
             tloig.LoIGJiTDenoiserConfig, jloig.LoIGJiTConfig,
             jloig.LoIGJiTModel, tloig.LoIGJiTConfig, tloig.LoIGJiTModel),
    "tread": (jtread.JiTWithTread, jtread.JiTWithTreadDenoiserConfig,
              ttread.JiTWithTread, ttread.JiTWithTreadDenoiserConfig,
              jtread.JiTWithTreadConfig, jtread.JiTWithTreadModel,
              ttread.JiTWithTreadConfig, ttread.JiTWithTreadModel),
}

TREAD = {"tread_start_block": 1, "tread_end_block": 3}
CASES = {
    "jit-pope": ("jit", {"positional_encoding": "pope"}),
    "jit-npope": ("jit", {"positional_encoding": "n-pope"}),
    "jit-pope-layernorm": ("jit", {"positional_encoding": "pope",
                                   "norm_type": "layer"}),
    "ujit": ("ujit", {"depth": 2, "num_blocks": 6}),
    "ujit-pope-pre": ("ujit", {"depth": 1, "num_blocks": 4,
                               "positional_encoding": "pope",
                               "norm_position": "pre"}),
    "ujit-post-fuse": ("ujit", {"depth": 1, "num_blocks": 3,
                                "norm_position": "post",
                                "do_context_fuse": True}),
    "cross": ("cross", {}),
    "cross-pope": ("cross", {"positional_encoding": "pope"}),
    "cross-pre": ("cross", {"norm_position": "pre", "depth": 3}),
    "ig": ("ig", {"intermediate_output_idx": 1}),
    "ig-bottleneck": ("ig", {"intermediate_output_idx": 3,
                             "use_output_bottleneck": True}),
    "loig": ("loig", {"internal_rank": 4}),
    "tread": ("tread", TREAD),
    "tread-fuse": ("tread", {**TREAD, "do_context_fuse": True,
                             "tread_route_rate": 0.25}),
}
MASK = np.array([[1, 1, 1, 0, 0], [1, 1, 1, 1, 1]], np.int32)


def rel_l2(ours, theirs) -> float:
    ours, theirs = np.asarray(ours, np.float64), np.asarray(theirs, np.float64)
    return float(np.linalg.norm(ours - theirs) / np.linalg.norm(theirs))


def perturb(flat: dict, seed: int = 0) -> dict:
    """Non-unit norm gains, nonzero biases, and PoPE phase biases past +-pi
    (so the clip acts)."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, value in flat.items():
        value = np.asarray(value)
        if "pope_bias" in key:
            value = rng.uniform(-4, 4, size=value.shape).astype(np.float32)
        elif "norm" in key:
            value = rng.uniform(0.5, 1.5, size=value.shape).astype(np.float32)
        elif key.endswith(".bias"):
            value = rng.normal(0, 0.02, size=value.shape).astype(np.float32)
        out[key] = value
    return out


def make_pair(case: str):
    family, overrides = CASES[case]
    jclass, jconfig, tclass, tconfig = FAMILY[family][:4]
    cfg = {**TINY, **overrides}
    jmodel = jclass(jconfig(**cfg), rngs=nnx.Rngs(0))
    flat = perturb(flatten_state(jmodel))
    load_flat_state(jmodel, flat)
    tmodel = tclass(tconfig(**cfg), device="cpu")
    tmodel.load_state_dict(from_jax_state(flat), strict=True)
    return jmodel, tmodel


def make_inputs(batch=2, size=16, context_len=5, seed=1):
    rng = np.random.default_rng(seed)
    return dict(
        image=rng.normal(size=(batch, size, size, 3)).astype(np.float32),
        timestep=rng.uniform(0, 1, size=batch).astype(np.float32),
        context=rng.normal(size=(batch, context_len, 32)).astype(np.float32),
        original_size=np.full((batch, 2), size, np.float32),
        target_size=np.full((batch, 2), size, np.float32),
        crop_coords=np.zeros((batch, 2), np.float32),
    )


def run_both(jmodel, tmodel, mask, route_seed=None):
    """Both forwards in fp32; TREAD routes with JAX's permutation of
    ``route_seed``'s key handed to the port."""
    inputs = make_inputs()
    jextra, textra = {}, {}
    if route_seed is not None:
        key = jax.random.key(route_seed)
        jextra["route_key"] = key
        textra["route_perm"] = torch.from_numpy(
            np.array(jax.random.permutation(key, 16)))
    with jattn.attention_dtype(None), tattn.attention_dtype(None):
        theirs = jmodel(**{k: jnp.asarray(v) for k, v in inputs.items()},
                        context_mask=None if mask is None else jnp.asarray(mask),
                        **jextra)
        with torch.no_grad():
            ours = tmodel(**{k: torch.from_numpy(v) for k, v in inputs.items()},
                          context_mask=None if mask is None else torch.from_numpy(mask),
                          **textra)
    if not isinstance(theirs, tuple):
        theirs, ours = (theirs,), (ours,)
    return [o.numpy() for o in ours], [np.asarray(t) for t in theirs]


# ------------------------------------------------------------------ PoPE


@pytest.mark.parametrize("with_bias", [False, True], ids=["nobias", "bias"])
def test_apply_pope_matches_jax(with_bias):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 6, 2, 8)).astype(np.float32) * 3
    emb = jpope.PopeEmbedder(axes_dims=(8,), axes_lens=(16,), zero_centered=(False,))
    freqs = emb(np.arange(6, dtype=np.float32).reshape(6, 1))
    bias = rng.uniform(-3, 3, size=(2, 8)).astype(np.float32) if with_bias else None
    theirs = jpope.apply_pope(jnp.asarray(x), jnp.asarray(freqs),
                              None if bias is None else jnp.asarray(bias))
    ours = tpope.apply_pope(torch.from_numpy(x), torch.from_numpy(freqs),
                            None if bias is None else torch.from_numpy(bias))
    assert ours.shape == (2, 6, 2, 16)
    assert rel_l2(ours.numpy(), theirs) <= FWD_TOL
    # the magnitude of each (re, im) pair is softplus(x), computed in fp32
    pairs = ours.numpy().reshape(2, 6, 2, 8, 2)
    np.testing.assert_allclose(np.linalg.norm(pairs, axis=-1),
                               np.logaddexp(0, x), rtol=1e-5)


def test_apply_pope_keeps_the_input_dtype():
    x = torch.randn(1, 3, 1, 4, dtype=torch.bfloat16)
    freqs = torch.rand(3, 4, 2)
    assert tpope.apply_pope(x, freqs).dtype == torch.bfloat16


@pytest.mark.parametrize("kind", ["PopeEmbedder", "NormalizedPopeEmbedder"])
def test_pope_embedders_match_jax(kind):
    kw = dict(pope_theta=256.0, axes_dims=(8, 12, 12), axes_lens=(256, 128, 128),
              zero_centered=(False, True, True), do_normalize=(False, True, True),
              normalize_by=64.0)
    theirs, ours = getattr(jpope, kind)(**kw), getattr(tpope, kind)(**kw)
    for args in ((32, 48, 4, 3), (16, 16, 4, 3)):
        np.testing.assert_array_equal(ours.prepare_image_position_ids(*args),
                                      theirs.prepare_image_position_ids(*args))
    pos = [theirs.prepare_image_position_ids(32, 48, 4, 3),
           theirs.prepare_context_position_ids(6, 2),
           theirs.prepare_context_position_ids(5, 0)]
    for p in pos:
        table = ours(p)
        assert table.shape == (p.shape[0], 32, 2)  # full-dim, not paired
        np.testing.assert_allclose(table, theirs(p), atol=TABLE_ATOL, rtol=0)


def test_frequency_tables_match_jax_and_key_on_the_embedder():
    """The denoiser's whole-sequence table, per segment, for RoPE, PoPE and
    normalized PoPE, and one cache entry per embedder kind."""
    for pe in ("rope", "pope", "n-pope"):
        cfg = {**TINY, "positional_encoding": pe}
        jmodel = jden.JiT(jcfg.DenoiserConfig(**cfg), rngs=nnx.Rngs(0))
        tmodel = tden.JiT(tcfg.DenoiserConfig(**cfg), device="cpu")
        ours = tmodel._freqs_for(16, 24, 5, torch.device("cpu")).numpy()
        np.testing.assert_allclose(ours, jmodel._freqs_for(16, 24, 5),
                                   atol=TABLE_ATOL, rtol=0)
        assert [k[0] for k in tmodel._freqs_cache] == [
            type(tmodel.rope_embedder).__name__]


@pytest.mark.parametrize("masking", ["none", "kv_lens", "mask"])
def test_pope_attention_matches_jax(masking):
    """PopeAttention alone: q/k at 2 * head_dim and v at head_dim through the
    plain attention, with suffix kv_lens, a key mask, or neither."""
    rng = np.random.default_rng(2)
    jattn_mod = jpope.PopeAttention(dim=64, num_heads=2, rngs=nnx.Rngs(0))
    flat = perturb(flatten_state(jattn_mod))
    load_flat_state(jattn_mod, flat)
    tattn_mod = tpope.PopeAttention(dim=64, num_heads=2)
    tattn_mod.load_state_dict(from_jax_state(flat), strict=True)
    x = rng.normal(size=(2, 7, 64)).astype(np.float32)
    freqs = rng.uniform(-1, 1, size=(7, 32, 2)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if masking == "kv_lens":
        lens = np.array([5, 7], np.int32)
        kw_j["kv_lens"], kw_t["kv_lens"] = jnp.asarray(lens), torch.from_numpy(lens)
    elif masking == "mask":
        mask = np.arange(7)[None, :] < np.array([[4], [7]])
        kw_j["key_mask"], kw_t["key_mask"] = jnp.asarray(mask), torch.from_numpy(mask)
    with jattn.attention_dtype(None), tattn.attention_dtype(None):
        theirs = jattn_mod(jnp.asarray(x), jnp.asarray(freqs), **kw_j)
        with torch.no_grad():
            ours = tattn_mod(torch.from_numpy(x), torch.from_numpy(freqs), **kw_t)
    assert rel_l2(ours.numpy(), theirs) <= FWD_TOL


# ------------------------------------------------------------------ forwards


@pytest.mark.parametrize("with_mask", [True, False], ids=["mask", "nomask"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_jax(case, with_mask):
    jmodel, tmodel = make_pair(case)
    ours, theirs = run_both(jmodel, tmodel, MASK if with_mask else None)
    assert len(ours) == len(theirs)
    for o, t in zip(ours, theirs):
        assert o.shape == t.shape == (2, 16, 16, 3)
        assert rel_l2(o, t) <= FWD_TOL


@pytest.mark.parametrize("with_mask", [True, False], ids=["mask", "nomask"])
@pytest.mark.parametrize("case", ["tread", "tread-fuse"])
def test_tread_routing_matches_jax(case, with_mask):
    """Training-time routing with the JAX package's permutation injected;
    routed and unrouted outputs differ, as in the JAX tests."""
    jmodel, tmodel = make_pair(case)
    ours, theirs = run_both(jmodel, tmodel, MASK if with_mask else None,
                            route_seed=3)
    assert rel_l2(ours[0], theirs[0]) <= FWD_TOL
    unrouted, _ = run_both(jmodel, tmodel, MASK if with_mask else None)
    assert np.abs(unrouted[0] - ours[0]).max() > 1e-6


@pytest.fixture
def packed_on_cpu(monkeypatch):
    """Open both packed-kernel gates on the CPU: the JAX side runs its Pallas
    kernel in interpret mode, the port's wrapper its plain version."""
    monkeypatch.setattr(jden, "_on_tpu", lambda: True)
    monkeypatch.setattr(jden, "short_attention_packed",
                        functools.partial(jax_packed, interpret=True))
    monkeypatch.setattr(jden, "MIN_PACKED_SEQ", 1)
    monkeypatch.setattr(tden, "_on_cuda", lambda x: True)
    monkeypatch.setattr(tden, "MIN_PACKED_SEQ", 1)
    calls = []
    real = tden.short_attention_packed

    def counting(q, k, v, num_heads, kv_lens=None, **kwargs):
        calls.append(None if kv_lens is None else kv_lens.tolist())
        return real(q, k, v, num_heads, kv_lens, **kwargs)

    monkeypatch.setattr(tden, "short_attention_packed", counting)
    return calls


# packed launches of one masked forward at TINY: Cross's self-attention
# blocks; IG's and LoIG's block 0 (before the context); all of TREAD's
# blocks, with suffix kv_lens; none of U-JiT's or PoPE's
PACKED_CALLS = {"cross": 3, "ig": 1, "loig": 1, "tread": 4, "ujit": 0,
                "jit-pope": 0}


@pytest.mark.parametrize("case", sorted(PACKED_CALLS))
def test_packed_branch_matches_jax(packed_on_cpu, case):
    jmodel, tmodel = make_pair(case)
    ours, theirs = run_both(jmodel, tmodel, MASK,
                            route_seed=5 if case == "tread" else None)
    assert len(packed_on_cpu) == PACKED_CALLS[case]
    if case == "tread":
        # suffix padding: patches (16, then 8 kept from block 1 to 2),
        # 8 size and time tokens, and each row's valid context
        assert packed_on_cpu == [[27, 29], [19, 21], [19, 21], [27, 29]]
    for o, t in zip(ours, theirs):
        assert rel_l2(o, t) <= FWD_TOL


def test_cross_npope_raises_as_in_jax():
    """Under n-pope the cross block applies RoPE to PoPE's full-dim table
    (the JAX package picks PopeCrossAttention for "pope" only): both
    forwards fail to broadcast. Kept as the JAX package has it (ROADMAP
    Queue 3)."""
    cfg = {**TINY, "positional_encoding": "n-pope"}
    jmodel = jcross.CrossJiT(jcross.CrossJiTDenoiserConfig(**cfg), rngs=nnx.Rngs(0))
    tmodel = tcross.CrossJiT(tcross.CrossJiTDenoiserConfig(**cfg), device="cpu")
    assert type(tmodel.blocks[2].attn) is tcross.CrossAttention
    assert type(tmodel.blocks[0].attn) is tpope.PopeAttention
    inputs = make_inputs()
    with pytest.raises(TypeError):
        jmodel(**{k: jnp.asarray(v) for k, v in inputs.items()})
    with pytest.raises(RuntimeError, match="must match the size"):
        tmodel(**{k: torch.from_numpy(v) for k, v in inputs.items()})


def test_ujit_layout():
    _, tmodel = make_pair("ujit")
    assert (len(tmodel.down_blocks), len(tmodel.up_blocks),
            len(tmodel.out_blocks)) == (2, 2, 1)
    assert tmodel.up_blocks[0].skip_merge is not None
    assert tmodel.down_blocks[0].skip_merge is None and tmodel.blocks is None
    with pytest.raises(ValueError, match="num_blocks"):
        tuvit.UJiT(tuvit.UJiTDenoiserConfig(**{**TINY, "depth": 2,
                                               "num_blocks": 4}))


def test_qk_logit_bound_covers_every_attention():
    """The bound is the max over every attention module, U-JiT's mid block
    included; the JAX package's list of block names misses ``mid_block``
    (ROADMAP Queue 3), so with the largest gains there the two differ."""
    jmodel, tmodel = make_pair("ujit")
    with torch.no_grad():
        tmodel.mid_block.attn.q_norm.weight.fill_(3.0)
    flat = flatten_state(jmodel)
    flat["mid_block.attn.q_norm.weight"] = np.full_like(
        flat["mid_block.attn.q_norm.weight"], 3.0)
    load_flat_state(jmodel, flat)
    k_max = float(tmodel.mid_block.attn.k_norm.weight.detach().abs().max())
    ours = float(tmodel.qk_logit_bound())
    assert ours == pytest.approx(np.sqrt(32) * 3.0 * k_max, rel=1e-6)
    assert float(jmodel.qk_logit_bound()) < ours
    _, cross = make_pair("cross")
    assert float(cross.qk_logit_bound()) == pytest.approx(
        max(float(m.qk_logit_bound()) for m in cross.modules()
            if isinstance(m, tden.Attention)))


# ------------------------------------------------------------------ checkpoints


@pytest.fixture
def label2id(tmp_path):
    path = tmp_path / "label2id.json"
    path.write_text(json.dumps({f"c{i}": i for i in range(4)}))
    return str(path)


@pytest.mark.parametrize("case", ["jit-pope", "jit-npope", "ujit-pope-pre",
                                  "ujit", "cross", "cross-pope", "ig", "loig",
                                  "tread"])
def test_reference_layout_checkpoints_load_into_the_port(case, label2id, tmp_path):
    """A checkpoint the JAX package writes (the reference layout) loads into
    the port's pipeline, which then gives the JAX output; the port writes the
    same keys back and loads its own file to the same bits. PoPE takes no
    RoPE permutation (``rope_head_dim`` None): with it, q/k rows would move
    and ``pope_bias`` would not."""
    family, overrides = CASES[case]
    jpipe_config, jpipe, tpipe_config, tpipe = FAMILY[family][4:]
    jdenoiser_config, tdenoiser_config = FAMILY[family][1], FAMILY[family][3]
    cfg = {**TINY, **overrides}
    encoder = {"type": "class", "label2id_map_path": label2id}
    jmodel = jpipe(jpipe_config(context_encoder=encoder,
                                denoiser=jdenoiser_config(**cfg)),
                   rngs=nnx.Rngs(0))
    load_flat_state(jmodel.denoiser, perturb(flatten_state(jmodel.denoiser)))
    path = str(tmp_path / "reference.safetensors")
    jmodel.save_checkpoint(path)
    config = tpipe_config(context_encoder=encoder, denoiser=tdenoiser_config(**cfg))
    model = tpipe.from_pretrained(config, path, device="cpu")
    assert model._rope_head_dim() == (
        None if "pope" in case else TINY["hidden_size"] // TINY["num_heads"])
    ours, theirs = run_both(jmodel.denoiser, model.denoiser, MASK)
    for o, t in zip(ours, theirs):
        assert rel_l2(o, t) <= FWD_TOL
    assert model.state_dict().keys() == jmodel.state_dict().keys()
    own = str(tmp_path / "port.safetensors")
    model.save_checkpoint(own)
    again = tpipe.from_pretrained(config, own, device="cpu")
    for key, value in model.denoiser.state_dict().items():
        torch.testing.assert_close(again.denoiser.state_dict()[key], value,
                                   rtol=0, atol=0)
