"""Roofline decomposition of the packed short-attention kernels at the
JiT-B/16 256^2 headline shape, on the card (port of
``tools/bench/attention_roofline.py``; kernel #11).

Five sections, as in the TPU probe:

1. the headline training step (``benchmarks._jit_train_setup``), then the same
   step with the denoiser's ``short_attention_packed`` and
   ``dot_product_attention`` patched to identity: the step's attention share
   (an over-estimate of the kernels' share: with q and k out of the graph,
   the backward of their projections, QKNorm and RoPE goes too);
2. kernels #1 and #2 alone: forward plus backward per layer, at S 298,
   bounded;
3. kernel #11, the products of attention's forward and backward with no
   softmax, scale or mask (:func:`dots_variant`; its plain version
   :func:`dots_variant_reference`), per layer and in the TPU probe's useful
   TFLOP/s (its seven dots; the function itself needs six, since q k^T is
   one product computed twice);
4. batched products at D 64 against D 128 (``torch.bmm``, as the TPU probe
   leaves them to XLA);
5. the bounded-softmax elementwise chain over the (B*H, S_PAD, S_PAD) fp32
   tile volume, and the kernels' HBM floor at the H100 SXM's 3.35 TB/s,
   beside the card's name and power limit.

The TPU probe also times the head-PAIRED dots-only schedule
(``_dots_only_paired_kernel``): two heads side by side with block-diagonal
operands, which only fills the TPU's 128-deep matrix unit. ``wgmma`` takes a
depth of 16 a step, so a depth of 64 leaves nothing idle to fill, and the
block-diagonal operands would double the multiply-adds of 4 of the 6
products: it is not ported and its keys are absent. Kernel #11 is one
launch of one warpgroup a block, every product a ``wgmma`` over tiles that
TMA brings into a ring while the products run: per 64 rows, a sweep over
the keys (s, dp, then o + dq of its query rows) and one over the queries
(s^T, dp^T, then dv + dk of its key rows), the sum rounded once: 8 (S, S,
D) products executed, where the function needs 6.

    python -m vision_pt_tpu_torch.tools.bench.attention_roofline

prints one JSON line.
"""

from __future__ import annotations

import ctypes
import json

import torch

from ...ops.short_attention import _merge_heads, _split_heads
from . import card, check_kernel_input, cuda_ms, launches_of_timing, probe_kernel

B, S, H, D = 64, 298, 12, 64
E = H * D
S_PAD = 304  # the TPU kernel's block rows; the dots-only probe's S
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
N_LAYERS = 12
# launches of dots_variant by main(): the timing and one comparison call
MAIN_LAUNCHES = launches_of_timing(N_LAYERS) + 1
# (S, S, D) products the kernel executes (s and dp in both of its sweeps;
# o, dq, dv, dk); the function's 6
PRODUCTS_EXECUTED = 8

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [*[_PTR] * 5, _INT, _INT, _INT, _INT, _PTR]


def dots_variant_reference(x: torch.Tensor, heads: int = H,
                           kv_len: int | None = None) -> torch.Tensor:
    """Plain PyTorch version of kernel #11 (``_dots_only_kernel``'s seven
    dots, ``tools/bench/attention_roofline.py:155-194``) with q = k = v =
    do = x: fp32 products of the (exactly upcast) input, s and dp rounded to
    x's dtype before the products that take them. Returns (o + dq) + (dv +
    dk), summed in fp32 and rounded once to x's dtype.

    ``kv_len`` keeps only the first ``kv_len`` rows of x as keys and values
    (s and dp are 0 past it): not the probe's function, but the plain
    version a check holds the kernel against to show that its limits fail a
    kernel that drops a key."""
    dt = x.dtype
    acc = torch.float64 if dt == torch.float64 else torch.float32
    q = k = v = do = _split_heads(x, heads).to(acc)
    keys = 1.0
    if kv_len is not None:
        keys = torch.arange(x.shape[1], device=x.device) < kv_len

    def low(t):  # rounded to x's dtype, computed on in fp32
        return t.to(dt).to(acc)

    s = (q @ k.transpose(-1, -2)) * keys  # forward q k^T
    o = low(s) @ v
    p = low((q @ k.transpose(-1, -2)) * keys)  # the backward's recompute
    dv = p.transpose(-1, -2) @ do
    ds = low((do @ v.transpose(-1, -2)) * keys)
    dq = ds @ k
    dk = ds.transpose(-1, -2) @ q
    return _merge_heads((o + dq) + (dv + dk)).to(dt)


def dots_variant(x: torch.Tensor, heads: int = H) -> torch.Tensor:
    """Kernel #11 on a (B, S, H*64) bf16 CUDA tensor (raises on what it does
    not take); the plain version for a CPU tensor."""
    if x.device.type == "cpu":
        return dots_variant_reference(x, heads)
    check_kernel_input(x, heads)
    x = x.contiguous()
    batch, seq, _ = x.shape
    out = torch.empty_like(x)
    ptr = x.data_ptr()
    rc = probe_kernel("vpt_attention_dots_probe", _ARGTYPES)(
        ptr, ptr, ptr, ptr, out.data_ptr(), batch, seq, heads, 64,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"attention dots probe kernel launch failed: {rc}")
    dots_variant.launches += 1
    return out


# launches of the CUDA kernel (not of the plain version) since the last reset
dots_variant.launches = 0


def _step_ms(steps: int) -> float:
    from ...benchmarks import _jit_train_setup, time_steps
    from ...models.jit import JiT_B_16_Config

    setup = _jit_train_setup(JiT_B_16_Config(), B, 256, dtype=torch.bfloat16,
                             param_dtype=torch.float32)
    setup.step(0)  # warm-up: allocator, cuBLAS handles, rotary tables
    seconds = time_steps(lambda i: setup.step(i + 1), steps=steps)
    del setup
    torch.cuda.empty_cache()
    return seconds * 1e3


def main(steps: int = 15) -> dict:
    """The five sections; ``steps`` is the training steps per timing window
    of section 1 (3 windows)."""
    from ...models.jit import denoiser as dn_mod
    from ...ops.short_attention import (
        short_attention_packed_bwd,
        short_attention_packed_with_lse,
    )

    out = card()
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(0)

    # 1. step share: the headline step, and the step with attention as identity
    step_ms = _step_ms(steps)
    out["step_ms"] = step_ms
    out["headline_img_s"] = B / step_ms * 1e3
    real = dn_mod.dot_product_attention, dn_mod.short_attention_packed
    dn_mod.dot_product_attention = lambda q, k, v, *args, **kwargs: v
    dn_mod.short_attention_packed = lambda q, k, v, num_heads, *args, **kwargs: v
    try:
        noattn_ms = _step_ms(steps)
    finally:
        dn_mod.dot_product_attention, dn_mod.short_attention_packed = real
    out["step_noattn_ms"] = noattn_ms
    out["attention_share_ms"] = step_ms - noattn_ms

    # 2. kernels #1 and #2 alone, forward and backward per layer
    q = torch.randn(B, S, E, generator=gen, device="cuda").to(bf16)

    def layer():
        o, lse = short_attention_packed_with_lse(q, q, q, H, bounded=True)
        return short_attention_packed_bwd(q, q, q, lse, o, H, bounded=True)

    layer_ms = cuda_ms(layer, N_LAYERS)
    out["kernel_fwdbwd_ms_per_layer"] = layer_ms
    out["kernel_fwdbwd_ms_12_layers"] = layer_ms * N_LAYERS

    # 3. kernel #11: the products alone. "Useful" FLOPs are the TPU probe's
    # metric, its seven dots; the kernel's bound counts the function's six
    x = torch.randn(B, S_PAD, E, generator=gen, device="cuda").to(bf16)
    dots_ms = cuda_ms(lambda: dots_variant(x), N_LAYERS)
    useful_flops = 7 * 2 * B * H * S_PAD * S_PAD * D
    out["dots_only_per_head_ms_per_layer"] = dots_ms
    out["dots_only_per_head_useful_tflops"] = useful_flops / dots_ms / 1e9
    out["dots_only_max_abs_diff"] = float(
        (dots_variant(x).float() - dots_variant_reference(x).float()).abs().max())
    out["kernel_minus_dots_ms_per_layer"] = layer_ms - dots_ms
    del x

    # 4. the (S, S, D) products at depth 64 against 128 (torch.bmm)
    for d in (64, 128):
        a = torch.randn(B * H, S_PAD, d, generator=gen, device="cuda").to(bf16)
        bmm_ms = cuda_ms(lambda: torch.bmm(torch.bmm(a, a.transpose(1, 2)), a), 8)
        out[f"qk_pv_dot_d{d}_ms"] = bmm_ms
        out[f"qk_pv_dot_d{d}_tflops"] = 2 * 2 * B * H * S_PAD * S_PAD * d / bmm_ms / 1e9
    del a

    # 5. the bounded-softmax elementwise chain on the fp32 tile volume, and
    # the kernels' HBM floor (q, k, v read and o written; q, k, v, do read
    # and dq, dk, dv written)
    tile = torch.randn(B * H, S_PAD, S_PAD, generator=gen, device="cuda")

    def softmax_elem():
        e = torch.exp2((tile * 1.06).clamp(-86.0, 86.0))
        return e / e.sum(dim=-1, keepdim=True).clamp_min(2.0**-100)

    out["softmax_ms_per_tile_pass"] = cuda_ms(softmax_elem, 4)
    del tile
    per_tensor = B * S * E * 2  # bf16
    out["hbm_ms_per_layer_floor"] = (4 + 7) * per_tensor / HBM_BYTES_PER_S * 1e3
    out["hbm_bytes_per_s"] = HBM_BYTES_PER_S
    torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
