"""The attention pairing probe on the card (port of
``tools/bench/attention_pairing_probe.py``; kernel #10).

The TPU probe times the packed short-attention kernel's bounded forward and
backward per head (``_base_kernel``) against the head-PAIRED schedule
(``_paired_kernel``), which lane-concatenates two 64-wide heads, with
block-diagonal keys and values, so that the depth-64 products fill the TPU's
128-deep matrix unit; both compute one function. ``wgmma`` on the H100 takes
a depth of 16 a step, so a depth of 64 is four full steps with nothing idle
to fill, and the block-diagonal operands would double the multiply-adds of
4 of the 6 products: the paired schedule is not ported and the ``paired_*``
keys are absent. What is ported is the function: :func:`run_variant`
launches its CUDA kernel (``csrc/attention_probe.cu``,
``vpt_attention_pairing_probe``) on a CUDA tensor, and
:func:`run_variant_reference` is its plain version, the body of
``_base_kernel`` in PyTorch.

Per batch element and head, with k = v = do = q = x and no mask: bounded
attention forward and backward; the kernel writes ``o + dv`` and ``dq +
dk``, each summed in fp32 and rounded once. It runs in two launches of one
warpgroup a block, every product a ``wgmma`` over tiles that TMA brings into
a ring while the products run: the first sweeps the keys of each 64 query
rows for the row sums of e and e * dp; the second, per 64 rows, sweeps the
keys for o and dq of its query rows, then the queries for dv and dk of its
key rows, and rounds o + dv and dq + dk once: 10 (S, S, D) products
executed, where the function needs 6.

    python -m vision_pt_tpu_torch.tools.bench.attention_pairing_probe

prints one JSON line: ``per_head_ms_per_layer`` (device time per call,
``cuda_ms``) and ``max_abs_diff``, the kernel against its plain version on
the same input, beside the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import json

import torch

from ...ops.short_attention import _merge_heads, _split_heads
from . import card, check_kernel_input, cuda_ms, launches_of_timing, probe_kernel

B, S, H, D = 64, 304, 12, 64  # headline shape, S pre-padded to sublane
E = H * D
LOG2E = 1.4426950408889634
CLIP = 60.0 * LOG2E
N_LAYERS = 12
# launches of run_variant by main(): the timing and one comparison call
MAIN_LAUNCHES = launches_of_timing(N_LAYERS) + 1
# (S, S, D) products the kernel executes (s and dp in each of its three
# sweeps; o, dq, dv, dk); the function's 6
PRODUCTS_EXECUTED = 10

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [*[_PTR] * 7, _INT, _INT, _INT, _INT, ctypes.c_float, _PTR]


def run_variant_reference(x: torch.Tensor, heads: int = H,
                          kv_len: int | None = None):
    """Plain PyTorch version of kernel #10 (``_base_kernel``'s arithmetic):
    fp32 products of the (exactly upcast) input, the weights rounded to x's
    dtype before the PV product, p and ds before theirs. Returns (o + dv,
    dq + dk) in x's dtype, each summed in fp32 and rounded once.

    ``kv_len`` keeps only the first ``kv_len`` rows of x as keys and values
    (their weights are 0 past it): not the probe's function, but the plain
    version a check holds the kernel against to show that its limits fail a
    kernel that drops a key."""
    dt = x.dtype
    acc = torch.float64 if dt == torch.float64 else torch.float32
    scale = (x.shape[-1] // heads) ** -0.5
    q = k = v = do = _split_heads(x, heads).to(acc)

    def low(t):  # rounded to x's dtype, computed on in fp32
        return t.to(dt).to(acc)

    s = (q @ k.transpose(-1, -2)) * (scale * LOG2E)
    e = torch.exp2(s.clamp(-CLIP, CLIP))
    if kv_len is not None:
        e = e * (torch.arange(e.shape[-1], device=e.device) < kv_len)
    denom = e.sum(-1, keepdim=True).clamp_min(2.0**-100)
    o = (low(e) @ v) / denom
    p = e / denom
    dv = low(p).transpose(-1, -2) @ do
    dp = do @ v.transpose(-1, -2)
    delta = (p * dp).sum(-1, keepdim=True)
    ds = low(p * (dp - delta))
    dq = (ds @ k) * scale
    dk = (ds.transpose(-1, -2) @ q) * scale
    return _merge_heads(o + dv).to(dt), _merge_heads(dq + dk).to(dt)


def run_variant(x: torch.Tensor, heads: int = H):
    """Kernel #10 on a (B, S, H*64) bf16 CUDA tensor (raises on what it does
    not take); the plain version for a CPU tensor. Returns (o + dv, dq +
    dk)."""
    if x.device.type == "cpu":
        return run_variant_reference(x, heads)
    check_kernel_input(x, heads)
    x = x.contiguous()
    batch, seq, _ = x.shape
    out1, out2 = torch.empty_like(x), torch.empty_like(x)
    stats = torch.empty((2, batch, heads, seq), dtype=torch.float32, device=x.device)
    ptr = x.data_ptr()
    rc = probe_kernel("vpt_attention_pairing_probe", _ARGTYPES)(
        ptr, ptr, ptr, ptr, out1.data_ptr(), out2.data_ptr(), stats.data_ptr(),
        batch, seq, heads, 64, 64**-0.5,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"attention pairing probe kernel launch failed: {rc}")
    run_variant.launches += 1
    return out1, out2


# launches of the CUDA kernel (not of the plain version) since the last reset
run_variant.launches = 0


def main() -> dict:
    out = card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(B, S, E, generator=gen, device="cuda").to(torch.bfloat16)
    out["shape"] = [B, S, H, D]
    out["per_head_ms_per_layer"] = cuda_ms(lambda: run_variant(x), N_LAYERS)
    kernel = run_variant(x)
    plain = run_variant_reference(x)
    out["max_abs_diff"] = max(float((a.float() - b.float()).abs().max())
                              for a, b in zip(kernel, plain))
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
