"""Device times of the redesigned kernels in two or more trees of the port,
in one run on one card: kernel #9 (``dequant_matmul_4bit``) at the JAX
package's bench shape (M 64, K = N = 8192) and at the SDXL sampler's
cross-attention shapes (M 154, K 2048, N 1280 and 640), bf16, nf4; kernels
#2, #4, #6 (the short-attention backward: packed bounded, BSHD, BHSD) and
the forwards #1, #3, #5 at JiT-B/16's training shape (B 64, S 298, 12 x 64,
bf16), #1 also at the sampler's (B 16, S 266); the flash forward #7 at the
latent trainer's shape (B 16, S 4106, 12 x 64, as a training step runs it,
writing the lse) and at the SDXL sampler's two self-attentions (B 2, S 4096,
10 heads; B 2, S 1024, 20 heads), the flash backward #8 at the latent shape;
each beside its library call (the flash rows beside SDPA under its
FLASH_ATTENTION backend); the probe kernels #10 (``run_variant``) and #11
(``dots_variant``) at the probes' shape (B 64, S 304, 12 x 64, bf16), each
beside its yardstick (:func:`probe_yardsticks`: no one PyTorch call computes
either function).

    python -m vision_pt_tpu_torch.tools.bench.kernel_ab \\
        --tree .chipwork/base --tree . --tree . --tree .chipwork/base

Every tree's kernels are built first (one process each, all together); then
each ``--tree``, in the order given, is timed in a process of its own that
imports that tree's package and this tree's ``timing.device_timing`` (loaded
by path): the median of 5 windows under torch.profiler, with the fastest and
slowest window. The attention rows call the public entry points only
(the backward through autograd, as a training step does), and the probe
rows the probe tools' wrappers, so the same calls time every tree. One
JSON line: the card, and per run the tree and its rows.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = ["nf4_matmul", "short_attention", "short_attention_bwd",
           "flash_attention", "flash_attention_bwd", "attention_probe"]
NF4_SHAPES = (("bench", 64, 8192, 8192), ("path", 154, 2048, 1280),
              ("path_n640", 154, 2048, 640))
TRAIN, SAMPLER = (64, 298), (16, 266)
HEADS, DIM = 12, 64
FLASH_SHAPES = (("latent", 16, 4106, 12), ("sdxl_s4096", 2, 4096, 10),
                ("sdxl_s1024", 2, 1024, 20))  # label, B, S, H (D 64, bf16)
PROBE_SHAPE = (64, 304, 12)  # the attention probes' B, S, H (D 64, bf16)


def _timing():
    spec = importlib.util.spec_from_file_location("_kernel_ab_timing",
                                                  os.path.join(HERE, "timing.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _row(timing, fn, library, iters):
    kernel = timing.device_timing(fn, iters)
    lib = timing.device_timing(library, iters)
    return {"ms": kernel.median, "ms_range": [kernel.low, kernel.high],
            "ms_by_kernel": {k[:80]: v for k, v in kernel.by_kernel.items()},
            "library_ms": lib.median, "library_ms_range": [lib.low, lib.high]}


def _autograd(fn, inputs):
    """(forward, backward) of ``fn`` on leaves that require a gradient: the
    forward's calls, and the gradients of one retained output for a
    cotangent."""
    import torch

    leaves = [x.detach().requires_grad_() for x in inputs]
    out = fn(*leaves)

    def backward(cotangent):
        return torch.autograd.grad(out, leaves, cotangent, retain_graph=True)

    return (lambda: fn(*leaves)), backward


def _flash_sdpa(fn):
    """``fn`` run under SDPA's FLASH_ATTENTION backend, as ``chip_smoke.py``
    times the flash kernels' yardstick."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def call(*args):
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            return fn(*args)

    return call


def probe_yardsticks(x, heads: int):
    """The probes' yardsticks on a (B, S, H*64) tensor x, as two callables:
    #10's, SDPA forward and its backward through autograd with k = v = do =
    q = x and the two adds (o + dv, dq + dk); #11's, its seven products as
    seven bf16 ``torch.matmul`` calls."""
    import torch
    import torch.nn.functional as F

    batch, seq, _ = x.shape
    xh = x.view(batch, seq, heads, -1).transpose(1, 2)
    leaves = [xh.detach().requires_grad_() for _ in range(3)]

    def sdpa_pair():
        o = F.scaled_dot_product_attention(*leaves)
        dq, dk, dv = torch.autograd.grad(o, leaves, xh)
        return o + dv, dq + dk

    def seven_matmuls():
        t = xh.transpose(-1, -2)
        s1 = xh @ t
        s2 = xh @ t
        dp = xh @ t
        return s1 @ xh, s2.transpose(-1, -2) @ xh, dp @ xh, dp.transpose(-1, -2) @ xh

    return sdpa_pair, seven_matmuls


def measure() -> dict:
    """This process's tree (on sys.path) timed with this file's timing."""
    import torch
    import torch.nn.functional as F

    from vision_pt_tpu_torch.ops import flash_attention as fa
    from vision_pt_tpu_torch.ops import short_attention as sa
    from vision_pt_tpu_torch.ops.quant.layers import _dequant_deint
    from vision_pt_tpu_torch.ops.quant.nf4 import quantize_4bit_device_kernel_layout
    from vision_pt_tpu_torch.ops.quant.nf4_matmul import dequant_matmul_4bit

    timing = _timing()
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    rows = {}
    for label, m, k, n in NF4_SHAPES:
        w = torch.randn(n, k, generator=gen, device="cuda") * 0.05
        packed, absmax = quantize_4bit_device_kernel_layout(w)
        dense = _dequant_deint(packed, absmax, "nf4", bf16)
        x = torch.randn(m, k, generator=gen, device="cuda").to(bf16)
        rows[f"dequant_matmul_4bit/{label}"] = _row(
            timing, lambda: dequant_matmul_4bit(x, packed, absmax),
            lambda: F.linear(x, dense), 50)
        del w, packed, absmax, dense

    for label, (batch, s) in (("train", TRAIN), ("sampler", SAMPLER)):
        q, k, v, do = (torch.randn(batch, s, HEADS, DIM, generator=gen,
                                   device="cuda").to(bf16) for _ in range(4))
        bhsd = [x.transpose(1, 2) for x in (q, k, v, do)]
        packed = [x.view(batch, s, HEADS * DIM) for x in (q, k, v, do)]
        rows[f"short_attention_packed/{label}"] = _row(
            timing, lambda: sa.short_attention_packed(*packed[:3], HEADS, bounded=True),
            lambda: F.scaled_dot_product_attention(*bhsd[:3]), 50)
        if label != "train":
            continue
        # the training forward and the backward through autograd, as a
        # training step calls them: the same calls in every tree
        sdpa = _autograd(F.scaled_dot_product_attention, bhsd[:3])
        entries = (
            ("short_attention_packed",
             lambda *x: sa.short_attention_packed(*x, HEADS, bounded=True), packed),
            ("short_attention", sa.short_attention, (q, k, v, do)),
            ("short_attention_bhsd", sa.short_attention_bhsd, bhsd))
        for name, fn, args in entries:
            forward, backward = _autograd(fn, args[:3])
            if name == "short_attention_packed":
                rows[f"{name}_grad/train"] = _row(timing, forward, sdpa[0], 50)
            rows[f"{name}_bwd/train"] = _row(
                timing, lambda: backward(args[3]), lambda: sdpa[1](bhsd[3]), 20)
        rows["short_attention/train"] = _row(
            timing, lambda: sa.short_attention(q, k, v),
            lambda: F.scaled_dot_product_attention(*bhsd[:3]), 50)
        rows["short_attention_bhsd/train"] = _row(
            timing, lambda: sa.short_attention_bhsd(*bhsd[:3]),
            lambda: F.scaled_dot_product_attention(*bhsd[:3]), 50)

    sdpa = _flash_sdpa(F.scaled_dot_product_attention)
    for label, batch, s, heads in FLASH_SHAPES:
        q, k, v, do = (torch.randn(batch, s, heads, DIM, generator=gen,
                                   device="cuda").to(bf16) for _ in range(4))
        bhsd = [x.transpose(1, 2) for x in (q, k, v, do)]
        if label != "latent":  # the sampler's call: no lse, no autograd
            rows[f"flash_attention/{label}"] = _row(
                timing, lambda: fa.flash_attention(q, k, v),
                lambda: sdpa(*bhsd[:3]), 20)
            continue
        forward, backward = _autograd(fa.flash_attention, (q, k, v))
        sdpa_forward, sdpa_backward = _autograd(sdpa, bhsd[:3])
        rows[f"flash_attention/{label}"] = _row(timing, forward, sdpa_forward, 20)
        rows[f"flash_attention_bwd/{label}"] = _row(
            timing, lambda: backward(do),
            _flash_sdpa(lambda: sdpa_backward(bhsd[3])), 10)
    del q, k, v, do, bhsd, forward, backward, sdpa_forward, sdpa_backward

    from vision_pt_tpu_torch.tools.bench import attention_pairing_probe as pairing
    from vision_pt_tpu_torch.tools.bench import attention_roofline as roofline

    batch, s, heads = PROBE_SHAPE
    x = torch.randn(batch, s, heads * DIM, generator=gen, device="cuda").to(bf16)
    sdpa_pair, seven_matmuls = probe_yardsticks(x, heads)
    rows["run_variant/probe"] = _row(timing, lambda: pairing.run_variant(x),
                                     sdpa_pair, 20)
    rows["dots_variant/probe"] = _row(timing, lambda: roofline.dots_variant(x),
                                      seven_matmuls, 20)
    return rows


def _run(tree: str, mode: str) -> subprocess.Popen:
    env = {**os.environ, "PYTHONPATH": os.path.abspath(tree)}
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), mode],
                            cwd=os.path.abspath(tree), env=env,
                            stdout=subprocess.PIPE, text=True)


def main(trees: list[str]) -> dict:
    builds = [_run(tree, "--build") for tree in dict.fromkeys(trees)]
    for proc in builds:
        proc.communicate()
        if proc.returncode:
            raise RuntimeError("a kernel build failed")
    runs = []
    for tree in trees:
        proc = _run(tree, "--measure")
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"timing {tree} failed")
        runs.append({"tree": tree, "rows": json.loads(out.strip().splitlines()[-1])})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    result = {"nvidia_smi": smi, "runs": runs}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    if sys.argv[1:] == ["--build"]:
        from vision_pt_tpu_torch.ops import _build

        _build.build(SOURCES)
    elif sys.argv[1:] == ["--measure"]:
        print(json.dumps(measure()), flush=True)
    else:
        parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
        parser.add_argument("--tree", action="append", required=True)
        main(parser.parse_args().tree)
