#!/usr/bin/env python3
"""Drive the PyTorch port's JiT-B/16 class-to-image sampler and training step,
its latent JiT 1024^2 trainer, its SDXL 1024^2 text-to-image sampler (bf16
and NF4), its ``short`` attention backend and its two attention probes, on
one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels-only   # phases 1-3 (with nf4_kernel,
                                           # short_kernel, nf4_timing and
                                           # short_timing) alone, no result line

Phases, one JSON line each; any failure raises and the script exits non-zero
without a result line:

1. device: the card, its power limit, and the build of every CUDA kernel of
   the paths from the sources in ``vision_pt_tpu_torch/csrc`` (one ``nvcc``
   per source, started together), with the ptxas register and spill report;
2. kernel: each kernel against its plain PyTorch version, on the card, at the
   paths' shapes and at edge shapes (for the attention kernels the edges of
   their key tiles too: S 129, 257, 1025 and 1153, Sq 200 with Sk 320), in
   bf16, fp16 and fp32. Every element
   must lie within tol * (RMS(ref) + |ref|), tol 2e-2 for bf16, 5e-3 for
   fp16 (attention) and 1e-4 for fp32, and the forwards' LSE within 1e-4
   absolute; a kv_len 0 row must be exactly 0, and so must the key-gradient
   rows past kv_len. At the latent shape the same limits must fail the
   kernel's results against a plain version whose kv_len is 64 keys short,
   at its tile edge, or one key short, and in fp16 (and for the packed
   kernels in bf16) one key short. Autograd through
   ``short_attention_packed`` (bf16 and fp16) and ``flash_attention`` must
   give exactly the explicit backward, and two calls of the packed backward
   must give the same bits;
3. timing: each kernel's device ms per launch (``device_timing``: the
   median of 5 windows under torch.profiler, with the fastest and slowest
   window; the plain versions by CUDA events, host time included), its bound on an H100
   SXM from the bytes and operations of these inputs, the plain version's ms,
   and one PyTorch library call that computes the same function, at the
   sampler shape (forward) and the training-step shape (forward, backward)
   of the packed kernels and at the latent trainer's shape (B 16, S 4106) of
   the flash kernels (their plain versions over the same batch in calls of
   2 rows);
4. sampler: ``JiTModel.new_with_config`` at the full width of JiT-B/16, 256^2,
   bf16 compute, answering 3 requests of ``generate`` (batch 8, CFG, 20
   Euler steps); the forward kernel must launch 80 times per request and the
   backward never;
5. train_step: the JAX package's headline training step (``bench_headline``)
   in the port: JiT-B/16, 256^2, batch 64, bf16 compute, fp32 parameters, 32
   unmasked context tokens, AdamW 1e-4; one warm-up and 10 timed steps; 12
   forward and 12 backward kernel launches per step; one profiled step;
6. trainer: the port's entry point (``train.jit.class_to_image.run``) on
   ``configs/jit/synthetic_class_to_image.yml`` widened to JiT-B/16, 256^2,
   batch 64, bf16, 4 steps, with clipping, EMA, a cosine schedule, a
   safetensors save and a 4-step preview; 4 forward and 4 backward launches
   per step; the saved file must load back through ``JiTModel.from_pretrained``;
   the last step runs under the profiler;
7. train_parity: one training step's loss and gradients, same weights, batch
   and injected draws, on the card (kernels) and on the CPU (plain versions
   of the same path), batch 2, in fp32, bf16 and fp16 (the fp16 loss scaled
   by 2^12 before the backward: see LOSS_SCALE), through
   ``tools.bench.step_parity``;
8. parity: the same weights and injected noise through the sampler on the
   card (kernel) and on the CPU (plain versions), batch 1, CFG, 2 steps;
   PSNR at least 50 dB in fp32 (under ``attention_dtype(None)``) and 30 dB
   in bf16;
9. latent_trainer: the port's latent entry point
   (``train.jit.latent_class_to_image.run``) on
   ``configs/jit/latent_arb_1024.yml`` with every model and dataset field as
   shipped (depth 24, 768 wide, patch 2 over a 128 x 128 x 4 latent, so
   S = 4170 in every block; batch 16, bf16, gradient checkpointing, AdamW
   1e-4) and only its paths rewritten: a synthetic cache of 64 latents in the
   JAX package's layout, one epoch = 4 steps; exactly 48 flash forward, 24
   flash backward and no packed launches per step; the last step runs under
   the profiler;
10. latent_parity: one training step of the latent workload at full width,
   depth cut to 6, a 64 x 64 latent (S = 1098, still the flash path), batch
   2, on the card (kernels) and on the CPU (plain versions), fp32, bf16 and
   fp16, against the train_parity floors;
11. sdxl_sampler: SDXL-base at full width (UNet 320/640/1280, context 2048,
   CLIP-L + bigG, the VAE), random weights from a seed, built on the card,
   bf16 compute with fp32 parameters, through the CLI's ``run``
   (``tools.inference_cli``) at 1024^2, batch 1, CFG 5, 20 steps, with the
   word-hash tokenizer: a warm and a timed request in bf16, then again after
   ``quantize_inplace(..., "bnb_nf4")`` with the CLI's keys; exactly 1,400
   flash launches per request, and 2,800 of kernel #9 under NF4 (0 without);
   a profiled 2-step request each; the image finite and not constant;
12. sdxl_parity: full widths at reduced depth (layers_per_block 1, one
   transformer per stage), 512^2, bf16, one UNet call and a 2-step CFG
   generate with injected latents and noise, on the card (kernels) and on
   the CPU (plain versions), before and after NF4 quantization; the floors
   must also fail the card's run with kernel #9 given one scale row 25% off,
   or that chunk left out, in every launch;
13. short_path (after train_step): ``dot_product_attention(...,
   backend="short")`` forward and backward at JiT-B/16 width (B 64, S 298,
   12 x 64, bf16, kv_lens in [266, 298] with one row at 0), then
   ``short_attention_bhsd`` on the same tensors transposed; exactly one
   forward and one backward launch of the matching entry per call (#3/#4,
   then #5/#6) and none of any other kernel; a mask or ``is_causal`` must be
   refused;
14. attention_probes (after short_path): the two probe tools' ``main()``
   (``tools.bench.attention_pairing_probe``, ``tools.bench.attention_roofline``,
   the roofline's training step with 5 steps a window), each printing its
   JSON line; #10 and #11 launch exactly as their timing asks.

After phase 2, short_kernel holds kernels #3-#6 (the short backend's BSHD
and BHSD entries, forward and backward) against their plain versions at the
JiT-B/16 train shape and at edge shapes (S 37; Sq 266 with Sk 77; kv_lens
full, partial and 0; D 128; bf16 and fp32) under phase 2's limits, which must
fail a plain version one key short; autograd through both entries must give
exactly their backward; #10 and #11 at the probes' shape (B 64, S 304, 12 x
64) and at S that cut their 64-row tiles (S 37, 65, 129, 257, 298) under the
same limits, which must fail a plain version with one head's output left out
and one that drops the last key; fp16 cases of #3-#6 likewise. short_timing
times #3-#6 at the train shape (SDPA forward, and forward and backward, as
the yardsticks), #10 and #11 at theirs (SDPA forward and backward with the
adds; seven bf16 matmuls; with the products each executes) and #2 again.
nf4_kernel holds kernel #9 (``dequant_matmul_4bit``) against
its plain version at the sampler's shapes and at edge shapes (M 1, 37, 1024;
K 128, 5120; N 8, 136, 10240), nf4 and fp4, bf16, fp16 and fp32, under
phase 2's limits (fp16's tol 2e-3), which must fail a plain version with one absmax row 25% off or one
64-row chunk left out, and on both sides of each block-shape boundary (M 1,
64, 65, 128, 129, 154, 256, 257, 1024 at K 2048, N 1280, which K splits);
two calls at M 64 and 154 must give the same bits. Phase 3 also times kernel #7 at SDXL's two
self-attention shapes, and nf4_timing times kernel #9 at the sampler's
shapes and at the JAX package's bench shape (M 64, K = N = 8192), beside
F.linear on the weight dequantized beforehand.

Every kernel launch counter is set to 0 just before a path is driven and read
just after. Then the ``{"kernels": [...]}`` line, the card's name and power
limit as nvidia-smi prints them, and the result line.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from vision_pt_tpu_torch.tools.bench import device_timing, event_ms

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}  # dense
TOL = {torch.bfloat16: 2e-2, torch.float16: 2e-3, torch.float32: 1e-4}
# attention in fp16: its weights and ds are rounded to 11 significant bits
# (bf16: 8), so a sum in another order flips a rounding 8 times smaller than
# in bf16; 5e-3 keeps the bf16 limit's headroom (largest bf16 share ~0.5)
# and still fails a plain version one key short
ATTN_TOL = {**TOL, torch.float16: 5e-3}
# the flash forward's LSE (fp32 on both sides, about 8.3 at S 4106): absolute
LSE_ATOL = 1e-4
STEPS, BATCH, REQUESTS = 20, 8, 3
LAUNCHES_PER_REQUEST = 4 * STEPS  # blocks 0-3 (before context_start_block)
PSNR_FLOOR_DB = {"float32": 50.0, "bfloat16": 30.0}
TRAIN_BATCH, TIMED_STEPS = 64, 10
# train_parity floors, largest over the parameters of the relative L2 error
# of the gradient, card vs CPU. fp32: both sides compute in fp32 and differ
# only in the order of sums (measured errors ~1e-5 on the CPU against JAX).
# bf16: every activation is rounded to 8 mantissa bits and the card's and
# the CPU's matmuls round at other places, so a few percent is expected; a
# wrong kernel gives errors of order 1.
# fp16 backwards scale the loss by 2^12 first, as fp16 training under
# torch.amp's GradScaler does; the port's trainer, like the JAX package's,
# does not scale, so this step is not the trainer's path. Unscaled, the
# attention backward's ds = p (dp - delta) rounds to 0 in fp16 for 39-87%
# (JiT) and 91-100% (latent) of its nonzero values, on either side: the
# CPU's own fp16 gradients miss the fp32 step's by 150% and 108%, and card
# and CPU differ by 0.83 and 0.26 whether the card runs the kernels or their
# plain versions. Scaled, each side is within 0.0066 of the fp32 step
# (tools/bench/step_parity.py on an H100).
LOSS_SCALE = {"float16": 4096.0}
TRAIN_PARITY_FLOOR = {"float32": {"loss": 1e-4, "grad": 1e-3},
                      "bfloat16": {"loss": 2e-2, "grad": 1e-1},
                      # above the scaled fp16 readings, card vs CPU (grad
                      # <= 0.0070, loss <= 2.4e-6), below the bf16 steps'
                      # grad (0.041-0.050), so a step at bf16 precision
                      # fails; the loss alone does not separate the two
                      "float16": {"loss": 1e-5, "grad": 2e-2}}
ROOT = os.path.dirname(os.path.abspath(__file__))
# the port's own kernels among a profile's device kernels
PORT_KERNEL = re.compile(
    r"attn_(fwd|bwd_dq|bwd_dkdv)_|(packed|flash)_bwd_(dq|dkdv)_|nf4_matmul|"
    r"(pairing|dots)_probe_")
SOURCES = ("short_attention", "short_attention_bwd", "flash_attention",
           "flash_attention_bwd", "nf4_matmul", "attention_probe")
LATENT_BATCH, LATENT_SIDE, LATENT_ITEMS = 16, 128, 64
# the kernel launch counters, in the order of every launch-count tuple:
# kernels #1-#11 (their wrappers in _wrappers())
N_KERNELS = 11


def _expect(launches: dict[int, int]) -> tuple[int, ...]:
    """A launch-count tuple from {kernel number: launches}, 0 elsewhere."""
    return tuple(launches.get(i, 0) for i in range(1, N_KERNELS + 1))


# flash launches per latent training step: 24 blocks forward, 24 recomputed
# under gradient checkpointing, 24 backward
LATENT_STEP_LAUNCHES = _expect({7: 48, 8: 24})


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


_STARTED = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line, stamped with the seconds since the script started."""
    at = round(time.perf_counter() - _STARTED, 1)
    print(json.dumps({"phase": phase, "at_seconds": at, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def psnr(ours: np.ndarray, theirs: np.ndarray) -> float:
    mse = float(np.mean((ours - theirs) ** 2))
    peak = float(theirs.max() - theirs.min())
    return 10 * np.log10(peak**2 / max(mse, 1e-30))


# ------------------------------------------------------------------ phases


def phase_device() -> str:
    from vision_pt_tpu_torch.ops import _build

    check(torch.cuda.device_count() >= 1, "no CUDA device")
    smi = nvidia_smi()
    t0 = time.perf_counter()
    _build.build(list(SOURCES))
    seconds = time.perf_counter() - t0
    ptxas = [line.strip() for log, _ in _build.build_logs.values()
             for line in log.splitlines()
             if "Compiling entry" in line or "registers" in line or "spill" in line]
    spills = [line for line in ptxas if "spill" in line
              and not line.startswith("0 bytes stack frame, 0 bytes spill")]
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         build_seconds=round(seconds, 3), ptxas=ptxas, spills=spills)
    return smi


def _attention_inputs(gen, batch, sq, sk, heads, dim, dtype):
    return [torch.randn(batch, s, heads * dim, generator=gen, device="cuda").to(dtype)
            for s in (sq, sk, sk)]


def _kv_lens(gen, lens, batch, sk):
    if lens == "range":  # kv_lens in [min(266, Sk), Sk], row 1 at 0
        kv_lens = torch.randint(min(266, sk), sk + 1, (batch,), generator=gen,
                                device="cuda")
        kv_lens[1] = 0
        return kv_lens
    return None if lens is None else torch.tensor(lens, device="cuda")


def _compare(out, ref, tol, atol=None):
    """The largest |out - ref|, and the largest share of its limit
    atol + tol * |ref| that an element uses (at most 1 to agree). ``atol``
    defaults to tol times the RMS of ref, so the limit follows the size of
    what is compared: at S = 4170 an attention output or gradient is about
    0.025 in RMS, and a fixed 2e-2 would pass a kernel that drops a key
    tile."""
    ref = ref.float()
    diff = (out.float() - ref).abs()
    if atol is None:
        atol = tol * float(ref.square().mean().sqrt())
    limit = (atol + tol * ref.abs()).clamp_min(1e-30)
    return float(diff.max()), float((diff / limit).max())


def _agree(compared) -> tuple[float, float, bool]:
    """(largest error, largest limit share, every tensor within its limit)
    over the ``_compare`` results of one kernel's outputs."""
    err = max(e for e, _ in compared)
    share = max(s for _, s in compared)
    return err, share, share <= 1.0


def phase_kernel() -> dict:
    """Both kernels against their plain versions; returns the largest error
    of each at the training-step shape."""
    from vision_pt_tpu_torch.ops.short_attention import (
        short_attention_packed,
        short_attention_packed_bwd,
        short_attention_packed_bwd_reference,
        short_attention_packed_reference,
        short_attention_packed_with_lse,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    cases = [
        # (name, batch, sq, sk, heads, dim, dtype, bounded, kv_lens)
        ("train_s298", 64, 298, 298, 12, 64, bf16, True, None),
        ("train_s266", 64, 266, 266, 12, 64, bf16, True, None),
        ("sampler_s266", 16, 266, 266, 12, 64, bf16, True, None),
        ("s37", 2, 37, 37, 2, 64, bf16, True, [37, 21]),
        ("s37_unbounded", 2, 37, 37, 2, 64, bf16, False, [37, 21]),
        ("s330_kv", 16, 330, 330, 12, 64, bf16, True, "range"),
        ("s330_kv_unbounded", 16, 330, 330, 12, 64, bf16, False, "range"),
        ("sq266_sk330", 16, 266, 330, 12, 64, bf16, True, "range"),
        ("d128", 4, 266, 266, 6, 128, bf16, False, "range"),
        ("s129", 4, 129, 129, 12, 64, bf16, False, [128, 0, 129, 64]),
        ("s266_fp32", 16, 266, 266, 12, 64, f32, True, None),
        ("d128_fp32", 4, 266, 330, 6, 128, f32, False, "range"),
        ("train_s298_fp16", 64, 298, 298, 12, 64, f16, True, None),
        ("s330_kv_fp16", 16, 330, 330, 12, 64, f16, True, "range"),
        ("s330_kv_unbounded_fp16", 16, 330, 330, 12, 64, f16, False, "range"),
        ("d128_fp16", 4, 266, 330, 6, 128, f16, False, "range"),
    ]
    errors = {}
    for name, batch, sq, sk, heads, dim, dtype, bounded, lens in cases:
        q, k, v = _attention_inputs(gen, batch, sq, sk, heads, dim, dtype)
        do = torch.randn(batch, sq, heads * dim, generator=gen, device="cuda").to(dtype)
        kv_lens = _kv_lens(gen, lens, batch, sk)
        tol = ATTN_TOL[dtype]
        out, lse = short_attention_packed_with_lse(q, k, v, heads, kv_lens,
                                                   bounded=bounded)
        grads = short_attention_packed_bwd(q, k, v, lse, do, heads, kv_lens,
                                           bounded=bounded)
        torch.cuda.synchronize()
        ref, ref_lse = short_attention_packed_reference(
            q, k, v, heads, kv_lens, bounded=bounded, return_lse=True)
        # the backward's plain version takes the kernel's lse, as #8's
        ref_grads = short_attention_packed_bwd_reference(
            q, k, v, lse, do, heads, kv_lens, bounded=bounded)
        for kernel, outs, compared in (
                ("short_attention_packed", [out],
                 [_compare(out, ref, tol), _compare(lse, ref_lse, 0.0, LSE_ATOL)]),
                ("short_attention_packed_bwd", grads,
                 [_compare(g, r, tol) for g, r in zip(grads, ref_grads)])):
            err, share, within = _agree(compared)
            finite = all(bool(torch.isfinite(o).all()) for o in outs)
            zero_row = past_kv_zero = None
            if kv_lens is not None and int(kv_lens[1]) == 0:
                zero_row = all(bool((o[1] == 0).all()) for o in outs)
            if kernel.endswith("bwd") and kv_lens is not None:
                k0 = int(kv_lens[0])
                past_kv_zero = all(bool((g[0, k0:] == 0).all()) for g in grads[1:])
            emit("kernel", kernel=kernel, case=name,
                 shape=[batch, sq, sk, heads, dim], dtype=str(dtype),
                 bounded=bounded, max_abs_err=err, tolerance=tol,
                 lse_atol=LSE_ATOL if kernel == "short_attention_packed" else None,
                 limit_share=share, finite=finite, zero_row=zero_row,
                 past_kv_zero=past_kv_zero)
            check(finite and within and zero_row is not False
                  and past_kv_zero is not False,
                  f"{kernel} disagrees with its plain version at {name}")
            if name == "train_s298":
                errors[kernel] = err
        if name == "train_s298":
            # repeated calls give the same bits: no atomics, fixed order
            again = short_attention_packed_bwd(q, k, v, lse, do, heads,
                                               bounded=bounded)
            same = all(torch.equal(a, b) for a, b in zip(again, grads))
            emit("kernel", kernel="short_attention_packed_bwd", case="repeat",
                 bitwise_equal=same)
            check(same, "two calls of the packed backward differ")
        if name.startswith("s330_kv"):
            # the limits must fail the kernel's row 0 against the plain
            # version of that row with one key fewer
            n = int(kv_lens[0])
            wrong = torch.tensor([n - 1], device="cuda")
            row = [x[:1] for x in (q, k, v, lse, do)]
            refs = [short_attention_packed_reference(*row[:3], heads, wrong,
                                                     bounded=bounded),
                    *short_attention_packed_bwd_reference(*row, heads, wrong,
                                                          bounded=bounded)]
            shares = [_compare(o, r, tol)[1] for o, r in
                      zip([out[:1], *(g[:1] for g in grads)], refs)]
            emit("kernel", kernel="short_attention_packed", case="limits_can_fail",
                 dtype=str(dtype), bounded=bounded, kv_len=n,
                 one_key_fewer_shares=shares)
            check(shares[0] > 1 and max(shares[1:]) > 1,
                  f"the packed limits pass a kernel one key short at {name}: {shares}")
        del q, k, v, do, out, lse, grads, ref, ref_lse, ref_grads
        torch.cuda.empty_cache()

    # autograd through the Function runs exactly the backward kernel
    for dtype in (bf16, f16):
        q, k, v = (x.requires_grad_() for x in
                   _attention_inputs(gen, 4, 266, 266, 12, 64, dtype))
        do = torch.randn(4, 266, 768, generator=gen, device="cuda").to(dtype)
        out = short_attention_packed(q, k, v, 12, bounded=True)
        auto = torch.autograd.grad(out, (q, k, v), do)
        leaves = [x.detach() for x in (q, k, v)]
        again, lse = short_attention_packed_with_lse(*leaves, 12, bounded=True)
        explicit = short_attention_packed_bwd(*leaves, lse, do, 12,
                                              bounded=True)
        equal = torch.equal(out, again) and all(
            torch.equal(a, b) for a, b in zip(auto, explicit))
        emit("kernel", kernel="short_attention_packed_bwd", case="autograd",
             dtype=str(dtype), autograd_equals_explicit=equal)
        check(equal, "autograd through short_attention_packed differs from its "
              f"backward ({dtype})")
    return errors


FLASH_CASES = [
    # (name, batch, sq, sk, heads, dim, dtype, causal, kv_lens)
    ("path_s4170_kv", 4, 4170, 4170, 12, 64, torch.bfloat16, False,
     [4106, 4170, 4107, 0]),
    ("path_s4106", 4, 4106, 4106, 12, 64, torch.bfloat16, False, None),
    # the SDXL sampler's self-attentions at 1024^2 (B 2 with CFG)
    ("sdxl_s4096", 2, 4096, 4096, 10, 64, torch.bfloat16, False, None),
    ("sdxl_s1024", 2, 1024, 1024, 20, 64, torch.bfloat16, False, None),
    ("s1000_kv", 2, 1000, 1000, 12, 64, torch.bfloat16, False, [1000, 0]),
    ("sq1000_sk1500", 2, 1000, 1500, 6, 64, torch.bfloat16, False, [1337, 0]),
    ("causal_s1000", 2, 1000, 1000, 12, 64, torch.bfloat16, True, [1000, 777]),
    ("d128", 2, 1000, 1100, 6, 128, torch.bfloat16, False, [1100, 0]),
    ("fp32_s1000", 2, 1000, 1000, 4, 64, torch.float32, False, [1000, 0]),
    ("fp32_d128_causal", 2, 700, 700, 2, 128, torch.float32, True, [700, 333]),
    ("fp16_s1000_kv", 2, 1000, 1000, 12, 64, torch.float16, False, [777, 0]),
    ("fp16_d128_causal", 2, 700, 700, 2, 128, torch.float16, True, [700, 333]),
    # the edges of the key tiles (64 keys below Sk 1024, 128 from it on at
    # D 64): one key past a tile, causal with kv_len one past a tile, Sq !=
    # Sk at D 128 with a zero row
    *((f"{tag}_{label}", batch, sq, sk, heads, dim, dtype, causal, lens)
      for tag, dtype in (("bf16", torch.bfloat16), ("fp16", torch.float16))
      for label, batch, sq, sk, heads, dim, causal, lens in (
          ("s129", 1, 129, 129, 1, 64, False, [128]),
          ("s257_causal", 2, 257, 257, 2, 64, True, [257, 129]),
          ("sq200_sk320_d128", 2, 200, 320, 1, 128, False, [255, 0]),
          ("s1025", 2, 1025, 1025, 2, 64, False, [1025, 1024]),
          ("s1153_causal", 2, 1153, 1153, 2, 64, True, [1153, 1025]))),
]


def _bshd(gen, batch, s, heads, dim, dtype):
    return torch.randn(batch, s, heads, dim, generator=gen, device="cuda").to(dtype)


def _flash_compare(outs, refs, tol):
    """``_compare`` over (out, lse) or (dq, dk, dv); the LSE, the one (B, H,
    Sq) tensor, is held to LSE_ATOL absolute."""
    return [_compare(o, r, 0.0, LSE_ATOL) if o.dim() == 3 else _compare(o, r, tol)
            for o, r in zip(outs, refs)]


def _flash_limits_can_fail(q, k, v, do, out, lse, grads, lens, tol):
    """The limits must fail a kernel that is slightly wrong: the kernel's
    results for row 2 (kv_len 4107) against the plain version of that row
    with 64 keys fewer, with kv_len rounded down to its tile edge (4096) and
    with one key fewer. Each must make the forward and the backward
    disagree; 64 keys fewer must make every tensor disagree on its own."""
    from vision_pt_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_reference,
        flash_attention_reference,
    )

    i, n = 2, lens[2]
    row = [x[i:i + 1] for x in (q, k, v, out, lse, do)]
    kernel = [out[i:i + 1], lse[i:i + 1], *(g[i:i + 1] for g in grads)]
    shares = {}
    for label, wrong in (("64_keys_fewer", n - 64), ("tile_edge", n // 64 * 64),
                         ("one_key_fewer", n - 1)):
        wrong_lens = torch.tensor([wrong], device="cuda")
        refs = [*flash_attention_reference(*row[:3], wrong_lens),
                *flash_attention_bwd_reference(*row, wrong_lens)]
        shares[label] = dict(zip(("out", "lse", "dq", "dk", "dv"), (
            s for _, s in (_flash_compare(kernel[:2], refs[:2], tol)
                           + _flash_compare(kernel[2:], refs[2:], tol)))))
    emit("kernel", kernel="flash_attention", case="limits_can_fail", kv_len=n,
         limit_shares=shares)
    for label, s in shares.items():
        check(max(s["out"], s["lse"]) > 1 and max(s["dq"], s["dk"], s["dv"]) > 1,
              f"the flash limits pass a kernel with kv_len off ({label}): {s}")
    check(min(shares["64_keys_fewer"].values()) > 1,
          f"a flash limit passes 64 keys left out: {shares['64_keys_fewer']}")


def phase_flash_kernel() -> dict:
    """Kernels #7 and #8 against their plain versions; returns the largest
    error of each at the latent trainer's shape (S 4170 with kv_lens), and of
    #7 at each SDXL shape (by case name)."""
    from vision_pt_tpu_torch.ops.flash_attention import (
        NEG_INF,
        flash_attention,
        flash_attention_bwd,
        flash_attention_bwd_reference,
        flash_attention_reference,
        flash_attention_with_lse,
    )

    gen = torch.Generator(device="cuda").manual_seed(2)
    errors = {}
    for name, batch, sq, sk, heads, dim, dtype, causal, lens in FLASH_CASES:
        q, do = (_bshd(gen, batch, sq, heads, dim, dtype) for _ in range(2))
        k, v = (_bshd(gen, batch, sk, heads, dim, dtype) for _ in range(2))
        kv_lens = None if lens is None else torch.tensor(lens, device="cuda")
        tol = ATTN_TOL[dtype]
        out, lse = flash_attention_with_lse(q, k, v, kv_lens, causal=causal)
        # the backward's plain version takes the kernel's (out, lse) too
        grads = flash_attention_bwd(q, k, v, out, lse, do, kv_lens, causal=causal)
        torch.cuda.synchronize()
        ref, ref_lse = flash_attention_reference(q, k, v, kv_lens, causal=causal)
        ref_grads = flash_attention_bwd_reference(q, k, v, out, lse, do, kv_lens,
                                                  causal=causal)
        zero_rows = [i for i, n in enumerate(lens or []) if n == 0]
        partial = [(i, n) for i, n in enumerate(lens or []) if 0 < n < sk]
        for kernel, outs, refs in (("flash_attention", [out, lse], [ref, ref_lse]),
                                   ("flash_attention_bwd", grads, ref_grads)):
            err, share, within = _agree(_flash_compare(outs, refs, tol))
            finite = all(bool(torch.isfinite(o).all()) for o in outs)
            # a kv_len 0 row: output and gradients 0, LSE -1e30
            zero_row = all(bool((o[i] == (NEG_INF if o is lse else 0)).all())
                           for o in outs for i in zero_rows) if zero_rows else None
            past_kv_zero = None
            if kernel.endswith("bwd") and partial:
                past_kv_zero = all(bool((g[i, n:] == 0).all())
                                   for g in grads[1:] for i, n in partial)
            emit("kernel", kernel=kernel, case=name,
                 shape=[batch, sq, sk, heads, dim], dtype=str(dtype),
                 causal=causal, kv_lens=lens, max_abs_err=err, tolerance=tol,
                 lse_atol=LSE_ATOL if kernel == "flash_attention" else None,
                 limit_share=share, finite=finite, zero_row=zero_row,
                 past_kv_zero=past_kv_zero)
            check(finite and within and zero_row is not False
                  and past_kv_zero is not False,
                  f"{kernel} disagrees with its plain version at {name}")
            if name == "path_s4170_kv":
                errors[kernel] = err
            elif name.startswith("sdxl") and kernel == "flash_attention":
                errors[name] = err
        if name == "path_s4170_kv":
            _flash_limits_can_fail(q, k, v, do, out, lse, grads, lens, tol)
        if dtype == torch.float16:
            # the fp16 limits must fail the kernel's partial row against the
            # plain version of that row with one key fewer
            i, n = partial[0]
            wrong = torch.tensor([n - 1], device="cuda")
            row = [x[i:i + 1] for x in (q, k, v, out, lse, do)]
            refs = [flash_attention_reference(*row[:3], wrong, causal=causal)[0],
                    *flash_attention_bwd_reference(*row, wrong, causal=causal)]
            shares = [_compare(o, r, tol)[1] for o, r in
                      zip([out[i:i + 1], *(g[i:i + 1] for g in grads)], refs)]
            emit("kernel", kernel="flash_attention", case="limits_can_fail",
                 dtype=str(dtype), kv_len=n, one_key_fewer_shares=shares)
            check(shares[0] > 1 and max(shares[1:]) > 1,
                  f"the fp16 flash limits pass a kernel one key short: {shares}")
        del ref, ref_lse, ref_grads, grads
        torch.cuda.empty_cache()

    # autograd through the Function runs exactly the backward kernel
    q, k, v = (_bshd(gen, 2, 1000, 12, 64, torch.bfloat16).requires_grad_()
               for _ in range(3))
    do = _bshd(gen, 2, 1000, 12, 64, torch.bfloat16)
    kv_lens = torch.tensor([1000, 611], device="cuda")
    out = flash_attention(q, k, v, kv_lens)
    auto = torch.autograd.grad(out, (q, k, v), do)
    leaves = [x.detach() for x in (q, k, v)]
    again, lse = flash_attention_with_lse(*leaves, kv_lens)
    explicit = flash_attention_bwd(*leaves, again, lse, do, kv_lens)
    equal = torch.equal(out, again) and all(
        torch.equal(a, b) for a, b in zip(auto, explicit))
    emit("kernel", kernel="flash_attention_bwd", case="autograd",
         autograd_equals_explicit=equal)
    check(equal, "autograd through flash_attention differs from its backward")
    return errors


def _time_kernel(name, fn, plain, library, nbytes, flops, dtype, replaces,
                 source, shape, library_name, plain_chunk=None, iters=50,
                 phase="timing", executed_flops=None):
    """One row of the kernels line. Every time is of the same inputs: the
    kernel's and the library call's are device time (the median of 5
    windows of ``iters`` calls, with the fastest and slowest window,
    ``device_timing``), the plain version's one event window, host time
    included; ``plain_chunk`` notes that the plain version went over the
    batch in chunks of that many rows, one call each. ``executed_flops``,
    the products the kernel's design runs, adds their rate to the phase
    line (not to the row)."""
    kernel = device_timing(fn, iters)
    plain_ms = event_ms(plain, 3 if plain_chunk else 5, warmup=1 if plain_chunk else 3)
    library = device_timing(library, iters)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    row = dict(
        name=name, route="cuda", source=source, replaces=replaces,
        ms=kernel.median, ms_range=[kernel.low, kernel.high],
        plain_ms=plain_ms, plain_chunk=plain_chunk,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=library.median, library_ms_range=[library.low, library.high],
    )
    executed = {} if executed_flops is None else dict(
        executed_flops=executed_flops,
        executed_tflops=executed_flops / (kernel.median * 1e-3) / 1e12)
    emit(phase, shape=shape, dtype=str(dtype), bytes=nbytes, flops=flops,
         library=library_name, **row, **executed,
         ms_by_kernel={k[:80]: v for k, v in kernel.by_kernel.items()})
    return row


def phase_timing() -> dict:
    """Kernel #1 at the sampler shape; kernels #1 and #2 at the training
    step's shape (its blocks 4-11: S = 298). Returns the training rows."""
    import torch.nn.functional as F

    from vision_pt_tpu_torch.ops.short_attention import (
        short_attention_packed,
        short_attention_packed_bwd,
        short_attention_packed_bwd_reference,
        short_attention_packed_reference,
        short_attention_packed_with_lse,
    )

    heads, dim, dtype = 12, 64, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    for label, batch, s in (("sampler", 16, 266), ("train", TRAIN_BATCH, 298)):
        q, k, v = _attention_inputs(gen, batch, s, s, heads, dim, dtype)
        qh, kh, vh = (x.view(batch, s, heads, dim).transpose(1, 2) for x in (q, k, v))
        size = q.numel() * q.element_size()
        attn_flops = 2 * batch * heads * s * s * dim  # one (S, S, D) product
        rows[label] = _time_kernel(
            "short_attention_packed",
            lambda: short_attention_packed(q, k, v, heads, bounded=True),
            lambda: short_attention_packed_reference(q, k, v, heads, bounded=True),
            lambda: F.scaled_dot_product_attention(qh, kh, vh),
            4 * size, 2 * attn_flops, dtype,
            "vision_pt_tpu/ops/short_attention.py:462",
            "vision_pt_tpu_torch/csrc/short_attention.cu",
            [label, batch, s, s, heads, dim], "F.scaled_dot_product_attention",
        )
        if label != "train":
            continue
        # the forward as a training step runs it: with its row log-sum-exp
        rows["train_lse"] = _time_kernel(
            "short_attention_packed_with_lse",
            lambda: short_attention_packed_with_lse(q, k, v, heads, bounded=True),
            lambda: short_attention_packed_reference(q, k, v, heads, bounded=True,
                                                     return_lse=True),
            lambda: F.scaled_dot_product_attention(qh, kh, vh),
            4 * size + 4 * batch * heads * s, 2 * attn_flops, dtype,
            "vision_pt_tpu/ops/short_attention.py:462",
            "vision_pt_tpu_torch/csrc/short_attention.cu",
            [label, batch, s, s, heads, dim], "F.scaled_dot_product_attention",
        )
        do = torch.randn(batch, s, heads * dim, generator=gen, device="cuda").to(dtype)
        out, lse = short_attention_packed_with_lse(q, k, v, heads, bounded=True)
        leaves = [x.detach().requires_grad_() for x in (qh, kh, vh)]
        sdpa_out = F.scaled_dot_product_attention(*leaves)
        doh = do.view(batch, s, heads, dim).transpose(1, 2)
        rows["train_bwd"] = _time_kernel(
            "short_attention_packed_bwd",
            lambda: short_attention_packed_bwd(q, k, v, lse, do, heads,
                                               bounded=True),
            lambda: short_attention_packed_bwd_reference(q, k, v, lse, do,
                                                         heads, bounded=True),
            lambda: torch.autograd.grad(sdpa_out, leaves, doh, retain_graph=True),
            7 * size, 5 * attn_flops, dtype,
            "vision_pt_tpu/ops/short_attention.py:493",
            "vision_pt_tpu_torch/csrc/short_attention_bwd.cu",
            [label, batch, s, s, heads, dim],
            "torch.autograd.grad of F.scaled_dot_product_attention",
        )
    return rows


# (S, S, D) products that kernel #8 runs: s and dp in both of its launches,
# then dq; dv and dk (the function needs 5)
FLASH_BWD_PRODUCTS = 7

# kernel #7's timed forward shapes (D 64, bf16, no kv_lens): the latent
# trainer's, where kernel #8 is timed too, and the SDXL sampler's two
# self-attentions at 1024^2 (B 2 with CFG)
FLASH_TIMING_SHAPES = (("latent", LATENT_BATCH, 4106, 12), ("sdxl_s4096", 2, 4096, 10),
                       ("sdxl_s1024", 2, 1024, 20))


def phase_flash_timing() -> dict:
    """Kernel #7 at each of FLASH_TIMING_SHAPES and #8 at the latent one,
    keyed by label (the backward as ``latent_bwd``); their plain versions on
    the same inputs in calls of batch 2, whose (B, H, S, S) fp32 tensors are
    1.6 GB each at the latent shape (12.9 GB at batch 16)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from vision_pt_tpu_torch.ops.flash_attention import (
        flash_attention_bwd,
        flash_attention_bwd_reference,
        flash_attention_reference,
        flash_attention_with_lse,
    )

    dim, dtype, chunk = 64, torch.bfloat16, 2
    gen = torch.Generator(device="cuda").manual_seed(3)
    library = "F.scaled_dot_product_attention (FLASH_ATTENTION backend)"
    rows = {}
    for label, batch, s, heads in FLASH_TIMING_SHAPES:
        q, k, v, do = (_bshd(gen, batch, s, heads, dim, dtype) for _ in range(4))
        out, lse = flash_attention_with_lse(q, k, v)
        chunks = [[x[i:i + chunk] for x in (q, k, v, out, lse, do)]
                  for i in range(0, batch, chunk)]
        plain_chunk = chunk if batch > chunk else None
        size = q.numel() * q.element_size()
        lse_bytes = lse.numel() * lse.element_size()
        product = 2 * batch * heads * s * s * dim  # one (S, S, D) product
        qh, kh, vh, doh = (x.transpose(1, 2) for x in (q, k, v, do))
        shape = [label, batch, s, s, heads, dim]
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            rows[label] = _time_kernel(
                "flash_attention",
                lambda: flash_attention_with_lse(q, k, v),
                lambda: [flash_attention_reference(*c[:3]) for c in chunks],
                lambda: F.scaled_dot_product_attention(qh, kh, vh),
                4 * size + lse_bytes, 2 * product, dtype,
                "vision_pt_tpu/ops/flash_attention.py:115",
                "vision_pt_tpu_torch/csrc/flash_attention.cu", shape, library,
                plain_chunk=plain_chunk, iters=20, executed_flops=2 * product,
            )
            if label == "latent":
                leaves = [x.detach().requires_grad_() for x in (qh, kh, vh)]
                sdpa_out = F.scaled_dot_product_attention(*leaves)
                rows["latent_bwd"] = _time_kernel(
                    "flash_attention_bwd",
                    lambda: flash_attention_bwd(q, k, v, out, lse, do),
                    lambda: [flash_attention_bwd_reference(*c) for c in chunks],
                    lambda: torch.autograd.grad(sdpa_out, leaves, doh,
                                                retain_graph=True),
                    8 * size + lse_bytes, 5 * product, dtype,
                    "vision_pt_tpu/ops/flash_attention.py:325",
                    "vision_pt_tpu_torch/csrc/flash_attention_bwd.cu", shape,
                    "torch.autograd.grad of " + library, plain_chunk=plain_chunk,
                    iters=20, executed_flops=FLASH_BWD_PRODUCTS * product,
                )
                del leaves, sdpa_out
        del q, k, v, do, out, lse, chunks, qh, kh, vh, doh
        torch.cuda.empty_cache()
    return rows


def _wrappers():
    """The kernel wrappers, in the order of every launch-count tuple:
    kernels #1-#11 (packed forward and backward, the short backend's BSHD
    and BHSD forwards and backwards, flash forward and backward, NF4
    dequant-matmul, the two attention probes)."""
    from vision_pt_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_bwd,
    )
    from vision_pt_tpu_torch.ops.quant.nf4_matmul import dequant_matmul_4bit
    from vision_pt_tpu_torch.ops.short_attention import (
        short_attention,
        short_attention_bhsd,
        short_attention_bhsd_bwd,
        short_attention_bwd,
        short_attention_packed,
        short_attention_packed_bwd,
    )
    from vision_pt_tpu_torch.tools.bench.attention_pairing_probe import run_variant
    from vision_pt_tpu_torch.tools.bench.attention_roofline import dots_variant

    return (short_attention_packed, short_attention_packed_bwd, short_attention,
            short_attention_bwd, short_attention_bhsd, short_attention_bhsd_bwd,
            flash_attention, flash_attention_bwd, dequant_matmul_4bit,
            run_variant, dots_variant)


def _reset_counts():
    for fn in _wrappers():
        fn.launches = 0


def _counts() -> tuple[int, ...]:
    return tuple(fn.launches for fn in _wrappers())


def _diff(after, before) -> tuple[int, ...]:
    return tuple(a - b for a, b in zip(after, before))


def _jit_b16_config(label2id: str, dtype: str):
    from vision_pt_tpu_torch.models.jit import JiT_B_16_Config, JiTConfig

    return JiTConfig(
        context_encoder={"type": "class", "label2id_map_path": label2id},
        denoiser=JiT_B_16_Config(), dtype=dtype,
    )


def phase_sampler(label2id: str) -> tuple[int, ...]:
    from vision_pt_tpu_torch.models.jit import JiTModel

    t0 = time.perf_counter()
    model = JiTModel.new_with_config(_jit_b16_config(label2id, "bfloat16"), seed=0)
    build_s = time.perf_counter() - t0

    def request(seed):
        return model.generate(prompt=["c1"] * BATCH, width=256, height=256,
                              num_inference_steps=STEPS, cfg_scale=2.0,
                              seed=seed, return_arrays=True)

    request(100)  # warm-up: allocator, cuBLAS handles, rotary tables
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    seconds, per_request = [], []
    for i in range(REQUESTS):
        before = _counts()[0]
        t0 = time.perf_counter()
        out = request(i)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        per_request.append(_counts()[0] - before)
        check(tuple(out.shape) == (BATCH, 256, 256, 3), f"shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), "non-finite image")
    launches, bwd_launches, *others = _counts()
    emit("sampler", model="JiT-B/16", resolution=256, batch=BATCH, cfg=True,
         steps=STEPS, build_seconds=round(build_s, 3), request_seconds=seconds,
         steps_per_second=[STEPS / s for s in seconds],
         kernel_launches_per_request=per_request, bwd_launches=bwd_launches,
         other_launches=others,
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    check(per_request == [LAUNCHES_PER_REQUEST] * REQUESTS and bwd_launches == 0
          and others == [0] * len(others),
          f"packed kernel launches per request {per_request} (backward "
          f"{bwd_launches}, kernels #3-#11 {others}), expected "
          f"{LAUNCHES_PER_REQUEST} (0)")
    profile("sampler", lambda: request(7))
    return launches, bwd_launches, *others


def profile(path: str, run):
    """Where the device time of one run of ``path`` goes (torch.profiler);
    returns what the run returns."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    averages = prof.key_averages()
    kernels = [e for e in averages
               if e.device_type.name == "CUDA" and e.device_time_total > 0]
    device_us = sum(e.device_time_total for e in kernels)
    ops = [e for e in averages
           if e.device_type.name == "CPU" and e.self_device_time_total > 0]

    def rows(events, attr, n):
        top = sorted(events, key=lambda e: -getattr(e, attr))[:n]
        return [{"name": e.key[:60], "device_ms": getattr(e, attr) / 1e3,
                 "count": e.count} for e in top]

    emit("profile", path=path, wall_seconds=wall,
         device_kernel_seconds=device_us / 1e6,
         device_busy_share=(device_us / 1e6) / wall,
         port_kernels=rows([e for e in kernels if PORT_KERNEL.search(e.key)],
                           "device_time_total", 8),
         top_ops=rows(ops, "self_device_time_total", 14),
         top_kernels=rows(kernels, "device_time_total", 8))
    return result


def phase_train_step() -> tuple[int, ...]:
    """``bench_headline``'s step (vision_pt_tpu/benchmarks.py:83-135) in the
    port, as ``vision_pt_tpu_torch.benchmarks._jit_train_setup`` builds it;
    returns the kernel launches of the timed steps."""
    from vision_pt_tpu_torch.benchmarks import CONTEXT_LEN, _jit_train_setup
    from vision_pt_tpu_torch.models.jit import JiT_B_16_Config

    batch = TRAIN_BATCH
    model, optimizer, step = _jit_train_setup(
        JiT_B_16_Config(), batch, 256, dtype=torch.bfloat16,
        param_dtype=torch.float32)
    step(0)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    losses = [step(i) for i in range(1, TIMED_STEPS + 1)]
    torch.cuda.synchronize()
    seconds = (time.perf_counter() - t0) / TIMED_STEPS
    counts = _counts()
    fwd, bwd = counts[:2]
    losses = [float(x) for x in losses]
    emit("train_step", model="JiT-B/16", resolution=256, batch=batch,
         context_tokens=CONTEXT_LEN, compute="bfloat16", params="float32",
         optimizer="adamw 1e-4", timed_steps=TIMED_STEPS,
         seconds_per_step=seconds, images_per_second=batch / seconds,
         peak_memory_bytes=torch.cuda.max_memory_allocated(), losses=losses,
         fwd_launches_per_step=fwd / TIMED_STEPS,
         bwd_launches_per_step=bwd / TIMED_STEPS)
    check(all(np.isfinite(losses)), f"non-finite loss {losses}")
    check(counts == _expect({1: 12 * TIMED_STEPS, 2: 12 * TIMED_STEPS}),
          f"kernel launches {counts} over {TIMED_STEPS} steps, "
          "expected 12 + 12 packed per step and no flash")
    profile("train_step", lambda: step(TIMED_STEPS + 1))
    del model, optimizer, step
    torch.cuda.empty_cache()
    return counts


def phase_trainer(tmp: str) -> tuple[int, ...]:
    """The port's entry point on the synthetic config at JiT-B/16 width;
    returns the kernel launches of the whole run (steps and preview)."""
    import yaml

    from vision_pt_tpu_torch.models.jit import JiT_B_16_Config, JiTConfig, JiTModel
    from vision_pt_tpu_torch.train.jit.class_to_image import run
    from vision_pt_tpu_torch.training.trainer import Trainer

    with open(os.path.join(ROOT, "configs/jit/synthetic_class_to_image.yml")) as f:
        cfg = yaml.safe_load(f)
    label2id = os.path.join(tmp, "trainer_label2id.json")
    with open(label2id, "w") as f:
        json.dump({f"c{i}": i for i in range(4)}, f)
    model_cfg = cfg["model"]
    model_cfg["context_encoder"]["label2id_map_path"] = label2id
    model_cfg["denoiser"] = JiT_B_16_Config().model_dump()
    model_cfg["dtype"] = "bfloat16"
    model_cfg["max_token_length"] = 64
    cfg["dataset"].update(num_items=2 * TRAIN_BATCH, image_size=256,
                          batch_size=TRAIN_BATCH)
    cfg["scheduler"]["args"]["num_warmup_steps"] = 1
    cfg["saving"]["strategy"] = {"per_epochs": None}  # the final save only
    cfg["saving"]["callbacks"][0]["save_dir"] = os.path.join(tmp, "out")
    cfg["preview"]["callbacks"][0]["save_dir"] = os.path.join(tmp, "preview")
    cfg["preview"]["data"]["data"][0].update(width=256, height=256)
    cfg["tracker"]["log_dir"] = os.path.join(tmp, "logs")
    path = os.path.join(tmp, "trainer.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)

    per_step, step_seconds = [], []
    inner = Trainer.train_step

    def counting(self, *args, **kwargs):
        before = _counts()
        t0 = time.perf_counter()
        if len(per_step) == 3:  # the last step runs under the profiler
            out = profile("trainer", lambda: inner(self, *args, **kwargs))
        else:
            out = inner(self, *args, **kwargs)
        torch.cuda.synchronize()
        step_seconds.append(time.perf_counter() - t0)
        per_step.append(_diff(_counts(), before))
        return out

    Trainer.train_step = counting
    _reset_counts()
    t0 = time.perf_counter()
    try:
        trainer = run(path)
    finally:
        Trainer.train_step = inner
    seconds = time.perf_counter() - t0
    counts = _counts()
    with open(os.path.join(tmp, "logs", "verify_run.metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    saved = sorted(os.listdir(os.path.join(tmp, "out")))
    previews = os.listdir(os.path.join(tmp, "preview"))
    loaded = JiTModel.from_pretrained(
        JiTConfig.model_validate(model_cfg),
        os.path.join(tmp, "out", [n for n in saved if not n.startswith("ema_")][0]),
    )
    expected = trainer.model.model.state_dict()
    reloaded = all(torch.equal(v, expected[k]) for k, v in loaded.state_dict().items())
    emit("trainer", config="configs/jit/synthetic_class_to_image.yml",
         model="JiT-B/16", resolution=256, batch=TRAIN_BATCH,
         steps=trainer.global_step, run_seconds=seconds,
         step_seconds=step_seconds, losses=losses,
         launches_per_step=per_step, run_launches=counts, saved=saved,
         previews=len(previews), reloaded=reloaded,
         qk_logit_bound=[r.get("train/qk_logit_bound") for r in records
                         if "train/loss" in r])
    check(trainer.global_step == 4 and len(losses) == 4
          and all(np.isfinite(losses)), f"trainer losses {losses}")
    check(per_step == [_expect({1: 4, 2: 4})] * 4,
          f"launches per step {per_step}, expected 4 + 4 packed, no flash")
    check(len(saved) == 2 and len(previews) == 1 and reloaded,
          f"saved {saved}, previews {previews}, reloaded {reloaded}")
    del trainer, loaded
    torch.cuda.empty_cache()
    return counts


def _step_parity(phase: str, model: str, label2id: str, cases, **fields) -> None:
    """One training step of ``model`` (``tools.bench.step_parity``) on the
    card (kernels) and on the CPU (plain versions) for each (dtype, depth or
    None for the model's, launches) of ``cases``, held to
    TRAIN_PARITY_FLOOR; the card step must launch ``launches``."""
    from vision_pt_tpu_torch.tools.bench.step_parity import (
        grad_errors,
        step,
        summary,
    )

    for dtype, depth, launches in cases:
        results = {}
        for device in ("cuda", "cpu"):
            _reset_counts()
            results[device] = (step(model, dtype, device, label2id,
                                    loss_scale=LOSS_SCALE.get(dtype, 1.0),
                                    depth=depth),
                               _counts())
        (card, counts_c), (host, counts_h) = results["cuda"], results["cpu"]
        loss_err = abs(card.loss - host.loss) / abs(host.loss)
        errors = summary(grad_errors(card.grads, host.grads))
        floor = TRAIN_PARITY_FLOOR[dtype]
        emit(phase, dtype=dtype, batch=2, depth=depth, **fields,
             loss_scale=LOSS_SCALE.get(dtype, 1.0), loss_cuda=card.loss,
             loss_cpu=host.loss, loss_rel_err=loss_err,
             grad_rel_l2_max=errors["max"], grad_rel_l2_median=errors["median"],
             worst_params=errors["worst"], floor=floor, launches_cuda=counts_c,
             launches_cpu=counts_h, seconds_cuda=card.seconds,
             seconds_cpu=host.seconds)
        check(all(bool(torch.isfinite(g).all()) for g in card.grads.values()),
              "non-finite grads")
        check(counts_c == launches and counts_h == _expect({}),
              f"the card step must launch {launches} ({counts_c}), the CPU "
              f"step none ({counts_h})")
        check(loss_err <= floor["loss"] and errors["max"] <= floor["grad"],
              f"{dtype} {phase}: loss {loss_err:.2e}, grad {errors['worst'][0]}")
        del results, card, host
        torch.cuda.empty_cache()


# fp16 parity steps at reduced depth: the CPU side of an fp16 step takes
# 150 s (JiT-B/16) and 300 s (latent, depth 6) on the card's host, whose CPU
# has no fast fp16 matrix path (``tools.bench.step_parity`` runs them whole)
FP16_PARITY_DEPTH = {"jit": 6, "latent": 2}


def phase_train_parity(label2id: str) -> None:
    """One JiT-B/16 training step's loss and gradients on the card and on
    the CPU (#1/#2 at S 298, blocks 0-3; fp16 at depth 6)."""
    launches = _expect({1: 4, 2: 4})
    _step_parity("train_parity", "jit", label2id,
                 [("float32", None, launches), ("bfloat16", None, launches),
                  ("float16", FP16_PARITY_DEPTH["jit"], launches)])


def phase_parity(label2id: str) -> None:
    from vision_pt_tpu_torch.models.jit import JiTModel
    from vision_pt_tpu_torch.ops.attention import attention_dtype

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(os.cpu_count() or 1)
    init = np.random.default_rng(0).normal(size=(1, 256, 256, 3)).astype(np.float32)
    for dtype in ("float32", "bfloat16"):
        config = _jit_b16_config(label2id, dtype)
        results = {}
        for device in ("cuda", "cpu"):
            model = JiTModel.new_with_config(config, seed=0, device=device)
            _reset_counts()
            with attention_dtype(None if dtype == "float32" else torch.bfloat16):
                out = model.generate(
                    prompt=["c1"], width=256, height=256, num_inference_steps=2,
                    cfg_scale=2.0, execution_dtype=getattr(torch, dtype),
                    initial_noise=init, return_arrays=True,
                )
            results[device] = (out.float().cpu().numpy(), _counts()[0])
            del model
        value = psnr(results["cuda"][0], results["cpu"][0])
        emit("parity", dtype=dtype, batch=1, cfg=True, steps=2,
             psnr_db=value, floor_db=PSNR_FLOOR_DB[dtype],
             kernel_launches_cuda=results["cuda"][1],
             kernel_launches_cpu=results["cpu"][1])
        check(np.isfinite(results["cuda"][0]).all(), "non-finite parity output")
        check(results["cuda"][1] == 4 * 2 and results["cpu"][1] == 0,
              "the card run must launch the kernel 8 times, the CPU run never")
        check(value >= PSNR_FLOOR_DB[dtype],
              f"{dtype} card-vs-CPU PSNR {value:.2f} dB < {PSNR_FLOOR_DB[dtype]}")


def _write_latent_cache(cache_dir: str, label2id: str) -> None:
    """A cache in the JAX package's layout (``vision_pt_tpu/data/
    latent_cache.py``): LATENT_ITEMS latents of 128 x 128 x 4 fp16
    mean/std, SDXL sizes of 1024, captions of 1-4 of four classes, so the
    context (and kv_lens) differ per row."""
    rng = np.random.default_rng(0)
    os.makedirs(cache_dir, exist_ok=True)
    rows = []
    side, size = LATENT_SIDE, 8 * LATENT_SIDE
    for i in range(LATENT_ITEMS):
        name = f"{i:040x}.npz"
        np.savez(os.path.join(cache_dir, name),
                 mean=rng.normal(size=(side, side, 4)).astype(np.float16),
                 std=rng.uniform(0.05, 0.3, size=(side, side, 4)).astype(np.float16))
        rows.append({"caption": " ".join(f"c{(i + j) % 4}" for j in range(1 + i % 4)),
                     "height": size, "width": size,
                     "original_size": [size, size], "target_size": [size, size],
                     "crop_coords_top_left": [0, 0], "scaling_factor": 0.13025,
                     "dtype": "float16", "file": name, "latent_height": side,
                     "latent_width": side})
    with open(os.path.join(cache_dir, "manifest.jsonl"), "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    with open(label2id, "w") as f:
        json.dump({f"c{i}": i for i in range(4)}, f)


def phase_latent_trainer(tmp: str) -> tuple[int, ...]:
    """The port's latent entry point on ``configs/jit/latent_arb_1024.yml`` as
    shipped, paths rewritten; returns the kernel launches of the whole run
    (the sanity check and 4 steps)."""
    import yaml

    from vision_pt_tpu_torch.train.jit.latent_class_to_image import run
    from vision_pt_tpu_torch.training.trainer import Trainer

    with open(os.path.join(ROOT, "configs/jit/latent_arb_1024.yml")) as f:
        cfg = yaml.safe_load(f)
    label2id = os.path.join(tmp, "latent_label2id.json")
    _write_latent_cache(os.path.join(tmp, "latent_cache"), label2id)
    cfg["model"]["context_encoder"]["label2id_map_path"] = label2id
    cfg["dataset"]["cache_dir"] = os.path.join(tmp, "latent_cache")
    cfg["saving"]["callbacks"][0]["save_dir"] = os.path.join(tmp, "latent_out")
    cfg["tracker"]["log_dir"] = os.path.join(tmp, "latent_logs")
    cfg["num_train_epochs"] = 1
    path = os.path.join(tmp, "latent.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)

    per_step, step_seconds, context_lens = [], [], []
    inner = Trainer.train_step

    def counting(self, batch, *args, **kwargs):
        context_lens.append(batch["context_mask"].sum(dim=1).tolist())
        before = _counts()
        t0 = time.perf_counter()
        if len(per_step) == 3:  # the last step runs under the profiler
            out = profile("latent_trainer",
                          lambda: inner(self, batch, *args, **kwargs))
        else:
            out = inner(self, batch, *args, **kwargs)
        torch.cuda.synchronize()
        step_seconds.append(time.perf_counter() - t0)
        per_step.append(_diff(_counts(), before))
        return out

    Trainer.train_step = counting
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    try:
        trainer = run(path)
    finally:
        Trainer.train_step = inner
    seconds = time.perf_counter() - t0
    counts = _counts()
    peak = torch.cuda.max_memory_allocated()
    with open(os.path.join(tmp, "latent_logs", "JiT", "latent-1024.metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    losses = [r["train/loss"] for r in records if "train/loss" in r]
    saved = sorted(os.listdir(os.path.join(tmp, "latent_out")))
    denoiser = trainer.model.model.denoiser
    tokens = (LATENT_SIDE // denoiser.config.patch_size) ** 2 + 6 + \
        denoiser.config.num_time_tokens + trainer.model.model_config.max_token_length
    steady = step_seconds[1:3]  # after the first, before the profiled step
    emit("latent_trainer", config="configs/jit/latent_arb_1024.yml",
         depth=denoiser.config.depth, hidden=denoiser.config.hidden_size,
         latent=[LATENT_SIDE, LATENT_SIDE, 4], tokens=tokens,
         batch=LATENT_BATCH, steps=trainer.global_step, run_seconds=seconds,
         step_seconds=step_seconds,
         seconds_per_step=sum(steady) / len(steady),
         latents_per_second=LATENT_BATCH * len(steady) / sum(steady),
         peak_memory_bytes=peak, losses=losses,
         context_tokens_per_step=context_lens,
         launches_per_step=per_step, run_launches=counts, saved=saved)
    check(denoiser.config.depth == 24 and tokens == 4170,
          f"latent config: depth {denoiser.config.depth}, {tokens} tokens")
    check(trainer.global_step == 4 and len(losses) == 4
          and all(np.isfinite(losses)), f"latent trainer losses {losses}")
    check(per_step == [LATENT_STEP_LAUNCHES] * 4,
          f"launches per step {per_step}, expected {LATENT_STEP_LAUNCHES}")
    check(len(saved) == 1, f"saved {saved}")
    del trainer, denoiser
    torch.cuda.empty_cache()
    return counts


def phase_latent_parity(tmp: str) -> None:
    """One latent training step's loss and gradients on the card and on the
    CPU: full width, depth 6 (fp16: 2), a 64 x 64 latent (S = 1098), batch 2
    (#7/#8, one launch each a block)."""
    fp16 = FP16_PARITY_DEPTH["latent"]
    _step_parity("latent_parity", "latent", os.path.join(tmp, "latent_label2id.json"),
                 [("float32", 6, _expect({7: 6, 8: 6})),
                  ("bfloat16", 6, _expect({7: 6, 8: 6})),
                  ("float16", fp16, _expect({7: fp16, 8: fp16}))],
                 latent=[64, 64, 4])


# ------------------------------------------------------------ SDXL phases

# kernel #9 at the sampler's shapes (the 2 x 77 context rows of every
# cross-attention to_k / to_v, K 2048, N 640 or 1280) and at edge shapes
NF4_PATH_SHAPES = ((154, 2048, 640), (154, 2048, 1280))
NF4_EDGE_SHAPES = tuple((m, k, n) for m in (1, 37, 1024) for k in (128, 5120)
                        for n in (8, 136, 10240))
# kernel #9's block shapes change at M 64, 128 and 256, and its K splits
# with M and N (ops/quant/nf4_matmul.py:plan): both sides of each boundary
NF4_SPLIT_SHAPES = tuple((m, 2048, 1280) for m in (1, 64, 65, 128, 129, 256, 257,
                                                   1024))  # and M 154: the path
SDXL_SIDE, SDXL_STEPS, SDXL_CFG, SDXL_TOKENS = 1024, 20, 5.0, 75
# per UNet call at 1024^2 with CFG: 70 self-attentions take flash (10 at
# S 4096 with 10 heads, 60 at S 1024 with 20), and the to_k / to_v of the 70
# cross-attentions (154 rows) take kernel #9 once the UNet is NF4
SDXL_LAUNCHES = {"bf16": _expect({7: 70 * SDXL_STEPS}),
                 "nf4": _expect({7: 70 * SDXL_STEPS, 9: 140 * SDXL_STEPS})}
SDXL_PROMPT = ("photo of a red fox in the snow, detailed fur",
               "blurry, ugly, low quality")
# sdxl_parity at 512^2, full widths, layers_per_block 1, one transformer per
# stage, one UNet call (batch 2) and a 2-step generate (two calls): flash at
# stage 2 (32 x 32 = 1024 tokens, 3 self-attentions a call); under NF4 the
# kernel takes every product of at most 1024 rows: the 6 context products
# of stage 2 and all 48 quantized products of stage 3 (2 x 256 rows)
SDXL_PARITY_LAUNCHES = {"bf16": _expect({7: 9}), "nf4": _expect({7: 9, 9: 162})}
# sdxl_parity floors on the relative L2 error, card vs CPU, in bf16: every
# activation is rounded to 8 mantissa bits through ~40 layers and the card's
# and the CPU's matmuls and convolutions round at other places (the JiT
# phases see a few percent in bf16; one UNet call measured 1.5e-2). The
# latents pass two steps of CFG 5, which scales the difference of the two
# predictions, and their error, by 5 (measured 3.3e-2 and 4.4e-2, an H100
# against its host, the same in every run). Each floor lies between those
# readings and those of a kernel #9 with one scale row 25% off in every
# launch (measured 8.6e-2 and 1.37e-1), which the phase runs to show it.
SDXL_PARITY_FLOOR = {"unet": 5e-2, "latents": 7.5e-2}


def phase_nf4_kernel() -> float:
    """Kernel #9 against its plain version, nf4 and fp4, bf16, fp16 and fp32;
    returns the largest error at the path's shape (154 x 2048 -> 1280, bf16,
    nf4)."""
    from vision_pt_tpu_torch.ops.quant.nf4 import quantize_4bit_device_kernel_layout
    from vision_pt_tpu_torch.ops.quant.nf4_matmul import (
        dequant_matmul_4bit,
        dequant_matmul_4bit_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(4)
    weights, cases, path = {}, [], None
    for m, k, n in NF4_PATH_SHAPES + NF4_EDGE_SHAPES + NF4_SPLIT_SHAPES:
        for quant_type in ("nf4", "fp4"):
            if (k, n, quant_type) not in weights:
                w = torch.randn(n, k, generator=gen, device="cuda") * 0.05
                weights[k, n, quant_type] = quantize_4bit_device_kernel_layout(
                    w, quant_type)
            packed, absmax = weights[k, n, quant_type]
            for dtype in (torch.bfloat16, torch.float16, torch.float32):
                x = torch.randn(m, k, generator=gen, device="cuda").to(dtype)
                out = dequant_matmul_4bit(x, packed, absmax, quant_type)
                torch.cuda.synchronize()
                ref = dequant_matmul_4bit_reference(x, packed, absmax, quant_type)
                err, share = _compare(out, ref, TOL[dtype])
                ok = (bool(torch.isfinite(out).all()) and share <= 1.0
                      and out.dtype == dtype and out.shape == ref.shape)
                cases.append([m, k, n, quant_type, str(dtype)[6:], err, share, ok])
                check(ok, f"dequant_matmul_4bit disagrees at {cases[-1]}")
                if (m, n, quant_type, dtype) == (154, 1280, "nf4", torch.bfloat16):
                    path = (x, packed, absmax, out, err)
                if (k, n, quant_type) == (2048, 1280, "nf4") and m in (64, 154):
                    # repeated calls give the same bits: the splits are added
                    # in a fixed order, no atomics
                    same = torch.equal(out, dequant_matmul_4bit(x, packed, absmax))
                    emit("nf4_kernel", kernel="dequant_matmul_4bit", case="repeat",
                         shape=[m, k, n], dtype=str(dtype), bitwise_equal=same)
                    check(same, f"two calls of dequant_matmul_4bit differ at {m}")
    emit("nf4_kernel", kernel="dequant_matmul_4bit",
         tolerance={str(dtype)[6:]: tol for dtype, tol in TOL.items()},
         columns=["m", "k", "n", "quant", "dtype", "max_abs_err", "limit_share", "ok"],
         cases=cases)
    # the limits must fail a plain version with one absmax row 25% off, or
    # with one 64-row chunk left out
    x, packed, absmax, out, err = path
    perturbed, dropped = absmax.clone(), absmax.clone()
    perturbed[3] *= 1.25
    dropped[3] = 0.0
    shares = {label: _compare(out, dequant_matmul_4bit_reference(x, packed, a),
                              TOL[torch.bfloat16])[1]
              for label, a in (("absmax_row_perturbed", perturbed),
                               ("chunk_dropped", dropped))}
    emit("nf4_kernel", kernel="dequant_matmul_4bit", case="limits_can_fail",
         limit_shares=shares)
    check(min(shares.values()) > 1, f"an NF4 limit passes a wrong kernel: {shares}")
    return err


def phase_nf4_timing() -> dict:
    """Kernel #9 at the sampler's two shapes and at the JAX package's bench
    shape (M 64, K = N = 8192), bf16, nf4; the yardstick is F.linear on the
    weight dequantized to bf16 beforehand."""
    import torch.nn.functional as F

    from vision_pt_tpu_torch.ops.quant.layers import _dequant_deint
    from vision_pt_tpu_torch.ops.quant.nf4 import quantize_4bit_device_kernel_layout
    from vision_pt_tpu_torch.ops.quant.nf4_matmul import (
        dequant_matmul_4bit,
        dequant_matmul_4bit_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(5)
    rows = {}
    for label, (m, k, n) in (("path_n640", NF4_PATH_SHAPES[0]),
                             ("path", NF4_PATH_SHAPES[1]), ("bench", (64, 8192, 8192))):
        w = torch.randn(n, k, generator=gen, device="cuda") * 0.05
        packed, absmax = quantize_4bit_device_kernel_layout(w)
        dense = _dequant_deint(packed, absmax, "nf4", torch.bfloat16)  # (n, k)
        x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
        nbytes = 2 * m * k + packed.numel() + 4 * absmax.numel() + 2 * m * n
        rows[label] = _time_kernel(
            "dequant_matmul_4bit",
            lambda: dequant_matmul_4bit(x, packed, absmax),
            lambda: dequant_matmul_4bit_reference(x, packed, absmax),
            lambda: F.linear(x, dense),
            nbytes, 2 * m * k * n, torch.bfloat16,
            "vision_pt_tpu/ops/quant/pallas_nf4.py:167",
            "vision_pt_tpu_torch/csrc/nf4_matmul.cu", [label, m, k, n],
            "F.linear on the weight dequantized to bf16 beforehand",
            phase="nf4_timing",
        )
        del w, packed, absmax, dense
    return rows


def phase_sdxl_sampler() -> dict:
    """SDXL-base at full width, random weights from a seed, bf16 compute
    with fp32 parameters, built on the card; through the CLI's ``run`` at
    1024^2, batch 1, CFG 5, 20 steps: one warm and one timed request in
    bf16, then again with the UNet NF4 (the CLI's keys), each followed by a
    profiled 2-step request. Returns the timed requests' kernel launches."""
    from vision_pt_tpu_torch.models.sdxl import SDXLConfig, SDXLModel, WordHashTokenizer
    from vision_pt_tpu_torch.ops.quant import quantize_inplace
    from vision_pt_tpu_torch.tools import inference_cli as cli

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tokenizer = WordHashTokenizer()
    model = SDXLModel.from_config(SDXLConfig(checkpoint_path="", dtype="bfloat16"),
                                  seed=0, device="cuda", tokenizer_1=tokenizer,
                                  tokenizer_2=tokenizer)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    params = {name: sum(p.numel() for p in module.parameters())
              for name, module in model._submodules().items()}

    def request(seed, steps=SDXL_STEPS):
        return cli.run(model, SDXL_PROMPT[0], SDXL_PROMPT[1], width=SDXL_SIDE,
                       height=SDXL_SIDE, num_inference_steps=steps,
                       cfg_scale=SDXL_CFG, seed=seed, max_token_length=SDXL_TOKENS)

    launches = {}
    for label in ("bf16", "nf4"):
        replaced, quant_s = [], None
        if label == "nf4":
            t0 = time.perf_counter()
            replaced = quantize_inplace(model.denoiser, "bnb_nf4",
                                        cli.INCLUDE_KEYS, cli.EXCLUDE_KEYS)
            torch.cuda.synchronize()
            quant_s = time.perf_counter() - t0
            torch.cuda.empty_cache()
        request(100, steps=2)  # warm-up: allocator, cuDNN and cuBLAS plans
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        t0 = time.perf_counter()
        image = request(1)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _counts()
        stats = image.float()
        emit("sdxl_sampler", model="SDXL-base (random weights, seed 0)",
             unet=label, params=params, quantized_linears=len(replaced),
             quantize_seconds=quant_s, resolution=SDXL_SIDE, batch=1,
             cfg=SDXL_CFG, steps=SDXL_STEPS, context_tokens=SDXL_TOKENS + 2,
             build_seconds=build_s, seconds_per_image=seconds,
             steps_per_second=SDXL_STEPS / seconds,
             peak_memory_bytes=torch.cuda.max_memory_allocated(),
             launches=counts, expected=SDXL_LAUNCHES[label],
             image_mean=float(stats.mean()), image_std=float(stats.std()))
        check(tuple(image.shape) == (1, SDXL_SIDE, SDXL_SIDE, 3),
              f"image shape {tuple(image.shape)}")
        check(bool(torch.isfinite(stats).all()) and float(stats.std()) > 1e-3,
              "the SDXL image is not finite, or constant")
        check(counts == SDXL_LAUNCHES[label],
              f"SDXL {label} launches {counts}, expected {SDXL_LAUNCHES[label]}")
        if label == "nf4":  # 70 blocks of 10 linears, 11 transformers of 2
            check(len(replaced) == 70 * 10 + 11 * 2,
                  f"{len(replaced)} quantized linears")
        launches[f"sdxl_{label}"] = counts
        # a 2-step request: the profiler's own processing of a 20-step one
        # (about 400 k events) takes minutes
        profile(f"sdxl_{label}_2_steps", lambda: request(2, steps=2))
    del model, image
    torch.cuda.empty_cache()
    return launches


def _rel_l2(ours: np.ndarray, theirs: np.ndarray) -> float:
    return float(np.linalg.norm(ours - theirs) / max(np.linalg.norm(theirs), 1e-30))


def phase_sdxl_parity() -> None:
    """The same weights and draws on the card (kernels) and on the CPU (the
    plain versions of the same path): full widths, layers_per_block 1, one
    transformer per stage, 512^2, bf16; one UNet call (batch 2) and a 2-step
    CFG generate, before and after NF4 quantization."""
    import copy

    import vision_pt_tpu_torch.ops.attention as attention
    from vision_pt_tpu_torch.models.sdxl import (
        DenoiserConfig,
        SDXLConfig,
        SDXLModel,
        WordHashTokenizer,
    )
    from vision_pt_tpu_torch.ops.quant import layers as qlayers
    from vision_pt_tpu_torch.ops.quant import quantize_inplace
    from vision_pt_tpu_torch.tools import inference_cli as cli

    bf16 = torch.bfloat16
    torch.set_num_threads(os.cpu_count() or 1)
    config = SDXLConfig(checkpoint_path="", dtype="bfloat16", denoiser=DenoiserConfig(
        layers_per_block=1, num_transformers_per_block=[1, 1, 1]))
    tokenizer = WordHashTokenizer()
    card = SDXLModel.from_config(config, seed=1, device="cuda",
                                 tokenizer_1=tokenizer, tokenizer_2=tokenizer)
    rng = np.random.default_rng(5)
    unet_args = [
        rng.normal(size=(2, 64, 64, 4)).astype(np.float32),
        np.asarray([999.0, 500.0], np.float32),
        rng.normal(size=(2, 77, 2048)).astype(np.float32),
        rng.normal(size=(2, 1280)).astype(np.float32),
        np.full((2, 2), 512.0, np.float32), np.full((2, 2), 512.0, np.float32),
        np.zeros((2, 2), np.float32),
    ]
    low = (0, 2, 3)  # the arguments in the execution dtype
    sigma = card.scheduler.get_max_noise_sigma(
        card.scheduler.get_sigmas(card.scheduler.get_timesteps(2)))
    latents = rng.normal(size=(1, 64, 64, 4)).astype(np.float32) * sigma
    noise = [rng.normal(size=(1, 64, 64, 4)).astype(np.float32) for _ in range(2)]

    def run(model, device):
        """(UNet output, latents, launches, seconds) of one UNet call and the
        2-step generate; the CPU runs the same path, through the plain
        versions."""
        args = [torch.from_numpy(a).to(device, bf16 if i in low else torch.float32)
                for i, a in enumerate(unet_args)]
        _reset_counts()
        gates = attention._on_cuda, qlayers._on_cuda
        attention._on_cuda = qlayers._on_cuda = lambda x: True
        t0 = time.perf_counter()
        try:
            with torch.inference_mode():
                unet_out = model.denoiser(*args)
            out = model.generate(SDXL_PROMPT[0], SDXL_PROMPT[1], width=512,
                                 height=512, num_inference_steps=2,
                                 cfg_scale=SDXL_CFG, execution_dtype=bf16,
                                 latents=latents, step_noise=noise,
                                 return_latents=True)
        finally:
            attention._on_cuda, qlayers._on_cuda = gates
        return (unet_out.float().cpu().numpy(), out.float().cpu().numpy(),
                _counts(), time.perf_counter() - t0)

    for label in ("bf16", "nf4"):
        if label == "nf4":
            quantize_inplace(card.denoiser, "bnb_nf4", cli.INCLUDE_KEYS,
                             cli.EXCLUDE_KEYS)
        host = copy.deepcopy(card).to("cpu")
        unet_c, lat_c, counts_c, sec_c = run(card, "cuda")
        unet_h, lat_h, counts_h, sec_h = run(host, "cpu")
        errors = {"unet": _rel_l2(unet_c, unet_h), "latents": _rel_l2(lat_c, lat_h)}
        emit("sdxl_parity", unet=label, resolution=512, depth="layers_per_block 1, "
             "one transformer per stage", rel_l2=errors, floor=SDXL_PARITY_FLOOR,
             psnr_db={"unet": psnr(unet_c, unet_h), "latents": psnr(lat_c, lat_h)},
             launches_cuda=counts_c, launches_cpu=counts_h,
             expected_cuda=SDXL_PARITY_LAUNCHES[label], seconds_cuda=sec_c,
             seconds_cpu=sec_h)
        check(np.isfinite(unet_c).all() and np.isfinite(lat_c).all(),
              "non-finite SDXL parity output")
        check(counts_c == SDXL_PARITY_LAUNCHES[label] and counts_h == _expect({}),
              f"SDXL parity launches: card {counts_c}, expected "
              f"{SDXL_PARITY_LAUNCHES[label]}; CPU {counts_h}, expected none")
        check(all(errors[k] <= SDXL_PARITY_FLOOR[k] for k in errors),
              f"SDXL {label} parity {errors} over {SDXL_PARITY_FLOOR}")
        del host
        if label != "nf4":
            continue
        # the floors must fail a kernel #9 that is slightly wrong in every
        # launch: its scale row 3 25% off, or that chunk left out
        kernel, wrong_errors = qlayers.dequant_matmul_4bit, {}
        for wrong_label, scale in (("absmax_row_perturbed", 1.25),
                                   ("chunk_dropped", 0.0)):
            def wrong(x, packed, absmax, quant_type="nf4", scale=scale):
                absmax = absmax.clone()
                absmax[3] *= scale
                return kernel(x, packed, absmax, quant_type)

            qlayers.dequant_matmul_4bit = wrong
            try:
                unet_w, lat_w, _, _ = run(card, "cuda")
            finally:
                qlayers.dequant_matmul_4bit = kernel
            wrong_errors[wrong_label] = {"unet": _rel_l2(unet_w, unet_h),
                                         "latents": _rel_l2(lat_w, lat_h)}
        emit("sdxl_parity", unet=label, case="limits_can_fail", rel_l2=wrong_errors,
             floor=SDXL_PARITY_FLOOR)
        for wrong_label, e in wrong_errors.items():
            check(all(e[k] > SDXL_PARITY_FLOOR[k] for k in e),
                  f"an SDXL parity floor passes kernel #9 with {wrong_label}: {e}")
    del card
    torch.cuda.empty_cache()


# ---------------------------------- the short backend (#3-#6) and the probes

# (name, batch, sq, sk, heads, dim, dtype, kv_lens): the JiT-B/16 train shape,
# then edge shapes; "range" draws kv_lens in [266, Sk] with row 1 at 0
SHORT_CASES = [
    ("train_s298", 64, 298, 298, 12, 64, torch.bfloat16, None),
    ("train_s298_kv_fp16", 16, 298, 298, 12, 64, torch.float16, "range"),
    ("d128_fp16", 4, 266, 266, 6, 128, torch.float16, "range"),
    ("train_s298_kv", 16, 298, 298, 12, 64, torch.bfloat16, "range"),
    ("s37", 2, 37, 37, 2, 64, torch.bfloat16, [37, 21]),
    ("sq266_sk77", 4, 266, 77, 6, 64, torch.bfloat16, [77, 40, 0, 1]),
    ("d128", 4, 266, 266, 6, 128, torch.bfloat16, "range"),
    ("fp32_s266", 4, 266, 266, 12, 64, torch.float32, [266, 100, 0, 7]),
    ("fp32_d128_sq266_sk77", 2, 266, 77, 4, 128, torch.float32, [77, 0]),
]
SHORT_SHAPE = (64, 298, 12, 64)  # JiT-B/16's training step: B, S, H, D
PROBE_SHAPE = (64, 304, 12, 64)  # the probes' (S padded to 304 on the TPU)
# (name, batch, seq, heads) of the probes' cases (D 64, bf16): their shape,
# then S that cut their 64-row tiles, JiT-B/16's unpadded S 298 last
PROBE_CASES = [("probe", *PROBE_SHAPE[:3]), ("s37", 2, 37, 2), ("s65", 3, 65, 4),
               ("s129", 4, 129, 12), ("s257", 8, 257, 12), ("s298", 64, 298, 12)]
ROOFLINE_STEPS = 5  # training steps per timing window of the roofline probe


def _short_entries(layout):
    """(forward, forward with lse, backward, plain forward, plain backward,
    batch-first view of a BSHD tensor in this layout) of the short backend's
    BSHD or BHSD entry."""
    from vision_pt_tpu_torch.ops import short_attention as sa

    if layout == "bshd":
        return (sa.short_attention, sa.short_attention_with_lse,
                sa.short_attention_bwd, sa.short_attention_reference,
                sa.short_attention_bwd_reference, lambda x: x)
    return (sa.short_attention_bhsd, sa.short_attention_bhsd_with_lse,
            sa.short_attention_bhsd_bwd, sa.short_attention_bhsd_reference,
            sa.short_attention_bhsd_bwd_reference,
            lambda x: x.transpose(1, 2).contiguous())


def phase_short_kernel() -> dict:
    """Kernels #3-#6 (the short backend's forward and backward, BSHD and
    BHSD) and #10, #11 (the probes) against their plain versions; returns
    the largest error of each at the train shape (#3-#6) and at the probe
    shape (#10, #11)."""
    from vision_pt_tpu_torch.tools.bench import attention_pairing_probe as pairing
    from vision_pt_tpu_torch.tools.bench import attention_roofline as roofline

    gen = torch.Generator(device="cuda").manual_seed(6)
    errors = {}
    for name, batch, sq, sk, heads, dim, dtype, lens in SHORT_CASES:
        q, do = (_bshd(gen, batch, sq, heads, dim, dtype) for _ in range(2))
        k, v = (_bshd(gen, batch, sk, heads, dim, dtype) for _ in range(2))
        kv_lens = _kv_lens(gen, lens, batch, sk)
        tol = ATTN_TOL[dtype]
        row_lens = [sk] * batch if kv_lens is None else kv_lens.clamp(0, sk).tolist()
        zero_rows = [i for i, n in enumerate(row_lens) if n == 0]
        partial = [(i, n) for i, n in enumerate(row_lens) if 0 < n < sk]
        for layout in ("bshd", "bhsd"):
            fwd, fwd_lse, bwd, plain_fwd, plain_bwd, view = _short_entries(layout)
            args = [view(x) for x in (q, k, v)]
            dout = view(do)
            out, lse = fwd_lse(*args, kv_lens)
            grads = bwd(*args, lse, dout, kv_lens)
            torch.cuda.synchronize()
            ref, ref_lse = plain_fwd(*args, kv_lens, return_lse=True)
            ref_grads = plain_bwd(*args, lse, dout, kv_lens)
            for kernel, outs, compared in (
                    (fwd.__name__, [out], [_compare(out, ref, tol),
                                           _compare(lse, ref_lse, 0.0, LSE_ATOL)]),
                    (bwd.__name__, grads,
                     [_compare(o, r, tol) for o, r in zip(grads, ref_grads)])):
                err, share, within = _agree(compared)
                finite = all(bool(torch.isfinite(o).all()) for o in outs)
                zero_row = all(bool((o[i] == 0).all()) for o in outs
                               for i in zero_rows) if zero_rows else None
                past_kv_zero = None
                if kernel.endswith("bwd") and partial:
                    rows = [g[i, n:] if layout == "bshd" else g[i, :, n:]
                            for g in grads[1:] for i, n in partial]
                    past_kv_zero = all(bool((r == 0).all()) for r in rows)
                emit("short_kernel", kernel=kernel, case=name, layout=layout,
                     shape=[batch, sq, sk, heads, dim], dtype=str(dtype),
                     kv_lens=row_lens if lens else None, max_abs_err=err,
                     tolerance=tol, limit_share=share, finite=finite,
                     zero_row=zero_row, past_kv_zero=past_kv_zero)
                check(finite and within and zero_row is not False
                      and past_kv_zero is not False,
                      f"{kernel} disagrees with its plain version at {name}")
                if name == "train_s298":
                    errors[kernel] = err
            if name.startswith("train_s298_kv"):
                # the limits must fail the kernel's results for row 0 against
                # the plain version of that row with one key fewer
                n = row_lens[0]
                wrong = torch.tensor([n - 1], device="cuda")
                row = [x[:1] for x in (*args, lse, dout)]
                kernel_row = [out[:1], *(g[:1] for g in grads)]
                refs = [plain_fwd(*row[:3], wrong), *plain_bwd(*row, wrong)]
                shares = [_compare(o, r, tol)[1] for o, r in zip(kernel_row, refs)]
                emit("short_kernel", kernel=fwd.__name__, layout=layout,
                     case="limits_can_fail", dtype=str(dtype), kv_len=n,
                     one_key_fewer_shares=shares)
                check(shares[0] > 1 and max(shares[1:]) > 1,
                      f"the {layout} limits pass a kernel one key short: {shares}")
        del q, k, v, do, out, lse, grads, ref, ref_lse, ref_grads
        torch.cuda.empty_cache()

    # autograd through both entries runs exactly their backward kernels
    q, k, v, do = (_bshd(gen, 4, 266, 12, 64, torch.bfloat16) for _ in range(4))
    kv_lens = torch.tensor([266, 200, 0, 31], device="cuda")
    for layout in ("bshd", "bhsd"):
        fwd, fwd_lse, bwd, _, _, view = _short_entries(layout)
        leaves = [view(x).detach().requires_grad_() for x in (q, k, v)]
        auto = torch.autograd.grad(fwd(*leaves, kv_lens), leaves, view(do))
        detached = [x.detach() for x in leaves]
        _, lse = fwd_lse(*detached, kv_lens)
        explicit = bwd(*detached, lse, view(do), kv_lens)
        equal = all(torch.equal(a, b) for a, b in zip(auto, explicit))
        emit("short_kernel", kernel=bwd.__name__, layout=layout, case="autograd",
             autograd_equals_explicit=equal)
        check(equal, f"autograd through {fwd.__name__} differs from its backward")

    # the probes at their shape and at edges of their 64-row tiles; the
    # limits must fail a plain version that leaves out one head's output, and
    # one that drops the last key
    tol = TOL[torch.bfloat16]
    for name, batch, seq, heads in PROBE_CASES:
        dim = 64
        x = torch.randn(batch, seq, heads * dim, generator=gen,
                        device="cuda").to(torch.bfloat16)
        for kernel, run, plain in (
                ("run_variant", pairing.run_variant, pairing.run_variant_reference),
                ("dots_variant", lambda x, h: [roofline.dots_variant(x, h)],
                 lambda x, h, **kw: [roofline.dots_variant_reference(x, h, **kw)])):
            outs = run(x, heads)
            torch.cuda.synchronize()
            refs = plain(x, heads)
            err, share, within = _agree([_compare(o, r, tol) for o, r in zip(outs, refs)])
            finite = all(bool(torch.isfinite(o).all()) for o in outs)
            head = min(5, heads - 1)
            dropped = [r.clone() for r in refs]
            for r in dropped:
                r[..., head * dim:(head + 1) * dim] = 0
            dropped_share = max(_compare(o, r, tol)[1] for o, r in zip(outs, dropped))
            short_share = max(_compare(o, r, tol)[1]
                              for o, r in zip(outs, plain(x, heads, kv_len=seq - 1)))
            emit("short_kernel", kernel=kernel, case=name, shape=[batch, seq, heads, dim],
                 dtype="torch.bfloat16", max_abs_err=err, tolerance=tol,
                 limit_share=share, finite=finite, head_dropped_share=dropped_share,
                 one_key_short_share=short_share)
            check(finite and within, f"{kernel} disagrees with its plain version at {name}")
            check(dropped_share > 1, f"the {kernel} limits pass a head left out at "
                  f"{name}: {dropped_share}")
            check(short_share > 1, f"the {kernel} limits pass a kernel one key short "
                  f"at {name}: {short_share}")
            if name == "probe":
                errors[kernel] = err
        del x, outs, refs, dropped
    return errors


def phase_short_timing() -> dict:
    """Kernels #3-#6 at the JiT-B/16 train shape, #10 and #11 at the probes'
    shape, and #2 again at B 64, S 298; keyed by wrapper name (#2 as
    ``packed_bwd``)."""
    import torch.nn.functional as F

    from vision_pt_tpu_torch.ops import short_attention as sa
    from vision_pt_tpu_torch.tools.bench import attention_pairing_probe as pairing
    from vision_pt_tpu_torch.tools.bench import attention_roofline as roofline
    from vision_pt_tpu_torch.tools.bench.kernel_ab import probe_yardsticks

    batch, s, heads, dim = SHORT_SHAPE
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, do = (_bshd(gen, batch, s, heads, dim, bf16) for _ in range(4))
    size = q.numel() * q.element_size()
    product = 2 * batch * heads * s * s * dim  # one (S, S, D) product
    shape = [batch, s, s, heads, dim]
    rows = {}
    for layout, number in (("bshd", 3), ("bhsd", 5)):
        fwd, fwd_lse, bwd, plain_fwd, plain_bwd, view = _short_entries(layout)
        args = [view(x) for x in (q, k, v)]
        dout = view(do)
        _, lse = fwd_lse(*args)
        # SDPA on the same memory, as (B, H, S, D) views
        bhsd = [x.transpose(1, 2) if layout == "bshd" else x for x in (*args, dout)]
        leaves = [x.detach().requires_grad_() for x in bhsd[:3]]
        rows[fwd.__name__] = _time_kernel(
            fwd.__name__, lambda: fwd(*args), lambda: plain_fwd(*args),
            lambda: F.scaled_dot_product_attention(*bhsd[:3]),
            4 * size, 2 * product, bf16,
            f"vision_pt_tpu/ops/short_attention.py:{543 if number == 3 else 307}",
            "vision_pt_tpu_torch/csrc/short_attention.cu", [layout, *shape],
            "F.scaled_dot_product_attention", phase="short_timing")
        rows[bwd.__name__] = _time_kernel(
            bwd.__name__, lambda: bwd(*args, lse, dout),
            lambda: plain_bwd(*args, lse, dout),
            lambda: torch.autograd.grad(F.scaled_dot_product_attention(*leaves),
                                        leaves, bhsd[3]),
            7 * size, 5 * product, bf16,
            f"vision_pt_tpu/ops/short_attention.py:{561 if number == 3 else 325}",
            "vision_pt_tpu_torch/csrc/short_attention_bwd.cu", [layout, *shape],
            "F.scaled_dot_product_attention forward and its torch.autograd.grad "
            "backward", phase="short_timing")
        del leaves

    # kernel #2 again, for the comparison with the code before its head stride
    packed = [x.view(batch, s, heads * dim) for x in (q, k, v)]
    _, lse = sa.short_attention_packed_with_lse(*packed, heads, bounded=True)
    packed += [lse, do.view(batch, s, heads * dim)]
    leaves = [x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v)]
    sdpa_out = F.scaled_dot_product_attention(*leaves)
    rows["packed_bwd"] = _time_kernel(
        "short_attention_packed_bwd",
        lambda: sa.short_attention_packed_bwd(*packed, heads, bounded=True),
        lambda: sa.short_attention_packed_bwd_reference(*packed, heads, bounded=True),
        lambda: torch.autograd.grad(sdpa_out, leaves, do.transpose(1, 2),
                                    retain_graph=True),
        7 * size, 5 * product, bf16, "vision_pt_tpu/ops/short_attention.py:493",
        "vision_pt_tpu_torch/csrc/short_attention_bwd.cu", ["train", *shape],
        "torch.autograd.grad of F.scaled_dot_product_attention", phase="short_timing")
    del q, k, v, do, packed, leaves, sdpa_out, lse

    batch, s, heads, dim = PROBE_SHAPE
    x = torch.randn(batch, s, heads * dim, generator=gen, device="cuda").to(bf16)
    size = x.numel() * x.element_size()
    product = 2 * batch * heads * s * s * dim
    sdpa_pair, seven_matmuls = probe_yardsticks(x, heads)
    rows["run_variant"] = _time_kernel(
        "run_variant", lambda: pairing.run_variant(x),
        lambda: pairing.run_variant_reference(x), sdpa_pair,
        3 * size, 6 * product, bf16,
        "tools/bench/attention_pairing_probe.py:143",
        "vision_pt_tpu_torch/csrc/attention_probe.cu", ["probe", batch, s, s, heads, dim],
        "F.scaled_dot_product_attention forward and backward, and the two adds",
        phase="short_timing", executed_flops=pairing.PRODUCTS_EXECUTED * product)
    rows["dots_variant"] = _time_kernel(
        "dots_variant", lambda: roofline.dots_variant(x),
        lambda: roofline.dots_variant_reference(x), seven_matmuls,
        2 * size, 6 * product, bf16,  # q k^T is one product, computed twice
        "tools/bench/attention_roofline.py:252",
        "vision_pt_tpu_torch/csrc/attention_probe.cu", ["probe", batch, s, s, heads, dim],
        "the seven products as seven bf16 torch.matmul calls (no one call "
        "computes the function)", phase="short_timing",
        executed_flops=roofline.PRODUCTS_EXECUTED * product)
    return rows


def phase_short_path() -> tuple[int, ...]:
    """The short backend as a user calls it, at JiT-B/16 width:
    ``dot_product_attention(..., backend="short")`` forward and backward,
    then ``short_attention_bhsd`` on the same tensors transposed; each call
    must launch exactly its entry's forward and backward once and no other
    kernel. Returns the launches of both calls."""
    from vision_pt_tpu_torch.ops.attention import dot_product_attention
    from vision_pt_tpu_torch.ops.short_attention import (
        short_attention_bhsd,
        short_attention_bwd_reference,
        short_attention_reference,
    )

    batch, s, heads, dim = SHORT_SHAPE
    gen = torch.Generator(device="cuda").manual_seed(8)
    q, k, v, do = (_bshd(gen, batch, s, heads, dim, torch.bfloat16) for _ in range(4))
    kv_lens = _kv_lens(gen, "range", batch, s)
    leaves = [x.requires_grad_() for x in (q, k, v)]
    counts, seconds = [], []
    for label in ("dot_product_attention", "short_attention_bhsd"):
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        if label == "dot_product_attention":
            out = dot_product_attention(*leaves, kv_lens=kv_lens, backend="short")
            grads = torch.autograd.grad(out, leaves, do)
        else:
            out = short_attention_bhsd(*(x.transpose(1, 2) for x in leaves), kv_lens)
            grads = torch.autograd.grad(out, leaves, do.transpose(1, 2))
            out = out.transpose(1, 2)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        counts.append(_counts())
        if label == "dot_product_attention":
            first = (out, grads)
    refused = {}
    for kwargs in ({"mask": torch.ones(batch, s, dtype=torch.bool, device="cuda")},
                   {"is_causal": True}):
        try:
            dot_product_attention(q, k, v, backend="short", **kwargs)
        except ValueError as e:
            refused[next(iter(kwargs))] = str(e)
    tol = TOL[torch.bfloat16]
    ref, ref_lse = short_attention_reference(*(x.detach() for x in leaves), kv_lens,
                                             return_lse=True)
    ref_grads = short_attention_bwd_reference(*(x.detach() for x in leaves), ref_lse,
                                              do, kv_lens)
    err, share, within = _agree([_compare(o, r, tol) for o, r in
                                 zip((first[0].detach(), *first[1]), (ref, *ref_grads))])
    same = torch.equal(out, first[0]) and all(
        torch.equal(a, b) for a, b in zip(grads, first[1]))
    expected = [_expect({3: 1, 4: 1}), _expect({5: 1, 6: 1})]
    emit("short_path", shape=[batch, s, heads, dim], dtype="torch.bfloat16",
         kv_lens=kv_lens.tolist(), calls=["dot_product_attention(backend='short')",
                                          "short_attention_bhsd"],
         launches=counts, expected=expected, seconds=seconds, refused=refused,
         max_abs_err=err, limit_share=share, bhsd_equals_bshd=same)
    check(counts == expected, f"short path launches {counts}, expected {expected}")
    check(set(refused) == {"mask", "is_causal"} and all(
        "kv_lens only" in m for m in refused.values()),
        f"the short backend must refuse a mask and is_causal: {refused}")
    check(within and same and all(bool(torch.isfinite(x).all())
                                  for x in (out, *grads)),
          f"short path output: limit share {share}, BHSD equals BSHD {same}")
    return tuple(a + b for a, b in zip(*counts))


def phase_attention_probes() -> tuple[int, ...]:
    """Both probe tools' ``main()`` on the card; #10 and #11 must launch as
    often as their timing and comparison call for, and the roofline's
    sections 1-2 run kernels #1 and #2 (12 blocks per real training step,
    none with attention as identity; one each per timed layer). Returns the
    launches of both."""
    from vision_pt_tpu_torch.tools.bench import attention_pairing_probe as pairing
    from vision_pt_tpu_torch.tools.bench import attention_roofline as roofline
    from vision_pt_tpu_torch.tools.bench import launches_of_timing

    _reset_counts()
    t0 = time.perf_counter()
    pair = pairing.main()
    pair_s = time.perf_counter() - t0
    pair_counts = _counts()
    _reset_counts()
    t0 = time.perf_counter()
    roof = roofline.main(steps=ROOFLINE_STEPS)
    roof_s = time.perf_counter() - t0
    roof_counts = _counts()
    packed = 12 * (1 + 3 * ROOFLINE_STEPS) + launches_of_timing(roofline.N_LAYERS)
    expected = [_expect({10: pairing.MAIN_LAUNCHES}),
                _expect({1: packed, 2: packed, 11: roofline.MAIN_LAUNCHES})]
    emit("attention_probes", seconds=[pair_s, roof_s],
         launches=[pair_counts, roof_counts], expected=expected)
    check([pair_counts, roof_counts] == expected,
          f"probe launches {[pair_counts, roof_counts]}, expected {expected}")
    numbers = [pair["per_head_ms_per_layer"], pair["max_abs_diff"],
               *(val for val in roof.values() if isinstance(val, float))]
    check(all(np.isfinite(numbers)) and roof["step_ms"] > roof["step_noattn_ms"] > 0,
          f"probe results {pair} {roof}")
    return tuple(a + b for a, b in zip(pair_counts, roof_counts))


def main(args: list[str]) -> int:
    if args not in ([], ["--kernels-only"]):
        print("usage: chip_smoke.py [--kernels-only]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    started = time.perf_counter()
    smi = phase_device()
    errors = {**phase_kernel(), **phase_flash_kernel(),
              "dequant_matmul_4bit": phase_nf4_kernel(), **phase_short_kernel()}
    rows = phase_timing()
    rows.update(phase_flash_timing())
    nf4_rows = phase_nf4_timing()
    short_rows = phase_short_timing()
    if args:  # no path was driven: no kernels line and no result line
        emit("done", seconds=time.perf_counter() - started)
        return 0
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        label2id = os.path.join(tmp, "label2id.json")
        with open(label2id, "w") as f:
            json.dump({f"c{i}": i for i in range(4)}, f)
        launches["sampler"] = phase_sampler(label2id)
        launches["train_step"] = phase_train_step()
        launches["short_path"] = phase_short_path()
        launches["attention_probes"] = phase_attention_probes()
        launches["trainer"] = phase_trainer(tmp)
        phase_train_parity(label2id)
        phase_parity(label2id)
        launches["latent_trainer"] = phase_latent_trainer(tmp)
        phase_latent_parity(tmp)
    launches.update(phase_sdxl_sampler())
    phase_sdxl_parity()
    kernels = []
    # each kernel's launches are those of its main path: the training step
    # for the packed kernels, the short backend's path for #3-#6, the latent
    # trainer for the flash kernels (the SDXL requests beside them), the NF4
    # SDXL request for kernel #9, the probe tools for #10 and #11
    for number, (row, kernel, path) in enumerate((
            (rows["train"], "short_attention_packed", "train_step"),
            (rows["train_bwd"], "short_attention_packed_bwd", "train_step"),
            (short_rows["short_attention"], "short_attention", "short_path"),
            (short_rows["short_attention_bwd"], "short_attention_bwd", "short_path"),
            (short_rows["short_attention_bhsd"], "short_attention_bhsd", "short_path"),
            (short_rows["short_attention_bhsd_bwd"], "short_attention_bhsd_bwd",
             "short_path"),
            (rows["latent"], "flash_attention", "latent_trainer"),
            (rows["latent_bwd"], "flash_attention_bwd", "latent_trainer"),
            (nf4_rows["path"], "dequant_matmul_4bit", "sdxl_nf4"),
            (short_rows["run_variant"], "run_variant", "attention_probes"),
            (short_rows["dots_variant"], "dots_variant", "attention_probes")),
            start=1):
        kernels.append({"number": number, **row,
                        "launches": launches[path][number - 1],
                        "launches_by_path": {k: v[number - 1] for k, v in launches.items()},
                        "max_abs_err": errors[kernel]})
        check(launches[path][number - 1] > 0, f"{kernel} never launched on {path}")
    kernels[0]["with_lse"] = rows["train_lse"]  # as the training step runs it
    kernels[1]["retimed_ms"] = short_rows["packed_bwd"]["ms"]  # short_timing
    kernels[6]["sdxl_timing"] = [{**rows[label], "max_abs_err": errors[label]}
                                 for label in ("sdxl_s4096", "sdxl_s1024")]
    kernels[8]["other_shapes"] = [nf4_rows["path_n640"], nf4_rows["bench"]]
    emit("done", seconds=time.perf_counter() - started)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
