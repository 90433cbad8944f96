#!/usr/bin/env python3
"""Drive the PyTorch port's JiT-B/16 class-to-image sampler and training step
on one CUDA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the script exits non-zero
without a result line:

1. device: the card, its power limit, and the build of every CUDA kernel of
   the paths from the sources in ``vision_pt_tpu_torch/csrc`` (one ``nvcc``
   per source, started together), with the ptxas register and spill report;
2. kernel: each kernel against its plain PyTorch version, on the card, at the
   paths' shapes and at edge shapes (tolerance 2e-2 abs/rel for bf16, 1e-4
   for fp32; a kv_len 0 row must be exactly 0, and so must the key-gradient
   rows past kv_len); autograd through ``short_attention_packed`` must give
   exactly the explicit backward;
3. timing: each kernel's ms per launch (CUDA events), its bound on an H100
   SXM from the bytes and operations of these inputs, the plain version's ms,
   and one PyTorch library call that computes the same function, at the
   sampler shape (forward) and the training-step shape (forward, backward);
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
   of the same path), batch 2, in fp32 and in bf16;
8. parity: the same weights and injected noise through the sampler on the
   card (kernel) and on the CPU (plain versions), batch 1, CFG, 2 steps;
   PSNR at least 50 dB in fp32 (under ``attention_dtype(None)``) and 30 dB
   in bf16.

Every kernel launch counter is set to 0 just before a path is driven and read
just after. Then the ``{"kernels": [...]}`` line, the card's name and power
limit as nvidia-smi prints them, and the result line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
STEPS, BATCH, REQUESTS = 20, 8, 3
LAUNCHES_PER_REQUEST = 4 * STEPS  # blocks 0-3 (before context_start_block)
PSNR_FLOOR_DB = {"float32": 50.0, "bfloat16": 30.0}
TRAIN_BATCH, TRAIN_CONTEXT, TIMED_STEPS = 64, 32, 10
# train_parity floors, largest over the parameters of the relative L2 error
# of the gradient, card vs CPU. fp32: both sides compute in fp32 and differ
# only in the order of sums (measured errors ~1e-5 on the CPU against JAX).
# bf16: every activation is rounded to 8 mantissa bits and the card's and
# the CPU's matmuls round at other places, so a few percent is expected; a
# wrong kernel gives errors of order 1.
TRAIN_PARITY_FLOOR = {"float32": {"loss": 1e-4, "grad": 1e-3},
                      "bfloat16": {"loss": 2e-2, "grad": 1e-1}}
ROOT = os.path.dirname(os.path.abspath(__file__))


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device ms per call over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
    _build.build(["short_attention", "short_attention_bwd"])
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


def _compare(out, ref, tol):
    diff = (out.float() - ref.float()).abs()
    return float(diff.max()), bool((diff <= tol + tol * ref.float().abs()).all())


def phase_kernel() -> dict:
    """Both kernels against their plain versions; returns the largest error
    of each at the training-step shape."""
    from vision_pt_tpu_torch.ops.short_attention import (
        short_attention_packed,
        short_attention_packed_bwd,
        short_attention_packed_bwd_reference,
        short_attention_packed_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
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
        ("s266_fp32", 16, 266, 266, 12, 64, f32, True, None),
        ("d128_fp32", 4, 266, 330, 6, 128, f32, False, "range"),
    ]
    errors = {}
    for name, batch, sq, sk, heads, dim, dtype, bounded, lens in cases:
        q, k, v = _attention_inputs(gen, batch, sq, sk, heads, dim, dtype)
        do = torch.randn(batch, sq, heads * dim, generator=gen, device="cuda").to(dtype)
        kv_lens = _kv_lens(gen, lens, batch, sk)
        tol = TOL[dtype]
        out = short_attention_packed(q, k, v, heads, kv_lens, bounded=bounded)
        grads = short_attention_packed_bwd(q, k, v, do, heads, kv_lens,
                                           bounded=bounded)
        torch.cuda.synchronize()
        ref = short_attention_packed_reference(q, k, v, heads, kv_lens,
                                               bounded=bounded)
        ref_grads = short_attention_packed_bwd_reference(q, k, v, do, heads,
                                                         kv_lens, bounded=bounded)
        for kernel, outs, refs in (("short_attention_packed", [out], [ref]),
                                   ("short_attention_packed_bwd", grads, ref_grads)):
            compared = [_compare(o, r, tol) for o, r in zip(outs, refs)]
            err = max(e for e, _ in compared)
            within = all(w for _, w in compared)
            finite = all(bool(torch.isfinite(o).all()) for o in outs)
            zero_row = past_kv_zero = None
            if kv_lens is not None and int(kv_lens[1]) == 0:
                zero_row = all(bool((o[1] == 0).all()) for o in outs)
            if kernel.endswith("bwd") and kv_lens is not None:
                k0 = int(kv_lens[0])
                past_kv_zero = all(bool((g[0, k0:] == 0).all()) for g in grads[1:])
            emit("kernel", kernel=kernel, case=name,
                 shape=[batch, sq, sk, heads, dim], dtype=str(dtype),
                 bounded=bounded, max_abs_err=err, tolerance=tol, finite=finite,
                 zero_row=zero_row, past_kv_zero=past_kv_zero)
            check(finite and within and zero_row is not False
                  and past_kv_zero is not False,
                  f"{kernel} disagrees with its plain version at {name}")
            if name == "train_s298":
                errors[kernel] = err

    # autograd through the Function runs exactly the backward kernel
    q, k, v = (x.requires_grad_() for x in
               _attention_inputs(gen, 4, 266, 266, 12, 64, bf16))
    do = torch.randn(4, 266, 768, generator=gen, device="cuda").to(bf16)
    out = short_attention_packed(q, k, v, 12, bounded=True)
    auto = torch.autograd.grad(out, (q, k, v), do)
    explicit = short_attention_packed_bwd(q.detach(), k.detach(), v.detach(),
                                          do, 12, bounded=True)
    equal = all(torch.equal(a, b) for a, b in zip(auto, explicit))
    emit("kernel", kernel="short_attention_packed_bwd", case="autograd",
         autograd_equals_explicit=equal)
    check(equal, "autograd through short_attention_packed differs from its backward")
    return errors


def _time_kernel(name, fn, plain, library, nbytes, flops, dtype, replaces,
                 source, shape, library_name):
    ms = cuda_ms(fn, 50)
    plain_ms = cuda_ms(plain, 5)
    library_ms = cuda_ms(library, 50)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    row = dict(
        name=name, route="cuda", source=source, replaces=replaces,
        ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=library_ms,
    )
    emit("timing", shape=shape, dtype=str(dtype), bytes=nbytes, flops=flops,
         library=library_name, **row)
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
        do = torch.randn(batch, s, heads * dim, generator=gen, device="cuda").to(dtype)
        leaves = [x.detach().requires_grad_() for x in (qh, kh, vh)]
        sdpa_out = F.scaled_dot_product_attention(*leaves)
        doh = do.view(batch, s, heads, dim).transpose(1, 2)
        rows["train_bwd"] = _time_kernel(
            "short_attention_packed_bwd",
            lambda: short_attention_packed_bwd(q, k, v, do, heads, bounded=True),
            lambda: short_attention_packed_bwd_reference(q, k, v, do, heads,
                                                         bounded=True),
            lambda: torch.autograd.grad(sdpa_out, leaves, doh, retain_graph=True),
            7 * size, 5 * attn_flops, dtype,
            "vision_pt_tpu/ops/short_attention.py:493",
            "vision_pt_tpu_torch/csrc/short_attention_bwd.cu",
            [label, batch, s, s, heads, dim],
            "torch.autograd.grad of F.scaled_dot_product_attention",
        )
    return rows


def _reset_counts():
    from vision_pt_tpu_torch.ops.short_attention import (
        short_attention_packed,
        short_attention_packed_bwd,
    )

    short_attention_packed.launches = 0
    short_attention_packed_bwd.launches = 0


def _counts() -> tuple[int, int]:
    from vision_pt_tpu_torch.ops.short_attention import (
        short_attention_packed,
        short_attention_packed_bwd,
    )

    return short_attention_packed.launches, short_attention_packed_bwd.launches


def _jit_b16_config(label2id: str, dtype: str):
    from vision_pt_tpu_torch.models.jit import JiT_B_16_Config, JiTConfig

    return JiTConfig(
        context_encoder={"type": "class", "label2id_map_path": label2id},
        denoiser=JiT_B_16_Config(), dtype=dtype,
    )


def phase_sampler(label2id: str) -> int:
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
    launches, bwd_launches = _counts()
    emit("sampler", model="JiT-B/16", resolution=256, batch=BATCH, cfg=True,
         steps=STEPS, build_seconds=round(build_s, 3), request_seconds=seconds,
         steps_per_second=[STEPS / s for s in seconds],
         kernel_launches_per_request=per_request, bwd_launches=bwd_launches,
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    check(per_request == [LAUNCHES_PER_REQUEST] * REQUESTS and bwd_launches == 0,
          f"packed kernel launches per request {per_request} (backward "
          f"{bwd_launches}), expected {LAUNCHES_PER_REQUEST} (0)")
    profile("sampler", lambda: request(7))
    return launches


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
         packed_kernels=rows([e for e in kernels if "packed_" in e.key],
                             "device_time_total", 6),
         top_ops=rows(ops, "self_device_time_total", 14),
         top_kernels=rows(kernels, "device_time_total", 8))
    return result


def phase_train_step() -> tuple[int, int]:
    """``bench_headline``'s step (vision_pt_tpu/benchmarks.py:83-135) in the
    port; returns the kernel launches of the timed steps."""
    from vision_pt_tpu_torch.models.jit import Denoiser, JiT_B_16_Config
    from vision_pt_tpu_torch.ops.loss.flow_match import prepare_scaled_noised_latents
    from vision_pt_tpu_torch.ops.timestep.sampling import scale_shift_sigmoid_randn
    from vision_pt_tpu_torch.training.optimizer import get_optimizer

    batch, size, bf16 = TRAIN_BATCH, 256, torch.bfloat16
    config = JiT_B_16_Config()
    model = Denoiser(config, dtype=bf16, param_dtype=torch.float32,
                     generator=torch.Generator().manual_seed(0), device="cuda")
    optimizer = get_optimizer("adamw", list(model.parameters()), lr=1e-4)
    gen = torch.Generator(device="cuda").manual_seed(1)
    images = torch.randn(batch, size, size, 3, generator=gen, device="cuda")
    context = torch.randn(batch, TRAIN_CONTEXT, config.context_dim,
                          generator=gen, device="cuda").to(bf16)
    sizes = torch.full((batch, 2), float(size), device="cuda")
    crop = torch.zeros(batch, 2, device="cuda")

    def step(i):
        g = torch.Generator(device="cuda").manual_seed(1000 + i)
        t = scale_shift_sigmoid_randn(g, batch, device="cuda")
        noisy, _ = prepare_scaled_noised_latents(g, images, t)
        pred = model(noisy.to(bf16), t, context, sizes, sizes, crop)
        denom = torch.clamp_min(1.0 - t.reshape(-1, 1, 1, 1), 0.05)
        target_v = (images - noisy) / denom
        pred_v = (pred.float() - noisy) / denom
        loss = torch.mean(torch.square(pred_v - target_v))
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    step(0)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    losses = [step(i) for i in range(1, TIMED_STEPS + 1)]
    torch.cuda.synchronize()
    seconds = (time.perf_counter() - t0) / TIMED_STEPS
    fwd, bwd = _counts()
    losses = [float(x) for x in losses]
    emit("train_step", model="JiT-B/16", resolution=256, batch=batch,
         context_tokens=TRAIN_CONTEXT, compute="bfloat16", params="float32",
         optimizer="adamw 1e-4", timed_steps=TIMED_STEPS,
         seconds_per_step=seconds, images_per_second=batch / seconds,
         peak_memory_bytes=torch.cuda.max_memory_allocated(), losses=losses,
         fwd_launches_per_step=fwd / TIMED_STEPS,
         bwd_launches_per_step=bwd / TIMED_STEPS)
    check(all(np.isfinite(losses)), f"non-finite loss {losses}")
    check((fwd, bwd) == (12 * TIMED_STEPS, 12 * TIMED_STEPS),
          f"kernel launches {fwd} + {bwd} over {TIMED_STEPS} steps, "
          "expected 12 + 12 per step")
    profile("train_step", lambda: step(TIMED_STEPS + 1))
    del model, optimizer
    torch.cuda.empty_cache()
    return fwd, bwd


def phase_trainer(tmp: str) -> tuple[int, int]:
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
        after = _counts()
        per_step.append((after[0] - before[0], after[1] - before[1]))
        return out

    Trainer.train_step = counting
    _reset_counts()
    t0 = time.perf_counter()
    try:
        trainer = run(path)
    finally:
        Trainer.train_step = inner
    seconds = time.perf_counter() - t0
    fwd, bwd = _counts()
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
         launches_per_step=per_step, run_launches=[fwd, bwd], saved=saved,
         previews=len(previews), reloaded=reloaded,
         qk_logit_bound=[r.get("train/qk_logit_bound") for r in records
                         if "train/loss" in r])
    check(trainer.global_step == 4 and len(losses) == 4
          and all(np.isfinite(losses)), f"trainer losses {losses}")
    check(per_step == [(4, 4)] * 4, f"launches per step {per_step}, expected 4 + 4")
    check(len(saved) == 2 and len(previews) == 1 and reloaded,
          f"saved {saved}, previews {previews}, reloaded {reloaded}")
    del trainer, loaded
    torch.cuda.empty_cache()
    return fwd, bwd


def phase_train_parity(label2id: str) -> None:
    """One training step's loss and gradients on the card and on the CPU."""
    import vision_pt_tpu_torch.models.jit.denoiser as denoiser
    from vision_pt_tpu_torch.config import TrainConfig
    from vision_pt_tpu_torch.models.jit import JiT_B_16_Config
    from vision_pt_tpu_torch.ops.attention import attention_dtype
    from vision_pt_tpu_torch.workloads.jit_class_to_image import (
        JiTForClassToImageTraining,
    )

    rng = np.random.default_rng(0)
    images = rng.uniform(-1, 1, size=(2, 256, 256, 3)).astype(np.float32)
    t_draw = rng.normal(size=(2,)).astype(np.float32)
    noise = rng.normal(size=images.shape).astype(np.float32)
    for dtype in ("float32", "bfloat16"):
        config = TrainConfig.model_validate({
            "model": {"context_encoder": {"type": "class",
                                          "label2id_map_path": label2id},
                      "denoiser": JiT_B_16_Config().model_dump(), "dtype": dtype,
                      "drop_context_rate": 0.0},
            "dataset": {}, "seed": 0,
        })
        results = {}
        for device in ("cuda", "cpu"):
            workload = JiTForClassToImageTraining(config, torch.device(device))
            workload.setup_model()
            trainable = workload.trainable()
            batch = workload.prepare_batch({"image": images, "caption": ["c1", "c2 c3"]})
            draws = {"timesteps": torch.sigmoid(torch.from_numpy(t_draw) * 0.8 - 0.8),
                     "noise": torch.from_numpy(noise)}
            draws = {k: v.to(device) for k, v in draws.items()}
            _reset_counts()
            gate = denoiser._on_cuda
            # the CPU runs the same path, through the plain versions
            denoiser._on_cuda = lambda x: True
            t0 = time.perf_counter()
            try:
                with attention_dtype(None if dtype == "float32" else torch.bfloat16):
                    loss, _ = workload.compute_loss(trainable, batch, draws)
                    loss.backward()
            finally:
                denoiser._on_cuda = gate
            results[device] = (
                float(loss.detach()),
                {n: p.grad.detach().float().cpu() for n, p in trainable.named_parameters()},
                _counts(), time.perf_counter() - t0,
            )
            del workload, trainable
        (loss_c, grads_c, counts_c, sec_c), (loss_h, grads_h, counts_h, sec_h) = (
            results["cuda"], results["cpu"])
        loss_err = abs(loss_c - loss_h) / abs(loss_h)
        grad_err = {n: float(torch.linalg.vector_norm(grads_c[n] - g)
                             / torch.linalg.vector_norm(g).clamp_min(1e-30))
                    for n, g in grads_h.items()}
        worst = sorted(grad_err.items(), key=lambda kv: -kv[1])[:5]
        floor = TRAIN_PARITY_FLOOR[dtype]
        emit("train_parity", dtype=dtype, batch=2, loss_cuda=loss_c, loss_cpu=loss_h,
             loss_rel_err=loss_err, grad_rel_l2_max=worst[0][1],
             grad_rel_l2_median=float(np.median(list(grad_err.values()))),
             worst_params=worst, floor=floor, launches_cuda=counts_c,
             launches_cpu=counts_h, seconds_cuda=sec_c, seconds_cpu=sec_h)
        check(all(bool(torch.isfinite(g).all()) for g in grads_c.values()),
              "non-finite grads")
        check(counts_c == (4, 4) and counts_h == (0, 0),
              f"the card step must launch 4 + 4 kernels ({counts_c}), the CPU "
              f"step none ({counts_h})")
        check(loss_err <= floor["loss"] and worst[0][1] <= floor["grad"],
              f"{dtype} train parity: loss {loss_err:.2e}, grad {worst[0]}")
    torch.cuda.empty_cache()


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    started = time.perf_counter()
    smi = phase_device()
    errors = phase_kernel()
    rows = phase_timing()
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        label2id = os.path.join(tmp, "label2id.json")
        with open(label2id, "w") as f:
            json.dump({f"c{i}": i for i in range(4)}, f)
        launches["sampler"] = (phase_sampler(label2id), 0)
        launches["train_step"] = phase_train_step()
        launches["trainer"] = phase_trainer(tmp)
        phase_train_parity(label2id)
        phase_parity(label2id)
    kernels = []
    for i, (row, kernel) in enumerate(((rows["train"], "short_attention_packed"),
                                       (rows["train_bwd"], "short_attention_packed_bwd"))):
        kernels.append({**row, "launches": launches["train_step"][i],
                        "launches_by_path": {k: v[i] for k, v in launches.items()},
                        "max_abs_err": errors[kernel]})
    emit("done", seconds=time.perf_counter() - started)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
