#!/usr/bin/env python3
"""Drive the PyTorch port's JiT-B/16 class-to-image sampler on one CUDA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure raises and the script exits non-zero
without a result line:

1. device: the card, its power limit, and the build of every CUDA kernel of
   the path from the sources in ``vision_pt_tpu_torch/csrc``;
2. kernel: each kernel against its plain PyTorch version, on the card, at the
   path's shape and at edge shapes (tolerance 2e-2 abs/rel for bf16, 1e-4
   for fp32; a kv_len 0 row must be exactly 0);
3. timing: each kernel's ms per launch (CUDA events), its bound on an H100
   SXM from the bytes and operations of these inputs, the plain version's ms,
   and one PyTorch library call that computes the same function;
4. sampler: ``JiTModel.new_with_config`` at the full width of JiT-B/16, 256^2,
   bf16 compute, answering 3 requests of ``generate`` (batch 8, CFG, 20
   Euler steps); every kernel counter is set to 0 just before and read just
   after; the packed attention kernel must launch 80 times per request;
5. profile: where the device time of one request goes (torch.profiler);
6. parity: the same weights and injected noise through the sampler on the
   card (kernel) and on the CPU (plain versions), batch 1, CFG, 2 steps;
   PSNR at least 50 dB in fp32 (under ``attention_dtype(None)``) and 30 dB
   in bf16.

Then the ``{"kernels": [...]}`` line, the card's name and power limit as
nvidia-smi prints them, and the result line.
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
    _build.build(["short_attention"])
    seconds = time.perf_counter() - t0
    ptxas = [line.strip() for log, _ in _build.build_logs.values()
             for line in log.splitlines() if "registers" in line or "spill" in line]
    emit("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         build_seconds=round(seconds, 3), ptxas=ptxas)
    return smi


def _attention_inputs(gen, batch, sq, sk, heads, dim, dtype):
    return [torch.randn(batch, s, heads * dim, generator=gen, device="cuda").to(dtype)
            for s in (sq, sk, sk)]


def phase_kernel() -> float:
    from vision_pt_tpu_torch.ops.short_attention import (
        short_attention_packed,
        short_attention_packed_reference,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [
        # (name, batch, sq, sk, heads, dim, dtype, bounded, kv_lens)
        ("path", 16, 266, 266, 12, 64, bf16, True, None),
        ("s37", 2, 37, 37, 2, 64, bf16, True, [37, 21]),
        ("s37_unbounded", 2, 37, 37, 2, 64, bf16, False, [37, 21]),
        ("s330_kv", 16, 330, 330, 12, 64, bf16, True, "range"),
        ("s330_kv_unbounded", 16, 330, 330, 12, 64, bf16, False, "range"),
        ("sq266_sk330", 16, 266, 330, 12, 64, bf16, True, "range"),
        ("d128", 4, 266, 266, 6, 128, bf16, False, "range"),
        ("path_fp32", 16, 266, 266, 12, 64, f32, True, None),
        ("d128_fp32", 4, 266, 330, 6, 128, f32, False, "range"),
    ]
    path_err = None
    for name, batch, sq, sk, heads, dim, dtype, bounded, lens in cases:
        q, k, v = _attention_inputs(gen, batch, sq, sk, heads, dim, dtype)
        kv_lens = None
        if lens == "range":  # kv_lens in [266, Sk], one row at 0
            kv_lens = torch.randint(min(266, sk), sk + 1, (batch,),
                                    generator=gen, device="cuda")
            kv_lens[1] = 0
        elif lens is not None:
            kv_lens = torch.tensor(lens, device="cuda")
        out = short_attention_packed(q, k, v, heads, kv_lens, bounded=bounded)
        torch.cuda.synchronize()
        ref = short_attention_packed_reference(q, k, v, heads, kv_lens,
                                               bounded=bounded)
        diff = (out.float() - ref.float()).abs()
        err = float(diff.max())
        tol = TOL[dtype]
        within = bool((diff <= tol + tol * ref.float().abs()).all())
        finite = bool(torch.isfinite(out).all())
        zero_row = None
        if kv_lens is not None and int(kv_lens[1]) == 0:
            zero_row = bool((out[1] == 0).all())
        emit("kernel", kernel="short_attention_packed", case=name,
             shape=[batch, sq, sk, heads, dim], dtype=str(dtype), bounded=bounded,
             max_abs_err=err, tolerance=tol, finite=finite, zero_row=zero_row)
        check(finite and within and zero_row is not False,
              f"short_attention_packed disagrees with its plain version at {name}")
        if name == "path":
            path_err = err
    return path_err


def phase_timing() -> dict:
    import torch.nn.functional as F

    from vision_pt_tpu_torch.ops.short_attention import (
        short_attention_packed,
        short_attention_packed_reference,
    )

    batch, s, heads, dim, dtype = 16, 266, 12, 64, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = _attention_inputs(gen, batch, s, s, heads, dim, dtype)
    ms = cuda_ms(lambda: short_attention_packed(q, k, v, heads, bounded=True), 200)
    plain_ms = cuda_ms(
        lambda: short_attention_packed_reference(q, k, v, heads, bounded=True), 20)
    qh, kh, vh = (x.view(batch, s, heads, dim).transpose(1, 2) for x in (q, k, v))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(qh, kh, vh), 200)
    nbytes = 4 * q.numel() * q.element_size()  # q, k, v read, o written
    flops = 4 * batch * heads * s * s * dim  # QK^T and PV, no kv_lens
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / PEAK_FLOPS[dtype] * 1e3
    row = dict(
        name="short_attention_packed", route="cuda",
        source="vision_pt_tpu_torch/csrc/short_attention.cu",
        replaces="vision_pt_tpu/ops/short_attention.py:364",
        ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        library_ms=library_ms,
    )
    emit("timing", shape=[batch, s, s, heads, dim], dtype=str(dtype),
         bytes=nbytes, flops=flops, library="F.scaled_dot_product_attention",
         **row)
    return row


def _jit_b16_config(label2id: str, dtype: str):
    from vision_pt_tpu_torch.models.jit import JiT_B_16_Config, JiTConfig

    return JiTConfig(
        context_encoder={"type": "class", "label2id_map_path": label2id},
        denoiser=JiT_B_16_Config(), dtype=dtype,
    )


def phase_sampler(label2id: str) -> int:
    from vision_pt_tpu_torch.models.jit import JiTModel
    from vision_pt_tpu_torch.ops.short_attention import short_attention_packed

    t0 = time.perf_counter()
    model = JiTModel.new_with_config(_jit_b16_config(label2id, "bfloat16"), seed=0)
    build_s = time.perf_counter() - t0

    def request(seed):
        return model.generate(prompt=["c1"] * BATCH, width=256, height=256,
                              num_inference_steps=STEPS, cfg_scale=2.0,
                              seed=seed, return_arrays=True)

    request(100)  # warm-up: allocator, cuBLAS handles, rotary tables
    torch.cuda.synchronize()
    short_attention_packed.launches = 0
    seconds, per_request = [], []
    for i in range(REQUESTS):
        before = short_attention_packed.launches
        t0 = time.perf_counter()
        out = request(i)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        per_request.append(short_attention_packed.launches - before)
        check(tuple(out.shape) == (BATCH, 256, 256, 3), f"shape {tuple(out.shape)}")
        check(bool(torch.isfinite(out).all()), "non-finite image")
    launches = short_attention_packed.launches
    emit("sampler", model="JiT-B/16", resolution=256, batch=BATCH, cfg=True,
         steps=STEPS, build_seconds=round(build_s, 3), request_seconds=seconds,
         steps_per_second=[STEPS / s for s in seconds],
         kernel_launches_per_request=per_request,
         peak_memory_bytes=torch.cuda.max_memory_allocated())
    check(per_request == [LAUNCHES_PER_REQUEST] * REQUESTS,
          f"packed kernel launches per request {per_request}, "
          f"expected {LAUNCHES_PER_REQUEST}")
    profile_request(request)
    return launches


def profile_request(request) -> None:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        request(7)
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

    emit("profile", wall_seconds=wall, device_kernel_seconds=device_us / 1e6,
         device_busy_share=(device_us / 1e6) / wall,
         packed_kernel=rows([e for e in kernels if "packed_fwd" in e.key],
                            "device_time_total", 2),
         top_ops=rows(ops, "self_device_time_total", 12),
         top_kernels=rows(kernels, "device_time_total", 6))


def phase_parity(label2id: str) -> None:
    from vision_pt_tpu_torch.models.jit import JiTModel
    from vision_pt_tpu_torch.ops.attention import attention_dtype
    from vision_pt_tpu_torch.ops.short_attention import short_attention_packed

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(os.cpu_count() or 1)
    init = np.random.default_rng(0).normal(size=(1, 256, 256, 3)).astype(np.float32)
    for dtype in ("float32", "bfloat16"):
        config = _jit_b16_config(label2id, dtype)
        results = {}
        for device in ("cuda", "cpu"):
            model = JiTModel.new_with_config(config, seed=0, device=device)
            short_attention_packed.launches = 0
            with attention_dtype(None if dtype == "float32" else torch.bfloat16):
                out = model.generate(
                    prompt=["c1"], width=256, height=256, num_inference_steps=2,
                    cfg_scale=2.0, execution_dtype=getattr(torch, dtype),
                    initial_noise=init, return_arrays=True,
                )
            results[device] = (out.float().cpu().numpy(),
                               short_attention_packed.launches)
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
    smi = phase_device()
    path_err = phase_kernel()
    row = phase_timing()
    with tempfile.TemporaryDirectory() as tmp:
        label2id = os.path.join(tmp, "label2id.json")
        with open(label2id, "w") as f:
            json.dump({f"c{i}": i for i in range(4)}, f)
        launches = phase_sampler(label2id)
        phase_parity(label2id)
    print(json.dumps({"kernels": [{**row, "launches": launches,
                                   "max_abs_err": path_err}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
