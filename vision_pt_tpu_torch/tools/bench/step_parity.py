"""One training step's loss and gradients, on the card and on the CPU, for
the two models whose attention takes the port's kernels in training:
JiT-B/16 class-to-image at 256^2 (the packed kernels #1/#2, S 298) and the
latent model of ``configs/jit/latent_arb_1024.yml`` at depth 6 on a 64 x 64
latent (flash #7/#8, S 1098), batch 2, inputs from numpy seeds.
``chip_smoke.py``'s ``train_parity`` and ``latent_parity`` phases take their
steps from :func:`step`.

    python -m vision_pt_tpu_torch.tools.bench.step_parity

runs the fp16 witnesses on the card and prints one JSON line per model
(about 17 minutes on an H100's host, almost all of it the CPU's fp16 steps:
150-320 s each there, whose CPU has no fast fp16 matrix path). For each model: an fp32
step on the card (the reference: fp32 card and CPU steps agree within 1e-5);
fp16 steps through the kernels, through the kernels' plain versions on the
card, and on the CPU, each with the loss unscaled and scaled by
:data:`LOSS_SCALE` (the gradients divided back); a bf16 step through the
kernels, a control at bf16 precision. Each step's gradients are held, by
the largest and the median relative L2 error over the parameters, against
the fp32 reference and against the CPU step of the same scale; and the
share of the nonzero ds = p (dp - delta) of the CPU steps' attention
backwards that fp16 holds only as a subnormal (below 2^-14) or rounds to 0
(below 2^-25).
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
LATENT_CONFIG = os.path.join(ROOT, "configs", "jit", "latent_arb_1024.yml")
# fp16 training scales the loss before its backward (torch.amp's GradScaler
# does): unscaled, the attention backward's ds lies below fp16's range
LOSS_SCALE = 4096.0
F16_SUBNORMAL, F16_FLUSH = 2.0**-14, 2.0**-25
MODELS = ("jit", "latent")


class Step(NamedTuple):
    loss: float
    grads: dict  # parameter name -> fp32 CPU gradient (unscaled)
    seconds: float  # the loss and its backward


def write_label2id(path: str) -> str:
    with open(path, "w") as f:
        json.dump({f"c{i}": i for i in range(4)}, f)
    return path


def _jit(label2id, dtype, device, depth=None, batch=2):
    """(workload, batch, draws, gate module) of a JiT-B/16 step at 256^2,
    at ``depth`` blocks (default 12), the first ``batch`` of 2 samples."""
    import vision_pt_tpu_torch.models.jit.denoiser as gate
    from vision_pt_tpu_torch.config import TrainConfig
    from vision_pt_tpu_torch.models.jit import JiT_B_16_Config
    from vision_pt_tpu_torch.workloads.jit_class_to_image import (
        JiTForClassToImageTraining,
    )

    rng = np.random.default_rng(0)
    images = rng.uniform(-1, 1, size=(2, 256, 256, 3)).astype(np.float32)
    t_draw = rng.normal(size=(2,)).astype(np.float32)
    noise = rng.normal(size=images.shape).astype(np.float32)
    images, t_draw, noise = images[:batch], t_draw[:batch], noise[:batch]
    denoiser = JiT_B_16_Config().model_dump()
    denoiser["depth"] = depth or denoiser["depth"]
    config = TrainConfig.model_validate({
        "model": {"context_encoder": {"type": "class", "label2id_map_path": label2id},
                  "denoiser": denoiser, "dtype": dtype,
                  "drop_context_rate": 0.0},
        "dataset": {}, "seed": 0,
    })
    workload = JiTForClassToImageTraining(config, torch.device(device))
    workload.setup_model()
    arrays = workload.prepare_batch({"image": images, "caption": ["c1", "c2 c3"][:batch]})
    return workload, arrays, t_draw, noise, gate


def _latent(label2id, dtype, device, depth=None, batch=2):
    """(workload, batch, draws, gate module) of a latent step: the shipped
    config at ``depth`` blocks (default 6), a 64 x 64 x 4 latent (S = 1024 +
    74 context), the first ``batch`` of 2 samples."""
    import yaml

    import vision_pt_tpu_torch.ops.attention as gate
    from vision_pt_tpu_torch.config import TrainConfig
    from vision_pt_tpu_torch.workloads.jit_variants import (
        JiTForArbClassToImageTraining,
    )

    with open(LATENT_CONFIG) as f:
        model = yaml.safe_load(f)["model"]
    model["context_encoder"]["label2id_map_path"] = label2id
    model["denoiser"]["depth"] = depth or 6
    model["drop_context_rate"] = 0.0
    rng = np.random.default_rng(1)
    arrays = {"latents": rng.normal(size=(2, 64, 64, 4)).astype(np.float32),
              "caption": ["c1", "c0 c2 c3"],
              **{k: np.full((2, 2), v, np.int32) for k, v in
                 (("original_size", 512), ("target_size", 512),
                  ("crop_coords_top_left", 0))}}
    arrays = {k: v[:batch] for k, v in arrays.items()}
    t_draw = rng.normal(size=(2,)).astype(np.float32)[:batch]
    noise = rng.normal(size=(2, 64, 64, 4)).astype(np.float32)[:batch]
    config = TrainConfig.model_validate({"model": {**model, "dtype": dtype},
                                         "dataset": {}, "seed": 0})
    workload = JiTForArbClassToImageTraining(config, torch.device(device))
    workload.setup_model()
    return workload, workload.prepare_batch(arrays), t_draw, noise, gate


@contextlib.contextmanager
def _plain_on_card():
    """The attention kernels' plain versions on CUDA tensors as well."""
    import vision_pt_tpu_torch.ops.flash_attention as fa
    import vision_pt_tpu_torch.ops.short_attention as sa

    saved = sa._wants_kernel, fa._forward, fa.flash_attention_bwd
    sa._wants_kernel = lambda q: False
    fa._forward = lambda q, k, v, kv_lens, scale, causal: fa.flash_attention_reference(
        q, k, v, kv_lens, scale=scale, causal=causal)
    fa.flash_attention_bwd = fa.flash_attention_bwd_reference
    try:
        yield
    finally:
        sa._wants_kernel, fa._forward, fa.flash_attention_bwd = saved


def step(model: str, dtype: str, device: str, label2id: str, *,
         loss_scale: float = 1.0, plain: bool = False,
         depth: int | None = None, batch: int = 2) -> Step:
    """One step of ``model`` ("jit" or "latent"; ``depth`` blocks, or 12
    and 6; the first ``batch`` of 2 samples) in ``dtype`` on ``device``, the
    attention gate open on the CPU too (so the CPU runs the kernels' plain
    versions); ``plain`` also runs the plain versions on the card. The
    backward takes ``loss * loss_scale``; gradients are divided back."""
    from vision_pt_tpu_torch.ops.attention import attention_dtype

    workload, arrays, t_draw, noise, gate = (_jit if model == "jit" else _latent)(
        label2id, dtype, device, depth, batch)
    trainable = workload.trainable()
    draws = {"timesteps": torch.sigmoid(torch.from_numpy(t_draw) * 0.8 - 0.8),
             "noise": torch.from_numpy(noise)}
    draws = {k: v.to(device) for k, v in draws.items()}
    opened = gate._on_cuda
    gate._on_cuda = lambda x: True
    t0 = time.perf_counter()
    try:
        with (_plain_on_card() if plain else contextlib.nullcontext()), \
                attention_dtype(None if dtype == "float32" else getattr(torch, dtype)):
            loss, _ = workload.compute_loss(trainable, arrays, draws)
            (loss * loss_scale).backward()
    finally:
        gate._on_cuda = opened
    seconds = time.perf_counter() - t0
    grads = {n: p.grad.detach().float().cpu() / loss_scale
             for n, p in trainable.named_parameters()}
    return Step(float(loss.detach()), grads, seconds)


def grad_errors(grads: dict, reference: dict) -> dict:
    """Relative L2 error of each parameter's gradient against ``reference``."""
    return {n: float(torch.linalg.vector_norm(grads[n] - g)
                     / torch.linalg.vector_norm(g).clamp_min(1e-30))
            for n, g in reference.items()}


def summary(errors: dict, worst: int = 5) -> dict:
    ranked = sorted(errors.items(), key=lambda kv: -kv[1])
    return {"max": ranked[0][1], "median": float(np.median(list(errors.values()))),
            "worst": ranked[:worst]}


@contextlib.contextmanager
def _record_ds(shares: list):
    """Appends, for every attention backward run through a plain version,
    the (subnormal, flushed) shares of its nonzero fp32 ds in fp16."""
    import vision_pt_tpu_torch.ops.flash_attention as fa
    import vision_pt_tpu_torch.ops.short_attention as sa

    def record(ds):
        mag = ds.abs()[ds != 0]
        shares.append(((mag < F16_SUBNORMAL).float().mean().item(),
                       (mag < F16_FLUSH).float().mean().item()))

    def flash_bwd(q, k, v, out, lse, do, kv_lens=None, *, scale=None, causal=False):
        scale = q.shape[-1] ** -0.5 if scale is None else scale
        f32 = torch.float32
        do_ = do.to(q.dtype).to(f32)
        delta = torch.einsum("bqhd,bqhd->bhq", do_, out.to(f32))
        valid = fa._valid(kv_lens, q.shape[0], q.shape[1], k.shape[1], causal, q.device)
        p = torch.where(valid, torch.exp(fa._logits(q, k, scale) - lse[..., None]), 0.0)
        dp = torch.einsum("bqhd,bkhd->bhqk", do_, v.to(f32))
        record(p * (dp - delta[..., None]) * scale)
        return flash_ref(q, k, v, out, lse, do, kv_lens, scale=scale, causal=causal)

    def packed_bwd(q, k, v, lse, do, num_heads, kv_lens=None, scale=None,
                   bounded=False):
        f32 = torch.float32
        qh, kh, vh, doh = (sa._split_heads(x.to(q.dtype), num_heads).to(f32)
                           for x in (q, k, v, do))
        scale = qh.shape[-1] ** -0.5 if scale is None else scale
        x = (qh @ kh.transpose(-1, -2)) * (scale * sa.LOG2E)
        if bounded:
            lim = sa.BOUNDED_LOGIT_CLIP * sa.LOG2E
            x = x.clamp(-lim, lim)
        valid = sa._key_valid(kv_lens, q.shape[0], k.shape[1], q.device)
        p = torch.where(valid, torch.exp2(x - lse[..., None] * sa.LOG2E), 0.0)
        dp = doh @ vh.transpose(-1, -2)
        record(p * (dp - (p * dp).sum(dim=-1, keepdim=True)))
        return packed_ref(q, k, v, lse, do, num_heads, kv_lens, scale, bounded)

    flash_ref, packed_ref = fa.flash_attention_bwd_reference, sa.short_attention_packed_bwd_reference
    fa.flash_attention_bwd_reference = flash_bwd
    sa.short_attention_packed_bwd_reference = packed_bwd
    try:
        yield
    finally:
        fa.flash_attention_bwd_reference = flash_ref
        sa.short_attention_packed_bwd_reference = packed_ref


def witness(model: str, label2id: str) -> dict:
    """The fp16 witnesses of ``model`` (the module docstring)."""
    ref = step(model, "float32", "cuda", label2id)
    rows = {}
    for scale in (1.0, LOSS_SCALE):
        shares: list = []
        with _record_ds(shares):
            cpu = step(model, "float16", "cpu", label2id, loss_scale=scale)
        rows[f"cpu@{scale:g}"] = {
            "vs_fp32": summary(grad_errors(cpu.grads, ref.grads)),
            "ds_subnormal_share": [s for s, _ in shares],
            "ds_flushed_share": [f for _, f in shares], "seconds": cpu.seconds}
        for label, plain in (("kernels", False), ("plain_on_card", True)):
            card = step(model, "float16", "cuda", label2id, loss_scale=scale,
                        plain=plain)
            rows[f"{label}@{scale:g}"] = {
                "vs_fp32": summary(grad_errors(card.grads, ref.grads)),
                "vs_cpu": summary(grad_errors(card.grads, cpu.grads)),
                "loss_rel_err_vs_cpu": abs(card.loss - cpu.loss) / abs(cpu.loss)}
        del cpu
    bf16 = step(model, "bfloat16", "cuda", label2id)
    rows["bf16_kernels"] = {"vs_fp32": summary(grad_errors(bf16.grads, ref.grads))}
    return {"model": model, "loss_scale": LOSS_SCALE, "rows": rows}


def main() -> list[dict]:
    from . import card

    info = card()
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        label2id = write_label2id(os.path.join(tmp, "label2id.json"))
        for model in MODELS:
            result = {**witness(model, label2id), **info}
            print(json.dumps(result), flush=True)
            out.append(result)
    return out


if __name__ == "__main__":
    main()
