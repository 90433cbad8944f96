"""Bench helpers (port of the part of ``vision_pt_tpu/benchmarks.py`` that
the attention roofline probe and ``chip_smoke.py`` need): :func:`time_steps`
and :func:`_jit_train_setup`, the headline training step. The bench sections
themselves (``bench_headline`` and the rest) are not ported yet (ROADMAP
Queue 1 item 1, the bench cells).
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple

import torch

CONTEXT_LEN = 32  # unmasked context tokens of the headline step


def time_steps(fn: Callable[[int], object], steps: int = 10,
               windows: int = 3) -> float:
    """Best-of-``windows`` seconds per step of ``fn(i)`` (i counts every
    call), each window of ``steps`` calls closed by
    ``torch.cuda.synchronize()``."""
    best = float("inf")
    counter = 0
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(steps):
            fn(counter)
            counter += 1
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / steps)
    return best


class TrainSetup(NamedTuple):
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    step: Callable[[int], torch.Tensor]  # step(i) -> the detached loss


def _jit_train_setup(config, batch: int, size: int, *, dtype, param_dtype,
                     device="cuda") -> TrainSetup:
    """The JAX package's headline training step: a JiT ``Denoiser`` of
    ``config`` (weights from seed 0), AdamW 1e-4 (optax's defaults), random
    NHWC images and ``CONTEXT_LEN`` unmasked context tokens, the sigmoid
    timestep draw and flow-matching v-loss. ``step(i)`` draws its timesteps
    and noise from a generator seeded ``1000 + i`` and takes one optimizer
    step."""
    from .models.jit.denoiser import Denoiser
    from .ops.loss.flow_match import prepare_scaled_noised_latents
    from .ops.timestep.sampling import scale_shift_sigmoid_randn
    from .training.optimizer import get_optimizer

    model = Denoiser(config, dtype=dtype, param_dtype=param_dtype,
                     generator=torch.Generator().manual_seed(0), device=device)
    optimizer = get_optimizer("adamw", list(model.parameters()), lr=1e-4)
    gen = torch.Generator(device=device).manual_seed(1)
    images = torch.randn(batch, size, size, 3, generator=gen, device=device)
    context = torch.randn(batch, CONTEXT_LEN, config.context_dim, generator=gen,
                          device=device).to(dtype or torch.float32)
    sizes = torch.full((batch, 2), float(size), device=device)
    crop = torch.zeros(batch, 2, device=device)

    def step(i: int) -> torch.Tensor:
        g = torch.Generator(device=device).manual_seed(1000 + i)
        t = scale_shift_sigmoid_randn(g, batch, device=device)
        noisy, _ = prepare_scaled_noised_latents(g, images, t)
        pred = model(noisy.to(dtype or images.dtype), t, context, sizes, sizes, crop)
        denom = torch.clamp_min(1.0 - t.reshape(-1, 1, 1, 1), 0.05)
        target_v = (images - noisy) / denom
        pred_v = (pred.float() - noisy) / denom
        loss = torch.mean(torch.square(pred_v - target_v))
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return TrainSetup(model, optimizer, step)
