"""8-bit Adam moments (port of ``vision_pt_tpu/training/optim8bit.py``, the
counterpart of ``bitsandbytes.optim.AdamW8bit``).

m and v live as int8 in blocks of 256 with an fp32 absmax per block; each
update dequantizes, applies the Adam step in fp32 and quantizes again. v is
stored in sqrt space, which keeps small values. The quantization is linear
(not bitsandbytes' dynamic map), as in the JAX package, which computes this
as plain XLA outside any Pallas kernel; here it is plain PyTorch.
"""

from __future__ import annotations

import torch

from .optimizer import StateKeepsDtype

BLOCK = 256


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 -> (int8 (blocks, 256), fp32 absmax / 127 per block)."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(blocks / safe[:, None]), -127, 127).to(torch.int8)
    return q, scale.float()


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded fp32 square root (through fp64): torch's CPU
    ``sqrt`` is an ulp off at times, and an ulp can move an int8 code."""
    return torch.sqrt(x.double()).float()


def _dequantize(q: torch.Tensor, scale: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    x = q.float() * scale[:, None]
    return x.reshape(-1)[: like.numel()].reshape(like.shape)


class Adam8bit(StateKeepsDtype, torch.optim.Optimizer):
    """Adam with int8 blockwise moments (``optim8bit.adam8bit``); with
    ``weight_decay`` the decoupled AdamW form (``adamw8bit``: the decay is
    added to the Adam step before the rate). Parameters take
    (p + update) rounded to their dtype, as ``optax.apply_updates``."""

    def __init__(self, params, lr: float = 1e-3,
                 betas: tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))

    def _state(self, p: torch.Tensor) -> dict:
        state = self.state[p]
        if not state:
            zeros = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            m_q, m_scale = _quantize(zeros)
            v_q, v_scale = _quantize(zeros)
            state.update(count=0, m_q=m_q, m_scale=m_scale, v_q=v_q, v_scale=v_scale)
        return state

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self._state(p)
                state["count"] += 1
                count = torch.tensor(float(state["count"]), device=p.device)
                g = p.grad.float()
                m = _dequantize(state["m_q"], state["m_scale"], g)
                v = torch.square(_dequantize(state["v_q"], state["v_scale"], g))
                m = b1 * m + (1 - b1) * g
                v = b2 * v + (1 - b2) * torch.square(g)
                m_hat = m / (1 - b1**count)
                v_hat = v / (1 - b2**count)
                update = m_hat / (_sqrt(v_hat) + group["eps"])
                state["m_q"], state["m_scale"] = _quantize(m)
                state["v_q"], state["v_scale"] = _quantize(_sqrt(v))
                if group["weight_decay"]:
                    update = update + group["weight_decay"] * p
                update = update * -group["lr"]
                p.copy_(p + update)


class AdamW8bit(Adam8bit):
    """``optim8bit.adamw8bit``: weight decay 1e-2 by default, as
    bitsandbytes."""

    def __init__(self, params, lr: float = 1e-3,
                 betas: tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-2):
        super().__init__(params, lr, betas, eps, weight_decay)
