"""8-bit Adam moments (port of ``vision_pt_tpu/training/optim8bit.py``, the
counterpart of ``bitsandbytes.optim.AdamW8bit``).

m and v live as int8 in blocks of 256 with an fp32 absmax per block; each
update dequantizes, applies the Adam step in fp32 and quantizes again. v is
stored in sqrt space, which keeps small values. The quantization is linear
(not bitsandbytes' dynamic map), as in the JAX package, which computes this
as plain XLA outside any Pallas kernel; here it is plain PyTorch.

The blocks run over the array flattened in the JAX package's layout
(``layouts``: a linear's or LoRA factor's (out, in) weight is flattened as
the (in, out) kernel). A parameter sharded by FSDP (a DTensor) keeps its
shard of the int8 codes and every block's scale: a block may straddle two
ranks, so each rank takes the maxima of its part of every block and the
ranks that split the array take their maximum, and the codes are those of
the whole array. The update is the one-device update, bit for bit.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..parallel.mesh import _local
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


class _Layout:
    """Where a parameter's elements sit in the blocks: ``perm`` orders its
    dims as the JAX package's layout; for a DTensor, ``blocks`` is the
    block of each element of this rank's shard (in its order) and
    ``groups`` the process groups that split the array."""

    def __init__(self, p: torch.Tensor, perm: tuple[int, ...] | None):
        from torch.distributed.tensor import DTensor

        self.perm = tuple(perm) if perm is not None else tuple(range(p.dim()))
        self.inverse = tuple(sorted(range(p.dim()), key=self.perm.__getitem__))
        self.count = -(-p.numel() // BLOCK)
        self.blocks, self.groups = None, []
        if not isinstance(p, DTensor):
            return
        flax_shape = [p.shape[d] for d in self.perm]
        index = torch.arange(p.numel(), device=p.device).view(flax_shape).permute(self.inverse)
        mesh = p.device_mesh
        for axis, placement in enumerate(p.placements):
            if placement.is_shard():
                dim, n = placement.dim, mesh.size(axis)
                assert index.shape[dim] % n == 0, "8-bit moments need even shards"
                size = index.shape[dim] // n
                index = index.narrow(dim, mesh.get_local_rank(axis) * size, size)
                self.groups.append(mesh.get_group(axis))
        self.blocks = index.reshape(-1) // BLOCK

    def zeros(self, p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The codes and scales of a zero moment."""
        if self.blocks is None:
            return _quantize(torch.zeros(p.shape, dtype=torch.float32, device=p.device))
        from torch.distributed.tensor import DTensor

        local = _local(p)
        q = torch.zeros(local.shape, dtype=torch.int8, device=local.device)
        return (DTensor.from_local(q, p.device_mesh, p.placements, run_check=False,
                                   shape=p.shape, stride=p.stride()),
                torch.zeros(self.count, dtype=torch.float32, device=local.device))

    def quantize(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """fp32 ``x`` (this rank's elements) -> (codes, scales)."""
        if self.blocks is None:
            return _quantize(x.permute(self.perm))
        absmax = torch.zeros(self.count, dtype=torch.float32, device=x.device)
        absmax.scatter_reduce_(0, self.blocks, x.abs().reshape(-1), "amax")
        for group in self.groups:
            dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=group)
        scale = absmax / 127.0
        safe = torch.where(scale > 0, scale, torch.ones_like(scale))
        q = torch.clamp(torch.round(x / safe[self.blocks].view(x.shape)), -127, 127)
        return q.to(torch.int8), scale

    def dequantize(self, q: torch.Tensor, scale: torch.Tensor,
                   like: torch.Tensor) -> torch.Tensor:
        """fp32 values of this rank's elements, shaped as ``like``."""
        if self.blocks is None:
            flat = (q.float() * scale[:, None]).reshape(-1)[: like.numel()]
            return flat.view([like.shape[d] for d in self.perm]).permute(self.inverse)
        return _local(q).float() * scale[self.blocks].view(like.shape)


class Adam8bit(StateKeepsDtype, torch.optim.Optimizer):
    """Adam with int8 blockwise moments (``optim8bit.adam8bit``); with
    ``weight_decay`` the decoupled AdamW form (``adamw8bit``: the decay is
    added to the Adam step before the rate). Parameters take
    (p + update) rounded to their dtype, as ``optax.apply_updates``."""

    def __init__(self, params, lr: float = 1e-3,
                 betas: tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, layouts: dict | None = None):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))
        self._perms = layouts or {}
        self._layouts: dict[torch.Tensor, _Layout] = {}

    def _layout(self, p: torch.Tensor) -> _Layout:
        if p not in self._layouts:
            self._layouts[p] = _Layout(p, self._perms.get(p))
        return self._layouts[p]

    def _state(self, p: torch.Tensor) -> dict:
        state = self.state[p]
        if not state:
            layout = self._layout(p)
            m_q, m_scale = layout.zeros(p)
            v_q, v_scale = layout.zeros(p)
            state.update(count=0, m_q=m_q, m_scale=m_scale, v_q=v_q, v_scale=v_scale)
        return state

    @staticmethod
    def _store(state: dict, name: str, q: torch.Tensor, scale: torch.Tensor) -> None:
        from torch.distributed.tensor import DTensor

        if isinstance(state[f"{name}_q"], DTensor):  # a shard's codes, in place
            state[f"{name}_q"].to_local().copy_(q)
        else:
            state[f"{name}_q"] = q
        state[f"{name}_scale"] = scale

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for param in group["params"]:
                if param.grad is None:
                    continue
                state, layout = self._state(param), self._layout(param)
                state["count"] += 1
                p = _local(param)
                count = torch.tensor(float(state["count"]), device=p.device)
                g = _local(param.grad).float()
                m = layout.dequantize(state["m_q"], state["m_scale"], g)
                v = torch.square(layout.dequantize(state["v_q"], state["v_scale"], g))
                m = b1 * m + (1 - b1) * g
                v = b2 * v + (1 - b2) * torch.square(g)
                m_hat = m / (1 - b1**count)
                v_hat = v / (1 - b2**count)
                update = m_hat / (_sqrt(v_hat) + group["eps"])
                self._store(state, "m", *layout.quantize(m))
                self._store(state, "v", *layout.quantize(_sqrt(v)))
                if group["weight_decay"]:
                    update = update + group["weight_decay"] * p
                update = update * -group["lr"]
                p.copy_(p + update)


class AdamW8bit(Adam8bit):
    """``optim8bit.adamw8bit``: weight decay 1e-2 by default, as
    bitsandbytes."""

    def __init__(self, params, lr: float = 1e-3,
                 betas: tuple[float, float] = (0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-2, layouts: dict | None = None):
        super().__init__(params, lr, betas, eps, weight_decay, layouts)
