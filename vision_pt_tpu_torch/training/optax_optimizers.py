"""The optax optimizers the JAX package's optimizer factory builds, as torch
optimizers (the update rules of optax 0.2.6, which ``vision_pt_tpu/training/
optimizer.py`` dispatches to):

- :class:`Prodigy`: ``optax.contrib.prodigy``, one distance estimate d over
  every parameter of every group;
- :class:`Lion`: ``optax.lion`` (b1 0.9, b2 0.99, weight decay 1e-3);
- :class:`Adafactor`: ``optax.adafactor`` (the two largest dims factored when
  both are >= 128, decay 0.8, block-RMS clipping at 1, the parameter-scale
  multiplication, eps 1e-30);
- :class:`RMSprop`: ``optax.rmsprop`` (decay 0.9, eps 1e-8 inside the square
  root, initial scale 0);
- :class:`Adagrad`: ``optax.adagrad`` (the accumulator starts at 0.1, eps
  1e-7 inside the inverse square root).

These are not ``torch.optim.RMSprop`` / ``Adagrad`` / ``Adafactor``, whose
defaults and eps placement differ. Each group's ``lr`` is the rate of the
next update: the Trainer writes its schedule there before every step, which
is where optax reads ``learning_rate(count)``. The state sits in the
parameters' dtype, as optax keeps it (Adafactor's momentum in
``dtype_momentum``).

Under ``trainer.mesh`` a parameter sharded by FSDP (a DTensor) updates its
own shard, its elementwise state sharded alike, and each rule takes its
whole-array quantities over the whole array: Prodigy's two sums over every
parameter (a shard's terms summed over the ranks that split it, a whole
parameter's counted once), so every rank holds the same d; Adafactor runs
on the DTensors themselves, so its factored dims see the whole shape and
its means (the row and column means, made whole on every rank; the block
RMS; the parameter-scale RMS) are the whole array's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.mesh import _local, shard_sum
from ..utils.dtype import str_to_dtype
from .optimizer import StateKeepsDtype


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor made whole on every rank (its shards gathered, its partial
    sums added), else ``t``."""
    from torch.distributed.tensor import DTensor

    return t.full_tensor() if isinstance(t, DTensor) else t


def _replicated_like(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x`` (whole on every rank) as a replicated DTensor on ``t``'s mesh
    when ``t`` is a DTensor, so the two broadcast; else ``x``."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(t, DTensor):
        return x
    mesh = t.device_mesh
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


class _Optax(StateKeepsDtype, torch.optim.Optimizer):
    """Shared walk over the parameters that have a gradient. State the shape
    of a parameter is made like it (a DTensor for a sharded one); the
    elementwise rules write it in place through this rank's shard."""

    def _with_grads(self):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    yield group, p

    @staticmethod
    def _store(state: dict, **values: torch.Tensor) -> None:
        for name, value in values.items():
            _local(state[name]).copy_(value)

    @staticmethod
    def _scaled(lr: float, update: torch.Tensor) -> torch.Tensor:
        """``scale_by_learning_rate``: the rate in the update's dtype."""
        return torch.tensor(lr, dtype=update.dtype, device=update.device) * update

    @staticmethod
    def _apply(p: torch.Tensor, update: torch.Tensor) -> None:
        """``optax.apply_updates``: p + u, in p's dtype."""
        p.copy_((p + update).to(p.dtype))


class Lion(_Optax):
    """sign((1 - b1) g + b1 m) plus decoupled decay, times -lr; then
    m = (1 - b2) g + b2 m."""

    def __init__(self, params, lr: float = 1e-4, betas: tuple[float, float] = (0.9, 0.99),
                 weight_decay: float = 1e-3):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group, p in self._with_grads():
            b1, b2 = group["betas"]
            state = self.state[p]
            if not state:
                state["mu"] = torch.zeros_like(p)
            param, g, mu = _local(p), _local(p.grad), _local(state["mu"])
            update = torch.sign((1.0 - b1) * g + b1 * mu)
            self._store(state, mu=((1 - b2) * g + b2 * mu).to(mu.dtype))
            update = update + group["weight_decay"] * param
            self._apply(param, self._scaled(-group["lr"], update))


class RMSprop(_Optax):
    """``optax.rmsprop``: nu = (1 - decay) g^2 + decay nu (centered: minus
    the mean's square), g / sqrt(nu + eps) (``eps_in_sqrt``) or
    g / (sqrt(nu) + eps), times -lr, then the optional momentum trace."""

    def __init__(self, params, lr: float = 1e-3, decay: float = 0.9, eps: float = 1e-8,
                 initial_scale: float = 0.0, eps_in_sqrt: bool = True,
                 centered: bool = False, momentum: float | None = None,
                 nesterov: bool = False, bias_correction: bool = False):
        super().__init__(params, dict(
            lr=lr, decay=decay, eps=eps, initial_scale=initial_scale,
            eps_in_sqrt=eps_in_sqrt, centered=centered, momentum=momentum,
            nesterov=nesterov, bias_correction=bias_correction))

    @torch.no_grad()
    def step(self, closure=None):
        for group, p in self._with_grads():
            decay, eps = group["decay"], group["eps"]
            state = self.state[p]
            if not state:
                state.update(nu=torch.full_like(p, group["initial_scale"]), count=0)
                if group["centered"]:
                    state["mu"] = torch.zeros_like(p)
                if group["momentum"] is not None:
                    state["trace"] = torch.zeros_like(p)
            param, g = _local(p), _local(p.grad)
            nu = (1 - decay) * g**2 + decay * _local(state["nu"])
            self._store(state, nu=nu)
            mu = None
            if group["centered"]:
                mu = (1 - decay) * g + decay * _local(state["mu"])
                self._store(state, mu=mu)
            if group["bias_correction"]:
                state["count"] += 1
                correction = 1 - torch.tensor(decay, dtype=torch.float32) ** state["count"]
                nu = nu / correction.to(nu.dtype)
                if mu is not None:
                    mu = mu / correction.to(mu.dtype)
            if mu is not None:
                nu = nu - mu * mu
            scaling = (torch.rsqrt(nu + eps) if group["eps_in_sqrt"]
                       else 1 / (torch.sqrt(nu) + eps))
            update = self._scaled(-group["lr"], scaling * g)
            if group["momentum"] is not None:
                trace = update + group["momentum"] * _local(state["trace"])
                update = (update + group["momentum"] * trace if group["nesterov"]
                          else trace)
                self._store(state, trace=trace)
            self._apply(param, update)


class Adagrad(_Optax):
    """``optax.adagrad``: s = g^2 + s from ``initial_accumulator_value``,
    g / sqrt(s + eps) where s > 0 (else 0), times -lr."""

    def __init__(self, params, lr: float = 1e-3, initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7):
        super().__init__(params, dict(lr=lr, initial_accumulator_value=initial_accumulator_value,
                                      eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group, p in self._with_grads():
            state = self.state[p]
            if not state:
                state["sum_of_squares"] = torch.full_like(
                    p, group["initial_accumulator_value"])
            param, g = _local(p), _local(p.grad)
            total = g * g + _local(state["sum_of_squares"])
            self._store(state, sum_of_squares=total)
            inverse = torch.where(total > 0, torch.rsqrt(total + group["eps"]),
                                  torch.zeros_like(total))
            self._apply(param, self._scaled(-group["lr"], inverse * g))


def _factored_dims(shape: tuple[int, ...], factored: bool,
                   min_dim_size_to_factor: int) -> tuple[int, int] | None:
    """The two largest axes (second largest, largest) when both are at
    least ``min_dim_size_to_factor``, as optax picks them."""
    if not factored or len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < min_dim_size_to_factor:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


class Adafactor(_Optax):
    """``optax.adafactor``: the factored second-moment scaling
    (``scale_by_factored_rms``), block-RMS clipping, the rate, the
    parameter-scale multiplication, the optional momentum and decay, then
    the sign flip. The factored dims are chosen on the whole shape in the
    port's own layout (linears (out, in), convs OIHW); the update does not
    depend on which of the two is the row."""

    def __init__(self, params, lr: float = 1e-3, min_dim_size_to_factor: int = 128,
                 decay_rate: float = 0.8, decay_offset: int = 0,
                 multiply_by_parameter_scale: bool = True,
                 clipping_threshold: float | None = 1.0, momentum: float | None = None,
                 dtype_momentum: torch.dtype | str = torch.float32,
                 weight_decay_rate: float | None = None, eps: float = 1e-30,
                 factored: bool = True):
        if isinstance(dtype_momentum, str):
            dtype_momentum = str_to_dtype(dtype_momentum)
        super().__init__(params, dict(
            lr=lr, min_dim_size_to_factor=min_dim_size_to_factor, decay_rate=decay_rate,
            decay_offset=decay_offset,
            multiply_by_parameter_scale=multiply_by_parameter_scale,
            clipping_threshold=clipping_threshold, momentum=momentum,
            dtype_momentum=dtype_momentum, weight_decay_rate=weight_decay_rate, eps=eps,
            factored=factored))

    @staticmethod
    def _scale_by_factored_rms(group, state, g):
        dtype = g.dtype
        dims = _factored_dims(tuple(g.shape), group["factored"],
                              group["min_dim_size_to_factor"])
        step = torch.tensor(state["count"] - group["decay_offset"] + 1,
                            dtype=torch.float32, device=_local(g).device)
        decay = 1.0 - step ** (-group["decay_rate"])
        grad_sqr = g * g + group["eps"]
        if dims is None:
            v = (decay * state["v"] + (1.0 - decay) * grad_sqr).to(dtype)
            state["v"] = v
            return g * v ** -0.5
        d1, d0 = dims
        # the row and column means, whole on every rank
        v_row = (decay * state["v_row"]
                 + (1.0 - decay) * _whole(grad_sqr.mean(dim=d0))).to(dtype)
        v_col = (decay * state["v_col"]
                 + (1.0 - decay) * _whole(grad_sqr.mean(dim=d1))).to(dtype)
        state["v_row"], state["v_col"] = v_row, v_col
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        row_factor = (v_row / v_row.mean(dim=reduced_d1, keepdim=True)) ** -0.5
        col_factor = v_col ** -0.5
        return (g * _replicated_like(g, row_factor.unsqueeze(d0))
                * _replicated_like(g, col_factor.unsqueeze(d1)))

    @torch.no_grad()
    def step(self, closure=None):
        for group, p in self._with_grads():
            state = self.state[p]
            if not state:
                state["count"] = 0
                dims = _factored_dims(tuple(p.shape), group["factored"],
                                      group["min_dim_size_to_factor"])
                if dims is None:
                    state["v"] = torch.zeros_like(p)
                else:
                    d1, d0 = dims
                    state["v_row"] = _whole(torch.zeros_like(p).sum(dim=d0))
                    state["v_col"] = _whole(torch.zeros_like(p).sum(dim=d1))
                if group["momentum"] is not None:
                    state["ema"] = torch.zeros_like(p, dtype=group["dtype_momentum"])
            update = self._scale_by_factored_rms(group, state, p.grad)
            state["count"] += 1
            if group["clipping_threshold"] is not None:
                rms = torch.sqrt(_whole(torch.mean(update * update)))
                update = update / torch.clamp_min(rms / group["clipping_threshold"], 1.0)
            update = self._scaled(group["lr"], update)
            if group["multiply_by_parameter_scale"]:
                rms = torch.sqrt(_whole(torch.mean(p * p)))
                update = update * torch.where(rms <= 1e-3, torch.full_like(rms, 1e-3), rms)
            if group["momentum"] is not None:
                m = group["momentum"]
                update = (1 - m) * update + m * state["ema"]
                state["ema"] = update.to(group["dtype_momentum"])
            if group["weight_decay_rate"] is not None:
                update = update + group["weight_decay_rate"] * p
            self._apply(p, -1 * update)


class Prodigy(_Optax):
    """``optax.contrib.prodigy``: AdamW on the gradients scaled by the
    distance estimate d, which grows from ``estim_lr0`` by the weighted
    sums over every parameter of every group (one d, one count). The rate
    of the first group scales d (optax's ``learning_rate(count)``)."""

    def __init__(self, params, lr: float = 1.0, betas: tuple[float, float] = (0.9, 0.999),
                 beta3: float | None = None, eps: float = 1e-8, estim_lr0: float = 1e-6,
                 estim_lr_coef: float = 1.0, weight_decay: float = 0.0,
                 safeguard_warmup: bool = False):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))
        self.beta3 = betas[1] ** 0.5 if beta3 is None else beta3
        self.estim_lr0, self.estim_lr_coef = estim_lr0, estim_lr_coef
        self.safeguard_warmup = safeguard_warmup

    def _shared(self, p: torch.Tensor) -> dict:
        """count, estim_lr (d) and numerator_weighted, kept under one key of
        ``self.state`` so ``state_dict`` carries them."""
        shared = self.state["prodigy"]
        if not shared:
            zero = torch.zeros((), dtype=torch.float32, device=p.device)
            shared.update(count=0, estim_lr=zero + self.estim_lr0,
                          numerator_weighted=zero.clone())
        return shared

    @torch.no_grad()
    def step(self, closure=None):
        params = [p for _, p in self._with_grads()]
        if not params:
            return
        shared = self._shared(params[0])
        b1, b2 = self.param_groups[0]["betas"]
        lr = self.param_groups[0]["lr"]
        beta3, lr0 = self.beta3, self.estim_lr0
        count = shared["count"] + 1
        f32 = dict(dtype=torch.float32, device=params[0].device)
        bc = ((1 - torch.tensor(b2, **f32) ** count) ** 0.5
              / (1 - torch.tensor(b1, **f32) ** count))
        estim_lr = shared["estim_lr"]
        dlr = estim_lr * lr * bc
        numerators, denominators = [], []
        for group, p in self._with_grads():
            state = self.state[p]
            if not state:
                state.update(exp_avg=torch.zeros_like(p), exp_avg_sq=torch.zeros_like(p),
                             grad_sum=torch.zeros_like(p), params0=p.detach().clone())
            param, g = _local(p), _local(p.grad)
            dg = estim_lr * g
            numerators.append(torch.sum(g * (_local(state["params0"]) - param)))
            scale = estim_lr if self.safeguard_warmup else dlr
            grad_sum = beta3 * _local(state["grad_sum"]) + scale * dg / lr0
            self._store(state, exp_avg=b1 * _local(state["exp_avg"]) + (1 - b1) * dg,
                        exp_avg_sq=b2 * _local(state["exp_avg_sq"]) + (1 - b2) * dg * dg,
                        grad_sum=grad_sum)
            denominators.append(torch.sum(torch.abs(grad_sum)))
        # over every parameter's every element: the same d on every rank
        numerator_acum = shard_sum(numerators, params)
        denominator = shard_sum(denominators, params)
        numerator_weighted = (beta3 * shared["numerator_weighted"]
                              + (estim_lr / lr0) * dlr * numerator_acum)
        lr_estimate = self.estim_lr_coef * numerator_weighted / denominator
        estim_lr = torch.maximum(estim_lr, lr_estimate)
        for group, p in self._with_grads():
            state, param = self.state[p], _local(p)
            update = (-group["weight_decay"] * dlr * param
                      - dlr * _local(state["exp_avg"])
                      / (torch.sqrt(_local(state["exp_avg_sq"])) + estim_lr * group["eps"]))
            self._apply(param, update)
        shared.update(count=count, estim_lr=estim_lr,
                      numerator_weighted=numerator_weighted)
