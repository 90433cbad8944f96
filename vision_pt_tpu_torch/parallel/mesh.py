"""Device mesh and sharding (port of ``vision_pt_tpu/parallel/mesh.py``).

A ``torch.distributed.device_mesh.DeviceMesh`` over the axes
(data, fsdp, tensor, seq), ranks laid out row-major as the JAX package lays
out its devices:
- data: batch rows (DDP): every parameter whole on every rank, gradients
  averaged over data x fsdp;
- fsdp: batch rows too, and the large parameters sharded (FSDP2
  ``fully_shard`` over the (data, fsdp) sub-mesh, replicated over data);
- tensor: megatron-style tensor parallelism by dotted-name rules
  (column / row splits through ``distribute_module`` on the tensor sub-mesh);
- seq: the sequence of self-attention over a ring (``ops.ring_attention``),
  every other activation whole on each seq rank.

The placement is the JAX package's where FSDP2 can express it: a parameter
that the JAX rules leave replicated (under ``min_size_to_shard`` elements,
no divisible axis, or a tensor-parallel target) is kept out of FSDP
(``ignored_params``) and its gradient is averaged by
:func:`reduce_replicated_grads`; a sharded one is split on flax's "first
divisible axis", taken on the flax layout of the parameter (a Linear's
``in_features``: dim 1 of torch's (out, in) weight).
"""

from __future__ import annotations

import contextlib
from typing import Any, Mapping

import numpy as np
import torch
import torch.distributed as dist
from pydantic import BaseModel
from torch import nn

AXES = ("data", "fsdp", "tensor", "seq")


class MeshConfig(BaseModel):
    data: int = 1
    fsdp: int = 1
    tensor: int = 1
    seq: int = 1


def mesh_sizes(config: MeshConfig | dict | None, n: int) -> list[int]:
    """The (data, fsdp, tensor, seq) sizes of a mesh over ``n`` ranks: all on
    data with no config, a -1 inferred, and the JAX package's assertion when
    the sizes do not cover ``n``."""
    if config is None:
        cfg = MeshConfig(data=n)
    elif isinstance(config, dict):
        cfg = MeshConfig.model_validate(config)
    else:
        cfg = config
    sizes = [cfg.data, cfg.fsdp, cfg.tensor, cfg.seq]
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = n // known
    assert int(np.prod(sizes)) == n, f"mesh {sizes} does not cover {n} devices"
    return sizes


def _ensure_group() -> None:
    """A single process with no group makes a one-rank one: NCCL on a CUDA
    host, gloo otherwise. A process of a multi-process launch (WORLD_SIZE
    over 1) with no group raises: each would train alone on the whole batch."""
    import os

    if dist.is_initialized():
        return
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise RuntimeError(
            f"a mesh in one of {os.environ['WORLD_SIZE']} processes (WORLD_SIZE) with no "
            "process group: set trainer.distributed_init to join them")
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def make_mesh(config: MeshConfig | dict | None = None,
              devices: list[int] | None = None):
    """A (data, fsdp, tensor, seq) ``DeviceMesh`` over ``devices`` (ranks of
    the default group; all of them by default), row-major like
    ``np.asarray(devices).reshape(sizes)``. With config=None every rank goes
    on the data axis; a size of -1 is inferred."""
    from torch.distributed.device_mesh import DeviceMesh

    _ensure_group()
    ranks = list(range(dist.get_world_size())) if devices is None else list(devices)
    sizes = mesh_sizes(config, len(ranks))
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, np.asarray(ranks).reshape(sizes).tolist(),
                      mesh_dim_names=AXES)


def _axis_size(mesh, axis: str) -> int:
    """Size of ``axis`` in a ``DeviceMesh`` or a mapping of axis sizes."""
    if isinstance(mesh, Mapping):
        return int(mesh.get(axis, 1))
    names = mesh.mesh_dim_names or ()
    return int(mesh.size(names.index(axis))) if axis in names else 1


def fsdp_partition_spec(shape: tuple[int, ...], mesh, axis: str = "fsdp",
                        min_size_to_shard: int = 2**14) -> tuple:
    """The JAX package's FSDP spec over ``shape`` (as a tuple of axis names
    or None per dim): the first evenly divisible axis goes on ``axis``;
    parameters under ``min_size_to_shard`` elements, or with no divisible
    axis, are replicated (``()``)."""
    size = _axis_size(mesh, axis)
    if size == 1 or int(np.prod(shape)) < min_size_to_shard:
        return ()
    for i, dim in enumerate(shape):
        if dim % size == 0:
            spec: list[Any] = [None] * len(shape)
            spec[i] = axis
            return tuple(spec)
    return ()


# Exact path-component rules, as in the JAX package: column-parallel layers
# (qkv, MLP up / gate) split their output features, row-parallel layers
# (attention out, MLP down) their input features.
_TP_COLUMN_RULES: tuple[tuple[str, ...], ...] = (
    ("to_q",), ("to_k",), ("to_v",),       # JiT / SDXL / CogView4 attention
    ("w_1",), ("w_2",),                     # JiT SwiGLU up + gate
    ("q_proj",), ("k_proj",), ("v_proj",), ("gate_up_proj",),  # decoder LM
    ("fc1",),                               # CLIP MLP up
    ("geglu", "proj"),                      # SDXL GeGLU fused up+gate
    ("ff", "proj"),                         # CogView4 MLP up
)
_TP_ROW_RULES: tuple[tuple[str, ...], ...] = (
    ("to_o",), ("w_3",),                    # JiT attention out / SwiGLU down
    ("o_proj",), ("down_proj",),            # decoder LM
    ("fc2",),                               # CLIP MLP down
    ("to_out",),                            # SDXL / CogView4 attention out
    ("ff", "out",),                         # SDXL / CogView4 FF down
)


def _match_rules(components: tuple[str, ...],
                 rules: tuple[tuple[str, ...], ...]) -> bool:
    for rule in rules:
        w = len(rule)
        if any(components[i:i + w] == rule
               for i in range(len(components) - w + 1)):
            return True
    return False


def tp_classification(path: str) -> str | None:
    """"column" / "row" / None for a dotted parameter path: the rule match
    alone, whatever the shape or mesh."""
    components = tuple(path.split("."))
    if components and components[-1] in ("weight", "kernel", "bias"):
        components = components[:-1]
    if _match_rules(components, _TP_COLUMN_RULES):
        return "column"
    if _match_rules(components, _TP_ROW_RULES):
        return "row"
    return None


def tensor_partition_spec(path: str, shape: tuple[int, ...], mesh,
                          axis: str = "tensor") -> tuple | None:
    """Tensor-parallel spec of a torch parameter (``.weight`` (out, in) or
    ``.bias``), or None if it is no target. A column weight splits dim 0
    (the JAX kernel's last), a row weight dim 1 (its first); a column bias
    goes with its outputs, a row bias stays whole (added after the
    reduction)."""
    size = _axis_size(mesh, axis)
    if size == 1:
        return None
    is_weight = path.endswith(".weight")
    is_bias = path.endswith(".bias")
    if not (is_weight or is_bias):
        return None
    kind = tp_classification(path)
    if kind == "column" and shape[0] % size == 0:
        spec: list[Any] = [None] * len(shape)
        spec[0] = axis
        return tuple(spec)
    if kind == "row" and is_weight and len(shape) == 2 and shape[1] % size == 0:
        return (None, axis)
    if kind == "row" and is_bias:
        return ()
    return None


def _flax_perm(module: nn.Module, param: torch.Tensor) -> tuple[int, ...]:
    """Dims of ``param`` in the order of its flax counterpart: a Linear
    kernel (and a module that declares ``flax_kernel``, a LoRA factor) is
    (in, out), a conv kernel (kh, kw, in, out)."""
    from ..ops.linear import Conv2d, Linear

    if ((isinstance(module, (Linear, nn.Linear)) or getattr(module, "flax_kernel", False))
            and param.dim() == 2):
        return (1, 0)
    if isinstance(module, (Conv2d, nn.Conv2d)) and param.dim() == 4:
        return (2, 3, 1, 0)
    return tuple(range(param.dim()))


def flax_perms(module: nn.Module) -> dict[nn.Parameter, tuple[int, ...]]:
    """{parameter: the dims of its flax counterpart's layout} over
    ``module``; the layout the JAX package's whole-array rules (the FSDP
    spec, the 8-bit moments' blocks) see."""
    return {p: _flax_perm(sub, p) for sub in module.modules()
            for p in sub.parameters(recurse=False)}


def fsdp_shard_dim(module: nn.Module, param: torch.Tensor, mesh,
                   axis: str = "fsdp", min_size_to_shard: int = 2**14) -> int | None:
    """The torch dim FSDP splits for ``param`` of ``module`` (the JAX spec
    taken on the flax layout), or None to keep it whole."""
    perm = _flax_perm(module, param)
    spec = fsdp_partition_spec(tuple(param.shape[d] for d in perm), mesh, axis,
                               min_size_to_shard)
    return perm[spec.index(axis)] if spec else None


def _tensor_plan(module: nn.Module, size: int) -> dict[str, str]:
    """{linear module name: "column" | "row"} of the tensor-parallel rules.
    A rule hit inside a module that does not declare ``supports_tensor_parallel``
    (its forward must take its head or feature count from the local width)
    raises instead of computing a different function."""
    plan = {}
    parents = dict(module.named_modules())
    for name, sub in module.named_modules():
        weight = getattr(sub, "weight", None)
        if not isinstance(weight, nn.Parameter) or weight.dim() != 2:
            continue
        spec = tensor_partition_spec(f"{name}.weight", tuple(weight.shape),
                                     {"tensor": size})
        if not spec:
            continue
        parent = parents[name.rpartition(".")[0]]
        if not getattr(parent, "supports_tensor_parallel", False):
            raise NotImplementedError(
                f"tensor parallelism of {type(parent).__name__} ({name}) is not "
                "ported: ROADMAP Queue 1 item 5")
        heads = getattr(parent, "num_heads", None)
        if heads is not None and heads % size:
            raise NotImplementedError(
                f"{heads} heads of {name} do not split over {size} tensor ranks: "
                "ROADMAP Queue 1 item 5")
        plan[name] = tp_classification(f"{name}.weight")
    return plan


def _tensor_parallel(module: nn.Module, mesh, kind: str) -> None:
    """Megatron-style parallelism of a module with a (out, in) ``weight``
    and optional ``bias`` over the tensor sub-mesh, through the public
    DTensor API (the port's ``Linear`` is not an ``nn.Linear``, which torch's
    ``ColwiseParallel`` / ``RowwiseParallel`` require). "column": weight and
    bias split on the out features, the input whole, the output this rank's
    features; "row": the weight split on the in features, the bias whole,
    the input this rank's features, the output summed over the ranks."""
    from torch.distributed.tensor import (
        DTensor,
        Replicate,
        Shard,
        distribute_module,
        distribute_tensor,
    )

    column = kind == "column"

    def partition(_, sub, device_mesh):
        for name, p in list(sub.named_parameters(recurse=False)):
            place = Shard(0) if column else Shard(1) if name == "weight" else Replicate()
            sub.register_parameter(name, nn.Parameter(
                distribute_tensor(p.detach(), device_mesh, [place]),
                requires_grad=p.requires_grad))

    def inputs(_, args, device_mesh):
        x = DTensor.from_local(args[0], device_mesh,
                               [Replicate() if column else Shard(-1)], run_check=False)
        return (x, *args[1:])

    def outputs(_, y, device_mesh):
        return y.redistribute(device_mesh, [Shard(-1) if column else Replicate()]).to_local()

    distribute_module(module, mesh, partition, inputs, outputs)


def _top_units(module: nn.Module) -> list[nn.Module]:
    """The children of ``module`` holding parameters, looking through
    containers (``ModuleList`` / ``ModuleDict``), whose forward never runs."""
    units = []
    for child in module.children():
        if isinstance(child, (nn.ModuleList, nn.ModuleDict)):
            units += _top_units(child)
        elif any(True for _ in child.parameters()):
            units.append(child)
    return units


def _fsdp_units(module: nn.Module) -> list[nn.Module]:
    """The modules whose forward FSDP hooks, innermost first: every
    submodule that declares ``fsdp_unit`` (a transformer or residual block,
    a text tower's layer: one is gathered at a time), each child holding
    parameters (through containers), and the module itself when it holds
    parameters of its own. A unit's ``fsdp_forward_methods`` (a VAE's
    ``encode`` / ``decode``) gather like its forward."""
    top = _top_units(module)
    units = [sub for sub in reversed(list(module.modules()))
             if getattr(sub, "fsdp_unit", False) and sub not in top and sub is not module
             and any(True for _ in sub.parameters())]
    units += top
    if any(True for _ in module.parameters(recurse=False)):
        units.append(module)
    return units


def _parameters_of(part) -> list[nn.Parameter]:
    """The parameters of a submodule or a parameter named by
    ``tensor_partial`` (none for None)."""
    if isinstance(part, nn.Parameter):
        return [part]
    return [] if part is None else list(part.parameters())


def shard_module(module: nn.Module, mesh, axis: str = "fsdp",
                 min_size_to_shard: int = 2**14) -> None:
    """Place the parameters of ``module`` in place: tensor parallelism by
    the rules on the tensor sub-mesh, then FSDP2 over (data, fsdp) for the
    parameters the JAX package shards; every other parameter stays whole
    and is averaged by :func:`reduce_replicated_grads`. Optimizer state made
    afterwards follows the placement."""
    from torch.distributed.tensor import DTensor, Shard

    tensor_partial: list[nn.Parameter] = []
    if _axis_size(mesh, "tensor") > 1:
        plan = _tensor_plan(module, _axis_size(mesh, "tensor"))
        for name, kind in plan.items():
            _tensor_parallel(module.get_submodule(name), mesh["tensor"], kind)
        parents = {name.rpartition(".")[0] for name in plan}
        tensor_partial = [p for name, sub in module.named_modules() if name in parents
                          for child in getattr(sub, "tensor_partial", ())
                          for p in _parameters_of(getattr(sub, child, None))]

    replicated, shard_dims = [], {}
    for name, sub in module.named_modules():
        for pname, p in sub.named_parameters(recurse=False):
            tp = tensor_partition_spec(f"{name}.{pname}".lstrip("."),
                                       tuple(p.shape), mesh)
            dim = None
            if not isinstance(p, DTensor) and tp != ():
                dim = fsdp_shard_dim(sub, p, mesh, axis, min_size_to_shard)
            if dim is None:
                replicated.append(p)
            else:
                shard_dims[p] = dim
    if shard_dims:
        from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method

        dp_mesh = mesh["data", axis]
        for unit in _fsdp_units(module):
            fully_shard(unit, mesh=dp_mesh, ignored_params=set(replicated),
                        shard_placement_fn=lambda p: Shard(shard_dims[p]))
            for method in getattr(unit, "fsdp_forward_methods", ()):
                register_fsdp_forward_method(unit, method)
    module._mesh_grads = (replicated, tensor_partial, mesh)


def _batch_groups(mesh) -> list:
    return [mesh.get_group(a) for a in ("data", "fsdp") if _axis_size(mesh, a) > 1]


def batch_mean(tensors: list[torch.Tensor], mesh) -> list[torch.Tensor]:
    """The mean over the data x fsdp ranks of per-rank values (a loss over
    this rank's rows): one all-reduce a batch axis over the stacked values."""
    groups = _batch_groups(mesh)
    if not groups or not tensors:
        return tensors
    stacked = torch.stack([t.detach().float() for t in tensors])
    for group in groups:
        dist.all_reduce(stacked, group=group)
    stacked /= _axis_size(mesh, "data") * _axis_size(mesh, "fsdp")
    return [s.to(t.dtype) for s, t in zip(stacked, tensors)]


def _local(t: torch.Tensor) -> torch.Tensor:
    """This rank's shard of a DTensor (under no_grad a view: writes reach
    it), else ``t``."""
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _all_reduce_flat(grads: list[torch.Tensor], groups: list, divisor: int) -> None:
    """Sum ``grads`` over each of ``groups`` in place (one all-reduce a
    group over their flattened values, by dtype), then divide."""
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for g in grads:
        by_dtype.setdefault(g.dtype, []).append(g)
    for same in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in same])
        for group in groups:
            dist.all_reduce(flat, group=group)
        if divisor != 1:
            flat /= divisor
        offset = 0
        for g in same:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


@torch.no_grad()
def reduce_replicated_grads(module: nn.Module) -> None:
    """The gradient reductions FSDP does not make after ``shard_module``:
    the gradients of parameters that see only this rank's heads summed over
    the tensor ranks, then those of the parameters kept whole averaged over
    the data x fsdp ranks (FSDP averages the sharded ones)."""
    replicated, tensor_partial, mesh = getattr(module, "_mesh_grads", ([], [], None))
    if mesh is None:
        return
    grads = [_local(p.grad) for p in tensor_partial if p.grad is not None]
    if grads:
        _all_reduce_flat(grads, [mesh.get_group("tensor")], 1)
    groups = _batch_groups(mesh)
    grads = [_local(p.grad) for p in replicated if p.grad is not None]
    if groups and grads:
        _all_reduce_flat(grads, groups,
                         _axis_size(mesh, "data") * _axis_size(mesh, "fsdp"))


def _split_key(t: torch.Tensor) -> tuple:
    """(mesh, the names of the axes it is split on) of a DTensor; (None, ())
    for a whole tensor."""
    from torch.distributed.tensor import DTensor

    if not isinstance(t, DTensor):
        return None, ()
    names = t.device_mesh.mesh_dim_names
    return t.device_mesh, tuple(names[i] for i, pl in enumerate(t.placements)
                                if pl.is_shard())


def shard_sum(values: list[torch.Tensor], like: list[torch.Tensor]) -> torch.Tensor:
    """The sum over every element of the tensors ``like`` of some function
    whose sum over this rank's elements of ``like[i]`` is ``values[i]``: a
    DTensor's partial sums are added over the mesh axes it is split on, a
    whole tensor's are taken once (not once a rank). Every rank of the
    groups gets the same value."""
    sums: dict[tuple, torch.Tensor] = {}
    for value, t in zip(values, like):
        key = _split_key(t)
        sums[key] = sums[key] + value if key in sums else value.clone()
    total = None
    for (mesh, names), s in sums.items():
        for name in names:
            dist.all_reduce(s, group=mesh.get_group(name))
        total = s if total is None else total + s
    return total


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """The L2 norm over every element of ``tensors``; for DTensors the
    squares of each shard are summed over the mesh axes it is split on."""
    from torch.distributed.tensor import DTensor

    if not any(isinstance(t, DTensor) for t in tensors):
        return torch.nn.utils.get_total_norm(tensors, norm_type=2.0)
    return shard_sum([_local(t).float().square().sum() for t in tensors], tensors).sqrt()


def reshard(module: nn.Module) -> None:
    """Free every gathered FSDP group under ``module``: a forward outside
    training (a preview) leaves the root groups gathered, and a later
    forward would read those copies, not the sharded parameters the
    optimizer or a swap has written since."""
    from torch.distributed.fsdp import FSDPModule

    for sub in module.modules():
        if isinstance(sub, FSDPModule):
            sub.reshard()


@contextlib.contextmanager
def full_parameters(module: nn.Module):
    """Inside, every DTensor parameter of ``module`` is replaced by its full
    tensor (gathered: every rank enters); the sharded ones come back after.
    For reading the weights whole (saving); no forward runs inside."""
    from torch.distributed.tensor import DTensor

    reshard(module)  # FSDP's state_dict hook leaves a sharded group be
    swapped = [(sub, name, p) for sub in module.modules()
               for name, p in sub._parameters.items() if isinstance(p, DTensor)]
    for sub, name, p in swapped:
        sub._parameters[name] = nn.Parameter(p.full_tensor().detach(),
                                             requires_grad=p.requires_grad)
    try:
        yield
    finally:
        for sub, name, p in swapped:
            sub._parameters[name] = p


def distribute_like(full: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``full`` (the same on every rank) placed as ``like``: this rank's
    shard when ``like`` is a DTensor, else ``full`` on its device."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    if isinstance(like, DTensor):
        return distribute_tensor(full.to(like.device, like.dtype), like.device_mesh,
                                 like.placements, src_data_rank=None)
    return full


def full_tensors(tree: Any) -> Any:
    """``tree`` with every DTensor gathered to its full tensor (a collective:
    every rank calls it)."""
    from torch.distributed.tensor import DTensor

    if isinstance(tree, DTensor):
        return tree.full_tensor()
    if isinstance(tree, dict):
        return {k: full_tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(full_tensors(v) for v in tree)
    return tree


def batch_rows(mesh) -> tuple[int, int]:
    """(index, count) of this rank's block of batch rows over data x fsdp."""
    data, fsdp = _axis_size(mesh, "data"), _axis_size(mesh, "fsdp")
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    return coord.get("data", 0) * fsdp + coord.get("fsdp", 0), data * fsdp


def shard_batch(batch: Any, mesh) -> Any:
    """This rank's rows of every array in ``batch`` (leading axis), split
    over data x fsdp as ``P(("data", "fsdp"))`` splits it: the tensor and
    seq ranks of one (data, fsdp) coordinate take the same rows."""
    index, count = batch_rows(mesh)

    def place(x):
        if isinstance(x, (torch.Tensor, np.ndarray)) and x.ndim > 0:
            assert x.shape[0] % count == 0, (
                f"batch {x.shape[0]} not divisible by data x fsdp = {count}")
            rows = x.shape[0] // count
            return x[index * rows:(index + 1) * rows]
        if isinstance(x, dict):
            return {k: place(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(place(v) for v in x)
        return x

    return place(batch)


class _GatherRows(torch.autograd.Function):
    """All-gather of the batch ranks' row blocks in row order; the backward
    sums the whole gradient over those ranks (every rank's loss may read
    every row) and takes this rank's block."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.rows = mesh, x.shape[0]
        out = x.contiguous()
        for axis in ("fsdp", "data"):  # the fsdp blocks of one data row first
            n = _axis_size(mesh, axis)
            if n > 1:
                parts = [torch.empty_like(out) for _ in range(n)]
                dist.all_gather(parts, out, group=mesh.get_group(axis))
                out = torch.cat(parts)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        for group in _batch_groups(ctx.mesh):
            dist.all_reduce(grad, group=group)
        index, _ = batch_rows(ctx.mesh)
        return grad[index * ctx.rows:(index + 1) * ctx.rows], None


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """The whole batch's rows of ``x`` (this rank's block, as ``shard_batch``
    split it) on every rank, with the gradient carried back to the rank that
    computed each row."""
    if not _batch_groups(mesh):
        return x
    return _GatherRows.apply(x, mesh)


def replicated(mesh):
    """Placements that keep a tensor whole on every rank of ``mesh``."""
    from torch.distributed.tensor import Replicate

    return [Replicate()] * mesh.ndim
