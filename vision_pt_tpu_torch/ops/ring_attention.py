"""Ring attention: sequence-parallel attention over the seq ranks (port of
``vision_pt_tpu/ops/ring_attention.py``).

Each rank keeps its block of queries and passes its key / value block round
the ring with ``torch.distributed`` point-to-point sends
(``batch_isend_irecv``: NCCL on the card, gloo on the CPU), accumulating a
streaming softmax in fp32 (``o``, ``m``, ``l``). The last block is consumed
without a rotation. The backward recomputes each block's scores from the
forward's log-sum-exp (nothing of size S_local² is stored), and the dk / dv
accumulators travel the ring with their blocks and come home to their
owner. No kernel here, as in the JAX package: the block update is plain
torch (fp32 products of the input dtype, fp32 ``exp``).

Layout: (B, S_local, H, D) blocks, the BSHD layout of
``dot_product_attention``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .attention import _exact_tf32


def _group_of(axis) -> dist.ProcessGroup:
    """The process group of a seq axis: a group, or a 1-D ``DeviceMesh``."""
    from torch.distributed.device_mesh import DeviceMesh

    return axis.get_group() if isinstance(axis, DeviceMesh) else axis


def _product(equation: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """fp32 einsum of two tensors (products of 16-bit inputs exact)."""
    with _exact_tf32(a.dtype, a.device):
        return torch.einsum(equation, a.float(), b.float())


def _scores(q, k_blk, scale, blk_mask):
    """fp32 (B, H, Sq, Sk) scores, masked keys at -inf."""
    s = _product("bqhd,bkhd->bhqk", q, k_blk) * scale
    if blk_mask is not None:
        s = s.masked_fill(~blk_mask[:, None, None, :], -torch.inf)
    return s


def _block_mask(kv_lens, owner: int, s_local: int, device):
    """Which keys of the block that ``owner`` holds are below ``kv_lens``
    (global positions), or None without ``kv_lens``."""
    if kv_lens is None:
        return None
    pos = owner * s_local + torch.arange(s_local, device=device)
    return pos[None, :] < kv_lens.to(device)[:, None]


def _rotate(tensors: list[torch.Tensor], group, rank: int, n: int) -> list[torch.Tensor]:
    """Send ``tensors`` to the next rank of the ring and receive the previous
    rank's; returns the received tensors after the exchange completes."""
    nxt = dist.get_global_rank(group, (rank + 1) % n)
    prv = dist.get_global_rank(group, (rank - 1) % n)
    received = [torch.empty_like(t) for t in tensors]
    ops = [dist.P2POp(dist.isend, t, nxt, group) for t in tensors]
    ops += [dist.P2POp(dist.irecv, r, prv, group) for r in received]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return received


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_lens, group, scale):
        n, rank = dist.get_world_size(group), dist.get_rank(group)
        b, s_local, h, d = q.shape
        o = torch.zeros(b, s_local, h, d, dtype=torch.float32, device=q.device)
        m = torch.full((b, h, s_local), -torch.inf, device=q.device)
        l = torch.zeros(b, h, s_local, device=q.device)
        k_blk, v_blk = k, v
        for step in range(n):
            # the block at step t came from rank (rank - t) mod n
            mask = _block_mask(kv_lens, (rank - step) % n, s_local, q.device)
            s = _scores(q, k_blk, scale, mask)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # fully masked rows keep m = -inf; guard exp against -inf - -inf
            safe_m = torch.where(torch.isfinite(m_new), m_new, 0.0)
            corr = torch.exp(m - safe_m)
            p = torch.exp(s - safe_m[..., None])
            l = l * corr + p.sum(dim=-1)
            pv = _product("bhqk,bkhd->bqhd", p.to(v_blk.dtype), v_blk)
            o = o * corr.transpose(1, 2)[..., None] + pv
            m = m_new
            if step < n - 1:
                k_blk, v_blk = _rotate([k_blk, v_blk], group, rank, n)
        # rows with no valid key divide by l = 1 and give 0
        out = (o / torch.where(l == 0.0, 1.0, l).transpose(1, 2)[..., None]).to(q.dtype)
        lse = torch.where(l > 0.0, m + torch.log(l), torch.inf)
        ctx.save_for_backward(q, k, v, kv_lens, out, lse)
        ctx.group, ctx.scale = group, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, kv_lens, out, lse = ctx.saved_tensors
        group, scale = ctx.group, ctx.scale
        n, rank = dist.get_world_size(group), dist.get_rank(group)
        s_local = q.shape[1]
        dout32 = dout.float()
        delta = (dout32 * out.float()).sum(dim=-1).transpose(1, 2)  # (B, H, Sq)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        k_blk, v_blk = k, v
        dk_blk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv_blk = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
        for step in range(n):
            mask = _block_mask(kv_lens, (rank - step) % n, s_local, q.device)
            # lse = +inf on a row with no valid key: its p is 0
            p = torch.exp(_scores(q, k_blk, scale, mask) - lse[..., None])
            dv_blk = dv_blk + _product("bhqk,bqhd->bkhd", p, dout32)
            dp = _product("bqhd,bkhd->bhqk", dout32, v_blk)
            ds = p * (dp - delta[..., None])
            dq = dq + _product("bhqk,bkhd->bqhd", ds, k_blk) * scale
            dk_blk = dk_blk + _product("bhqk,bqhd->bkhd", ds, q) * scale
            if step < n - 1:
                k_blk, v_blk, dk_blk, dv_blk = _rotate(
                    [k_blk, v_blk, dk_blk, dv_blk], group, rank, n)
        if n > 1:  # the accumulators of the last block go home to its owner
            dk_blk, dv_blk = _rotate([dk_blk, dv_blk], group, rank, n)
        return (dq.to(q.dtype), dk_blk.to(k.dtype), dv_blk.to(v.dtype),
                None, None, None)


def ring_attention(
    q: torch.Tensor,  # (B, S_local, H, D): this rank's sequence block
    k: torch.Tensor,
    v: torch.Tensor,
    axis_name,  # the seq axis: a process group or a 1-D DeviceMesh
    kv_lens: torch.Tensor | None = None,  # (B,) GLOBAL valid key length
    scale: float | None = None,
) -> torch.Tensor:
    """Non-causal ring attention over the ranks of ``axis_name``, each
    holding its block of q / k / v along the sequence (rank i the i-th
    block). ``kv_lens`` masks global key positions >= kv_lens[b] (suffix
    padding, the flash kernel's contract); a row with no valid key gives 0.
    Returns this rank's block of the output in q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _Ring.apply(q, k, v, kv_lens, _group_of(axis_name), scale)


class _SeqSlice(torch.autograd.Function):
    """This rank's block of a tensor that every seq rank holds whole; the
    backward gathers the blocks' gradients (every rank then has the whole
    gradient, and nothing is reduced over seq)."""

    @staticmethod
    def forward(ctx, x, group, rank: int, n: int):
        ctx.group, ctx.n = group, n
        s_local = x.shape[1] // n
        return x[:, rank * s_local:(rank + 1) * s_local].contiguous()

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad.contiguous(), ctx.group, ctx.n), None, None, None


class _SeqGather(torch.autograd.Function):
    """The seq ranks' blocks joined along S; the backward takes this rank's
    rows of the incoming gradient (the transpose of ``_SeqSlice``)."""

    @staticmethod
    def forward(ctx, x, group, rank: int, n: int):
        ctx.rank, ctx.s_local = rank, x.shape[1]
        return _gather(x.contiguous(), group, n)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.rank * ctx.s_local
        return grad[:, lo:lo + ctx.s_local].contiguous(), None, None, None


def _gather(x: torch.Tensor, group, n: int) -> torch.Tensor:
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=1)


def ring_attention_sharded(
    q: torch.Tensor,  # (B, S, H, D): the whole sequence, on every seq rank
    k: torch.Tensor,
    v: torch.Tensor,
    mesh,
    axis_name: str = "seq",
    kv_lens: torch.Tensor | None = None,
    scale: float | None = None,
    batch_axes: tuple[str, ...] = (),
) -> torch.Tensor:
    """Split the sequence of q / k / v over ``mesh[axis_name]``, run the
    ring, and join the output along S. S must divide evenly by the axis size
    (pad the sequence and pass kv_lens otherwise).

    The batch rows are this rank's already (``shard_batch`` over
    ``batch_axes``, the trainer's data x fsdp layout): the ring never moves
    rows between batch ranks, so each (data, fsdp) coordinate runs its own
    seq ring, as the JAX package's ``batch_axes`` layout does."""
    n = mesh[axis_name].size() if mesh.ndim > 1 else mesh.size()
    assert q.shape[1] % n == 0, (
        f"sequence {q.shape[1]} not divisible by mesh axis {axis_name}={n}; "
        "pad the sequence and pass kv_lens"
    )
    for axis in batch_axes:
        assert axis in mesh.mesh_dim_names, f"no mesh axis {axis!r}"
    group = mesh.get_group(axis_name)
    rank = dist.get_rank(group)
    q, k, v = (_SeqSlice.apply(x, group, rank, n) for x in (q, k, v))
    out = ring_attention(q, k, v, group, kv_lens=kv_lens, scale=scale)
    return _SeqGather.apply(out, group, rank, n)
