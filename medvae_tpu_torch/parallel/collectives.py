"""The collectives of the parallel paths, written with `all_reduce` and
`broadcast` only (port only; each function's docstring names the JAX
collective it stands for).

PyTorch's backend table lists only those two for gloo on CUDA tensors, and
`torch.distributed.nn.functional.all_gather`'s backward takes `all_to_all`
on every backend but NCCL. So a gather here is an all_reduce(SUM) of a
zero-filled buffer in which each rank fills its own block: exact, since
adding zeros is exact (a −0.0 comes back +0.0). Every function takes a
group that may be None, the trivial group of a single process, where it is
the identity.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch


def group_size(group) -> int:
    if group is None:
        return 1
    import torch.distributed as dist

    return dist.get_world_size(group)


def group_rank(group) -> int:
    if group is None:
        return 0
    import torch.distributed as dist

    return dist.get_rank(group)


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    dist.all_reduce(t, group=group)
    return t


def _gather_along(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The blocks of every rank of `group` along `dim`, in rank order (fp32
    on the wire for bf16 and fp16, which holds their values exactly)."""
    n, r = group_size(group), group_rank(group)
    wire = torch.float32 if x.dtype in (torch.bfloat16, torch.float16) else x.dtype
    dim = dim % x.dim()
    size = x.shape[dim]
    shape = list(x.shape)
    shape[dim] = size * n
    buf = torch.zeros(shape, dtype=wire, device=x.device)
    buf.narrow(dim, r * size, size).copy_(x)
    return _all_reduce(buf, group).to(x.dtype)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group, ctx.rows = group, x.shape[0]
        return _gather_along(x, 0, group)

    @staticmethod
    def backward(ctx, g):
        r = group_rank(ctx.group)
        wire = torch.float32 if g.dtype in (torch.bfloat16, torch.float16) else g.dtype
        total = _all_reduce(g.to(wire).contiguous().clone(), ctx.group)
        return total[r * ctx.rows:(r + 1) * ctx.rows].to(g.dtype), None


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """`jax.lax.all_gather(x, axis, axis=0, tiled=True)`: the ranks' rows
    stacked in rank order. Its backward is JAX's transpose, `psum_scatter`:
    the cotangents of every rank summed, then this rank's slice. Every rank
    computes the same batch-global loss on the gathered rows, so the sum
    counts each rank's term once the gradients are pmean'd; a detached
    gather would lose the cross-rank term, and a slice without the sum
    would give 1/N of it."""
    if group is None:
        return x
    if not x.requires_grad:
        return _gather_along(x, 0, group)
    return _GatherRows.apply(x, group)


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group, ctx.size = dim, group, x.shape[dim]
        return _gather_along(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        r = group_rank(ctx.group)
        return g.narrow(ctx.dim, r * ctx.size, ctx.size).contiguous(), None, None


def gather_channels(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The all-gather that XLA's SPMD partitioner inserts after a
    column-sharded conv: every model rank's output channels along `dim`.
    Every model rank then runs the same downstream on the same rows, so the
    cotangent is the same on each, and the backward is this rank's slice of
    it, with no sum."""
    if group is None:
        return x
    return _GatherChannels.apply(x, dim, group)


class _SumGradients(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.group), None


def sum_gradients(x: torch.Tensor, group) -> torch.Tensor:
    """The input side of a column-sharded layer: the identity forward, and
    a backward that sums the cotangent over the model group, since each
    model rank's shard gives only its own rows' part of the input's
    gradient (the partitioner's psum of that gradient)."""
    if group is None or not x.requires_grad:
        return x
    return _SumGradients.apply(x, group)


class _AllReduceMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x.clone(), group) / group_size(group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.group) / group_size(ctx.group), None


def pmean_autograd(x: torch.Tensor, group) -> torch.Tensor:
    """`jax.lax.pmean` inside a differentiated function (sync-BN's moments):
    forward the mean over the group; backward JAX's transpose under
    shard_map, the cotangents' psum / N."""
    if group is None:
        return x
    return _AllReduceMean.apply(x, group)


def pmean(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """`jax.lax.pmean` of a list of tensors: one flat fp32 bucket, one
    all_reduce, a division by the group's size, copied back into tensors of
    each one's shape, dtype and memory layout (`empty_like`). With one rank
    it is the identity, bit for bit, also for what a caller reduces: a
    gradient's norm sums a tensor in its layout's order (a conv's gradient
    may come out of autograd in another layout than a flat copy's)."""
    tensors = list(tensors)
    if group is None or not tensors:
        return tensors
    flat = torch.cat([t.detach().reshape(-1).to(torch.float32) for t in tensors])
    flat = _all_reduce(flat, group) / group_size(group)
    out, at = [], 0
    for t in tensors:
        out.append(torch.empty_like(t).copy_(flat[at:at + t.numel()].view(t.shape)))
        at += t.numel()
    return out


def pmean_dict(values: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    names = list(values)
    return dict(zip(names, pmean([values[n] for n in names], group)))


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """`jax.lax.psum` of a tensor that needs no gradient."""
    if group is None:
        return t
    return _all_reduce(t.detach().clone(), group)


def all_reduce_min(value: int, group, device) -> int:
    """The smallest of an integer over the group (the ranks' batch probes)."""
    if group is None:
        return int(value)
    import torch.distributed as dist

    t = torch.tensor([int(value)], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    return int(t.item())


def gather_host_rows(rows, group, device) -> "object":
    """A numpy array of rows from every rank of the group, stacked in rank
    order (all ranks must pass the same shape); the host side of a
    validation whose batches were split over the ranks."""
    import numpy as np

    if group is None:
        return rows
    t = torch.from_numpy(np.ascontiguousarray(rows, np.float64)).to(device)
    return _gather_along(t, 0, group).cpu().numpy()
