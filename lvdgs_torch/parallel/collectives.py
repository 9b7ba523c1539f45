"""The collectives of the multi-device paths, in one place.

Every rank holds a replica of the map and runs the same loop. These calls
make the gradients, losses and flags that steer the loop equal on every
rank, so that each rank takes the same host decisions and the replicas
stay bit for bit equal (an all-reduce hands every rank the same sums).

gloo (ranks that share a device) and NCCL (one GPU per rank) both take
CUDA tensors for each call here: torch 2.11 on the H100 ran all_reduce,
all_gather_into_tensor and reduce_scatter_tensor over gloo on cuda:0, so
no call is staged through host memory.

A `group` of None stands for this rank alone (a mesh without that dim):
every call is then the identity.
"""
from __future__ import annotations

from typing import Dict, List, Union

import torch
import torch.distributed as dist

Tensors = Union[Dict[str, torch.Tensor], List[torch.Tensor]]


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_flat(tensors: Tensors, group) -> Tensors:
    """The sum over `group` of each float32 tensor of a dict or list, by one
    all_reduce of their concatenation; same structure and shapes back."""
    if group_size(group) == 1:
        return tensors
    vals = list(tensors.values()) if isinstance(tensors, dict) else list(tensors)
    flat = torch.cat([t.reshape(-1) for t in vals])
    dist.all_reduce(flat, group=group)
    out, i = [], 0
    for t in vals:
        out.append(flat[i:i + t.numel()].view(t.shape))
        i += t.numel()
    return dict(zip(tensors, out)) if isinstance(tensors, dict) else out


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """A reduced copy of `x` summed over `group`."""
    if group_size(group) == 1:
        return x
    x = x.clone()
    dist.all_reduce(x, group=group)
    return x


def all_gather_tiled(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's `x` (all of one shape) concatenated along `dim` in group
    rank order: jax.lax.all_gather(..., tiled=True)."""
    n = group_size(group)
    if n == 1:
        return x
    src = x.movedim(dim, 0).contiguous()
    as_u8 = src.dtype == torch.bool
    if as_u8:
        src = src.to(torch.uint8)
    out = src.new_empty((n * src.shape[0], *src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    if as_u8:
        out = out.bool()
    return out.movedim(0, dim)


def reduce_scatter_tiled(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The sum over `group` of `x`, cut along `dim` into one block per rank:
    this rank's block (jax.lax.psum_scatter(..., tiled=True))."""
    n = group_size(group)
    if n == 1:
        return x
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim)


class _GatherAlong(torch.autograd.Function):
    """all_gather_tiled whose backward is the sum reduce-scatter: the
    transpose JAX's autodiff gives all_gather."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_gather_tiled(x, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_tiled(g, ctx.group), None


class _SumOver(torch.autograd.Function):
    """all_reduce_sum whose backward sums the cotangents over the group
    too: the transpose of jax.lax.psum under shard_map with check_vma off
    (lvdgs_tpu/parallel/dp_mapping.py)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g.contiguous(), ctx.group), None


def gather_along(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all_gather_tiled along dim 0."""
    return _GatherAlong.apply(x, group)


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable all_reduce_sum (psum), transposed as the reference's."""
    return _SumOver.apply(x, group)
