"""The collectives of the sharded stages over a mesh axis: what
``shard_map`` with ``lax.axis_index``, ``lax.all_gather`` and
``lax.psum`` are in the JAX package.

Gloo gathers host tensors only. Where an axis's group is gloo and the
tensor lies on a card, the gather stages it through host memory; that is
the one case that does, and it is stated here rather than left to a
backend's fallback.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis`` (``lax.axis_index``)."""
    return mesh.get_local_rank(axis)


def all_gather_stack(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """[n, *x.shape]: every rank's ``x`` on ``axis``, stacked in the order
    of its coordinate (``lax.all_gather(..., tiled=False)``)."""
    group = mesh.get_group(axis)
    staged = x.is_cuda and dist.get_backend(group) == "gloo"
    src = (x.cpu() if staged else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.stack(parts)
    return out.to(x.device) if staged else out


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The sum of every rank's ``x`` on ``axis`` (``lax.psum``), taken as
    a gather and then a sum in coordinate order, so that every rank holds
    the same bits (an all-reduce may differ by rank in the low bits, and
    a loop that exits on the sum would then leave its collectives out of
    step)."""
    parts = all_gather_stack(x, mesh, axis)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total
