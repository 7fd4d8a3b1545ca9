"""Collectives on a ``torch.distributed`` process group: the port's
``lax.psum``/``pmax``/``pmin``/``all_gather`` for code that every rank of
a group runs on its own shard.

Each helper returns a new tensor and leaves its input as it was (NCCL and
Gloo reduce in place). Bool tensors travel as int32, which NCCL takes and
bool it does not. Every rank of the group must call the same helpers in
the same order with tensors of the same shape and dtype.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

_OPS = {
    "sum": dist.ReduceOp.SUM,
    "max": dist.ReduceOp.MAX,
    "min": dist.ReduceOp.MIN,
}


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The reduction of ``t`` over ``group`` (``op``: sum, max or min),
    identical on every rank."""
    is_bool = t.dtype == torch.bool
    out = t.to(torch.int32) if is_bool else t.clone(
        memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=_OPS[op], group=group)
    return out.bool() if is_bool else out


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """``[P, *t.shape]``: every rank's ``t``, in group rank order."""
    is_bool = t.dtype == torch.bool
    src = t.to(torch.int32) if is_bool else t.contiguous()
    parts = [torch.empty_like(src)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.stack(parts)
    return out.bool() if is_bool else out


def exclusive_prefix(cnt: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``cnt`` over the ranks before this one (``lax``'s
    all-gather, exclusive cumsum over the shard axis, own row)."""
    allc = all_gather(cnt, group)
    excl = torch.cumsum(allc, dim=0) - allc
    return excl[dist.get_rank(group)]


def agree_any(flag: bool, group) -> bool:
    """Whether ``flag`` holds on any rank of ``group``: the one host
    value every rank then branches on alike."""
    dev = _group_device(group)
    return bool(all_reduce(torch.tensor([int(flag)], device=dev), group,
                           "max")[0])


def _group_device(group) -> torch.device:
    """The device a group's collectives take tensors on: the current card
    for NCCL, else the host."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")
