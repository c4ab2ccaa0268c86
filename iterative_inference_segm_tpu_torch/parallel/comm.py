"""The collectives of the parallel layer, over a mesh axis's group.

NCCL moves CUDA tensors. gloo moves host tensors: on a gloo group a CUDA
tensor crosses through host memory (copied out, exchanged, copied back).
That is an explicit branch on the group's backend, taken by every call on
gloo, never a retry after a failure. It serves ranks that share one card
(NCCL refuses two ranks on a card) and the CPU tests; a run over several
cards uses NCCL and takes no host copy.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce_(t: torch.Tensor, group, *, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce ``t`` in place over ``group`` (one collective) and return it."""
    if _staged(t, group):
        host = t.cpu()
        dist.all_reduce(host, op=op, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def all_gather_cat(t: torch.Tensor, group, *, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes), concatenated in rank order."""
    n = dist.get_world_size(group)
    src = t.cpu() if _staged(t, group) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def broadcast_(t: torch.Tensor, src_group_rank: int, group) -> torch.Tensor:
    """Overwrite ``t`` with the group rank ``src_group_rank``'s."""
    src = dist.get_global_rank(group, src_group_rank)
    if _staged(t, group):
        host = t.cpu()
        dist.broadcast(host, src=src, group=group)
        t.copy_(host)
    else:
        dist.broadcast(t, src=src, group=group)
    return t


def isend(t: torch.Tensor, dst_group_rank: int, group, *, tag: int = 0):
    """Start sending ``t`` to a group rank; returns ``(work, buffer)``: keep
    the buffer alive until ``work.wait()``."""
    buf = t.cpu() if _staged(t, group) else t.contiguous()
    return dist.isend(buf, dst=dist.get_global_rank(group, dst_group_rank), group=group, tag=tag), buf


def irecv(like: torch.Tensor, src_group_rank: int, group, *, tag: int = 0):
    """Start receiving a tensor shaped as ``like`` from a group rank; returns
    ``finish()``, which waits and gives it on ``like``'s device."""
    staged = _staged(like, group)
    buf = torch.empty(like.shape, dtype=like.dtype, device="cpu" if staged else like.device)
    work = dist.irecv(buf, src=dist.get_global_rank(group, src_group_rank), group=group, tag=tag)

    def finish() -> torch.Tensor:
        work.wait()
        return buf.to(like.device) if staged else buf

    return finish
