"""Explicit data parallelism: one gradient all-reduce a step.

Port of ``iterative_inference_segm_tpu.parallel.dp``. Each rank runs the
per-rank loss on its shard of the batch and backpropagates; then the
gradients of every parameter and the loss are averaged over the 'data'
group with ONE ``all_reduce`` of one flat buffer (the counterpart of the
one fused all-reduce XLA compiles the JAX step to), and the optimizer
steps. Every rank then applies the same update, so the parameters stay
replicated without a second broadcast.

The models are dicts of tensors with a ``torch.optim`` optimizer over them
(``train.loop.make_optimizer``), not ``nn.Module``s, so
``nn.parallel.DistributedDataParallel``, which wraps a module and reduces
in buckets during the backward, is not used.

Randomness is per rank: JAX folds the device's axis index into the
replicated key; the port's step takes each rank's randomness as an
argument (a generator, or what the trainers' ``StepRandomness`` holds), so
a caller decides what each rank draws.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from iterative_inference_segm_tpu_torch.parallel import comm
from iterative_inference_segm_tpu_torch.parallel.mesh import axis_group, axis_size
from iterative_inference_segm_tpu_torch.parallel.sharding import replicate, shard_batch


def leaves(params: dict) -> list[torch.Tensor]:
    """The tensors of a ``{layer: {leaf: tensor}}`` tree, in its order."""
    return [t for layer in params.values() for t in layer.values()]


def reduce_group(mesh, axis: str = "data", sum_axis: str | None = None):
    """The group a step's reduction runs over: ``axis``'s, or with
    ``sum_axis`` (the 'space' of an H-sharded step, whose ranks hold parts
    of one gradient) the whole mesh of the two axes."""
    if sum_axis is None:
        return axis_group(mesh, axis)
    axis_size(mesh, sum_axis)
    if set(mesh.mesh_dim_names) != {axis, sum_axis} or mesh.size() != dist.get_world_size():
        raise ValueError(f"a reduction over '{axis}' and '{sum_axis}' needs a mesh of those two axes over "
                         f"every rank; got {mesh.mesh_dim_names}")
    return dist.group.WORLD


def average_gradients(tensors: list[torch.Tensor], loss: torch.Tensor, mesh, *, axis: str = "data",
                      sum_axis: str | None = None) -> torch.Tensor:
    """Average the ``.grad`` of ``tensors`` and ``loss`` over ``axis`` with
    one ``all_reduce`` of one flat f32 buffer; the averaged gradients are
    written back into ``.grad`` (a missing one counts as zeros). Returns the
    averaged loss. With ``sum_axis`` the same one all-reduce also sums them
    over that axis (an H-sharded step: each 'space' rank holds its rows'
    part of the loss and of every gradient)."""
    n = axis_size(mesh, axis)
    grads = [t.grad if t.grad is not None else torch.zeros_like(t) for t in tensors]
    flat = torch.cat([loss.detach().reshape(1).float()] + [g.reshape(-1).float() for g in grads])
    comm.all_reduce_(flat, reduce_group(mesh, axis, sum_axis))
    flat /= n
    offset = 1
    for t, g in zip(tensors, grads):
        k = g.numel()
        t.grad = flat[offset : offset + k].view_as(g).to(g.dtype)
        offset += k
    return flat[0]


def make_dp_grad_step(
    loss_fn: Callable,
    optimizer: torch.optim.Optimizer,
    mesh,
    *,
    axis: str = "data",
) -> Callable:
    """``step(params, batch, rand) -> loss`` for ``loss_fn(params, batch,
    rand)``: ``batch`` is this rank's shard, ``rand`` this rank's
    randomness; the loss and gradients are averaged over ``axis`` before
    ``optimizer`` (over the tensors of ``params``) steps."""
    axis_size(mesh, axis)

    def step(params, batch, rand):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, batch, rand)
        loss.backward()
        loss = average_gradients(leaves(params), loss, mesh, axis=axis)
        optimizer.step()
        return loss

    return step


def put_dp(mesh, params, batch, *, axis: str = "data"):
    """``params`` replicated from rank 0 (in place) and this rank's shard of
    ``batch``. The optimizer's state needs no placing: it is made by the
    first step, from the averaged (equal) gradients."""
    return replicate(mesh, params), shard_batch(mesh, batch, axis=axis)
