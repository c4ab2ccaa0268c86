"""Tensor parallelism for the FCN-8 classifier pair (fc6/fc7).

Port of ``iterative_inference_segm_tpu.parallel.tp``. fc6 (7x7x512xF) and
fc7 (1x1xFxF) hold ~96% of FCN-8's parameters at F = 4096 (fc6 alone is
411 MB in f32); the backbone and the class-channel tail stay replicated.
The layout is the column -> row pair:

* fc6 is sharded on its OUTPUT channels over the 'model' axis, with its
  bias, so each rank computes a contiguous slice of the fc6 activation and
  the relu -> dropout chain runs on that slice alone;
* fc7 is sharded on its INPUT channels: each rank contracts its slice into
  a partial sum, the partial sums are all-reduced, then fc7's whole
  (replicated) bias is added.

GSPMD inserts the collectives for the JAX package; the port writes them
at the fc6/fc7 seam of ``models.fcn8.fcn8_head`` (its ``model_group``
argument) as two autograd functions: fc7's partial sums are summed in the
forward (identity in the backward), and fc6's replicated input gets the
adjoint, identity in the forward and a sum of the input gradient in the
backward, without which the backbone's gradients would be a 1/n part of
the truth on each rank. The dropout keep-mask after fc6 is the rank's
slice of the whole mask. The optimizer, built over the rank's slices, keeps
Adam's moments for fc6/fc7 sharded the same way. Compose with DP on a
``("data", "model")`` mesh, the batch sharded over 'data'.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from iterative_inference_segm_tpu_torch.parallel import comm
from iterative_inference_segm_tpu_torch.parallel.mesh import axis_size
from iterative_inference_segm_tpu_torch.parallel.sharding import Placement

# params[name] for these is {'w': OIHW (cout, cin, kh, kw), 'b': (cout,)}
_COL_PARALLEL = ("fc6",)  # w sharded on cout (dim 0), and b
_ROW_PARALLEL = ("fc7",)  # w sharded on cin (dim 1); b replicated, added after the sum


def tp_shardings(params: dict, mesh, *, model_axis: str = "model") -> dict:
    """The ``Placement`` of every FCN-8 leaf: fc6 column-, fc7 row-parallel,
    every other leaf replicated. The fc width must divide the axis size."""
    n = axis_size(mesh, model_axis)
    fc = int(params["fc6"]["w"].shape[0])
    if fc % n:
        raise ValueError(f"fc_channels {fc} not divisible by mesh axis '{model_axis}' size {n}")

    def on_model(p):
        return Placement(mesh, tuple(p if name == model_axis else Replicate() for name in mesh.mesh_dim_names))

    repl = on_model(Replicate())
    out = {layer: {k: repl for k in leaves} for layer, leaves in params.items()}
    for name in _COL_PARALLEL:
        out[name] = {"w": on_model(Shard(0)), "b": on_model(Shard(0))}
    for name in _ROW_PARALLEL:
        out[name] = {"w": on_model(Shard(1)), "b": repl}
    return out


def shard_params_tp(params: dict, mesh, *, model_axis: str = "model") -> dict:
    """This rank's params under the TP layout, from the whole (replicated)
    ``params``: fc6/fc7 become copies of the rank's slices, so they own
    only the slice's memory; every other leaf is kept as it is."""
    specs = tp_shardings(params, mesh, model_axis=model_axis)
    return {
        layer: {k: (specs[layer][k].local(t).clone() if layer in _COL_PARALLEL + _ROW_PARALLEL else t)
                for k, t in leaves.items()}
        for layer, leaves in params.items()
    }


class _CopyToModel(torch.autograd.Function):
    """fc6's replicated input: identity forward, gradient summed backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return comm.all_reduce_(g.contiguous().clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    """fc7's partial sums: summed forward, identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        return comm.all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromModel.apply(x, group)


def model_slice(t: torch.Tensor, group) -> torch.Tensor:
    """This rank's block of the last dim of ``t`` over the 'model' group."""
    n = dist.get_world_size(group)
    k = t.shape[-1] // n
    r = dist.get_rank(group)
    return t[..., r * k : (r + 1) * k]
