"""Placements over a mesh: batch-sharded activations, replicated params.

Port of ``iterative_inference_segm_tpu.parallel.sharding``. Under JAX a
``NamedSharding`` places a global array and XLA inserts the collectives; in
the port each rank holds only its part, so a placement is a description
(one ``torch.distributed.tensor`` ``Shard``/``Replicate`` a mesh axis) that
cuts a rank's part out of a whole batch (``Placement.local``). The
collectives are written out where the JAX package lets XLA place them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard
from torch.utils._pytree import tree_map

from iterative_inference_segm_tpu_torch.parallel import comm
from iterative_inference_segm_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size


@dataclass(frozen=True)
class Placement:
    """A value's layout on ``mesh``: one ``Shard(dim)`` or ``Replicate()``
    per mesh axis (``placements``, in the mesh's axis order)."""

    mesh: object
    placements: tuple

    def local(self, x):
        """This rank's part of the whole ``x`` (a numpy array or a tensor):
        dim d cut into equal blocks over each axis that shards it."""
        for name, p in zip(self.mesh.mesh_dim_names, self.placements):
            if isinstance(p, Shard):
                n = axis_size(self.mesh, name)
                if x.shape[p.dim] % n:
                    raise ValueError(f"dim {p.dim} of size {x.shape[p.dim]} does not split over '{name}' ({n})")
                k = x.shape[p.dim] // n
                i = axis_index(self.mesh, name)
                idx = [slice(None)] * x.ndim
                idx[p.dim] = slice(i * k, (i + 1) * k)
                x = x[tuple(idx)]
        return x


def batch_sharding(mesh, ndim: int, *, axis: str = "data", spatial_axis: str | None = None) -> Placement:
    """Dim 0 (the batch) sharded over ``axis``; with ``spatial_axis``, dim 1
    (H) too, over that axis, for a value of ``ndim`` >= 2. An H-sharded map
    is run by the ops through ``parallel.spatial`` (their ``space``)."""
    axis_size(mesh, axis)
    if spatial_axis is not None:
        axis_size(mesh, spatial_axis)

    def place(name):
        if name == axis:
            return Shard(0)
        return Shard(1) if name == spatial_axis and ndim >= 2 else Replicate()

    return Placement(mesh, tuple(place(n) for n in mesh.mesh_dim_names))


def replicated_sharding(mesh) -> Placement:
    return Placement(mesh, tuple(Replicate() for _ in mesh.mesh_dim_names))


def shard_batch(mesh, tree, *, axis: str = "data", spatial_axis: str | None = None):
    """This rank's slice of dim 0 of every leaf (numpy arrays or tensors),
    and with ``spatial_axis`` its equal band of dim 1 (H) of every leaf of
    2 dims or more."""
    return tree_map(lambda x: batch_sharding(mesh, x.ndim, axis=axis, spatial_axis=spatial_axis).local(x), tree)


def replicate(mesh, tree):
    """Every rank gets rank 0's bytes of every tensor leaf (a broadcast over
    the whole mesh, in place); returns ``tree``."""
    with torch.no_grad():
        tree_map(lambda t: comm.broadcast_(t, 0, dist.group.WORLD) if isinstance(t, torch.Tensor) else t, tree)
    return tree


def gather_batch(mesh, t: torch.Tensor, *, axis: str = "data", spatial_axis: str | None = None) -> torch.Tensor:
    """The whole batch from every rank's dim-0 shard over ``axis`` (and,
    with ``spatial_axis``, its band of H over that axis first)."""
    if spatial_axis is not None:
        t = comm.all_gather_cat(t, axis_group(mesh, spatial_axis), dim=1)
    return comm.all_gather_cat(t, axis_group(mesh, axis))


def padded_batch_putter(mesh, *, void_label: int, axis: str = "data", spatial_axis: str | None = None):
    """``put(images, labels)`` for the DP training loops: this rank's shard
    of a whole batch as host tensors of the batch's dtypes (the u8 wire
    stays bytes), a short batch padded first with zero images and all-void
    labels.

    Padding is exact: both losses and the confusion matrix mask void labels
    with a count-guarded denominator, so padded rows add nothing to loss,
    gradients or metrics (an all-padded shard averages in a zero loss and
    gradient, the equal-shard weighting every DP step has). The padded size
    is pinned by the first batch, so every step has one shape. With
    ``spatial_axis`` each part is also the rank's band of H.
    """
    n_dev = axis_size(mesh, axis)
    x_place = batch_sharding(mesh, 4, axis=axis, spatial_axis=spatial_axis)
    y_place = batch_sharding(mesh, 3, axis=axis, spatial_axis=spatial_axis)
    target = [0]

    def put(images, labels):
        x = np.asarray(images)
        y = np.asarray(labels)
        b = x.shape[0]
        t = max(target[0], -(-b // n_dev) * n_dev)
        target[0] = t
        if b < t:
            x = np.concatenate([x, np.zeros((t - b, *x.shape[1:]), x.dtype)])
            y = np.concatenate([y, np.full((t - b, *y.shape[1:]), void_label, y.dtype)])
        return (torch.from_numpy(np.ascontiguousarray(x_place.local(x))),
                torch.from_numpy(np.ascontiguousarray(y_place.local(y))))

    return put
