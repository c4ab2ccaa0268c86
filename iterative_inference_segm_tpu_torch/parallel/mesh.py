"""Device meshes over a launched process group.

Port of ``iterative_inference_segm_tpu.parallel.mesh``. The JAX package
builds one ``Mesh`` over the devices of one controller; the port runs one
process a device (``parallel.launch``), so a mesh exists only inside a
launched group. Outside one, ``MeshSpec`` names the axes and their sizes:
what ``mesh_from_flag`` resolves a CLI flag to and what ``launch`` forms.
Inside, ``make_mesh`` builds a ``torch.distributed.device_mesh.DeviceMesh``
with the JAX axis names (``("data",)``, ``("data", "model")``,
``("stage",)``, ``("data", "stage")``); the helpers below read an axis's
size, this rank's index on it and the group its collectives run over.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

# The "devices" the CPU offers: gloo ranks on one host. The JAX tests fake
# 8 CPU devices (the root conftest.py); the port's CPU tests launch at most
# this many ranks.
CPU_DEVICE_COUNT = 8


def local_device_count(device_type: str = "cuda") -> int:
    """The devices a mesh can span: the visible cards, or on the CPU
    ``CPU_DEVICE_COUNT`` gloo ranks."""
    if device_type == "cpu":
        return CPU_DEVICE_COUNT
    return torch.cuda.device_count()


@dataclass(frozen=True)
class MeshSpec:
    """A mesh to be formed: axis names and sizes, one rank a device."""

    axis_names: tuple[str, ...]
    axis_sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axis names {self.axis_names} and sizes {self.axis_sizes} differ in length")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return int(np.prod(self.axis_sizes))


def make_mesh(
    axis_names: tuple[str, ...] = ("data",),
    axis_sizes: tuple[int, ...] | None = None,
    *,
    device_type: str | None = None,
    ranks: int | None = None,
) -> DeviceMesh:
    """A DeviceMesh over every rank of the launched group. Default: a 1-D
    'data' mesh; ``axis_sizes`` must multiply to the world size. With
    ``ranks`` (the JAX ``devices=`` of a subset), a mesh over the first
    ``ranks`` ranks: every rank of the group calls this, and a rank outside
    the mesh takes no part in what runs on it."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a launched process group (parallel.launch)")
    n = dist.get_world_size() if ranks is None else int(ranks)
    if not 1 <= n <= dist.get_world_size():
        raise ValueError(f"a mesh over {n} ranks in a group of {dist.get_world_size()}")
    if axis_sizes is None:
        axis_sizes = (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(axis_sizes)) != n:
        raise ValueError(f"axis sizes {tuple(axis_sizes)} do not multiply to device count {n}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if ranks is None:
        return init_device_mesh(device_type, tuple(axis_sizes), mesh_dim_names=tuple(axis_names))
    return DeviceMesh(device_type, torch.arange(n).reshape(tuple(axis_sizes)), mesh_dim_names=tuple(axis_names))


def mesh_from_flag(devices: str | int | None, *, batch_size: int | None = None,
                   device_type: str = "cuda") -> MeshSpec | None:
    """Resolve the CLIs' ``--devices N|auto`` to a 1-D 'data' mesh spec
    (None = the single-device path; 'auto' = every visible device), with
    the JAX package's checks: the count must be visible and divide the
    batch."""
    if devices is None:
        return None
    avail = local_device_count(device_type)
    n = avail if devices == "auto" else int(devices)
    if n > avail:
        raise ValueError(f"--devices {n} requested but only {avail} visible")
    if n <= 1:
        return None
    if batch_size is not None and batch_size % n:
        raise ValueError(f"batch size {batch_size} not divisible by --devices {n}")
    return MeshSpec(("data",), (n,))


def _check_mesh(mesh) -> DeviceMesh:
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"expected a DeviceMesh (parallel.make_mesh in a launched group); got {type(mesh).__name__}")
    return mesh


def has_axis(mesh, axis: str) -> bool:
    return axis in (_check_mesh(mesh).mesh_dim_names or ())


def axis_size(mesh, axis: str) -> int:
    """The size of ``axis``; a ValueError naming the axes when it is absent."""
    names = _check_mesh(mesh).mesh_dim_names or ()
    if axis not in names:
        raise ValueError(f"mesh axes {names} have no '{axis}' axis")
    return mesh.size(names.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's index on ``axis`` (``lax.axis_index``)."""
    axis_size(mesh, axis)
    return mesh.get_local_rank(axis)


def axis_group(mesh, axis: str) -> dist.ProcessGroup:
    """The group of the ranks that differ only on ``axis``."""
    axis_size(mesh, axis)
    return mesh[axis].get_group()
