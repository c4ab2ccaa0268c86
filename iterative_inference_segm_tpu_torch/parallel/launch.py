"""Launch a function in one process a device, over ``torch.distributed``.

The port's counterpart of the JAX package's single controller: where JAX
runs one program over every device of a mesh, the port spawns one rank a
device (``torch.multiprocessing``, method ``spawn``), forms the process
group and the mesh in each, and calls ``fn(mesh, device, *args)`` there.

* The ranks meet at a ``FileStore`` in a temporary directory: no TCP port,
  so launches in concurrent processes cannot collide.
* Rank r runs on ``cuda:r`` for ``device='cuda'``; any other device
  (``'cpu'``, ``'cuda:0'``) is every rank's. A CPU rank takes its share of
  the cores for its intra-op threads, and no more than the launching
  process had (``torch.get_num_threads()``), so a caller that limits its
  threads limits its ranks'.
* The backend is explicit: NCCL on CUDA, gloo on the CPU, unless the caller
  names one. NCCL takes one card a rank, so ranks that share a card must
  ask for gloo; nothing falls back from one backend to the other.
* The parent builds, before it spawns, the kernels (``csrc/<name>.cu``) and
  the native input runtime its ranks will load, so N ranks that start cold
  do not run N compilers on one source; each rank loads from the parent's
  build directory.
* A rank's standard output is kept in a file; rank 0's is written to the
  parent's ``sys.stdout`` when the ranks end, and the others' are dropped,
  so only rank 0 prints.
* ``fn`` and its arguments are pickled once into the launch's temporary
  directory, and every rank loads them from there, so the ranks start
  together (through the start pipe, a rank that imports what it unpickles
  holds up the next rank's start).
* Rank 0's return value (or, with ``launch_ranks``, every rank's) comes
  back to the parent, pickled: return CPU tensors or numpy arrays. A rank
  that raises ends the launch: the others are terminated and the parent
  raises ``RankError`` with the traceback of the rank that failed first
  (the others' failures are mostly its consequence: a peer that left).
* Each rank destroys its process group on every exit path.

Importing this module starts no process and forms no group.
"""

from __future__ import annotations

import datetime
import os
import pickle
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.multiprocessing.spawn import ProcessException

from iterative_inference_segm_tpu_torch.ops import _build
from iterative_inference_segm_tpu_torch.parallel.mesh import MeshSpec, make_mesh

# a collective that waits longer than this raises in its rank (and so ends
# the launch) instead of hanging it
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)


class RankError(RuntimeError):
    """A rank of a launch raised; the message holds its traceback."""


def rank_devices(device: str | torch.device, world_size: int) -> list[torch.device]:
    """Each rank's device: ``cuda:r`` for a bare 'cuda', else the one given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return [torch.device("cuda", r) for r in range(world_size)]
    return [device] * world_size


def resolve_backend(devices: Sequence[torch.device], backend: str | None) -> str:
    """The backend the caller named, or NCCL on CUDA and gloo on the CPU;
    NCCL with two ranks on one card raises."""
    cuda = devices[0].type == "cuda"
    backend = backend or ("nccl" if cuda else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}; expected 'nccl' or 'gloo'")
    if backend == "nccl":
        if not cuda:
            raise ValueError("the NCCL backend needs CUDA devices")
        if len(set(devices)) != len(devices):
            raise ValueError("NCCL takes one card a rank; ranks that share a card need backend='gloo'")
    return backend


def prebuild(devices: Sequence[torch.device], kernels: Sequence[str], native_runtime: bool) -> None:
    """Build in this process what the ranks will load: the ``csrc`` kernels
    (on CUDA only; the CPU takes their plain versions) and the native input
    runtime."""
    if devices[0].type == "cuda":
        for name in kernels:
            _build.build(name)
    if native_runtime:
        from iterative_inference_segm_tpu_torch.data.native_loader import NATIVE_SRC

        _build.build_host(NATIVE_SRC, "input_runtime")


_CALL = "call.pkl"  # (fn, args), in the launch's temporary directory


def _record_failure(tmp: Path, rank: int) -> None:
    """When and how this rank failed, for the parent to find the first."""
    with open(tmp / f"error-{rank}.pkl", "wb") as f:
        pickle.dump((time.time(), traceback.format_exc()), f)


def _rank_main(rank, spec: MeshSpec, devices, backend, tmp: str, build_dir: str, threads: int):
    _build.BUILD_DIR = Path(build_dir)
    device = devices[rank]
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(max(1, min(threads, (os.cpu_count() or 1) // len(devices))))
    tmp = Path(tmp)
    with open(tmp / f"stdout-{rank}", "w") as out:
        sys.stdout = out
        try:
            with open(tmp / _CALL, "rb") as f:
                fn, args = pickle.load(f)
        except BaseException:
            _record_failure(tmp, rank)
            raise
        dist.init_process_group(backend, init_method=f"file://{tmp / 'store'}", rank=rank,
                                world_size=spec.size, timeout=COLLECTIVE_TIMEOUT)
        try:
            mesh = make_mesh(spec.axis_names, spec.axis_sizes, device_type=device.type)
            result = fn(mesh, device, *args)
        except BaseException:
            _record_failure(tmp, rank)
            raise
        finally:
            dist.destroy_process_group()
            sys.stdout.flush()
    with open(tmp / f"result-{rank}.pkl", "wb") as f:
        pickle.dump(result, f)


def launch_ranks(
    fn: Callable,
    *args,
    mesh: MeshSpec,
    device: str | torch.device = "cuda",
    backend: str | None = None,
    kernels: Sequence[str] = (),
    native_runtime: bool = False,
) -> list:
    """Run ``fn(mesh, device, *args)`` in ``mesh.size`` ranks; returns every
    rank's result, by rank. ``fn`` and ``args`` must pickle (``fn`` a
    module-level function)."""
    devices = rank_devices(device, mesh.size)
    if devices[0].type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA card here")
    backend = resolve_backend(devices, backend)
    prebuild(devices, kernels, native_runtime)
    with tempfile.TemporaryDirectory(prefix="launch-") as tmp:
        with open(Path(tmp) / _CALL, "wb") as f:
            pickle.dump((fn, args), f)
        ctx = mp.start_processes(
            _rank_main, args=(mesh, devices, backend, tmp, str(_build.BUILD_DIR), torch.get_num_threads()),
            nprocs=mesh.size, join=False, start_method="spawn",
        )
        try:
            while not ctx.join():
                pass
        except ProcessException as e:  # a rank raised, or died
            raise RankError(_first_failure(Path(tmp)) or str(e)) from e
        finally:
            out = Path(tmp) / "stdout-0"
            if out.exists():
                sys.stdout.write(out.read_text())
                sys.stdout.flush()
        results = []
        for r in range(mesh.size):
            with open(Path(tmp) / f"result-{r}.pkl", "rb") as f:
                results.append(pickle.load(f))
    return results


def _first_failure(tmp: Path) -> str | None:
    errors = []
    for path in tmp.glob("error-*.pkl"):
        with open(path, "rb") as f:
            stamp, tb = pickle.load(f)
        errors.append((stamp, int(path.stem.split("-")[1]), tb))
    if not errors:
        return None
    _, rank, tb = min(errors)
    return f"rank {rank} failed first:\n{tb}"


def launch(fn: Callable, *args, **kwargs):
    """``launch_ranks``, returning rank 0's result."""
    return launch_ranks(fn, *args, **kwargs)[0]
