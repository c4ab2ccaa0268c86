"""``--devices`` in the CLI twins: re-enter ``main`` in one rank a device.

The JAX CLIs build a mesh over the devices of one process; the port's run
``main`` again in N ranks through ``parallel.launch``, each with the mesh
and its device, and rank 0 prints the lines. The parent builds what the
ranks will load first (``kernels`` on CUDA; the native runtime for
``--packed``).
"""

from __future__ import annotations

import sys
from typing import Callable, Sequence


def _rank(mesh, device, main: Callable, argv: list[str]) -> int:
    return main(argv, mesh=mesh, device=device)


def run_ranks(main: Callable, argv: Sequence[str] | None, spec, device: str, *, kernels: Sequence[str] = (),
              native_runtime: bool = False) -> int:
    """``main(argv, mesh=..., device=...)`` in ``spec.size`` ranks on
    ``device`` (``cuda``: one card a rank, NCCL; ``cpu``: gloo); returns
    rank 0's exit code. A rank that fails fails the run with its traceback."""
    from iterative_inference_segm_tpu_torch.parallel.launch import launch

    argv = list(sys.argv[1:] if argv is None else argv)
    return launch(_rank, main, argv, mesh=spec, device=device, kernels=kernels, native_runtime=native_runtime)


def check_device(device) -> None:
    """A CUDA device with no card raises: there is no CPU fallback."""
    import torch

    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: no CUDA card here (pass --device cpu)")
