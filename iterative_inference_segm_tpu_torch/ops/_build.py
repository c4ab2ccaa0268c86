"""Builds the package's native sources at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled for
Hopper (``sm_90a``) into ``build/lib<name>-<hash>.so`` inside the package
(listed in ``.gitignore``), then loaded with ``ctypes``. The hash covers the
source and the flags, so an edited source is rebuilt and a stale library is
never loaded. ``build_host`` does the same for a host C++ source with
``g++`` (the native input runtime); its hash also covers the host CPU, since
it compiles with ``-march=native``. Nothing here runs at import time: the
first call to ``load`` builds, and needs ``nvcc`` (found through
``CUDA_HOME`` or ``PATH``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# native/Makefile's flags, warnings aside
HOST_CXX = "g++"
HOST_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared")
HOST_LIBS = ("-lpthread",)

_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
        if nvcc.is_file():
            return str(nvcc)
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return nvcc


def _compile(compiler: str, flags: tuple[str, ...], src: Path, name: str, *, libs: tuple[str, ...] = (),
             key: bytes = b"") -> Path:
    """``compiler flags -o build/lib<name>-<hash>.so src libs`` unless that
    file exists; the hash covers the source, the flags and ``key``. The
    compiler's stderr is kept beside the library as ``.log``; a failed
    build raises with it."""
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags + libs).encode() + key).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [compiler, *flags, "-o", str(tmp), str(src), *libs]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    except OSError as e:
        raise RuntimeError(f"{compiler} could not run for {src}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{Path(compiler).name} failed ({proc.returncode}) for {src}:\n{proc.stderr}")
    lib.with_suffix(".log").write_text(proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent build never loads a partial file
    return lib


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a library of the same source and
    flags exists; returns its path. The compiler's register/spill report
    (``-Xptxas -v``) is kept beside it as ``.log``."""
    return _compile(find_nvcc(), NVCC_FLAGS, CSRC_DIR / f"{name}.cu", name)


def _host_cpu() -> bytes:
    """What ``-march=native`` compiles for: the CPU's model and flags."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return os.uname().machine.encode()
    keep = [ln for ln in lines if ln.startswith(("model name", "flags"))]
    return "\n".join(dict.fromkeys(keep)).encode()


def build_host(src: Path, name: str) -> Path:
    """Compile the host C++ source ``src`` with ``g++`` and ``HOST_FLAGS``
    into ``build/lib<name>-<hash>.so`` unless it exists; returns its path."""
    return _compile(HOST_CXX, HOST_FLAGS, Path(src), name, libs=HOST_LIBS, key=_host_cpu())


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; cached per process."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build(name)))
    return _loaded[name]
