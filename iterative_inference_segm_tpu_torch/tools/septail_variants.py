"""Where the time of ``septail_step``'s tiled form goes, on the card.

Builds variants of ``csrc/septail_step.cu``, one edit each, beside the
kernel as it is, and times all of them cold (the L2 flushed before each
launch, ``tail_bench.device_times``) at the bench step (batch 128, C = 11,
180 x 240 half-resolution positions, s in NHWC), in turns (each variant in
the order below, then again in reverse), in bf16 and f32:

    ring         the kernel as it is: two stages, the next tile's copies
                 landing while the block computes the current one
    copies_only  the copies alone (each tile's arithmetic skipped)
    math_only    the arithmetic alone (no copies: the stages hold whatever
                 shared memory held)

Only ``ring`` computes the step; it is held to the plain version
(``septail_step_reference``) before it is timed. Run from the
repository root on a machine with the card:

    python -m iterative_inference_segm_tpu_torch.tools.septail_variants
"""

from __future__ import annotations

import ctypes
import statistics
import sys

import torch

from iterative_inference_segm_tpu_torch.ops import _build
from iterative_inference_segm_tpu_torch.ops import septail_step as st
from iterative_inference_segm_tpu_torch.tools import tail_bench
from iterative_inference_segm_tpu_torch.tools.timing import nvidia_smi

SHAPE = (128, 11, 180, 240)  # B, C, Hh, Wh: the bench step
EPS = 0.1
TOL = {torch.float32: 1e-5, torch.bfloat16: 2.0**-8}  # tests/test_torch_septail_step.py's

_MATH = "  // The deconv and the stencil, a class at a time, for the four phases."
_STAGE = "  using R = YRow<T>;\n  constexpr int V = vec_of<T>();\n  const Tile tl = tile_of(t, p.Hh, p.Wh);\n"
EDITS = {  # variant: (text of the source, its replacement)
    "ring": None,
    "copies_only": (_MATH, "  if (p.eps != 0.f) {\n    __syncthreads();\n    continue;\n  }\n" + _MATH),
    "math_only": (_STAGE, "  if (p.eps != 0.f) {\n    cp_async_commit();\n    return;\n  }\n" + _STAGE),
}


def variant_sources() -> dict[str, str]:
    """Each variant's source: the kernel's, with its one edit."""
    src = (_build.CSRC_DIR / "septail_step.cu").read_text()
    out = {}
    for name, edit in EDITS.items():
        if edit is not None and src.count(edit[0]) != 1:
            raise RuntimeError(f"septail_variants: {name}'s anchor is not in csrc/septail_step.cu once")
        out[name] = src if edit is None else src.replace(*edit)
    return out


def build_variants() -> dict[str, ctypes.CDLL]:
    """Each variant compiled (``_build``'s flags) and loaded."""
    _build.BUILD_DIR.mkdir(exist_ok=True)
    libs = {}
    for name, text in variant_sources().items():
        src = _build.BUILD_DIR / f"septail_{name}.cu"
        src.write_text(text)
        lib = ctypes.CDLL(str(_build._compile(_build.find_nvcc(), _build.NVCC_FLAGS, src, f"septail_{name}")))
        lib.septail_step_launch.argtypes = st._ARGTYPES
        lib.septail_step_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def launcher(lib, y_ph, s, w):
    """A call of ``lib``'s kernel on these inputs, as ``septail_step`` makes it."""
    y_ph, y_strides, s, s_strides = st._kernel_layouts(y_ph, s)
    b, _, _, c, hh, wh = y_ph.shape
    out = torch.empty_like(y_ph)
    weights = [t.float().contiguous() for t in w]
    args = (st._DTYPE_CODE[y_ph.dtype], b, c, hh, wh, y_ph.data_ptr(), *y_strides, s.data_ptr(), *s_strides,
            *(t.data_ptr() for t in weights), EPS, out.data_ptr(), torch.cuda.current_stream().cuda_stream)

    def call():
        st._raise_on(lib.septail_step_launch(*args), f"variant {lib._name}")
        return out

    call.keep = (y_ph, s, weights)  # the pointers' tensors live as long as the call
    return call


def main() -> int:
    if not torch.cuda.is_available():
        print("septail_variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = nvidia_smi()
    libs = build_variants()
    flush = tail_bench.flush_buffer(dev)
    b, c, hh, wh = SHAPE
    for dtype in (torch.bfloat16, torch.float32):
        gen = torch.Generator(dev).manual_seed(0)
        y_ph = torch.softmax(torch.randn((b, 2, 2, c, hh, wh), device=dev, generator=gen) * 2, dim=3).to(dtype)
        s = torch.randn((b, hh, wh, c), device=dev, generator=gen).to(dtype)
        w = [(torch.randn(shape, device=dev, generator=gen) * 0.5).to(dtype)
             for shape in ((4, 4, c), (3, 3, c), (c, c), (c,))]
        calls = {name: launcher(lib, y_ph, s, w) for name, lib in libs.items()}
        err = (calls["ring"]().float() - st.septail_step_reference(y_ph, s, *w, EPS).float()).abs().max().item()
        if not err <= TOL[dtype]:
            raise AssertionError(f"septail_variants: the kernel in {dtype}: max abs err {err:.3e}")
        cold = {name: [] for name in calls}
        for name in [*calls, *reversed(calls)]:
            cold[name].append(statistics.median(tail_bench.device_times(calls[name], flush=flush)[0]))
        print(f"{str(dtype)[6:]} at {SHAPE}: " + ", ".join(
            f"{name} {' / '.join(f'{ms:.4f}' for ms in t)} ms" for name, t in cold.items()) + f" cold; {smi}",
            flush=True)
        del y_ph, s, w, calls
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
