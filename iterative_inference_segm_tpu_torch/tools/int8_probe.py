"""Does the card run an int8 convolution at twice the bf16 rate? The twin of
the repo's ``tools/int8_probe.py`` on the card.

The backbone's conv4_2 shape: a 3x3 512 -> 512 SAME conv on (128, 45, 60,
512), 1.63 TFLOP, in bf16 and in int8 -> int32, and an 8192x2048x2048 dot
in each; inputs uniform integers in [-127, 127) from seeded generators
(the bf16 rows take the same integers, exact in bf16). The H100's dense
peaks are 989 TFLOP/s in bf16 and 1979 TOP/s in int8; each line carries
its ``tflops`` and ``peak_share`` against the peak of its type.

``F.conv2d`` has no int8 path on CUDA, so the int8 conv row is one
``torch._int_mm`` GEMM over the unfolded 3x3 patches: the input padded by
one pixel and its nine shifted windows concatenated on the channels, a
(345600, 4608) int8 matrix, times the (4608, 512) kernel (held as a
(512, 4608) row-major matrix and passed transposed, the layout cuBLAS's
int8 GEMM takes), accumulated in int32. Sums of 4608 products of magnitude
at most 127^2 fit in int32 exactly, so the result is the exact
convolution. The unfolding is part of the row. Beside it, the same GEMM in
bf16 (``conv 3x3 ... bf16 as the int8 row's im2col GEMM``), so that one
ratio compares one formulation; the JAX probe's ratio (cuDNN's bf16 conv
against the int8 row) is kept as its derived line; and both GEMMs alone on
patches unfolded beforehand, which splits each row into its unfolding and
its GEMM. The dots are
``torch.mm`` in bf16 (bf16 out, f32 accumulation) and ``torch._int_mm``.
The JAX probe prints "FAILED" for a row that does not compile; here every
row runs, and nothing is caught. On the CPU ``torch._int_mm`` runs too,
with the same int32 result. Each row's scalar is the JAX row's: the f32 sum
of its output. Timing and lines as ``tools/perf_probe.py``.

Usage (on the card):
    python -m iterative_inference_segm_tpu_torch.tools.int8_probe [--iters 10]
"""

from __future__ import annotations

import sys

import torch

from iterative_inference_segm_tpu_torch.tools.timing import ProbeRun, probe_parser

B, H, W, CH = 128, 45, 60, 512
DOT = (8192, 2048, 2048)  # (N, K, M)
PEAK_TFLOPS = {"bf16": 989.0, "int8": 1979.0}  # H100 SXM dense, at its full 700 W


def unfold3x3(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B*H*W, 9*C): each pixel's 3x3 SAME neighbourhood,
    zero-padded, in (dy, dx, c) order; by padding and slicing, for any
    dtype."""
    b, h, w, c = x.shape
    xp = torch.zeros((b, h + 2, w + 2, c), dtype=x.dtype, device=x.device)
    xp[:, 1:-1, 1:-1] = x
    patches = [xp[:, dy:dy + h, dx:dx + w] for dy in range(3) for dx in range(3)]
    return torch.cat(patches, -1).reshape(b * h * w, 9 * c)


def gemm_kernel(w: torch.Tensor) -> torch.Tensor:
    """An OIHW 3x3 kernel as the (O, 9*I) matrix whose rows match
    ``unfold3x3``'s (dy, dx, c) columns."""
    o, i = int(w.shape[0]), int(w.shape[1])
    return w.permute(0, 2, 3, 1).reshape(o, 9 * i).contiguous()


def conv_int8(x8: torch.Tensor, wk8: torch.Tensor) -> torch.Tensor:
    """The 3x3 SAME conv of int8 ``x8`` (B, H, W, C) by the int8 GEMM kernel
    ``wk8`` (O, 9*C) (``gemm_kernel``): (B, H, W, O) int32."""
    b, h, w, _ = x8.shape
    return torch._int_mm(unfold3x3(x8), wk8.t()).reshape(b, h, w, -1)


def conv_gemm(x: torch.Tensor, wk: torch.Tensor) -> torch.Tensor:
    """The same GEMM in ``x``'s float dtype."""
    b, h, w, _ = x.shape
    return torch.mm(unfold3x3(x), wk.t()).reshape(b, h, w, -1)


def _labels(x8, w8, a8, bt8) -> tuple[str, ...]:
    b, h, w, c = x8.shape
    conv = f"conv 3x3 {c}->{int(w8.shape[0])} @{h}x{w}"
    dot = f"dot {int(a8.shape[0])}x{int(a8.shape[1])}x{int(bt8.shape[0])}"
    return (f"{conv} bf16", f"{conv} int8->int32", f"{conv} bf16 as the int8 row's im2col GEMM", f"{dot} bf16",
            f"{dot} int8->int32", f"{conv} int8 im2col GEMM alone (patches unfolded beforehand)",
            f"{conv} bf16 im2col GEMM alone (patches unfolded beforehand)")


def cases(x8, w8, a8, bt8):
    """``[(label, fn)]``; ``x8`` (B, H, W, C) and ``w8`` (O, C, 3, 3) int8,
    ``a8`` (N, K) and ``bt8`` (M, K) int8 (the dot's right operand
    transposed); ``fn()`` returns the row's output."""
    from iterative_inference_segm_tpu_torch.ops.conv import conv2d

    xb, wb, ab, btb = (t.to(torch.bfloat16) for t in (x8, w8, a8, bt8))
    wk8 = gemm_kernel(w8)
    wkb = wk8.to(torch.bfloat16)
    p8 = unfold3x3(x8)
    pb = p8.to(torch.bfloat16)
    return list(zip(_labels(x8, w8, a8, bt8), (
        lambda: (conv2d(xb, wb, padding="SAME"),),
        lambda: (conv_int8(x8, wk8),),
        lambda: (conv_gemm(xb, wkb),),
        lambda: (torch.mm(ab, btb.t()),),
        lambda: (torch._int_mm(a8, bt8.t()),),
        lambda: (torch._int_mm(p8, wk8.t()),),
        lambda: (torch.mm(pb, wkb.t()),),
    )))


def row_work(x8, w8, a8, bt8) -> dict:
    """{label: (operations, type)} of each row: 2 a multiply-add."""
    b, h, w, c = x8.shape
    conv = 2.0 * b * h * w * int(w8.shape[0]) * 9 * c
    dot = 2.0 * int(a8.shape[0]) * int(a8.shape[1]) * int(bt8.shape[0])
    return dict(zip(_labels(x8, w8, a8, bt8), ((conv, "bf16"), (conv, "int8"), (conv, "bf16"), (dot, "bf16"),
                                                (dot, "int8"), (conv, "int8"), (conv, "bf16"))))


def _ints(shape, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device).manual_seed(seed)
    return torch.randint(-127, 127, tuple(shape), generator=gen, device=device, dtype=torch.int8)


def main(argv=None) -> int:
    args = probe_parser(__doc__, iters=10, repeats=3).parse_args(argv)
    run = ProbeRun("int8_probe", args)
    dev = run.device
    n, k, m = DOT
    x8, w8 = _ints((B, H, W, CH), 0, dev), _ints((CH, CH, 3, 3), 1, dev)
    a8, bt8 = _ints((n, k), 0, dev), _ints((m, k), 2, dev)
    work, t = row_work(x8, w8, a8, bt8), []
    with torch.inference_mode():
        for label, fn in cases(x8, w8, a8, bt8):
            flops, kind = work[label]
            t.append(run.time(label, fn, B, rates=lambda ms, flops=flops, kind=kind: {
                "tflops": flops / ms / 1e9, "peak_share": flops / ms / 1e9 / PEAK_TFLOPS[kind], "kind": kind}))
    run.derived("int8/bf16 conv speedup", t[1], B, speedup=t[0] / t[1])
    run.derived("int8/bf16 im2col GEMM speedup", t[1], B, speedup=t[2] / t[1])
    return 0


if __name__ == "__main__":
    sys.exit(main())
