"""Pipeline-level probes: the refinement loop unrolled, a bf16 carry, and the
backbone's blocks: the twin of the repo's ``tools/scan_variants_probe.py``
on the card.

FCN-8 / VGG16 fc 4096, C = 11, batch 128, 360x480, bf16 compute, the
stem-1 depth-3 DAE with the pool4 tap, weights from seeded generators. The
JAX probe's rows, with its labels:

  - the pipeline (the FCN, then K = 5 score steps of the general engine,
    then the argmax) with an f32 and a bf16 carry, each at ``unroll=1``
    and ``unroll=5``. The steps run the port's general engine
    (``inference.iterative.logits_refinement_scan``: each one launch of K3,
    ``ops.refine_tail``, on the DAE's logits, cast to the carry's dtype as
    the JAX probe's ``dae_apply(out_dtype=...)`` takes the softmax at it;
    the blend's eps is the carry's ``0.1``). ``unroll`` has no PyTorch
    counterpart: the loop is Python's. The ``unroll=1`` rows run the loop
    as it is; the ``unroll=5`` rows run the same pipeline captured once in
    a ``torch.cuda.CUDAGraph`` and replayed (``Captured``), so that the
    host issues one launch a call. On the CPU those rows run uncaptured;
  - the VGG prefixes through conv1_2, pool1, conv2_x, conv3_x, conv4_x and
    conv5_x + pool5 (``models.fcn8._VGG``), each followed by its derived
    "stage marginal" line (its time less the previous prefix's), then the
    VGG with fc6 and fc7 and its "fc6+fc7 marginal".

K3's launches are counted by its wrapper as the host issues them, so a
capture would count launches that do not run and a replay none:
``Captured`` takes the capture's count back and adds it at each replay.
After each captured row, one more replay is held to one uncaptured run of
the loop (a ``check`` line: the share of pixels whose argmax differs).
Each row's scalar is the JAX row's: the sum of the argmax, or the f32 sum
of the prefix's output. Timing and lines as ``tools/perf_probe.py``.

Usage (on the card):
    python -m iterative_inference_segm_tpu_torch.tools.scan_variants_probe [--iters 8]
"""

from __future__ import annotations

import sys

import torch

from iterative_inference_segm_tpu_torch.tools.timing import ProbeRun, bf16, probe_parser

B, H, W, C = 128, 360, 480, 11
FC_CHANNELS = 4096
EPS = 0.1
K = 5
CAPTURE_TOL = 1e-3  # the share of pixels whose argmax a replay may move (the same kernels: expected 0)
MARKS = ((2, "conv1_1..1_2"), (3, "+pool1"), (5, "+conv2_x"), (9, "+conv3_x+pools"), (13, "+conv4_x"),
         (17, "+conv5_x+pool5"))


class Captured:
    """``fn()`` captured in one ``torch.cuda.CUDAGraph`` and replayed. The
    first call runs ``fn`` uncaptured on a side stream (it builds the
    kernels and lets cuDNN pick its algorithms, none of which may happen in
    a capture), then captures it and returns the uncaptured result; each
    later call replays the graph and returns the captured outputs. K3's
    launch count follows what runs: the capture's count is taken back, and
    each replay adds it. On a CPU device, ``fn`` itself."""

    def __init__(self, fn, device):
        self.fn, self.device = fn, torch.device(device)
        self.graph = self.out = None
        self.k3 = 0

    def __call__(self):
        if self.device.type != "cuda":
            return self.fn()
        from iterative_inference_segm_tpu_torch.ops.refine_tail import refine_tail

        if self.graph is None:
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                warm = self.fn()
            torch.cuda.current_stream(self.device).wait_stream(side)
            torch.cuda.synchronize(self.device)
            before = refine_tail.launches
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.out = self.fn()
            self.k3 = refine_tail.launches - before
            refine_tail.launches = before
            return warm
        self.graph.replay()
        refine_tail.launches += self.k3
        return self.out


def pipeline(fcn: dict, dae: dict, x: torch.Tensor, *, bf16_carry: bool, compute_dtype=torch.bfloat16,
             steps: int = K) -> torch.Tensor:
    """The JAX probe's ``pipe`` up to its argmax: FCN-8 (pool4 tap), K
    score steps of the general engine over the DAE's logits at the carry's
    dtype, from y0 at that dtype; returns y_K."""
    from iterative_inference_segm_tpu_torch.inference.iterative import logits_refinement_scan
    from iterative_inference_segm_tpu_torch.models.dae import dae_logits
    from iterative_inference_segm_tpu_torch.models.fcn8 import fcn8_apply

    cd = compute_dtype
    carry = torch.bfloat16 if bf16_carry else torch.float32
    y0, h = fcn8_apply(fcn, x, return_features=("pool4",), compute_dtype=cd)
    return logits_refinement_scan(lambda y: dae_logits(dae, y, h, depth=3, compute_dtype=cd).to(carry),
                                  y0.to(carry), eps=bf16(EPS) if bf16_carry else EPS, num_steps=steps, mode="score")


def pipeline_cases(fcn: dict, dae: dict, x: torch.Tensor, *, compute_dtype=torch.bfloat16):
    """``[(label, fn)]`` of the four pipeline rows; ``fn()`` returns the
    argmax map (the ``unroll=5`` rows' ``fn`` a ``Captured``)."""
    def pipe(bf16_carry):
        return lambda: (torch.argmax(pipeline(fcn, dae, x, bf16_carry=bf16_carry, compute_dtype=compute_dtype), -1),)

    return [
        ("K=5 unroll=1 f32 carry (current)", pipe(False)),
        ("K=5 unroll=5 f32 carry", Captured(pipe(False), x.device)),
        ("K=5 unroll=1 bf16 carry", pipe(True)),
        ("K=5 unroll=5 bf16 carry", Captured(pipe(True), x.device)),
    ]


def vgg(fcn: dict, x: torch.Tensor, n: int, compute_dtype) -> torch.Tensor:
    """The first ``n`` items of the VGG stack (``models.fcn8._VGG``)."""
    from iterative_inference_segm_tpu_torch.models.fcn8 import _VGG
    from iterative_inference_segm_tpu_torch.ops.conv import conv2d, max_pool

    h = x.to(compute_dtype)
    for item in _VGG[:n]:
        if item == "P":
            h = max_pool(h, window=2, stride=2, ceil_mode=True)
        else:
            p = fcn[item[0]]
            h = torch.relu(conv2d(h, p["w"], p["b"], padding="SAME"))
    return h


def backbone_cases(fcn: dict, x: torch.Tensor, *, compute_dtype=torch.bfloat16):
    """``[(label, fn)]`` of the VGG prefixes, then the VGG with fc6 and fc7."""
    from iterative_inference_segm_tpu_torch.models.fcn8 import _VGG
    from iterative_inference_segm_tpu_torch.ops.conv import conv2d

    def fc_part():
        h = vgg(fcn, x, len(_VGG), compute_dtype)
        for name in ("fc6", "fc7"):
            h = torch.relu(conv2d(h, fcn[name]["w"], fcn[name]["b"], padding="SAME"))
        return (h,)

    rows = [(f"VGG prefix {n:2d} ({lbl})", lambda n=n: (vgg(fcn, x, n, compute_dtype),)) for n, lbl in MARKS]
    return rows + [("VGG + fc6 + fc7", fc_part)]


def main(argv=None) -> int:
    from iterative_inference_segm_tpu_torch.models.dae import DAE_H_CHANNELS, init_dae
    from iterative_inference_segm_tpu_torch.models.fcn8 import init_fcn8
    from iterative_inference_segm_tpu_torch.tools.timing import total

    args = probe_parser(__doc__, iters=8, repeats=2).parse_args(argv)
    run = ProbeRun("scan_variants_probe", args)
    dev, cd = run.device, torch.bfloat16
    fcn = init_fcn8(torch.Generator().manual_seed(0), n_classes=C, fc_channels=FC_CHANNELS, device=dev)
    dae = init_dae(torch.Generator().manual_seed(1), n_classes=C, h_specs={"pool4": DAE_H_CHANNELS["pool4"]}, depth=3,
                   stem_pool=1, device=dev)
    x = run.normal((B, H, W, 3), 2)
    with torch.inference_mode():
        rows = pipeline_cases(fcn, dae, x, compute_dtype=cd)
        while rows:  # a captured row's graph and its pool go before the next row
            label, fn = rows.pop(0)
            run.time(label, fn, B)
            if isinstance(fn, Captured):  # its replay against the loop it captured
                (got,), (want,) = fn(), fn.fn()
                off = (got != want).float().mean().item()
                run.check(f"{label}: share of the argmax off the uncaptured loop's", off, CAPTURE_TOL)
            del fn
        prev = 0.0
        for label, fn in backbone_cases(fcn, x, compute_dtype=cd):
            t = run.time(label, fn, B, total)
            run.derived("fc6+fc7 marginal" if label == "VGG + fc6 + fc7" else "stage marginal", t - prev, B,
                        after=label)
            prev = t
    return 0


if __name__ == "__main__":
    sys.exit(main())
