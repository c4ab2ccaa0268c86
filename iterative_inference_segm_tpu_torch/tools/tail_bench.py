"""The refinement-tail kernel (``refine_tail``, ``csrc/refine_tail.cu``) on
the card at the shapes the main path hands it, timed against its bound.

``record_main_path`` runs one image through the flagship half engine and one
through the general engine (full width: FCN-8 fc 4096, C=11, 360x480, bf16,
one step each) and records, through ``refine_tail.layouts``, the shapes,
strides, dtypes and row-packing of the maps the kernel is given at each of
its three call sites:

* ``step``    -- the half engine's folded per-step tail (``inference/fused.py``,
                 ``halfres_refinement_scan_folded``), batch 8 at 180x240;
* ``rect``    -- its full-resolution rectification, the one call with labels
                 (``_rectify``), batch 8 at 360x480;
* ``general`` -- the general engine's score step (``inference/iterative.py``),
                 batch 4 at 360x480, bf16 logits beside the f32 iterate.

``main_path_cases`` makes seeded random maps of those shapes and layouts in
bf16 and f32, and ``time_case`` times the kernel on them warm (back to back)
and cold (the 50 MB L2 flushed before each launch by reading a 128 MB
buffer, CUDA events around each launch: the median, least and most of the
launches), each time after queueing the work behind a device-side sleep, so
that the host's launch rate does not enter the device time; ``host_ahead``
says whether the host had queued all of it before the sleep ended. It also
prints the cold time after a flush by writing the buffer: the ~50 MB of
dirty lines that leaves in L2 are written back while the kernel runs, and
that traffic is charged to the kernel. ``bound`` is the least time the card
could take for the same function: each input byte read once (u only where
it is cropped to), each output byte written once, at the published 3.35
TB/s of an H100 SXM, or its f32 operations at 67 TFLOP/s, whichever is
larger. The share of the bound is taken against the cold time; the warm
loop's inputs may sit in L2 and read above the memory bound.

Run on a card (every case is timed in ``ROUNDS`` rounds, fresh maps each
round, to show the spread within one process):

    python -m iterative_inference_segm_tpu_torch.tools.tail_bench
"""

from __future__ import annotations

import dataclasses
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass

import torch

from iterative_inference_segm_tpu_torch.ops import refine_tail as rt

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
F32_FLOPS_PER_S = 67e12  # f32 outside the tensor cores, the same sheet
FLUSH_BYTES = 128 * 2**20  # read (or written) between cold launches: over twice the 50 MB L2
SLEEP_CYCLES = 40_000_000  # ~20 ms at 1.98 GHz: the host queues a timed loop behind it
ITERS = 30
ROUNDS = 3
SITE_BATCH = {"step": 8, "rect": 8, "general": 4}
EPS = 0.1


@dataclass
class Case:
    name: str
    u: torch.Tensor
    y: torch.Tensor
    v: torch.Tensor | None = None
    w: torch.Tensor | None = None
    b: torch.Tensor | None = None
    with_labels: bool = False

    def kernel(self):
        return rt.refine_tail(self.u, self.y, EPS, v=self.v, w=self.w, b=self.b, with_labels=self.with_labels)

    def plain(self):
        return rt.refine_tail_reference(self.u, self.y, EPS, v=self.v, w=self.w, b=self.b,
                                        with_labels=self.with_labels)


def layouts_of(fn) -> list[dict]:
    """Calls ``fn`` and returns the layouts of the maps of every
    ``refine_tail`` call it made, in order."""
    rt.refine_tail.layouts = []
    try:
        fn()
        return rt.refine_tail.layouts
    finally:
        rt.refine_tail.layouts = None


def record_layouts(fn) -> list[dict]:
    """The distinct records of the ``refine_tail`` calls ``fn`` makes, in
    the order first made."""
    out = []
    for rec in layouts_of(fn):
        if rec not in out:
            out.append(rec)
    return out


def cases_at(dev, recs: list[dict], batch: int, seed: int = 0, prefix: str = "") -> list[Case]:
    """Seeded maps at each recorded call's shapes and dtypes
    (``record_layouts``) with batch ``batch``, given the terms the call was
    given (``v``, ``w``, ``b``) and its labels flag; drawn on ``dev`` and
    row-packed, as the engines lay them out."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def draw(shape, dtype, scale=3.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    cases = []
    for rec in recs:
        (_, h, wd, c), (_, hu, wu, _) = rec["y"]["shape"], rec["u"]["shape"]
        dt = {k: getattr(torch, rec[k]["dtype"]) for k in ("u", "v", "y") if rec[k] is not None}
        y = torch.softmax(draw((batch, h, wd, c), torch.float32), -1).to(dt["y"])
        u = draw((batch, hu, wu, c), dt["u"])
        v = draw((batch, h, wd, c), dt["v"]) if rec["v"] is not None else None
        w = draw((c, c), torch.float32, 0.3) if rec["w"] else None
        b = draw((c,), torch.float32, 0.5) if rec["b"] else None
        site = "rect" if rec["labels"] else "step"
        cases.append(Case(f"{prefix}{site} b{batch} {rec['y']['dtype']}", u, y, v, w, b, rec["labels"]))
    return cases


def full_width_models(dev):
    """FCN-8 (fc 4096), the flagship DAE (stem 1, depth 3) and the general
    engine's DAE (stem 0, depth 4), random from fixed seeds."""
    from iterative_inference_segm_tpu_torch.models.dae import DAE_H_CHANNELS, init_dae
    from iterative_inference_segm_tpu_torch.models.fcn8 import init_fcn8

    fcn = init_fcn8(torch.Generator().manual_seed(0), n_classes=11, fc_channels=4096, device=dev)
    h = {"pool4": DAE_H_CHANNELS["pool4"]}
    flag = init_dae(torch.Generator().manual_seed(1), n_classes=11, h_specs=h, depth=3, stem_pool=1,
                    tail="full", device=dev)
    gen = init_dae(torch.Generator().manual_seed(11), n_classes=11, h_specs=h, depth=4, stem_pool=0,
                   device=dev)
    return fcn, flag, gen


def record_main_path(dev, fcn, flag_dae, gen_dae, hw=(360, 480)) -> dict:
    """One image of ``hw`` through each engine (bf16, one step); the layouts
    seen at the three call sites. With one step the flagship calls the
    kernel twice, once for the step and once, with labels, for the
    rectification, and the general engine once; anything else raises."""
    from iterative_inference_segm_tpu_torch.inference.fused import flagship_forward_fn
    from iterative_inference_segm_tpu_torch.inference.iterative import make_refiner
    from iterative_inference_segm_tpu_torch.models.dae import dae_apply
    from iterative_inference_segm_tpu_torch.models.fcn8 import fcn8_apply

    x = torch.randn((1, *hw, 3), generator=torch.Generator().manual_seed(2)).to(dev)
    with torch.inference_mode():
        flag = layouts_of(lambda: flagship_forward_fn(num_steps=1, eps=EPS, depth=3, compute_dtype=torch.bfloat16,
                                                      with_labels=True)(fcn, flag_dae, x))
        gen = layouts_of(lambda: make_refiner(fcn8_apply, dae_apply, fcn, gen_dae, eps=EPS, num_steps=1,
                                              compute_dtype=torch.bfloat16, dae_kwargs={"depth": 4})(x))
    steps = [r for r in flag if not r["labels"]]
    rects = [r for r in flag if r["labels"]]
    if (len(steps), len(rects), len(gen)) != (1, 1, 1):
        raise RuntimeError(f"expected one step, one rectification and one general step; the engines made "
                           f"{len(steps)}, {len(rects)} and {len(gen)} refine_tail calls")
    return {"step": steps[0], "rect": rects[0], "general": gen[0]}


def main_path_cases(dev, seen: dict, seed: int = 0) -> list[Case]:
    """Seeded maps at each site's shapes (``cases_at``) at ``SITE_BATCH``,
    in bf16 and f32 (the general engine's u in bf16 beside an f32 y, as it
    runs, and all-f32 as before), named ``<site>_<bf16|f32>``."""
    cases = []
    for site in ("step", "rect", "general"):
        rec = seen[site]
        for tag, dt_y, dt_u in (("bf16", "bfloat16", "bfloat16"), ("f32", "float32", "float32")):
            if site == "general" and tag == "bf16":
                dt_y = "float32"  # the engine's iterate stays f32; its logits are bf16
            as_run = {**rec, "u": {**rec["u"], "dtype": dt_u}, "y": {**rec["y"], "dtype": dt_y},
                      "v": rec["v"] and {**rec["v"], "dtype": dt_y}}
            (case,) = cases_at(dev, [as_run], SITE_BATCH[site], seed=seed + len(cases))
            cases.append(dataclasses.replace(case, name=f"{site}_{tag}"))
    return cases


def bound(case: Case) -> dict:
    """Bytes and f32 operations the function needs on these inputs, and the
    least time they take on the card: {'bytes', 'flops', 'bound_ms',
    'bound_by'}."""
    bsz, h, wd, c = case.y.shape
    px = bsz * h * wd
    nbytes = px * c * (case.u.element_size() + 2 * case.y.element_size())  # u (cropped), y; y' out
    if case.v is not None:
        nbytes += px * c * case.v.element_size()
    if case.with_labels:
        nbytes += px * 4
    # per element: the adds of u, v (and b), max, subtract, exp, sum, divide,
    # the blend's two multiplies and add; 2C more for y.W
    per = 8 + (case.v is not None) + (case.b is not None) + (2 * c if case.w is not None else 0)
    return {"bytes": nbytes, "flops": px * c * per, **bound_ms(nbytes, px * c * per)}


def bound_ms(nbytes: float, flops: float) -> dict:
    """The least time the card could take: the bytes over its memory rate or
    the f32 operations over its f32 rate, whichever is larger, and which."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def device_times(fn, iters: int = ITERS, flush: torch.Tensor | None = None,
                 write: bool = False) -> tuple[list[float], bool]:
    """Device times of ``fn`` by CUDA events, with the calls queued behind a
    device-side sleep. Without ``flush``: ``iters`` calls back to back,
    events around the loop, and the one mean. With it: the buffer is read
    (or, with ``write``, written) before each call, events bracket each call
    alone, and each call's time. Second: whether the host had queued every
    call before the sleep ended, so that no call waited on the host."""
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(iters if flush is not None else 1)]
    slept = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    t0 = time.perf_counter()
    slept[0].record()
    torch.cuda._sleep(SLEEP_CYCLES)
    slept[1].record()
    if flush is None:
        ev[0][0].record()
        for _ in range(iters):
            fn()
        ev[0][1].record()
    else:
        for i, (start, end) in enumerate(ev):
            if write:
                flush.fill_(i & 0xFF)
            else:
                flush.max()
            start.record()
            fn()
            end.record()
    queued_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    ahead = queued_ms < slept[0].elapsed_time(slept[1])
    if flush is None:
        return [ev[0][0].elapsed_time(ev[0][1]) / iters], ahead
    return [s.elapsed_time(e) for s, e in ev], ahead


def flush_buffer(dev) -> torch.Tensor:
    """The L2 flush buffer. Writing it a few hundred times first brings the
    card's clocks up before the first timing, and reading it once loads the
    reduction's kernel, whose first call would otherwise stall the host
    inside the first cold loop."""
    buf = torch.zeros(FLUSH_BYTES, dtype=torch.uint8, device=dev)
    for i in range(200):
        buf.fill_(i & 0xFF)
    buf.max()
    torch.cuda.synchronize()
    return buf


def time_case(case: Case, flush: torch.Tensor) -> dict:
    """Warm ms; cold ms after a read flush (median, least, most) and after a
    write flush (median); plain ms; the bound and the cold share of it; the
    cold time of a plain copy of y (one PyTorch pass over 2|y| bytes: what
    a simple pass reaches at this size); and ``host_ahead``, whether every
    timed loop was queued before its sleep ended."""
    dst = torch.empty_like(case.y)
    warm, ahead_warm = device_times(case.kernel)
    cold, ahead_cold = device_times(case.kernel, flush=flush)
    cold_write, ahead_write = device_times(case.kernel, flush=flush, write=True)
    plain, ahead_plain = device_times(case.plain, iters=10)
    copy, ahead_copy = device_times(lambda: dst.copy_(case.y), flush=flush)
    out = {"warm_ms": warm[0], "cold_ms": statistics.median(cold), "cold_min_ms": min(cold),
           "cold_max_ms": max(cold), "cold_write_ms": statistics.median(cold_write), "plain_ms": plain[0],
           "copy_ms": statistics.median(copy), "copy_bytes": 2 * case.y.numel() * case.y.element_size(),
           "host_ahead": all((ahead_warm, ahead_cold, ahead_write, ahead_plain, ahead_copy)), **bound(case)}
    out["share"] = out["bound_ms"] / out["cold_ms"]
    out["warm_share"] = out["bound_ms"] / out["warm_ms"]
    return out


def report(t: dict) -> str:
    """One case's timings as a line."""
    return (f"warm {t['warm_ms']:.4f} ms, cold {t['cold_ms']:.4f} ms (launches {t['cold_min_ms']:.4f}.."
            f"{t['cold_max_ms']:.4f}; after a write flush {t['cold_write_ms']:.4f}), plain {t['plain_ms']:.4f} ms; "
            f"{t['bytes'] / 1e6:.1f} MB, bound {t['bound_ms']:.4f} ms ({t['bound_by']}), "
            f"{t['bytes'] / t['cold_ms'] / 1e9:.2f} TB/s cold; a copy of y {t['copy_ms']:.4f} ms cold, "
            f"{t['copy_bytes'] / t['copy_ms'] / 1e9:.2f} TB/s; share of the bound {t['share']:.1%} cold "
            f"({t['warm_share']:.1%} warm, L2 may serve it); host ahead {t['host_ahead']}")


def sm_clock() -> str:
    """The card's SM clock and power draw now, as nvidia-smi reads them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def main() -> int:
    if not torch.cuda.is_available():
        print("tail_bench: no CUDA device; the kernel runs on the card only", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(f"{torch.cuda.get_device_name(0)}: refine_tail at the main path's shapes", flush=True)
    seen = record_main_path(dev, *full_width_models(dev))
    for site, rec in seen.items():
        print(f"layout {site}: {rec}", flush=True)
    flush = flush_buffer(dev)
    for r in range(ROUNDS):
        for case in main_path_cases(dev, seen, seed=r):
            clock = sm_clock()
            print(f"round {r} {case.name:12s} y={tuple(case.y.shape)} u={tuple(case.u.shape)} "
                  f"{str(case.u.dtype)[6:]}: {report(time_case(case, flush))}; clocks.sm, power {clock}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
