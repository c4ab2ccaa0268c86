"""End-to-end SERVING throughput on the card: packed dataset -> native C++
input runtime -> host->device copy -> flagship refinement pipeline,
sustained (the port of the repo's ``tools/serve_bench.py``).

``tools/bench.py`` measures the pipeline on a batch resident on the card.
This tool measures the serving path the port ships:

    IIST1 file -> native decode/normalize worker threads
    (native/input_runtime.cc, ``data.native_loader.NativeDataset``)
    -> ``data.prefetch.device_prefetch`` (pinned buffers, copies on a side
    stream) -> ``flagship_forward_fn`` (FCN-8 + K-step half engine) -> an
    on-card accumulator.

Two wires (``NativeDataset.batches(raw=...)``):
  f32  the runtime normalizes; f32 images cross the link
  u8   raw bytes cross the link (4x fewer); ``normalize_image(...,
       input_scale=255)`` runs on the card

Stages (images/s), as the JAX tool's:
  producer   the native runtime's batches alone (no device work)
  transfer   the copy alone: ``to(device, non_blocking=True)`` of each
             pinned batch, ended by a synchronize so the window holds it
  compute    the pipeline alone, batch resident (bench.py's quantity)
  e2e        runtime -> device_prefetch -> pipeline over the whole file,
             the best of --epochs passes

It prints the JAX tool's progress lines and one JSON line with its keys,
plus ``device`` (the card's name and power limit). The packed file is
removed in a ``finally``.

Usage (on the card):
    python -m iterative_inference_segm_tpu_torch.tools.serve_bench [--batch 128] [--num-batches 6]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from iterative_inference_segm_tpu_torch.data.config_datasets import CAMVID
from iterative_inference_segm_tpu_torch.data.native_loader import NativeDataset, pack_dataset
from iterative_inference_segm_tpu_torch.data.pipeline import normalize_image
from iterative_inference_segm_tpu_torch.data.prefetch import device_prefetch
from iterative_inference_segm_tpu_torch.entry import flagship_params
from iterative_inference_segm_tpu_torch.inference.fused import flagship_forward_fn
from iterative_inference_segm_tpu_torch.tools.timing import chained_ms, device_stamp, synchronize


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--num-batches", type=int, default=6)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--width", type=int, default=480)
    p.add_argument("--epochs", type=int, default=3, help="timed passes over the dataset")
    p.add_argument("--n-threads", type=int, default=8)
    p.add_argument("--prefetch-depth", type=int, default=2)
    p.add_argument("--wire", choices=["f32", "u8", "both"], default="both")
    p.add_argument("--device", default="cuda",
                   help="torch device ('cuda' needs a card; 'cpu' runs the plain versions)")
    return p.parse_args(argv)


def run(args, fcn_params, dae_params, device) -> tuple[dict, dict]:
    """The stages; returns ``(results, sums)``: images/s by stage, and the
    on-card scalars ``sum(argmax(y_K))`` of the resident batch
    (``compute``) and of each batch of the last e2e pass per wire
    (``e2e_<wire>``), which agree across the wires."""
    b, h, w = args.batch, args.height, args.width
    n = b * args.num_batches
    cfg = CAMVID
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, (n, h, w, 3), np.uint8)
    labels = rng.integers(0, cfg.n_classes, (n, h, w)).astype(np.int32)
    fd, path = tempfile.mkstemp(suffix=".iist")
    os.close(fd)
    ds = None
    try:
        t0 = time.perf_counter()
        pack_dataset(path, images, labels, cfg)
        print(f"packed {n} images ({os.path.getsize(path) / 1e6:.0f} MB) in {time.perf_counter() - t0:.1f}s",
              flush=True)
        del images, labels
        ds = NativeDataset(path)
        return _stages(args, ds, fcn_params, dae_params, device)
    finally:
        # always reclaim the synthetic file, even if a stage raises
        if ds is not None:
            ds.close()
        os.unlink(path)


def build_flagship(args):
    """The pipeline the stages run: FCN-8 + the K-step half engine at its
    defaults (bf16, folded tail), with labels."""
    return flagship_forward_fn(num_steps=args.steps, depth=3, with_labels=True)


def _stages(args, ds, fcn_params, dae_params, device) -> tuple[dict, dict]:
    b, cfg = args.batch, CAMVID
    flagship = build_flagship(args)

    def refine(x):
        with torch.inference_mode():
            _, _, labels = flagship(fcn_params, dae_params, x)
            return torch.sum(labels, dtype=torch.int64)

    def pipeline(x, raw):
        # the u8 wire's ingest on the card: bytes -> normalized f32
        return refine(normalize_image(x, cfg, input_scale=255.0) if raw else x)

    def epoch_batches(raw):
        return ds.batches(b, shuffle=False, drop_last=True, n_threads=args.n_threads, raw=raw)

    results, sums = {}, {}
    modes = ["f32", "u8"] if args.wire == "both" else [args.wire]
    on_card = device.type == "cuda"

    def pinned(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.pin_memory() if on_card else t

    # --- compute alone, batch resident (f32 ingest) ---
    xr = torch.from_numpy(next(iter(epoch_batches(raw=False)))[0]).to(device)
    iters = max(args.num_batches * args.epochs, 8)
    ms, acc = chained_ms(lambda: pipeline(xr, False), iters, device=device, warmup=1, repeats=1)
    results["compute"] = b * 1e3 / ms
    sums["compute"] = int(acc) // iters
    print(f"compute (resident batch): {results['compute']:.1f} img/s", flush=True)
    del xr

    for mode in modes:
        raw = mode == "u8"

        # --- native producer alone (pass 0 warms the page cache) ---
        for _ in range(2):
            t0 = time.perf_counter()
            nb = sum(1 for _ in epoch_batches(raw))
            dt = time.perf_counter() - t0
        results[f"producer_{mode}"] = nb * b / dt
        print(f"[{mode}] producer (native C++ x{args.n_threads} threads): {results[f'producer_{mode}']:.1f} img/s",
              flush=True)

        # --- the copy alone: pinned batches, non-blocking, one tiny reduce each ---
        host = [pinned(img) for img, _ in epoch_batches(raw)]
        host[0].to(device, non_blocking=True)
        synchronize(device)
        t0 = time.perf_counter()
        acc = None
        for img in host:
            s = img.to(device, non_blocking=True)[0, 0, 0].float().sum()
            acc = s if acc is None else acc + s
        synchronize(device)
        dt = time.perf_counter() - t0
        results[f"transfer_{mode}"] = len(host) * b / dt
        gbs = len(host) * host[0].numel() * host[0].element_size() / dt / 1e9
        print(f"[{mode}] transfer (pinned to(device, non_blocking)): {results[f'transfer_{mode}']:.1f} img/s "
              f"({gbs:.2f} GB/s)", flush=True)
        del host

        # --- the whole overlapped serving path ---
        best = 0.0
        for _ in range(args.epochs):
            t0 = time.perf_counter()
            per_batch = [pipeline(img, raw) for img, _ in device_prefetch(epoch_batches(raw),
                                                                          depth=args.prefetch_depth, device=device)]
            synchronize(device)
            dt = time.perf_counter() - t0
            best = max(best, len(per_batch) * b / dt)
        results[f"e2e_{mode}"] = best
        sums[f"e2e_{mode}"] = [int(s) for s in per_batch]
        print(f"[{mode}] e2e serving (native -> prefetch -> pipeline): {best:.1f} img/s", flush=True)
    return results, sums


def result_line(results: dict, device) -> dict:
    """The JSON line: images/s by stage, rounded as the JAX tool's, and the
    card."""
    return {**{k: round(v, 1) for k, v in results.items()}, "device": device_stamp(device)}


def main(argv=None, *, params=None) -> int:
    """``params``: ``(fcn_params, dae_params)`` to serve in place of the
    flagship's seeded full-width ones (``entry.flagship_params``; the tests
    hand small ones in)."""
    from iterative_inference_segm_tpu_torch.scripts._parallel import check_device

    args = parse_args(argv)
    device = torch.device(args.device)
    check_device(device)
    fcn_params, dae_params = params if params is not None else flagship_params(device)
    results, _ = run(args, fcn_params, dae_params, device)
    print(json.dumps(result_line(results, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
