#!/usr/bin/env python
"""Smoke run of the PyTorch port on one NVIDIA H100: builds the hand-written
kernel, holds it against its plain PyTorch version, serves requests through
the flagship half-engine ``Predictor`` at full width, holds the card against
the CPU, and times the flagship forward.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (one line each; any failure raises and the exit code is non-zero):
 1. device   -- a CUDA card is required (there is no CPU fallback)
 2. build    -- nvcc builds csrc/refine_tail.cu for sm_90a
 3. kernel   -- refine_tail against refine_tail_reference at the main
                path's shapes, bf16 and f32, with CUDA-event times
 4. serve    -- Predictor(engine="half") answers 3 requests (3, 8, 13
                images at 360x480, bf16, K=5) over seeded random weights at
                full width (FCN-8 fc 4096, C=11); the kernel's launch count
                must be (K+1) x chunks
 5. parity   -- one image in f32 on the card (TF32 off) against f32 on the CPU
 6. timing   -- flagship forward images/s at batch 8 and 32
The line before the last is the kernel report (JSON), the last line the
device report (JSON).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from iterative_inference_segm_tpu_torch.data.config_datasets import CAMVID
from iterative_inference_segm_tpu_torch.data.pipeline import normalize_image
from iterative_inference_segm_tpu_torch.inference.fused import flagship_forward_fn
from iterative_inference_segm_tpu_torch.inference.predictor import Predictor
from iterative_inference_segm_tpu_torch.models.dae import DAE_H_CHANNELS, init_dae
from iterative_inference_segm_tpu_torch.models.fcn8 import init_fcn8
from iterative_inference_segm_tpu_torch.ops import _build
from iterative_inference_segm_tpu_torch.ops.refine_tail import refine_tail, refine_tail_reference

K_STEPS = 5
EPS = 0.1
N_CLASSES = 11
H, W = 360, 480
BATCH = 8

# Tolerances of the kernel against its plain version on the same inputs.
# Both compute in f32 and round once on the store; they differ only in the
# exp and the summation order, so f32 agrees to a few ulps and bf16 by at
# most one bf16 ulp where the f32 value lies near a rounding boundary.
F32_TOL = 1e-5
BF16_TOL = 2.0**-8  # one bf16 ulp on [0.5, 1)
MIN_ARGMAX_AGREE = 0.999

# Card (cuDNN, TF32 off) against CPU, f32, one image through the whole
# flagship: different convolution algorithms sum the fan-ins (up to 25088
# terms in fc6) in different orders, about 1e-6 relative per layer; the
# first H100 runs read 8e-6.
PARITY_TOL = 1e-4
PARITY_MIN_ARGMAX_AGREE = 0.999


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_cases(dev, gen):
    """(name, dtype, u, y, v, w, b, with_labels) at the main path's shapes."""
    def probs(shape):
        return torch.softmax(torch.randn(shape, generator=gen) * 3.0, -1)

    def logits(shape):
        return torch.randn(shape, generator=gen) * 3.0

    cases = []
    for dt in (torch.bfloat16, torch.float32):
        tag = "bf16" if dt == torch.bfloat16 else "f32"
        step = (BATCH, H // 2, W // 2, N_CLASSES)
        full = (BATCH, H, W, N_CLASSES)
        cases.append((f"step_{tag}", dt, logits(step), probs(step), logits(step), None, None, False))
        cases.append((f"rect_{tag}", dt, logits(full), probs(full), logits(full), None, None, True))
        # the u map is larger than y: crop offsets (1, 2), as crop_to takes them
        cases.append((
            f"crop_{tag}", dt, logits((BATCH, H // 2 + 3, W // 2 + 5, N_CLASSES)),
            probs(step), logits(step), None, None, False,
        ))
        # K3's own function: u + y.W + b, no v
        wm = torch.randn((N_CLASSES, N_CLASSES), generator=gen) * 0.5
        bias = torch.randn((N_CLASSES,), generator=gen)
        cases.append((f"w_{tag}", dt, logits(step), probs(step), None, wm, bias, True))

    def on_card(t, dt=None):
        return None if t is None else t.to(dev, dt or t.dtype)

    return [
        (name, dt, on_card(u, dt), on_card(y, dt), on_card(v, dt), on_card(wm), on_card(bias), lab)
        for name, dt, u, y, v, wm, bias, lab in cases
    ]


def run_kernel_phase(dev):
    gen = torch.Generator().manual_seed(0)
    worst = 0.0
    report = {}
    for name, dt, u, y, v, wm, bias, lab in kernel_cases(dev, gen):
        got = refine_tail(u, y, EPS, v=v, w=wm, b=bias, with_labels=lab)
        ref = refine_tail_reference(u, y, EPS, v=v, w=wm, b=bias, with_labels=lab)
        torch.cuda.synchronize()
        g_y, r_y = (got[0], ref[0]) if lab else (got, ref)
        err = (g_y.float() - r_y.float()).abs().max().item()
        agree = (g_y.float().argmax(-1) == r_y.float().argmax(-1)).float().mean().item()
        if lab:
            lab_agree = (got[1] == ref[1]).float().mean().item()
            if got[1].dtype != torch.int32 or lab_agree < MIN_ARGMAX_AGREE:
                raise AssertionError(f"{name}: labels agree {lab_agree:.6f} ({got[1].dtype})")
            if not torch.equal(got[1], g_y.float().argmax(-1).to(torch.int32)):
                raise AssertionError(f"{name}: kernel labels differ from the argmax of its own y'")
        tol = F32_TOL if dt == torch.float32 else BF16_TOL
        if not err <= tol or agree < MIN_ARGMAX_AGREE:
            raise AssertionError(f"{name}: max abs err {err:.3e} (tol {tol:.1e}), argmax agree {agree:.6f}")
        ms = cuda_time_ms(lambda: refine_tail(u, y, EPS, v=v, w=wm, b=bias, with_labels=lab), 50)
        plain_ms = cuda_time_ms(
            lambda: refine_tail_reference(u, y, EPS, v=v, w=wm, b=bias, with_labels=lab), 50
        )
        worst = max(worst, err)
        report[name] = {"max_abs_err": err, "argmax_agree": agree, "ms": ms, "plain_ms": plain_ms}
        phase("kernel", f"{name:10s} shape={tuple(y.shape)} u={tuple(u.shape)} "
              f"max_abs_err={err:.3e} argmax_agree={agree:.6f} "
              f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}")
    return worst, report


def full_width_params(dev, dtype=torch.float32):
    fcn = init_fcn8(torch.Generator().manual_seed(0), n_classes=N_CLASSES, fc_channels=4096,
                    dtype=dtype, device=dev)
    dae = init_dae(
        torch.Generator().manual_seed(1), n_classes=N_CLASSES,
        h_specs={"pool4": DAE_H_CHANNELS["pool4"]}, depth=3, stem_pool=1, tail="full",
        dtype=dtype, device=dev,
    )
    return fcn, dae


def run_serve_phase(dev, fcn, dae):
    pred = Predictor(
        fcn, dae, device=dev, engine="half", batch_size=BATCH, compute_dtype=torch.bfloat16,
        num_steps=K_STEPS, eps=EPS, dae_kwargs={"depth": 3, "encoder": "pool"},
    )
    rng = np.random.default_rng(0)
    requests = [rng.random((n, H, W, 3), dtype=np.float32) for n in (3, 8, 13)]
    chunks = sum(-(-len(r) // BATCH) for r in requests)
    refine_tail.launches = 0
    t0 = time.perf_counter()
    answers = [pred.predict(r, return_probs=True) for r in requests]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = refine_tail.launches
    for req, (labels, probs) in zip(requests, answers):
        n = len(req)
        if labels.shape != (n, H, W) or labels.dtype != np.int32:
            raise AssertionError(f"labels {labels.shape} {labels.dtype} for {n} images")
        if probs.shape != (n, H, W, N_CLASSES) or not np.isfinite(probs).all():
            raise AssertionError(f"probs {probs.shape} not finite or misshapen")
        sum_err = float(np.abs(probs.sum(-1) - 1.0).max())
        if sum_err > 1e-2:
            raise AssertionError(f"probabilities sum to 1 within {sum_err}")
        if labels.min() < 0 or labels.max() >= N_CLASSES:
            raise AssertionError(f"labels outside [0, {N_CLASSES})")
        phase("serve", f"request of {n}: labels {labels.shape} int32, probs sum-1 "
              f"max {sum_err:.2e}, classes used {len(np.unique(labels))}")
    want = (K_STEPS + 1) * chunks
    if launches != want:
        raise AssertionError(f"refine_tail launched {launches} times; expected {want}")
    phase("serve", f"{sum(len(r) for r in requests)} images in {chunks} chunks, "
          f"{secs:.2f} s wall (first calls included); refine_tail launches {launches} "
          f"= (K+1) x chunks")
    return launches


def run_parity_phase(fcn, dae):
    # f32 convolutions exact on the card (cuDNN defaults to TF32 otherwise)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    fwd = flagship_forward_fn(num_steps=K_STEPS, eps=EPS, depth=3,
                              compute_dtype=torch.float32, with_labels=True)
    img = np.random.default_rng(1).random((1, H, W, 3), dtype=np.float32)
    x = normalize_image(torch.from_numpy(img), CAMVID)
    to_cpu = lambda p: {k: {kk: t.cpu() for kk, t in v.items()} for k, v in p.items()}  # noqa: E731
    with torch.inference_mode():
        y0_g, yk_g, lab_g = fwd(fcn, dae, x.cuda())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y0_c, yk_c, lab_c = fwd(to_cpu(fcn), to_cpu(dae), x)
        cpu_s = time.perf_counter() - t0
    d0 = (y0_g.cpu() - y0_c).abs().max().item()
    dk = (yk_g.cpu() - yk_c).abs().max().item()
    agree = (lab_g.cpu() == lab_c).float().mean().item()
    phase("parity", f"f32 card vs CPU, 1 image: max|dy0|={d0:.3e} max|dy_K|={dk:.3e} "
          f"argmax agree={agree:.6f} (CPU run {cpu_s:.1f} s)")
    if not (d0 <= PARITY_TOL and dk <= PARITY_TOL) or agree < PARITY_MIN_ARGMAX_AGREE:
        raise AssertionError(f"card vs CPU beyond tolerance {PARITY_TOL} / {PARITY_MIN_ARGMAX_AGREE}")


def run_timing_phase(dev, fcn, dae, smi):
    def forward(num_steps):
        return flagship_forward_fn(num_steps=num_steps, eps=EPS, depth=3,
                                   compute_dtype=torch.bfloat16, with_labels=True)

    fwd, fwd_k0 = forward(K_STEPS), forward(0)
    for batch in (8, 32):
        x = torch.randn((batch, H, W, 3), generator=torch.Generator().manual_seed(2)).to(dev)
        with torch.inference_mode():
            ms = cuda_time_ms(lambda: fwd(fcn, dae, x), iters=20)
            ms_k0 = cuda_time_ms(lambda: fwd_k0(fcn, dae, x), iters=10)
        ips = batch * 1000.0 / ms
        phase("timing", f"flagship bf16 K={K_STEPS} batch {batch}: {ms:.2f} ms/batch, "
              f"{ips:.1f} images/s; K=0 (FCN + rectification) {ms_k0:.2f} ms/batch; on {smi}")
    phase("timing", f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 1

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi()
    phase("device", f"{name} capability {cap} torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi, flush=True)
    if cap != (9, 0):
        raise AssertionError(f"the kernels are built for sm_90a; this card is {cap}")

    t0 = time.perf_counter()
    lib = _build.build("refine_tail")
    _build.load("refine_tail")
    phase("build", f"nvcc sm_90a {lib.name} in {time.perf_counter() - t0:.1f} s; "
          f"ptxas: {' | '.join(l.strip() for l in lib.with_suffix('.log').read_text().splitlines() if 'registers' in l)}")

    worst, kreport = run_kernel_phase(dev)
    fcn, dae = full_width_params(dev)
    launches = run_serve_phase(dev, fcn, dae)
    run_parity_phase(fcn, dae)
    run_timing_phase(dev, fcn, dae, smi)

    step = kreport["step_bf16"]
    print(json.dumps({"kernels": [{
        "name": "refine_tail", "route": "cuda",
        "source": "iterative_inference_segm_tpu_torch/csrc/refine_tail.cu",
        "replaces": "tools/tail_kernel_proto.py:41",
        "launches": launches, "max_abs_err": worst,
        "ms": step["ms"], "plain_ms": step["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
