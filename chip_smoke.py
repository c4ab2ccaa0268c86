#!/usr/bin/env python
"""Smoke run of the PyTorch port on one NVIDIA H100: builds the hand-written
kernels, holds each against its plain PyTorch version, serves requests
through the flagship half-engine ``Predictor`` at full width, holds the card
against the CPU, times the flagship forward, trains the DAE at full width in
the three corruption regimes, serves the DAE it trained, runs the K4/K5
throughput probes, serves through the general engine in score and energy
modes (and the 'sep'-tail flagship), and runs the (eps, K) searches and the
``iterative_inference`` CLI.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases:
 1. device   -- a CUDA card is required (there is no CPU fallback)
 2. build    -- nvcc builds csrc/refine_tail.cu, csrc/corruption.cu and
                csrc/vpu_probe.cu for sm_90a, all at once
 3. kernel   -- refine_tail against refine_tail_reference at the main
                path's shapes, bf16 and f32, with CUDA-event times
 4. serve    -- Predictor(engine="half") answers 3 requests (3, 8, 13
                images at 360x480, bf16, K=5) over seeded random weights at
                full width (FCN-8 fc 4096, C=11); the kernel's launch count
                must be (K+1) x chunks
 5. parity   -- one image in f32 on the card (TF32 off) against f32 on the CPU
 6. timing   -- flagship forward images/s at batch 8 and 32
 7. corrupt  -- K1 (corrupt_onehot) and K2 (corrupt_probs) against their
                plain versions at the training shapes, sigma 0 and 1, with
                CUDA-event times beside a plain fill of the same output
 8. train    -- train_dae at full width (FCN-8 fc 4096, DAE stem 1 / depth 3,
                batch 32 of 360x480 frames cropped to 224 with flips, bf16,
                eval on full frames) in the gt, natural and mix regimes; the
                launch counts of K1/K2 must match the batches each regime
                sends through them; train images/s and the step's split
 9. tparity  -- one f32 train step on the card (TF32 off) against the CPU
10. tserve   -- Predictor.from_npz serves the best_dae.npz phase 8 wrote
11. probe    -- K4 (fma_chain) at n_fma 2, 26, 50, 100 and K5
                (pattern_softmax), bf16 and f32, each against its plain
                version; then the probe tool's sweep (tools/vpu_probe.py):
                20-launch chains beside the plain versions, the store floor,
                the marginal multiply-add rate against the FP32 FMA peak
12. general  -- Predictor(engine="general") at the JAX CLI's full width (DAE
                depth 4, stem_pool 0, widths 32..256, K=5, batch 4) answers
                3 and 8 images in bf16, score (refine_tail launches K x
                chunks) and energy (none); one f32 image card vs CPU (score:
                y_K; energy: the energy and one step's gradient, see
                run_energy_parity); images/s at batch 4 and 8; the 'sep'-tail
                flagship (stem 1, depth 3) served through the half engine in
                both modes with its launch counts
13. search   -- grid_search_eps_k and grid_search_eps_k_half (eps 0.02..0.2,
                K_max 10, two val batches of 4, bf16) against per-K engine
                runs at two (eps, K) points; then the CLI's main() with
                --synthetic --search --num-batches 2 --bf16 at full width
Every phase asserts; any failure raises and the exit code is non-zero. The
line before the last is the kernel report (JSON), the last line the device
report (JSON).
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from iterative_inference_segm_tpu_torch.data.config_datasets import CAMVID
from iterative_inference_segm_tpu_torch.data.pipeline import normalize_image
from iterative_inference_segm_tpu_torch.data.synthetic import synthetic_batches
from iterative_inference_segm_tpu_torch.inference.fused import flagship_forward_fn
from iterative_inference_segm_tpu_torch.inference.iterative import make_refiner, refinement_scan
from iterative_inference_segm_tpu_torch.inference.predictor import Predictor
from iterative_inference_segm_tpu_torch.inference.search import grid_search_eps_k, grid_search_eps_k_half
from iterative_inference_segm_tpu_torch.models.dae import DAE_H_CHANNELS, dae_logits, init_dae
from iterative_inference_segm_tpu_torch.models.fcn8 import fcn8_apply, init_fcn8
from iterative_inference_segm_tpu_torch.ops import _build
from iterative_inference_segm_tpu_torch.ops import corruption_kernel as ck
from iterative_inference_segm_tpu_torch.ops import vpu_probe as vp
from iterative_inference_segm_tpu_torch.ops.conv import conv2d
from iterative_inference_segm_tpu_torch.ops.metrics import confusion_matrix, metrics_from_confusion
from iterative_inference_segm_tpu_torch.ops.refine_tail import refine_tail, refine_tail_reference
from iterative_inference_segm_tpu_torch.scripts import iterative_inference as cli
from iterative_inference_segm_tpu_torch.tools import vpu_probe as probe_tool
from iterative_inference_segm_tpu_torch.train.loop import TrainConfig, make_optimizer
from iterative_inference_segm_tpu_torch.train.train_dae import (
    draw_step_randomness,
    make_dae_train_step,
    train_dae,
)
from iterative_inference_segm_tpu_torch.utils.checkpoint import save_npz

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

# K1/K2 against their plain versions: the same hash, the same f32 formulas
# and the same class order in the softmax sum; only CUDA's logf/cosf/expf
# against PyTorch's (each within 2 ulps) differ, which moves an output by
# ~1e-7.
CORRUPT_TOL = 1e-6
CORRUPT_SUM_TOL = 1e-5
CORRUPT_MIN_ARGMAX_AGREE = 0.9999
SIGMA = 1.0
CROP = CAMVID.train_crop

# The DAE training cell: batch 32 of full 360x480 frames cropped in-step to
# 224x224 with flips, bf16 compute over f32 master weights, Adam 1e-3 with
# 1e-4 coupled L2; eval on full frames.
TRAIN_BATCH = 32
TRAIN_EPOCHS = 3
TRAIN_BATCHES = 4
VAL_BATCHES = 2
DAE_KW = dict(h_taps=("pool4",), dae_depth=3, dae_stem_pool=1, dae_tail="full",
              dae_encoder="pool")

# One f32 train step, card (cuDNN, TF32 off) against CPU, full width, batch
# 2. The loss is a mean over ~10^5 pixels of a DAE fed by the frozen FCN,
# whose convolutions sum up to 25088 terms in another order on each side
# (~1e-6 relative per layer, as in phase 5): 1e-4 relative. Adam's first
# moment after one step is 0.1 x (gradient + 1e-4 w); each gradient entry is
# a sum over every pixel of the batch, taken in another order on each side,
# of terms that partly cancel: 1e-3 of each leaf's largest entry.
TRAIN_PARITY_LOSS_TOL = 1e-4
TRAIN_PARITY_MOMENT_TOL = 1e-3

# K4 against its plain version: both chain one rounding a step in f32 (fmaf;
# addcmul), so f32 is held bit-equal: a kernel rounding ``acc + x * w``
# twice is off by up to 1.8e-4 at n=100. K5: the same f32 order of
# operations on both sides; only CUDA's expf and PyTorch's exp may differ
# (by an ulp), which moves a probability by ~1e-7.
PATTERN_F32_TOL = 1e-6

# The general engine at the JAX CLI's defaults, and the search's grid.
GENERAL_BATCH = 4
SEARCH_EPS = (0.02, 0.05, 0.1, 0.2)
SEARCH_KMAX = 10
SEARCH_POINTS = ((1, 3), (3, 10))  # (eps index, K) held against engine runs
# the energy 0.5 ||y - r(y)||^2, a sum over 1.9 M values, card against CPU
ENERGY_REL_TOL = 1e-5
# One energy step's gradient, card against CPU, in norm (itself and its
# Jacobian term). The first H100 runs read 1.0e-3..4.4e-3, the CPU against
# itself with y0 moved by 1e-7 1.0e-2 (the update's discontinuities), and
# planted zero, score-mode and sign-flipped gradients 0.76..2.6.
ENERGY_GRAD_REL_TOL = 0.05


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def clocks() -> str:
    """The card's SM clock (now and its maximum), power draw and
    temperature, read beside a timing."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log) -> str:
    """'kernel<template args>: registers, spill stores/loads' per entry
    function of an ``nvcc -Xptxas -v`` log (template args as mangled, e.g.
    ``Lb1ELi16`` for <true, 16>)."""
    out, entry, spill = [], "?", ""
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = re.search(r"\d+([A-Za-z][A-Za-z_]*_kernel)I(\w+?)EE", m.group(1))
            entry = f"{k.group(1)}<{k.group(2)}>" if k else m.group(1)[:40]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = f"spill {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append(f"{entry}: {m.group(1)} regs, {spill}")
    return " | ".join(out)


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
              f"{ips:.1f} images/s; K=0 (FCN + rectification) {ms_k0:.2f} ms/batch; on {smi}; "
              f"clocks.sm, max, power, temp: {clocks()}")
    phase("timing", f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def _labels_with_void(shape, gen):
    lab = torch.randint(0, N_CLASSES, shape, generator=gen, dtype=torch.int32)
    void = torch.rand(shape, generator=gen) < 0.02
    return torch.where(void, torch.full_like(lab, CAMVID.void_label), lab)


def run_corrupt_phase(dev):
    """K1 and K2 against their plain versions at the training shapes (the
    train step's crop, and the eval step's full frames)."""
    gen = torch.Generator().manual_seed(3)
    report = {}
    for shape in ((TRAIN_BATCH, *CROP), (BATCH, H, W)):
        labels = _labels_with_void(shape, gen).to(dev)
        probs = torch.softmax(torch.randn((*shape, N_CLASSES), generator=gen) * 3.0, -1).to(dev)
        void = labels == CAMVID.void_label
        for sigma in (0.0, SIGMA):
            for name, fn, ref, src, kw in (
                ("corrupt_onehot", ck.corrupt_onehot, ck.corrupt_onehot_kernel_reference, labels,
                 {"n_classes": N_CLASSES, "sigma": sigma}),
                ("corrupt_probs", ck.corrupt_probs, ck.corrupt_probs_kernel_reference, probs,
                 {"sigma": sigma}),
            ):
                seed = 0x9E3779B9
                got = fn(src, seed, **kw)
                want = ref(src, seed, **kw)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                sum_err = (got.sum(-1) - 1.0).abs().max().item()
                agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
                if not (err <= CORRUPT_TOL and sum_err <= CORRUPT_SUM_TOL
                        and agree >= CORRUPT_MIN_ARGMAX_AGREE):
                    raise AssertionError(f"{name} {shape} sigma={sigma}: max abs err {err:.3e}, "
                                         f"row sums {sum_err:.3e}, argmax agree {agree:.6f}")
                if name == "corrupt_onehot" and sigma == 0.0:
                    rows = got[void]
                    if not torch.equal(rows, torch.full_like(rows, 1.0 / N_CLASSES)):
                        raise AssertionError("void rows at sigma 0 are not exactly uniform")
                ms = cuda_time_ms(lambda: fn(src, seed, **kw), 20)
                plain_ms = cuda_time_ms(lambda: ref(src, seed, **kw), 5)
                out = torch.empty_like(got)
                fill_ms = cuda_time_ms(lambda: out.fill_(0.5), 20)
                key = (name, shape, sigma)
                report[key] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
                phase("corrupt", f"{name:14s} {tuple(got.shape)} sigma={sigma}: "
                      f"max_abs_err={err:.3e} row_sum_err={sum_err:.1e} argmax_agree={agree:.6f} "
                      f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f} "
                      f"store_floor_ms={fill_ms:.4f} ({got.numel() * 4 / 1e6:.1f} MB)")
    return report


def synthetic_data():
    def make(n, seed):
        return list(synthetic_batches(cfg=CAMVID, batch_size=TRAIN_BATCH, num_batches=n, seed=seed))

    return make(TRAIN_BATCHES, 0), make(VAL_BATCHES, 10_000)


def run_train_phase(fcn, workdir):
    """train_dae in each regime; returns the launch counts and the gt
    regime's workdir."""
    t0 = time.perf_counter()
    train, val = synthetic_data()
    phase("train", f"synthetic CamVid: {TRAIN_BATCHES} train + {VAL_BATCHES} val batches of "
          f"{TRAIN_BATCH} x {H}x{W} in {time.perf_counter() - t0:.1f} s")
    tcfg = TrainConfig(learning_rate=1e-3, weight_decay=1e-4, max_epochs=TRAIN_EPOCHS,
                       patience=TRAIN_EPOCHS, batch_size=TRAIN_BATCH, seed=0,
                       compute_dtype=torch.bfloat16)
    batches = TRAIN_EPOCHS * (TRAIN_BATCHES + VAL_BATCHES)
    launches = {"corrupt_onehot": 0, "corrupt_probs": 0}
    torch.cuda.reset_peak_memory_stats()
    for regime, from_gt in (("gt", True), ("natural", False), ("mix", 0.5)):
        ck.corrupt_onehot.launches = 0
        ck.corrupt_probs.launches = 0
        t0 = time.perf_counter()
        result = train_dae(
            fcn_params=fcn, dataset=CAMVID, train_data=train, val_data=val, tcfg=tcfg,
            sigma=SIGMA, from_gt=from_gt, workdir=str(workdir / regime), augment=True,
            corruption_impl="kernel", **DAE_KW,
        )
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        k1, k2 = ck.corrupt_onehot.launches, ck.corrupt_probs.launches
        launches["corrupt_onehot"] += k1
        launches["corrupt_probs"] += k2
        hist = result["history"]
        losses = [h["train_loss"] for h in hist]
        if len(hist) != TRAIN_EPOCHS or not np.isfinite(losses).all():
            raise AssertionError(f"{regime}: history {hist}")
        if not np.isfinite([h["val_loss"] for h in hist]).all():
            raise AssertionError(f"{regime}: val loss not finite")
        if regime == "gt" and not losses[-1] < losses[0]:
            raise AssertionError(f"gt regime: train loss did not fall: {losses}")
        want = {"gt": (batches, 0), "natural": (0, batches)}.get(regime)
        if want is not None and (k1, k2) != want:
            raise AssertionError(f"{regime}: K1/K2 launched {k1}/{k2} times; expected {want}")
        # mix: one coin per batch sends it through exactly one of the two
        if regime == "mix" and not (k1 + k2 == batches and k1 > 0 and k2 > 0):
            raise AssertionError(f"mix: K1/K2 launched {k1}/{k2} times for {batches} batches")
        phase("train", f"{regime:7s} from_gt={from_gt}: train_loss "
              + " ".join(f"{v:.4f}" for v in losses)
              + f" val_loss {hist[-1]['val_loss']:.4f} val_mIoU {hist[-1]['val_miou']:.4f}; "
              f"K1/K2 launches {k1}/{k2} over {batches} batches; {secs:.1f} s wall "
              f"(first calls included), last epoch {hist[-1]['train_images_per_sec']:.1f} images/s")
    phase("train", f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, workdir / "gt"


def run_train_timing(dev, fcn, smi):
    """Train images/s at batch 32, crop 224, bf16, and the step's split."""
    tcfg = TrainConfig(compute_dtype=torch.bfloat16)
    dae = init_dae(torch.Generator().manual_seed(4), n_classes=N_CLASSES,
                   h_specs={"pool4": DAE_H_CHANNELS["pool4"]}, depth=3, stem_pool=1, device=dev)
    opt = make_optimizer(tcfg, dae)
    train_step, _ = make_dae_train_step(CAMVID, tcfg, opt, h_taps=("pool4",), sigma=SIGMA,
                                        from_gt=True, dae_depth=3, corruption_impl="kernel")
    stages = train_step.stages
    images, labels = next(synthetic_batches(cfg=CAMVID, batch_size=TRAIN_BATCH, num_batches=1,
                                            seed=5))
    x, y = torch.from_numpy(images).to(dev), torch.from_numpy(labels).to(dev)
    rand = draw_step_randomness(torch.Generator().manual_seed(6), batch=TRAIN_BATCH, hw=(H, W),
                                crop=CROP, p_gt=1.0)
    step_ms = cuda_time_ms(lambda: train_step(dae, fcn, x, y, rand), iters=20)
    xc, yc = stages.prepare(x, y, rand)
    probs, h = stages.features(fcn, xc)
    y_tilde = stages.corrupt(yc, probs, rand)

    def dae_fwd_bwd():
        opt.zero_grad(set_to_none=True)
        stages.loss(dae, y_tilde, h, yc)[0].backward()

    split = {
        "crop+normalize": cuda_time_ms(lambda: stages.prepare(x, y, rand), iters=20),
        "frozen FCN forward": cuda_time_ms(lambda: stages.features(fcn, xc), iters=20),
        "corruption (K1)": cuda_time_ms(lambda: stages.corrupt(yc, probs, rand), iters=20),
        "DAE forward+backward": cuda_time_ms(dae_fwd_bwd, iters=20),
        "optimizer step": cuda_time_ms(opt.step, iters=20),
    }
    pool5 = torch.randn((TRAIN_BATCH, CROP[0] // 32, CROP[1] // 32, 512), device=dev,
                        dtype=torch.bfloat16)
    with torch.no_grad():
        fc6_ms = cuda_time_ms(lambda: conv2d(pool5, fcn["fc6"]["w"].to(torch.bfloat16),
                                             fcn["fc6"]["b"].to(torch.bfloat16)), iters=20)
    ips = TRAIN_BATCH * 1000.0 / step_ms
    phase("timing", f"DAE train step bf16 batch {TRAIN_BATCH} crop {CROP[0]}: {step_ms:.2f} ms/step, "
          f"{ips:.1f} images/s; on {smi}; clocks.sm, max, power, temp: {clocks()}")
    for name, ms in split.items():
        phase("timing", f"  {name:22s} {ms:8.3f} ms  {100.0 * ms / step_ms:5.1f}% of the step")
    phase("timing", f"  fc6 (7x7 conv on the {CROP[0] // 32}x{CROP[1] // 32} pool5 map) alone "
          f"{fc6_ms:.3f} ms, {100.0 * fc6_ms / split['frozen FCN forward']:.1f}% of the FCN forward")
    return step_ms, ips


def run_train_parity(fcn):
    """One f32 train step at full width, batch 2, card against CPU."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    images, labels = next(synthetic_batches(cfg=CAMVID, batch_size=2, num_batches=1, seed=7))
    rand = draw_step_randomness(torch.Generator().manual_seed(8), batch=2, hw=(H, W), crop=CROP,
                                p_gt=1.0)
    tcfg = TrainConfig()
    runs = {}
    for where in ("cuda", "cpu"):
        fcn_w = fcn if where == "cuda" else {k: {kk: t.cpu() for kk, t in v.items()}
                                             for k, v in fcn.items()}
        dae = init_dae(torch.Generator().manual_seed(9), n_classes=N_CLASSES,
                       h_specs={"pool4": DAE_H_CHANNELS["pool4"]}, depth=3, stem_pool=1,
                       device=where)
        opt = make_optimizer(tcfg, dae)
        train_step, _ = make_dae_train_step(CAMVID, tcfg, opt, h_taps=("pool4",), sigma=SIGMA,
                                            from_gt=True, dae_depth=3, corruption_impl="kernel")
        t0 = time.perf_counter()
        loss = float(train_step(dae, fcn_w, torch.from_numpy(images).to(where),
                                torch.from_numpy(labels).to(where), rand))
        secs = time.perf_counter() - t0
        moments = {f"{k}/{kk}": opt.state[t]["exp_avg"].cpu() for k, v in dae.items()
                   for kk, t in v.items()}
        runs[where] = (loss, moments, secs)
    (lg, mg, sg), (lc, mc, sc) = runs["cuda"], runs["cpu"]
    loss_rel = abs(lg - lc) / abs(lc)
    worst, worst_name = 0.0, ""
    for name, m in mc.items():
        rel = (mg[name] - m).abs().max().item() / max(m.abs().max().item(), 1e-30)
        if rel > worst:
            worst, worst_name = rel, name
    phase("tparity", f"f32 train step, batch 2, crop {CROP[0]}: loss card {lg:.7f} CPU {lc:.7f} "
          f"(rel {loss_rel:.2e}); Adam exp_avg worst rel {worst:.2e} ({worst_name}); "
          f"card {sg:.2f} s, CPU {sc:.1f} s")
    if not (loss_rel <= TRAIN_PARITY_LOSS_TOL and worst <= TRAIN_PARITY_MOMENT_TOL):
        raise AssertionError(f"train step card vs CPU beyond {TRAIN_PARITY_LOSS_TOL} / "
                             f"{TRAIN_PARITY_MOMENT_TOL}")


def run_train_serve_phase(dev, fcn, gt_workdir):
    """Serve the DAE that phase 8 trained, loaded from its best_dae.npz."""
    fcn_npz = gt_workdir / "fcn8.npz"
    save_npz(fcn_npz, fcn)
    pred = Predictor.from_npz(
        fcn_npz, gt_workdir / "best_dae.npz", device=dev, dae_depth=3, dae_stem_pool=1,
        engine="half", batch_size=BATCH, compute_dtype=torch.bfloat16, num_steps=K_STEPS, eps=EPS,
    )
    images = np.random.default_rng(3).random((3, H, W, 3), dtype=np.float32)
    refine_tail.launches = 0
    labels, probs = pred.predict(images, return_probs=True)
    torch.cuda.synchronize()
    if labels.shape != (3, H, W) or labels.dtype != np.int32:
        raise AssertionError(f"labels {labels.shape} {labels.dtype}")
    if not np.isfinite(probs).all() or float(np.abs(probs.sum(-1) - 1.0).max()) > 1e-2:
        raise AssertionError("served probabilities not finite or off the simplex")
    if refine_tail.launches != K_STEPS + 1:
        raise AssertionError(f"refine_tail launched {refine_tail.launches} times")
    phase("tserve", f"best_dae.npz from the gt regime served 3 images at {H}x{W}: labels "
          f"{labels.shape} int32, classes used {len(np.unique(labels))}, refine_tail launches "
          f"{refine_tail.launches}")
    return refine_tail.launches


def run_probe_phase(dev):
    """K4/K5 against their plain versions at the probe's shapes (one launch
    each), then the probe tool's sweep with the launch counts set to 0 just
    before it. The chain's values grow ~(1 + n) a launch and reach inf, so
    only the single launches are compared."""
    worst = {"fma_chain": 0.0, "pattern_softmax": 0.0}
    for dt in probe_tool.DTYPES:
        x, w = probe_tool.fma_inputs(dt, dev)
        for n in probe_tool.N_FMA:
            got = vp.fma_chain(x, w, n)
            want = vp.fma_chain_reference(x, w, n)
            torch.cuda.synchronize()
            ok_bits = torch.equal(got, want)
            want = want.float()
            err = (got.float() - want).abs()
            if dt == torch.float32:
                ok = ok_bits
            else:
                ok = bool((err <= 2.0**-7 * want.abs()).all())  # one bf16 ulp of the value
            worst["fma_chain"] = max(worst["fma_chain"], err.max().item())
            phase("probe", f"fma_chain n={n:3d} {dt}: max abs err {err.max().item():.3e} "
                  f"(max |acc| {want.abs().max().item():.1f}), bit-equal {ok_bits}")
            if not ok or got.dtype != dt or not torch.isfinite(got).all():
                raise AssertionError(f"fma_chain n={n} {dt} disagrees with its plain version")
        xp, k = probe_tool.pattern_inputs(dt, dev)
        got = vp.pattern_softmax(xp, k)
        want = vp.pattern_softmax_reference(xp, k).float()
        torch.cuda.synchronize()
        err = (got.float() - want).abs().max().item()
        sums = (got.float().sum(2) - 1.0).abs().max().item()
        worst["pattern_softmax"] = max(worst["pattern_softmax"], err)
        phase("probe", f"pattern_softmax {dt}: max abs err {err:.3e}, rows sum to 1 within {sums:.2e}")
        tol = PATTERN_F32_TOL if dt == torch.float32 else BF16_TOL
        if not err <= tol or (dt == torch.float32 and not sums <= CORRUPT_SUM_TOL):
            raise AssertionError(f"pattern_softmax {dt}: err {err:.3e} (tol {tol:.1e}), row sums {sums:.2e}")
    vp.fma_chain.launches = 0
    vp.pattern_softmax.launches = 0
    res = probe_tool.run(dev)
    launches = {"fma_chain": vp.fma_chain.launches, "pattern_softmax": vp.pattern_softmax.launches}
    if launches != probe_tool.launches_per_sweep():
        raise AssertionError(f"probe sweep launched {launches}; expected {probe_tool.launches_per_sweep()}")
    phase("probe", f"sweep launches {launches}; clocks.sm, max, power, temp: {clocks()}")
    return worst, launches, res


def general_params(dev, dtype=torch.float32):
    """The JAX CLI's default DAE at full width: depth 4, stem_pool 0, 'full'
    tail, pool encoder, widths (32, 64, 128, 256), pool4 conditioning."""
    return init_dae(torch.Generator().manual_seed(11), n_classes=N_CLASSES,
                    h_specs={"pool4": DAE_H_CHANNELS["pool4"]}, depth=4, stem_pool=0,
                    dtype=dtype, device=dev)


def _check_answer(labels, probs, n):
    if labels.shape != (n, H, W) or labels.dtype != np.int32:
        raise AssertionError(f"labels {labels.shape} {labels.dtype} for {n} images")
    if probs.shape != (n, H, W, N_CLASSES) or not np.isfinite(probs).all():
        raise AssertionError(f"probs {probs.shape} not finite or misshapen")
    if labels.min() < 0 or labels.max() >= N_CLASSES:
        raise AssertionError(f"labels outside [0, {N_CLASSES})")


def _serve_counted(pred, requests, want_launches, tag):
    refine_tail.launches = 0
    t0 = time.perf_counter()
    answers = [pred.predict(r, return_probs=True) for r in requests]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = refine_tail.launches
    for req, (labels, probs) in zip(requests, answers):
        _check_answer(labels, probs, len(req))
    if launches != want_launches:
        raise AssertionError(f"{tag}: refine_tail launched {launches} times; expected {want_launches}")
    phase("general", f"{tag}: {sum(len(r) for r in requests)} images, {secs:.2f} s wall (first calls "
          f"included), refine_tail launches {launches}, classes used "
          f"{len(np.unique(answers[-1][0]))}")
    return launches


def _grad_errors(g, gs, g_ref, gs_ref) -> tuple[float, float]:
    """``(e_g, e_v)`` of an energy gradient ``g`` (its score part ``gs`` = y0
    - r(y0)) against the reference ``g_ref``: ||g - g_ref|| / ||g_ref||, and
    the same for the Jacobian term v = g - gs, which a score-mode step lacks."""
    def nrm(t):
        return t.double().norm().item()

    v_ref = g_ref - gs_ref
    return nrm(g - g_ref) / nrm(g_ref), nrm((g - gs) - v_ref) / nrm(v_ref)


def run_energy_parity(dev, dae, dae_c, fcn_c, img):
    """Energy mode, card against CPU, from the same y0 and taps (the CPU
    FCN's). Its update is discontinuous where a max-pool window changes its
    maximum or a pre-activation crosses 0, and on a smooth class map many
    windows nearly tie, so a 1e-7 change of y moves some values of y_1 by
    ~0.05 on either device: a K-step trajectory is not held value by value
    (phase printed above, for the record). Held instead, from one step: the
    energy 0.5 ||y0 - r(y0)||^2 (relative 1e-5), the step's argmax (>=
    99.9%), and the gradient g = (y0 - y_1) / eps in norm: ||g_card - g_cpu||
    / ||g_cpu|| and the same for its Jacobian term g - (y0 - r(y0)), each
    within ENERGY_GRAD_REL_TOL. Printed beside them: the CPU against itself
    under a 1e-7 change of y0, and three planted gradients (zero, the score
    step's, the card's with its sign flipped), each of which must fail."""
    with torch.no_grad():
        y0, h = fcn8_apply(fcn_c, img, return_features=("pool4",))
        noise = 1e-7 * torch.randn(y0.shape, generator=torch.Generator().manual_seed(7))
        runs = {}
        for where, d_, d, y in (("card", dev, dae, y0), ("cpu", "cpu", dae_c, y0),
                                ("cpu+1e-7", "cpu", dae_c, y0 + noise)):
            hd = {k: v.to(d_) for k, v in h.items()}
            fn = lambda yy, d=d, hd=hd: dae_logits(d, yy, hd, depth=4)  # noqa: E731
            yd = y.to(d_)
            r = torch.softmax(fn(yd).float(), -1)
            energy = 0.5 * torch.sum(torch.square(yd - r)).item()
            y1 = refinement_scan(fn, yd, eps=EPS, num_steps=1, mode="energy")
            runs[where] = (energy, y1.cpu(), ((yd - y1) / EPS).cpu(), (yd - r).cpu())
    e_rel = abs(runs["card"][0] - runs["cpu"][0]) / abs(runs["cpu"][0])
    stats = {}
    for other in ("card", "cpu+1e-7"):
        d = (runs[other][1] - runs["cpu"][1]).abs()
        agree = (runs[other][1].argmax(-1) == runs["cpu"][1].argmax(-1)).float().mean().item()
        stats[other] = (d.max().item(), (d > PARITY_TOL).float().mean().item(), agree)
    g_ref, gs_ref = runs["cpu"][2:]
    g_card, gs_card = runs["card"][2:]
    errs = {where: _grad_errors(*runs[where][2:], g_ref, gs_ref) for where in ("card", "cpu+1e-7")}
    planted = {"zero": (torch.zeros_like(g_card), gs_card), "score": (gs_card, gs_card),
               "flipped": (-g_card, gs_card)}
    errs.update({f"planted {k}": _grad_errors(g, gs, g_ref, gs_ref) for k, (g, gs) in planted.items()})
    phase("general", f"f32 energy, same y0 and taps: energy card {runs['card'][0]:.6f} CPU "
          f"{runs['cpu'][0]:.6f} (rel {e_rel:.2e}); one step, card vs CPU: max|dy_1|={stats['card'][0]:.3e}, "
          f"{stats['card'][1]:.2%} of values beyond {PARITY_TOL}, argmax agree {stats['card'][2]:.6f}; "
          f"CPU vs CPU with y0 moved by 1e-7: max|dy_1|={stats['cpu+1e-7'][0]:.3e}, "
          f"{stats['cpu+1e-7'][1]:.2%} beyond, argmax agree {stats['cpu+1e-7'][2]:.6f}")
    phase("general", "f32 energy gradient against the CPU's, relative (g, Jacobian term), limit "
          f"{ENERGY_GRAD_REL_TOL}: " + "; ".join(f"{k} {eg:.4e}, {ev:.4e}" for k, (eg, ev) in errs.items()))
    if not e_rel <= ENERGY_REL_TOL or stats["card"][2] < PARITY_MIN_ARGMAX_AGREE:
        raise AssertionError(f"energy mode: card vs CPU energy rel {e_rel:.2e} (tol {ENERGY_REL_TOL}), "
                             f"one-step argmax agree {stats['card'][2]:.6f}")
    if not max(errs["card"]) <= ENERGY_GRAD_REL_TOL:
        raise AssertionError(f"energy mode: card gradient off the CPU's by {errs['card']}")
    for k in planted:
        if max(errs[f"planted {k}"]) <= ENERGY_GRAD_REL_TOL:
            raise AssertionError(f"the energy-gradient check passes a planted {k} gradient")


def run_general_phase(dev, fcn, smi):
    dae = general_params(dev)
    rng = np.random.default_rng(4)
    requests = [rng.random((n, H, W, 3), dtype=np.float32) for n in (3, 8)]
    chunks = sum(-(-len(r) // GENERAL_BATCH) for r in requests)
    launches = 0
    for mode in ("score", "energy"):
        pred = Predictor(fcn, dae, device=dev, batch_size=GENERAL_BATCH, compute_dtype=torch.bfloat16,
                         num_steps=K_STEPS, eps=EPS, mode=mode, dae_kwargs={"depth": 4, "encoder": "pool"})
        launches += _serve_counted(pred, requests, K_STEPS * chunks if mode == "score" else 0,
                                   f"general engine {mode} bf16")
        # score steps blend two distributions; energy steps leave the simplex
        probs = pred.predict(requests[0][:1], return_probs=True)[1]
        if probs.dtype != np.float32 or (mode == "score" and float(np.abs(probs.sum(-1) - 1.0).max()) > 1e-3):
            raise AssertionError(f"general-engine {mode} probs are not f32 (on the simplex in score mode)")

    # one image in f32, card (TF32 off) against the CPU
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    img = normalize_image(torch.from_numpy(np.random.default_rng(5).random((1, H, W, 3), dtype=np.float32)),
                          CAMVID)
    to_cpu = lambda p: {k: {kk: t.cpu() for kk, t in v.items()} for k, v in p.items()}  # noqa: E731
    fcn_c, dae_c = to_cpu(fcn), to_cpu(dae)
    out = {}
    for mode in ("score", "energy"):
        for where, d_, f, d in (("card", dev, fcn, dae), ("cpu", "cpu", fcn_c, dae_c)):
            refine = make_refiner(fcn8_apply, dae_logits, f, d, eps=EPS, num_steps=K_STEPS, mode=mode,
                                  compute_dtype=torch.float32, dae_kwargs={"depth": 4})
            t0 = time.perf_counter()
            out[mode, where] = [t.cpu() for t in refine(img.to(d_))]
            out[mode, where, "s"] = time.perf_counter() - t0
        dk = (out[mode, "card"][1] - out[mode, "cpu"][1]).abs().max().item()
        agree = (out[mode, "card"][1].argmax(-1) == out[mode, "cpu"][1].argmax(-1)).float().mean().item()
        phase("general", f"f32 card vs CPU, 1 image, {mode}, K={K_STEPS}: max|dy_K|={dk:.3e} argmax agree="
              f"{agree:.6f} (CPU run {out[mode, 'cpu', 's']:.1f} s)")
        if mode == "score" and (not dk <= PARITY_TOL or agree < PARITY_MIN_ARGMAX_AGREE):
            raise AssertionError(f"general engine score: card vs CPU beyond {PARITY_TOL} / "
                                 f"{PARITY_MIN_ARGMAX_AGREE}")
    run_energy_parity(dev, dae, dae_c, fcn_c, img)
    torch.cuda.reset_peak_memory_stats()
    timing = {}
    for mode in ("score", "energy"):
        refine = make_refiner(fcn8_apply, dae_logits, fcn, dae, eps=EPS, num_steps=K_STEPS, mode=mode,
                              compute_dtype=torch.bfloat16, dae_kwargs={"depth": 4})
        for batch in (4, 8):
            x = torch.randn((batch, H, W, 3), generator=torch.Generator().manual_seed(6)).to(dev)
            ms = cuda_time_ms(lambda: refine(x), iters=10)
            timing[(mode, batch)] = batch * 1000.0 / ms
            phase("general", f"general engine bf16 {mode} K={K_STEPS} batch {batch}: {ms:.2f} ms/batch, "
                  f"{timing[(mode, batch)]:.1f} images/s; on {smi}; clocks.sm, max, power, temp: {clocks()}")
    phase("general", f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # the 'sep'-tail flagship through the half engine
    sep = init_dae(torch.Generator().manual_seed(12), n_classes=N_CLASSES,
                   h_specs={"pool4": DAE_H_CHANNELS["pool4"]}, depth=3, stem_pool=1, tail="sep", device=dev)
    for mode in ("score", "energy"):
        pred = Predictor(fcn, sep, device=dev, engine="half", batch_size=GENERAL_BATCH,
                         compute_dtype=torch.bfloat16, num_steps=K_STEPS, eps=EPS, mode=mode,
                         dae_kwargs={"depth": 3})
        launches += _serve_counted(pred, requests, (K_STEPS + 1) * chunks if mode == "score" else 0,
                                   f"'sep' flagship, half engine, {mode} bf16")
    return launches, timing


def _miou_of(labels_fn, batches, dev):
    cm = None
    for x, lab in batches:
        c = confusion_matrix(labels_fn(torch.from_numpy(x).to(dev)), torch.from_numpy(lab).to(dev),
                             n_classes=N_CLASSES)
        cm = c if cm is None else cm + c
    return float(metrics_from_confusion(cm).mean_iou)


def run_search_phase(dev, fcn, flag_dae):
    dae = general_params(dev)
    val = [(normalize_image(torch.from_numpy(i), CAMVID).numpy(), lab)
           for i, lab in synthetic_batches(cfg=CAMVID, batch_size=GENERAL_BATCH, num_batches=2, seed=500)]
    kw = dict(n_classes=N_CLASSES, eps_grid=SEARCH_EPS, k_max=SEARCH_KMAX, device=dev,
              compute_dtype=torch.bfloat16)
    refine_tail.launches = 0
    t0 = time.perf_counter()
    gen = grid_search_eps_k(fcn8_apply, dae_logits, fcn, dae, val, dae_kwargs={"depth": 4}, **kw)
    half = grid_search_eps_k_half(fcn8_apply, fcn, flag_dae, val, depth=3, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = refine_tail.launches
    # general: K_max steps per trajectory; half: K_max steps + K_max + 1 rectifications
    want = len(SEARCH_EPS) * len(val) * (SEARCH_KMAX + 2 * SEARCH_KMAX + 1)
    if launches != want:
        raise AssertionError(f"searches launched refine_tail {launches} times; expected {want}")
    for name, res in (("general", gen), ("half", half)):
        grid = res["miou"]
        if grid.shape != (len(SEARCH_EPS), SEARCH_KMAX + 1) or not np.isfinite(grid).all():
            raise AssertionError(f"{name} search grid {grid.shape} not finite")
        phase("search", f"{name} search: best eps={res['best_eps']} K={res['best_k']} "
              f"mIoU {res['best_miou']:.4f}; grid mIoU range {grid.min():.4f}..{grid.max():.4f}")
    phase("search", f"both searches: {secs:.2f} s wall, refine_tail launches {launches}")
    for ei, k in SEARCH_POINTS:
        eps = SEARCH_EPS[ei]

        def general_labels(x, eps=eps, k=k):
            with torch.inference_mode():
                y0, h = fcn8_apply(fcn, x, return_features=("pool4",), compute_dtype=torch.bfloat16)
                yk = refinement_scan(lambda y: dae_logits(dae, y, h, depth=4, compute_dtype=torch.bfloat16),
                                     y0, eps=eps, num_steps=k)
            return yk.argmax(-1)

        fwd = flagship_forward_fn(eps=eps, num_steps=k, depth=3, compute_dtype=torch.bfloat16,
                                  with_labels=True)

        def half_labels(x, fwd=fwd):
            with torch.inference_mode():
                return fwd(fcn, flag_dae, x)[2]

        for name, res, fn in (("general", gen, general_labels), ("half", half, half_labels)):
            got = _miou_of(fn, val, dev)
            phase("search", f"{name} eps={eps} K={k}: engine run mIoU {got:.6f}, grid {res['miou'][ei, k]:.6f}")
            if abs(got - res["miou"][ei, k]) > 1e-6:
                raise AssertionError(f"{name} search grid disagrees with the engine at eps={eps} K={k}")

    # the CLI at full width (its own seeded random weights)
    buf = io.StringIO()
    refine_tail.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--synthetic", "--search", "--num-batches", "2", "--bf16", "--device", str(dev)])
    secs = time.perf_counter() - t0
    launches += refine_tail.launches
    lines = buf.getvalue().splitlines()
    for line in lines[:3]:
        phase("search", f"CLI: {line}")
    if not (rc == 0 and len(lines) == 3 + 1 + N_CLASSES and lines[0].startswith("val search: best eps=")
            and lines[1].startswith("step 0 (FCN-8 baseline): mIoU ") and " mIoU " in lines[2]
            and lines[3] == "per-class IoU (k=0 -> k=K):"):
        raise AssertionError(f"CLI printed {lines}")
    phase("search", f"CLI --synthetic --search --num-batches 2 --bf16: {secs:.1f} s wall, "
          f"refine_tail launches {refine_tail.launches}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 1

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi()
    phase("device", f"{kind} capability {cap} torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi, flush=True)
    if cap != (9, 0):
        raise AssertionError(f"the kernels are built for sm_90a; this card is {cap}")

    # one nvcc per source, all started together
    t0 = time.perf_counter()
    sources = ("refine_tail", "corruption", "vpu_probe")
    with ThreadPoolExecutor(len(sources)) as pool:
        libs = dict(zip(sources, pool.map(_build.build, sources)))
    for src, lib in libs.items():
        _build.load(src)
        phase("build", f"nvcc sm_90a {lib.name}; ptxas: {ptxas_summary(lib.with_suffix('.log'))}")
    phase("build", f"{len(libs)} kernels built in {time.perf_counter() - t0:.1f} s")

    worst, kreport = run_kernel_phase(dev)
    fcn, dae = full_width_params(dev)
    launches = run_serve_phase(dev, fcn, dae)
    run_parity_phase(fcn, dae)
    run_timing_phase(dev, fcn, dae, smi)

    creport = run_corrupt_phase(dev)
    workdir = _build.BUILD_DIR / "chip_smoke_train"
    shutil.rmtree(workdir, ignore_errors=True)
    train_launches, gt_workdir = run_train_phase(fcn, workdir)
    run_train_timing(dev, fcn, smi)
    run_train_parity(fcn)
    launches += run_train_serve_phase(dev, fcn, gt_workdir)
    shutil.rmtree(workdir)

    probe_err, probe_launches, probe_res = run_probe_phase(dev)
    general_launches, _ = run_general_phase(dev, fcn, smi)
    launches += general_launches
    launches += run_search_phase(dev, fcn, dae)

    step = kreport["step_bf16"]
    kernels = [{
        "name": "refine_tail", "route": "cuda",
        "source": "iterative_inference_segm_tpu_torch/csrc/refine_tail.cu",
        "replaces": "tools/tail_kernel_proto.py:41",
        "launches": launches, "max_abs_err": worst,
        "ms": step["ms"], "plain_ms": step["plain_ms"],
    }]
    for kname, line in (("corrupt_onehot", 59), ("corrupt_probs", 100)):
        main_path = creport[(kname, (TRAIN_BATCH, *CROP), SIGMA)]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "iterative_inference_segm_tpu_torch/csrc/corruption.cu",
            "replaces": f"iterative_inference_segm_tpu/ops/pallas/corruption_kernel.py:{line}",
            "launches": train_launches[kname],
            "max_abs_err": max(r["max_abs_err"] for k, r in creport.items() if k[0] == kname),
            "ms": main_path["ms"], "plain_ms": main_path["plain_ms"],
        })
    for kname, line, key in (("fma_chain", 30, ("fma", torch.float32, 100)),
                             ("pattern_softmax", 73, ("pattern", torch.float32))):
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "iterative_inference_segm_tpu_torch/csrc/vpu_probe.cu",
            "replaces": f"tools/vpu_probe.py:{line}",
            "launches": probe_launches[kname], "max_abs_err": probe_err[kname],
            "ms": probe_res[key]["ms"], "plain_ms": probe_res[key]["plain_ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
