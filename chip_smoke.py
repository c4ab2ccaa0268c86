#!/usr/bin/env python
"""Smoke run of the PyTorch port on one NVIDIA H100: builds the hand-written
kernels, holds each against its plain PyTorch version, serves requests
through the flagship half-engine ``Predictor`` at full width, holds the card
against the CPU, times the flagship forward, trains the DAE at full width in
the three corruption regimes, serves the DAE it trained, runs the K4/K5
throughput probes, serves through the general engine in score and energy
modes (and the 'sep'-tail flagship), runs the (eps, K) searches and the
``iterative_inference`` CLI, trains FCN-8 at full width, runs the synthetic
accuracy demo, serves the mirror DAE and the context module, drives the
data path (packed files on both wires, device prefetch, an EM dataset of two
classes) and the weight import and profiling utilities, then the parallel
layer: data-parallel training and serving, fc6/fc7 tensor parallelism and
the pipeline (serving, and gradients through it), in ranks that share the
card; then the measuring entry points: the bench, serving-bench and
training-bench twins and entry(); spatial (H) sharding; the phase-major
fused engine and its full-resolution step kernel; last, the twins of the
JAX system's decomposition probes.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases:
 1. device   -- a CUDA card is required (there is no CPU fallback)
 2. build    -- nvcc builds csrc/refine_tail.cu, csrc/corruption.cu,
                csrc/vpu_probe.cu and csrc/septail_step.cu for sm_90a, and
                g++ the native input runtime (native/input_runtime.cc), all
                at once
 3. kernel   -- the layouts (shapes, strides, dtypes) the engines hand
                refine_tail at its three call sites (half-engine step,
                rectification, general-engine step), all row-packed; the
                kernel against refine_tail_reference at those shapes in
                bf16 and f32 (the general step with bf16 logits beside the
                f32 iterate), timed warm and cold (L2 flushed) against its
                bound, with the share of the bound; then edge cases (crop
                offsets of 1, 3, 5 pixels, a ragged row, C in 1..32, y.W + b,
                and maps that are not row-packed, which must count as
                strided launches); the wide instance at C = 33, 64 and 128
                (also with y.W + b, bf16 logits and a strided map), timed
                cold at C = 64 and 128 on one 360x480 frame; C = 129 must
                raise
 4. serve    -- Predictor(engine="half") answers 3 requests (3, 8, 13
                images at 360x480, bf16, K=5) over seeded random weights at
                full width (FCN-8 fc 4096, C=11); the kernel's launch count
                must be (K+1) x chunks
 5. parity   -- one image in f32 on the card (TF32 off) against f32 on the CPU
 6. timing   -- flagship forward images/s at batch 8 and 32
 7. corrupt  -- K1 (corrupt_onehot) and K2 (corrupt_probs) bit-equal to
                their plain versions at the training shapes, sigma 0 and 1,
                timed warm and cold (L2 flushed) against their bound, beside
                a plain fill of the same output; bit-equal at the edge cases
                (C in 1..32 and, in the wide instance, 33, 64 and 128; a
                ragged last tile, void labels, bf16 and unaligned probs);
                C = 129 must raise; the wide instance timed cold at C = 64
                and 128 on the training crop; the registers, static SASS
                instructions and global stores of the C = 11 instances
 8. train    -- train_dae at full width (FCN-8 fc 4096, DAE stem 1 / depth 3,
                batch 32 of 360x480 frames cropped to 224 with flips, bf16,
                eval on full frames) in the gt, natural and mix regimes; the
                launch counts of K1/K2 must match the batches each regime
                sends through them; train images/s and the step's split
 9. tparity  -- one f32 train step on the card (TF32 off) against the CPU
10. tserve   -- Predictor.from_npz serves the best_dae.npz phase 8 wrote
11. probe    -- K4 (fma_chain) at n_fma 2, 26, 50, 100 and K5
                (pattern_softmax), bf16 and f32, each against its plain
                version; edge cases of their vector paths (K4 lengths that
                are no multiple of a vector and views at odd offsets; K5 at
                W that is no multiple of 4, C in 4, 11, 16, one row, a view
                off the vector's boundary); each case's time on the device
                alone, cold and warm, against its bound, beside an empty
                kernel's; then the probe tool's sweep (tools/vpu_probe.py):
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
14. fcn      -- train_fcn8 at full width (fc 4096, C=11, batch 10 of 360x480
                frames cropped to 224 with flips, bf16) for 2 epochs with a
                workdir (metrics.jsonl, best_fcn8.npz, ckpt/), resumed to a
                third; Predictor.from_npz serves the trained best_fcn8.npz;
                the train step at batch 32, crop 224 and 128, with and
                without remat (images/s, peak memory) and its split (crop +
                normalize, masks, forward, backward, Adam; fc6's forward and
                backward alone); then the train_fcn8 CLI for one epoch
15. fparity  -- one f32 FCN-8 train step card (TF32 off) vs CPU, batch 2,
                crop 224, the same crops and dropout masks
16. demo     -- the demo twin's main() for the flagship config at seed 1 at
                its defaults (96x128, fc 64; FCN-8 -> DAE -> (eps, K) search
                -> test mIoU): its JSON row, and refine_tail launched as the
                search's grid and the test refinement imply
17. arch     -- the mirror DAE (untied and tied, depth 4, widths 32..256,
                pool4) and the context module (on the input) at full width
                through Predictor(engine="general"), score (refine_tail K x
                chunks) and energy (none); one f32 image card vs CPU from the
                same y0 and taps (score: y_K; energy: one step, as phase
                12); general-engine images/s at batch 4, bf16; max_unpool
                card vs CPU bit for bit on tie cases; engine="half" refusing
                both archs
18. data     -- a synthetic CamVid (128 train, 16 val, 16 test at 360x480)
                packed by the pack_dataset twin; the val batch on the u8 wire
                normalized on the card against the f32 wire normalized by the
                native runtime (1e-6, labels equal); per wire, the runtime's
                ms a batch and the host->device copy's (pageable to_device
                against device_prefetch's pinned side stream), medians of 24
                batches of 32; one epoch of the train_dae twin per wire with
                --packed (bf16, batch 32; images/s, then under torch.profiler
                the device's idle share); the iterative_inference twin
                serving the test split on each wire (mIoU within 2e-4); one
                epoch through iterate_split and epoch_reshuffled over the
                frames in memory (the --data-root path, Pillow's decode aside)
19. em       -- a synthetic EM stack (512x512x1, C = 2, 24/3/3) packed; the
                train_dae twin --dataset em --packed --wire u8 in the gt and
                natural regimes (K1/K2 launches one a batch); the
                iterative_inference twin --search on the DAE it trained
                (refine_tail launches = grid + test); K1/K2 at 32x256x256x2
                bit-equal to their plain versions and K3 at the general step's
                4x512x512x2 against refine_tail_reference, cold against their
                bound
20. utils    -- the full-width FCN written as a Lasagne positional npz with
                the inverse converters, imported back bit for bit and served
                with --fcn-reference-npz (the lines of --fcn-npz); one short
                train_fcn8 twin epoch with --profile-dir, whose trace holds
                CUDA kernel events
Phases 21-25 run the parallel layer through parallel/launch.py in ranks
that share the one card over gloo (NCCL takes one card a rank); each
reference runs in rank 0, in one process, on the card; every time printed
is that of ranks sharing one card, not a multi-card figure:
21. dp       -- one train_dae step at full width (batch 32 split 16 + 16,
                crop 224, the CLI's DAE) on 2 ranks, f32 (gt regime, K1) and
                bf16 (natural, K2), held to the shards' averaged gradients
                and one Adam step (f32: loss and every param to 1e-5 of its
                leaf's largest; bf16: the loss to 1e-4); the f32 step again
                on 1 rank over NCCL, held to the plain single-device step;
                one train_fcn8 step (fc 4096, batch 10 split 5 + 5, own
                crops and masks a rank) held as phase 15 holds a step
22. dpserve  -- Predictor(mesh=...) at batch 8 on 2 ranks, 12 images (the
                last chunk short), half engine bf16 (argmax agreement with
                the single-device Predictor >= 0.999) and general f32
                (probabilities to 1e-5, labels equal but at near-ties)
23. tp       -- FCN-8 at fc 4096 on a ('model',) mesh of 2: the f32 forward
                and one f32 train step with given masks against the
                replicated run (logits, loss, gradients per leaf in norm to
                1e-5); each rank holds half of fc6/fc7 and their moments
24. pp       -- the flagship at batch 8 through make_pp_flagship: 2 stages
                (half bf16 at M = 2 and 4, general f32 with the DAE and the
                mirror DAE, Predictor(pp_mesh=...)), 3 stages (half, general)
                and DP x PP on ('data', 'stage') of (2, 2), held to the
                one-process engine on the same chunks (f32 to 1e-5, bf16 by
                argmax agreement >= 0.999), beside the agreement with one
                run of the whole batch; refine_tail launches only in the
                refinement stage
25. ppgrad   -- the gradient of mean(y_K^2) through make_pp_flagship (2
                stages, M = 2, batch 4, f32, K = 5) in every FCN-8 and DAE
                param, without and with remat, held to one process's
                gradient over the same microbatches (1e-5 of each leaf's
                largest) and remat to none; every rank returns the whole
                gradient; refine_tail (the kernel's forward under autograd)
                launched in the refinement stage only, again in the
                backward under remat
Each rank counts its own kernel launches; the kernel report adds them.
26. bench    -- the bench twin (tools/bench.py) as a user runs it, at its
                default (batch 128), batch 8 and 32, --steps 0, --preset fast
                and the general engine at batch 8 in score and energy mode:
                its JSON lines; refine_tail launched (K+1) a half-engine
                forward, K a general score forward, none in energy mode; the
                batch-8 and -32 readings beside phase 6's; fc6 alone at
                batch 8, 32 and 128 and its share of the forward
27. sbench   -- the serve_bench twin (tools/serve_bench.py) at batch 32, 4
                batches, 2 epochs, both wires: a packed file through the
                native runtime and device_prefetch into the flagship; its
                lines; refine_tail (K+1) a forward; the two wires' answers
                (sum(argmax(y_K)) a batch) agree
28. tbench   -- the train_bench twin (tools/train_bench.py) at batch 32,
                crop 224, augment on and off, without and with remat: its
                lines (images/s, GFLOPs an image, mfu_pct); K1 launched once
                a DAE step
29. entry    -- entry() (the flagship forward on its example arguments:
                finite, a softmax a pixel) and python -m ...entry's line
30. space    -- spatial (H) sharding at full width (fc 4096, C = 11,
                360x480, f32, TF32 off) in 2 ranks sharing the card over
                gloo, on ('data', 'space') (1, 2): the FCN-8 forward, the
                general engine (K = 3) and the half engine (K = 5) on batch
                2, and one DAE train step (gt regime, crop 224, K1 on the
                gathered labels), each held to the same process unsharded
                on the same card (y0 and y_K within 1e-4, argmax agreement
                >= 0.999; the step's loss within 1e-5, Adam's first moment
                per leaf within 1e-4 of its largest); the FCN forward's
                exchanges against the contract (neighbour transfers only,
                no all-gather at 12 /32 rows over 2 shards, no
                all-reduce); K3 at every layout the sharded engines handed
                it and K1 at the step's gathered labels against their plain
                versions (phase 3's and phase 7's limits), outside the
                counted runs; then python -m ...entry multichip 4 on the
                card (4 ranks sharing it; its launches are not counted)
31. fused    -- the phase-major engine: septail_step's instances (ptxas
                registers, spills, static shared memory, static SASS; each
                launch's dynamic shared memory, blocks an SM, 16-byte
                copies); the kernel against its plain
                version at the bench step as the bench twin's pipeline hands
                it (batch 128, C = 11, 360x480; bf16 carry within 2^-8 and
                argmax >= 99.9%, f32 carry within 1e-5), timed warm and cold
                (L2 flushed) against its bound, beside the plain version;
                at C = 2 and 33, a 2x2 frame (every tap on an edge), NHWC
                and channel-leading s, maps one position below and above a
                multiple of the 12 x 16 tile and smaller than one, y_ph
                staged by 16-byte copies and a value at a time (unaligned
                bf16 rows); C = 129 raises; the gradient through
                one kernel step against the plain version's, per leaf; the
                engine against the general engine with the 'sep' tail on
                the card (f32, TF32 off, batch 2: 1e-4, argmax >= 99.9%),
                make_fused_refiner card against CPU on one image (f32), and
                one bench forward (bf16 carry, batch 128) under
                torch.profiler (device time, idle share, septail_step's
                share); then, the counts set to 0: the bench twin --engine
                fused --dae-tail sep at batch 128 with a bf16 and an f32
                carry (septail_step K a forward, refine_tail none) and the
                fused_bench twin's four variants (images/s)
32. probes   -- the eighteen twins of the JAX system's decomposition probes
                (tools/{perf,pipeline,fcn_block,fwd_shape,half,core,
                tail_ops,dae_op,pool,fused,train_itemize,tailfold,tail2,
                scan_variants,int8,aug,aug_order,aug_step}_probe.py): first,
                not counted, their kernel rows at full width (batch 128)
                held to their plain versions (f32 1e-5, bf16 2^-8) and to
                their op-by-op rows (bf16 logits: 2^-8), argmax >= 99.9%:
                pipeline_probe's two tail rows (K3), fused_probe's phase
                step (S1), scan_variants_probe's pipeline step at an f32 and
                a bf16 carry (K3), tailfold_probe's port step (K3, against
                the op-by-op v2 step); the flagship forward as the bench
                twin runs it at batch 128 and 32 under torch.profiler
                (device time, idle share, top operations, fc6's
                convolutions' share); the top three device kernels of
                tail2_probe's three 11-channel conv rows (NHWC -> NHWC,
                NHWC -> NCHW, NCHW -> NCHW) and of tailfold_probe's v1 and
                v2 steps, traced in a fresh process; then, the counts set to
                0, each twin's main with
                --iters 2 --repeats 1 (perf_probe at batches 4..128): every
                JSON line its probe's and stamped with the card, each timed
                row's ms finite and positive, each asserted check within its
                limit, refine_tail and septail_step launched as the rows
                imply (scan_variants_probe's graph replays counted as the
                launches they captured); its wall time; half_probe's
                flagship pipeline beside the bench twin's batch 128,
                fcn_block_probe's fc6+fc7 delta beside fc6 alone at batch
                32, tailfold_probe's K = 5 loops beside the bench twin's
                folded forward; the seven twins added last, their wall time
Phases 4, 10, 12, 13, 16-20, 22, 24-27, 29 and 30 also assert that no refine_tail
launch of theirs took the kernel's strided staging. Every phase asserts; any failure
(in any rank) raises and the exit code is non-zero. The line before the last is the kernel
report (JSON: each kernel's launches on its path, error, times, bound and
what sets it), the last line the device report (JSON).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import io
import json
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from iterative_inference_segm_tpu_torch.data.camvid import iterate_split
from iterative_inference_segm_tpu_torch.data.config_datasets import CAMVID, DATASET_CONFIGS
from iterative_inference_segm_tpu_torch.data.loaders import epoch_reshuffled
from iterative_inference_segm_tpu_torch.data import native_loader
from iterative_inference_segm_tpu_torch.data.native_loader import NativeDataset
from iterative_inference_segm_tpu_torch.data.pipeline import draw_crop_and_flip, normalize_image
from iterative_inference_segm_tpu_torch.data.prefetch import device_prefetch
from iterative_inference_segm_tpu_torch.data.synthetic import synthetic_batches
from iterative_inference_segm_tpu_torch.inference import fused as fused_engine
from iterative_inference_segm_tpu_torch.inference.fused import flagship_forward_fn
from iterative_inference_segm_tpu_torch.inference.iterative import logits_refinement_scan, make_refiner
from iterative_inference_segm_tpu_torch.inference.predictor import Predictor
from iterative_inference_segm_tpu_torch.inference.search import grid_search_eps_k, grid_search_eps_k_half
from iterative_inference_segm_tpu_torch.models.dae import (
    DAE_H_CHANNELS,
    dae_apply,
    dae_core,
    dae_logits,
    init_dae,
)
from iterative_inference_segm_tpu_torch.models.fcn8 import dropout_masks, fcn8_apply, fcn8_backbone, fcn8_logits, init_fcn8
from iterative_inference_segm_tpu_torch.models.registry import (
    init_score_template,
    score_apply_fn,
    score_kwargs,
    score_logits_fn,
)
from iterative_inference_segm_tpu_torch.ops import _build
from iterative_inference_segm_tpu_torch.ops import corruption_kernel as ck
from iterative_inference_segm_tpu_torch.ops import vpu_probe as vp
from iterative_inference_segm_tpu_torch.ops.conv import conv2d, max_unpool
from iterative_inference_segm_tpu_torch.ops.metrics import confusion_matrix, metrics_from_confusion
from iterative_inference_segm_tpu_torch.ops.refine_tail import refine_tail, refine_tail_reference
from iterative_inference_segm_tpu_torch.ops.septail_step import kernel_plan as septail_plan
from iterative_inference_segm_tpu_torch.ops.septail_step import septail_step, septail_step_reference
from iterative_inference_segm_tpu_torch.scripts import demo_synthetic as demo
from iterative_inference_segm_tpu_torch.scripts import iterative_inference as cli
from iterative_inference_segm_tpu_torch.scripts import pack_dataset as pack_cli
from iterative_inference_segm_tpu_torch.scripts import train_dae as dae_cli
from iterative_inference_segm_tpu_torch.scripts import train_fcn8 as fcn_cli
from iterative_inference_segm_tpu_torch import entry as entry_point
from iterative_inference_segm_tpu_torch.entry import flagship_params
from iterative_inference_segm_tpu_torch.tools import bench as bench_tool
from iterative_inference_segm_tpu_torch.tools import fused_bench as fused_tool
from iterative_inference_segm_tpu_torch.tools import profile_general as profile_tool
from iterative_inference_segm_tpu_torch.tools import seed_replication, tail_bench
from iterative_inference_segm_tpu_torch.tools import serve_bench as serve_tool
from iterative_inference_segm_tpu_torch.tools import train_bench as train_tool
from iterative_inference_segm_tpu_torch.tools import vpu_probe as probe_tool
from iterative_inference_segm_tpu_torch.tools import (
    aug_order_probe,
    aug_probe,
    aug_step_probe,
    core_probe,
    dae_op_probe,
    fcn_block_probe,
    fused_probe,
    fwd_shape_probe,
    half_probe,
    int8_probe,
    perf_probe,
    pipeline_probe,
    pool_probe,
    scan_variants_probe,
    tail2_probe,
    tail_ops_probe,
    tailfold_probe,
    train_itemize_probe,
)
from iterative_inference_segm_tpu_torch.tools.timing import bf16, chained_ms, nvidia_smi
from iterative_inference_segm_tpu_torch.train.loop import TrainConfig, make_optimizer, to_device
from iterative_inference_segm_tpu_torch.train.train_dae import (
    draw_step_randomness,
    make_dae_train_step,
    train_dae,
)
from iterative_inference_segm_tpu_torch.train.train_fcn8 import StepRandomness as FCNStepRandomness
from iterative_inference_segm_tpu_torch.train.train_fcn8 import draw_step_randomness as draw_fcn_randomness
from iterative_inference_segm_tpu_torch.train.train_fcn8 import make_fcn8_train_step, train_fcn8
from iterative_inference_segm_tpu_torch.utils import profiling
from iterative_inference_segm_tpu_torch.utils.checkpoint import latest_step, save_npz
from iterative_inference_segm_tpu_torch.utils.import_weights import FCN8_LASAGNE_ORDER, import_lasagne_npz
from iterative_inference_segm_tpu_torch.utils.jax_bridge import params_to_jax

K_STEPS = 5
EPS = 0.1
WIDE_CLASSES = (33, 64, 128)  # class counts of the kernels' wide instances; one more must raise
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

# K1/K2 are held bit-equal to their plain versions on the card (the same
# hash, the same f32 operations in the same order, the same libm); their
# rows sum to 1 within f32 rounding of C terms.
CORRUPT_SUM_TOL = 1e-5
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
# The mirror DAE's unpool switches add discontinuities of their own: a CPU
# rehearsal at 48x64 read 5.4e-2 for the CPU against itself (Jacobian
# term). So the limit is the larger of ENERGY_GRAD_REL_TOL and twice that
# run's own CPU-against-CPU reading, capped at 0.5, where every planted
# gradient (1.0 and above) still fails.
ENERGY_GRAD_NOISE_CAP = 0.5


# The FCN-8 training cell: the CLI's batch of 10 full frames cropped in-step
# to 224x224 with flips, bf16 over f32 master weights; timed at batch 32.
FCN_BATCH = 10
FCN_TRAIN_BATCHES = 3
FCN_TIMING_CROPS = (CROP, (128, 128))
# One f32 FCN-8 train step, card (TF32 off) against CPU (run_fcn_parity):
# the loss and the updated params at phase 9's 1e-4, each leaf's Adam first
# moment in norm at 1e-2 (planted errors read 1.0 and 2.0).
FCN_PARITY_TOL = 1e-4
FCN_PARITY_GRAD_TOL = 1e-2
# where both gradients exceed 1e4 x Adam's epsilon, its first step is lr
# within lr * 1e-4 on both sides: within 1e-4 of a leaf's largest entry,
# since every entry moves by up to lr (a bias leaf starts at 0)
FCN_PARITY_MIN_GRAD = 1e-4
# The demo's val and test splits (3 and 4 batches, scripts/demo_synthetic.py)
DEMO_VAL_BATCHES = 3
DEMO_TEST_BATCHES = 4

# The data phase (18): a synthetic CamVid packed at full size (360x480),
# read at the trainers' batch of 32; each timing is a median over this many
# batches. The u8 wire normalized on the card against the f32 wire
# normalized by the runtime: both compute (x/255 - mean)/std in f32, the
# runtime with x * (1/255) and * (1/std), so they differ by an ulp or two of
# values under 2.1 (2.4e-7 an ulp).
DATA_SPLITS = {"train": 128, "val": 16, "test": 16}
DATA_TIMED_BATCHES = 24
WIRE_TOL = 1e-6
# The two wires served through the CLI (f32, general engine, the same
# frames) agree on every pixel but those whose argmax the ulps above flip
WIRE_MIOU_TOL = 2e-4
# The EM phase (19): the ISBI split (24/3/3) of synthetic 512x512 frames,
# C = 2, trained for two epochs a regime at the batch of 32 (one padded
# batch of train and one of val an epoch)
EM_SPLITS = {"train": 24, "val": 3, "test": 3}
EM_EPOCHS = 2
EM = DATASET_CONFIGS["em"]

# Operations an element, for the operations side of each bound. K1/K2:
# counted once from the SASS of the fast paths on sm_90a (a multiply-add
# counts 2; moves, branches and addressing do not); K1's one-hot (a
# compare-select) adds 1. K5, with the same counts for expf and the divide:
# the class scale, three shifted multiply-adds, the class-3 multiply-add and
# the softmax.
CORRUPT_OPS = (
    1  # the counter, pixel * 128 + class
    + 2 * (2 + 6 + 2)  # two murmur3 hashes: multiply-add with the seed, 3 shift-xors, 2 multiplies
    + 2 * 4  # two uniforms: shift, convert, add, multiply
    + 36 + 9 + 29  # the fast paths of logf, sqrtf, cosf
    + 3 + 2  # Box-Muller's three multiplies; the scaled add
    + 1 + 1 + 12 + 1 + 12  # softmax: max, subtract, expf, sum, the IEEE divide
)
PATTERN_OPS = (
    1 + 3 * 2 + 2  # the class scale; the left, right and lower neighbours; class 3's value added
    + 1 + 1 + 12 + 1 + 12  # softmax: max, subtract, expf, sum, the IEEE divide
)


def cuda_ms(fn, iters: int) -> float:
    """ms a call of ``fn`` on the card: the best of 3 chained blocks of
    ``iters`` calls (``tools/timing.chained_ms``, the benches' timer)."""
    return chained_ms(fn, iters, device="cuda", accumulate=False)[0]


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def reset_tail_counts() -> None:
    refine_tail.launches = 0
    refine_tail.strided_launches = 0


def check_no_strided(tag: str) -> None:
    """The engines hand the kernel row-packed maps only: no launch of the
    main path takes its strided staging."""
    if refine_tail.strided_launches:
        raise AssertionError(f"{tag}: {refine_tail.strided_launches} refine_tail launches took the strided staging")


def clocks() -> str:
    """The card's SM clock (now and its maximum), power draw and
    temperature, read beside a timing."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def kernel_name(mangled: str) -> str:
    """'kernel<template args>' of a mangled entry name, the template args as
    mangled (e.g. ``Lb1ELi11ELb1`` for <true, 11, true>)."""
    k = re.search(r"\d+([A-Za-z][A-Za-z_]*_kernel)I(\w+?)EE", mangled)
    return f"{k.group(1)}<{k.group(2)}>" if k else mangled[:40]


def ptxas_entries(log) -> dict[str, tuple[int, str, int]]:
    """(registers, 'spill stores/loads', static shared bytes) of each entry
    function of an ``nvcc -Xptxas -v`` log, keyed by ``kernel_name``
    (dynamic shared memory is the launch's, not the compiler's)."""
    out, entry, spill = {}, "?", ""
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = kernel_name(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = f"spill {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            out[entry] = (int(m.group(1)), spill, int(smem.group(1)) if smem else 0)
    return out


def ptxas_summary(log) -> str:
    """'kernel<template args>: registers, spill stores/loads' per entry
    function of an ``nvcc -Xptxas -v`` log."""
    return " | ".join(f"{k}: {r} regs, {s}" for k, (r, s, _) in ptxas_entries(log).items())


def sass_counts(lib) -> dict[str, dict[str, int]]:
    """Static SASS of each kernel in a built library (``cuobjdump -sass``,
    beside nvcc), keyed by ``kernel_name``: its instructions, and its global
    stores of 16 bytes (``STG.E.128``) and of 4 (``STG.E``)."""
    cuobjdump = str(pathlib.Path(_build.find_nvcc()).with_name("cuobjdump"))
    out = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True, check=True,
                         timeout=120).stdout
    counts, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = kernel_name(m.group(1))
            counts[name] = {"instructions": 0, "stg128": 0, "stg32": 0}
        elif name is not None and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            counts[name]["instructions"] += 1
            counts[name]["stg128"] += bool(re.search(r"\bSTG\.E\.128\b", line))
            counts[name]["stg32"] += bool(re.search(r"\bSTG\.E\s", line))
    return counts


def split_flags(splits: dict) -> list[str]:
    """pack_dataset's --num-train/--num-val/--num-test for ``splits``."""
    return [arg for split, n in splits.items() for arg in (f"--num-{split}", str(n))]


def run_cli(main_fn, argv) -> tuple[list[str], float]:
    """A CLI twin's ``main(argv)`` in this process: its printed lines and
    its wall seconds (the device synchronized); a non-zero code raises."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main_fn([str(a) for a in argv])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    if rc != 0:
        raise AssertionError(f"{main_fn.__module__} {argv} returned {rc}: {lines[-5:]}")
    return lines, secs


def last_epoch(workdir) -> dict:
    """The last line of a trainer's ``metrics.jsonl``."""
    rows = [json.loads(ln) for ln in (pathlib.Path(workdir) / "metrics.jsonl").read_text().splitlines()]
    if not rows or not np.isfinite([rows[-1]["train_loss"], rows[-1]["val_loss"]]).all():
        raise AssertionError(f"{workdir}: metrics {rows}")
    return rows[-1]


def edge_cases(dev, gen):
    """(name, dtype, u, y, v, w, b, with_labels, strided) beyond the main
    path's shapes: u wider and taller by 1, 3 and 5 pixels (a row span of u
    then starts 2 bytes into a 16-byte chunk in bf16), a row of 301 pixels
    (no multiple of the kernel's tile), C in {1, 11, 16, 17, 32}, K3's own
    function (u + y.W + b), and u and v laid out as NCHW memory (not
    row-packed), which must take the kernel's strided staging."""
    def probs(shape):
        return torch.softmax(torch.randn(shape, generator=gen) * 3.0, -1)

    def logits(shape):
        return torch.randn(shape, generator=gen) * 3.0

    def nchw_memory(t):
        return t.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)

    step = (BATCH, H // 2, W // 2, N_CLASSES)
    cases = []
    for dt in (torch.bfloat16, torch.float32):
        tag = "bf16" if dt == torch.bfloat16 else "f32"
        for d in (1, 3, 5):
            cases.append((f"crop+{d}_{tag}", dt, logits((BATCH, H // 2 + d, W // 2 + d, N_CLASSES)),
                          probs(step), logits(step), None, None, False, False))
        cases.append((f"ragged_{tag}", dt, logits((4, 31, 304, N_CLASSES)), probs((4, 30, 301, N_CLASSES)),
                       logits((4, 30, 301, N_CLASSES)), None, None, True, False))
        for c in (1, 11, 16, 17, 32):
            cases.append((f"C={c}_{tag}", dt, logits((2, 25, 203, c)), probs((2, 24, 200, c)),
                          logits((2, 24, 200, c)), None, None, True, False))
        wm = torch.randn((N_CLASSES, N_CLASSES), generator=gen) * 0.5
        bias = torch.randn((N_CLASSES,), generator=gen)
        cases.append((f"w_{tag}", dt, logits(step), probs(step), None, wm, bias, True, False))
        cases.append((f"strided_{tag}", dt, nchw_memory(logits((BATCH, H // 2 + 3, W // 2 + 5, N_CLASSES))),
                      probs(step), nchw_memory(logits(step)), None, None, True, True))
        # the wide instance (a pixel's classes in shared memory): 33..128 classes
        for c in WIDE_CLASSES:
            cases.append((f"C={c}_{tag}", dt, logits((2, 25, 203, c)), probs((2, 24, 200, c)),
                          logits((2, 24, 200, c)), None, None, True, False))
        wm = torch.randn((40, 40), generator=gen) * 0.5
        cases.append((f"w_C=40_{tag}", dt, logits((2, 24, 200, 40)), probs((2, 24, 200, 40)), None, wm,
                      torch.randn((40,), generator=gen), True, False))
        cases.append((f"strided_C=33_{tag}", dt, nchw_memory(logits((2, 25, 203, 33))), probs((2, 24, 200, 33)),
                      nchw_memory(logits((2, 24, 200, 33))), None, None, True, True))

    def on_card(t, dt=None):  # .to keeps a dense map's strides
        return None if t is None else t.to(dev, dt or t.dtype)

    cases = [
        (name, dt, on_card(u, dt), on_card(y, dt), on_card(v, dt), on_card(wm), on_card(bias), lab, strided)
        for name, dt, u, y, v, wm, bias, lab, strided in cases
    ]
    # the general engine's pair at 128 classes: bf16 logits beside an f32 iterate
    u, y = logits((2, 25, 203, 128)), probs((2, 24, 200, 128))
    cases.append(("C=128_bf16_u", torch.float32, on_card(u, torch.bfloat16), on_card(y), None, None, None, True,
                  False))
    return cases


def check_kernel_case(name, got, ref, with_labels, dtype):
    """The kernel's output against the plain version's; returns (max abs
    err, argmax agreement)."""
    g_y, r_y = (got[0], ref[0]) if with_labels else (got, ref)
    err = (g_y.float() - r_y.float()).abs().max().item()
    agree = (g_y.float().argmax(-1) == r_y.float().argmax(-1)).float().mean().item()
    if with_labels:
        lab_agree = (got[1] == ref[1]).float().mean().item()
        if got[1].dtype != torch.int32 or lab_agree < MIN_ARGMAX_AGREE:
            raise AssertionError(f"{name}: labels agree {lab_agree:.6f} ({got[1].dtype})")
        if not torch.equal(got[1], g_y.float().argmax(-1).to(torch.int32)):
            raise AssertionError(f"{name}: kernel labels differ from the argmax of its own y'")
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    if not err <= tol or agree < MIN_ARGMAX_AGREE:
        raise AssertionError(f"{name}: max abs err {err:.3e} (tol {tol:.1e}), argmax agree {agree:.6f}")
    return err, agree


def run_kernel_phase(dev, fcn, dae, gdae):
    """Step 0, the layouts the engines hand the kernel at its three call
    sites; then refine_tail against its plain version at those sites'
    shapes (timed warm and cold against the bound) and at the edge cases."""
    seen = tail_bench.record_main_path(dev, fcn, dae, gdae)
    for site, rec in seen.items():
        phase("kernel", f"layout at {site}: " + "; ".join(
            f"{k} {r['shape']} stride {r['stride']} {r['dtype']} row-packed {r['row_packed']}"
            for k, r in rec.items() if isinstance(r, dict)) + f"; labels {rec['labels']}")
        if not all(r["row_packed"] for r in rec.values() if isinstance(r, dict)):
            raise AssertionError(f"the engines hand the kernel a map that is not row-packed at {site}")
    worst = 0.0
    report = {}
    flush = tail_bench.flush_buffer(dev)
    for case in tail_bench.main_path_cases(dev, seen):
        strided = refine_tail.strided_launches
        got, ref = case.kernel(), case.plain()
        torch.cuda.synchronize()
        if refine_tail.strided_launches != strided:
            raise AssertionError(f"{case.name}: a main-path layout took the strided staging")
        err, agree = check_kernel_case(case.name, got, ref, case.with_labels, case.y.dtype)
        worst = max(worst, err)
        t = tail_bench.time_case(case, flush)
        report[case.name] = {"max_abs_err": err, "argmax_agree": agree, **t}
        phase("kernel", f"{case.name:12s} y={tuple(case.y.shape)} {str(case.y.dtype)[6:]} "
              f"u={tuple(case.u.shape)} {str(case.u.dtype)[6:]} max_abs_err={err:.3e} argmax_agree={agree:.6f}; "
              + tail_bench.report(t))
    gen = torch.Generator().manual_seed(0)
    for name, dt, u, y, v, wm, bias, lab, strided in edge_cases(dev, gen):
        before = refine_tail.strided_launches
        got = refine_tail(u, y, EPS, v=v, w=wm, b=bias, with_labels=lab)
        ref = refine_tail_reference(u, y, EPS, v=v, w=wm, b=bias, with_labels=lab)
        torch.cuda.synchronize()
        if refine_tail.strided_launches - before != int(strided):
            raise AssertionError(f"{name}: strided launches {refine_tail.strided_launches - before}, "
                                 f"expected {int(strided)}")
        err, agree = check_kernel_case(name, got, ref, lab, dt)
        worst = max(worst, err)
        phase("kernel", f"{name:12s} y={tuple(y.shape)} u={tuple(u.shape)} stride {u.stride()} "
              f"max_abs_err={err:.3e} argmax_agree={agree:.6f} strided={strided}")
    # the wide instance on one frame, cold against its byte bound; it runs on
    # no path of the datasets the repo has
    for c in WIDE_CLASSES[1:]:
        for tag, dt_y, dt_u in (("f32", torch.float32, torch.float32), ("bf16", torch.bfloat16, torch.bfloat16)):
            y = torch.softmax(torch.randn((1, H, W, c), generator=gen) * 3.0, -1).to(dev, dt_y)
            u = (torch.randn((1, H, W, c), generator=gen) * 3.0).to(dev, dt_u)
            case = tail_bench.Case(f"wide C={c} {tag}", u, y)
            err, _ = check_kernel_case(case.name, case.kernel(), case.plain(), False, dt_y)
            worst = max(worst, err)
            phase("kernel", f"{case.name} y={tuple(y.shape)} max_abs_err={err:.3e}; "
                  + tail_bench.report(tail_bench.time_case(case, flush)))
    too_many = WIDE_CLASSES[-1] + 1
    u = torch.zeros((1, 4, 8, too_many), device=dev)
    before = refine_tail.launches
    try:
        refine_tail(u, u, EPS)
    except ValueError as e:
        phase("kernel", f"C={too_many} on the card raises: {e}")
    else:
        raise AssertionError(f"refine_tail took {too_many} classes on the card")
    if refine_tail.launches != before:
        raise AssertionError("the refused call counted a launch")
    return worst, report


def run_serve_phase(dev, fcn, dae):
    pred = Predictor(
        fcn, dae, device=dev, engine="half", batch_size=BATCH, compute_dtype=torch.bfloat16,
        num_steps=K_STEPS, eps=EPS, dae_kwargs={"depth": 3, "encoder": "pool"},
    )
    rng = np.random.default_rng(0)
    requests = [rng.random((n, H, W, 3), dtype=np.float32) for n in (3, 8, 13)]
    chunks = sum(-(-len(r) // BATCH) for r in requests)
    reset_tail_counts()
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
    check_no_strided("serve")
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
    ips_of = {}
    for batch in (8, 32):
        x = torch.randn((batch, H, W, 3), generator=torch.Generator().manual_seed(2)).to(dev)
        with torch.inference_mode():
            ms = cuda_ms(lambda: fwd(fcn, dae, x), iters=20)
            ms_k0 = cuda_ms(lambda: fwd_k0(fcn, dae, x), iters=10)
        ips = ips_of[batch] = batch * 1000.0 / ms
        phase("timing", f"flagship bf16 K={K_STEPS} batch {batch}: {ms:.2f} ms/batch, "
              f"{ips:.1f} images/s; K=0 (FCN + rectification) {ms_k0:.2f} ms/batch; on {smi}; "
              f"clocks.sm, max, power, temp: {clocks()}")
    phase("timing", f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return ips_of


def _labels_with_void(shape, gen):
    lab = torch.randint(0, N_CLASSES, shape, generator=gen, dtype=torch.int32)
    void = torch.rand(shape, generator=gen) < 0.02
    return torch.where(void, torch.full_like(lab, CAMVID.void_label), lab)


def corrupt_edge_cases(dev, gen):
    """(name, kernel, plain version, input on the card, kwargs) of K1 and K2
    beyond the main path's shapes: C in {1, 2, 11, 16, 17, 32} (the exact
    C = 11 instance and the general one) and {33, 64, 128} (the wide one, a
    pixel's classes in shared memory); 3 x 45 x 61 = 8235 pixels, whose last
    128-pixel tile holds 43 (473 elements at C = 11, so the stores' scalar
    tail runs; the wide instance's last 64-pixel tile holds 43 too); labels from -2 to C + 1 (void below 0 and at or above
    C); probs in bf16 (the wrapper widens them) and 4 bytes past a 16-byte
    boundary (the kernel stages them element by element)."""
    shape = (3, 45, 61)
    cases = []
    for c in (1, 2, 11, 16, 17, 32, *WIDE_CLASSES):
        lab = torch.randint(-2, c + 2, shape, generator=gen, dtype=torch.int32).to(dev)
        probs = torch.softmax(torch.randn((*shape, c), generator=gen) * 3.0, -1).to(dev)
        cases.append((f"onehot C={c}", ck.corrupt_onehot, ck.corrupt_onehot_kernel_reference, lab,
                      {"n_classes": c}))
        cases.append((f"probs C={c}", ck.corrupt_probs, ck.corrupt_probs_kernel_reference, probs, {}))
    probs = torch.softmax(torch.randn((*shape, N_CLASSES), generator=gen) * 3.0, -1).to(dev)
    buf = torch.empty(probs.numel() + 1, device=dev)
    buf[1:].copy_(probs.reshape(-1))
    unaligned = buf[1:].view(probs.shape)
    if unaligned.data_ptr() % 16 == 0:
        raise AssertionError("the unaligned case is 16-byte aligned")
    cases.append(("probs bf16", ck.corrupt_probs, ck.corrupt_probs_kernel_reference, probs.to(torch.bfloat16), {}))
    cases.append(("probs unaligned", ck.corrupt_probs, ck.corrupt_probs_kernel_reference, unaligned, {}))
    return cases


CORRUPT_SEED = 0x9E3779B9


def check_and_time_corrupt(name, fn, ref, src, kw, shape, flush, void=None, tag="corrupt"):
    """One of K1/K2 on one input: bit-equal to its plain version, rows
    summing to 1, then cold and warm against the bound."""
    seed = CORRUPT_SEED
    sigma, n_classes = kw["sigma"], kw.get("n_classes", src.shape[-1])
    got = fn(src, seed, **kw)
    want = ref(src, seed, **kw)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    sum_err = (got.sum(-1) - 1.0).abs().max().item()
    if not (torch.equal(got, want) and sum_err <= CORRUPT_SUM_TOL):
        raise AssertionError(f"{name} {shape} C={n_classes} sigma={sigma}: not bit-equal to its plain version "
                             f"(max abs err {err:.3e}) or row sums off by {sum_err:.3e}")
    if void is not None and sigma == 0.0:
        rows = got[void]
        if not torch.equal(rows, torch.full_like(rows, 1.0 / n_classes)):
            raise AssertionError("void rows at sigma 0 are not exactly uniform")
    del want
    cold, ahead_cold = tail_bench.device_times(lambda: fn(src, seed, **kw), flush=flush)
    warm, ahead_warm = tail_bench.device_times(lambda: fn(src, seed, **kw))
    plain_ms = cuda_ms(lambda: ref(src, seed, **kw), 5)
    out = torch.empty_like(got)
    fill_ms = cuda_ms(lambda: out.fill_(0.5), 20)
    nbytes = src.numel() * src.element_size() + got.numel() * got.element_size()
    ops = (CORRUPT_OPS + (name == "corrupt_onehot")) * got.numel()
    t = {"max_abs_err": err, "ms": statistics.median(cold), "warm_ms": warm[0], "plain_ms": plain_ms,
         **tail_bench.bound_ms(nbytes, ops)}
    phase(tag, f"{name:14s} {tuple(got.shape)} sigma={sigma}: bit-equal, row_sum_err="
          f"{sum_err:.1e}; cold {t['ms']:.4f} ms (launches {min(cold):.4f}..{max(cold):.4f}), warm "
          f"{t['warm_ms']:.4f}, plain {plain_ms:.4f}, store floor {fill_ms:.4f} "
          f"({got.numel() * 4 / 1e6:.1f} MB); {nbytes / 1e6:.1f} MB, {ops / 1e9:.3f} G operations, "
          f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}), share {t['bound_ms'] / t['ms']:.1%} cold "
          f"({t['bound_ms'] / t['warm_ms']:.1%} warm); host ahead {ahead_cold and ahead_warm}")
    return t


def run_corrupt_phase(dev):
    """K1 and K2 bit-equal to their plain versions at the training shapes
    (the train step's crop, and the eval step's full frames), timed warm and
    cold against their bound; the wide instance (33..128 classes) timed at
    C = 64 and 128; the edge cases; one class more than the counter has room
    for must raise; then the registers and SASS of the instances the main
    path launches."""
    gen = torch.Generator().manual_seed(3)
    flush = tail_bench.flush_buffer(dev)
    seed = CORRUPT_SEED
    report = {}
    for shape in ((TRAIN_BATCH, *CROP), (BATCH, H, W)):
        labels = _labels_with_void(shape, gen).to(dev)
        probs = torch.softmax(torch.randn((*shape, N_CLASSES), generator=gen) * 3.0, -1).to(dev)
        void = labels == CAMVID.void_label
        for sigma in (0.0, SIGMA):
            report["corrupt_onehot", shape, sigma] = check_and_time_corrupt(
                "corrupt_onehot", ck.corrupt_onehot, ck.corrupt_onehot_kernel_reference, labels,
                {"n_classes": N_CLASSES, "sigma": sigma}, shape, flush, void)
            report["corrupt_probs", shape, sigma] = check_and_time_corrupt(
                "corrupt_probs", ck.corrupt_probs, ck.corrupt_probs_kernel_reference, probs, {"sigma": sigma}, shape,
                flush)
    # the wide instance at the training crop, batch 8; it runs on no path of
    # the datasets the repo has
    shape = (BATCH, *CROP)
    for c in WIDE_CLASSES[1:]:
        labels = torch.randint(-1, c + 1, shape, generator=gen, dtype=torch.int32).to(dev)
        probs = torch.softmax(torch.randn((*shape, c), generator=gen) * 3.0, -1).to(dev)
        check_and_time_corrupt("corrupt_onehot", ck.corrupt_onehot, ck.corrupt_onehot_kernel_reference, labels,
                               {"n_classes": c, "sigma": SIGMA}, shape, flush)
        check_and_time_corrupt("corrupt_probs", ck.corrupt_probs, ck.corrupt_probs_kernel_reference, probs,
                               {"sigma": SIGMA}, shape, flush)
        del labels, probs
    edge = corrupt_edge_cases(dev, gen)
    for sigma in (0.0, SIGMA):
        for cname, fn, ref, src, kw in edge:
            got = fn(src, seed, sigma=sigma, **kw)
            want = ref(src, seed, sigma=sigma, **kw)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"{cname} sigma={sigma}: max abs err {(got - want).abs().max().item():.3e}, "
                                     "not bit-equal to the plain version")
    phase("corrupt", f"bit-equal at sigma 0 and {SIGMA}: " + ", ".join(c[0] for c in edge))
    too_many = WIDE_CLASSES[-1] + 1
    for name, call in (
        ("corrupt_onehot", lambda: ck.corrupt_onehot(torch.zeros((4, 8), dtype=torch.int32, device=dev), seed,
                                                     n_classes=too_many, sigma=SIGMA)),
        ("corrupt_probs", lambda: ck.corrupt_probs(torch.zeros((4, 8, too_many), device=dev), seed, sigma=SIGMA)),
    ):
        try:
            call()
        except ValueError as e:
            phase("corrupt", f"C={too_many} on the card raises: {e}")
        else:
            raise AssertionError(f"{name} took {too_many} classes on the card")
    # The C = 11 instances: every class loop exact, each class stored to
    # shared memory, the tile written with 16-byte global stores (one
    # scalar store for its tail).
    lib = _build.build("corruption")
    regs, sass = ptxas_entries(lib.with_suffix(".log")), sass_counts(lib)
    for kname, inst in (("corrupt_onehot", "corrupt_kernel<Lb1ELi11ELb1>"),
                        ("corrupt_probs", "corrupt_kernel<Lb0ELi11ELb1>")):
        if inst not in sass or inst not in regs:
            raise AssertionError(f"no SASS or ptxas entry for {inst} in {sorted(sass)}")
        s = sass[inst]
        if s["stg128"] < 1:
            raise AssertionError(f"{inst} has no 16-byte global store")
        phase("corrupt", f"{kname}: {inst} {regs[inst][0]} registers, {regs[inst][1]}; {s['instructions']} static "
              f"SASS instructions, global stores {s['stg128']} of 16 bytes and {s['stg32']} of 4")
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
    step_ms = cuda_ms(lambda: train_step(dae, fcn, x, y, rand), iters=20)
    xc, yc = stages.prepare(x, y, rand)
    probs, h = stages.features(fcn, xc)  # no probs: the gt regime reads none
    y_tilde = stages.corrupt(yc, probs, rand)

    def dae_fwd_bwd():
        opt.zero_grad(set_to_none=True)
        stages.loss(dae, y_tilde, h, yc)[0].backward()

    split = {
        "crop+normalize": cuda_ms(lambda: stages.prepare(x, y, rand), iters=20),
        "frozen FCN to pool4": cuda_ms(lambda: stages.features(fcn, xc), iters=20),
        "corruption (K1)": cuda_ms(lambda: stages.corrupt(yc, probs, rand), iters=20),
        "DAE forward+backward": cuda_ms(dae_fwd_bwd, iters=20),
        "optimizer step": cuda_ms(opt.step, iters=20),
    }
    ips = TRAIN_BATCH * 1000.0 / step_ms
    phase("timing", f"DAE train step bf16 batch {TRAIN_BATCH} crop {CROP[0]}: {step_ms:.2f} ms/step, "
          f"{ips:.1f} images/s; on {smi}; clocks.sm, max, power, temp: {clocks()}")
    for name, ms in split.items():
        phase("timing", f"  {name:22s} {ms:8.3f} ms  {100.0 * ms / step_ms:5.1f}% of the step")
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
    reset_tail_counts()
    labels, probs = pred.predict(images, return_probs=True)
    torch.cuda.synchronize()
    if labels.shape != (3, H, W) or labels.dtype != np.int32:
        raise AssertionError(f"labels {labels.shape} {labels.dtype}")
    if not np.isfinite(probs).all() or float(np.abs(probs.sum(-1) - 1.0).max()) > 1e-2:
        raise AssertionError("served probabilities not finite or off the simplex")
    if refine_tail.launches != K_STEPS + 1:
        raise AssertionError(f"refine_tail launched {refine_tail.launches} times")
    check_no_strided("tserve")
    phase("tserve", f"best_dae.npz from the gt regime served 3 images at {H}x{W}: labels "
          f"{labels.shape} int32, classes used {len(np.unique(labels))}, refine_tail launches "
          f"{refine_tail.launches}")
    return refine_tail.launches


def probe_edge_cases(dev, gen):
    """(name, kernel call, plain call, f32 tolerance or None for bit-equal)
    of K4 and K5 beyond the probe's shapes, in f32 and bf16. K4 (n_fma = 45:
    the loop unrolled by 32, the one by 8, the remainder): lengths that are
    no multiple of a 16-byte vector, and views 1, 3 and 5 elements into an
    aligned buffer (a scalar head, the vectors, a scalar tail). K5: C in
    {4, 11, 16}; W = 7, 33 and 1 (no multiple of the 4 w a thread takes:
    tiles whose spans start off a 16-byte boundary, computed one w a
    thread); one row (none below); 4 and 5 rows (last tiles of 1 and 2);
    W = 700; 16 x 1000, of which only one row fits a tile in f32; a view
    of W = 8 one element off the 4-element boundary."""
    cases = []
    w8 = tuple(torch.linspace(0.9, 1.1, 8).tolist())
    for dt in probe_tool.DTYPES:
        tag = str(dt).removeprefix("torch.")
        for length, offset in ((1, 0), (7, 0), (9, 0), (1003, 0), (1000, 1), (1003, 3), (37, 5)):
            x = torch.randn(length + offset, generator=gen).to(dev, dt)[offset:]
            cases.append((f"fma_chain {tag} n={length} at element {offset}", "fma_chain",
                          lambda x=x: vp.fma_chain(x, w8, 45), lambda x=x: vp.fma_chain_reference(x, w8, 45), None))
        shapes = [(2, 1, 4, 7), (2, 1, 11, 33), (1, 1, 16, 240), (2, 3, 11, 7), (1, 5, 16, 33), (2, 3, 4, 240),
                  (1, 2, 11, 700), (3, 4, 11, 1), (1, 4, 16, 1000)]
        views = [torch.randn(s, generator=gen).to(dev, dt) for s in shapes]
        views.append(torch.randn(1 + 2 * 3 * 11 * 8, generator=gen).to(dev, dt)[1:].view(2, 3, 11, 8))
        for x in views:
            k = torch.linspace(0.5, 1.5, x.shape[2], device=dev)
            off = (x.data_ptr() % 16) // x.element_size()
            cases.append((f"pattern_softmax {tag} {tuple(x.shape)} at element {off}", "pattern_softmax",
                          lambda x=x, k=k: vp.pattern_softmax(x, k),
                          lambda x=x, k=k: vp.pattern_softmax_reference(x, k), PATTERN_F32_TOL))
    return cases


def run_probe_phase(dev):
    """K4/K5 against their plain versions at the probe's shapes (one launch
    each) and at the edge cases of their vector paths; their times on the
    device alone against their bounds; then the probe tool's sweep with the
    launch counts set to 0 just before it. The chain's values grow ~(1 + n)
    a launch and reach inf, so only the single launches are compared."""
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
    for name, kernel, call, plain, f32_tol in probe_edge_cases(dev, torch.Generator().manual_seed(12)):
        got, want = call(), plain()
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        if got.dtype == torch.float32:
            ok = torch.equal(got, want) if f32_tol is None else err <= f32_tol
        elif kernel == "fma_chain":
            ok = bool(((got.float() - want.float()).abs() <= 2.0**-7 * want.float().abs()).all())
        else:
            ok = err <= BF16_TOL
        worst[kernel] = max(worst[kernel], err)
        if not ok or got.shape != want.shape or not got.is_contiguous():
            raise AssertionError(f"{name}: disagrees with its plain version (max abs err {err:.3e})")
        phase("probe", f"{name}: max abs err {err:.3e}")
    try:  # a tile of one 16 x 1300 f32 row, the row below and the results is over a block's shared memory
        vp.pattern_softmax(torch.zeros((1, 2, 16, 1300), device=dev), torch.ones(16, device=dev))
    except ValueError as e:
        phase("probe", f"pattern_softmax refuses a row that does not fit: {e}")
    else:
        raise AssertionError("pattern_softmax took a row that does not fit a block's shared memory")

    # each case on the device alone (cold after a read flush of the L2, and
    # warm), against its bound; an empty kernel through the same route
    alone = probe_tool.device_sweep(dev)
    numel = probe_tool.B * probe_tool.R * probe_tool.C * probe_tool.W
    for key, t in alone.items():
        if key == "empty":
            continue
        size = torch.empty((), dtype=key[1]).element_size()
        if key[0] == "fma":
            n, ops = numel * probe_tool.NH, 2 * key[2] * numel * probe_tool.NH
        else:
            n, ops = numel, PATTERN_OPS * numel
        t.update(tail_bench.bound_ms(2 * n * size, ops))
        floor = alone["empty"]["cold_ms"]
        plain = f"{t['plain_cold_ms']:.4f}" if "plain_cold_ms" in t else "not timed"
        phase("probe", f"{' '.join(str(k).removeprefix('torch.') for k in key)}: cold {t['cold_ms']:.4f} ms "
              f"(launches {t['cold_min_ms']:.4f}..{t['cold_max_ms']:.4f}), warm {t['warm_ms']:.4f}, plain cold "
              f"{plain}; {2 * n * size / 1e6:.1f} MB, {ops / 1e9:.3f} G operations, bound "
              f"{t['bound_ms']:.4f} ms ({t['bound_by']}), share {t['bound_ms'] / t['cold_ms']:.1%} cold "
              f"({t['bound_ms'] / t['warm_ms']:.1%} warm); against the bound plus the empty kernel's "
              f"{floor:.4f} ms: {(t['bound_ms'] + floor) / t['cold_ms']:.1%}; host ahead {t['host_ahead']}")

    vp.fma_chain.launches = 0
    vp.pattern_softmax.launches = 0
    res = probe_tool.run(dev, alone)
    launches = {"fma_chain": vp.fma_chain.launches, "pattern_softmax": vp.pattern_softmax.launches}
    if launches != probe_tool.launches_per_sweep():
        raise AssertionError(f"probe sweep launched {launches}; expected {probe_tool.launches_per_sweep()}")
    phase("probe", f"sweep launches {launches}; clocks.sm, max, power, temp: {clocks()}")
    return worst, launches, alone


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


def _serve_counted(pred, requests, want_launches, what, tag="general"):
    reset_tail_counts()
    t0 = time.perf_counter()
    answers = [pred.predict(r, return_probs=True) for r in requests]
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = refine_tail.launches
    for req, (labels, probs) in zip(requests, answers):
        _check_answer(labels, probs, len(req))
    if launches != want_launches:
        raise AssertionError(f"{what}: refine_tail launched {launches} times; expected {want_launches}")
    check_no_strided(what)
    phase(tag, f"{what}: {sum(len(r) for r in requests)} images, {secs:.2f} s wall (first calls "
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


def run_energy_parity(dev, dae, dae_c, fcn_c, img, *, logits=None, tag="general", fcn_out=None):
    """Energy mode, card against CPU, from the same y0 and taps (the CPU
    FCN's, or ``fcn_out`` = (y0, taps) already computed from it); the score
    network's ``logits(params, y, h)`` defaults to the phase's DAE. Its update is discontinuous where a max-pool window changes its
    maximum or a pre-activation crosses 0, and on a smooth class map many
    windows nearly tie, so a 1e-7 change of y moves some values of y_1 by
    ~0.05 on either device: a K-step trajectory is not held value by value
    (phase printed above, for the record). Held instead, from one step: the
    energy 0.5 ||y0 - r(y0)||^2 (relative 1e-5), the step's argmax (>=
    99.9%), and the gradient g = (y0 - y_1) / eps in norm: ||g_card - g_cpu||
    / ||g_cpu|| and the same for its Jacobian term g - (y0 - r(y0)), each
    within ENERGY_GRAD_REL_TOL, or twice the CPU's own reading under the
    1e-7 change where that is larger (capped at ENERGY_GRAD_NOISE_CAP). Printed beside them: the CPU against itself
    under a 1e-7 change of y0, and three planted gradients (zero, the score
    step's, the card's with its sign flipped), each of which must fail."""
    if logits is None:
        def logits(p, y, h):
            return dae_logits(p, y, h, depth=4)
    with torch.no_grad():
        y0, h = fcn_out or fcn8_apply(fcn_c, img, return_features=("pool4",))
        noise = 1e-7 * torch.randn(y0.shape, generator=torch.Generator().manual_seed(7))
        runs = {}
        for where, d_, d, y in (("card", dev, dae, y0), ("cpu", "cpu", dae_c, y0),
                                ("cpu+1e-7", "cpu", dae_c, y0 + noise)):
            hd = {k: v.to(d_) for k, v in h.items()}
            fn = lambda yy, d=d, hd=hd: logits(d, yy, hd)  # noqa: E731
            yd = y.to(d_)
            r = torch.softmax(fn(yd).float(), -1)
            energy = 0.5 * torch.sum(torch.square(yd - r)).item()
            y1 = logits_refinement_scan(fn, yd, eps=EPS, num_steps=1, mode="energy")
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
    phase(tag, f"f32 energy, same y0 and taps: energy card {runs['card'][0]:.6f} CPU "
          f"{runs['cpu'][0]:.6f} (rel {e_rel:.2e}); one step, card vs CPU: max|dy_1|={stats['card'][0]:.3e}, "
          f"{stats['card'][1]:.2%} of values beyond {PARITY_TOL}, argmax agree {stats['card'][2]:.6f}; "
          f"CPU vs CPU with y0 moved by 1e-7: max|dy_1|={stats['cpu+1e-7'][0]:.3e}, "
          f"{stats['cpu+1e-7'][1]:.2%} beyond, argmax agree {stats['cpu+1e-7'][2]:.6f}")
    limit = min(ENERGY_GRAD_NOISE_CAP, max(ENERGY_GRAD_REL_TOL, 2.0 * max(errs["cpu+1e-7"])))
    phase(tag, "f32 energy gradient against the CPU's, relative (g, Jacobian term), limit "
          f"{limit:.4f}: " + "; ".join(f"{k} {eg:.4e}, {ev:.4e}" for k, (eg, ev) in errs.items()))
    if not e_rel <= ENERGY_REL_TOL or stats["card"][2] < PARITY_MIN_ARGMAX_AGREE:
        raise AssertionError(f"energy mode: card vs CPU energy rel {e_rel:.2e} (tol {ENERGY_REL_TOL}), "
                             f"one-step argmax agree {stats['card'][2]:.6f}")
    if not max(errs["card"]) <= limit:
        raise AssertionError(f"energy mode: card gradient off the CPU's by {errs['card']}")
    for k in planted:
        if max(errs[f"planted {k}"]) <= limit:
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
            refine = make_refiner(fcn8_apply, dae_apply, f, d, eps=EPS, num_steps=K_STEPS, mode=mode,
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
        refine = make_refiner(fcn8_apply, dae_apply, fcn, dae, eps=EPS, num_steps=K_STEPS, mode=mode,
                              compute_dtype=torch.bfloat16, dae_kwargs={"depth": 4})
        for batch in (4, 8):
            x = torch.randn((batch, H, W, 3), generator=torch.Generator().manual_seed(6)).to(dev)
            ms = cuda_ms(lambda: refine(x), iters=10)
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
    reset_tail_counts()
    t0 = time.perf_counter()
    gen = grid_search_eps_k(fcn8_apply, dae_apply, fcn, dae, val, dae_kwargs={"depth": 4}, **kw)
    half = grid_search_eps_k_half(fcn8_apply, fcn, flag_dae, val, depth=3, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = refine_tail.launches
    # general: K_max steps per trajectory; half: K_max steps + K_max + 1 rectifications
    want = len(SEARCH_EPS) * len(val) * (SEARCH_KMAX + 2 * SEARCH_KMAX + 1)
    if launches != want:
        raise AssertionError(f"searches launched refine_tail {launches} times; expected {want}")
    check_no_strided("search")
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
                yk = logits_refinement_scan(
                    lambda y: dae_logits(dae, y, h, depth=4, compute_dtype=torch.bfloat16), y0, eps=eps, num_steps=k)
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
    reset_tail_counts()
    lines, secs = run_cli(cli.main, ["--synthetic", "--search", "--num-batches", "2", "--bf16", "--device", dev])
    launches += refine_tail.launches
    for line in lines[:3]:
        phase("search", f"CLI: {line}")
    if not (len(lines) == 3 + 1 + N_CLASSES and lines[0].startswith("val search: best eps=")
            and lines[1].startswith("step 0 (FCN-8 baseline): mIoU ") and " mIoU " in lines[2]
            and lines[3] == "per-class IoU (k=0 -> k=K):"):
        raise AssertionError(f"CLI printed {lines}")
    check_no_strided("CLI")
    phase("search", f"CLI --synthetic --search --num-batches 2 --bf16: {secs:.1f} s wall, "
          f"refine_tail launches {refine_tail.launches}")
    return launches


def fcn_step(dev, crop, *, remat=False, dtype=torch.bfloat16, params=None):
    """A full-width FCN-8 train step at ``crop``: (params, optimizer,
    train_step); params from seed 20 unless given."""
    params = params if params is not None else init_fcn8(
        torch.Generator().manual_seed(20), n_classes=N_CLASSES, fc_channels=4096, device=dev)
    tcfg = TrainConfig(compute_dtype=dtype, remat=remat)
    opt = make_optimizer(tcfg, params)
    cfg = dataclasses.replace(CAMVID, train_crop=crop)
    train_step, _ = make_fcn8_train_step(cfg, tcfg, opt)
    return params, opt, train_step


def run_fcn_phase(dev, smi, workdir):
    """train_fcn8 at full width (fc 4096, C = 11, 360x480 cropped to 224 with
    flips, bf16, batch 10) for 2 epochs with a workdir, then resumed to a
    third; the trained best_fcn8.npz served by Predictor.from_npz; the train
    step timed at batch 32, crop 224 and 128, with and without remat, with
    its split; then the CLI twin for one epoch."""
    def data(n, seed):
        return list(synthetic_batches(cfg=CAMVID, batch_size=FCN_BATCH, num_batches=n, seed=seed))

    train, val = data(FCN_TRAIN_BATCHES, 0), data(1, 10_000)
    tcfg = TrainConfig(max_epochs=2, patience=10, batch_size=FCN_BATCH, seed=0, compute_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    first = train_fcn8(dataset=CAMVID, train_data=train, val_data=val, tcfg=tcfg, workdir=str(workdir),
                       device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    resumed = train_fcn8(dataset=CAMVID, train_data=train, val_data=val, workdir=str(workdir), device=dev,
                         tcfg=dataclasses.replace(tcfg, max_epochs=3))
    hist = resumed["history"]
    if [h["epoch"] for h in hist] != [0, 1, 2] or hist[:2] != [
            {**h, "step": h["epoch"], "time": hist[i]["time"]} for i, h in enumerate(first["history"])]:
        raise AssertionError(f"the resumed run did not continue at epoch 2: {hist}")
    for name in ("metrics.jsonl", "best_fcn8.npz"):
        if not (workdir / name).is_file():
            raise AssertionError(f"train_fcn8 wrote no {name}")
    if latest_step(workdir / "ckpt") != 2 or not np.isfinite([h["train_loss"] for h in hist]).all():
        raise AssertionError(f"checkpoints or losses: ckpt {latest_step(workdir / 'ckpt')}, {hist}")
    phase("fcn", f"train_fcn8 bf16 batch {FCN_BATCH}, crop {CROP[0]}: 2 epochs of {FCN_TRAIN_BATCHES} batches "
          f"in {secs:.1f} s (first calls included), train_loss "
          + " ".join(f"{h['train_loss']:.4f}" for h in hist) + f", val_mIoU {hist[-1]['val_miou']:.4f}, "
          f"last epoch {hist[-1]['train_images_per_sec']:.1f} images/s; resumed at epoch 2; metrics.jsonl, "
          "best_fcn8.npz, ckpt/ written")
    pred = Predictor.from_npz(workdir / "best_fcn8.npz", device=dev, batch_size=GENERAL_BATCH,
                              compute_dtype=torch.bfloat16)
    labels, probs = pred.predict(np.random.default_rng(8).random((3, H, W, 3), dtype=np.float32),
                                 return_probs=True)
    _check_answer(labels, probs, 3)
    phase("fcn", f"Predictor.from_npz served best_fcn8.npz: labels {labels.shape}, classes used "
          f"{len(np.unique(labels))}")

    images, labels_np = next(synthetic_batches(cfg=CAMVID, batch_size=TRAIN_BATCH, num_batches=1, seed=21))
    x, y = torch.from_numpy(images).to(dev), torch.from_numpy(labels_np).to(dev)
    timing = {}
    for crop in FCN_TIMING_CROPS:
        for remat in (False, True):
            params, opt, train_step = fcn_step(dev, crop, remat=remat)
            rand = draw_fcn_randomness(torch.Generator().manual_seed(22), batch=TRAIN_BATCH, hw=(H, W),
                                       crop=crop, device=dev)
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: train_step(params, x, y, rand), iters=10)
            timing[crop[0], remat] = TRAIN_BATCH * 1000.0 / ms
            phase("fcn", f"FCN-8 train step bf16 batch {TRAIN_BATCH} crop {crop[0]} remat {remat}: {ms:.2f} "
                  f"ms/step, {timing[crop[0], remat]:.1f} images/s, peak device memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; on {smi}; clocks.sm, max, power, temp: "
                  f"{clocks()}")
            del params, opt, train_step

    # the split at crop 224, no remat: each stage alone, CUDA events over 10
    params, opt, train_step = fcn_step(dev, CROP)
    rand = draw_fcn_randomness(torch.Generator().manual_seed(22), batch=TRAIN_BATCH, hw=(H, W), crop=CROP,
                               device=dev)
    stages = train_step.stages
    step_ms = cuda_ms(lambda: train_step(params, x, y, rand), iters=10)
    xc, yc = stages.prepare(x, y, rand)
    masks = stages.masks(xc, rand)

    def fwd_bwd():
        opt.zero_grad(set_to_none=True)
        stages.loss(params, xc, yc, masks).backward()

    pool5 = torch.randn((TRAIN_BATCH, CROP[0] // 32, CROP[1] // 32, 512), device=dev, dtype=torch.bfloat16)
    cot = torch.randn((TRAIN_BATCH, CROP[0] // 32, CROP[1] // 32, 4096), device=dev, dtype=torch.bfloat16)
    fc6 = params["fc6"]

    def fc6_fwd_bwd():
        fc6["w"].grad = fc6["b"].grad = None
        conv2d(pool5, fc6["w"], fc6["b"]).backward(cot)

    split = {
        "crop+normalize": cuda_ms(lambda: stages.prepare(x, y, rand), iters=10),
        "dropout masks": cuda_ms(lambda: stages.masks(xc, rand), iters=10),
        "forward": cuda_ms(lambda: stages.loss(params, xc, yc, masks), iters=10),
    }
    split["backward"] = cuda_ms(fwd_bwd, iters=10) - split["forward"]
    split["Adam"] = cuda_ms(opt.step, iters=10)
    with torch.no_grad():
        fc6_fwd = cuda_ms(lambda: conv2d(pool5, fc6["w"], fc6["b"]), iters=10)
    fc6_all = cuda_ms(fc6_fwd_bwd, iters=10)
    phase("fcn", f"FCN-8 train step split, bf16 batch {TRAIN_BATCH} crop {CROP[0]}: step {step_ms:.3f} ms "
          f"({TRAIN_BATCH * 1000.0 / step_ms:.1f} images/s)")
    for name, ms in split.items():
        phase("fcn", f"  {name:15s} {ms:8.3f} ms  {100.0 * ms / step_ms:5.1f}% of the step")
    phase("fcn", f"  fc6 alone (7x7 conv, 512 -> 4096, on the {CROP[0] // 32}x{CROP[1] // 32} pool5 map): forward "
          f"{fc6_fwd:.3f} ms, backward {fc6_all - fc6_fwd:.3f} ms, together {fc6_all:.3f} ms = "
          f"{100.0 * fc6_all / step_ms:.1f}% of the step")
    del params, opt, train_step

    lines, secs = run_cli(fcn_cli.main, ["--synthetic", "--bf16", "--max-epochs", "1", "--workdir", workdir / "cli",
                                         "--device", dev])
    if not lines or not lines[0].startswith("epoch 0: train_loss=") or not lines[-1].startswith(
            "done: best val mIoU") or not (workdir / "cli" / "best_fcn8.npz").is_file():
        raise AssertionError(f"train_fcn8 CLI printed {lines}")
    phase("fcn", f"CLI --synthetic --bf16 --max-epochs 1: {secs:.1f} s; {lines[0]}")
    return timing


def _norm_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a - b).double().norm().item() / max(b.double().norm().item(), 1e-30)


def run_fcn_parity(dev):
    """One f32 FCN-8 train step at full width, batch 2, crop 224, card (TF32
    off) against the CPU, with the same crops and dropout masks. The loss is
    held to FCN_PARITY_TOL. The gradient is not held entry by entry: the
    step's ReLU derivatives are steps, so where a pre-activation lies within
    the two sides' rounding of 0, one side passes the full upstream gradient
    and the other none (a first card-vs-CPU reading put 28 of 39 leaves
    beyond 1e-3 of their largest entry, up to 2.3e-2). Held instead, per
    leaf: the Adam first moment (0.1 x the gradient) in norm, ||m_card -
    m_cpu|| / ||m_cpu|| <= FCN_PARITY_GRAD_TOL, where a planted sign-flipped
    or zero moment (2.0, 1.0) must fail; and the updated params to
    FCN_PARITY_TOL of their leaf's largest entry wherever Adam's first step,
    lr * g / (|g| + 1e-8), is set by the gradient: the two sides' gradients
    agree in sign and both exceed FCN_PARITY_MIN_GRAD in size. The entries
    left out are counted. Printed beside them: the CPU against itself with the images
    moved by 1e-7."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    images, labels = next(synthetic_batches(cfg=CAMVID, batch_size=2, num_batches=1, seed=23))
    moved = images + 1e-7 * np.random.default_rng(26).standard_normal(images.shape).astype(np.float32)
    gen = torch.Generator().manual_seed(24)
    rand = draw_fcn_randomness(gen, batch=2, hw=(H, W), crop=CROP, device="cpu")
    masks = dropout_masks(rand.dropout, (2, CROP[0] // 32, CROP[1] // 32, 4096))
    init = init_fcn8(torch.Generator().manual_seed(25), n_classes=N_CLASSES, fc_channels=4096)
    runs = {}
    for key, where, x in (("card", dev, images), ("cpu", "cpu", images), ("cpu+1e-7", "cpu", moved)):
        params = {k: {kk: t.clone().to(where) for kk, t in v.items()} for k, v in init.items()}
        params, opt, train_step = fcn_step(where, CROP, dtype=torch.float32, params=params)
        r = FCNStepRandomness(dropout=tuple(m.to(where) for m in masks), crop=rand.crop)
        t0 = time.perf_counter()
        loss = float(train_step(params, torch.from_numpy(x).to(where), torch.from_numpy(labels).to(where), r))
        secs = time.perf_counter() - t0
        runs[key] = (loss, {f"{k}/{kk}": (t.detach().cpu(), opt.state[t]["exp_avg"].cpu())
                            for k, v in params.items() for kk, t in v.items()}, secs)
        del params, opt, train_step
    lc, pc, sc = runs["cpu"]
    stats = {}
    for key in ("card", "cpu+1e-7"):
        loss, pk, _ = runs[key]
        grad = {n: _norm_rel(pk[n][1], mu) for n, (_, mu) in pc.items()}
        par, unset = {}, 0
        for n, (p, mu) in pc.items():
            p_k, mu_k = pk[n]
            step_set = ((torch.sign(mu_k) == torch.sign(mu)) & (mu.abs() >= 0.1 * FCN_PARITY_MIN_GRAD)
                        & (mu_k.abs() >= 0.1 * FCN_PARITY_MIN_GRAD))
            unset += int((~step_set).sum())
            d = (p_k - p).abs()[step_set]
            par[n] = d.max().item() / p.abs().max().item() if d.numel() else 0.0
        stats[key] = (abs(loss - lc) / abs(lc), grad, par, unset)
    total = sum(p.numel() for p, _ in pc.values())
    planted = {k: max(_norm_rel(f(mu), mu) for _, mu in pc.values())
               for k, f in (("zero", torch.zeros_like), ("flipped", torch.neg))}

    def worst(d):
        n = max(d, key=d.get)
        return f"{d[n]:.2e} ({n})"

    for key, (loss_rel, grad, par, unset) in stats.items():
        what = "card vs CPU" if key == "card" else "CPU vs CPU with the images moved by 1e-7"
        phase("fparity", f"f32 FCN-8 train step, batch 2, crop {CROP[0]}, same crops and dropout masks, {what}: "
              f"loss {runs[key][0]:.7f} / {lc:.7f} (rel {loss_rel:.2e}); Adam exp_avg per leaf in norm, worst "
              f"{worst(grad)}; updated params where the step is set, worst {worst(par)} of the leaf's largest; "
              f"{unset} of {total} entries left out (gradients of other signs or under {FCN_PARITY_MIN_GRAD}); "
              f"{runs[key][2]:.2f} s")
    phase("fparity", f"planted moments, worst leaf in norm: zero {planted['zero']:.2e}, flipped {planted['flipped']:.2e}")
    loss_rel, grad, par, _ = stats["card"]
    if not (loss_rel <= FCN_PARITY_TOL and max(grad.values()) <= FCN_PARITY_GRAD_TOL
            and max(par.values()) <= FCN_PARITY_TOL):
        raise AssertionError(f"FCN train step card vs CPU beyond {FCN_PARITY_TOL} (loss, params) / "
                             f"{FCN_PARITY_GRAD_TOL} (moments)")
    if min(planted.values()) <= FCN_PARITY_GRAD_TOL:
        raise AssertionError("the moment check passes a planted moment")


def run_demo_phase(dev):
    """The demo twin's main() on the card for the flagship config at seed 1,
    at its defaults; its refine_tail launches against what the grid and the
    test refinement imply."""
    argv = ["--json", "--seed", "1", *seed_replication.CONFIGS["flagship"], "--device", str(dev)]
    args = demo.parse_args(argv)
    reset_tail_counts()
    k1_before, k2_before = ck.corrupt_onehot.launches, ck.corrupt_probs.launches
    lines, secs = run_cli(demo.main, argv)
    row = json.loads(lines[-1])
    keys = {"test_miou_fcn", "test_miou_refined", "delta_miou", "best_eps", "best_k", "engine", "mode", "arch",
            "dae_encoder"}
    if set(row) != keys:
        raise AssertionError(f"demo printed {lines[-3:]}")
    # the half search: per eps and val batch, K_max steps and K_max + 1
    # rectifications; then per test batch K steps and one rectification
    grid = len(args.eps_grid) * DEMO_VAL_BATCHES * (2 * args.k_max + 1)
    served = DEMO_TEST_BATCHES * (row["best_k"] + 1)
    if refine_tail.launches != grid + served:
        raise AssertionError(f"demo: refine_tail launched {refine_tail.launches} times; expected {grid} + {served}")
    check_no_strided("demo")
    k1 = ck.corrupt_onehot.launches - k1_before
    k2 = ck.corrupt_probs.launches - k2_before
    for line in lines:
        if line.startswith(("  best eps", "  fcn epoch 2", "  dae epoch 15")):
            phase("demo", line.strip())
    phase("demo", f"flagship seed 1: {json.dumps({'config': 'flagship', 'seed': 1, 'wall_s': round(secs, 1), **row})}"
          f"; refine_tail launches {refine_tail.launches} = search {grid} + test {served}, none strided; "
          f"K1/K2 launches {k1}/{k2}")
    return refine_tail.launches, k1, k2


def unpool_tie_cases(gen):
    """(name, pre, g) on which max_unpool must pick the same positions on the
    card as on the CPU: the mirror's first stage (32 channels at 360x480)
    after a ReLU, with many all-zero windows; small integers (exact ties);
    ragged odd sizes (45x61, ceil-mode windows cut by the border); a map of
    equal values; each in f32 and bf16 (where ties are commoner)."""
    def relu_ints(shape):
        return torch.clamp(torch.randint(-2, 3, shape, generator=gen), min=0).float()

    def sparse(shape):
        return torch.relu(torch.randn(shape, generator=gen)) * (torch.rand(shape, generator=gen) < 0.3)

    pres = {"stage1_zero_windows": sparse((1, H, W, 32)), "exact_ties": relu_ints((2, 90, 120, 16)),
            "ragged_odd": relu_ints((2, 45, 61, 8)), "all_equal": torch.full((1, 23, 31, 4), 0.5)}
    cases = []
    for name, pre in pres.items():
        b, h, w, c = pre.shape
        g = torch.randn((b, -(-h // 2), -(-w // 2), c), generator=gen)
        for dt in (torch.float32, torch.bfloat16):
            cases.append((f"{name} {str(dt)[6:]}", pre.to(dt), g.to(dt)))
    return cases


def arch_params(arch, tied, dev):
    """Full-width score networks: the mirror DAE at depth 4 with the default
    widths (32..256), conditioned on pool4; the context module on the input."""
    taps = ("input",) if arch == "contextmod" else ("pool4",)
    return init_score_template(arch, torch.Generator().manual_seed(30), n_classes=N_CLASSES, h_taps=taps,
                               depth=4, tied=tied, device=dev), taps


def run_score_parity(name, dev, logits, params, params_c, y0, h):
    """Score mode, K steps, card against CPU from the same f32 y0 and taps.
    Beside it the CPU against itself with y0 moved by 1e-7. A network whose
    steps are continuous in y (the context module) is held at PARITY_TOL; the
    mirror's max-pool switches are not: where a window nearly ties, the
    card's and the CPU's roundings pick different pixels, and the decoder's
    unpool puts the value one pixel away. So where the CPU's own run under
    the 1e-7 change moves values beyond PARITY_TOL too, the card's share of
    values beyond it is held to twice the CPU's own share (at least 1e-4),
    with the argmax >= PARITY_MIN_ARGMAX_AGREE."""
    noise = 1e-7 * torch.randn(y0.shape, generator=torch.Generator().manual_seed(7))
    ys = {}
    for where, d_, p, y in (("card", dev, params, y0), ("cpu", "cpu", params_c, y0),
                            ("cpu+1e-7", "cpu", params_c, y0 + noise)):
        hd = {k: v.to(d_) for k, v in h.items()}
        t0 = time.perf_counter()
        with torch.inference_mode():
            ys[where] = logits_refinement_scan(lambda yy, p=p, hd=hd: logits(p, yy, hd), y.to(d_), eps=EPS,
                                               num_steps=K_STEPS).cpu()
        ys[where, "s"] = time.perf_counter() - t0
    stats = {}
    for other in ("card", "cpu+1e-7"):
        d = (ys[other] - ys["cpu"]).abs()
        agree = (ys[other].argmax(-1) == ys["cpu"].argmax(-1)).float().mean().item()
        stats[other] = (d.max().item(), (d > PARITY_TOL).float().mean().item(), agree)
    (dk, frac, agree), (dr, frac_ref, agree_ref) = stats["card"], stats["cpu+1e-7"]
    phase("arch", f"{name} f32 card vs CPU, 1 image, score, K={K_STEPS}, same y0 and taps: max|dy_K|={dk:.3e}, "
          f"{frac:.3%} of values beyond {PARITY_TOL}, argmax agree={agree:.6f}; CPU vs CPU with y0 moved by "
          f"1e-7: max|dy_K|={dr:.3e}, {frac_ref:.3%} beyond, argmax agree {agree_ref:.6f} "
          f"(CPU run {ys['cpu', 's']:.1f} s)")
    if dk <= PARITY_TOL:
        return
    if dr <= PARITY_TOL or frac > max(1e-4, 2.0 * frac_ref) or agree < PARITY_MIN_ARGMAX_AGREE:
        raise AssertionError(f"{name} score: card vs CPU beyond {PARITY_TOL} / {PARITY_MIN_ARGMAX_AGREE}")


def run_arch_phase(dev, fcn, smi):
    """Mirror (untied, tied) and contextmod at full width through
    Predictor(engine="general"), score (refine_tail K x chunks) and energy
    (none); one f32 image card vs CPU from the same y0 and taps (score: y_K;
    energy: the energy and one step's gradient); max_unpool card vs CPU on
    the tie cases; general-engine images/s at batch 4, bf16; the half engine
    refusing another arch."""
    rng = np.random.default_rng(9)
    request = rng.random((5, H, W, 3), dtype=np.float32)
    chunks = -(-len(request) // GENERAL_BATCH)
    launches = 0
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    img = normalize_image(torch.from_numpy(rng.random((1, H, W, 3), dtype=np.float32)), CAMVID)
    to_cpu = lambda p: {k: {kk: t.cpu() for kk, t in v.items()} for k, v in p.items()}  # noqa: E731
    fcn_c = to_cpu(fcn)
    t0 = time.perf_counter()
    with torch.no_grad():
        y0_c, h_c = fcn8_apply(fcn_c, img, return_features=("pool4", "input"))
    phase("arch", f"CPU FCN forward for the parity checks: {time.perf_counter() - t0:.1f} s")
    timing = {}
    for arch, tied in (("mirror", False), ("mirror", True), ("contextmod", False)):
        name = f"{arch}{' tied' if tied else ''}"
        params, taps = arch_params(arch, tied, dev)
        kw = dict(h_taps=taps, dae_arch=arch, dae_kwargs=score_kwargs(arch, depth=4))
        for mode in ("score", "energy"):
            pred = Predictor(fcn, params, device=dev, batch_size=GENERAL_BATCH, compute_dtype=torch.bfloat16,
                             num_steps=K_STEPS, eps=EPS, mode=mode, **kw)
            launches += _serve_counted(pred, [request], K_STEPS * chunks if mode == "score" else 0,
                                       f"{name} general engine {mode} bf16", tag="arch")
        # one f32 image, card against CPU, from the CPU FCN's y0 and taps
        params_c = to_cpu(params)
        logits = score_logits_fn(arch)
        kwargs = score_kwargs(arch, depth=4)
        h_t = {t: h_c[t] for t in taps}
        run_score_parity(name, dev, lambda p, y, h: logits(p, y, h, **kwargs), params, params_c, y0_c, h_t)
        run_energy_parity(dev, params, params_c, fcn_c, img, tag="arch", fcn_out=(y0_c, h_t),
                          logits=lambda p, y, h: logits(p, y, h, **kwargs))
        # images/s at batch 4, bf16
        for mode in ("score", "energy"):
            refine = make_refiner(fcn8_apply, score_apply_fn(arch), fcn, params, eps=EPS, num_steps=K_STEPS,
                                  mode=mode, h_taps=taps, compute_dtype=torch.bfloat16, dae_kwargs=kwargs)
            x = torch.randn((GENERAL_BATCH, H, W, 3), generator=torch.Generator().manual_seed(6)).to(dev)
            ms = cuda_ms(lambda: refine(x), iters=5)
            timing[name, mode] = GENERAL_BATCH * 1000.0 / ms
            phase("arch", f"{name} general engine bf16 {mode} K={K_STEPS} batch {GENERAL_BATCH}: {ms:.2f} ms/batch, "
                  f"{timing[name, mode]:.1f} images/s; on {smi}; clocks.sm, max, power, temp: {clocks()}")
        try:
            Predictor(fcn, params, device=dev, engine="half", dae_arch=arch, **{"h_taps": taps})
        except ValueError as e:
            phase("arch", f"{name}: engine='half' raises: {e}")
        else:
            raise AssertionError(f"engine='half' took dae_arch={arch!r}")
        del params, params_c

    gen = torch.Generator().manual_seed(31)
    for name, pre, g in unpool_tie_cases(gen):
        got = max_unpool(g.to(dev), pre.to(dev))
        want = max_unpool(g, pre)
        torch.cuda.synchronize()
        if not torch.equal(got.cpu(), want) or int((got != 0).sum()) != int((g != 0).sum()):
            raise AssertionError(f"max_unpool {name} {tuple(pre.shape)}: the card picks other positions than the "
                                 "CPU")
    phase("arch", "max_unpool card == CPU bit for bit: " + ", ".join(c[0] for c in unpool_tie_cases(gen)))
    return launches, timing


def hold_wires(raw, f32, file_cfg, dev, n: int) -> float:
    """The first batch of each wire held to each other: the u8 batch copied
    as the trainers copy it (``to_device``: the labels become int32) and
    normalized on ``dev`` with the file's statistics, against the f32 batch
    the runtime normalized on the host, on its ``n`` frames (the runtime
    pads a short batch with zeros on both wires, which normalize to other
    values on the device). Returns the largest difference; raises beyond
    WIRE_TOL or where the labels (padding included) differ."""
    x8, y8 = to_device(*raw, dev)
    x, y = to_device(*f32, dev)
    if x8.dtype != torch.uint8 or y8.dtype != torch.int32 or x.dtype != torch.float32:
        raise AssertionError(f"wires: u8 {x8.dtype}/{y8.dtype}, f32 {x.dtype}")
    if not torch.equal(y8, y):
        raise AssertionError("the u8 wire's labels differ from the f32 wire's")
    err = (normalize_image(x8[:n], file_cfg, input_scale=255.0) - x[:n]).abs().max().item()
    if not err <= WIRE_TOL:
        raise AssertionError(f"the u8 wire normalized on the device is {err:.3e} off the f32 wire (tol {WIRE_TOL})")
    return err


def lasagne_arrays(params: dict) -> list[np.ndarray]:
    """The port's FCN-8 as a reference-era Lasagne checkpoint: the positional
    list of ``get_all_param_values`` in build order, made with the inverse
    of each converter of ``utils/import_weights``: OIHW convs and their
    biases, fc6 and fc7 as flat FC matrices (Caffe's C, H, W order), IOHW
    transposed convs without bias."""
    jtree = params_to_jax(params)
    arrays = []
    for name, kind in FCN8_LASAGNE_ORDER:
        w = jtree[name]["w"]  # HWIO, the JAX layout
        if kind == "deconv":
            arrays.append(np.ascontiguousarray(w.transpose(2, 3, 0, 1)))
            continue
        oihw = np.ascontiguousarray(w.transpose(3, 2, 0, 1))
        arrays.append(oihw.reshape(oihw.shape[0], -1) if kind == "fc" else oihw)
        arrays.append(jtree[name]["b"])
    return arrays


def idle_share(intervals, window=None) -> tuple[float, float, float]:
    """(busy ms, window ms, idle share) of device intervals (start, end) in
    microseconds over ``window`` (start, end), by default the first start
    to the last end; a moment is busy where any interval covers it."""
    if window is None and intervals:
        window = (min(s for s, _ in intervals), max(e for _, e in intervals))
    clipped = sorted((max(s, window[0]), min(e, window[1])) for s, e in intervals) if window else []
    clipped = [(s, e) for s, e in clipped if e > s]
    if not clipped:
        raise AssertionError("the profiler traced no device time")
    busy, cur_start, cur_end = 0.0, None, None
    for start, end in clipped:
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    busy += cur_end - cur_start
    span = window[1] - window[0]
    return busy / 1e3, span / 1e3, 1.0 - busy / span


COPY_MARK = "chip_smoke.to_device"


def profiled_training(fn, n_train: int):
    """``fn()``, which trains one epoch of ``n_train`` batches through
    ``train_dae``, under ``torch.profiler`` (CPU and CUDA), with each
    batch's ``to_device`` marked as a range. Returns fn's value and
    (busy ms, window ms, idle share) of the device, first over the train
    steps (from the first batch's copy to the first val batch's), then over
    the whole run's device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    # the module (the package's ``train_dae`` is the trainer function)
    trainer = importlib.import_module("iterative_inference_segm_tpu_torch.train.train_dae")

    def marked(*args, **kwargs):
        with record_function(COPY_MARK):
            return to_device(*args, **kwargs)

    trainer.to_device = marked
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = fn()
            torch.cuda.synchronize()
    finally:
        trainer.to_device = to_device
    events = prof.events()
    spans = [(e.time_range.start, e.time_range.end) for e in events if e.device_type == DeviceType.CUDA]
    marks = sorted(e.time_range.start for e in events if e.name == COPY_MARK)
    if len(marks) <= n_train:
        raise AssertionError(f"{len(marks)} marked copies; expected the {n_train} train batches and val")
    return out, idle_share(spans, (marks[0], marks[n_train])), idle_share(spans)


def _miou_of_lines(lines) -> list[float]:
    """The k=0 and k=K mIoU the iterative_inference CLI printed."""
    return [float(ln.split("mIoU ")[1].split()[0]) for ln in lines if " mIoU " in ln and "acc " in ln]


def run_data_phase(dev, fcn, smi, root):
    """Phase 18: a synthetic CamVid packed by the pack_dataset twin; the
    first batch of each wire held to each other; the runtime's ms a batch
    and the host->device copy's (pageable ``to_device`` against
    ``device_prefetch``'s pinned side stream), per wire; one epoch of the
    train_dae twin per wire with --packed (train images/s; then again under
    the profiler for the device's idle share); the iterative_inference twin
    serving the test split on each wire; one epoch through iterate_split and
    epoch_reshuffled over the frames in memory (the --data-root path without
    the PNG decode). Returns the refine_tail and K1 launches."""
    packed = root / "camvid"
    lines, secs = run_cli(pack_cli.main, ["--synthetic", "--out", packed, *split_flags(DATA_SPLITS)])
    phase("data", f"pack_dataset twin --synthetic at {H}x{W}: {'; '.join(ln.split(' -> ')[0] for ln in lines)} "
          f"in {secs:.1f} s, {sum((packed / f'{s}.iist').stat().st_size for s in DATA_SPLITS) / 1e6:.1f} MB")
    with NativeDataset(packed / "val.iist") as ds:
        (f32,), (raw,) = list(ds.batches(TRAIN_BATCH)), list(ds.batches(TRAIN_BATCH, raw=True))
        file_cfg = dataclasses.replace(CAMVID, mean=ds.mean, std=ds.std)
        n = min(ds.n, TRAIN_BATCH)
    err = hold_wires(raw, f32, file_cfg, dev, n)
    phase("data", f"the val batch ({n} frames, padded to {TRAIN_BATCH}), u8 wire normalized on the card vs f32 "
          f"wire normalized by the runtime: max abs err {err:.3e} (tol {WIRE_TOL}), labels equal (u8 -> int32 "
          "after the copy)")

    host = {}
    with NativeDataset(packed / "train.iist") as ds:
        for wire in ("f32", "u8"):
            times, kept, epoch = [], [], 0
            while len(times) < DATA_TIMED_BATCHES:
                it = ds.batches(TRAIN_BATCH, shuffle=True, seed=epoch, raw=wire == "u8")
                epoch += 1
                while True:
                    t0 = time.perf_counter()
                    batch = next(it, None)
                    if batch is None:
                        break
                    times.append((time.perf_counter() - t0) * 1e3)
                    kept.append(batch)
            host[wire] = (times, kept[:DATA_TIMED_BATCHES])
    for wire, (times, kept) in host.items():
        nbytes = sum(a.nbytes for a in kept[0])
        pageable = []
        for img, lab in kept:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            to_device(img, lab, dev)
            torch.cuda.synchronize()
            pageable.append((time.perf_counter() - t0) * 1e3)
        pinned, out = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for item in device_prefetch(kept, depth=2, device=dev):
            torch.cuda.current_stream(dev).synchronize()
            t1 = time.perf_counter()
            pinned.append((t1 - t0) * 1e3)
            t0 = t1
            out.append(item)
        for i in (0, len(kept) - 1):
            if not all(torch.equal(o.cpu(), torch.from_numpy(a)) for o, a in zip(out[i], kept[i])):
                raise AssertionError(f"{wire}: device_prefetch batch {i} differs from its source")
        del out
        rt, pg, pn = (statistics.median(v) for v in (times, pageable, pinned))
        phase("data", f"{wire} wire, batch {TRAIN_BATCH} ({nbytes / 1e6:.1f} MB): runtime {rt:.3f} ms/batch "
              f"({min(times):.3f}..{max(times):.3f}), host->device pageable to_device {pg:.3f} ms "
              f"({nbytes / pg / 1e6:.2f} GB/s), device_prefetch pinned side stream {pn:.3f} ms "
              f"({nbytes / pn / 1e6:.2f} GB/s); medians of {len(times)}/{len(pageable)}/{len(pinned)} batches; "
              f"on {smi}")
    del host

    k1_before = ck.corrupt_onehot.launches
    per_epoch = -(-DATA_SPLITS["train"] // TRAIN_BATCH) + -(-DATA_SPLITS["val"] // TRAIN_BATCH)
    runs = 0
    for wire in ("f32", "u8"):
        argv = ["--packed", packed, "--wire", wire, "--bf16", "--batch-size", TRAIN_BATCH, "--dae-depth", 3,
                "--dae-stem-pool", 1, "--max-epochs", 1, "--device", dev]
        lines, secs = run_cli(dae_cli.main, [*argv, "--workdir", root / f"dae_{wire}"])
        row = last_epoch(root / f"dae_{wire}")
        _, steps, whole = profiled_training(
            lambda: run_cli(dae_cli.main, [*argv, "--workdir", root / f"dae_{wire}_profiled"]),
            -(-DATA_SPLITS["train"] // TRAIN_BATCH))
        row_p = last_epoch(root / f"dae_{wire}_profiled")
        runs += 2
        phase("data", f"train_dae twin --packed --wire {wire} --bf16, batch {TRAIN_BATCH}, 1 epoch "
              f"({DATA_SPLITS['train']} frames): {row['train_images_per_sec']:.1f} train images/s, epoch "
              f"{row['epoch_seconds']:.3f} s, train_loss {row['train_loss']:.4f}, {secs:.1f} s wall; under the "
              f"profiler {row_p['train_images_per_sec']:.1f} images/s, the device busy {steps[0]:.1f} of "
              f"{steps[1]:.1f} ms over the train steps (first batch's copy to val's), idle {steps[2]:.1%}; "
              f"{whole[0]:.1f} of {whole[1]:.1f} ms from the run's first device operation to its last (init, "
              f"train, val, checkpoint), idle {whole[2]:.1%}")
    k1 = ck.corrupt_onehot.launches - k1_before
    if k1 != runs * per_epoch:
        raise AssertionError(f"train_dae --packed: K1 launched {k1} times; expected {runs * per_epoch}")

    reset_tail_counts()
    served = {}
    for wire in ("f32", "u8"):
        lines, secs = run_cli(cli.main, ["--packed", packed, "--wire", wire, "--device", dev])
        served[wire] = _miou_of_lines(lines)
        phase("data", f"iterative_inference twin --packed --wire {wire} (f32, general engine, K={K_STEPS}, "
              f"{DATA_SPLITS['test']} test frames): {lines[0]} | {lines[1].strip()} ({secs:.1f} s)")
    diff = max(abs(a - b) for a, b in zip(served["f32"], served["u8"]))
    want = 2 * K_STEPS * -(-DATA_SPLITS["test"] // 4)
    if len(served["f32"]) != 2 or diff > WIRE_MIOU_TOL or refine_tail.launches != want:
        raise AssertionError(f"served wires: mIoU {served}, refine_tail {refine_tail.launches} (expected {want})")
    check_no_strided("data")
    tail_launches = refine_tail.launches
    k1_total = k1

    # --data-root without Pillow: the frames in memory, as the loaders give
    # them (f32 in [0, 1], int32 labels), through the same iterators
    with NativeDataset(packed / "train.iist") as ds:
        (tr_i, tr_l), = ds.batches(DATA_SPLITS["train"], raw=True)
    with NativeDataset(packed / "val.iist") as ds:
        (va_i, va_l), = ds.batches(DATA_SPLITS["val"], raw=True)
    tr_i, va_i = tr_i.astype(np.float32) / 255.0, va_i.astype(np.float32) / 255.0
    tr_l, va_l = tr_l.astype(np.int32), va_l.astype(np.int32)
    train_data = epoch_reshuffled(
        lambda seed: iterate_split(tr_i, tr_l, batch_size=TRAIN_BATCH, shuffle=True, seed=seed), 0)
    k1_before = ck.corrupt_onehot.launches
    t0 = time.perf_counter()
    result = train_dae(
        fcn_params=fcn, dataset=CAMVID, train_data=train_data,
        val_data=lambda: iterate_split(va_i, va_l, batch_size=TRAIN_BATCH),
        tcfg=TrainConfig(max_epochs=1, batch_size=TRAIN_BATCH, seed=0, compute_dtype=torch.bfloat16),
        sigma=SIGMA, from_gt=True, **DAE_KW,
    )
    torch.cuda.synchronize()
    row = result["history"][-1]
    k1 = ck.corrupt_onehot.launches - k1_before
    if k1 != per_epoch or not np.isfinite(row["train_loss"]):
        raise AssertionError(f"the in-memory epoch: K1 {k1}, history {result['history']}")
    phase("data", f"iterate_split + epoch_reshuffled over the {DATA_SPLITS['train']} frames in memory (f32, "
          f"to_device pageable), 1 epoch: {row['train_images_per_sec']:.1f} train images/s, epoch "
          f"{row['epoch_seconds']:.3f} s, {time.perf_counter() - t0:.1f} s wall")
    return tail_launches, k1_total + k1


def run_em_phase(dev, smi, root):
    """Phase 19: a synthetic EM stack (512x512x1, C = 2, 24/3/3) packed by
    the pack_dataset twin; the train_dae twin on it (--packed --wire u8) in
    the gt and natural regimes, with K1's and K2's launches; the
    iterative_inference twin with --search on the DAE it trained, with K3's;
    then K1/K2 at 32x256x256x2 bit-equal to their plain versions and K3 at
    the general step's EM shape against refine_tail_reference, each timed
    cold against its bound. Returns (refine_tail launches, K1 launches, K2
    launches, {kernel: timing})."""
    em_dir = root / "em"
    lines, secs = run_cli(pack_cli.main, ["--dataset", "em", "--synthetic", "--out", em_dir,
                                          *split_flags(EM_SPLITS)])
    phase("em", f"pack_dataset twin --dataset em --synthetic ({EM.height}x{EM.width}x{EM.in_channels}, "
          f"C={EM.n_classes}): {'; '.join(ln.split(' -> ')[0] for ln in lines)} in {secs:.1f} s")
    per_run = EM_EPOCHS * (-(-EM_SPLITS["train"] // TRAIN_BATCH) + -(-EM_SPLITS["val"] // TRAIN_BATCH))
    k = {"corrupt_onehot": 0, "corrupt_probs": 0}
    for regime, extra, want in (("gt", [], (per_run, 0)), ("natural", ["--from-fcn"], (0, per_run))):
        before = (ck.corrupt_onehot.launches, ck.corrupt_probs.launches)
        lines, secs = run_cli(dae_cli.main, [
            "--dataset", "em", "--packed", em_dir, "--wire", "u8", "--bf16", "--batch-size", TRAIN_BATCH,
            "--dae-depth", 3, "--dae-stem-pool", 1, "--max-epochs", EM_EPOCHS, "--workdir", root / f"em_{regime}",
            "--device", dev, *extra])
        got = (ck.corrupt_onehot.launches - before[0], ck.corrupt_probs.launches - before[1])
        row = last_epoch(root / f"em_{regime}")
        if got != want:
            raise AssertionError(f"EM {regime}: K1/K2 launched {got}; expected {want}")
        k["corrupt_onehot"] += got[0]
        k["corrupt_probs"] += got[1]
        phase("em", f"train_dae twin --dataset em --packed --wire u8 {regime}: "
              + " | ".join(ln for ln in lines if ln.startswith("epoch "))
              + f"; K1/K2 launches {got[0]}/{got[1]}; {row['train_images_per_sec']:.1f} train images/s "
              f"(the last epoch), {secs:.1f} s wall")
    reset_tail_counts()
    lines, secs = run_cli(cli.main, [
        "--dataset", "em", "--packed", em_dir, "--wire", "u8", "--dae-npz", root / "em_gt" / "best_dae.npz",
        "--dae-depth", 3, "--dae-stem-pool", 1, "--search", "--bf16", "--device", dev])
    best_k = int(lines[0].split(" K=")[1].split()[0])
    n_val, n_test = (-(-EM_SPLITS[s] // 4) for s in ("val", "test"))
    want = len(SEARCH_EPS) * n_val * SEARCH_KMAX + n_test * best_k
    if refine_tail.launches != want:
        raise AssertionError(f"EM CLI: refine_tail launched {refine_tail.launches} times; expected {want}")
    check_no_strided("em")
    tail_launches = refine_tail.launches
    phase("em", f"iterative_inference twin --dataset em --packed --wire u8 --search --bf16 on the gt DAE: "
          + " | ".join(ln.strip() for ln in lines[:3]) + f"; refine_tail launches {tail_launches} = search "
          f"{len(SEARCH_EPS) * n_val * SEARCH_KMAX} + test {n_test * best_k}, none strided; {secs:.1f} s")

    # the three kernels alone at C = 2, cold against their bound
    gen = torch.Generator().manual_seed(40)
    flush = tail_bench.flush_buffer(dev)
    shape = (TRAIN_BATCH, *EM.train_crop)
    lab = torch.randint(0, EM.n_classes, shape, generator=gen, dtype=torch.int32)
    lab = torch.where(torch.rand(shape, generator=gen) < 0.02, torch.full_like(lab, EM.void_label), lab).to(dev)
    probs = torch.softmax(torch.randn((*shape, EM.n_classes), generator=gen) * 3.0, -1).to(dev)
    report = {}
    for sigma in (0.0, SIGMA):
        report["corrupt_onehot", sigma] = check_and_time_corrupt(
            "corrupt_onehot", ck.corrupt_onehot, ck.corrupt_onehot_kernel_reference, lab,
            {"n_classes": EM.n_classes, "sigma": sigma}, shape, flush, lab == EM.void_label, tag="em")
        report["corrupt_probs", sigma] = check_and_time_corrupt(
            "corrupt_probs", ck.corrupt_probs, ck.corrupt_probs_kernel_reference, probs, {"sigma": sigma},
            shape, flush, tag="em")
    y = torch.softmax(torch.randn((GENERAL_BATCH, EM.height, EM.width, EM.n_classes), generator=gen) * 3.0,
                      -1).to(dev)
    u = (torch.randn(y.shape, generator=gen) * 3.0).to(dev, torch.bfloat16)
    case = tail_bench.Case("em general_bf16", u, y)
    err, agree = check_kernel_case(case.name, case.kernel(), case.plain(), False, y.dtype)
    t = tail_bench.time_case(case, flush)
    report["refine_tail"] = {"max_abs_err": err, **t}
    phase("em", f"refine_tail general step y={tuple(y.shape)} f32 u bf16: max_abs_err={err:.3e} argmax_agree="
          f"{agree:.6f}; " + tail_bench.report(t) + f"; on {smi}; clocks.sm, max, power, temp: {clocks()}")
    return tail_launches, k["corrupt_onehot"], k["corrupt_probs"], report


def run_utils_phase(dev, fcn, root):
    """Phase 20: the full-width FCN's own weights written as a Lasagne
    positional npz with the inverse converters, imported back bit for bit,
    and served with --fcn-reference-npz, which must print the lines that
    --fcn-npz prints on the same weights; then one short train_fcn8 twin
    epoch with --profile-dir, whose trace must hold CUDA kernel events.
    Returns the refine_tail launches."""
    save_npz(root / "fcn8.npz", fcn)
    np.savez(root / "fcn8_lasagne.npz", *lasagne_arrays(fcn))
    template = init_fcn8(torch.Generator().manual_seed(50), n_classes=N_CLASSES,
                         fc_channels=int(fcn["fc7"]["w"].shape[0]), device=dev)
    imported = import_lasagne_npz(root / "fcn8_lasagne.npz", template, strict=True)
    if not all(torch.equal(imported[k][kk], t) for k, v in fcn.items() for kk, t in v.items()):
        raise AssertionError("the Lasagne npz did not import back to the FCN's own weights")
    reset_tail_counts()
    common = ["--synthetic", "--num-batches", 1, "--bf16", "--device", dev]
    by_npz, s1 = run_cli(cli.main, [*common, "--fcn-npz", root / "fcn8.npz"])
    by_ref, s2 = run_cli(cli.main, [*common, "--fcn-reference-npz", root / "fcn8_lasagne.npz"])
    if by_npz != by_ref or refine_tail.launches != 2 * K_STEPS:
        raise AssertionError(f"--fcn-reference-npz printed {by_ref[:2]}, --fcn-npz {by_npz[:2]}; refine_tail "
                             f"{refine_tail.launches}")
    check_no_strided("utils")
    phase("utils", f"{len(lasagne_arrays(fcn))} Lasagne arrays from the full-width FCN imported back bit for bit; "
          f"--fcn-reference-npz prints what --fcn-npz prints ({len(by_ref)} lines; {by_ref[1].strip()}; "
          f"{s1:.1f} / {s2:.1f} s)")
    trace_dir = root / "trace"
    lines, secs = run_cli(fcn_cli.main, ["--synthetic", "--bf16", "--max-epochs", 1, "--num-train-batches", 2,
                                         "--num-val-batches", 1, "--profile-dir", trace_dir,
                                         "--workdir", root / "fcn8", "--device", dev])
    trace = trace_dir / profiling.TRACE_FILE
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not kernels:
        raise AssertionError(f"{trace} holds no CUDA kernel events ({len(events)} events)")
    phase("utils", f"train_fcn8 twin --profile-dir, 1 epoch of 2 batches of 10: {lines[0]}; {trace.name} "
          f"{trace.stat().st_size / 1e6:.1f} MB, {len(events)} events, {len(kernels)} CUDA kernels "
          f"({len({e['name'] for e in kernels})} distinct); {secs:.1f} s")
    return refine_tail.launches


# ---------------------------------------------------------------- the parallel layer (phases 21-24)
#
# The machine has one card, so the phases' ranks share cuda:0 and talk over
# gloo (NCCL refuses two ranks on one card; parallel/comm.py stages a CUDA
# tensor through host memory on gloo). NCCL itself runs at world size 1.
# Every time printed is that of ranks sharing one card: not a multi-card
# figure. Each reference runs in rank 0, in one process, on the same card.

PAR_BATCH = 32  # the DP DAE step: 16 + 16 on 2 ranks
PAR_FCN_BATCH = 10  # the DP FCN-8 step: the CLI's batch, 5 + 5
PAR_SERVE_IMAGES = 12  # 2 chunks of 8, the last one short
PAR_F32_TOL = 1e-5  # f32 against the one-process reference on the same card


def _leaves_of(params):
    return [t for v in params.values() for t in v.values()]


def _clone(params):
    return {k: {kk: t.detach().clone() for kk, t in v.items()} for k, v in params.items()}


def _leaf_rel(a: dict, b: dict) -> tuple[float, str]:
    """The largest max|a - b| / max|b| over the leaves, and its leaf ('all'
    when every leaf is equal)."""
    worst, name = 0.0, "all"
    for k, v in b.items():
        for kk, t in v.items():
            rel = (a[k][kk] - t).abs().max().item() / max(t.abs().max().item(), 1e-30)
            if rel > worst:
                worst, name = rel, f"{k}/{kk}"
    return worst, name


def _rank():
    return torch.distributed.get_rank()


def par_cases(mesh, device, cases):
    """Each rank: run ``cases`` ([(name, function, kwargs)]) in order; each
    result gets the case's wall time in this rank."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for name, fn, kw in cases:
        t0 = time.perf_counter()
        out[name] = globals()[fn](mesh, device, **kw)
        torch.cuda.synchronize()
        out[name]["secs"] = time.perf_counter() - t0
    return out


def par_dae_step(mesh, device, dtype, from_gt, seed):
    """One DP train_dae step at full width (the CLI's DAE: depth 4, no stem
    pool; crop 224) on this rank's shard of a batch of PAR_BATCH, K1 (gt) or
    K2 (natural) launched by the step; rank 0 then runs the reference: the
    shards' single-device gradients, averaged by hand, one Adam step."""
    from iterative_inference_segm_tpu_torch.parallel.mesh import axis_index, axis_size

    torch.backends.cudnn.deterministic = True
    n, r = axis_size(mesh, "data"), axis_index(mesh, "data")
    local = PAR_BATCH // n
    fcn, _ = flagship_params(device)
    init = init_dae(torch.Generator().manual_seed(12), n_classes=N_CLASSES, h_specs={"pool4": DAE_H_CHANNELS["pool4"]},
                    depth=4, stem_pool=0, device=device)
    images, labels = next(synthetic_batches(cfg=CAMVID, batch_size=PAR_BATCH, num_batches=1, seed=seed))
    gen = torch.Generator().manual_seed(seed + 1)
    rands = [draw_step_randomness(gen, batch=local, hw=(H, W), crop=CROP, p_gt=float(from_gt)) for _ in range(n)]
    shards = [(torch.from_numpy(images[s * local:(s + 1) * local]).to(device),
               torch.from_numpy(labels[s * local:(s + 1) * local]).to(device)) for s in range(n)]
    tcfg = TrainConfig(compute_dtype=getattr(torch, dtype))
    kw = dict(h_taps=("pool4",), sigma=SIGMA, from_gt=from_gt, dae_depth=4, corruption_impl="kernel")
    dae = _clone(init)
    step, _ = make_dae_train_step(CAMVID, tcfg, make_optimizer(tcfg, dae), mesh=mesh, **kw)
    ck.corrupt_onehot.launches = ck.corrupt_probs.launches = 0
    t0 = time.perf_counter()
    loss = float(step(dae, fcn, *shards[r], rands[r]))
    out = {"loss": loss, "step_s": time.perf_counter() - t0, "k1": ck.corrupt_onehot.launches,
           "k2": ck.corrupt_probs.launches}
    if _rank() == 0:
        ref = _clone(init)
        ropt = make_optimizer(tcfg, ref)
        rstep, _ = make_dae_train_step(CAMVID, tcfg, ropt, **kw)
        if n == 1:  # the plain single-device step
            ref_loss = float(rstep(ref, fcn, *shards[0], rands[0]))
        else:
            st, grads, losses = rstep.stages, [], []
            for s in range(n):
                xc, yc = st.prepare(*shards[s], rands[s])
                probs, h = st.features(fcn, xc)
                with torch.no_grad():
                    y_tilde = st.corrupt(yc, probs, rands[s])
                ropt.zero_grad(set_to_none=True)
                value, _ = st.loss(ref, y_tilde, h, yc)
                value.backward()
                grads.append([t.grad.clone() for t in _leaves_of(ref)])
                losses.append(float(value.detach()))
            for i, t in enumerate(_leaves_of(ref)):
                t.grad = sum(g[i] for g in grads) / n
            ropt.step()
            ref_loss = sum(losses) / n
        out["loss_rel"] = abs(loss - ref_loss) / abs(ref_loss)
        out["param_rel"], out["param_leaf"] = _leaf_rel(dae, ref)
        out["moved"] = max((a - b).abs().max().item() for a, b in zip(_leaves_of(dae), _leaves_of(init)))
    return out


def par_fcn_step(mesh, device):
    """One DP train_fcn8 step at full width (fc 4096, crop 224, f32) on this
    rank's shard of the CLI's batch, each rank with its own crops and
    dropout masks; rank 0 holds it to the shards' averaged single-device
    gradients, as phase 15 holds a step: the loss, Adam's first moment per
    leaf in norm, the updated params where Adam's step is set."""
    from iterative_inference_segm_tpu_torch.parallel.mesh import axis_index, axis_size

    torch.backends.cudnn.deterministic = True
    n, r = axis_size(mesh, "data"), axis_index(mesh, "data")
    local = PAR_FCN_BATCH // n
    images, labels = next(synthetic_batches(cfg=CAMVID, batch_size=PAR_FCN_BATCH, num_batches=1, seed=31))
    gen = torch.Generator().manual_seed(32)
    rands = []
    for _ in range(n):
        crop = draw_crop_and_flip(gen, local, (H, W), CROP)
        masks = dropout_masks(gen, (local, CROP[0] // 32, CROP[1] // 32, 4096))
        rands.append(FCNStepRandomness(dropout=tuple(m.to(device) for m in masks), crop=crop))
    shards = [(torch.from_numpy(images[s * local:(s + 1) * local]).to(device),
               torch.from_numpy(labels[s * local:(s + 1) * local]).to(device)) for s in range(n)]
    init = init_fcn8(torch.Generator().manual_seed(25), n_classes=N_CLASSES, fc_channels=4096, device=device)
    tcfg = TrainConfig()
    params = _clone(init)
    opt = make_optimizer(tcfg, params)
    step, _ = make_fcn8_train_step(CAMVID, tcfg, opt, mesh=mesh)
    t0 = time.perf_counter()
    loss = float(step(params, *shards[r], rands[r]))
    out = {"loss": loss, "step_s": time.perf_counter() - t0}
    if _rank() == 0:
        ref = _clone(init)
        ropt = make_optimizer(tcfg, ref)
        rstep, _ = make_fcn8_train_step(CAMVID, tcfg, ropt)
        st, grads, losses = rstep.stages, [], []
        for s in range(n):
            xc, yc = st.prepare(*shards[s], rands[s])
            ropt.zero_grad(set_to_none=True)
            value = st.loss(ref, xc, yc, rands[s].dropout)
            value.backward()
            grads.append([t.grad.clone() for t in _leaves_of(ref)])
            losses.append(float(value.detach()))
        for i, t in enumerate(_leaves_of(ref)):
            t.grad = sum(g[i] for g in grads) / n
        ropt.step()
        ref_loss = sum(losses) / n
        moments, par, unset = {}, {}, 0
        for (name, lv), (_, rv) in zip(params.items(), ref.items()):
            for kk, t in lv.items():
                mu, mu_ref = opt.state[t]["exp_avg"], ropt.state[rv[kk]]["exp_avg"]
                moments[f"{name}/{kk}"] = _norm_rel(mu, mu_ref)
                step_set = ((torch.sign(mu) == torch.sign(mu_ref)) & (mu.abs() >= 0.1 * FCN_PARITY_MIN_GRAD)
                            & (mu_ref.abs() >= 0.1 * FCN_PARITY_MIN_GRAD))
                unset += int((~step_set).sum())
                d = (t - rv[kk]).abs()[step_set]
                par[f"{name}/{kk}"] = d.max().item() / rv[kk].abs().max().item() if d.numel() else 0.0
        out.update(loss_rel=abs(loss - ref_loss) / abs(ref_loss), moment_rel=max(moments.values()),
                   moment_leaf=max(moments, key=moments.get), param_rel=max(par.values()), unset=unset,
                   total=sum(t.numel() for t in _leaves_of(params)))
    return out


def par_serve(mesh, device, engine):
    """Predictor(mesh=...) at batch 8 over PAR_SERVE_IMAGES images (the half
    engine in bf16, the general in f32); rank 0 holds the gathered answer to
    the single-device Predictor at batch 8."""
    fcn, dae = flagship_params(device)
    dtype = torch.bfloat16 if engine == "half" else torch.float32
    if engine == "general":
        dae = general_params(device)
    kw = dict(engine=engine, batch_size=BATCH, compute_dtype=dtype, num_steps=K_STEPS, eps=EPS,
              dae_kwargs={"depth": 3 if engine == "half" else 4, "encoder": "pool"})
    images = np.random.default_rng(41).random((PAR_SERVE_IMAGES, H, W, 3), dtype=np.float32)
    reset_tail_counts()
    t0 = time.perf_counter()
    labels, probs = Predictor(fcn, dae, device=device, mesh=mesh, **kw).predict(images, return_probs=True)
    torch.cuda.synchronize()
    out = {"serve_s": time.perf_counter() - t0, "launches": refine_tail.launches,
           "strided": refine_tail.strided_launches}
    _check_answer(labels, probs, PAR_SERVE_IMAGES)
    if _rank() == 0:
        want_l, want_p = Predictor(fcn, dae, device=device, **kw).predict(images, return_probs=True)
        out["agree"] = float((labels == want_l).mean())
        out["max_abs"] = float(np.abs(probs - want_p).max())
        top2 = np.sort(want_p, axis=-1)[..., -2:]
        near_tie = (top2[..., 1] - top2[..., 0]) <= PAR_F32_TOL
        out["off_beyond_ties"] = int(((labels != want_l) & ~near_tie).sum())
    return out


def par_tp(mesh, device):
    """FCN-8 at fc 4096 on a ('model',) mesh of 2: the f32 forward and one
    f32 train step with given dropout masks, each rank holding half of
    fc6/fc7 (and so of Adam's moments for them); every rank holds its run to
    the replicated run in its own process."""
    from iterative_inference_segm_tpu_torch.ops.losses import masked_crossentropy
    from iterative_inference_segm_tpu_torch.parallel.mesh import axis_group, make_mesh
    from iterative_inference_segm_tpu_torch.parallel.tp import shard_params_tp, tp_shardings

    tmesh = make_mesh(("model",), (2,), device_type="cuda")
    group = axis_group(tmesh, "model")
    whole = init_fcn8(torch.Generator().manual_seed(25), n_classes=N_CLASSES, fc_channels=4096, device=device)
    images, labels = next(synthetic_batches(cfg=CAMVID, batch_size=2, num_batches=1, seed=33))
    x = normalize_image(torch.from_numpy(images), CAMVID).to(device)
    y = torch.from_numpy(labels).to(device)
    masks = tuple(m.to(device) for m in dropout_masks(torch.Generator().manual_seed(34), (2, 12, 15, 4096)))
    specs = tp_shardings(whole, tmesh)
    tcfg = TrainConfig()

    def run(params, model_group):
        opt = make_optimizer(tcfg, params)
        with torch.no_grad():
            logits = fcn8_logits(params, x, model_group=model_group)
        t0 = time.perf_counter()
        loss = masked_crossentropy(fcn8_logits(params, x, dropout=masks, model_group=model_group), y,
                                   n_classes=N_CLASSES)
        loss.backward()
        grads = {k: {kk: t.grad.clone() for kk, t in v.items()} for k, v in params.items()}
        opt.step()
        torch.cuda.synchronize()
        return logits, float(loss.detach()), grads, opt, time.perf_counter() - t0

    local = shard_params_tp(_clone(whole), tmesh)
    logits, loss, grads, opt, step_s = run(local, group)
    r_logits, r_loss, r_grads, _, ref_s = run(_clone(whole), None)
    r_grads = {k: {kk: (specs[k][kk].local(t) if k in ("fc6", "fc7") else t) for kk, t in v.items()}
               for k, v in r_grads.items()}
    grad_norm = {f"{k}/{kk}": _norm_rel(grads[k][kk], t) for k, v in r_grads.items() for kk, t in v.items()}
    held = sum(t.numel() * t.element_size() for name in ("fc6", "fc7") for t in local[name].values())
    moments = sum(opt.state[t][m].numel() * 4 for name in ("fc6", "fc7") for t in local[name].values()
                  for m in ("exp_avg", "exp_avg_sq"))
    whole_bytes = sum(t.numel() * t.element_size() for name in ("fc6", "fc7") for t in whole[name].values())
    return {"logits_rel": (logits - r_logits).abs().max().item() / r_logits.abs().max().item(),
            "loss_rel": abs(loss - r_loss) / abs(r_loss), "grad_rel": max(grad_norm.values()),
            "grad_leaf": max(grad_norm, key=grad_norm.get), "held": held, "moments": moments,
            "whole": whole_bytes, "step_s": step_s, "ref_s": ref_s,
            "shapes": {k: tuple(local[k]["w"].shape) for k in ("fc6", "fc7")}}


def par_pp(mesh, device, engine, arch, microbatches, names=None, sizes=None, predictor=False):
    """The flagship through make_pp_flagship (or Predictor(pp_mesh=...)) at
    full width, batch 8. Rank 0 holds y_K (the labels) to the one-process
    flagship_forward_fn or general engine (Predictor) run on the same chunks
    as the ranks run (each microbatch's 'data' shard): f32 at PAR_F32_TOL,
    bf16 by argmax agreement; and reports the agreement with one run of the
    whole batch, where cuDNN may pick other algorithms. Each rank's
    refine_tail launches are counted."""
    from iterative_inference_segm_tpu_torch.parallel.mesh import axis_index, axis_size, has_axis, make_mesh
    from iterative_inference_segm_tpu_torch.parallel.pp import make_pp_flagship, merge_microbatches, split_microbatches

    pmesh = make_mesh(names, sizes, device_type="cuda") if names else mesh
    fcn, dae = flagship_params(device)
    half = engine == "half"
    dtype = torch.bfloat16 if half else torch.float32
    if not half:
        dae = general_params(device) if arch == "dae" else arch_params(arch, False, device)[0]
    depth = 3 if half else 4
    kw = dict(eps=EPS, num_steps=K_STEPS, depth=depth, compute_dtype=dtype, engine=engine, dae_arch=arch)
    batch_axis = "data" if has_axis(pmesh, "data") else None
    chunk = BATCH // microbatches // (axis_size(pmesh, "data") if batch_axis else 1)
    images = np.random.default_rng(42).random((BATCH, H, W, 3), dtype=np.float32)
    x = normalize_image(torch.from_numpy(images), CAMVID).to(device)
    pred_kw = dict(engine=engine, compute_dtype=dtype, num_steps=K_STEPS, eps=EPS,
                   dae_kwargs={"depth": depth, "encoder": "pool"})
    many = np.random.default_rng(43).random((PAR_SERVE_IMAGES, H, W, 3), dtype=np.float32)
    reset_tail_counts()
    t0 = time.perf_counter()
    if predictor:
        labels, probs = Predictor(fcn, dae, device=device, pp_mesh=pmesh, pp_microbatches=microbatches,
                                  batch_size=BATCH, **pred_kw).predict(many, return_probs=True)
    else:
        fwd = make_pp_flagship(pmesh, batch_axis=batch_axis, **kw)
        with torch.no_grad():
            _, yk = fwd(fcn, dae, split_microbatches(x, microbatches))
        yk = merge_microbatches(yk).float()
    torch.cuda.synchronize()
    out = {"pp_s": time.perf_counter() - t0, "launches": refine_tail.launches,
           "strided": refine_tail.strided_launches, "stage": axis_index(pmesh, "stage")}
    if _rank() != 0:
        return out
    if predictor:
        _check_answer(labels, probs, PAR_SERVE_IMAGES)
        out["agree"] = float((labels == Predictor(fcn, dae, device=device, batch_size=chunk, **pred_kw)
                              .predict(many)).mean())
        out["agree_whole"] = float((labels == Predictor(fcn, dae, device=device, batch_size=BATCH, **pred_kw)
                                    .predict(many)).mean())
        return out

    def one_process(xx):
        with torch.no_grad():
            if half:
                return flagship_forward_fn(num_steps=K_STEPS, eps=EPS, depth=3, compute_dtype=dtype)(fcn, dae, xx)[1]
            logits = score_logits_fn(arch)
            y0, h = fcn8_apply(fcn, xx, return_features=("pool4",), compute_dtype=dtype)
            return logits_refinement_scan(
                lambda y: logits(dae, y, h, compute_dtype=dtype, **score_kwargs(arch, depth=4)), y0, eps=EPS,
                num_steps=K_STEPS)

    ref = torch.cat([one_process(x[i:i + chunk]) for i in range(0, BATCH, chunk)]).float()
    d = (yk - ref).abs()
    out.update(max_abs=d.max().item(), beyond=(d > PAR_F32_TOL).float().mean().item(),
               agree=(yk.argmax(-1) == ref.argmax(-1)).float().mean().item(),
               agree_whole=(yk.argmax(-1) == one_process(x).float().argmax(-1)).float().mean().item())
    return out


PPGRAD_BATCH = 4  # 2 microbatches of 2 frames at 360x480, f32


def par_ppgrad(mesh, device):
    """The gradient of mean(y_K ** 2) through the flagship pipeline (2
    stages, half engine, score, K=5, f32, full width) in every FCN-8 and DAE
    param, without and with remat. Rank 0 holds both to the gradient of the
    same loss in one process (flagship_forward_fn over the same
    microbatches) and to each other; every rank reports a checksum of the
    gradient it returns (each must return the whole one) and its
    refine_tail launches (the kernel's forward under autograd; with remat
    the refinement stage runs it again in the backward)."""
    from iterative_inference_segm_tpu_torch.parallel.mesh import axis_index, make_mesh
    from iterative_inference_segm_tpu_torch.parallel.pp import make_pp_flagship, merge_microbatches, split_microbatches

    pmesh = make_mesh(("stage",), (2,), device_type="cuda")
    # cuDNN's backward algorithms may add in any order; deterministic ones let the pipeline, remat and the
    # one-process gradient differ only where the pipeline sums its microbatches' gradients
    torch.backends.cudnn.deterministic = True
    fcn, dae = flagship_params(device)
    leaves = _leaves_of(fcn) + _leaves_of(dae)
    for t in leaves:
        t.requires_grad_(True)
    images = np.random.default_rng(44).random((PPGRAD_BATCH, H, W, 3), dtype=np.float32)
    x = split_microbatches(normalize_image(torch.from_numpy(images), CAMVID).to(device), 2)
    kw = dict(eps=EPS, num_steps=K_STEPS, depth=3, compute_dtype=torch.float32)
    out, grads = {"stage": axis_index(pmesh, "stage")}, {}
    for remat in (False, True):
        reset_tail_counts()
        t0 = time.perf_counter()
        _, yk = make_pp_flagship(pmesh, remat=remat, **kw)(fcn, dae, x)
        loss = torch.mean(torch.square(merge_microbatches(yk)))
        grads[remat] = (loss.item(), torch.autograd.grad(loss, leaves))
        torch.cuda.synchronize()
        out[f"launches_{int(remat)}"] = refine_tail.launches
        out[f"strided_{int(remat)}"] = refine_tail.strided_launches
        out[f"secs_{int(remat)}"] = time.perf_counter() - t0
        out[f"checksum_{int(remat)}"] = sum(g.double().abs().sum().item() for g in grads[remat][1])
    if _rank() != 0:
        torch.backends.cudnn.deterministic = False
        return out
    fwd = flagship_forward_fn(**kw)
    loss = sum(torch.sum(torch.square(fwd(fcn, dae, xm)[1])) for xm in x) / (PPGRAD_BATCH * H * W * N_CLASSES)
    ref = torch.autograd.grad(loss, leaves)

    def worst(a, b):
        return max((u - v).abs().max().item() / max(v.abs().max().item(), 1e-30) for u, v in zip(a, b))

    out.update(loss=grads[False][0], loss_rel=abs(grads[False][0] - loss.item()) / loss.item(),
               grad_rel=worst(grads[False][1], ref), remat_rel=worst(grads[True][1], grads[False][1]),
               nonzero=sum(int(bool(g.abs().max() > 0)) for g in grads[False][1]), leaves=len(leaves))
    torch.backends.cudnn.deterministic = False
    return out


def run_parallel_phases(smi):
    """Phases 21-25 in four launches (2 ranks, 1 rank over NCCL, 3 ranks, 4
    ranks); returns the launches each kernel made in the ranks, summed."""
    from iterative_inference_segm_tpu_torch.parallel.launch import launch_ranks
    from iterative_inference_segm_tpu_torch.parallel.mesh import MeshSpec

    def run(cases, names, sizes, device="cuda:0", backend="gloo"):
        t0 = time.perf_counter()
        res = launch_ranks(par_cases, cases, mesh=MeshSpec(names, sizes), device=device, backend=backend,
                           kernels=("refine_tail", "corruption"))
        return res, time.perf_counter() - t0

    stage2 = dict(names=("stage",), sizes=(2,))
    t_all = time.perf_counter()
    r2, w2 = run([
        ("dae_f32", "par_dae_step", {"dtype": "float32", "from_gt": True, "seed": 35}),
        ("dae_bf16", "par_dae_step", {"dtype": "bfloat16", "from_gt": False, "seed": 36}),
        ("fcn", "par_fcn_step", {}),
        ("serve_half", "par_serve", {"engine": "half"}),
        ("serve_general", "par_serve", {"engine": "general"}),
        ("tp", "par_tp", {}),
        ("pp_half_m2", "par_pp", {"engine": "half", "arch": "dae", "microbatches": 2, **stage2}),
        ("pp_half_m4", "par_pp", {"engine": "half", "arch": "dae", "microbatches": 4, **stage2}),
        ("pp_general", "par_pp", {"engine": "general", "arch": "dae", "microbatches": 2, **stage2}),
        ("pp_mirror", "par_pp", {"engine": "general", "arch": "mirror", "microbatches": 4, **stage2}),
        ("pp_predictor", "par_pp", {"engine": "half", "arch": "dae", "microbatches": 2, "predictor": True,
                                    **stage2}),
        ("ppgrad", "par_ppgrad", {}),
    ], ("data",), (2,))
    r1, w1 = run([("dae_nccl", "par_dae_step", {"dtype": "float32", "from_gt": True, "seed": 35})], ("data",), (1,),
                 device="cuda", backend=None)
    r3, w3 = run([("pp3_half", "par_pp", {"engine": "half", "arch": "dae", "microbatches": 4}),
                  ("pp3_general", "par_pp", {"engine": "general", "arch": "dae", "microbatches": 2})],
                 ("stage",), (3,))
    r4, w4 = run([("dpxpp", "par_pp", {"engine": "half", "arch": "dae", "microbatches": 2})], ("data", "stage"), (2, 2))
    note = f"ranks sharing one card ({smi}), not a multi-card figure"
    secs = lambda res, *names: sum(res[0][n]["secs"] for n in names)  # noqa: E731
    launches = {"refine_tail": 0, "corrupt_onehot": 0, "corrupt_probs": 0}

    # 21: DP training
    for name, res, want in (("dae_f32", r2, (1, 0)), ("dae_bf16", r2, (0, 1)), ("dae_nccl", r1, (1, 0))):
        got = [(r[name]["k1"], r[name]["k2"]) for r in res]
        if any(g != want for g in got):
            raise AssertionError(f"{name}: K1/K2 launched {got} in the ranks; expected {want} each")
        launches["corrupt_onehot"] += sum(g[0] for g in got)
        launches["corrupt_probs"] += sum(g[1] for g in got)
        r0 = res[0][name]
        tol = TRAIN_PARITY_LOSS_TOL if name == "dae_bf16" else PAR_F32_TOL
        bad = r0["loss_rel"] > tol or (name != "dae_bf16" and not r0["param_rel"] <= PAR_F32_TOL) or r0["moved"] == 0
        phase("dp", f"train_dae step {name} ({len(res)} rank{'s' if len(res) > 1 else ''}, "
              f"{'nccl' if name == 'dae_nccl' else 'gloo'}), batch {PAR_BATCH} at {H}x{W} cropped to {CROP[0]}, "
              f"the CLI's DAE: loss {r0['loss']:.7f}, rel to the one-process reference {r0['loss_rel']:.2e} "
              f"(limit {tol}); params after the step, worst leaf {r0['param_rel']:.2e} of its largest "
              f"({r0['param_leaf']}); K1/K2 per rank {want}; step {r0['step_s']:.2f} s, case {r0['secs']:.1f} s")
        if bad:
            raise AssertionError(f"{name}: DP step beyond the reference")
    f = r2[0]["fcn"]
    phase("dp", f"train_fcn8 step (2 ranks), batch {PAR_FCN_BATCH} crop {CROP[0]}, fc 4096, f32, own crops and masks "
          f"a rank: loss rel {f['loss_rel']:.2e}; Adam exp_avg per leaf in norm, worst {f['moment_rel']:.2e} "
          f"({f['moment_leaf']}); params where the step is set, worst {f['param_rel']:.2e}; {f['unset']} of "
          f"{f['total']} entries left out; step {f['step_s']:.2f} s")
    if not (f["loss_rel"] <= PAR_F32_TOL and f["moment_rel"] <= FCN_PARITY_GRAD_TOL and f["param_rel"] <= PAR_F32_TOL):
        raise AssertionError("DP FCN-8 step beyond the reference")
    phase("dp", f"phase 21 in {secs(r2, 'dae_f32', 'dae_bf16', 'fcn') + secs(r1, 'dae_nccl'):.1f} s in the ranks; "
          f"{note}")

    # 22: DP serving
    chunks = -(-PAR_SERVE_IMAGES // BATCH)
    for name, per_chunk in (("serve_half", K_STEPS + 1), ("serve_general", K_STEPS)):
        got = [r[name]["launches"] for r in r2]
        if got != [per_chunk * chunks] * 2 or any(r[name]["strided"] for r in r2):
            raise AssertionError(f"{name}: refine_tail launched {got} in the ranks")
        launches["refine_tail"] += sum(got)
        r0 = r2[0][name]
        if name == "serve_half":
            ok = r0["agree"] >= MIN_ARGMAX_AGREE
            what = f"bf16 argmax agreement {r0['agree']:.6f} (limit {MIN_ARGMAX_AGREE})"
        else:
            ok = r0["max_abs"] <= PAR_F32_TOL and r0["off_beyond_ties"] == 0
            what = (f"f32 max|dprobs| {r0['max_abs']:.2e} (limit {PAR_F32_TOL}), labels differing beyond near-ties "
                    f"{r0['off_beyond_ties']}, agreement {r0['agree']:.6f}")
        phase("dpserve", f"Predictor(mesh) {name[6:]} engine, batch {BATCH} on 2 ranks (4 a rank), "
              f"{PAR_SERVE_IMAGES} images: against the single-device Predictor, {what}; refine_tail per rank {got[0]}; "
              f"{r0['serve_s']:.2f} s")
        if not ok:
            raise AssertionError(f"{name}: DP serving beyond the single-device Predictor")
    phase("dpserve", f"phase 22 in {secs(r2, 'serve_half', 'serve_general'):.1f} s in the ranks; {note}")

    # 23: TP
    for r, res in enumerate(r2):
        t = res["tp"]
        phase("tp", f"rank {r}: fc6 {t['shapes']['fc6']} fc7 {t['shapes']['fc7']}; fc6/fc7 params held "
              f"{t['held'] / 2**20:.1f} MiB of {t['whole'] / 2**20:.1f} MiB, Adam moments {t['moments'] / 2**20:.1f} MiB; "
              f"against the replicated run: logits {t['logits_rel']:.2e}, loss {t['loss_rel']:.2e}, gradients per leaf "
              f"in norm worst {t['grad_rel']:.2e} ({t['grad_leaf']}); step {t['step_s']:.2f} s")
        if not (t["logits_rel"] <= PAR_F32_TOL and t["loss_rel"] <= PAR_F32_TOL and t["grad_rel"] <= PAR_F32_TOL
                and t["held"] < 0.51 * t["whole"]):
            raise AssertionError(f"TP rank {r} beyond the replicated run")
    phase("tp", f"phase 23 in {secs(r2, 'tp'):.1f} s in the ranks; {note}")

    # 24: PP
    for res, name, m, last, per_mb in (
            (r2, "pp_half_m2", 2, 1, K_STEPS + 1), (r2, "pp_half_m4", 4, 1, K_STEPS + 1),
            (r2, "pp_general", 2, 1, K_STEPS), (r2, "pp_mirror", 4, 1, K_STEPS),
            (r2, "pp_predictor", 2 * chunks, 1, K_STEPS + 1), (r3, "pp3_half", 4, 2, K_STEPS + 1),
            (r3, "pp3_general", 2, 2, K_STEPS), (r4, "dpxpp", 2, 1, K_STEPS + 1)):
        got = [r[name]["launches"] for r in res]
        want = [per_mb * m if r[name]["stage"] == last else 0 for r in res]
        if got != want or any(r[name]["strided"] for r in res):
            raise AssertionError(f"{name}: refine_tail launched {got} in the ranks; expected {want}")
        launches["refine_tail"] += sum(got)
        r0 = res[0][name]
        if name in ("pp_general", "pp3_general"):
            ok = r0["max_abs"] <= PAR_F32_TOL
            what = f"f32 max|dy_K| {r0['max_abs']:.2e} (limit {PAR_F32_TOL})"
        elif name == "pp_mirror":
            ok = r0["agree"] >= PARITY_MIN_ARGMAX_AGREE and r0["beyond"] <= 1e-3
            what = (f"f32 mirror max|dy_K| {r0['max_abs']:.2e}, {r0['beyond']:.3%} of values beyond {PAR_F32_TOL} "
                    f"(limit 0.1%), argmax agreement {r0['agree']:.6f}")
        else:
            ok = r0["agree"] >= MIN_ARGMAX_AGREE
            what = f"bf16 argmax agreement {r0['agree']:.6f} (limit {MIN_ARGMAX_AGREE})"
        phase("pp", f"{name}: {len(res)} ranks, M={m if name != 'pp_predictor' else 2}, batch {BATCH} at {H}x{W} "
              f"against the one-process engine on the ranks' chunks: {what}; argmax agreement with one run of the "
              f"whole batch {r0['agree_whole']:.6f}; refine_tail per rank {got}; {r0['pp_s']:.2f} s")
        if not ok:
            raise AssertionError(f"{name}: the pipeline beyond the one-process engine")
    phase("pp", f"phase 24 in {secs(r2, 'pp_half_m2', 'pp_half_m4', 'pp_general', 'pp_mirror', 'pp_predictor') + secs(r3, 'pp3_half', 'pp3_general') + secs(r4, 'dpxpp'):.1f} s in the ranks; {note}")
    # 25: gradients through the pipeline
    g = [r["ppgrad"] for r in r2]
    got = [(r["launches_0"], r["launches_1"]) for r in g]
    want = [(2 * (K_STEPS + 1), 4 * (K_STEPS + 1)) if r["stage"] == 1 else (0, 0) for r in g]
    if got != want or any(r["strided_0"] or r["strided_1"] for r in g):
        raise AssertionError(f"ppgrad: refine_tail launched {got} in the ranks (no remat, remat); expected {want}")
    launches["refine_tail"] += sum(a + b for a, b in got)
    r0 = g[0]
    same = all(r[f"checksum_{i}"] == r0[f"checksum_{i}"] for r in g for i in (0, 1))
    phase("ppgrad", f"d mean(y_K^2) through make_pp_flagship (2 stages, M=2, batch {PPGRAD_BATCH} at {H}x{W}, f32, "
          f"K={K_STEPS}) in all {r0['leaves']} FCN-8 and DAE leaves ({r0['nonzero']} nonzero): loss {r0['loss']:.7f}, "
          f"rel to one process {r0['loss_rel']:.2e}; gradient against one process over the same microbatches, "
          f"worst leaf {r0['grad_rel']:.2e} of its largest (limit {PAR_F32_TOL}); remat against none "
          f"{r0['remat_rel']:.2e}; every rank returned the same gradient: {same}; refine_tail per rank {got}; "
          f"{r0['secs_0']:.2f} s, remat {r0['secs_1']:.2f} s")
    if not (r0["loss_rel"] <= PAR_F32_TOL and r0["grad_rel"] <= PAR_F32_TOL and r0["remat_rel"] <= PAR_F32_TOL
            and same and r0["nonzero"] == r0["leaves"]):
        raise AssertionError("ppgrad: the pipeline's gradient beyond one process's")
    phase("ppgrad", f"phase 25 in {secs(r2, 'ppgrad'):.1f} s in the ranks; {note}")
    phase("parallel", f"phases 21-25: {time.perf_counter() - t_all:.1f} s wall in 4 launches "
          f"({w2:.1f} s 2 ranks, {w1:.1f} s 1 rank over NCCL, {w3:.1f} s 3 ranks, {w4:.1f} s 4 ranks; each with "
          f"its ranks' start); {note}")
    return launches


# phases 26-29: the measuring entry points, each as a user runs it (main(argv), its printed lines)
BENCH_ITERS = 5  # the bench twin's chained block in this run (its default is 20)
BENCH_WARMUP = 2  # the twin's default
BENCH_CASES = (  # (name, argv, refine_tail launches a forward)
    ("b128", [], K_STEPS + 1),
    ("b8", ["--batch", 8], K_STEPS + 1),
    ("b32", ["--batch", 32], K_STEPS + 1),
    ("steps0", ["--steps", 0], 1),
    ("fast", ["--preset", "fast"], K_STEPS + 1),
    ("general", ["--engine", "general", "--batch", 8], K_STEPS),
    ("energy", ["--engine", "general", "--mode", "energy", "--batch", 8], 0),
)
SBENCH_ARGV = ["--batch", 32, "--num-batches", 4, "--epochs", 2, "--wire", "both"]
# the wires' sum(argmax(y_K)) a batch, relative: the u8 wire normalizes on the card and the runtime on the
# host, within 1e-6 of each other (phase 18); rounded to bf16 for the FCN they differ in a last bit here and
# there, which flips ~0.01% of the labels (3.1e-05 on an H100; the f32 wire equals the resident batch)
SBENCH_SUM_TOL = 1e-4
TBENCH_ARGV = ["--batches", 32, "--crops", 224, "--augment", "both", "--iters", 3, "--no-history"]
ENTRY_LINE = "entry() OK (1, 360, 480, 11) torch.bfloat16"
# refine_tail against its plain version at what each configuration that launches it hands it, at the batches
# the phases run it: (name, the bench twin's argv or None for serve_bench's flagship, batches). --steps 0 makes
# the default's rectification alone, energy mode no call
BENCH_KERNEL_CASES = (
    ("bench", [], (8, 32, 128)),
    ("bench fast", ["--preset", "fast"], (128,)),
    ("bench general", ["--engine", "general"], (8,)),
    ("serve_bench", None, (SBENCH_ARGV[1],)),
)


def reset_counts() -> None:
    reset_tail_counts()
    ck.corrupt_onehot.launches = 0
    ck.corrupt_probs.launches = 0


def bench_kernel_cases(dev) -> float:
    """refine_tail against its plain version on the card at the shapes,
    dtypes and terms each of ``BENCH_KERNEL_CASES`` hands it: the calls
    recorded on one image through the twin's own pipeline, then seeded maps
    at each batch. Returns the worst max abs error."""
    worst = 0.0
    x = torch.randn((1, H, W, 3), generator=torch.Generator().manual_seed(2)).to(dev)
    for name, argv, batches in BENCH_KERNEL_CASES:
        if argv is None:
            fcn, dae = flagship_params(dev)
            flagship = serve_tool.build_flagship(serve_tool.parse_args([]))
            with torch.inference_mode():
                recs = tail_bench.record_layouts(lambda: flagship(fcn, dae, x))
        else:
            args = bench_tool.parse_args(argv)
            fcn, dae = bench_tool.init_params(args, dev)
            pipeline = bench_tool.build_pipeline(args)
            recs = tail_bench.record_layouts(lambda: pipeline(fcn, dae, x))
        del fcn, dae
        for batch in batches:
            for case in tail_bench.cases_at(dev, recs, batch, prefix=f"{name} "):
                got, ref = case.kernel(), case.plain()
                err, agree = check_kernel_case(case.name, got, ref, case.with_labels, case.y.dtype)
                worst = max(worst, err)
                phase("bench", f"refine_tail, {case.name}: y={tuple(case.y.shape)} u={tuple(case.u.shape)} "
                      f"{str(case.u.dtype)[6:]} v {case.v is not None} b {case.b is not None} labels "
                      f"{case.with_labels}: max_abs_err={err:.3e} argmax_agree={agree:.6f}")
                del got, ref, case
        torch.cuda.empty_cache()
    return worst


def run_bench_phase(dev, smi, timing_ips):
    """refine_tail at the bench and serving shapes (``bench_kernel_cases``);
    the bench twin's configurations (``bench_cases``); its batch-8 and -32
    readings beside phase 6's; fc6 alone at batch 8, 32 and 128."""
    worst = bench_kernel_cases(dev)
    launches, readings = bench_cases(smi)
    for b in (8, 32):
        phase("bench", f"batch {b}: the bench twin {readings[f'b{b}']:.1f} images/s (best of 3 blocks of "
              f"{BENCH_ITERS}), phase 6 {timing_ips[b]:.1f} (the same function, best of 3 blocks of 20)")
    fcn, _ = flagship_params(dev)
    with torch.inference_mode():
        pools, _ = fcn8_backbone(fcn, torch.zeros((1, H, W, 3), device=dev), compute_dtype=torch.bfloat16)
    p5 = tuple(pools["pool5"].shape[1:])
    w6, b6 = fcn["fc6"]["w"].to(torch.bfloat16), fcn["fc6"]["b"].to(torch.bfloat16)
    for b in (8, 32, 128):
        x5 = torch.randn((b, *p5), device=dev, dtype=torch.bfloat16)
        with torch.inference_mode():
            ms = cuda_ms(lambda: conv2d(x5, w6, b6), iters=10)
        fwd_ms = b * 1e3 / readings[f"b{b}"]
        phase("bench", f"fc6 alone (7x7 conv 512 -> 4096 on the {p5[0]}x{p5[1]} pool5 map, bf16) at batch {b}: "
              f"{ms:.3f} ms, {100.0 * ms / fwd_ms:.1f}% of the twin's forward ({fwd_ms:.2f} ms); on {smi}")
    return launches, readings, worst


def bench_cases(smi):
    """The bench twin's main at each of ``BENCH_CASES``, as a user runs it:
    its JSON line (the card's stamp, JAX's keys but ``frontier``), and
    refine_tail launched (K + 1) a half-engine forward, K a general score
    forward, none in energy mode, over the warm-up and the 3 timed blocks."""
    readings, launches = {}, 0
    forwards = BENCH_WARMUP + 3 * BENCH_ITERS
    for name, argv, per_forward in BENCH_CASES:
        reset_counts()
        lines, secs = run_cli(bench_tool.main, ["--no-history", "--iters", BENCH_ITERS, *argv])
        rec = json.loads(lines[-1])
        want = per_forward * forwards
        if refine_tail.launches != want or ck.corrupt_onehot.launches or ck.corrupt_probs.launches:
            raise AssertionError(f"bench {name}: refine_tail launched {refine_tail.launches}; expected {want}")
        check_no_strided(f"bench {name}")
        if rec["device"] != smi or not rec["value"] > 0 or set(rec) != {"metric", "value", "unit", "vs_baseline",
                                                                        "device"}:
            raise AssertionError(f"bench {name}: {lines[-1]}")
        launches += refine_tail.launches
        readings[name] = rec["value"]
        phase("bench", f"{name}: {lines[-1]} (refine_tail {refine_tail.launches} = {per_forward} x {forwards} "
              f"forwards; {secs:.1f} s wall)")
    return launches, readings


def run_sbench_phase(dev, fcn, dae, smi):
    """The serve_bench twin over a packed file on both wires: its lines,
    refine_tail (K + 1) a forward, the wires' sums equal."""
    args = serve_tool.parse_args([str(a) for a in SBENCH_ARGV])
    reset_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        results, sums = serve_tool.run(args, fcn, dae, dev)
    secs = time.perf_counter() - t0
    for line in buf.getvalue().splitlines():
        phase("sbench", line)
    forwards = 1 + max(args.num_batches * args.epochs, 8) + 2 * args.epochs * args.num_batches
    want = (K_STEPS + 1) * forwards
    if refine_tail.launches != want:
        raise AssertionError(f"sbench: refine_tail launched {refine_tail.launches}; expected {want}")
    check_no_strided("sbench")
    diff = max(abs(a - b) / a for a, b in zip(sums["e2e_f32"], sums["e2e_u8"]))
    first = abs(sums["compute"] - sums["e2e_f32"][0]) / sums["compute"]
    line = serve_tool.result_line(results, dev)
    phase("sbench", f"{json.dumps(line)} (refine_tail {refine_tail.launches} = {K_STEPS + 1} x {forwards} forwards; "
          f"sum(argmax(y_K)) a batch, f32 wire {sums['e2e_f32']}, u8 wire {sums['e2e_u8']}, resident "
          f"{sums['compute']}: the wires differ by {diff:.2e}, resident vs e2e {first:.2e} (limit {SBENCH_SUM_TOL}); "
          f"{secs:.1f} s wall)")
    if diff > SBENCH_SUM_TOL or first > SBENCH_SUM_TOL or line["device"] != smi:
        raise AssertionError("sbench: the wires' answers disagree")
    return refine_tail.launches


def run_tbench_phase(dev, smi):
    """The train_bench twin at batch 32, crop 224, augment both, without
    and with remat: K1 launched once a DAE step, refine_tail never."""
    k1 = 0
    for remat in (False, True):
        reset_counts()
        lines, secs = run_cli(train_tool.main, TBENCH_ARGV + (["--remat"] if remat else []))
        recs = [json.loads(ln) for ln in lines if ln.startswith("{")]
        iters = TBENCH_ARGV[TBENCH_ARGV.index("--iters") + 1]
        steps = 2 * (1 + 3 * iters)  # the DAE cell at augment on and off, a warm-up step and 3 blocks each
        if ck.corrupt_onehot.launches != steps or refine_tail.launches or ck.corrupt_probs.launches:
            raise AssertionError(f"tbench remat={remat}: K1 launched {ck.corrupt_onehot.launches}; expected {steps} "
                                 "(one a DAE step)")
        if len(recs) != 4 or any(r.get("oom") or "mfu_pct" not in r or r["device"] != smi for r in recs):
            raise AssertionError(f"tbench remat={remat}: {lines}")
        k1 += ck.corrupt_onehot.launches
        for r in recs:
            phase("tbench", json.dumps(r))
        phase("tbench", f"remat={remat}: K1 launches {ck.corrupt_onehot.launches} = one a DAE step; {secs:.1f} s wall")
    return k1


def run_entry_phase(dev):
    """entry(): the forward on its example arguments (finite, a softmax a
    pixel), then ``python -m ...entry``'s line."""
    reset_counts()
    fn, example = entry_point.entry(dev)
    y = fn(*example).float()
    if tuple(y.shape) != (1, H, W, N_CLASSES) or not torch.isfinite(y).all() or (y.sum(-1) - 1).abs().max() > 2e-2:
        raise AssertionError(f"entry(): y_K {tuple(y.shape)} not a finite softmax map")
    del fn, example
    lines, secs = run_cli(entry_point.main, [])
    want = 2 * (K_STEPS + 1)
    if lines[-1] != ENTRY_LINE or refine_tail.launches != want:
        raise AssertionError(f"entry: {lines[-1]!r}, refine_tail {refine_tail.launches} (expected {want})")
    check_no_strided("entry")
    phase("entry", f"{lines[-1]}; y_K finite, a softmax a pixel; refine_tail {refine_tail.launches} = (K+1) x 2 "
          f"forwards; {secs:.1f} s wall")
    return refine_tail.launches


# ---------------------------------------------------------------- phase 30: spatial (H) sharding

SPACE_BATCH = 2
SPACE_TOL = 1e-4  # y0 / y_K sharded against one process on the same card, f32, max abs
SPACE_STEP_TOL = 1e-4  # the step's Adam first moment per leaf, of its largest (the loss: PAR_F32_TOL)
MULTICHIP_LINE = "dryrun_multichip(4) OK"


@contextlib.contextmanager
def _comm_log():
    """The exchanges the spatial ops make through parallel.comm while the
    block runs: isend/irecv as (this group rank, peer), and the counts of
    all-gathers and all-reduces."""
    from iterative_inference_segm_tpu_torch.parallel import comm

    log = {"isend": [], "irecv": [], "all_gather_cat": 0, "all_reduce_": 0}
    saved = {name: getattr(comm, name) for name in log}

    def peer_call(name):
        def call(t, peer, group, **kw):
            log[name].append((torch.distributed.get_rank(group), peer))
            return saved[name](t, peer, group, **kw)
        return call

    def counted(name):
        def call(*a, **kw):
            log[name] += 1
            return saved[name](*a, **kw)
        return call

    comm.isend, comm.irecv = peer_call("isend"), peer_call("irecv")
    comm.all_gather_cat, comm.all_reduce_ = counted("all_gather_cat"), counted("all_reduce_")
    try:
        yield log
    finally:
        for name, fn in saved.items():
            setattr(comm, name, fn)


@contextlib.contextmanager
def _recorded_tail_calls():
    """refine_tail's arguments at each distinct layout the engines hand it,
    kept (cloned) for the check against the plain version; the kernel still
    runs, and counts, as it does."""
    from iterative_inference_segm_tpu_torch.inference import fused as fused_mod
    from iterative_inference_segm_tpu_torch.inference import iterative as iterative_mod

    tails = {}

    def tail(u, y, eps, **kw):
        key = (tuple(u.shape), u.dtype, tuple(y.shape), y.dtype, tuple(sorted((k, v is not None) for k, v in kw.items())))
        if key not in tails:
            tails[key] = (u.detach().clone(), y.detach().clone(), eps,
                          {k: v.detach().clone() if isinstance(v, torch.Tensor) else v for k, v in kw.items()})
        return refine_tail(u, y, eps, **kw)

    fused_mod.refine_tail = iterative_mod.refine_tail = tail
    try:
        yield tails
    finally:
        fused_mod.refine_tail = iterative_mod.refine_tail = refine_tail


def par_space(mesh, device):
    """Phase 30 in one of 2 ranks on ('data', 'space') (1, 2): the sharded
    FCN-8 forward (with its exchanges), general and half engines and DAE
    step, their launches, then rank 0's unsharded runs and the kernels
    against their plain versions at what the sharded runs handed them."""
    from iterative_inference_segm_tpu_torch.inference.fused import make_half_refiner
    from iterative_inference_segm_tpu_torch.parallel.mesh import axis_group
    from iterative_inference_segm_tpu_torch.parallel.sharding import gather_batch, shard_batch
    from iterative_inference_segm_tpu_torch.parallel.spatial import rows_of

    torch.backends.cudnn.deterministic = True
    group = axis_group(mesh, "space")
    fcn, dae = flagship_params(device)
    gdae = general_params(device)
    x = torch.from_numpy(np.random.default_rng(51).random((SPACE_BATCH, H, W, 3), dtype=np.float32)).to(device)
    xs = shard_batch(mesh, x, spatial_axis="space")
    general = dict(eps=EPS, num_steps=3, h_taps=("pool4",))
    half = dict(eps=EPS, num_steps=K_STEPS, h_taps=("pool4",), depth=3, compute_dtype=torch.float32)
    images, labels = next(synthetic_batches(cfg=CAMVID, batch_size=SPACE_BATCH, num_batches=1, seed=52))
    rand = draw_step_randomness(torch.Generator().manual_seed(53), batch=SPACE_BATCH, hw=(H, W), crop=CROP, p_gt=1.0)
    init = init_dae(torch.Generator().manual_seed(12), n_classes=N_CLASSES, h_specs={"pool4": DAE_H_CHANNELS["pool4"]},
                    depth=4, stem_pool=0, device=device)
    tcfg = TrainConfig()
    step_kw = dict(h_taps=("pool4",), sigma=SIGMA, from_gt=True, dae_depth=4, corruption_impl="kernel")
    whole = (torch.from_numpy(images).to(device), torch.from_numpy(labels).to(device))

    def step_run(step_mesh, batch):
        params = _clone(init)
        opt = make_optimizer(tcfg, params)
        with contextlib.redirect_stdout(io.StringIO()):
            step, _ = make_dae_train_step(CAMVID, tcfg, opt, mesh=step_mesh, **step_kw)
            loss = float(step(params, fcn, *batch, rand))
        return loss, {f"{k}/{kk}": opt.state[t]["exp_avg"] for k, v in params.items() for kk, t in v.items()}, step

    reset_counts()
    out = {}
    with _recorded_tail_calls() as tails:
        t0 = time.perf_counter()
        with torch.no_grad(), _comm_log() as log:
            probs, _ = fcn8_apply(fcn, xs, space=rows_of(group, xs))
            torch.cuda.synchronize()
        out["fcn_s"], out["log"] = time.perf_counter() - t0, log
        t0 = time.perf_counter()
        g0, gk = make_refiner(fcn8_apply, score_apply_fn("dae"), fcn, gdae, space_group=group, **general)(xs)
        torch.cuda.synchronize()
        out["general_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        h0, hk = make_half_refiner(fcn8_apply, fcn, dae, space_group=group, **half)(xs)
        torch.cuda.synchronize()
        out["half_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        loss, m1, step = step_run(mesh, shard_batch(mesh, whole, spatial_axis="space"))
        torch.cuda.synchronize()
        out["step_s"] = time.perf_counter() - t0
    out.update(k3=refine_tail.launches, strided=refine_tail.strided_launches, k1=ck.corrupt_onehot.launches)
    got = {name: gather_batch(mesh, t.contiguous(), spatial_axis="space").float()
           for name, t in (("fcn", probs), ("g0", g0), ("gk", gk), ("h0", h0), ("hk", hk))}
    # the kernels against their plain versions, outside the counted runs
    tail_err, tail_agree = 0.0, 1.0
    for u, y, eps, kw in tails.values():
        want = refine_tail_reference(u, y, eps, **kw)
        have = refine_tail(u, y, eps, **kw)
        if kw.get("with_labels"):
            tail_agree = min(tail_agree, (have[1] == want[1]).float().mean().item())
            have, want = have[0], want[0]
        tail_err = max(tail_err, (have.float() - want.float()).abs().max().item())
    # K1's input in the sharded step: the gathered whole labels, cropped as the step crops them
    _, lab = step.stages.prepare(*whole, rand)
    kw = {"n_classes": N_CLASSES, "sigma": SIGMA}
    k1_equal = torch.equal(ck.corrupt_onehot(lab, rand.noise_seed, **kw),
                           ck.corrupt_onehot_kernel_reference(lab, rand.noise_seed, **kw))
    out.update(tail_err=tail_err, tail_agree=tail_agree, tail_layouts=len(tails), k1_equal=k1_equal,
               k1_shapes=[tuple(lab.shape)], loss=loss)
    if _rank() == 0:
        with torch.no_grad():
            ref = {"fcn": fcn8_apply(fcn, x)[0]}
        ref["g0"], ref["gk"] = make_refiner(fcn8_apply, score_apply_fn("dae"), fcn, gdae, **general)(x)
        ref["h0"], ref["hk"] = make_half_refiner(fcn8_apply, fcn, dae, **half)(x)
        out["err"] = {k: (got[k] - ref[k].float()).abs().max().item() for k in got}
        out["agree"] = {k: (got[k].argmax(-1) == ref[k].float().argmax(-1)).float().mean().item() for k in got}
        ref_loss, ref_m1, _ = step_run(None, whole)
        out["loss_rel"] = abs(loss - ref_loss) / abs(ref_loss)
        rel = {k: (m1[k] - v).abs().max().item() / max(v.abs().max().item(), 1e-30) for k, v in ref_m1.items()}
        out["m1_rel"], out["m1_leaf"] = max(rel.values()), max(rel, key=rel.get)
    return out


def run_space_phase(smi):
    """Phase 30: one launch of 2 ranks sharing cuda:0 over gloo, then the
    multichip dry run as a user runs it; returns the kernel launches the
    ranks made."""
    from iterative_inference_segm_tpu_torch.parallel.launch import launch_ranks
    from iterative_inference_segm_tpu_torch.parallel.mesh import MeshSpec

    t_phase = time.perf_counter()
    res = launch_ranks(par_cases, [("space", "par_space", {})], mesh=MeshSpec(("data", "space"), (1, 2)),
                       device="cuda:0", backend="gloo", kernels=("refine_tail", "corruption"))
    ranks_s = time.perf_counter() - t_phase
    outs = [r["space"] for r in res]
    r0 = outs[0]
    note = f"ranks sharing one card ({smi}), a correctness reading, not a speed figure"
    for i, o in enumerate(outs):
        log = o["log"]
        pairs = log["isend"] + log["irecv"]
        if not pairs or any(abs(me - peer) != 1 for me, peer in pairs) or log["all_gather_cat"] or log["all_reduce_"]:
            raise AssertionError(f"space: rank {i}'s FCN-8 forward exchanges {log} break the halo contract")
        # K3: K general steps + (K+1) half-engine launches; K1: once in the step
        if o["k3"] != 3 + K_STEPS + 1 or o["k1"] != 1 or o["strided"]:
            raise AssertionError(f"space: rank {i} launched refine_tail {o['k3']} (strided {o['strided']}), "
                                 f"corrupt_onehot {o['k1']}; expected {3 + K_STEPS + 1}, 1")
        if not (o["tail_err"] <= F32_TOL and o["tail_agree"] >= MIN_ARGMAX_AGREE and o["k1_equal"]):
            raise AssertionError(f"space: rank {i}'s kernels against their plain versions: refine_tail "
                                 f"{o['tail_err']:.3e} (agree {o['tail_agree']}), corrupt_onehot equal {o['k1_equal']}")
    log = r0["log"]
    phase("space", f"FCN-8 forward, fc 4096, batch {SPACE_BATCH} at {H}x{W} f32 over ('data', 'space') (1, 2): "
          f"rank 0 sent {len(log['isend'])} / received {len(log['irecv'])} halo blocks, all to its neighbour; "
          f"all-gathers {log['all_gather_cat']}, all-reduces {log['all_reduce_']}; {r0['fcn_s']:.2f} s")
    bad = []
    for k in ("fcn", "g0", "gk", "h0", "hk"):
        if not (r0["err"][k] <= SPACE_TOL and r0["agree"][k] >= MIN_ARGMAX_AGREE):
            bad.append(k)
    phase("space", "sharded against one process, max abs (argmax agreement): " + ", ".join(
        f"{k} {r0['err'][k]:.2e} ({r0['agree'][k]:.6f})" for k in ("fcn", "g0", "gk", "h0", "hk"))
        + f"; limit {SPACE_TOL} (>= {MIN_ARGMAX_AGREE}); general K=3 {r0['general_s']:.2f} s, half K={K_STEPS} "
        f"{r0['half_s']:.2f} s")
    phase("space", f"train_dae step gt, batch {SPACE_BATCH} crop {CROP[0]}, the CLI's DAE (depth 4), f32: loss "
          f"{r0['loss']:.7f}, rel to one process {r0['loss_rel']:.2e} (limit {PAR_F32_TOL}); Adam exp_avg worst leaf "
          f"{r0['m1_rel']:.2e} of its largest ({r0['m1_leaf']}, limit {SPACE_STEP_TOL}); K1 on the gathered labels "
          f"{r0['k1_shapes']}; {r0['step_s']:.2f} s")
    if bad or not (r0["loss_rel"] <= PAR_F32_TOL and r0["m1_rel"] <= SPACE_STEP_TOL):
        raise AssertionError(f"space: sharded beyond one process ({bad}, step {r0['loss_rel']:.2e}, "
                             f"{r0['m1_rel']:.2e})")
    phase("space", f"kernels against their plain versions at the sharded runs' arguments: refine_tail at "
          f"{r0['tail_layouts']} layouts max abs err {max(o['tail_err'] for o in outs):.3e} (limit {F32_TOL}), "
          f"labels agree {min(o['tail_agree'] for o in outs):.6f}; corrupt_onehot bit-equal: "
          f"{all(o['k1_equal'] for o in outs)}; launches per rank refine_tail {[o['k3'] for o in outs]}, "
          f"corrupt_onehot {[o['k1'] for o in outs]}")
    lines, secs = run_cli(entry_point.main, ["multichip", 4])
    if lines[-1] != MULTICHIP_LINE:
        raise AssertionError(f"multichip: {lines[-1]!r}")
    phase("space", f"python -m ...entry multichip 4 (4 ranks sharing the card over gloo): {lines[-1]}; {secs:.1f} s")
    phase("space", f"phase 30 in {time.perf_counter() - t_phase:.1f} s wall ({ranks_s:.1f} s the 2-rank launch with "
          f"its ranks' start); {note}")
    return {"refine_tail": sum(o["k3"] for o in outs), "corrupt_onehot": sum(o["k1"] for o in outs)}



# ---------------------------------------------------------------- phase 31: the phase-major fused engine
FUSED_ARGV = ["--engine", "fused", "--dae-tail", "sep"]
FUSED_CARRIES = ((), ("--state-dtype", "f32"))  # the bench twin's fused engine at a bf16 and an f32 carry
FUSED_BENCH_ITERS = 3  # the fused_bench twin's chained block in this run (its default is 8)
FUSED_CHECK_BATCH = 2  # the engine against the general engine on the card, f32
# the gradient through one kernel step against the plain version's, per leaf, of its largest entry: both
# backwards differentiate the plain version at the same inputs, so they differ in summation order only
FUSED_GRAD_TOL = 1e-5
FUSED_PROFILE_ITERS = 2  # fused bench forwards under torch.profiler
# The tiled form's tile is 12 x 16 half-resolution positions; y_ph goes by 16-byte copies where its rows
# are whole 16-byte units (Wh a multiple of 8 in bf16, of 4 in f32), else a value at a time.
FUSED_EDGE = (  # (name, batch, classes, Hh, Wh, s channel-leading, dtype of y_ph and s)
    ("C=2", 2, 2, 45, 61, False, torch.float32),
    ("C=2 bf16", 2, 2, 45, 61, True, torch.bfloat16),
    ("C=33", 1, 33, 20, 37, False, torch.float32),
    ("C=33 bf16", 1, 33, 20, 37, True, torch.bfloat16),
    ("2x2 map", 3, 11, 1, 1, False, torch.float32),
    ("2x2 map bf16", 3, 11, 1, 1, True, torch.bfloat16),
    ("channel-leading s", 2, 11, 45, 61, True, torch.float32),
    ("a tile multiple less 1, bf16 rows of 62 B", 2, 11, 23, 31, False, torch.bfloat16),
    ("a tile multiple plus 1, bf16 rows of 66 B", 2, 11, 25, 33, True, torch.bfloat16),
    ("a tile multiple plus 1, f32", 3, 11, 13, 17, True, torch.float32),
    ("ragged tiles by 16-byte copies, bf16", 2, 11, 23, 40, True, torch.bfloat16),
    ("ragged tiles by 16-byte copies, f32", 2, 11, 25, 36, False, torch.float32),
    ("smaller than a tile, by 16-byte copies", 2, 11, 5, 8, False, torch.bfloat16),
    ("smaller than a tile", 2, 11, 7, 9, True, torch.float32),
    ("unaligned bf16 rows", 2, 11, 45, 61, False, torch.bfloat16),
    ("C=2 by 16-byte copies", 2, 2, 13, 24, True, torch.bfloat16),
)


def septail_ops(c: int) -> int:
    """f32 operations a pixel and class of ``septail_step``, counted from
    its code as K5's are (a multiply-add counts 2; expf and the IEEE divide
    12 each, as in ``PATTERN_OPS``): the 4 deconv and 9 stencil taps, the C
    multiply-adds of the mix and its bias, the softmax, the blend's
    subtract and multiply-add."""
    return 2 * (4 + 9) + 2 * c + 1 + (1 + 1 + 12 + 1 + 12) + 2


def septail_bound(y_ph, s) -> dict:
    """Bytes (y_ph and s read once, y_ph' written once) and operations of one
    launch on these inputs, and the least time they take on the card."""
    b, _, _, c, hh, wh = (int(d) for d in y_ph.shape)
    nbytes = 2 * y_ph.numel() * y_ph.element_size() + s.numel() * s.element_size()
    flops = 4 * b * hh * wh * c * septail_ops(c)
    return {"bytes": nbytes, "flops": flops, **tail_bench.bound_ms(nbytes, flops)}


def septail_inputs(dev, b, c, hh, wh, channel_leading, dtype, seed, s_stride=None):
    """Seeded phase-major probabilities, a score map (B, Hh, Wh, C) in NHWC or
    channel-leading memory (or at ``s_stride``), and the step's weights in
    the JAX layouts, all on the card."""
    gen = torch.Generator(dev).manual_seed(seed)
    y_ph = torch.softmax(torch.randn((b, 2, 2, c, hh, wh), device=dev, generator=gen) * 2, dim=3).to(dtype)
    s = torch.randn((b, hh, wh, c), device=dev, generator=gen)
    if s_stride is not None:
        s = torch.empty_strided(s.shape, s_stride, device=dev).copy_(s)
    elif channel_leading:
        s = s.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    weights = [(torch.randn(shape, device=dev, generator=gen) * 0.5).to(dtype)
               for shape in ((4, 4, c), (3, 3, c), (c, c), (c,))]
    return y_ph, s.to(dtype), weights


def check_septail(name, y_ph, s, w) -> tuple[float, float]:
    """septail_step against septail_step_reference on the same card inputs:
    max abs err within the tolerance; the class argmax the plain version's
    but at near-ties (the plain value at the kernel's class within the
    tolerance of the plain maximum), and agreeing on >= 99.9% of a map of
    10^5 pixels or more (a smaller map holds one flip over 0.1%). Returns
    (max abs err, argmax agreement)."""
    got = septail_step(y_ph, s, *w, EPS)
    if got.dtype != y_ph.dtype or not got.is_contiguous():
        raise AssertionError(f"septail_step {name}: returned {got.dtype} {got.stride()}")
    got, want = got.float(), septail_step_reference(y_ph, s, *w, EPS).float()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    arg = got.argmax(3, keepdim=True)
    agree = (arg == want.argmax(3, keepdim=True)).float().mean().item()
    tol = F32_TOL if y_ph.dtype == torch.float32 else BF16_TOL
    ties_only = bool((want.gather(3, arg) >= want.amax(3, keepdim=True) - tol).all())
    big = arg.numel() >= 10**5
    if not err <= tol or not ties_only or (big and agree < MIN_ARGMAX_AGREE):
        raise AssertionError(f"septail_step {name}: max abs err {err:.3e} (tol {tol:.1e}), argmax agree {agree:.6f}, "
                             f"differing only at near-ties {ties_only}")
    return err, agree


def record_septail(fn) -> list[dict]:
    """The shapes, strides and dtypes ``fn`` hands ``septail_step``."""
    seen = []
    real = fused_engine.septail_step

    def recorder(y_ph, s, *rest):
        seen.append({name: (tuple(t.shape), t.stride(), t.dtype) for name, t in (("y_ph", y_ph), ("s", s))})
        return real(y_ph, s, *rest)

    fused_engine.septail_step = recorder
    try:
        fn()
    finally:
        fused_engine.septail_step = real
    return seen


def perturbed_sep_tail(dae, seed):
    """The 'sep' tail's leaves moved by 0.1 x N(0, 1): the bilinear, delta
    and identity inits are symmetric and would hide a flip or a transpose."""
    gen = torch.Generator().manual_seed(seed)
    for layer in ("up_stem_dw", "score_input_dw", "mix"):
        for leaf, t in dae[layer].items():
            dae[layer][leaf] = t + 0.1 * torch.randn(t.shape, generator=gen).to(t.device)
    return dae


def septail_instances(dev, wh: int) -> dict:
    """ptxas's registers, spills and static shared memory and the static
    SASS instructions of each ``septail_step`` instance, and what a launch
    of C = 11, 2 and 33 classes takes at the bench step's width
    (``kernel_plan``: threads and dynamic shared bytes a block, resident
    blocks an SM, 16-byte copies), keyed by (dtype, C); the C = 11 entries
    also carry their instance's ptxas and SASS readings."""
    lib = _build.build("septail_step")
    entries, sass = ptxas_entries(lib.with_suffix(".log")), sass_counts(lib)
    for name, (regs, spill, smem) in entries.items():
        phase("fused", f"septail_step instance {name}: {regs} registers, {spill}, {smem} B static shared (ptxas); "
              f"{sass.get(name, {}).get('instructions', '?')} static SASS instructions")
    plans = {}
    for dt, tag in ((torch.bfloat16, "13__nv_bfloat16"), (torch.float32, "f")):
        for c in (N_CLASSES, 2, WIDE_CLASSES[0]):
            plan = plans[(dt, c)] = septail_plan(dt, c, wh, dev)
            phase("fused", f"septail_step launch, {str(dt)[6:]} C={c} Wh={wh}: {plan['form']} form, "
                  f"{plan['threads']} threads and {plan['smem_bytes']} B dynamic shared a block, "
                  f"{plan['blocks_per_sm']} blocks an SM, {plan['registers']} registers, y_ph by 16-byte copies "
                  f"{plan['cp_async']}")
        name = next((k for k in entries if k.startswith(f"septail_tile_kernel<{tag}Li{N_CLASSES}E")), None)
        if name is None or plans[(dt, N_CLASSES)]["form"] != "tiled":
            raise AssertionError(f"fused: no tiled C={N_CLASSES} instance of septail_step for {dt}: {list(entries)}")
        plans[(dt, N_CLASSES)].update(instance=name, spill=entries[name][1], static_smem=entries[name][2],
                                      sass_instructions=sass.get(name, {}).get("instructions"))
    return plans


def run_fused_kernel_checks(dev, smi):
    """septail_step against its plain version at the bench step (the layouts
    the bench twin's pipeline hands it, batch 128) in bf16 and f32, timed warm
    and cold against its bound; the edge cases; C = 129 refused; the
    gradient through one kernel step against the plain version's."""
    args = bench_tool.parse_args(FUSED_ARGV)
    fcn, dae = bench_tool.init_params(args, dev)
    x1 = torch.randn((1, H, W, 3), generator=torch.Generator().manual_seed(2)).to(dev)
    worst, report = 0.0, {}
    flush = tail_bench.flush_buffer(dev)
    plans = septail_instances(dev, W // 2)
    for carry in (torch.bfloat16, torch.float32):
        args.state_dtype = "bf16" if carry == torch.bfloat16 else "f32"
        recs = record_septail(lambda: bench_tool.build_pipeline(args)(fcn, dae, x1))
        (b1, _, _, c, hh, wh), s_stride, s_dt = recs[0]["y_ph"][0], recs[0]["s"][1], recs[0]["s"][2]
        if len(recs) != K_STEPS or s_dt != carry or recs[0]["y_ph"][2] != carry:
            raise AssertionError(f"fused: the pipeline handed septail_step {recs}")
        # at the bench twin's batch, s's strides as recorded (a dense map's batch stride is Hh Wh C)
        stride = (hh * wh * c, *s_stride[1:])
        y_ph, s, w = septail_inputs(dev, args.batch, c, hh, wh, False, carry, 0, s_stride=stride)
        name = f"bench step {str(carry)[6:]} carry"
        err, agree = check_septail(name, y_ph, s, w)
        worst = max(worst, err)
        kernel = lambda: septail_step(y_ph, s, *w, EPS)  # noqa: E731
        warm, ahead_w = tail_bench.device_times(kernel)
        cold, ahead_c = tail_bench.device_times(kernel, flush=flush)
        plain, ahead_p = tail_bench.device_times(lambda: septail_step_reference(y_ph, s, *w, EPS), iters=3)
        t = {"max_abs_err": err, "warm_ms": warm[0], "cold_ms": statistics.median(cold), "cold_min_ms": min(cold),
             "cold_max_ms": max(cold), "plain_ms": plain[0], **septail_bound(y_ph, s), **plans[(carry, c)]}
        t["share"] = t["bound_ms"] / t["cold_ms"]
        report[args.state_dtype] = t
        phase("fused", f"septail_step, {name}: y_ph {tuple(y_ph.shape)} s {tuple(s.shape)} stride {s.stride()} "
              f"(as the pipeline hands it at batch {b1}): max_abs_err={err:.3e} "
              f"argmax_agree={agree:.6f}; warm {t['warm_ms']:.4f} ms, cold {t['cold_ms']:.4f} ms (launches "
              f"{t['cold_min_ms']:.4f}..{t['cold_max_ms']:.4f}), plain {t['plain_ms']:.4f} ms; "
              f"{t['bytes'] / 1e9:.3f} GB, {t['flops'] / 1e9:.2f} G operations, bound {t['bound_ms']:.4f} ms "
              f"({t['bound_by']}), {t['share']:.1%} of it cold; {t['instance']}: {t['registers']} registers, "
              f"{t['spill']}, {t['sass_instructions']} static SASS instructions, {t['smem_bytes']} B dynamic shared a "
              f"block, {t['blocks_per_sm']} blocks an SM, "
              f"y_ph by 16-byte copies {t['cp_async']}; host ahead {ahead_w and ahead_c and ahead_p}; "
              f"{smi}; clocks.sm, max, power, temp: {clocks()}")
        del y_ph, s, w, kernel
        torch.cuda.empty_cache()
    for i, (name, b, c, hh, wh, cl, dt) in enumerate(FUSED_EDGE):
        y_ph, s, w = septail_inputs(dev, b, c, hh, wh, cl, dt, 10 + i)
        err, agree = check_septail(name, y_ph, s, w)
        worst = max(worst, err)
        phase("fused", f"septail_step {name}: y_ph {tuple(y_ph.shape)} {str(dt)[6:]}, s stride {s.stride()}: "
              f"max_abs_err={err:.3e} argmax_agree={agree:.6f}")
    y_ph, s, w = septail_inputs(dev, 1, WIDE_CLASSES[-1] + 1, 2, 3, False, torch.float32, 20)
    before = septail_step.launches
    try:
        septail_step(y_ph, s, *w, EPS)
    except ValueError as e:
        phase("fused", f"C={WIDE_CLASSES[-1] + 1} on the card raises: {e}")
    else:
        raise AssertionError("septail_step took 129 classes on the card")
    if septail_step.launches != before:
        raise AssertionError("the refused call counted a launch")
    # the gradient through one kernel step (the plain version's backward at the saved inputs) against the
    # plain version's own, per leaf, of sum(m * y_ph'), at the bench step's shape at batch 1, f32
    y_ph, s, w = septail_inputs(dev, 1, N_CLASSES, H // 2, W // 2, False, torch.float32, 21)
    m = torch.randn(y_ph.shape, device=dev, generator=torch.Generator(dev).manual_seed(22))
    grads = []
    for step in (septail_step, septail_step_reference):
        leaves = [t.clone().requires_grad_(True) for t in (y_ph, s, *w)]
        (m * step(*leaves, EPS)).sum().backward()
        grads.append([t.grad for t in leaves])
    rel = [((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item() for a, b in zip(*grads)]
    phase("fused", "gradient of sum(m * y_ph') through one kernel step against the plain version's, per leaf "
          f"(y_ph, s, w_up, w_si, mix, bias), of its largest: {', '.join(f'{r:.2e}' for r in rel)} (limit "
          f"{FUSED_GRAD_TOL})")
    if not max(rel) <= FUSED_GRAD_TOL or min(g.abs().max().item() for g in grads[1]) == 0:
        raise AssertionError(f"fused: the kernel step's gradient {rel}")
    del fcn, dae
    torch.cuda.empty_cache()
    return worst, report


def run_fused_engine_checks(dev, smi):
    """The engine against the general engine with the 'sep' tail on the
    card in f32; make_fused_refiner card against CPU; one bench forward
    (bf16 carry, batch 128) under torch.profiler: its device time, idle
    share and septail_step's share. Not counted. Returns the profile."""
    # the engine against the general engine with the 'sep' tail, both on the card, f32, TF32 off
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    args = bench_tool.parse_args(FUSED_ARGV)
    fcn, dae = bench_tool.init_params(args, dev)
    dae_p = perturbed_sep_tail({k: dict(v) for k, v in dae.items()}, 3)
    x = torch.randn((FUSED_CHECK_BATCH, H, W, 3), generator=torch.Generator().manual_seed(4)).to(dev)
    with torch.inference_mode():
        y0, h = fcn8_apply(fcn, x, return_features=("pool4",))
        core_fn = lambda yp: dae_core(dae_p, yp, h, depth=3, stem_pool=1)  # noqa: E731
        got = fused_engine.fused_refinement_scan(dae_p, core_fn, y0, eps=EPS, num_steps=K_STEPS)
        want = logits_refinement_scan(lambda y: dae_logits(dae_p, y, h, depth=3), y0, eps=EPS, num_steps=K_STEPS)
    torch.cuda.synchronize()
    d = (got - want).abs().max().item()
    agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    moved = (want - y0).abs().max().item()
    phase("fused", f"fused_refinement_scan against the general engine ('sep' tail), card, f32, batch "
          f"{FUSED_CHECK_BATCH} at {H}x{W}, K={K_STEPS}: max|dy_K|={d:.3e} argmax agree={agree:.6f} (limits "
          f"{PARITY_TOL}, {PARITY_MIN_ARGMAX_AGREE}); the steps moved y by {moved:.3e}")
    if not (d <= PARITY_TOL and agree >= PARITY_MIN_ARGMAX_AGREE and moved > 1e-3):
        raise AssertionError("fused: the engine against the general engine beyond its limits")
    # make_fused_refiner on one image, card against CPU, f32
    img = x[:1]
    to_cpu = lambda p: {k: {kk: t.cpu() for kk, t in v.items()} for k, v in p.items()}  # noqa: E731
    y0_g, yk_g = fused_engine.make_fused_refiner(fcn8_apply, fcn, dae_p, eps=EPS, num_steps=K_STEPS)(img)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    y0_c, yk_c = fused_engine.make_fused_refiner(fcn8_apply, to_cpu(fcn), to_cpu(dae_p), eps=EPS,
                                                 num_steps=K_STEPS)(img.cpu())
    cpu_s = time.perf_counter() - t0
    d0, dk = (y0_g.cpu() - y0_c).abs().max().item(), (yk_g.cpu() - yk_c).abs().max().item()
    agree = (yk_g.cpu().argmax(-1) == yk_c.argmax(-1)).float().mean().item()
    phase("fused", f"make_fused_refiner, 1 image, f32, card vs CPU: max|dy0|={d0:.3e} max|dy_K|={dk:.3e} argmax "
          f"agree={agree:.6f} (CPU run {cpu_s:.1f} s)")
    if not (d0 <= PARITY_TOL and dk <= PARITY_TOL and agree >= PARITY_MIN_ARGMAX_AGREE):
        raise AssertionError("fused: make_fused_refiner card vs CPU beyond tolerance")
    del x, y0, h, got, want, y0_g, yk_g
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    # one bench forward as the twin runs it (bf16 carry, batch 128, its synthetic images) under the profiler
    pipeline = bench_tool.build_pipeline(args)
    ((images, _),) = synthetic_batches(cfg=CAMVID, batch_size=args.batch, num_batches=1, height=H, width=W, seed=0)
    xb = torch.from_numpy(images).to(dev)
    prof = profile_tool.profile(lambda xx: pipeline(fcn, dae, xx), xb, iters=FUSED_PROFILE_ITERS,
                                tail="septail_")  # either form: septail_tile_kernel, septail_step_kernel
    step_ms = sum(ms for _, ms, _ in prof["tail"])
    step_share = sum(share for _, _, share in prof["tail"])
    phase("fused", f"bench forward --engine fused --dae-tail sep, batch {args.batch}, under torch.profiler "
          f"({FUSED_PROFILE_ITERS} forwards): {prof['event_ms']:.3f} ms a forward by CUDA events, device time "
          f"{prof['device_ms']:.3f} ms ({prof['idle']:.1%} idle), {prof['ops']:.0f} device operations; "
          f"septail_step {step_ms:.3f} ms a forward ({step_share:.1%} of device time); {smi}")
    for name, ms, share in prof["top"]:
        phase("fused", f"   {ms:9.4f} ms {share:6.1%}  {name[:110]}")
    if step_ms <= 0:
        raise AssertionError("fused: the profiled forward traced no septail_step kernel")
    del fcn, dae, dae_p, xb
    torch.cuda.empty_cache()
    return prof


def run_fused_main_path(smi):
    """As a user runs them: the bench twin's fused engine at batch 128, bf16
    and f32 carry (septail_step K a forward, refine_tail none), then the
    fused_bench twin's four variants. Returns images/s by engine."""
    readings = {}
    forwards = BENCH_WARMUP + 3 * BENCH_ITERS
    for carry in FUSED_CARRIES:
        before = septail_step.launches, refine_tail.launches
        lines, secs = run_cli(bench_tool.main, ["--no-history", "--iters", BENCH_ITERS, *FUSED_ARGV, *carry])
        rec = json.loads(lines[-1])
        got = septail_step.launches - before[0], refine_tail.launches - before[1]
        if got != (K_STEPS * forwards, 0) or rec["device"] != smi or not rec["value"] > 0:
            raise AssertionError(f"fused bench {carry}: {lines[-1]}; septail_step, refine_tail launched {got}")
        readings["bench fused " + (carry[-1] if carry else "bf16")] = rec["value"]
        phase("fused", f"bench twin {' '.join(FUSED_ARGV + list(carry))}: {lines[-1]} (septail_step {got[0]} = "
              f"{K_STEPS} x {forwards} forwards; {secs:.1f} s wall)")
    before = septail_step.launches, refine_tail.launches
    lines, secs = run_cli(fused_tool.main, ["--iters", FUSED_BENCH_ITERS])
    forwards = 1 + 3 * FUSED_BENCH_ITERS
    got = septail_step.launches - before[0], refine_tail.launches - before[1]
    if got != (2 * K_STEPS * forwards, 2 * K_STEPS * forwards) or lines[0] != f"device: {smi}" or len(lines) != 5:
        raise AssertionError(f"fused_bench: {lines}; septail_step, refine_tail launched {got}")
    for line in lines[1:]:
        readings[line.split(" (K=")[0]] = float(line.split("->")[1].split()[0])
        phase("fused", f"fused_bench twin, batch 128: {line}")
    phase("fused", f"fused_bench twin: septail_step {got[0]}, refine_tail {got[1]} = 2 x {K_STEPS} x {forwards} "
          f"forwards each; {secs:.1f} s wall; {smi}")
    return readings


def run_fused_phase(dev, smi):
    """Phase 31: the kernel against its plain version and the engine's
    checks (not counted), then the main path with the counts set to 0 just
    before it and read just after; septail_step must have launched."""
    t_phase = time.perf_counter()
    worst, report = run_fused_kernel_checks(dev, smi)
    run_fused_engine_checks(dev, smi)
    reset_counts()
    septail_step.launches = 0
    readings = run_fused_main_path(smi)
    launches, tail_launches = septail_step.launches, refine_tail.launches
    if launches == 0:
        raise AssertionError("fused: septail_step never launched on the main path")
    phase("fused", "batch 128 images/s: " + ", ".join(f"{k} {v:.1f}" for k, v in readings.items())
          + f"; septail_step launches {launches}; phase 31 in {time.perf_counter() - t_phase:.1f} s; {smi}")
    return worst, report, launches, tail_launches


PROBE_ITERS = 2  # a chained block of 2 calls after one warm-up call, one block (the twins' defaults: 8-20, 1-3)
PROBE_CALLS = 1 + PROBE_ITERS  # calls of each timed row
PROBE_BATCHES = (4, 8, 16, 32, 128)  # perf_probe: the JAX defaults, then the bench's batches
PROBE_RUNS = (  # (module, argv, refine_tail launches a call of its rows, septail_step launches a call,
    #               refine_tail launches once a run, outside the timed rows)
    (perf_probe, ["--batches", *PROBE_BATCHES], 2 * K_STEPS * len(PROBE_BATCHES), 0, 0),  # the scan and the pipeline
    (pipeline_probe, [], 1 + K_STEPS + 2, 0, 0),  # K = 1, K = 5, the two K3 tail rows
    (fcn_block_probe, [], 0, 0, 0),
    (fwd_shape_probe, [], 0, 0, 0),
    (half_probe, [], len(half_probe.CONFIGS) * (K_STEPS + 1), 0, 0),  # each configuration's pipeline
    (core_probe, [], 0, 0, 0),
    (tail_ops_probe, [], 0, 0, 0),
    (dae_op_probe, [], 0, 0, 0),
    (pool_probe, [], 0, 0, 0),
    (fused_probe, [], 0, 1, 0),  # the S1 row
    (train_itemize_probe, [], 0, 0, 0),
    (tailfold_probe, [], 1, 0, 1),  # the port's folded step; once: its f32 check against v2
    (tail2_probe, [], 0, 0, 0),
    # the four K = 5 pipelines, a graph replay counted as the launches it captured; once: each captured
    # row's replay and uncaptured loop held to each other
    (scan_variants_probe, [], 4 * K_STEPS, 0, 2 * 2 * K_STEPS),
    (int8_probe, [], 0, 0, 0),
    (aug_probe, [], 0, 0, 0),
    (aug_order_probe, [], 0, 0, 0),
    (aug_step_probe, [], 0, 0, 0),
)
LATER_PROBES = (tailfold_probe, tail2_probe, scan_variants_probe, int8_probe, aug_probe, aug_order_probe,
                aug_step_probe)  # the seven twins added last: phase 32 prints their added wall time
PROBE_PROFILE_BATCHES = (128, 32)  # the flagship forward traced at the bench's default and at 32
PROBE_PROFILE_ITERS = 2
FC6_WEIGHT = (4096, 512, 7, 7)  # OIHW: the convolutions the trace attributes to fc6
PROBE_LAYERS = {  # the layers the traces attribute device time to, by their OIHW weight (C = 11)
    "fc6": FC6_WEIGHT, "fc7": (4096, 4096, 1, 1), "conv1_1": (64, 3, 3, 3), "conv1_2": (64, 64, 3, 3),
    "DAE enc1": (32, 11, 3, 3), "folded score_enc1' + score_input (half res)": (11, 43, 3, 3),
    "score_input (full res)": (11, 11, 3, 3),
}
# K3's all-bf16 row against its op-by-op row (the JAX row's formula):
# besides the kernel's one rounding, the row rounds three times and blends by
# bf16(1 - bf16(0.1)) = 0.8984375 where the kernel takes 1 - 0.10009765625
# (the row's two weights sum to 0.9985): at most 0.0015 + 3 half-ulps on
# [0.5, 1), under two bf16 ulps there. That 0.15% shift of y against r
# reorders classes the row rounds to near-equal values: the argmax differs on
# 0.11% of the batch-128 map, each time at a near-tie of the row (NVIDIA H100
# 80GB HBM3, 700.00 W), so that comparison holds the near-ties alone; the
# kernel against its plain version keeps MIN_ARGMAX_AGREE.
PROBE_OPS_BF16_TOL = 2.0**-7


def probe_name(module) -> str:
    return module.__name__.rsplit(".", 1)[1]


def check_probe_lines(name: str, lines: list[str], smi: str) -> list[dict]:
    """A twin's JSON lines: each its probe's and stamped with the card; a
    timed row's ms finite and positive, ms_per_img its share an image, its
    value finite; a derived row's ms finite; a check within its limit (one
    that only reports, ``"asserted": false``, finite)."""
    recs = [json.loads(ln) for ln in lines]
    if not recs:
        raise AssertionError(f"probes: {name} printed nothing")
    for rec in recs:
        bad = rec.get("probe") != name or rec.get("device") != smi
        if rec.get("check"):
            bad |= not (rec["max_abs_err"] <= rec["limit"] if rec.get("asserted", True)
                        else np.isfinite(rec["max_abs_err"]))
        elif rec.get("derived"):
            bad |= not np.isfinite(rec["ms"])
        else:
            bad |= not (np.isfinite(rec["ms"]) and rec["ms"] > 0 and np.isfinite(rec["value"])
                        and abs(rec["ms_per_img"] * rec["batch"] - rec["ms"]) <= 1e-9 * rec["ms"])
        if bad:
            raise AssertionError(f"probes: {name} line {rec}")
    return recs


def hold_probe_row(name, got, want, tol, class_dim=-1, min_agree=MIN_ARGMAX_AGREE) -> tuple[float, float]:
    """A kernel row's map against the map of the row it is held to: max abs
    err within ``tol``; the class argmax the other's but at near-ties (the
    other's value at this argmax within ``tol`` of its maximum), agreeing on
    >= ``min_agree`` (None: no floor) of a map of 10^5 pixels or more, as
    phase 31 holds S1. Returns (max abs err, argmax agreement)."""
    got, want = got.float(), want.float()
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    arg = got.argmax(class_dim, keepdim=True)
    agree = (arg == want.argmax(class_dim, keepdim=True)).float().mean().item()
    ties_only = bool((want.gather(class_dim, arg) >= want.amax(class_dim, keepdim=True) - tol).all())
    phase("probes", f"{name}: max_abs_err={err:.3e} argmax_agree={agree:.6f} (limits {tol:.1e}, {min_agree}), "
          f"differing only at near-ties {ties_only}")
    if not (err <= tol and ties_only and (min_agree is None or arg.numel() < 10**5 or agree >= min_agree)):
        raise AssertionError(f"probes: {name} beyond its limits")
    return err, agree


def probe_kernel_checks(dev) -> dict:
    """The probes' kernel rows at their full-width shapes (batch 128), each
    held to its plain version on the same inputs (f32 1e-5, bf16 2^-8) and
    to its op-by-op row: the K3 rows' logits are bf16 in both (the f32 row
    2^-8, argmax >= 99.9%; the all-bf16 one PROBE_OPS_BF16_TOL, its argmax
    differing at near-ties alone); S1's op-by-op row is its
    plain version's formula (2^-8; the phase mean and transpose after it
    are the same ops on both). Not counted. Returns the worst error against
    the plain versions by kernel."""
    worst = {"refine_tail": 0.0, "septail_step": 0.0}
    b, c = pipeline_probe.parse_args([]).batch, N_CLASSES
    cd = torch.bfloat16
    dae = init_dae(torch.Generator().manual_seed(1), n_classes=c, h_specs={"pool4": DAE_H_CHANNELS["pool4"]}, depth=3,
                   stem_pool=1, device=dev)
    gen = torch.Generator(dev).manual_seed(40)
    y = torch.softmax(torch.randn((b, H, W, c), device=dev, generator=gen) * 2, -1)
    s_half = torch.randn((b, H // 2, W // 2, c), device=dev, generator=gen).to(cd)
    with torch.inference_mode():
        for yy, all_bf16 in ((y, False), (y.to(cd), True)):
            (ops_label, ops), (k_label, kernel) = pipeline_probe.tail_maps(dae, yy, s_half, compute_dtype=cd,
                                                                            all_bf16=all_bf16)
            got = kernel()
            u, v, eps = pipeline_probe.tail_terms(dae, yy, s_half, compute_dtype=cd, all_bf16=all_bf16)
            plain = refine_tail_reference(u, yy, eps, v=v)
            tol = F32_TOL if yy.dtype == torch.float32 else BF16_TOL
            err, _ = hold_probe_row(f"pipeline_probe '{k_label}' {tuple(yy.shape)} against its plain version", got,
                                    plain, tol)
            worst["refine_tail"] = max(worst["refine_tail"], err)
            hold_probe_row(f"pipeline_probe '{k_label}' {tuple(yy.shape)} against {ops_label}", got, ops(),
                           *((PROBE_OPS_BF16_TOL, -1, None) if all_bf16 else (BF16_TOL,)))
            del got, plain, u, v
        del y, s_half
        torch.cuda.empty_cache()
        sep = perturbed_sep_tail(init_dae(torch.Generator().manual_seed(0), n_classes=c, h_specs={"pool4": 512},
                                          depth=3, stem_pool=1, tail="sep", device=dev), 41)
        tail = {k: {kk: t.to(cd) for kk, t in sep[k].items()} for k in fused_probe.TAIL_LAYERS}
        y_ph = torch.softmax(torch.randn((b, 2, 2, c, H // 2, W // 2), device=dev, generator=gen) * 2, 3).to(cd)
        s_cl = torch.randn((b, c, H // 2, W // 2), device=dev, generator=gen).to(cd)
        (ops_label, ops), (k_label, kernel) = fused_probe.phase_step_maps(tail, y_ph, s_cl)
        got = kernel()
        weights = [t.to(cd) for t in fused_engine.septail_weights(tail)]
        plain = septail_step_reference(y_ph, s_cl.permute(0, 2, 3, 1), *weights, bf16(0.1))
        worst["septail_step"], _ = hold_probe_row(
            f"fused_probe '{k_label}' y_ph {tuple(y_ph.shape)} against its plain version", got[0], plain, BF16_TOL,
            class_dim=3)
        hold_probe_row(f"fused_probe '{k_label}' y_ph' against {ops_label}", got[0], ops()[0], BF16_TOL, class_dim=3)
    del dae, sep, y_ph, s_cl, got, plain
    torch.cuda.empty_cache()
    worst["refine_tail"] = max(worst["refine_tail"], later_probe_kernel_checks(dev, b, c))
    return worst


def later_probe_kernel_checks(dev, b: int, c: int) -> float:
    """K3 in the later twins' rows at batch ``b``, held as
    ``probe_kernel_checks`` holds the others; not counted. scan_variants_
    probe's pipeline step at each carry (the DAE's bf16 logits at the
    carry's dtype): against its plain version, and against the JAX row's
    formula ``y - eps (y - softmax(u))`` at the carry's dtype (f32 1e-5;
    bf16 PROBE_OPS_BF16_TOL, its argmax differing at near-ties alone).
    tailfold_probe's port step (bf16, 180x240): against its plain version
    and against the op-by-op v2 row. Returns the worst error against the
    plain versions."""
    worst = 0.0
    gen = torch.Generator(dev).manual_seed(43)
    y0 = torch.softmax(torch.randn((b, H, W, c), device=dev, generator=gen) * 2, -1)
    logits = torch.randn((b, H, W, c), device=dev, generator=gen).to(torch.bfloat16)
    with torch.inference_mode():
        for carry, eps in ((torch.float32, scan_variants_probe.EPS), (torch.bfloat16, bf16(scan_variants_probe.EPS))):
            y, u = y0.to(carry), logits.to(carry)
            got = refine_tail(u, y, eps)
            err, _ = hold_probe_row(f"scan_variants_probe pipeline step, {carry} carry, {tuple(y.shape)}, against its "
                                    "plain version", got, refine_tail_reference(u, y, eps),
                                    F32_TOL if carry == torch.float32 else BF16_TOL)
            worst = max(worst, err)
            hold_probe_row(f"scan_variants_probe pipeline step, {carry} carry, against the JAX row's formula", got,
                           y - eps * (y - torch.softmax(u, -1)),
                           *((F32_TOL,) if carry == torch.float32 else (PROBE_OPS_BF16_TOL, -1, None)))
            del y, u, got
        del y0, logits
        torch.cuda.empty_cache()
        dae = tailfold_probe.probe_dae(dev, torch.bfloat16)
        fk = fused_engine.fold_half_tail(dae)
        x = torch.softmax(torch.randn((b, H // 2, W // 2, c), device=dev, generator=gen), -1).to(torch.bfloat16)
        hb = torch.randn((b, *tailfold_probe.bottleneck_hw(H // 2, W // 2), int(dae["bottleneck"]["w"].shape[0])),
                         device=dev, generator=gen).to(torch.bfloat16)
        u, v, bb = tailfold_probe.port_step_terms(dae, fk, x, hb)
        got = tailfold_probe.step_port(dae, fk, x, hb)
        err, _ = hold_probe_row(f"tailfold_probe '{tailfold_probe.PORT_LABEL}' {tuple(x.shape)} against its plain "
                                "version", got, refine_tail_reference(u, x, tailfold_probe.EPS, v=v, b=bb), BF16_TOL)
        worst = max(worst, err)
        hold_probe_row(f"tailfold_probe '{tailfold_probe.PORT_LABEL}' against the op-by-op v2 step", got,
                       tailfold_probe.step_v2(dae, fk, x, hb), PROBE_OPS_BF16_TOL, -1, None)
    del dae, x, hb, u, v, got
    torch.cuda.empty_cache()
    return worst


def fresh_conv_traces() -> float:
    """``probe_conv_traces`` in a fresh process; returns its wall seconds.
    In this process, after the earlier phases, the profiler returned no
    device event at all for these short traces (the same traces in a fresh
    process, before or after the flagship's, keep them all)."""
    t0 = time.perf_counter()
    code = "import torch, chip_smoke; chip_smoke.probe_conv_traces(torch.device('cuda', 0))"
    out = subprocess.run([sys.executable, "-c", code], cwd=pathlib.Path(__file__).resolve().parent,
                         capture_output=True, text=True, timeout=900)
    sys.stdout.write(out.stdout)
    sys.stdout.flush()
    if out.returncode != 0:
        raise AssertionError(f"probes: the conv traces failed: {out.stderr[-3000:]}")
    return time.perf_counter() - t0


def probe_conv_traces(dev) -> dict:
    """Which device kernels the 11-channel convolutions run: tail2_probe's
    three 3x3 C x C conv rows (NHWC -> NHWC, NHWC -> NCHW, NCHW -> NCHW) at
    batch 128, 360x480, and tailfold_probe's v1 and v2 steps at 180x240,
    bf16, each under torch.profiler (``profile_general.profile``,
    ``PROBE_PROFILE_ITERS`` calls); prints each one's top three device
    kernels. Not counted. Returns {row: top three (name, ms, share)}."""
    b, c, cd = pipeline_probe.parse_args([]).batch, N_CLASSES, torch.bfloat16
    gen = torch.Generator(dev).manual_seed(44)
    y = torch.softmax(torch.randn((b, H, W, c), device=dev, generator=gen), -1).to(cd)
    w_si = (0.1 * torch.randn((c, c, 3, 3), device=dev, generator=gen)).to(cd)
    b_si = torch.zeros((c,), device=dev, dtype=cd)
    dae = tailfold_probe.probe_dae(dev, cd)
    fk = fused_engine.fold_half_tail(dae)
    x = torch.softmax(torch.randn((b, H // 2, W // 2, c), device=dev, generator=gen), -1).to(cd)
    hb = torch.randn((b, *tailfold_probe.bottleneck_hw(H // 2, W // 2), int(dae["bottleneck"]["w"].shape[0])),
                     device=dev, generator=gen).to(cd)
    steps = dict(tailfold_probe.STEPS)
    convs = tail2_probe.conv_cases(y, y.permute(0, 3, 1, 2).contiguous(), w_si, b_si)
    rows = [(f"tail2_probe '{label}'", fn) for label, fn in convs]
    rows += [(f"tailfold_probe step {v}", lambda v=v: (steps[v](dae, fk, x, hb),)) for v in ("v1", "v2")]
    out = {}
    with torch.inference_mode():
        for label, fn in rows:
            prof = profile_tool.profile(lambda _, fn=fn: fn(), None, iters=PROBE_PROFILE_ITERS)
            out[label] = prof["top"][:3]
            phase("probes", f"{label}: {prof['event_ms']:.3f} ms a call by CUDA events, {prof['device_ms']:.3f} ms of "
                  "device time; top kernels: " + "; ".join(f"{name[:100]} {ms:.3f} ms ({share:.1%})"
                                                          for name, ms, share in out[label]))
    del y, dae, x, hb
    torch.cuda.empty_cache()
    return out


def probe_profiles(dev, smi) -> dict:
    """The flagship forward as the bench twin runs it (half engine, bf16,
    K = 5) at each of ``PROBE_PROFILE_BATCHES`` under torch.profiler: CUDA
    event ms, device time, idle share, the top operations and fc6's
    convolutions' share (``profile_general.profile``). Not counted."""
    out = {}
    for b in PROBE_PROFILE_BATCHES:
        args = bench_tool.parse_args(["--batch", str(b)])
        fcn, dae = bench_tool.init_params(args, dev)
        pipeline = bench_tool.build_pipeline(args)
        ((images, _),) = synthetic_batches(cfg=CAMVID, batch_size=b, num_batches=1, height=H, width=W, seed=0)
        x = torch.from_numpy(images).to(dev)
        prof = profile_tool.profile(lambda xx: pipeline(fcn, dae, xx), x, iters=PROBE_PROFILE_ITERS,
                                    weights=tuple(PROBE_LAYERS.values()))
        fc6_ms, fc6_share = prof["by_weight"][FC6_WEIGHT]
        phase("probes", f"flagship forward (bench twin, half engine, bf16, K={K_STEPS}), batch {b}, under "
              f"torch.profiler ({PROBE_PROFILE_ITERS} forwards): {prof['event_ms']:.3f} ms a forward by CUDA events, "
              f"device time {prof['device_ms']:.3f} ms summed, {prof['busy_ms']:.3f} ms busy ({prof['idle']:.1%} "
              f"idle), {prof['ops']:.0f} device operations; fc6 {fc6_ms:.3f} ms ({fc6_share:.1%} of device time); "
              f"{smi}")
        for name, ms, share in prof["top"]:
            phase("probes", f"   {ms:9.4f} ms {share:6.1%}  {name[:110]}")
        layers = [(layer, *prof["by_weight"][w]) for layer, w in PROBE_LAYERS.items()]
        phase("probes", "   by layer: " + ", ".join(f"{layer} {ms:.3f} ms ({share:.1%})" for layer, ms, share in layers))
        if not fc6_ms > 0:
            raise AssertionError(f"probes: the batch-{b} trace attributed no device time to fc6")
        out[b] = prof
        del fcn, dae, x
        torch.cuda.empty_cache()
    return out


def probe_main_path(smi) -> tuple[dict, int, int, dict]:
    """Each twin's main as a user runs it, short (``--iters 2 --repeats
    1``): its lines checked (``check_probe_lines``), its wall time, and
    refine_tail and septail_step launched as its rows imply. Returns (lines
    by probe, K3 launches, S1 launches, wall seconds by probe)."""
    recs, k3, s1, walls = {}, 0, 0, {}
    for module, argv, k3_call, s1_call, k3_once in PROBE_RUNS:
        name = probe_name(module)
        before = refine_tail.launches, septail_step.launches
        lines, secs = run_cli(module.main, [*argv, "--iters", PROBE_ITERS, "--repeats", 1])
        walls[name] = secs
        got = refine_tail.launches - before[0], septail_step.launches - before[1]
        want = k3_call * PROBE_CALLS + k3_once, s1_call * PROBE_CALLS
        if got != want:
            raise AssertionError(f"probes: {name} launched refine_tail, septail_step {got}; expected {want}")
        check_no_strided(f"probes {name}")
        recs[name] = check_probe_lines(name, lines, smi)
        k3, s1 = k3 + got[0], s1 + got[1]
        phase("probes", f"{name} {' '.join(str(a) for a in argv)}: {len(lines)} lines in {secs:.1f} s wall; "
              f"refine_tail {got[0]}, septail_step {got[1]}")
        for rec in recs[name]:
            phase("probes", f"   {json.dumps(rec)}")
        torch.cuda.empty_cache()
    return recs, k3, s1, walls


def run_probes_phase(dev, smi, bench_readings) -> dict:
    """Phase 32: the probes' kernel rows held to their plain versions and
    op-by-op rows, the flagship's profiles at batch 128 and 32 (neither
    counted), then the twins as a user runs them with the counts set to 0
    just before and read just after; the readings beside the bench twin's
    and fc6 alone at batch 32."""
    t_phase = time.perf_counter()
    worst = probe_kernel_checks(dev)
    profiles = probe_profiles(dev, smi)
    t_traces = fresh_conv_traces()
    reset_counts()
    septail_step.launches = 0
    recs, k3, s1, walls = probe_main_path(smi)
    if refine_tail.launches != k3 or septail_step.launches != s1 or not (k3 and s1):
        raise AssertionError(f"probes: refine_tail {refine_tail.launches}, septail_step {septail_step.launches}")
    by_label = {(name, r["label"]): r for name, rs in recs.items() for r in rs}
    flag = by_label[("half_probe", "flagship d3 (32,64,128): FULL pipeline K=5")]["ms"]
    bench_ms = 128e3 / bench_readings["b128"]
    phase("probes", f"half_probe flagship FULL pipeline K=5 (unfolded) {flag:.2f} ms against the bench twin's batch "
          f"128 (folded) {bench_ms:.2f} ms: {flag / bench_ms:.3f}x")
    loops = {v: by_label[("tailfold_probe", f"K=5 scan {v}")]["ms"] for v in ("v0", "v1", "v2")}
    phase("probes", "tailfold_probe K = 5 loops of the pooled step alone at batch 128: " + ", ".join(
        f"{v} {ms:.2f} ms" for v, ms in loops.items()) + f"; v1 / v2 {loops['v1'] / loops['v2']:.3f}; beside the bench "
          f"twin's folded forward (FCN, five v2 steps, the rectification) {bench_ms:.2f} ms")
    later = sum(walls[probe_name(m)] for m in LATER_PROBES)
    phase("probes", f"the seven twins added last ({', '.join(probe_name(m) for m in LATER_PROBES)}): their mains "
          f"{later:.1f} s, the conv traces {t_traces:.1f} s")
    fcn, _ = flagship_params(dev)
    w6, b6 = fcn["fc6"]["w"].to(torch.bfloat16), fcn["fc6"]["b"].to(torch.bfloat16)
    b = fcn_block_probe.B
    x5 = torch.randn((b, 12, 15, 512), device=dev, dtype=torch.bfloat16)
    with torch.inference_mode():
        fc6_ms = cuda_ms(lambda: conv2d(x5, w6, b6), iters=10)
    delta = by_label[("fcn_block_probe", "delta fc6+fc7")]["ms"]
    phase("probes", f"fcn_block_probe delta fc6+fc7 at batch {b} {delta:.2f} ms against fc6 alone (7x7 conv 512 -> "
          f"4096 on the 12x15 pool5 map, bf16) {fc6_ms:.2f} ms and the trace's fc6 at batch 32 "
          f"{profiles[32]['by_weight'][FC6_WEIGHT][0]:.2f} ms")
    del fcn, x5
    torch.cuda.empty_cache()
    phase("probes", f"refine_tail launches {k3}, septail_step {s1}; phase 32 in {time.perf_counter() - t_phase:.1f} s; "
          f"{smi}")
    return {"worst": worst, "refine_tail": k3, "septail_step": s1}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = nvidia_smi()
    phase("device", f"{kind} capability {cap} torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi, flush=True)
    if cap != (9, 0):
        raise AssertionError(f"the kernels are built for sm_90a; this card is {cap}")

    # one nvcc per source and g++ for the native input runtime, all started together
    t0 = time.perf_counter()
    sources = ("refine_tail", "corruption", "vpu_probe", "septail_step")
    with ThreadPoolExecutor(len(sources) + 1) as pool:
        host = pool.submit(_build.build_host, native_loader.NATIVE_SRC, "input_runtime")
        libs = dict(zip(sources, pool.map(_build.build, sources)))
        host_lib = host.result()
    for src, lib in libs.items():
        _build.load(src)
        phase("build", f"nvcc sm_90a {lib.name}; ptxas: {ptxas_summary(lib.with_suffix('.log'))}")
    phase("build", f"g++ {host_lib.name} (native/input_runtime.cc, {' '.join(_build.HOST_FLAGS)})")
    phase("build", f"{len(libs)} kernels and the input runtime built in {time.perf_counter() - t0:.1f} s")

    fcn, dae = flagship_params(dev)
    worst, kreport = run_kernel_phase(dev, fcn, dae, general_params(dev))
    launches = run_serve_phase(dev, fcn, dae)
    run_parity_phase(fcn, dae)
    timing_ips = run_timing_phase(dev, fcn, dae, smi)

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

    fcn_workdir = _build.BUILD_DIR / "chip_smoke_fcn"
    shutil.rmtree(fcn_workdir, ignore_errors=True)
    run_fcn_phase(dev, smi, fcn_workdir)
    shutil.rmtree(fcn_workdir)
    run_fcn_parity(dev)
    demo_launches, k1, k2 = run_demo_phase(dev)
    launches += demo_launches
    train_launches["corrupt_onehot"] += k1
    train_launches["corrupt_probs"] += k2
    arch_launches, _ = run_arch_phase(dev, fcn, smi)
    launches += arch_launches

    data_root = _build.BUILD_DIR / "chip_smoke_data"
    shutil.rmtree(data_root, ignore_errors=True)
    data_root.mkdir(parents=True)
    data_launches, k1 = run_data_phase(dev, fcn, smi, data_root)
    launches += data_launches
    train_launches["corrupt_onehot"] += k1
    em_launches, k1, k2, _ = run_em_phase(dev, smi, data_root)
    launches += em_launches
    train_launches["corrupt_onehot"] += k1
    train_launches["corrupt_probs"] += k2
    launches += run_utils_phase(dev, fcn, data_root)
    shutil.rmtree(data_root)

    par = run_parallel_phases(smi)
    launches += par["refine_tail"]
    train_launches["corrupt_onehot"] += par["corrupt_onehot"]
    train_launches["corrupt_probs"] += par["corrupt_probs"]

    bench_launches, bench_readings, bench_err = run_bench_phase(dev, smi, timing_ips)
    launches += bench_launches
    worst = max(worst, bench_err)
    launches += run_sbench_phase(dev, fcn, dae, smi)
    train_launches["corrupt_onehot"] += run_tbench_phase(dev, smi)
    launches += run_entry_phase(dev)
    space = run_space_phase(smi)
    launches += space["refine_tail"]
    train_launches["corrupt_onehot"] += space["corrupt_onehot"]
    septail_err, septail_report, septail_launches, fused_tail_launches = run_fused_phase(dev, smi)
    launches += fused_tail_launches
    probes = run_probes_phase(dev, smi, bench_readings)
    launches += probes["refine_tail"]
    septail_launches += probes["septail_step"]
    worst = max(worst, probes["worst"]["refine_tail"])
    septail_err = max(septail_err, probes["worst"]["septail_step"])

    # No single PyTorch call computes any of the five functions, so each
    # library_ms is null. K3's entry is the half engine's step (bf16, the
    # K-a-chunk launch), timed cold, as are K1/K2's (the training crop) and
    # K4/K5's (the probe's shapes).
    step = kreport["step_bf16"]
    kernels = [{
        "name": "refine_tail", "route": "cuda",
        "source": "iterative_inference_segm_tpu_torch/csrc/refine_tail.cu",
        "replaces": "tools/tail_kernel_proto.py:41",
        "launches": launches, "max_abs_err": worst,
        "ms": step["cold_ms"], "plain_ms": step["plain_ms"],
        "bound_ms": step["bound_ms"], "bound_by": step["bound_by"], "library_ms": None,
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
            "bound_ms": main_path["bound_ms"], "bound_by": main_path["bound_by"], "library_ms": None,
        })
    # K4 at f32, n = 100 and K5 at f32, on the device alone, cold
    for kname, line, key in (("fma_chain", 30, ("fma", torch.float32, 100)),
                             ("pattern_softmax", 73, ("pattern", torch.float32))):
        t = probe_res[key]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "iterative_inference_segm_tpu_torch/csrc/vpu_probe.cu",
            "replaces": f"tools/vpu_probe.py:{line}",
            "launches": probe_launches[kname], "max_abs_err": probe_err[kname],
            "ms": t["cold_ms"], "plain_ms": t["plain_cold_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None,
        })
    # the phase-major engine's step: a hand-written kernel with no Pallas counterpart (it carries an XLA
    # fusion of the JAX engine); its entry is the bench step's, bf16 carry, cold
    t = septail_report["bf16"]
    kernels.append({
        "name": "septail_step", "route": "cuda",
        "source": "iterative_inference_segm_tpu_torch/csrc/septail_step.cu",
        "replaces": "iterative_inference_segm_tpu/inference/fused.py:98",
        "launches": septail_launches, "max_abs_err": septail_err,
        "ms": t["cold_ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None,
    })
    phase("done", f"phases 1-32 in {time.perf_counter() - t_start:.1f} s wall, the build included")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
