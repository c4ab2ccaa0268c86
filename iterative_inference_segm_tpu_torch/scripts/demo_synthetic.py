"""End-to-end demonstration on synthetic data: FCN-8 -> DAE -> refinement
(PyTorch port).

The twin of the JAX package's ``scripts/demo_synthetic.py``, with the same
flags, defaults, validity checks and ``--json`` line, plus ``--device``.
It trains a small FCN-8 on the synthetic structured scenes, trains a score
network against the frozen FCN, runs the (eps, K) search on val through the
engine it serves with, and reports test mIoU at k=0 (the FCN) and at the
chosen K. The synthetic data is the JAX package's, seed for seed; the
trained weights are not (init, dropout and crops come from a
``torch.Generator``).

Examples:
    python -m iterative_inference_segm_tpu_torch.scripts.demo_synthetic --json
    python -m iterative_inference_segm_tpu_torch.scripts.demo_synthetic --engine half \\
        --dae-stem-pool 1 --dae-depth 3 --bf16 --json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--epochs-fcn", type=int, default=3)
    p.add_argument("--epochs-dae", type=int, default=16)
    p.add_argument("--height", type=int, default=96)
    p.add_argument("--width", type=int, default=128)
    p.add_argument("--fc-channels", type=int, default=64)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--train-batches", type=int, default=16)
    p.add_argument("--sigma", type=float, default=0.0)
    p.add_argument("--corruption", choices=["natural", "gt", "mix"], default="natural",
                   help="DAE training corruption: frozen-FCN outputs, sigma-noised one-hot "
                        "ground truth, or a per-batch blend (--mix-prob)")
    p.add_argument("--mix-prob", type=float, default=0.5,
                   help="with --corruption mix: probability a batch uses the GT regime")
    p.add_argument("--arch", choices=["dae", "mirror", "contextmod"], default="dae",
                   help="score network (mirror and contextmod: general engine only; "
                        "contextmod conditions on the input image)")
    p.add_argument("--dae-tied", action="store_true", help="mirror arch: tie decoder kernels to the encoder")
    p.add_argument("--dae-stem-pool", type=int, default=0)
    p.add_argument("--dae-tail", choices=["full", "sep"], default="full")
    p.add_argument("--dae-depth", type=int, default=4)
    p.add_argument("--dae-widths", nargs="*", type=int, default=None)
    p.add_argument("--dae-encoder", choices=["pool", "stride"], default="pool")
    p.add_argument("--k-max", type=int, default=8)
    p.add_argument("--eps-grid", nargs="*", type=float, default=[0.05, 0.1, 0.2, 0.4, 0.7, 1.0])
    p.add_argument("--mode", choices=["score", "energy"], default="score")
    p.add_argument("--engine", choices=["general", "half"], default="general",
                   help="'half' = K pooled-map steps + one full-res rectification "
                        "(requires --dae-stem-pool 1)")
    p.add_argument("--bf16", action="store_true",
                   help="search AND eval refinement at bf16 compute/state")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json", action="store_true", help="print one JSON result line")
    p.add_argument("--device", default="cuda",
                   help="torch device ('cuda' needs a card; 'cpu' runs the kernels' plain versions)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    # fail invalid combinations before the training runs
    if args.engine == "half" and args.dae_stem_pool < 1:
        raise SystemExit("--engine half requires --dae-stem-pool >= 1 (2 = quarter engine)")
    if args.arch in ("contextmod", "mirror") and args.engine != "general":
        raise SystemExit(f"--arch {args.arch} runs on the general engine only")

    import numpy as np
    import torch

    from iterative_inference_segm_tpu_torch.data.config_datasets import CAMVID
    from iterative_inference_segm_tpu_torch.data.pipeline import normalize_image
    from iterative_inference_segm_tpu_torch.data.synthetic import synthetic_batches
    from iterative_inference_segm_tpu_torch.inference.fused import make_half_refiner
    from iterative_inference_segm_tpu_torch.inference.iterative import make_refiner
    from iterative_inference_segm_tpu_torch.inference.search import grid_search_eps_k, grid_search_eps_k_half
    from iterative_inference_segm_tpu_torch.models.fcn8 import fcn8_apply
    from iterative_inference_segm_tpu_torch.models.registry import score_apply_fn, score_kwargs
    from iterative_inference_segm_tpu_torch.ops.metrics import confusion_matrix, metrics_from_confusion
    from iterative_inference_segm_tpu_torch.train.loop import TrainConfig
    from iterative_inference_segm_tpu_torch.train.train_dae import train_dae
    from iterative_inference_segm_tpu_torch.train.train_fcn8 import train_fcn8

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA card here (pass --device cpu)")

    cfg = dataclasses.replace(CAMVID, train_crop=(args.height - 16, args.width - 16))

    def data(n, seed):
        return list(synthetic_batches(cfg=cfg, batch_size=args.batch_size, num_batches=n, seed=seed,
                                      height=args.height, width=args.width))

    train = data(args.train_batches, args.seed)
    val = data(3, args.seed + 500)
    test = data(4, args.seed + 900)

    print("== training FCN-8 ==", flush=True)
    tcfg = TrainConfig(learning_rate=1e-3, weight_decay=1e-4, max_epochs=args.epochs_fcn, patience=100,
                       seed=args.seed)
    rf = train_fcn8(dataset=cfg, train_data=train, val_data=val, tcfg=tcfg, fc_channels=args.fc_channels,
                    device=device,
                    epoch_callback=lambda e, h, _: print(
                        f"  fcn epoch {e}: loss {h['train_loss']:.3f} val mIoU {h['val_miou']:.3f}", flush=True))
    fcn_params = rf["params"]

    h_taps = ("input",) if args.arch == "contextmod" else ("pool4",)
    from_gt: bool | float = {"natural": False, "gt": True}.get(args.corruption, args.mix_prob)
    print(f"== training {args.arch} ({args.corruption} corruption, conditioned on {h_taps[0]}) ==", flush=True)
    tcfg_d = TrainConfig(learning_rate=1e-3, weight_decay=1e-4, max_epochs=args.epochs_dae, patience=100,
                         seed=args.seed)
    rd = train_dae(fcn_params=fcn_params, dataset=cfg, train_data=train, val_data=val,
                   tcfg=tcfg_d, h_taps=h_taps, sigma=args.sigma, from_gt=from_gt,
                   dae_depth=args.dae_depth, dae_stem_pool=args.dae_stem_pool, dae_tail=args.dae_tail,
                   dae_widths=tuple(args.dae_widths) if args.dae_widths else None,
                   dae_encoder=args.dae_encoder, dae_tied=args.dae_tied, arch=args.arch,
                   epoch_callback=lambda e, h, _: print(
                       f"  dae epoch {e}: loss {h['train_loss']:.3f} val mIoU {h['val_miou']:.3f}", flush=True))
    dae_params = rd["params"]

    print("== (eps, K) search on val ==", flush=True)

    def norm(b):
        return [(normalize_image(torch.from_numpy(i), cfg).numpy(), lab) for i, lab in b]

    cd = torch.bfloat16 if args.bf16 else torch.float32
    common = dict(n_classes=cfg.n_classes, eps_grid=args.eps_grid, k_max=args.k_max, device=device,
                  compute_dtype=cd, mode=args.mode)
    if args.engine == "half":
        res = grid_search_eps_k_half(fcn8_apply, fcn_params, dae_params, norm(val), h_taps=("pool4",),
                                     depth=args.dae_depth, encoder=args.dae_encoder, **common)
    else:
        # one dispatch table for the logits apply and its per-step kwargs
        score_apply = score_apply_fn(args.arch)
        dae_kwargs = score_kwargs(args.arch, depth=args.dae_depth, encoder=args.dae_encoder)
        res = grid_search_eps_k(fcn8_apply, score_apply, fcn_params, dae_params, norm(val), h_taps=h_taps,
                                dae_kwargs=dae_kwargs, **common)
    print(f"  best eps={res['best_eps']} K={res['best_k']} val mIoU {res['best_miou']:.4f}"
          f" (K=0 val mIoU {res['miou'][0, 0]:.4f})", flush=True)

    if args.engine == "half":
        refine = make_half_refiner(
            fcn8_apply, fcn_params, dae_params, eps=res["best_eps"], num_steps=res["best_k"],
            h_taps=("pool4",), depth=args.dae_depth, compute_dtype=cd, encoder=args.dae_encoder,
            mode=args.mode,
        )
    else:
        refine = make_refiner(
            fcn8_apply, score_apply, fcn_params, dae_params, eps=res["best_eps"],
            num_steps=res["best_k"], h_taps=h_taps, mode=args.mode, compute_dtype=cd, dae_kwargs=dae_kwargs,
        )
    cm0 = cmk = None
    for images, labels in norm(test):
        y0, yk = refine(torch.from_numpy(np.asarray(images, np.float32)).to(device))
        labels = torch.from_numpy(np.asarray(labels)).to(device)
        c0 = confusion_matrix(torch.argmax(y0, -1), labels, n_classes=cfg.n_classes)
        ck = confusion_matrix(torch.argmax(yk, -1), labels, n_classes=cfg.n_classes)
        cm0 = c0 if cm0 is None else cm0 + c0
        cmk = ck if cmk is None else cmk + ck
    m0 = metrics_from_confusion(cm0)
    mk = metrics_from_confusion(cmk)
    d = {
        "test_miou_fcn": round(float(m0.mean_iou), 4),
        "test_miou_refined": round(float(mk.mean_iou), 4),
        "delta_miou": round(float(mk.mean_iou - m0.mean_iou), 4),
        "best_eps": res["best_eps"],
        "best_k": res["best_k"],
        "engine": args.engine,
        "mode": args.mode,
        "arch": args.arch,
        "dae_encoder": args.dae_encoder,
    }
    if args.json:
        print(json.dumps(d))
    else:
        print(f"== RESULT == FCN mIoU {d['test_miou_fcn']}  refined mIoU {d['test_miou_refined']}"
              f"  delta {d['delta_miou']:+.4f} (eps={d['best_eps']}, K={d['best_k']})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
