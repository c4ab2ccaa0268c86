"""Iterative inference (PyTorch port): refine the FCN-8 softmax with K score
or energy steps of the DAE, and report per-class IoU / mIoU / accuracy at
k=0 (the FCN baseline) and k=K. With ``--search`` it first grid-searches
(eps, K) on the validation split and evaluates the best pair on test.

The twin of the JAX package's ``scripts/iterative_inference.py``: the same
flags, defaults, refusals and printed lines, plus ``--device``. Flags whose
paths the port does not have yet exit with an error that names ROADMAP.md.
Data is synthetic (the disk loaders are not ported).

Examples:
    python -m iterative_inference_segm_tpu_torch.scripts.iterative_inference \\
        --synthetic --tiny --num-steps 5 --device cpu
    python -m iterative_inference_segm_tpu_torch.scripts.iterative_inference \\
        --synthetic --search --bf16 --num-batches 2
"""

from __future__ import annotations

import argparse
import sys

# flags of the JAX CLI whose paths the port does not have yet, with the
# ROADMAP.md item that ports them
_NOT_PORTED = {
    "data_root": "--data-root (the disk loaders) is not ported yet (ROADMAP.md, Queue 1 item 8)",
    "packed": "--packed (the native input runtime) is not ported yet (ROADMAP.md, Queue 1 item 8)",
    "wire": "--wire u8 (the packed byte wire) is not ported yet (ROADMAP.md, Queue 1 item 8)",
    "devices": "--devices (sharded serving) is not ported yet (ROADMAP.md, Queue 1 item 12)",
    "pp": "--pp (pipeline-parallel serving) is not ported yet (ROADMAP.md, Queue 1 item 12)",
    "pp_stages": "--pp-stages is not ported yet (ROADMAP.md, Queue 1 item 12)",
    "pp_microbatches": "--pp-microbatches is not ported yet (ROADMAP.md, Queue 1 item 12)",
    "arch": "--arch mirror|contextmod is not ported yet (ROADMAP.md, Queue 1 item 6)",
    "dae_tied": "--dae-tied (mirror arch) is not ported yet (ROADMAP.md, Queue 1 item 6)",
    "dae_mirror_npz": "--dae-mirror-npz is not ported yet (ROADMAP.md, Queue 1 item 6)",
    "fcn_reference_npz": "--fcn-reference-npz (utils/import_weights) is not ported yet "
                         "(ROADMAP.md, Queue 1 item 10)",
    "fcn_flip_deconvs": "--fcn-flip-deconvs (utils/import_weights) is not ported yet "
                        "(ROADMAP.md, Queue 1 item 10)",
    "dump_dir": "--dump-dir (utils/colorize) is not ported yet (ROADMAP.md, Queue 1 item 10)",
    "dump_trajectory": "--dump-trajectory (utils/colorize) is not ported yet "
                       "(ROADMAP.md, Queue 1 item 10)",
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", default="camvid", choices=["camvid", "em", "polyps"])
    p.add_argument("--data-root", default=None)
    p.add_argument("--packed", default=None)
    p.add_argument("--wire", default="f32", choices=["f32", "u8"])
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on ('cuda' needs a card; 'cpu' runs the "
                        "kernels' plain versions)")
    p.add_argument("--fcn-npz", default=None, help="FCN-8 weights (flat npz, either package)")
    p.add_argument("--fcn-reference-npz", default=None)
    p.add_argument("--fcn-flip-deconvs", action="store_true")
    p.add_argument("--dae-npz", default=None, help="DAE weights (flat npz with its stamp)")
    p.add_argument("--concat-h", nargs="*", default=["pool4"])
    p.add_argument("--dae-depth", type=int, default=4)
    p.add_argument("--dae-stem-pool", type=int, default=0)
    p.add_argument("--dae-tail", choices=["full", "sep"], default="full",
                   help="must match the architecture the DAE npz was trained with")
    p.add_argument("--dae-widths", nargs="*", type=int, default=None,
                   help="encoder widths; must match the trained DAE npz")
    p.add_argument("--dae-encoder", choices=["pool", "stride"], default="pool",
                   help="encoder style; must match the trained DAE npz")
    p.add_argument("--arch", default="dae", choices=["dae", "mirror", "contextmod"])
    p.add_argument("--dae-tied", action="store_true")
    p.add_argument("--dae-mirror-npz", default=None)
    p.add_argument("--epsilon", type=float, default=0.1)
    p.add_argument("--num-steps", type=int, default=5)
    p.add_argument("--mode", default="score", choices=["score", "energy"])
    p.add_argument("--engine", default="general", choices=["general", "half"],
                   help="'half' = K pooled-map steps + one full-res rectification "
                        "(requires --dae-stem-pool >= 1; 2 iterates at quarter res)")
    p.add_argument("--renorm", default="none", choices=["none", "softmax"])
    p.add_argument("--search", action="store_true", help="grid-search (eps, K) on val first")
    p.add_argument("--eps-grid", nargs="*", type=float, default=[0.02, 0.05, 0.1, 0.2])
    p.add_argument("--k-max", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--devices", default=None)
    p.add_argument("--pp", action="store_true")
    p.add_argument("--pp-stages", type=int, choices=[2, 3], default=2)
    p.add_argument("--pp-microbatches", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--tiny", action="store_true", help="96x128 frames, fc 64")
    p.add_argument("--num-batches", type=int, default=4)
    p.add_argument("--dump-dir", default=None)
    p.add_argument("--dump-trajectory", action="store_true")
    args = p.parse_args(argv)
    for name, why in _NOT_PORTED.items():
        if getattr(args, name) != p.get_default(name):
            p.error(why)
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    import numpy as np
    import torch

    from iterative_inference_segm_tpu_torch.data.config_datasets import DATASET_CONFIGS
    from iterative_inference_segm_tpu_torch.data.pipeline import normalize_image
    from iterative_inference_segm_tpu_torch.data.synthetic import synthetic_batches
    from iterative_inference_segm_tpu_torch.inference.fused import make_half_refiner
    from iterative_inference_segm_tpu_torch.inference.iterative import make_refiner
    from iterative_inference_segm_tpu_torch.inference.search import (
        grid_search_eps_k,
        grid_search_eps_k_half,
    )
    from iterative_inference_segm_tpu_torch.models.fcn8 import fcn8_apply, init_fcn8
    from iterative_inference_segm_tpu_torch.models.registry import (
        expected_meta,
        init_score_template,
        score_kwargs,
        score_logits_fn,
    )
    from iterative_inference_segm_tpu_torch.ops.metrics import (
        confusion_matrix,
        metrics_from_confusion,
    )
    from iterative_inference_segm_tpu_torch.utils.checkpoint import check_npz_meta, load_npz

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {args.device}: no CUDA card here (pass --device cpu)")

    cfg = DATASET_CONFIGS[args.dataset]
    height = width = None
    fc_channels = 4096
    if args.tiny:
        height, width, fc_channels = 96, 128, 64

    fcn_params = init_fcn8(
        torch.Generator().manual_seed(args.seed), n_classes=cfg.n_classes,
        in_channels=cfg.in_channels, fc_channels=fc_channels, device=device,
    )
    if args.fcn_npz:
        fcn_params = load_npz(args.fcn_npz, fcn_params)
    widths = tuple(args.dae_widths) if args.dae_widths else None
    dae_params = init_score_template(
        args.arch, torch.Generator().manual_seed(args.seed + 1), n_classes=cfg.n_classes,
        h_taps=tuple(args.concat_h), depth=args.dae_depth, stem_pool=args.dae_stem_pool,
        tail=args.dae_tail, widths=widths, device=device,
    )
    if args.dae_npz:
        expect = expected_meta(
            args.arch, depth=args.dae_depth, stem_pool=args.dae_stem_pool, tail=args.dae_tail,
            widths=widths, encoder=args.dae_encoder,
        )
        check_npz_meta(args.dae_npz, expect, context=f"--dae-npz {args.dae_npz}")
        dae_params = load_npz(args.dae_npz, dae_params)
    score_logits = score_logits_fn(args.arch)
    dae_kwargs = score_kwargs(args.arch, depth=args.dae_depth, encoder=args.dae_encoder)

    def get_batches(split_seed):
        return [
            (normalize_image(torch.from_numpy(i), cfg).numpy(), lab)
            for i, lab in synthetic_batches(
                cfg=cfg, batch_size=args.batch_size, num_batches=args.num_batches,
                height=height, width=width, seed=split_seed,
            )
        ]

    val_batches = get_batches(args.seed + 500)
    test_batches = get_batches(args.seed + 900)

    if args.engine == "half" and (args.dae_stem_pool < 1 or args.arch != "dae"):
        raise SystemExit("--engine half requires --dae-stem-pool >= 1 "
                         "(2 = quarter engine), --arch dae")
    if args.engine == "half" and args.renorm != "none":
        raise SystemExit(
            "--renorm is a general-engine knob (the pooled engine's update "
            "has no renormalization step); rerun with --engine general"
        )

    compute_dtype = torch.bfloat16 if args.bf16 else torch.float32
    eps, num_steps = args.epsilon, args.num_steps
    if args.search:
        common = dict(n_classes=cfg.n_classes, eps_grid=args.eps_grid, k_max=args.k_max,
                      device=device, h_taps=tuple(args.concat_h), compute_dtype=compute_dtype,
                      mode=args.mode)
        if args.engine == "half":
            res = grid_search_eps_k_half(
                fcn8_apply, fcn_params, dae_params, val_batches, depth=args.dae_depth,
                encoder=args.dae_encoder, **common,
            )
        else:
            res = grid_search_eps_k(
                fcn8_apply, score_logits, fcn_params, dae_params, val_batches,
                renorm=args.renorm, dae_kwargs=dae_kwargs, **common,
            )
        eps, num_steps = res["best_eps"], res["best_k"]
        print(f"val search: best eps={eps} K={num_steps} (val mIoU {res['best_miou']:.4f})")

    # num_steps=0 is honest (the search may pick K=0): the loop runs no step
    # and yk == y0
    if args.engine == "half":
        refine = make_half_refiner(
            fcn8_apply, fcn_params, dae_params, eps=eps, num_steps=num_steps,
            h_taps=tuple(args.concat_h), depth=args.dae_depth, compute_dtype=compute_dtype,
            encoder=args.dae_encoder, mode=args.mode,
        )
    else:
        refine = make_refiner(
            fcn8_apply, score_logits, fcn_params, dae_params, eps=eps, num_steps=num_steps,
            h_taps=tuple(args.concat_h), mode=args.mode, renorm=args.renorm,
            compute_dtype=compute_dtype, dae_kwargs=dae_kwargs,
        )

    cm0 = cmk = None
    for images, labels in test_batches:
        y0, yk = refine(torch.from_numpy(np.asarray(images, np.float32)).to(device))
        labels = torch.from_numpy(np.asarray(labels)).to(device)
        c0 = confusion_matrix(torch.argmax(y0, -1), labels, n_classes=cfg.n_classes)
        ck = confusion_matrix(torch.argmax(yk, -1), labels, n_classes=cfg.n_classes)
        cm0 = c0 if cm0 is None else cm0 + c0
        cmk = ck if cmk is None else cmk + ck

    m0 = metrics_from_confusion(cm0)
    mk = metrics_from_confusion(cmk)
    if args.engine == "half":
        # the half engine's K counts pooled-map steps; K=0 still applies the
        # one full-res rectification, so it is a refinement pass
        refined_label = f"K={num_steps}+rectify (half engine)"
    elif num_steps > 0:
        refined_label = f"step {num_steps} (refined)"
    else:
        refined_label = "step 0 (search chose K=0; no refinement applied)"
    print(f"step 0 (FCN-8 baseline): mIoU {float(m0.mean_iou):.4f} acc {float(m0.pixel_accuracy):.4f}")
    print(f"{refined_label}:     mIoU {float(mk.mean_iou):.4f} acc {float(mk.pixel_accuracy):.4f}")
    print("per-class IoU (k=0 -> k=K):")
    for ci, name in enumerate(cfg.class_names):
        a = float(m0.per_class_iou[ci])
        b = float(mk.per_class_iou[ci])
        print(f"  {name:>14s}: {a:.4f} -> {b:.4f}  ({b - a:+.4f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
