"""Train the conditional DAE against a frozen FCN-8 (PyTorch port).

The twin of the JAX package's ``scripts/train_dae.py``, with the same flags
plus ``--device``. The DAE learns to denoise corrupted segmentation maps
conditioned on frozen FCN-8 features; ``--sigma``, ``--from-fcn`` and
``--gt-mix`` pick the corruption regime, ``--arch`` the score network
(``dae``, ``mirror``, ``contextmod``). The workdir gets ``metrics.jsonl``,
``best_dae.npz`` (JAX layout with the architecture stamp, served by
``Predictor.from_npz``) and ``ckpt/<epoch>/`` for resuming. The data is
``--packed DIR`` (the native runtime; ``--wire u8`` sends bytes to the card,
which normalizes them with the file's statistics), ``--data-root ROOT``
(the disk loaders; needs Pillow) or ``--synthetic``. ``--devices N`` (or
``auto``) trains data-parallel over N devices, one rank each
(``parallel.launch``): N cards over NCCL on CUDA, N gloo ranks with
``--device cpu``.

Examples:
    python -m iterative_inference_segm_tpu_torch.scripts.train_dae \\
        --synthetic --tiny --max-epochs 2 --device cpu
    python -m iterative_inference_segm_tpu_torch.scripts.train_dae \\
        --synthetic --bf16 --batch-size 32 --dae-depth 3 --dae-stem-pool 1
    python -m iterative_inference_segm_tpu_torch.scripts.train_dae \\
        --packed /data/packed --wire u8 --bf16 --batch-size 32
    python -m iterative_inference_segm_tpu_torch.scripts.train_dae \\
        --synthetic --tiny --max-epochs 1 --device cpu --devices 2
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", default="camvid", choices=["camvid", "em", "polyps"])
    p.add_argument("--data-root", default=None)
    p.add_argument("--packed", default=None)
    p.add_argument("--wire", default="f32", choices=["f32", "u8"])
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--devices", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device to train on ('cuda' needs a card; 'cpu' runs the "
                        "kernels' plain versions)")
    p.add_argument("--fcn-npz", default=None, help="frozen FCN-8 weights (flat npz)")
    p.add_argument("--concat-h", nargs="*", default=["pool4"],
                   help="FCN taps to condition on (e.g. pool3 pool4 fc7); empty = unconditional")
    p.add_argument("--sigma", type=float, default=1.0, help="corruption noise level")
    p.add_argument("--from-fcn", action="store_true",
                   help="corrupt from frozen-FCN outputs instead of noisy GT")
    p.add_argument("--gt-mix", type=float, default=None,
                   help="mixed regime: probability of the noisy-GT corruption per batch "
                        "(overrides --from-fcn)")
    p.add_argument("--dae-depth", type=int, default=4)
    p.add_argument("--dae-tail", choices=["full", "sep"], default="full")
    p.add_argument("--dae-widths", nargs="*", type=int, default=None,
                   help="encoder channel widths (default from models.dae)")
    p.add_argument("--dae-encoder", choices=["pool", "stride"], default="pool")
    p.add_argument("--dae-stem-pool", type=int, default=0,
                   help="pool the input map N times before the encoder")
    p.add_argument("--arch", default="dae", choices=["dae", "mirror", "contextmod"],
                   help="score network: the DAE, the conv/pool <-> unpool/conv mirror, or the "
                        "dilated context module (conditions on --concat-h input only)")
    p.add_argument("--dae-tied", action="store_true",
                   help="mirror arch only: tie the decoder kernels to the encoder's")
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--batch-size", type=int, default=10)
    p.add_argument("--max-epochs", type=int, default=500)
    p.add_argument("--patience", type=int, default=25)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--workdir", default=None)
    p.add_argument("--tiny", action="store_true", help="96x128 frames, fc 64, crop 64")
    p.add_argument("--num-train-batches", type=int, default=8)
    p.add_argument("--num-val-batches", type=int, default=2)
    args = p.parse_args(argv)
    if args.wire != "f32" and not args.packed:
        p.error("--wire u8 requires --packed (the wire format is a property "
                "of the packed-path input runtime)")
    return args


def main(argv=None, *, mesh=None, device=None) -> int:
    """``mesh``/``device``: set in the ranks that ``--devices`` launches."""
    args = parse_args(argv)
    import torch

    from iterative_inference_segm_tpu_torch.parallel.mesh import axis_size, mesh_from_flag
    from iterative_inference_segm_tpu_torch.scripts._parallel import check_device, run_ranks

    device = torch.device(device or args.device)
    check_device(device)
    if mesh is None:
        spec = mesh_from_flag(args.devices, batch_size=args.batch_size, device_type=device.type)
        if spec is not None:
            return run_ranks(main, argv, spec, args.device, kernels=("corruption",),
                             native_runtime=bool(args.packed))

    from iterative_inference_segm_tpu_torch.data.config_datasets import DATASET_CONFIGS
    from iterative_inference_segm_tpu_torch.models.fcn8 import init_fcn8
    from iterative_inference_segm_tpu_torch.scripts._train_data import train_sources
    from iterative_inference_segm_tpu_torch.train.loop import TrainConfig
    from iterative_inference_segm_tpu_torch.train.train_dae import train_dae
    from iterative_inference_segm_tpu_torch.utils.checkpoint import load_npz
    from iterative_inference_segm_tpu_torch.utils.experiment import build_experiment_name

    cfg = DATASET_CONFIGS[args.dataset]
    height = width = None
    fc_channels = 4096
    if args.tiny:
        height, width, fc_channels = 96, 128, 64
        cfg = dataclasses.replace(cfg, train_crop=(64, 64))

    fcn_params = init_fcn8(
        torch.Generator().manual_seed(args.seed), n_classes=cfg.n_classes,
        in_channels=cfg.in_channels, fc_channels=fc_channels, device=device,
    )
    if args.fcn_npz:
        fcn_params = load_npz(args.fcn_npz, fcn_params)

    tcfg = TrainConfig(
        learning_rate=args.learning_rate,
        weight_decay=args.weight_decay,
        max_epochs=args.max_epochs,
        patience=args.patience,
        batch_size=args.batch_size,
        seed=args.seed,
        compute_dtype=torch.bfloat16 if args.bf16 else torch.float32,
    )

    cfg, train_data, val_data, step_kwargs = train_sources(args, cfg, height=height, width=width)

    workdir = args.workdir or os.path.join(
        "experiments",
        build_experiment_name(
            f"dae_{args.dataset}",
            lr=args.learning_rate,
            sigma=args.sigma,
            from_fcn=args.from_fcn,
            h="-".join(args.concat_h) or "none",
            seed=args.seed,
        ),
    )
    if mesh is not None:
        print(f"[train_dae] data-parallel over {axis_size(mesh, 'data')} devices", flush=True)
    result = train_dae(
        fcn_params=fcn_params,
        dataset=cfg,
        mesh=mesh,
        train_data=train_data,
        val_data=val_data,
        tcfg=tcfg,
        h_taps=tuple(args.concat_h),
        sigma=args.sigma,
        from_gt=args.gt_mix if args.gt_mix is not None else (not args.from_fcn),
        dae_depth=args.dae_depth,
        dae_stem_pool=args.dae_stem_pool,
        dae_tail=args.dae_tail,
        dae_widths=tuple(args.dae_widths) if args.dae_widths else None,
        dae_encoder=args.dae_encoder,
        dae_tied=args.dae_tied,
        arch=args.arch,
        workdir=workdir,
        augment=not args.no_augment,
        **step_kwargs,
        epoch_callback=lambda e, h, _p: print(
            f"epoch {e}: train_loss={h['train_loss']:.4f} val_loss={h['val_loss']:.4f} "
            f"val_miou={h['val_miou']:.4f}",
            flush=True,
        ),
    )
    print(
        f"done: best val mIoU {result['best_miou']:.4f} at epoch {result['best_epoch']} "
        f"({result['epochs']} epochs run); checkpoints in {workdir}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
