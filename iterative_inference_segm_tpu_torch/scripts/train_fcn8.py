"""Train FCN-8 (PyTorch port).

The twin of the JAX package's ``scripts/train_fcn8.py``, with the same flags
plus ``--device``. The workdir gets ``metrics.jsonl``, ``best_fcn8.npz``
(JAX layout, stamped ``{"arch": "fcn8", "fc_channels": ...}``; the
``--fcn-npz`` flags of both packages read it) and ``ckpt/<epoch>/`` for
resuming. ``--packed`` (with ``--wire f32|u8``) and ``--data-root`` pick the
data as in ``train_dae``'s twin; ``--load-reference-npz`` starts from a
reference-era Lasagne checkpoint (``utils/import_weights``) and
``--profile-dir`` writes a ``torch.profiler`` Chrome trace of the run
(``utils/profiling``; rank 0's under ``--devices``). ``--devices N`` (or
``auto``) trains data-parallel over N devices, one rank each
(``parallel.launch``): N cards over NCCL on CUDA, N gloo ranks with
``--device cpu``.

Examples:
    python -m iterative_inference_segm_tpu_torch.scripts.train_fcn8 \\
        --synthetic --tiny --max-epochs 2 --device cpu
    python -m iterative_inference_segm_tpu_torch.scripts.train_fcn8 \\
        --synthetic --bf16 --max-epochs 1
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys

def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", default="camvid", choices=["camvid", "em", "polyps"])
    p.add_argument("--data-root", default=None)
    p.add_argument("--packed", default=None)
    p.add_argument("--wire", default="f32", choices=["f32", "u8"])
    p.add_argument("--synthetic", action="store_true", help="use the synthetic dataset")
    p.add_argument("--devices", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device to train on ('cuda' needs a card; 'cpu' runs there)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace of the run (trace.json) here")
    p.add_argument("--learning-rate", type=float, default=1e-3)
    p.add_argument("--weight-decay", type=float, default=1e-4)
    p.add_argument("--batch-size", type=int, default=10)
    p.add_argument("--max-epochs", type=int, default=500)
    p.add_argument("--patience", type=int, default=25)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-augment", action="store_true")
    p.add_argument("--bf16", action="store_true", help="bf16 conv compute")
    p.add_argument("--workdir", default=None)
    p.add_argument("--load-npz", default=None, help="initialize from a flat .npz export (either package)")
    p.add_argument("--load-reference-npz", default=None,
                   help="initialize from a reference-era Lasagne checkpoint (positional np.savez of "
                        "get_all_param_values; OIHW/flat-FC/IOHW layouts converted automatically)")
    p.add_argument("--tiny", action="store_true", help="96x128 frames, fc 64, crop 64")
    p.add_argument("--num-train-batches", type=int, default=8, help="synthetic only")
    p.add_argument("--num-val-batches", type=int, default=2, help="synthetic only")
    args = p.parse_args(argv)
    if args.wire != "f32" and not args.packed:
        p.error("--wire u8 requires --packed (the wire format is a property "
                "of the packed-path input runtime)")
    return args


def main(argv=None, *, mesh=None, device=None) -> int:
    """``mesh``/``device``: set in the ranks that ``--devices`` launches."""
    args = parse_args(argv)
    import torch
    import torch.distributed as dist

    from iterative_inference_segm_tpu_torch.parallel.mesh import axis_size, mesh_from_flag
    from iterative_inference_segm_tpu_torch.scripts._parallel import check_device, run_ranks

    device = torch.device(device or args.device)
    check_device(device)
    if mesh is None:
        spec = mesh_from_flag(args.devices, batch_size=args.batch_size, device_type=device.type)
        if spec is not None:
            return run_ranks(main, argv, spec, args.device, native_runtime=bool(args.packed))

    from iterative_inference_segm_tpu_torch.data.config_datasets import DATASET_CONFIGS
    from iterative_inference_segm_tpu_torch.models.fcn8 import init_fcn8
    from iterative_inference_segm_tpu_torch.scripts._train_data import train_sources
    from iterative_inference_segm_tpu_torch.train.loop import TrainConfig
    from iterative_inference_segm_tpu_torch.train.train_fcn8 import train_fcn8
    from iterative_inference_segm_tpu_torch.utils import profiling
    from iterative_inference_segm_tpu_torch.utils.checkpoint import load_npz
    from iterative_inference_segm_tpu_torch.utils.experiment import build_experiment_name

    cfg = DATASET_CONFIGS[args.dataset]
    height = width = None
    fc_channels = 4096
    if args.tiny:
        height, width, fc_channels = 96, 128, 64
        cfg = dataclasses.replace(cfg, train_crop=(64, 64))

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
            f"fcn8_{args.dataset}", lr=args.learning_rate, wd=args.weight_decay, seed=args.seed
        ),
    )
    params = None
    if args.load_npz or args.load_reference_npz:
        template = init_fcn8(
            torch.Generator().manual_seed(0), n_classes=cfg.n_classes,
            in_channels=cfg.in_channels, fc_channels=fc_channels, device=device,
        )
        if args.load_reference_npz:
            from iterative_inference_segm_tpu_torch.utils.import_weights import import_lasagne_npz

            params = import_lasagne_npz(args.load_reference_npz, template)
        else:
            params = load_npz(args.load_npz, template)

    writer = mesh is None or dist.get_rank() == 0
    if mesh is not None:
        print(f"[train_fcn8] data-parallel over {axis_size(mesh, 'data')} devices", flush=True)
    trace = profiling.trace(args.profile_dir) if args.profile_dir and writer else contextlib.nullcontext()
    with trace:
        result = train_fcn8(
            mesh=mesh,
            dataset=cfg,
            train_data=train_data,
            val_data=val_data,
            tcfg=tcfg,
            fc_channels=fc_channels,
            workdir=workdir,
            augment=not args.no_augment,
            **step_kwargs,
            params=params,
            device=device,
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
