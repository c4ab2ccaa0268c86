"""Iterative inference (PyTorch port): refine the FCN-8 softmax with K score
or energy steps of the DAE, and report per-class IoU / mIoU / accuracy at
k=0 (the FCN baseline) and k=K. With ``--search`` it first grid-searches
(eps, K) on the validation split and evaluates the best pair on test.

The twin of the JAX package's ``scripts/iterative_inference.py``: the same
flags, defaults, refusals, printed lines and dump files, plus ``--device``.
The data is ``--packed DIR`` (the native runtime; val is read only under
``--search``; on ``--wire u8`` each batch crosses as bytes and is normalized
on the card with the file's statistics), ``--data-root ROOT`` (the disk
loaders; needs Pillow) or ``--synthetic``. ``--fcn-reference-npz`` and
``--dae-mirror-npz`` load reference-era Lasagne checkpoints
(``utils/import_weights``); ``--dump-dir`` writes colorized PNGs (Pillow).
``--devices N`` serves each test batch data-parallel over N devices, one
rank each (``parallel.launch``; N cards over NCCL on CUDA, N gloo ranks
with ``--device cpu``); ``--pp`` serves through the stage pipeline
(``--pp-stages`` 2 or 3, ``--pp-microbatches`` in flight), composed with a
'data' axis when ``--devices`` is a larger multiple of the stage count.

Examples:
    python -m iterative_inference_segm_tpu_torch.scripts.iterative_inference \\
        --synthetic --tiny --num-steps 5 --device cpu
    python -m iterative_inference_segm_tpu_torch.scripts.iterative_inference \\
        --synthetic --search --bf16 --num-batches 2
    python -m iterative_inference_segm_tpu_torch.scripts.iterative_inference \\
        --packed /data/packed --wire u8 --dae-npz best_dae.npz --search
    python -m iterative_inference_segm_tpu_torch.scripts.iterative_inference \\
        --synthetic --tiny --device cpu --engine half --dae-stem-pool 1 --dae-depth 3 \\
        --batch-size 8 --pp --devices 4
"""

from __future__ import annotations

import argparse
import sys

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
    p.add_argument("--fcn-reference-npz", default=None,
                   help="load the FCN from a reference-era Lasagne positional .npz (layout "
                        "conversion automatic)")
    p.add_argument("--fcn-flip-deconvs", action="store_true",
                   help="with --fcn-reference-npz: reverse the spatial taps of the transposed-conv "
                        "kernels (checkpoints saved under the flipped convention)")
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
    p.add_argument("--arch", default="dae", choices=["dae", "mirror", "contextmod"],
                   help="score network: the DAE, the mirror DAE, or the dilated context module")
    p.add_argument("--dae-tied", action="store_true", help="mirror arch: expect a weight-tied checkpoint")
    p.add_argument("--dae-mirror-npz", default=None,
                   help="load the mirror DAE from a reference-era positional .npz "
                        "(utils.import_weights.import_mirror_dae_npz)")
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
    p.add_argument("--dump-dir", default=None, help="write colorized PNG predictions here (Pillow)")
    p.add_argument("--dump-trajectory", action="store_true",
                   help="with --dump-dir: dump every step y_0..y_K of the first batch")
    args = p.parse_args(argv)
    if args.wire != "f32" and not args.packed:
        p.error("--wire u8 requires --packed (the wire format is a property "
                "of the packed-path input runtime)")
    return args


def pp_mesh_spec(args):
    """The ``--pp`` mesh: ``--devices`` (default: the stage count) ranks as
    ('stage',) or ('data', 'stage'), with the JAX CLI's checks."""
    import torch

    from iterative_inference_segm_tpu_torch.parallel.mesh import MeshSpec, local_device_count

    if args.pp_microbatches < 1:
        raise SystemExit(f"--pp-microbatches must be >= 1; got {args.pp_microbatches}")
    avail = local_device_count(torch.device(args.device).type)
    s = args.pp_stages
    n_pp = avail if args.devices == "auto" else int(args.devices) if args.devices else s
    if n_pp < s or n_pp % s:
        raise SystemExit(f"--pp with {s} stages needs a device count divisible by {s}; got {n_pp}")
    if n_pp > avail:
        raise SystemExit(f"--pp over {n_pp} devices but only {avail} visible")
    pp_dp = n_pp // s
    if args.batch_size % (args.pp_microbatches * pp_dp):
        raise SystemExit(f"--batch-size {args.batch_size} not divisible by --pp-microbatches "
                         f"{args.pp_microbatches} x DP width {pp_dp}")
    return MeshSpec(("data", "stage"), (pp_dp, s)) if pp_dp > 1 else MeshSpec(("stage",), (s,))


def main(argv=None, *, mesh=None, device=None) -> int:
    """``mesh``/``device``: set in the ranks that ``--devices``/``--pp`` launch."""
    args = parse_args(argv)
    import dataclasses
    import os

    import numpy as np
    import torch
    import torch.distributed as dist

    from iterative_inference_segm_tpu_torch.parallel.mesh import axis_size, has_axis, mesh_from_flag
    from iterative_inference_segm_tpu_torch.scripts._parallel import check_device, run_ranks

    device = torch.device(device or args.device)
    check_device(device)
    if mesh is None:
        # with --pp, --devices sizes the pipeline mesh; the DP path (and its
        # own batch-divisibility rule) does not apply
        spec = (pp_mesh_spec(args) if args.pp
                else mesh_from_flag(args.devices, batch_size=args.batch_size, device_type=device.type))
        if spec is not None:
            return run_ranks(main, argv, spec, args.device, kernels=("refine_tail",),
                             native_runtime=bool(args.packed))
    writer = mesh is None or dist.get_rank() == 0

    from iterative_inference_segm_tpu_torch.data.config_datasets import DATASET_CONFIGS
    from iterative_inference_segm_tpu_torch.data.pipeline import normalize_image
    from iterative_inference_segm_tpu_torch.inference.fused import make_half_refiner
    from iterative_inference_segm_tpu_torch.inference.iterative import logits_refinement_scan, make_refiner
    from iterative_inference_segm_tpu_torch.inference.search import (
        grid_search_eps_k,
        grid_search_eps_k_half,
    )
    from iterative_inference_segm_tpu_torch.models.fcn8 import fcn8_apply, init_fcn8
    from iterative_inference_segm_tpu_torch.models.registry import (
        expected_meta,
        init_score_template,
        score_apply_fn,
        score_kwargs,
        score_logits_fn,
    )
    from iterative_inference_segm_tpu_torch.ops.metrics import (
        confusion_matrix,
        metrics_from_confusion,
    )
    from iterative_inference_segm_tpu_torch.utils.checkpoint import check_npz_meta, load_npz

    cfg = DATASET_CONFIGS[args.dataset]
    height = width = None
    fc_channels = 4096
    if args.tiny:
        height, width, fc_channels = 96, 128, 64

    fcn_params = init_fcn8(
        torch.Generator().manual_seed(args.seed), n_classes=cfg.n_classes,
        in_channels=cfg.in_channels, fc_channels=fc_channels, device=device,
    )
    if args.fcn_reference_npz:
        from iterative_inference_segm_tpu_torch.utils.import_weights import import_lasagne_npz

        fcn_params = import_lasagne_npz(args.fcn_reference_npz, fcn_params, flip_deconvs=args.fcn_flip_deconvs)
    elif args.fcn_npz:
        fcn_params = load_npz(args.fcn_npz, fcn_params)
    widths = tuple(args.dae_widths) if args.dae_widths else None
    dae_params = init_score_template(
        args.arch, torch.Generator().manual_seed(args.seed + 1), n_classes=cfg.n_classes,
        h_taps=tuple(args.concat_h), depth=args.dae_depth, stem_pool=args.dae_stem_pool,
        tail=args.dae_tail, widths=widths, tied=args.dae_tied, device=device,
    )
    if args.dae_mirror_npz:
        if args.arch != "mirror":
            raise SystemExit("--dae-mirror-npz requires --arch mirror")
        from iterative_inference_segm_tpu_torch.utils.import_weights import import_mirror_dae_npz

        dae_params = import_mirror_dae_npz(args.dae_mirror_npz, dae_params)
    elif args.dae_npz:
        expect = expected_meta(
            args.arch, depth=args.dae_depth, stem_pool=args.dae_stem_pool, tail=args.dae_tail,
            widths=widths, encoder=args.dae_encoder, tied=args.dae_tied,
        )
        check_npz_meta(args.dae_npz, expect, context=f"--dae-npz {args.dae_npz}")
        dae_params = load_npz(args.dae_npz, dae_params)
    score_apply, score_logits = score_apply_fn(args.arch), score_logits_fn(args.arch)
    dae_kwargs = score_kwargs(args.arch, depth=args.dae_depth, encoder=args.dae_encoder)

    def host_normalized(batches, norm_cfg):
        return [(normalize_image(torch.from_numpy(np.asarray(i)), norm_cfg).numpy(), lab) for i, lab in batches]

    u8_wire = bool(args.packed) and args.wire == "u8"
    test_cfg = cfg  # the statistics the u8 wire's test batches are normalized with
    if args.packed:
        from iterative_inference_segm_tpu_torch.data.native_loader import NativeDataset

        def packed_batches(split, *, device_normalize=False):
            """The split's batches and the config with the file header's
            statistics. On the u8 wire the bytes stay on the host (each test
            batch is normalized on the device as it is served, so the split
            is never resident there at once); val, which --search iterates
            once per eps, is normalized on the device up front."""
            with NativeDataset(os.path.join(args.packed, f"{split}.iist")) as ds:
                file_cfg = dataclasses.replace(cfg, mean=ds.mean, std=ds.std)
                out = []
                for i, lab in ds.batches(args.batch_size, raw=u8_wire):
                    if u8_wire and device_normalize:
                        i = normalize_image(torch.from_numpy(i).to(device), file_cfg, input_scale=255.0)
                    out.append((i, np.asarray(lab, np.int32)))
                return out, file_cfg

        # val is read only by --search: a serving layout may ship test.iist alone
        val_batches = packed_batches("val", device_normalize=True)[0] if args.search else []
        test_batches, test_cfg = packed_batches("test")
    elif args.synthetic or not args.data_root:
        from iterative_inference_segm_tpu_torch.data.synthetic import synthetic_batches

        def get_batches(split_seed):
            return host_normalized(synthetic_batches(
                cfg=cfg, batch_size=args.batch_size, num_batches=args.num_batches,
                height=height, width=width, seed=split_seed,
            ), cfg)

        val_batches = get_batches(args.seed + 500)
        test_batches = get_batches(args.seed + 900)
    else:
        from iterative_inference_segm_tpu_torch.data.camvid import iterate_split
        from iterative_inference_segm_tpu_torch.data.loaders import load_dataset_split

        va_i, va_l = load_dataset_split(args.dataset, args.data_root, "val", cfg)
        te_i, te_l = load_dataset_split(args.dataset, args.data_root, "test", cfg)
        val_batches = host_normalized(iterate_split(va_i, va_l, batch_size=args.batch_size), cfg)
        test_batches = host_normalized(iterate_split(te_i, te_l, batch_size=args.batch_size), cfg)

    if args.engine == "half" and (args.dae_stem_pool < 1 or args.arch != "dae"):
        raise SystemExit("--engine half requires --dae-stem-pool >= 1 "
                         "(2 = quarter engine), --arch dae")
    if args.engine == "half" and args.renorm != "none":
        raise SystemExit(
            "--renorm is a general-engine knob (the pooled engine's update "
            "has no renormalization step); rerun with --engine general"
        )
    if args.engine == "half" and args.dump_trajectory:
        raise SystemExit(
            "--dump-trajectory is a general-engine artifact (full-res y_k "
            "states); the half engine iterates a pooled map — rerun with "
            "--engine general to dump a trajectory"
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
                fcn8_apply, score_apply, fcn_params, dae_params, val_batches,
                renorm=args.renorm, dae_kwargs=dae_kwargs, **common,
            )
        eps, num_steps = res["best_eps"], res["best_k"]
        print(f"val search: best eps={eps} K={num_steps} (val mIoU {res['best_miou']:.4f})")

    # num_steps=0 is honest (the search may pick K=0): the loop runs no step
    # and yk == y0
    if args.pp:
        from iterative_inference_segm_tpu_torch.inference.fused import no_autograd
        from iterative_inference_segm_tpu_torch.parallel.pp import (
            make_pp_flagship,
            merge_microbatches,
            split_microbatches,
        )

        pp_batch_axis = "data" if has_axis(mesh, "data") else None
        pp_fwd = make_pp_flagship(
            mesh, eps=eps, num_steps=num_steps, h_taps=tuple(args.concat_h), depth=args.dae_depth,
            compute_dtype=compute_dtype, encoder=args.dae_encoder, mode=args.mode, engine=args.engine,
            renorm=args.renorm, dae_arch=args.arch, batch_axis=pp_batch_axis,
        )

        def refine(x):
            with no_autograd(args.mode):
                y0, yk = pp_fwd(fcn_params, dae_params, split_microbatches(x, args.pp_microbatches))
            return merge_microbatches(y0), merge_microbatches(yk)

        dp_note = f" x {axis_size(mesh, 'data')}-wide DP" if pp_batch_axis else ""
        print(f"pipeline-parallel serving: {axis_size(mesh, 'stage')} stages{dp_note}, "
              f"{args.pp_microbatches} microbatches in flight", flush=True)
    elif args.engine == "half":
        refine = make_half_refiner(
            fcn8_apply, fcn_params, dae_params, eps=eps, num_steps=num_steps,
            h_taps=tuple(args.concat_h), depth=args.dae_depth, compute_dtype=compute_dtype,
            encoder=args.dae_encoder, mode=args.mode,
        )
    else:
        refine = make_refiner(
            fcn8_apply, score_apply, fcn_params, dae_params, eps=eps, num_steps=num_steps,
            h_taps=tuple(args.concat_h), mode=args.mode, renorm=args.renorm,
            compute_dtype=compute_dtype, dae_kwargs=dae_kwargs,
        )

    def put_x(images):
        """A test batch on the device, normalized: the u8 wire's bytes with
        the test file's statistics, the others as they come (normalized on
        the host)."""
        x = torch.from_numpy(np.asarray(images)).to(device)
        if u8_wire:
            return normalize_image(x, test_cfg, input_scale=255.0)
        return x.to(torch.float32)

    if args.dump_dir and args.dump_trajectory and test_batches and writer:
        from iterative_inference_segm_tpu_torch.inference.fused import no_autograd
        from iterative_inference_segm_tpu_torch.utils.colorize import save_label_png

        with no_autograd(args.mode):
            y0, h = fcn8_apply(fcn_params, put_x(test_batches[0][0]), return_features=tuple(args.concat_h),
                               compute_dtype=compute_dtype)
            traj = logits_refinement_scan(
                lambda y: score_logits(dae_params, y, h, **dae_kwargs), y0,
                eps=eps, num_steps=num_steps, mode=args.mode, renorm=args.renorm, trajectory=True,
            )
        traj = traj.argmax(-1).cpu().numpy()  # (K+1, B, H, W)
        os.makedirs(args.dump_dir, exist_ok=True)
        for k in range(traj.shape[0]):
            for j in range(traj.shape[1]):
                save_label_png(os.path.join(args.dump_dir, f"traj_{j:02d}_step{k:02d}.png"), traj[k, j], cfg)

    if mesh is None:
        def serve(images):
            return refine(put_x(images))
    else:
        from iterative_inference_segm_tpu_torch.parallel.sharding import batch_sharding, gather_batch

        def pad_full(im):
            """A short last batch padded to the batch size (the padded rows'
            predictions are cut off again)."""
            im = np.asarray(im)
            if im.shape[0] < args.batch_size:
                im = np.concatenate([im, np.zeros((args.batch_size - im.shape[0], *im.shape[1:]), im.dtype)])
            return im

        if args.pp:
            def serve(images):
                y0, yk = refine(put_x(pad_full(images)))
                return y0[: len(images)], yk[: len(images)]
        else:
            x_sharding = batch_sharding(mesh, 4)

            def serve(images):
                # only this rank's shard crosses to its device
                y0, yk = refine(put_x(x_sharding.local(pad_full(images))))
                return gather_batch(mesh, y0)[: len(images)], gather_batch(mesh, yk)[: len(images)]

            print(f"eval batches sharded over {axis_size(mesh, 'data')} devices", flush=True)

    cm0 = cmk = None
    for bi, (images, labels) in enumerate(test_batches):
        y0, yk = serve(images)
        p0, pk = torch.argmax(y0, -1), torch.argmax(yk, -1)
        labels = torch.from_numpy(np.asarray(labels)).to(device)
        c0 = confusion_matrix(p0, labels, n_classes=cfg.n_classes)
        ck = confusion_matrix(pk, labels, n_classes=cfg.n_classes)
        cm0 = c0 if cm0 is None else cm0 + c0
        cmk = ck if cmk is None else cmk + ck
        if args.dump_dir and writer:
            from iterative_inference_segm_tpu_torch.utils.colorize import save_label_png

            os.makedirs(args.dump_dir, exist_ok=True)
            p0, pk = p0.cpu().numpy(), pk.cpu().numpy()
            for j in range(pk.shape[0]):
                save_label_png(os.path.join(args.dump_dir, f"b{bi:03d}_{j:02d}_k{num_steps}.png"), pk[j], cfg)
                save_label_png(os.path.join(args.dump_dir, f"b{bi:03d}_{j:02d}_k0.png"), p0[j], cfg)

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
