"""Pack a dataset into the IIST1 format consumed by the native input runtime
(PyTorch port).

The twin of the JAX package's ``scripts/pack_dataset.py``: the same flags,
printed lines and files, byte for byte. Sources:
  --from-dir <root>      on-disk dataset at <root> in its native layout
                         (--dataset selects the family; needs Pillow)
  --from-camvid <root>   alias for --dataset camvid --from-dir <root>
  --synthetic            generated structured scenes (the port's
                         synthetic_example, seed for seed the JAX one's)

Examples:
    python -m iterative_inference_segm_tpu_torch.scripts.pack_dataset \\
        --synthetic --out /tmp/camvid_synth --num-train 64 --num-val 16
    python -m iterative_inference_segm_tpu_torch.scripts.pack_dataset \\
        --dataset em --from-dir /data/isbi --out /data/packed_em
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset", default="camvid", choices=["camvid", "em", "polyps"])
    p.add_argument("--from-dir", default=None, help="dataset directory root (native layout)")
    p.add_argument("--from-camvid", default=None, help="alias: --dataset camvid --from-dir ROOT")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--out", required=True, help="output directory for <split>.iist files")
    p.add_argument("--num-train", type=int, default=64)
    p.add_argument("--num-val", type=int, default=16)
    p.add_argument("--num-test", type=int, default=16)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--width", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from iterative_inference_segm_tpu_torch.data.config_datasets import DATASET_CONFIGS
    from iterative_inference_segm_tpu_torch.data.native_loader import pack_dataset

    # as in the JAX script, the config is taken before --from-camvid sets
    # the dataset (it is camvid by default)
    cfg = DATASET_CONFIGS[args.dataset]
    os.makedirs(args.out, exist_ok=True)

    if args.from_camvid and not args.from_dir:
        args.from_dir = args.from_camvid
        args.dataset = "camvid"
    if args.from_dir:
        from iterative_inference_segm_tpu_torch.data.loaders import load_dataset_split

        for split in ("train", "val", "test"):
            images, labels = load_dataset_split(args.dataset, args.from_dir, split, cfg)
            out = os.path.join(args.out, f"{split}.iist")
            pack_dataset(out, images, labels, cfg)
            print(f"packed {split}: {images.shape[0]} samples -> {out}")
    elif args.synthetic:
        from iterative_inference_segm_tpu_torch.data.synthetic import synthetic_example

        counts = {"train": args.num_train, "val": args.num_val, "test": args.num_test}
        for si, (split, n) in enumerate(counts.items()):
            rng = np.random.default_rng(args.seed + 1000 * si)
            pairs = [
                synthetic_example(rng, cfg, height=args.height, width=args.width)
                for _ in range(n)
            ]
            images = np.stack([im for im, _ in pairs])
            labels = np.stack([lb for _, lb in pairs])
            out = os.path.join(args.out, f"{split}.iist")
            pack_dataset(out, images, labels, cfg)
            print(f"packed {split}: {n} samples -> {out}")
    else:
        p.error("one of --from-dir / --synthetic is required")
    return 0


if __name__ == "__main__":
    sys.exit(main())
