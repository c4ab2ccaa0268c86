"""The batch sources of the two trainer CLIs, from their data flags.

Both JAX trainer CLIs build them the same way (``scripts/train_dae.py:123-173``,
``scripts/train_fcn8.py:88-138``); the port's twins share this copy:

* ``--packed DIR``: ``DIR/{train,val}.iist`` through the native runtime,
  the training split reshuffled each epoch with seed ``--seed + n``. On the
  f32 wire the runtime normalizes on the host; on the u8 wire the bytes
  cross to the device and the step normalizes there (``input_scale`` 255)
  with the train file header's statistics, not the ``--dataset`` config's.
* ``--synthetic``, or no ``--data-root``: the synthetic scenes.
* ``--data-root ROOT``: the disk loaders (Pillow), the training split
  reshuffled each epoch through ``epoch_reshuffled``.
"""

from __future__ import annotations

import dataclasses
import os

from iterative_inference_segm_tpu_torch.data.config_datasets import DatasetConfig


def train_sources(args, cfg: DatasetConfig, *, height: int | None, width: int | None):
    """``(cfg, train_data, val_data, step_kwargs)``: the config the step
    uses, the two batch factories (one iterator per call) and the step's
    ``normalize`` / ``input_scale``."""
    raw_wire = args.wire == "u8"
    if args.packed:
        from iterative_inference_segm_tpu_torch.data.native_loader import NativeDataset

        train_ds = NativeDataset(os.path.join(args.packed, "train.iist"))
        val_ds = NativeDataset(os.path.join(args.packed, "val.iist"))
        if raw_wire:
            cfg = dataclasses.replace(cfg, mean=train_ds.mean, std=train_ds.std)
        epoch = {"n": 0}

        def train_data():
            epoch["n"] += 1
            return train_ds.batches(args.batch_size, shuffle=True, seed=args.seed + epoch["n"], raw=raw_wire)

        def val_data():
            return val_ds.batches(args.batch_size, raw=raw_wire)
    elif args.synthetic or not args.data_root:
        from iterative_inference_segm_tpu_torch.data.synthetic import synthetic_batches

        def train_data():
            return synthetic_batches(
                cfg=cfg, batch_size=args.batch_size, num_batches=args.num_train_batches,
                height=height, width=width, seed=args.seed,
            )

        def val_data():
            return synthetic_batches(
                cfg=cfg, batch_size=args.batch_size, num_batches=args.num_val_batches,
                height=height, width=width, seed=args.seed + 10_000,
            )
    else:
        from iterative_inference_segm_tpu_torch.data.camvid import iterate_split
        from iterative_inference_segm_tpu_torch.data.loaders import epoch_reshuffled, load_dataset_split

        tr_i, tr_l = load_dataset_split(args.dataset, args.data_root, "train", cfg)
        va_i, va_l = load_dataset_split(args.dataset, args.data_root, "val", cfg)
        train_data = epoch_reshuffled(
            lambda seed: iterate_split(tr_i, tr_l, batch_size=args.batch_size, shuffle=True, seed=seed),
            args.seed,
        )

        def val_data():
            return iterate_split(va_i, va_l, batch_size=args.batch_size)

    # the f32 packed wire arrives normalized; the u8 wire and the unpacked
    # sources are normalized in the step
    step_kwargs = {"normalize": not args.packed or raw_wire,
                   "input_scale": 255.0 if (args.packed and raw_wire) else 1.0}
    return cfg, train_data, val_data, step_kwargs
