"""Checkpoints (flat npz, training state, sharded restore), the
JAX-parameter bridge and experiment logging, with the JAX package's
exports."""

from iterative_inference_segm_tpu_torch.utils.checkpoint import (
    load_npz,
    restore_checkpoint,
    restore_checkpoint_sharded,
    save_checkpoint,
    save_npz,
)
from iterative_inference_segm_tpu_torch.utils.colorize import colorize_labels, save_label_png
from iterative_inference_segm_tpu_torch.utils.experiment import MetricLogger, build_experiment_name
