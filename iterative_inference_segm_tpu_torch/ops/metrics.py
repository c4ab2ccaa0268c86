"""Segmentation metrics: confusion matrix, per-class IoU, accuracy.

Port of ``iterative_inference_segm_tpu.ops.metrics``. The confusion matrix
is one ``torch.bincount`` over the valid pixels, on the device of its
inputs; labels outside [0, C) are void and excluded, predictions are
clipped into [0, C).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SegMetrics(NamedTuple):
    per_class_iou: torch.Tensor  # (C,) f32; 0 where the class is absent
    mean_iou: torch.Tensor  # scalar, mean over classes present in the union
    pixel_accuracy: torch.Tensor  # scalar
    valid_pixels: torch.Tensor  # scalar int


def confusion_matrix(pred: torch.Tensor, labels: torch.Tensor, *, n_classes: int) -> torch.Tensor:
    """(C, C) int64 counts over non-void pixels; rows = true, cols = pred."""
    valid = (labels >= 0) & (labels < n_classes)
    t = labels[valid].to(torch.int64)
    p = torch.clamp(pred[valid], 0, n_classes - 1).to(torch.int64)
    counts = torch.bincount(t * n_classes + p, minlength=n_classes * n_classes)
    return counts.reshape(n_classes, n_classes)


def metrics_from_confusion(cm: torch.Tensor) -> SegMetrics:
    """Per-class IoU / mIoU / accuracy from a (C, C) confusion matrix."""
    cm = cm.to(torch.float32)
    diag = torch.diagonal(cm)
    row = cm.sum(dim=1)
    col = cm.sum(dim=0)
    union = row + col - diag
    present = union > 0
    iou = torch.where(present, diag / torch.clamp(union, min=1.0), torch.zeros_like(diag))
    mean_iou = iou.sum() / torch.clamp(present.sum(), min=1)
    total = cm.sum()
    acc = diag.sum() / torch.clamp(total, min=1.0)
    return SegMetrics(
        per_class_iou=iou, mean_iou=mean_iou, pixel_accuracy=acc,
        valid_pixels=total.to(torch.int32),
    )


def jaccard(pred: torch.Tensor, labels: torch.Tensor, *, n_classes: int) -> SegMetrics:
    """One-shot per-class IoU for a batch (accumulate the confusion matrix
    across batches for dataset-level numbers)."""
    return metrics_from_confusion(confusion_matrix(pred, labels, n_classes=n_classes))


def pixel_accuracy(pred: torch.Tensor, labels: torch.Tensor, *, n_classes: int) -> torch.Tensor:
    valid = (labels >= 0) & (labels < n_classes)
    correct = (pred == labels) & valid
    return correct.sum() / torch.clamp(valid.sum(), min=1)
