"""Convolution/pooling ops (cuDNN through ``torch.nn.functional``), losses,
metrics, the corruption ops and the hand-written kernels, with the JAX
package's exports (the kernels' wrappers load nothing at import)."""

from iterative_inference_segm_tpu_torch.ops.conv import (
    bilinear_kernel,
    conv2d,
    conv_transpose2d,
    crop_to,
    init_conv,
    init_conv_transpose_bilinear,
    max_pool,
)
from iterative_inference_segm_tpu_torch.ops.corruption import corrupt_onehot, one_hot_probs
from iterative_inference_segm_tpu_torch.ops.losses import l2_regularization, masked_crossentropy
from iterative_inference_segm_tpu_torch.ops.metrics import SegMetrics, confusion_matrix, jaccard, pixel_accuracy
