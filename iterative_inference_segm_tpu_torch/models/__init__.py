"""FCN-8 segmenter, the conditional DAE score network and the score-network
registry (port), with the JAX package's exports."""

from iterative_inference_segm_tpu_torch.models.contextmod import contextmod_apply, init_contextmod
from iterative_inference_segm_tpu_torch.models.dae import DAE_H_CHANNELS, dae_apply, init_dae
from iterative_inference_segm_tpu_torch.models.dae_mirror import init_mirror_dae, mirror_dae_apply
from iterative_inference_segm_tpu_torch.models.fcn8 import FCN8_FEATURES, fcn8_apply, init_fcn8
