"""DAE training (the frozen FCN-8 + corruption + score network step), FCN-8
training and their scaffold, with the JAX package's exports."""

from iterative_inference_segm_tpu_torch.train.loop import (
    EarlyStopper,
    TrainConfig,
    TrainState,
    init_train_state,
    make_optimizer,
)
from iterative_inference_segm_tpu_torch.train.train_dae import train_dae
from iterative_inference_segm_tpu_torch.train.train_fcn8 import train_fcn8
