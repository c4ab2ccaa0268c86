"""Convolution/pooling ops (cuDNN through ``torch.nn.functional``), losses,
metrics, the corruption ops and the hand-written kernels."""
