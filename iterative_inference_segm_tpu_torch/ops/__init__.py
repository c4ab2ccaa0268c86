"""Convolution/pooling ops (cuDNN through ``torch.nn.functional``) and the
hand-written refinement-tail kernel."""
