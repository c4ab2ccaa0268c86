"""iterative_inference_segm_tpu_torch — the PyTorch/CUDA port of
``iterative_inference_segm_tpu``.

Same module paths and function names as the JAX package, so each function's
counterpart is found by name; the JAX package stays the reference the port is
tested against. Public functions keep the JAX layout (NHWC, class last); the
convolutions run on cuDNN through ``torch.nn.functional`` and the refinement
tail (crop + add + softmax + blend [+ argmax]) runs in a hand-written CUDA
kernel (``ops/refine_tail.py``, ``csrc/refine_tail.cu``).

The package imports ``torch`` and ``numpy`` only — never ``jax`` or the JAX
package: the machine with the GPU has neither installed.
"""

__version__ = "0.1.0"
