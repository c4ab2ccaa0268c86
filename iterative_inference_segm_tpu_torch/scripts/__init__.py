"""Command-line entry points, run as
``python -m iterative_inference_segm_tpu_torch.scripts.<name>``."""
