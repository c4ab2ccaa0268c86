"""Probes run on the card, as
``python -m iterative_inference_segm_tpu_torch.tools.<name>``."""
