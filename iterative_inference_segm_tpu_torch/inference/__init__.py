"""The refinement engines (general and pooled-scale), the (eps, K) search
and the serving ``Predictor`` (port)."""

from iterative_inference_segm_tpu_torch.inference.fused import (
    flagship_forward_fn,
    halfres_refine,
    halfres_refinement_scan,
    make_fused_refiner,
    make_half_refiner,
)
from iterative_inference_segm_tpu_torch.inference.iterative import (
    make_refiner,
    refine_with_trajectory,
    refinement_scan,
)
from iterative_inference_segm_tpu_torch.inference.predictor import Predictor
from iterative_inference_segm_tpu_torch.inference.search import (
    grid_search_eps_k,
    grid_search_eps_k_half,
)
