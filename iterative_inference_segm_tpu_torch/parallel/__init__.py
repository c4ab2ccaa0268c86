"""Parallelism over ``torch.distributed``: meshes, placements, data-,
tensor- and pipeline-parallel steps (port of
``iterative_inference_segm_tpu.parallel``).

One process a device (``launch``), each holding its part: DP averages the
gradients with one all-reduce a step (``dp``), TP splits the fc6/fc7 pair
over a 'model' axis (``tp``), PP streams microbatches through per-stage
ranks for serving and, through ``torch.autograd``, for training (``pp``),
and spatial sharding splits H over a 'space' axis with explicit halo
exchanges (``spatial``; XLA inserts them for the JAX package).
"""

from iterative_inference_segm_tpu_torch.parallel.mesh import local_device_count, make_mesh
from iterative_inference_segm_tpu_torch.parallel.pp import (
    make_gpipe,
    make_gpipe_stacked,
    make_pp_flagship,
    merge_microbatches,
    split_microbatches,
)
from iterative_inference_segm_tpu_torch.parallel.sharding import (
    batch_sharding,
    replicate,
    replicated_sharding,
    shard_batch,
)
from iterative_inference_segm_tpu_torch.parallel.tp import shard_params_tp, tp_shardings
