"""Data layer: dataset configs, disk loaders, the native packed runtime,
synthetic scenes, device prefetch and on-device preprocessing.

The port of ``iterative_inference_segm_tpu.data``, with the same exports
(the JAX-only names aside: the port's crop takes a ``torch.Generator``)."""

from iterative_inference_segm_tpu_torch.data.camvid import iterate_split, load_split
from iterative_inference_segm_tpu_torch.data.config_datasets import DATASET_CONFIGS, DatasetConfig
from iterative_inference_segm_tpu_torch.data.loaders import load_dataset_split
from iterative_inference_segm_tpu_torch.data.native_loader import NativeDataset, pack_dataset
from iterative_inference_segm_tpu_torch.data.pipeline import (
    eval_preprocess,
    normalize_image,
    random_crop_and_flip,
)
from iterative_inference_segm_tpu_torch.data.prefetch import device_prefetch
from iterative_inference_segm_tpu_torch.data.synthetic import synthetic_batches, synthetic_example
