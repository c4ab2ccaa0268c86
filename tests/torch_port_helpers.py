"""Shared inputs of the port's slice-3 tests: small JAX models (C=5, fc 16,
DAE widths (8, 16, 32)) whose transposed-conv, tail and score weights are
random, so that a missing flip or a wrong bias path shows; the port gets
the same weights through ``utils/jax_bridge``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from iterative_inference_segm_tpu.data import config_datasets as jcfg
from iterative_inference_segm_tpu.models import dae as jdae
from iterative_inference_segm_tpu.models import fcn8 as jfcn8
from iterative_inference_segm_tpu_torch.data import config_datasets as tcfg
from iterative_inference_segm_tpu_torch.utils.jax_bridge import params_from_jax

C = 5
HW = (48, 64)
TINY_J = dataclasses.replace(jcfg.CAMVID, n_classes=C, void_label=C, height=HW[0], width=HW[1])
TINY_T = dataclasses.replace(tcfg.CAMVID, n_classes=C, void_label=C, class_names=tcfg.CAMVID.class_names[:C])

_RANDOM_LAYERS = ("out", "score_input", "score_enc1", "mix", "score_input_dw")


def randomized(tree, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    out = {}
    for k, lv in tree.items():
        if k.startswith("up") or k in _RANDOM_LAYERS:
            lv = {kk: jnp.asarray(rng.normal(size=v.shape).astype(np.float32) * scale) for kk, v in lv.items()}
        out[k] = lv
    return out


def jax_params(stem_pool=1, depth=3, tail="full", encoder_seed=1, fcn_scale=0.3, n_classes=C, dae_scale=0.3):
    fcn = randomized(jfcn8.init_fcn8(jax.random.PRNGKey(0), n_classes=n_classes, fc_channels=16), 0, fcn_scale)
    dae = randomized(jdae.init_dae(
        jax.random.PRNGKey(encoder_seed), n_classes=n_classes, h_specs={"pool4": 512}, depth=depth,
        stem_pool=stem_pool, widths=(8, 16, 32, 64)[:depth], tail=tail,
    ), encoder_seed, dae_scale)
    return fcn, dae


def both(tree):
    return tree, params_from_jax(tree)


def images(n=2, seed=2):
    return np.random.default_rng(seed).normal(size=(n, *HW, 3)).astype(np.float32)


def probs(shape, seed):
    z = np.random.default_rng(seed).normal(size=shape).astype(np.float32) * 2
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)
