"""Shared inputs of the port's tests: small JAX models (C=5, fc 16, DAE
widths (8, 16, 32)) whose transposed-conv, tail and score weights are
random, so that a missing flip or a wrong bias path shows (the port gets the
same weights through ``utils/jax_bridge``); the CLI tests' weight files and
captured lines; reference-era Lasagne checkpoints; CamVid trees on disk."""

import contextlib
import dataclasses
import importlib.util
import io
import pathlib

import jax
import jax.numpy as jnp
import numpy as np

from iterative_inference_segm_tpu.data import config_datasets as jcfg
from iterative_inference_segm_tpu.models import dae as jdae
from iterative_inference_segm_tpu.models import fcn8 as jfcn8
from iterative_inference_segm_tpu.models.registry import checkpoint_meta, init_score_template
from iterative_inference_segm_tpu.utils.checkpoint import save_npz
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


def score_net(arch):
    """(JAX params, taps, apply kwargs) of a score network: the stem-0
    depth-4 DAE of ``jax_params``, the mirror DAE (widths 8..64, the pool4
    tap) or the context module (the input tap), their biases random so that
    a dropped one shows."""
    from iterative_inference_segm_tpu.models import registry as jreg

    if arch == "dae":
        return jax_params(stem_pool=0, depth=4)[1], ("pool4",), {"depth": 4}
    taps = ("input",) if arch == "contextmod" else ("pool4",)
    p = init_score_template(arch, jax.random.PRNGKey(5), n_classes=C, h_taps=taps, depth=4, widths=(8, 16, 32, 64))
    rng = np.random.default_rng(1)
    p = {k: {kk: jnp.asarray(rng.normal(size=v.shape).astype(np.float32) * 0.1) if kk == "b" else v
             for kk, v in lv.items()} for k, lv in p.items()}
    return p, taps, jreg.score_kwargs(arch, depth=4)


def both(tree):
    return tree, params_from_jax(tree)


def images(n=2, seed=2):
    return np.random.default_rng(seed).normal(size=(n, *HW, 3)).astype(np.float32)


def probs(shape, seed):
    z = np.random.default_rng(seed).normal(size=shape).astype(np.float32) * 2
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def lasagne_checkpoint(jparams, seed, *, conv_fc=False):
    """A full reference-era FCN-8 checkpoint for the JAX template ``jparams``:
    OIHW convs with biases, flat (or, with ``conv_fc``, OIHW) fc6/fc7, IOHW
    deconvs without bias; random values from ``seed``."""
    from iterative_inference_segm_tpu.utils.import_weights import FCN8_LASAGNE_ORDER

    rng = np.random.default_rng(seed)
    ckpt = {}
    for name, kind in FCN8_LASAGNE_ORDER:
        kh, kw, cin, cout = (int(d) for d in jparams[name]["w"].shape)
        if kind == "deconv":
            ckpt[name] = {"w": rng.normal(size=(cin, cout, kh, kw)).astype(np.float32)}
            continue
        shape = (cout, cin * kh * kw) if kind == "fc" and not conv_fc else (cout, cin, kh, kw)
        ckpt[name] = {"w": rng.normal(size=shape).astype(np.float32), "b": rng.normal(size=(cout,)).astype(np.float32)}
    return ckpt


def lasagne_positional(ckpt):
    """The named checkpoint as Lasagne's positional list, in build order."""
    from iterative_inference_segm_tpu.utils.import_weights import FCN8_LASAGNE_ORDER

    arrays = []
    for name, kind in FCN8_LASAGNE_ORDER:
        if name in ckpt:
            arrays.append(ckpt[name]["w"])
            if kind != "deconv":
                arrays.append(ckpt[name]["b"])
    return arrays


def write_camvid_tree(root, hw, counts, seed=5):
    """A CamVid layout of PNGs (``<split>/`` + ``<split>annot/``), labels
    0..11 (11 = void); ``counts`` maps split -> frames."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    for split, n in counts.items():
        (root / split).mkdir(parents=True)
        (root / f"{split}annot").mkdir()
        for i in range(n):
            Image.fromarray(rng.integers(0, 256, size=(*hw, 3), dtype=np.uint8)).save(root / split / f"f{i}.png")
            Image.fromarray(rng.integers(0, 12, size=hw).astype(np.uint8)).save(root / f"{split}annot" / f"f{i}.png")


def write_cli_npz(tmp, stem_pool, depth, tail):
    """FCN-8 (fc 64) and DAE weights with random score, tail and transposed-
    conv layers; the FCN's at scale 1.0 so that its softmax is decisive."""
    rng = np.random.default_rng(0)

    def randomize(tree, names, scale):
        return {k: ({kk: jnp.asarray(rng.normal(size=v.shape).astype(np.float32) * scale) for kk, v in lv.items()}
                    if k.startswith(names) else lv) for k, lv in tree.items()}

    fcn = randomize(jfcn8.init_fcn8(jax.random.PRNGKey(0), n_classes=11, fc_channels=64), ("up", "score"), 1.0)
    dae = init_score_template("dae", jax.random.PRNGKey(1), n_classes=11, h_taps=("pool4",), depth=depth,
                              stem_pool=stem_pool, tail=tail)
    dae = randomize(dae, ("up", "out", "score_input", "mix"), 0.3)
    save_npz(tmp / "fcn.npz", fcn)
    save_npz(tmp / "dae.npz", dae, meta=checkpoint_meta("dae", h_taps=("pool4",), depth=depth,
                                                        stem_pool=stem_pool, tail=tail))
    return ["--fcn-npz", str(tmp / "fcn.npz"), "--dae-npz", str(tmp / "dae.npz"), "--dae-depth", str(depth),
            "--dae-stem-pool", str(stem_pool), "--dae-tail", tail]


def cli_lines(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue().splitlines()


def jax_script(name):
    """The JAX package's ``scripts/<name>.py``, loaded as a module."""
    path = pathlib.Path(__file__).resolve().parent.parent / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"jax_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
