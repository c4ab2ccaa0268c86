"""The port's ``utils/import_weights``, ``utils/colorize`` and
``utils/profiling`` against the JAX package's on the same inputs: the numpy
converters equal, every import (VGG overlay, the full reference FCN-8 in
its flat and conv forms, with and without the deconv flip, the positional
Lasagne npz in full and VGG-only, the mirror DAE tied and untied) bit-equal
to the JAX import carried across by ``params_from_jax``, the same refusals;
the colorized labels and PNGs equal; and the profiling surface on the CPU
(a trace that writes a Chrome trace, a disabled trace).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
from PIL import Image  # noqa: E402

from iterative_inference_segm_tpu.data import config_datasets as jcfg  # noqa: E402
from iterative_inference_segm_tpu.models import fcn8 as jfcn8  # noqa: E402
from iterative_inference_segm_tpu.models.registry import init_score_template as j_init_score  # noqa: E402
from iterative_inference_segm_tpu.utils import colorize as jcol  # noqa: E402
from iterative_inference_segm_tpu.utils import import_weights as jiw  # noqa: E402
from iterative_inference_segm_tpu_torch.data import config_datasets as tcfg  # noqa: E402
from iterative_inference_segm_tpu_torch.utils import colorize as tcol  # noqa: E402
from iterative_inference_segm_tpu_torch.utils import import_weights as tiw  # noqa: E402
from iterative_inference_segm_tpu_torch.utils import profiling  # noqa: E402
from iterative_inference_segm_tpu_torch.utils.jax_bridge import params_from_jax, params_to_jax  # noqa: E402
from torch_port_helpers import lasagne_checkpoint, lasagne_positional  # noqa: E402


def _assert_same_tree(got, want_jax):
    want = params_from_jax(want_jax)
    assert sorted(got) == sorted(want)
    for layer in want:
        assert sorted(got[layer]) == sorted(want[layer]), layer
        for leaf, w in want[layer].items():
            assert got[layer][leaf].dtype == w.dtype and torch.equal(got[layer][leaf], w), (layer, leaf)


# ---------------------------------------------------------------- converters


def test_converters_equal_the_jax_converters():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(4, 3, 2, 5)).astype(np.float32)
    np.testing.assert_array_equal(tiw.oihw_to_hwio(w), jiw.oihw_to_hwio(w))
    for flip in (False, True):
        np.testing.assert_array_equal(tiw.deconv_iohw_to_hwio(w, flip=flip), jiw.deconv_iohw_to_hwio(w, flip=flip))
    fc = rng.normal(size=(7, 5 * 2 * 3)).astype(np.float32)
    np.testing.assert_array_equal(tiw.fc_to_conv_hwio(fc, 2, 3, 5), jiw.fc_to_conv_hwio(fc, 2, 3, 5))
    np.testing.assert_array_equal(tiw.fc_to_conv1x1_hwio(fc), jiw.fc_to_conv1x1_hwio(fc))
    assert tiw.FCN8_LASAGNE_ORDER == jiw.FCN8_LASAGNE_ORDER and tiw.FCN8_HEAD_LAYERS == jiw.FCN8_HEAD_LAYERS
    for mod in (jiw, tiw):
        with pytest.raises(ValueError):
            mod.fc_to_conv_hwio(np.zeros((4, 10)), 2, 2, 3)
        with pytest.raises(ValueError):
            mod.oihw_to_hwio(np.zeros((4, 10)))
        with pytest.raises(ValueError):
            mod.fc_to_conv1x1_hwio(np.zeros((4, 10, 1)))


# ---------------------------------------------------------------- FCN-8 imports


@pytest.fixture(scope="module")
def fcn():
    """The JAX FCN-8 template (C = 3, fc 8) and the port's image of it."""
    jparams = jfcn8.init_fcn8(jax.random.PRNGKey(0), n_classes=3, fc_channels=8)
    return jparams, params_from_jax(jparams)


IMPORT_CASES = {
    "vgg_overlay": lambda ck: (lambda m, p: m.import_vgg16_oihw({"conv1_1": ck["conv1_1"], "conv4_2": ck["conv4_2"]},
                                                                  p)),
    "reference_strict": lambda ck: (lambda m, p: m.import_fcn8_reference(ck, p, strict=True)),
    "reference_flipped": lambda ck: (lambda m, p: m.import_fcn8_reference(ck, p, flip_deconvs=True)),
    "reference_heads_only": lambda ck: (lambda m, p: m.import_fcn8_reference(
        {k: v for k, v in ck.items() if k.startswith(("score", "up"))}, p)),
}


@pytest.mark.parametrize("conv_fc", [False, True])
@pytest.mark.parametrize("case", list(IMPORT_CASES))
def test_fcn8_imports_are_the_jax_imports(fcn, case, conv_fc):
    jparams, tparams = fcn
    ckpt = lasagne_checkpoint(jparams, 3, conv_fc=conv_fc)
    call = IMPORT_CASES[case](ckpt)
    got = call(tiw, tparams)
    _assert_same_tree(got, call(jiw, jparams))
    if case == "reference_flipped":  # the flip reached the port's transposed kernels
        plain = tiw.import_fcn8_reference(ckpt, tparams)
        assert not torch.equal(got["upscore2"]["w"], plain["upscore2"]["w"])
    if case == "vgg_overlay":  # untouched layers keep the template, bit for bit
        assert torch.equal(got["conv1_2"]["w"], tparams["conv1_2"]["w"])
        assert torch.equal(got["upscore8"]["w"], tparams["upscore8"]["w"])


@pytest.mark.parametrize("what", ["full", "vgg_only", "flipped"])
def test_lasagne_npz_imports_are_the_jax_imports(fcn, what, tmp_path):
    jparams, tparams = fcn
    ckpt = lasagne_checkpoint(jparams, 5)
    if what == "vgg_only":
        ckpt = {n: ckpt[n] for n in jiw.VGG16_CONV_NAMES}
    np.savez(tmp_path / "ref.npz", *lasagne_positional(ckpt))
    kw = {"flip_deconvs": True} if what == "flipped" else {"strict": what == "full"}
    got = tiw.import_lasagne_npz(tmp_path / "ref.npz", tparams, **kw)
    _assert_same_tree(got, jiw.import_lasagne_npz(tmp_path / "ref.npz", jparams, **kw))
    named = tiw.group_lasagne_arrays(lasagne_positional(ckpt), params_to_jax(tparams))
    want = jiw.group_lasagne_arrays(lasagne_positional(ckpt), jparams)
    assert sorted(named) == sorted(want)
    for name in want:
        assert sorted(named[name]) == sorted(want[name])
        for leaf in want[name]:
            np.testing.assert_array_equal(named[name][leaf], want[name][leaf])


REFUSALS = {
    "strict_missing": (KeyError, lambda m, p, tmp: m.import_vgg16_oihw({}, p, strict=True)),
    "strict_reference_missing": (KeyError, lambda m, p, tmp: m.import_fcn8_reference({}, p, strict=True)),
    "shape_mismatch": (ValueError, lambda m, p, tmp: m.import_vgg16_oihw(
        {"conv1_1": {"w": np.zeros((64, 4, 3, 3), np.float32), "b": np.zeros(64, np.float32)}}, p)),
    "garbage_npz": (ValueError, lambda m, p, tmp: (np.savez(tmp / "bad.npz", np.zeros((7, 7, 7))),
                                                   m.import_lasagne_npz(tmp / "bad.npz", p))),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_imports_refuse_what_jax_refuses(fcn, case, tmp_path):
    exc, call = REFUSALS[case]
    for mod, params in zip((jiw, tiw), fcn):
        with pytest.raises(exc):
            call(mod, params, tmp_path)


def test_imported_fcn_runs_as_the_jax_one(fcn):
    """The port's FCN-8 with the imported weights gives the JAX FCN-8's
    probabilities with the JAX import (f32, 1e-5)."""
    from iterative_inference_segm_tpu_torch.models.fcn8 import fcn8_apply

    jparams, tparams = fcn
    ckpt = lasagne_checkpoint(jparams, 7)
    x = np.random.default_rng(8).normal(size=(1, 32, 32, 3)).astype(np.float32)
    want, _ = jfcn8.fcn8_apply(jiw.import_fcn8_reference(ckpt, jparams), jax.numpy.asarray(x))
    with torch.no_grad():
        got, _ = fcn8_apply(tiw.import_fcn8_reference(ckpt, tparams), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- mirror DAE


@pytest.mark.parametrize("tied", [False, True])
def test_mirror_dae_npz_import_is_the_jax_import(tied, tmp_path):
    jparams = j_init_score("mirror", jax.random.PRNGKey(1), n_classes=3, h_taps=("pool4",), depth=4,
                           widths=(4, 4, 8, 8), tied=tied)
    tparams = params_from_jax(jparams)
    rng = np.random.default_rng(2)
    arrays = []
    order = ["enc1", "enc2", "enc3", "enc4", "mid", "dec4", "dec3", "dec2", "dec1", "out"]
    assert "mid" in jparams
    for name in order:
        if "w" in jparams[name]:
            kh, kw, cin, cout = jparams[name]["w"].shape
            arrays.append(rng.normal(size=(cout, cin, kh, kw)).astype(np.float32))
        arrays.append(rng.normal(size=jparams[name]["b"].shape).astype(np.float32))
    np.savez(tmp_path / "mirror.npz", *arrays)
    got = tiw.import_mirror_dae_npz(tmp_path / "mirror.npz", tparams)
    _assert_same_tree(got, jiw.import_mirror_dae_npz(tmp_path / "mirror.npz", jparams))
    np.savez(tmp_path / "short.npz", *arrays[:-1])
    for mod, params in ((jiw, jparams), (tiw, tparams)):
        with pytest.raises(ValueError, match="mirror-DAE import"):
            mod.import_mirror_dae_npz(tmp_path / "short.npz", params)


# ---------------------------------------------------------------- colorize


@pytest.mark.parametrize("name", ["camvid", "em", "polyps"])
def test_colorize_matches_jax(name, tmp_path):
    jc, tc = jcfg.DATASET_CONFIGS[name], tcfg.DATASET_CONFIGS[name]
    labels = np.random.default_rng(3).integers(-2, jc.n_classes + 3, size=(6, 9))
    got = tcol.colorize_labels(labels, tc)
    np.testing.assert_array_equal(got, jcol.colorize_labels(labels, jc))
    assert got.dtype == np.uint8 and got.shape == (6, 9, 3)
    np.testing.assert_array_equal(got[labels >= jc.n_classes], np.broadcast_to(tc.palette[-1], got[labels >= jc.n_classes].shape))
    jcol.save_label_png(tmp_path / "j.png", labels, jc)
    tcol.save_label_png(tmp_path / "t.png", labels, tc)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "t.png")), np.asarray(Image.open(tmp_path / "j.png")))


# ---------------------------------------------------------------- profiling


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir)):
        torch.ones((16, 16)) @ torch.ones((16, 16))
    events = json.loads((logdir / profiling.TRACE_FILE).read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_trace_disabled_is_a_noop(tmp_path):
    logdir = tmp_path / "off"
    with profiling.trace(str(logdir), enabled=False):
        pass
    assert not logdir.exists()
