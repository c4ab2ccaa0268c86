"""The pipeline and augmentation probe twins (``iterative_inference_segm_tpu_
torch/tools/{scan_variants,aug,aug_order,aug_step}_probe.py``) on the CPU.

``scan_variants``: the pipeline rows against the JAX probe's ``pipe``
composed from the JAX package (``fcn8_apply``, ``dae_apply(out_dtype=)``,
``refinement_scan(unroll=)``), f32 compute: the f32 carry's y_K within
1e-5 of its largest entry, the bf16 carry's within two bf16 ulps of 1
with the argmax agreeing on >= 99%; the VGG prefix rows within 1e-5;
``Captured``'s launch count (through stand-ins for the CUDA graph: the
capture's launches taken back, each replay adding them). The augmentation
twins: the JAX probes' module-level functions, loaded by path, against the
twins on the same draws (the JAX probes' own, from their keys, handed over
as numpy): every crop form bit-equal, the one-hot form too in f32 on the
CPU; aug_order's (a)-(d) batches bit-equal and a step's loss against the
JAX composition (the keep-masks the JAX ``fcn8_logits`` draws from its
key) within 1e-5; aug_step's patched crop in force inside its block and
gone after. Small shapes: C = 5 (11 for the aug probes' labels), 48x64,
fc 16, DAE widths (8, 16, 32), crops of 32.
"""

import dataclasses
import importlib
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from iterative_inference_segm_tpu.inference.iterative import refinement_scan as j_scan  # noqa: E402
from iterative_inference_segm_tpu.models import dae as jdae  # noqa: E402
from iterative_inference_segm_tpu.models import fcn8 as jfcn8  # noqa: E402
from iterative_inference_segm_tpu.ops import conv as jconv  # noqa: E402
from iterative_inference_segm_tpu_torch.data.config_datasets import CAMVID  # noqa: E402
from iterative_inference_segm_tpu_torch.models.fcn8 import fc_shape  # noqa: E402
from iterative_inference_segm_tpu_torch.tools import (  # noqa: E402
    aug_order_probe,
    aug_probe,
    aug_step_probe,
    scan_variants_probe,
)
from iterative_inference_segm_tpu_torch.train.loop import TrainConfig, make_optimizer  # noqa: E402
from iterative_inference_segm_tpu_torch.utils.jax_bridge import params_from_jax  # noqa: E402
from torch_port_helpers import C, both, images, jax_params  # noqa: E402

TOOLS = pathlib.Path(__file__).resolve().parents[1] / "tools"


def jax_tool(name):
    spec = importlib.util.spec_from_file_location(f"jax_tools_{name}", TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def close(got, want, name=""):
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape, name
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()), err_msg=name)


# -- scan_variants -------------------------------------------------------------

def test_scan_variants_rows_match_jax():
    jf, jd = jax_params(stem_pool=1, depth=3, fcn_scale=0.1)
    x = images()
    tf, td = both(jf)[1], both(jd)[1]

    @jax.jit
    def want(jf, jd, x):
        y0, h = jfcn8.fcn8_apply(jf, x, return_features=("pool4",))
        out = {}
        for carry, unroll in ((jnp.float32, 1), (jnp.float32, 5), (jnp.bfloat16, 1)):
            fn = lambda y: jdae.dae_apply(jd, y, h, depth=3, out_dtype=carry)  # noqa: E731
            out[carry.__name__, unroll] = j_scan(fn, y0.astype(carry), eps=jnp.asarray(0.1, carry), num_steps=5,
                                                 mode="score", unroll=unroll)
        for n in (2, 3, 5, 9, 13, 17, len(jfcn8._VGG)):  # the last: the whole stack, pool5 too, under fc6
            h = x
            for item in jfcn8._VGG[:n]:
                h = (jax.nn.relu(jconv.conv2d(h, jf[item[0]]["w"], jf[item[0]]["b"], padding="SAME"))
                     if item != "P" else jconv.max_pool(h, window=2, stride=2, ceil_mode=True))
            out["prefix", n] = h
        for name in ("fc6", "fc7"):
            h = jax.nn.relu(jconv.conv2d(h, jf[name]["w"], jf[name]["b"], padding="SAME"))
        out["fc", 0] = h
        return out

    ref = want(jf, jd, jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(ref["float32", 1]), np.asarray(ref["float32", 5]))  # unroll: same map
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        rows = dict(scan_variants_probe.pipeline_cases(tf, td, xt, compute_dtype=torch.float32))
        assert list(rows) == ["K=5 unroll=1 f32 carry (current)", "K=5 unroll=5 f32 carry", "K=5 unroll=1 bf16 carry",
                              "K=5 unroll=5 bf16 carry"]
        y32 = scan_variants_probe.pipeline(tf, td, xt, bf16_carry=False, compute_dtype=torch.float32)
        y16 = scan_variants_probe.pipeline(tf, td, xt, bf16_carry=True, compute_dtype=torch.float32)
        close(y32, ref["float32", 1], "f32 carry")
        want16 = np.asarray(ref["bfloat16", 1].astype(jnp.float32))
        assert y16.dtype == torch.bfloat16 and np.abs(y16.float().numpy() - want16).max() <= 2.0**-7
        assert (y16.float().numpy().argmax(-1) == want16.argmax(-1)).mean() >= 0.99
        for label, fn in rows.items():
            (labels,) = fn()
            np.testing.assert_array_equal(labels.numpy(), (y32 if "f32" in label else y16).argmax(-1).numpy())
        for label, fn in scan_variants_probe.backbone_cases(tf, xt, compute_dtype=torch.float32):
            n = int(label.split()[2]) if label.startswith("VGG prefix") else None
            close(fn()[0], ref["prefix", n] if n else ref["fc", 0], label)


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_captured_counts_each_replay_as_the_launches_it_captured(monkeypatch):
    """``Captured`` on a 'cuda' device through stand-ins for the stream and
    graph calls: the warm-up call's launches count, the capture's are taken
    back, each replay adds what the capture launched."""
    import contextlib

    from iterative_inference_segm_tpu_torch.ops.refine_tail import refine_tail

    class _Stream:
        def __init__(self, *a, **k):
            pass

        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a, **k: _Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g: contextlib.nullcontext())
    monkeypatch.setattr(refine_tail, "launches", 0)
    calls = []

    def fn():
        calls.append(1)
        refine_tail.launches += 5
        return (len(calls),)

    cap = scan_variants_probe.Captured(fn, "cuda")
    assert cap() == (1,) and refine_tail.launches == 5 and cap.k3 == 5  # the warm-up ran; the capture is taken back
    assert cap() == (2,) and cap() == (2,) and len(calls) == 2  # replays return the captured outputs
    assert cap.graph.replays == 2 and refine_tail.launches == 15


# -- aug_probe ---------------------------------------------------------------

def _frames(b=2, h=48, w=64, seed=0):
    rng = np.random.default_rng(seed)
    return rng.random((b, h, w, 3), np.float32), rng.integers(0, 11, (b, h, w)).astype(np.int32)


def test_aug_rows_match_the_jax_probes_functions_bit_for_bit():
    jaug = jax_tool("aug_probe")
    image, labels = _frames()
    key, crop = jax.random.PRNGKey(7), (32, 32)
    draws = [torch.from_numpy(np.asarray(d)) for d in jaug._draws(key, 2, 48, 64, crop)]
    ti, tl = torch.from_numpy(image), torch.from_numpy(labels)
    assert [label for label, _ in aug_probe.VARIANTS] == [label for label, _ in jaug.VARIANTS]
    for (label, fn), (_, jfn) in zip(aug_probe.VARIANTS, jaug.VARIANTS):
        want_i, want_l = jax.jit(lambda k, i, lb, jfn=jfn: jfn(k, i, lb, crop))(key, image, labels)
        got_i, got_l = fn(ti, tl, *draws, crop)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i), err_msg=label)
        np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l), err_msg=label)
    assert aug_probe.equality_errors(ti, tl, *draws, crop) == {"B": 0.0, "C": 0.0, "D": 0.0}
    gen = torch.Generator().manual_seed(1)
    rows = aug_probe.cases(ti, tl, gen, crop)  # fresh draws each call, inside the frame
    (i1, l1), (i2, _) = rows[0][1](), rows[0][1]()
    assert tuple(i1.shape) == (2, 32, 32, 3) and tuple(l1.shape) == (2, 32, 32) and not torch.equal(i1, i2)


# -- aug_order_probe -----------------------------------------------------------

def test_aug_order_crops_match_jax_and_the_step_matches_its_loss():
    jord = jax_tool("aug_order_probe")
    image, labels = _frames(seed=1)
    ch = cw = 32
    draws_j = jord.draw(jax.random.PRNGKey(3), 2, 48, 64, ch, cw)
    draws = tuple(torch.from_numpy(np.asarray(d)) for d in draws_j)
    ti, tl = torch.from_numpy(image), torch.from_numpy(labels)
    for name in ("crop_dynslice", "crop_gather2d", "crop_separable"):
        want_i, want_l = jax.jit(getattr(jord, name), static_argnums=(5, 6))(image, labels, *draws_j, ch, cw)
        got_i, got_l = getattr(aug_order_probe, name)(ti, tl, *draws, ch, cw)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i), err_msg=name)
        np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l), err_msg=name)
    cfg = dataclasses.replace(CAMVID, n_classes=C, void_label=C, train_crop=(ch, cw))
    errs = aug_order_probe.batch_errors(cfg, (ti, tl % C), draws)
    assert list(errs.values()) == [0.0, 0.0, 0.0] and len(errs) == 3

    jf = jax_params(fcn_scale=0.1)[0]
    key = jax.random.PRNGKey(5)
    masks = tuple(torch.from_numpy(np.array(jax.random.bernoulli(k, 0.5, fc_shape((2, ch, cw), 16))))
                  for k in jax.random.split(key))
    from iterative_inference_segm_tpu.data.config_datasets import CAMVID as JCAMVID
    from iterative_inference_segm_tpu.data.pipeline import normalize_image
    from iterative_inference_segm_tpu.ops.losses import masked_crossentropy

    jcfg = dataclasses.replace(JCAMVID, n_classes=C, void_label=C, train_crop=(ch, cw))
    img_c, lab_c = jord.crop_gather2d(normalize_image(image, jcfg), labels % C, *draws_j, ch, cw)
    want = jax.jit(lambda p: masked_crossentropy(jfcn8.fcn8_logits(p, img_c, dropout_rng=key), lab_c, n_classes=C))(jf)
    params = params_from_jax(jf)
    before = {k: {kk: t.clone() for kk, t in v.items()} for k, v in params.items()}
    opt = make_optimizer(TrainConfig(learning_rate=1e-3), params)
    step = aug_order_probe.make_step(cfg, params, opt, order="norm_first", crop_impl=aug_order_probe.crop_gather2d,
                                     compute_dtype=torch.float32)
    close(step(ti, tl % C, draws, masks), float(want), "the step's loss")
    assert not torch.equal(params["fc6"]["w"], before["fc6"]["w"])  # Adam moved the params
    assert [label for label, _, _ in aug_order_probe.CELLS] == [
        "(a) normalize-full -> dynslice crop (shipped)", "(b) dynslice crop -> normalize crop",
        "(c) 2-D gather crop, folded flip", "(d) separable take_along_axis, folded flip", "(e) pre-cropped floor"]


# -- aug_step_probe -------------------------------------------------------------

def test_aug_step_clone_matches_jax_and_the_patch_is_in_force_inside_its_block():
    tf_mod = importlib.import_module("iterative_inference_segm_tpu_torch.train.train_fcn8")
    jstep = jax_tool("aug_step_probe")
    jord = jax_tool("aug_order_probe")
    image, labels = _frames(seed=2)
    key, crop = jax.random.PRNGKey(9), (32, 32)
    want_i, want_l = jax.jit(lambda k, i, lb: jstep.no_barrier_crop_and_flip(k, i, lb, crop=crop))(key, image, labels)
    draws = [torch.from_numpy(np.asarray(d)) for d in jord.draw(key, 2, 48, 64, *crop)]  # the clone's own draws
    got_i, got_l = aug_step_probe.no_barrier_crop_and_flip(torch.from_numpy(image), torch.from_numpy(labels), *draws,
                                                           crop=crop)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    shipped = tf_mod.crop_and_flip
    with aug_step_probe.patched_crop(aug_step_probe.no_barrier_crop_and_flip) as calls:
        out = tf_mod.crop_and_flip(torch.from_numpy(image), torch.from_numpy(labels), *draws, crop=crop)
        assert len(calls) == 1 and torch.equal(out[0], got_i)
    assert tf_mod.crop_and_flip is shipped
    with pytest.raises(RuntimeError), aug_step_probe.patched_crop(aug_step_probe.no_barrier_crop_and_flip):
        raise RuntimeError("a failing cell")
    assert tf_mod.crop_and_flip is shipped  # taken off in the finally
