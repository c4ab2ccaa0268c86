"""The port's general refinement engine (``inference/iterative.py``), the
general-engine ``Predictor``, its default engine, and the half engine's
energy mode, against the JAX package on the same numpy inputs and the same
(bridged) weights, on the CPU.

The public functions take JAX's callables: ``refinement_scan`` and
``refine_with_trajectory`` a probability function (run plain), and
``make_refiner`` the score network's probability apply, which it maps to
its logits twin for the loop that launches K3 (``logits_refinement_scan``).
``test_general_engine_takes_jaxs_calls`` calls each as JAX calls it, with
each of the three applies, at eps = 0.5 and K = 3 (where a logits function
mistaken for a probability one once took the softmax twice): within 1e-5 of
the map's largest entry and the argmax agreeing on >= 99.9%.

The engine tests hand both packages the same ``y0`` and conditioning taps
(from the JAX FCN), so they hold the refinement alone. Tolerances, f32:
1e-5 (the kernel's blend ``(1-eps) y + eps r`` against the JAX package's
``y - eps (y - r)`` differs by a few ulps a step; energy gradients sum the
DAE's backward in another order); whole ``Predictor`` paths, which also run
both FCNs, 1e-5 on the probabilities with equal labels. One exception: the
energy gradient is discontinuous where a DAE pre-activation crosses 0 (ReLU)
or a max-pool window changes its maximum, so the FCNs' last-ulp differences
move a few gradient entries by far more than an ulp; the whole-path energy
``Predictor`` with the full-resolution (stem_pool=0) DAE is held to 1e-4
(measured: 6 of 46080 values beyond 1e-5, the largest 1.5e-5), and
``make_refiner`` is held at 1e-5 with both sides given the same FCN.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch_port_helpers import TINY_J, TINY_T, both, images, jax_params, score_net  # noqa: E402

from iterative_inference_segm_tpu.inference import fused as jfused  # noqa: E402
from iterative_inference_segm_tpu.inference import iterative as jit_  # noqa: E402
from iterative_inference_segm_tpu.inference.predictor import Predictor as JPredictor  # noqa: E402
from iterative_inference_segm_tpu.models import contextmod as jctx  # noqa: E402
from iterative_inference_segm_tpu.models import dae as jdae  # noqa: E402
from iterative_inference_segm_tpu.models import dae_mirror as jmir  # noqa: E402
from iterative_inference_segm_tpu.models import fcn8 as jfcn8  # noqa: E402
from iterative_inference_segm_tpu_torch.inference import fused as tfused  # noqa: E402
from iterative_inference_segm_tpu_torch.inference import iterative as tit  # noqa: E402
from iterative_inference_segm_tpu_torch.inference.predictor import Predictor  # noqa: E402
from iterative_inference_segm_tpu_torch.models import contextmod as tctx  # noqa: E402
from iterative_inference_segm_tpu_torch.models import dae as tdae  # noqa: E402
from iterative_inference_segm_tpu_torch.models import dae_mirror as tmir  # noqa: E402
from iterative_inference_segm_tpu_torch.models import fcn8 as tfcn8  # noqa: E402
from iterative_inference_segm_tpu_torch.models import registry as treg  # noqa: E402
from iterative_inference_segm_tpu_torch.utils.jax_bridge import params_from_jax  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
EPS = 0.3


@pytest.fixture(scope="module")
def general():
    """A stem_pool=0 DAE (the general engine's default layout) with the FCN's
    y0 and pool4 tap, in both packages."""
    jf, jd = jax_params(stem_pool=0, depth=4)
    y0, h = jfcn8.fcn8_apply(jf, jnp.asarray(images()), return_features=("pool4",))
    ty0 = torch.from_numpy(np.asarray(y0))
    th = {k: torch.from_numpy(np.asarray(v)) for k, v in h.items()}
    return {"jf": jf, "jd": jd, "tf": both(jf)[1], "td": both(jd)[1], "y0": y0, "h": h,
            "ty0": ty0, "th": th}


def _fns(g, depth=4):
    """The JAX probability function and the port's: the same apply (``path
    'apply'``), or its logits twin for ``logits_refinement_scan``."""
    jfn = lambda y: jdae.dae_apply(g["jd"], y, g["h"], depth=depth)  # noqa: E731
    tfn = lambda y: tdae.dae_apply(g["td"], y, g["th"], depth=depth)  # noqa: E731
    tlogits = lambda y: tdae.dae_logits(g["td"], y, g["th"], depth=depth)  # noqa: E731
    return jfn, tfn, tlogits


_JAX_RUNS = {}


def _jax_run(g, fn, **kw):
    """A JAX engine run on ``general``'s inputs, once per keyword set."""
    key = (fn, tuple(sorted(kw.items())))
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = np.asarray(fn(_fns(g)[0], g["y0"], **kw))
    return _JAX_RUNS[key]


def _port_run(g, path, **kw):
    """The port's ``refinement_scan`` on the apply, or (``path 'logits'``)
    ``logits_refinement_scan`` on its logits twin; with ``trajectory`` the
    trajectory function of each."""
    _, tfn, tlogits = _fns(g)
    trajectory = kw.pop("trajectory", False)
    if path == "logits":
        return tit.logits_refinement_scan(tlogits, g["ty0"], trajectory=trajectory, **kw)
    return (tit.refine_with_trajectory if trajectory else tit.refinement_scan)(tfn, g["ty0"], **kw)


@pytest.mark.parametrize("path", ["apply", "logits"])
@pytest.mark.parametrize("mode", ["score", "energy"])
@pytest.mark.parametrize("renorm", ["none", "softmax"])
def test_refinement_scan_matches_jax(general, mode, renorm, path):
    kw = dict(eps=EPS, num_steps=3, mode=mode, renorm=renorm)
    want = _jax_run(general, jit_.refinement_scan, **kw)
    with tfused.no_autograd(mode):
        got = _port_run(general, path, **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert np.abs(want - np.asarray(general["y0"])).max() > 1e-3  # the steps moved y


@pytest.mark.parametrize("path", ["apply", "logits"])
@pytest.mark.parametrize("mode", ["score", "energy"])
def test_refine_with_trajectory_matches_jax(general, mode, path):
    kw = dict(eps=EPS, num_steps=3, mode=mode)
    want = _jax_run(general, jit_.refine_with_trajectory, **kw)
    with tfused.no_autograd(mode):
        got = _port_run(general, path, trajectory=True, **kw)
        last = _port_run(general, path, **kw)
    assert tuple(got.shape) == (4, 2, 48, 64, 5)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert torch.equal(got[0], general["ty0"]) and torch.equal(got[-1], last)


def test_refinement_scan_takes_jaxs_unroll(general):
    """``unroll`` (JAX's ``lax.scan`` knob) is accepted and changes nothing:
    the loop is Python's."""
    _, tfn, _ = _fns(general)
    with torch.inference_mode():
        want = tit.refinement_scan(tfn, general["ty0"], eps=EPS, num_steps=2)
        for unroll in (1, 2, True, False):
            assert torch.equal(tit.refinement_scan(tfn, general["ty0"], eps=EPS, num_steps=2, unroll=unroll), want)


def test_step_gradient_matches_jax(general):
    jfn, tfn, _ = _fns(general)
    for mode in ("score", "energy"):
        want = np.asarray(jit_._step_gradient(jfn, general["y0"], mode=mode))
        with torch.no_grad():
            got = tit._step_gradient(tfn, general["ty0"], mode=mode)
        np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=mode)


@pytest.mark.parametrize("mode", ["score", "energy"])
def test_only_score_steps_reach_the_kernel(general, monkeypatch, mode):
    """The logits loop in score mode: one tail-kernel call per step; energy
    mode, and the plain steps of ``refinement_scan`` on probabilities: none."""
    calls = []
    real = tit.refine_tail
    monkeypatch.setattr(tit, "refine_tail", lambda *a, **k: calls.append(1) or real(*a, **k))
    _, tfn, tlogits = _fns(general)
    with tfused.no_autograd(mode):
        tit.logits_refinement_scan(tlogits, general["ty0"], eps=EPS, num_steps=3, mode=mode)
        assert len(calls) == (3 if mode == "score" else 0)
        tit.refinement_scan(tfn, general["ty0"], eps=EPS, num_steps=3, mode=mode)
    assert len(calls) == (3 if mode == "score" else 0)


@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_score_steps_hand_the_logits_over_uncast(general, compute_dtype):
    """The kernel widens bf16 logits itself: ``logits_refinement_scan``
    gives bit for bit the y_K of the same steps with the logits cast to f32
    first."""
    def tfn(y):
        return tdae.dae_logits(general["td"], y, general["th"], depth=4, compute_dtype=compute_dtype)

    with torch.inference_mode():
        got = tit.logits_refinement_scan(tfn, general["ty0"], eps=EPS, num_steps=3)
        want = general["ty0"]
        for _ in range(3):
            want = tit.refine_tail(tfn(want).float(), want, EPS)
    assert tfn(general["ty0"]).dtype == compute_dtype and got.dtype == torch.float32
    assert torch.equal(got, want)


def test_energy_refuses_inference_mode(general):
    _, tfn, _ = _fns(general)
    with torch.inference_mode(), pytest.raises(RuntimeError, match="no_grad"):
        tit.refinement_scan(tfn, general["ty0"], eps=EPS, num_steps=1, mode="energy")


@pytest.mark.parametrize("bad", [{"mode": "langevin"}, {"renorm": "l1"}])
def test_refinement_scan_rejects_unknown_rules(general, bad):
    _, tfn, _ = _fns(general)
    with pytest.raises(ValueError):
        tit.refinement_scan(tfn, general["ty0"], eps=EPS, num_steps=1, **bad)


def _jax_fcn_for_torch(jf):
    """The JAX FCN behind the port's fcn_apply signature: both refiners then
    start from the same y0 and taps."""

    def apply(_params, x, *, return_features=(), compute_dtype=torch.float32):
        y0, h = jfcn8.fcn8_apply(jf, jnp.asarray(x.numpy()), return_features=return_features)
        return torch.from_numpy(np.asarray(y0)), {k: torch.from_numpy(np.asarray(v)) for k, v in h.items()}

    return apply


@pytest.mark.parametrize("mode,fcn", [("score", "port"), ("score", "shared"), ("energy", "shared")])
def test_make_refiner_matches_jax(general, mode, fcn):
    x = images()
    kw = dict(eps=EPS, num_steps=2, mode=mode, dae_kwargs={"depth": 4})
    jy0, jyk = jit_.make_refiner(jfcn8.fcn8_apply, jdae.dae_apply, general["jf"], general["jd"], **kw)(
        jnp.asarray(x))
    apply = tfcn8.fcn8_apply if fcn == "port" else _jax_fcn_for_torch(general["jf"])
    ty0, tyk = tit.make_refiner(apply, tdae.dae_apply, general["tf"], general["td"], **kw)(
        torch.from_numpy(x))
    np.testing.assert_allclose(ty0.numpy(), np.asarray(jy0), **TOL)
    np.testing.assert_allclose(tyk.numpy(), np.asarray(jyk), **TOL)


APPLIES = {"dae": (jdae.dae_apply, tdae.dae_apply), "mirror": (jmir.mirror_dae_apply, tmir.mirror_dae_apply),
           "contextmod": (jctx.contextmod_apply, tctx.contextmod_apply)}


def close_to_largest(got, want):
    """Within 1e-5 of the map's largest entry, the class argmax agreeing on
    >= 99.9% of the pixels."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.999


def fixed_fcn(y0, h, port):
    """An FCN apply (the JAX or the port signature) that returns the same y0
    and taps for any input: both refiners then refine the same y0, and the
    test times no FCN."""
    if port:
        y0, h = torch.from_numpy(np.asarray(y0)), {k: torch.from_numpy(np.asarray(v)) for k, v in h.items()}
    return lambda _p, _x, *, return_features=(), compute_dtype=None: (y0, {k: h[k] for k in return_features})


@pytest.mark.parametrize("fn,arch", [("refinement_scan", "dae"), ("refine_with_trajectory", "dae"),
                                     ("make_refiner", "dae"), ("make_refiner", "mirror"),
                                     ("make_refiner", "contextmod")])
def test_general_engine_takes_jaxs_calls(general, fn, arch):
    """Each public function called as JAX calls it, with the same kind of
    callable on both sides (``make_refiner``: the apply, as
    ``grid_search_eps_k`` in ``test_torch_search.py``; the scans: a closure
    over ``dae_apply``), at eps = 0.5, K = 3, from the same y0 and taps."""
    jp, taps, kw = score_net(arch)
    tp = params_from_jax(jp)
    japply, tapply = APPLIES[arch]
    steps = dict(eps=0.5, num_steps=3)
    x = images()
    y0, h = general["y0"], {t: jnp.asarray(x) if t == "input" else general["h"][t] for t in taps}
    if fn == "make_refiner":
        want = jit_.make_refiner(fixed_fcn(y0, h, False), japply, None, jp, h_taps=taps, dae_kwargs=kw,
                                 **steps)(jnp.asarray(x))[1]
        with torch.inference_mode():
            got = tit.make_refiner(fixed_fcn(y0, h, True), tapply, None, tp, h_taps=taps, dae_kwargs=kw,
                                   **steps)(torch.from_numpy(x))[1]
    else:
        th = {k: torch.from_numpy(np.asarray(v)) for k, v in h.items()}
        want = getattr(jit_, fn)(lambda y: japply(jp, y, h, **kw), y0, **steps)
        with torch.inference_mode():
            got = getattr(tit, fn)(lambda y: tapply(tp, y, th, **kw), general["ty0"], **steps)
    close_to_largest(got.numpy(), want)
    assert np.abs(np.asarray(want)[-1] - np.asarray(y0)).max() > 1e-2  # the steps moved y


def test_make_refiner_refuses_an_unknown_apply(general):
    """A logits function, or any callable but the three applies, raises
    naming them (the port would otherwise take a softmax it was not given)."""
    for fn in (tdae.dae_logits, treg.score_logits_fn("contextmod"), lambda p, y, h: y):
        with pytest.raises(ValueError, match="dae_apply, mirror_dae_apply or contextmod_apply"):
            tit.make_refiner(tfcn8.fcn8_apply, fn, general["tf"], general["td"], eps=EPS, num_steps=1)
    assert callable(tit.make_refiner(tfcn8.fcn8_apply, treg.score_apply_fn("contextmod"), general["tf"],
                                     general["td"], eps=EPS, num_steps=1))


def test_general_engine_takes_40_classes_as_jax():
    """No class cap on the CPU: a score-mode run at C = 40 (more than a
    pixel's classes in the kernel's registers, 32) through the port's own
    FCN, DAE and ``refine_tail`` agrees with the JAX engine, which has no
    cap. The random layers are scaled by 0.1, not the helpers' 0.3: a logit
    sums 40 inputs here, and at 0.3 it reaches 3e3, where its last ulp moves
    a softmax value by more than the tolerance."""
    jf, jd = jax_params(stem_pool=1, depth=3, n_classes=40, fcn_scale=0.1, dae_scale=0.1)
    x = images()
    kw = dict(eps=EPS, num_steps=3, mode="score", dae_kwargs={"depth": 3})
    jy0, jyk = jit_.make_refiner(jfcn8.fcn8_apply, jdae.dae_apply, jf, jd, **kw)(jnp.asarray(x))
    ty0, tyk = tit.make_refiner(tfcn8.fcn8_apply, tdae.dae_apply, both(jf)[1], both(jd)[1], **kw)(
        torch.from_numpy(x))
    assert tuple(tyk.shape) == (2, 48, 64, 40) and tyk.dtype == torch.float32
    np.testing.assert_allclose(ty0.numpy(), np.asarray(jy0), **TOL)
    np.testing.assert_allclose(tyk.numpy(), np.asarray(jyk), **TOL)
    assert np.abs(np.asarray(jyk) - np.asarray(jy0)).max() > 1e-3  # the steps moved y


@pytest.mark.parametrize("mode", ["score", "energy"])
@pytest.mark.parametrize("stem_pool", [0, 1])
def test_general_predictor_matches_jax(mode, stem_pool):
    """Batch 2 over 3 images (the last chunk zero-padded); energy mode runs
    under ``Predictor.predict``."""
    depth = 4 - stem_pool
    jf, jd = jax_params(stem_pool=stem_pool, depth=depth)
    imgs = np.random.default_rng(8).random((3, 48, 64, 3), dtype=np.float32)
    kw = dict(batch_size=2, num_steps=2, eps=EPS, mode=mode, engine="general", dae_kwargs={"depth": depth})
    want_labels, want_probs = JPredictor(jf, jd, dataset=TINY_J, compute_dtype=jnp.float32, **kw).predict(
        imgs, return_probs=True)
    tp = Predictor(both(jf)[1], both(jd)[1], device="cpu", dataset=TINY_T, compute_dtype=torch.float32, **kw)
    labels, probs = tp.predict(imgs, return_probs=True)
    assert labels.dtype == np.int32 and probs.dtype == np.float32 and probs.shape == (3, 48, 64, 5)
    np.testing.assert_array_equal(labels, want_labels)
    tol = 1e-4 if (mode, stem_pool) == ("energy", 0) else 1e-5  # see the module doc
    np.testing.assert_allclose(probs, want_probs, rtol=tol, atol=tol)


def test_default_engine_is_general_as_in_jax():
    """``Predictor`` with no ``engine`` serves the general engine, and with
    ``num_steps=0`` the FCN's f32 softmax unrefined, as the JAX package."""
    jf, jd = jax_params(stem_pool=1, depth=3)
    imgs = np.random.default_rng(9).random((2, 48, 64, 3), dtype=np.float32)
    for steps in (2, 0):
        kw = dict(batch_size=2, num_steps=steps, eps=EPS, dae_kwargs={"depth": 3})
        want_labels, want = JPredictor(jf, jd, dataset=TINY_J, compute_dtype=jnp.float32, **kw).predict(
            imgs, return_probs=True)
        tp = Predictor(both(jf)[1], both(jd)[1], device="cpu", dataset=TINY_T, compute_dtype=torch.float32, **kw)
        labels, got = tp.predict(imgs, return_probs=True)
        np.testing.assert_array_equal(labels, want_labels)
        np.testing.assert_allclose(got, want, **TOL)
        half = Predictor(both(jf)[1], both(jd)[1], device="cpu", dataset=TINY_T, engine="half",
                         compute_dtype=torch.float32, **kw).predict(imgs, return_probs=True)[1]
        assert np.abs(half - got).max() > 1e-4  # the default is not the half engine


@pytest.mark.parametrize("stem_pool", [1, 2])
def test_half_engine_energy_matches_jax(stem_pool):
    jf, jd = jax_params(stem_pool=stem_pool, depth=3)
    x = images(seed=5)
    kw = dict(num_steps=2, depth=3, eps=EPS, mode="energy", fold_tail=False)
    jy0, jyk = jax.jit(jfused.flagship_forward_fn(compute_dtype=jnp.float32, **kw))(jf, jd, jnp.asarray(x))
    fwd = tfused.flagship_forward_fn(compute_dtype=torch.float32, with_labels=True, **kw)
    with torch.no_grad():
        ty0, tyk, labels = fwd(both(jf)[1], both(jd)[1], torch.from_numpy(x))
    np.testing.assert_allclose(tyk.numpy(), np.asarray(jyk), **TOL)
    assert np.abs(np.asarray(jyk) - np.asarray(jy0)).max() > 1e-3
    np.testing.assert_array_equal(labels.numpy(), tyk.numpy().argmax(-1))


def test_half_predictor_energy_matches_jax():
    jf, jd = jax_params(stem_pool=1, depth=3)
    imgs = np.random.default_rng(10).random((2, 48, 64, 3), dtype=np.float32)
    kw = dict(batch_size=2, num_steps=2, eps=EPS, mode="energy", engine="half", dae_kwargs={"depth": 3})
    want_labels, want = JPredictor(jf, jd, dataset=TINY_J, compute_dtype=jnp.float32, **kw).predict(
        imgs, return_probs=True)
    labels, got = Predictor(both(jf)[1], both(jd)[1], device="cpu", dataset=TINY_T,
                            compute_dtype=torch.float32, **kw).predict(imgs, return_probs=True)
    np.testing.assert_array_equal(labels, want_labels)
    np.testing.assert_allclose(got, want, **TOL)


def test_half_refiner_energy_refuses_the_folded_tail():
    jf, jd = jax_params(stem_pool=1, depth=3)
    with pytest.raises(ValueError, match="fold_tail"):
        tfused.make_half_refiner(None, both(jf)[1], both(jd)[1], eps=0.1, num_steps=1, mode="energy",
                                 fold_tail=True)
