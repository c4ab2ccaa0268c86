"""The port's general refinement engine (``inference/iterative.py``), the
general-engine ``Predictor``, its default engine, and the half engine's
energy mode, against the JAX package on the same numpy inputs and the same
(bridged) weights, on the CPU.

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
from torch_port_helpers import TINY_J, TINY_T, both, images, jax_params  # noqa: E402

from iterative_inference_segm_tpu.inference import fused as jfused  # noqa: E402
from iterative_inference_segm_tpu.inference import iterative as jit_  # noqa: E402
from iterative_inference_segm_tpu.inference.predictor import Predictor as JPredictor  # noqa: E402
from iterative_inference_segm_tpu.models import dae as jdae  # noqa: E402
from iterative_inference_segm_tpu.models import fcn8 as jfcn8  # noqa: E402
from iterative_inference_segm_tpu_torch.inference import fused as tfused  # noqa: E402
from iterative_inference_segm_tpu_torch.inference import iterative as tit  # noqa: E402
from iterative_inference_segm_tpu_torch.inference.predictor import Predictor  # noqa: E402
from iterative_inference_segm_tpu_torch.models import dae as tdae  # noqa: E402
from iterative_inference_segm_tpu_torch.models import fcn8 as tfcn8  # noqa: E402

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
    jfn = lambda y: jdae.dae_apply(g["jd"], y, g["h"], depth=depth)  # noqa: E731
    tfn = lambda y: tdae.dae_logits(g["td"], y, g["th"], depth=depth)  # noqa: E731
    return jfn, tfn


@pytest.mark.parametrize("mode", ["score", "energy"])
@pytest.mark.parametrize("renorm", ["none", "softmax"])
def test_refinement_scan_matches_jax(general, mode, renorm):
    jfn, tfn = _fns(general)
    kw = dict(eps=EPS, num_steps=3, mode=mode, renorm=renorm)
    want = np.asarray(jit_.refinement_scan(jfn, general["y0"], **kw))
    with tfused.no_autograd(mode):
        got = tit.refinement_scan(tfn, general["ty0"], **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert np.abs(want - np.asarray(general["y0"])).max() > 1e-3  # the steps moved y


@pytest.mark.parametrize("mode", ["score", "energy"])
def test_refine_with_trajectory_matches_jax(general, mode):
    jfn, tfn = _fns(general)
    kw = dict(eps=EPS, num_steps=3, mode=mode)
    want = np.asarray(jit_.refine_with_trajectory(jfn, general["y0"], **kw))
    with tfused.no_autograd(mode):
        got = tit.refine_with_trajectory(tfn, general["ty0"], **kw)
        last = tit.refinement_scan(tfn, general["ty0"], **kw)
    assert tuple(got.shape) == (4, 2, 48, 64, 5)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert torch.equal(got[0], general["ty0"]) and torch.equal(got[-1], last)


def test_step_gradient_matches_jax(general):
    jfn, tfn = _fns(general)
    for mode in ("score", "energy"):
        want = np.asarray(jit_._step_gradient(jfn, general["y0"], mode=mode))
        with torch.no_grad():
            got = tit._step_gradient(tfn, general["ty0"], mode=mode)
        np.testing.assert_allclose(got.numpy(), want, **TOL, err_msg=mode)


@pytest.mark.parametrize("mode", ["score", "energy"])
def test_only_score_steps_reach_the_kernel(general, monkeypatch, mode):
    """Score mode: one tail-kernel call per step; energy mode: none."""
    calls = []
    real = tit.refine_tail
    monkeypatch.setattr(tit, "refine_tail", lambda *a, **k: calls.append(1) or real(*a, **k))
    _, tfn = _fns(general)
    with tfused.no_autograd(mode):
        tit.refinement_scan(tfn, general["ty0"], eps=EPS, num_steps=3, mode=mode)
    assert len(calls) == (3 if mode == "score" else 0)


def test_energy_refuses_inference_mode(general):
    _, tfn = _fns(general)
    with torch.inference_mode(), pytest.raises(RuntimeError, match="no_grad"):
        tit.refinement_scan(tfn, general["ty0"], eps=EPS, num_steps=1, mode="energy")


@pytest.mark.parametrize("bad", [{"mode": "langevin"}, {"renorm": "l1"}])
def test_refinement_scan_rejects_unknown_rules(general, bad):
    _, tfn = _fns(general)
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
    ty0, tyk = tit.make_refiner(apply, tdae.dae_logits, general["tf"], general["td"], **kw)(
        torch.from_numpy(x))
    np.testing.assert_allclose(ty0.numpy(), np.asarray(jy0), **TOL)
    np.testing.assert_allclose(tyk.numpy(), np.asarray(jyk), **TOL)


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
