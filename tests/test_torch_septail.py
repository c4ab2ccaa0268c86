"""The separable 'sep' tail in the port against the JAX package, on the CPU:
the depthwise ops (random, non-symmetric kernels, so that a missing flip
shows), the depthwise inits, the bridge of 3-D depthwise weights both ways,
``init_dae(tail='sep')``, ``dae_septail_logits``, ``dae_apply``, the half
engine's tail logits, and the half engine with the 'sep' tail in score and
energy modes, through the flagship forward and the ``Predictor``.

Tolerances: f32 within 1e-5 (the same convolutions summed in another order;
whole flagship paths, which also run both FCNs, within 1e-4 as in
``tests/test_torch_flagship.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch_port_helpers import C, TINY_J, TINY_T, both, images, jax_params, probs  # noqa: E402

from iterative_inference_segm_tpu.inference import fused as jfused  # noqa: E402
from iterative_inference_segm_tpu.inference.predictor import Predictor as JPredictor  # noqa: E402
from iterative_inference_segm_tpu.models import dae as jdae  # noqa: E402
from iterative_inference_segm_tpu.ops import conv as jconv  # noqa: E402
from iterative_inference_segm_tpu_torch.inference import fused as tfused  # noqa: E402
from iterative_inference_segm_tpu_torch.inference.predictor import Predictor  # noqa: E402
from iterative_inference_segm_tpu_torch.models import dae as tdae  # noqa: E402
from iterative_inference_segm_tpu_torch.ops import conv as tconv  # noqa: E402
from iterative_inference_segm_tpu_torch.utils.jax_bridge import params_from_jax, params_to_jax  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
PATH_TOL = dict(rtol=1e-4, atol=1e-4)


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("k,padding", [(3, "SAME"), (3, "VALID"), (5, ((2, 1), (0, 3)))])
@pytest.mark.parametrize("bias", [False, True])
def test_conv2d_depthwise_matches_jax(k, padding, bias):
    x, w, b = _rand((2, 9, 12, C), 0), _rand((k, k, C), 1), _rand((C,), 2)
    want = jconv.conv2d_depthwise(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b) if bias else None,
                                  padding=padding)
    tw = params_from_jax({"score_input_dw": {"w": w}})["score_input_dw"]["w"]
    assert tuple(tw.shape) == (C, 1, k, k)
    got = tconv.conv2d_depthwise(torch.from_numpy(x), tw, torch.from_numpy(b) if bias else None,
                                 padding=padding)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("k,stride", [(4, 2), (3, 2), (6, 3)])
def test_conv_transpose2d_depthwise_matches_jax(k, stride):
    x, w = _rand((2, 7, 9, C), 3), _rand((k, k, C), 4)
    want = np.asarray(jconv.conv_transpose2d_depthwise(jnp.asarray(x), jnp.asarray(w), stride=stride))
    tw = params_from_jax({"up_stem_dw": {"w": w}})["up_stem_dw"]["w"]
    got = tconv.conv_transpose2d_depthwise(torch.from_numpy(x), tw, stride=stride)
    assert tuple(got.shape) == (2, 7 * stride, 9 * stride, C)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the unflipped weight is wrong: the flip is what makes it right
    unflipped = torch.from_numpy(np.ascontiguousarray(w.transpose(2, 0, 1)[:, None]))
    bad = tconv.conv_transpose2d_depthwise(torch.from_numpy(x), unflipped, stride=stride)
    assert np.abs(bad.numpy() - want).max() > 1e-2


def test_depthwise_inits_match_jax():
    up = params_from_jax({"up_stem_dw": {"w": jconv.bilinear_kernel_depthwise(4, C)}})["up_stem_dw"]["w"]
    assert torch.equal(tconv.bilinear_kernel_depthwise(4, C), up)
    si = params_from_jax({"score_input_dw": {"w": jconv.delta_kernel_depthwise(3, C)}})["score_input_dw"]["w"]
    assert torch.equal(tconv.delta_kernel_depthwise(3, C), si)


def test_bridge_round_trips_depthwise_weights():
    tree = {"up_stem_dw": {"w": _rand((4, 4, C), 5)}, "score_input_dw": {"w": _rand((3, 3, C), 6)},
            "mix": {"w": _rand((1, 1, C, C), 7), "b": _rand((C,), 8)}}
    ported = params_from_jax(tree)
    assert tuple(ported["mix"]["w"].shape) == (C, C, 1, 1)
    back = params_to_jax(ported)
    for layer, leaves in tree.items():
        for leaf, v in leaves.items():
            np.testing.assert_array_equal(back[layer][leaf], v, err_msg=f"{layer}/{leaf}")
    # up_stem_dw is flipped (transposed conv), score_input_dw is not
    w = tree["up_stem_dw"]["w"]
    np.testing.assert_array_equal(ported["up_stem_dw"]["w"][:, 0].numpy(), w[::-1, ::-1].transpose(2, 0, 1))
    np.testing.assert_array_equal(ported["score_input_dw"]["w"][:, 0].numpy(),
                                  tree["score_input_dw"]["w"].transpose(2, 0, 1))
    with pytest.raises(ValueError):
        params_from_jax({"up_stem_dw": {"w": np.zeros((4, 4, C, 1), np.float32)}})


def test_init_dae_sep_matches_jax():
    j = jdae.init_dae(jax.random.PRNGKey(0), n_classes=C, depth=3, stem_pool=1, tail="sep",
                      widths=(8, 16, 32))
    t = tdae.init_dae(torch.Generator().manual_seed(0), n_classes=C, depth=3, stem_pool=1, tail="sep",
                      widths=(8, 16, 32))
    ported = params_from_jax(j)
    assert set(t) == set(ported) and "up_stem1" not in t and "score_input" not in t
    for layer in t:
        for leaf in t[layer]:
            assert t[layer][leaf].shape == ported[layer][leaf].shape, (layer, leaf)
    for layer in ("up_stem_dw", "score_input_dw", "mix"):  # deterministic inits: equal
        for leaf in t[layer]:
            assert torch.equal(t[layer][leaf], ported[layer][leaf]), (layer, leaf)
    assert tdae.dae_tail_of(t) == "sep" and tdae.dae_stem_pool_of(t) == 1


@pytest.fixture(scope="module")
def sep():
    jf, jd = jax_params(stem_pool=1, depth=3, tail="sep")
    return jf, jd, both(jf)[1], both(jd)[1]


def test_dae_septail_logits_matches_jax(sep):
    _, jd, _, td = sep
    s, y = _rand((2, 24, 32, C), 9), probs((2, 48, 64, C), 10)
    want = jdae.dae_septail_logits(jd, jnp.asarray(s), jnp.asarray(y))
    got = tdae.dae_septail_logits(td, torch.from_numpy(s), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("hw", [(48, 64), (47, 63)])  # odd sizes take the edge pad
def test_dae_apply_sep_matches_jax(sep, hw):
    _, jd, _, td = sep
    y = probs((2, *hw, C), 11)
    h = {"pool4": _rand((2, -(-hw[0] // 16), -(-hw[1] // 16), 512), 12)}
    want = jdae.dae_apply(jd, jnp.asarray(y), {k: jnp.asarray(v) for k, v in h.items()}, depth=3)
    th = {k: torch.from_numpy(v) for k, v in h.items()}
    got = tdae.dae_apply(td, torch.from_numpy(y), th, depth=3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    logits = tdae.dae_logits(td, torch.from_numpy(y), th, depth=3)
    assert torch.equal(torch.softmax(logits, -1), got)


def test_half_and_full_logits_sep_match_jax(sep):
    _, jd, _, td = sep
    x, s, y = probs((2, 24, 32, C), 13), _rand((2, 24, 32, C), 14), probs((2, 48, 64, C), 15)
    np.testing.assert_allclose(
        tfused.half_logits(td, torch.from_numpy(x), torch.from_numpy(s)).numpy(),
        np.asarray(jfused.half_logits(jd, jnp.asarray(x), jnp.asarray(s))), **TOL)
    np.testing.assert_allclose(
        tfused.full_logits(td, torch.from_numpy(s), torch.from_numpy(y)).numpy(),
        np.asarray(jfused.full_logits(jd, jnp.asarray(s), jnp.asarray(y))), **TOL)


@pytest.mark.parametrize("mode", ["score", "energy"])
@pytest.mark.parametrize("tail", ["full", "sep"])
def test_step_and_rectification_gradients_match_jax(mode, tail):
    """The plain gradients of the pooled step and of the rectification,
    both tails, both rules, at the same inputs."""
    _, jd = jax_params(stem_pool=1, depth=3, tail=tail)
    td = params_from_jax(jd)
    x, s, y = probs((2, 24, 32, C), 18), _rand((2, 24, 32, C), 19), probs((2, 48, 64, C), 20)
    w = _rand((1, 1, C, C), 21)[0, 0]
    # a core_fn both sides can run: a fixed linear map of x
    jcore = lambda xx: jnp.asarray(s) + xx @ jnp.asarray(w)  # noqa: E731
    tcore = lambda xx: torch.from_numpy(s) + xx @ torch.from_numpy(w)  # noqa: E731
    want = jfused.half_step_gradient(jd, jcore, jnp.asarray(x), mode=mode, state_dtype=jnp.float32)
    with torch.no_grad():
        got = tfused.half_step_gradient(td, tcore, torch.from_numpy(x), mode=mode, state_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = jfused.full_rect_gradient(jd, jnp.asarray(s), jnp.asarray(y), mode=mode)
    with torch.no_grad():
        got = tfused.full_rect_gradient(td, torch.from_numpy(s), torch.from_numpy(y), mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", ["score", "energy"])
def test_half_engine_sep_matches_jax(sep, mode):
    jf, jd, tf, td = sep
    x = images(seed=16)
    kw = dict(num_steps=2, depth=3, eps=0.3, mode=mode, fold_tail=False)
    jy0, jyk = jax.jit(jfused.flagship_forward_fn(compute_dtype=jnp.float32, **kw))(jf, jd, jnp.asarray(x))
    with tfused.no_autograd(mode):
        ty0, tyk, labels = tfused.flagship_forward_fn(compute_dtype=torch.float32, with_labels=True, **kw)(
            tf, td, torch.from_numpy(x))
    np.testing.assert_allclose(ty0.numpy(), np.asarray(jy0), **PATH_TOL)
    np.testing.assert_allclose(tyk.numpy(), np.asarray(jyk), **PATH_TOL)
    assert np.abs(np.asarray(jyk) - np.asarray(jy0)).max() > 1e-3
    np.testing.assert_array_equal(labels.numpy(), tyk.numpy().argmax(-1))


def test_sep_tail_is_never_folded(sep):
    _, _, tf, td = sep
    with pytest.raises(ValueError):
        tfused.fold_half_tail(td)
    with pytest.raises(ValueError, match="fold_tail"):
        tfused.make_half_refiner(None, tf, td, eps=0.1, num_steps=1, fold_tail=True)


@pytest.mark.parametrize("mode", ["score", "energy"])
def test_half_predictor_sep_matches_jax(sep, mode):
    jf, jd, tf, td = sep
    imgs = np.random.default_rng(17).random((3, 48, 64, 3), dtype=np.float32)
    kw = dict(batch_size=2, num_steps=2, eps=0.3, mode=mode, engine="half", dae_kwargs={"depth": 3})
    want_labels, want = JPredictor(jf, jd, dataset=TINY_J, compute_dtype=jnp.float32, **kw).predict(
        imgs, return_probs=True)
    labels, got = Predictor(tf, td, device="cpu", dataset=TINY_T, compute_dtype=torch.float32, **kw).predict(
        imgs, return_probs=True)
    np.testing.assert_array_equal(labels, want_labels)
    np.testing.assert_allclose(got, want, **PATH_TOL)
