"""``ops.losses`` and ``ops.metrics`` against the JAX package's, on the same
numpy inputs: void pixels (labels >= C and < 0), an all-void batch, clipped
predictions. Losses in f32 within 1e-5 relative (the same f32 formulas;
the two libms' log differ by an ulp and the means sum a few hundred pixels
in another order); metrics within 1e-6; confusion counts exactly equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from iterative_inference_segm_tpu.ops import losses as jlosses  # noqa: E402
from iterative_inference_segm_tpu.ops import metrics as jmetrics  # noqa: E402
from iterative_inference_segm_tpu_torch.ops import losses as tlosses  # noqa: E402
from iterative_inference_segm_tpu_torch.ops import metrics as tmetrics  # noqa: E402

C = 11
TOL = dict(rtol=1e-6, atol=1e-7)
LOSS_TOL = dict(rtol=1e-5, atol=1e-7)


def _case(kind, seed=0, shape=(2, 12, 16)):
    rng = np.random.default_rng(seed)
    labels = rng.integers(-1, C + 2, size=shape).astype(np.int32)
    if kind == "all_void":
        labels = np.full(shape, C, np.int32)
    elif kind == "no_void":
        labels = rng.integers(0, C, size=shape).astype(np.int32)
    logits = (rng.normal(size=shape + (C,)) * 3).astype(np.float32)
    return logits, labels


@pytest.mark.parametrize("kind", ["void", "no_void", "all_void"])
def test_masked_crossentropy_matches_jax(kind):
    logits, labels = _case(kind)
    want = float(jlosses.masked_crossentropy(jnp.asarray(logits), jnp.asarray(labels), n_classes=C))
    got = float(tlosses.masked_crossentropy(torch.from_numpy(logits), torch.from_numpy(labels), n_classes=C))
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    if kind == "all_void":
        assert got == 0.0


@pytest.mark.parametrize("kind", ["void", "no_void", "all_void"])
def test_crossentropy_probs_matches_jax(kind):
    logits, labels = _case(kind, seed=1)
    # some probabilities below the 1e-7 clip
    probs = np.asarray(torch.softmax(torch.from_numpy(logits) * 4, -1))
    want = float(jlosses.crossentropy_probs(jnp.asarray(probs), jnp.asarray(labels), n_classes=C))
    got = float(tlosses.crossentropy_probs(torch.from_numpy(probs), torch.from_numpy(labels), n_classes=C))
    np.testing.assert_allclose(got, want, **LOSS_TOL)
    assert probs.min() < 1e-7


def test_crossentropy_probs_bf16_input_and_gradient():
    logits, labels = _case("void", seed=2)
    probs = torch.softmax(torch.from_numpy(logits), -1).to(torch.bfloat16).requires_grad_(True)
    loss = tlosses.crossentropy_probs(probs, torch.from_numpy(labels), n_classes=C)
    assert loss.dtype == torch.float32
    loss.backward()
    g = probs.grad.float()
    void = (torch.from_numpy(labels) < 0) | (torch.from_numpy(labels) >= C)
    assert torch.all(g[void] == 0) and torch.any(g[~void] != 0)
    want = jlosses.crossentropy_probs(jnp.asarray(probs.detach().float().numpy(), jnp.bfloat16),
                                      jnp.asarray(labels), n_classes=C)
    np.testing.assert_allclose(float(loss.detach()), float(want), **LOSS_TOL)


def test_l2_regularization_matches_jax():
    rng = np.random.default_rng(3)
    tree = {
        "a": {"w": rng.normal(size=(3, 3, 2, 4)).astype(np.float32), "b": np.ones(4, np.float32)},
        "b": {"w": rng.normal(size=(1, 1, 4, 5)).astype(np.float32)},
    }
    want = float(jlosses.l2_regularization({k: {kk: jnp.asarray(v) for kk, v in lv.items()} for k, lv in tree.items()}))
    got = float(tlosses.l2_regularization({k: {kk: torch.from_numpy(v) for kk, v in lv.items()} for k, lv in tree.items()}))
    np.testing.assert_allclose(got, want, **TOL)
    assert float(tlosses.l2_regularization({"a": {"b": torch.ones(3)}})) == 0.0


@pytest.mark.parametrize("kind", ["void", "no_void", "all_void"])
def test_confusion_matrix_and_metrics_match_jax(kind):
    logits, labels = _case(kind, seed=4)
    pred = logits.argmax(-1).astype(np.int32)
    pred[0, 0, :4] = [-3, C, C + 7, 2]  # out-of-range predictions are clipped
    want = np.asarray(jmetrics.confusion_matrix(jnp.asarray(pred), jnp.asarray(labels), n_classes=C))
    got = tmetrics.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(labels), n_classes=C)
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got.dtype.is_floating_point
    jm = jmetrics.metrics_from_confusion(jnp.asarray(want))
    tm = tmetrics.metrics_from_confusion(got)
    for f in ("per_class_iou", "mean_iou", "pixel_accuracy", "valid_pixels"):
        np.testing.assert_allclose(np.asarray(getattr(tm, f)), np.asarray(getattr(jm, f)), **TOL)
    jj = jmetrics.jaccard(jnp.asarray(pred), jnp.asarray(labels), n_classes=C)
    tj = tmetrics.jaccard(torch.from_numpy(pred), torch.from_numpy(labels), n_classes=C)
    np.testing.assert_allclose(float(tj.mean_iou), float(jj.mean_iou), **TOL)
    pa_j = jmetrics.pixel_accuracy(jnp.asarray(pred), jnp.asarray(labels), n_classes=C)
    pa_t = tmetrics.pixel_accuracy(torch.from_numpy(pred), torch.from_numpy(labels), n_classes=C)
    np.testing.assert_allclose(float(pa_t), float(pa_j), **TOL)
