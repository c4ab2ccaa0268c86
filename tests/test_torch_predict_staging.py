"""``Predictor.predict`` through its kept host buffers, on the CPU: the
frames pass through one staging buffer of a chunk (zero-padded, sent in row
slices) and the labels go straight into an array of the ``OutputRing``. The
labels and probabilities are bit-equal to ``_predict`` run chunk by chunk
and concatenated, results of two calls never share memory, and the ring
reuses a slot only for its shape once the array it handed out is gone. On
the CPU the ring's slots are plain tensors, standing in for the page-locked
ones of a card. Small shapes: C = 5, 48x64, fc 16, DAE widths (8, 16, 32)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from iterative_inference_segm_tpu_torch.inference import predictor as predictor_mod  # noqa: E402
from iterative_inference_segm_tpu_torch.inference.predictor import OutputRing, Predictor  # noqa: E402
from iterative_inference_segm_tpu_torch.models.fcn8 import init_fcn8  # noqa: E402
from iterative_inference_segm_tpu_torch.models.registry import init_score_template  # noqa: E402
from torch_port_helpers import HW, TINY_T  # noqa: E402

C = TINY_T.n_classes
BATCH = 5  # with 4 row slices: (0, 1), (1, 2), (2, 3), (3, 5), so a padded chunk of 4 splits its last slice


def _frames(n, seed=0):
    return np.random.default_rng(seed).random((n, *HW, 3), dtype=np.float32)


@pytest.fixture(scope="module", params=["half", "general"])
def predictor(request):
    gen = torch.Generator().manual_seed(0)
    fcn = init_fcn8(gen, n_classes=C, fc_channels=16)
    dae = init_score_template("dae", gen, n_classes=C, depth=3, stem_pool=1, widths=(8, 16, 32))
    return Predictor(fcn, dae, device="cpu", dataset=TINY_T, engine=request.param, num_steps=2,
                     batch_size=BATCH, compute_dtype=torch.float32, dae_kwargs={"depth": 3})


def _chunked(p, images):
    """``_predict`` on each zero-padded chunk, its rows concatenated: the
    labels and f32 probabilities ``predict`` served before its buffers."""
    labels, probs = [], []
    with torch.inference_mode():
        for start in range(0, len(images), p.batch_size):
            chunk = images[start : start + p.batch_size]
            pad = np.zeros((p.batch_size - len(chunk), *chunk.shape[1:]), np.float32)
            lab, pr = p._predict(torch.from_numpy(np.concatenate([chunk, pad])))
            labels.append(lab[: len(chunk)].numpy())
            probs.append(pr[: len(chunk)].float().numpy())
    return np.concatenate(labels), np.concatenate(probs)


@pytest.mark.parametrize("n", [1, BATCH - 1, BATCH, 2 * BATCH + 1])
def test_labels_bit_equal_to_chunked_predict(predictor, n):
    images = _frames(n, seed=n)
    want, _ = _chunked(predictor, images)
    got = predictor.predict(images)
    assert got.shape == (n, *HW) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if n % BATCH:  # the last chunk's padding is zero, whatever an earlier chunk left in the buffer
        assert not predictor._stage[n % BATCH :].any()


def test_probs_bit_equal_to_chunked_predict(predictor):
    images = _frames(2 * BATCH + 1, seed=3)
    want_labels, want_probs = _chunked(predictor, images)
    labels, probs = predictor.predict(images, return_probs=True)
    assert probs.shape == (len(images), *HW, C) and probs.dtype == np.float32
    np.testing.assert_array_equal(labels, want_labels)
    np.testing.assert_array_equal(probs, want_probs)


def test_results_of_two_calls_never_alias(predictor):
    first = predictor.predict(_frames(BATCH, seed=1))
    second = predictor.predict(_frames(BATCH, seed=2))
    kept = second.copy()
    assert not np.shares_memory(first, second)
    first[...] = -1
    np.testing.assert_array_equal(second, kept)
    predictor.predict(_frames(BATCH, seed=3))
    predictor.predict(_frames(BATCH, seed=4))
    assert (first == -1).all()  # later calls wrote elsewhere
    np.testing.assert_array_equal(second, kept)


def _ring():
    made = []

    def alloc(shape, dtype):
        made.append(tuple(shape))
        return torch.empty(shape, dtype=dtype)

    return OutputRing(alloc), made


def _ptr(a):
    return a.__array_interface__["data"][0]


def test_ring_reuses_a_released_slot_only():
    ring, made = _ring()
    _, a, in_ring = ring.take((2, 3), torch.int32)
    ptr = _ptr(a)
    assert in_ring and made == [(2, 3)]
    _, b, _ = ring.take((2, 3), torch.int32)  # a is held: never reused
    assert _ptr(b) != ptr and len(made) == 2
    del a
    _, c, _ = ring.take((2, 3), torch.int32)  # a is gone: its slot again
    assert _ptr(c) == ptr and len(made) == 2


def test_ring_keeps_a_slot_while_a_view_of_its_array_lives():
    ring, made = _ring()
    _, a, _ = ring.take((4, 3), torch.int32)
    ptr, view = _ptr(a), a[1:]
    del a
    _, b, _ = ring.take((4, 3), torch.int32)
    assert _ptr(b) != ptr and len(made) == 2
    del b, view
    _, c, _ = ring.take((4, 3), torch.int32)
    assert _ptr(c) == ptr and len(made) == 2


def test_ring_misses_on_another_shape_and_replaces_a_free_slot_when_full():
    ring, made = _ring()
    _, a, _ = ring.take((2, 3), torch.int32)
    del a
    _, b, _ = ring.take((3, 3), torch.int32)  # a free slot of another shape is not reused
    assert made == [(2, 3), (3, 3)]
    held = [ring.take((4, 3), torch.int32)[1] for _ in range(predictor_mod.OUT_SLOTS - 2)]
    del b, held  # every slot free, none of shape (5, 3): the first free one is remade
    _, c, in_ring = ring.take((5, 3), torch.int32)
    assert in_ring and made[-1] == (5, 3) and len(made) == predictor_mod.OUT_SLOTS + 1
    _, d, in_ring = ring.take((3, 3), torch.int32)  # the (3, 3) slot was left as it was
    assert in_ring and len(made) == predictor_mod.OUT_SLOTS + 1


def test_ring_falls_back_when_every_slot_is_held():
    ring, made = _ring()
    held = [ring.take((2, 3), torch.int32)[1] for _ in range(predictor_mod.OUT_SLOTS)]
    _, extra, in_ring = ring.take((2, 3), torch.int32)
    assert not in_ring and len(made) == predictor_mod.OUT_SLOTS
    assert all(not np.shares_memory(extra, h) for h in held)


def test_predict_refuses_an_empty_request(predictor):
    with pytest.raises(ValueError, match="at least one image"):
        predictor.predict(np.zeros((0, *HW, 3), np.float32))


def test_predict_past_every_slot_held_still_serves_the_right_labels(predictor):
    images = _frames(BATCH, seed=9)
    want, _ = _chunked(predictor, images)
    held = [predictor.predict(images) for _ in range(predictor_mod.OUT_SLOTS + 1)]  # the last one falls back
    for labels in held:
        np.testing.assert_array_equal(labels, want)
    assert len({_ptr(h) for h in held}) == len(held)
