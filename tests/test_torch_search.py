"""The port's (eps, K) searches against the JAX package's on the CPU, on the
same numpy batches and the same (bridged) weights, in f32: the mIoU grids
agree within 1e-6 and pick the same (eps, K). Each K of a one-trajectory
search equals the engine run with ``num_steps=K``.

A grid entry is a count of pixels, so one pixel whose argmax flips moves it
by ~1e-6; the FCNs of the two packages differ in the last ulps, which flips
near-tied pixels of random weights. So both searches get the same FCN (the
JAX one, behind the port's ``fcn_apply`` signature) and the grids hold the
refinement and the scoring alone; the FCN's score weights are drawn at scale
1.0, so that its softmax is decisive.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from torch_port_helpers import C, both, jax_params  # noqa: E402

from iterative_inference_segm_tpu.inference import search as jsearch  # noqa: E402
from iterative_inference_segm_tpu.models import dae as jdae  # noqa: E402
from iterative_inference_segm_tpu.models import fcn8 as jfcn8  # noqa: E402
from iterative_inference_segm_tpu_torch.inference import fused as tfused  # noqa: E402
from iterative_inference_segm_tpu_torch.inference import iterative as tit  # noqa: E402
from iterative_inference_segm_tpu_torch.inference import search as tsearch  # noqa: E402
from iterative_inference_segm_tpu_torch.models import dae as tdae  # noqa: E402
from iterative_inference_segm_tpu_torch.ops.metrics import confusion_matrix, metrics_from_confusion  # noqa: E402

EPS_GRID = (0.1, 0.5)
K_MAX = 3


def _batches(n=2, seed=20):
    """Labels taken from a smoothed argmax of the images, so that mIoU is
    not flat across (eps, K)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.normal(size=(2, 48, 64, 3)).astype(np.float32)
        lab = (np.floor((x[..., 0] + 2.0) * 1.2).clip(0, C - 1)).astype(np.int32)
        lab[rng.random(lab.shape) < 0.02] = C  # void
        out.append((x, lab))
    return out


def _jax_fcn_for_torch(jf):
    def apply(_params, x, *, return_features=(), compute_dtype=torch.float32, probs_dtype=torch.float32):
        y0, h = jfcn8.fcn8_apply(jf, jnp.asarray(x.numpy()), return_features=return_features)
        return torch.from_numpy(np.asarray(y0)), {k: torch.from_numpy(np.asarray(v)) for k, v in h.items()}

    return apply


def _miou(preds_labels):
    cm = sum(confusion_matrix(p, lab, n_classes=C) for p, lab in preds_labels)
    return float(metrics_from_confusion(cm).mean_iou)


@pytest.mark.parametrize("mode", ["score", "energy"])
def test_general_search_matches_jax(mode):
    jf, jd = jax_params(stem_pool=0, depth=4, fcn_scale=1.0)
    batches = _batches()
    kw = dict(n_classes=C, eps_grid=EPS_GRID, k_max=K_MAX, mode=mode)
    want = jsearch.grid_search_eps_k(jfcn8.fcn8_apply, jdae.dae_apply, jf, jd, batches,
                                     dae_kwargs={"depth": 4}, **kw)
    tf, td = both(jf)[1], both(jd)[1]
    got = tsearch.grid_search_eps_k(_jax_fcn_for_torch(jf), tdae.dae_logits, tf, td, batches, device="cpu",
                                    dae_kwargs={"depth": 4}, **kw)
    assert got["miou"].shape == (len(EPS_GRID), K_MAX + 1)
    np.testing.assert_allclose(got["miou"], want["miou"], rtol=0, atol=1e-6)
    assert (got["best_eps"], got["best_k"]) == (want["best_eps"], want["best_k"])
    assert np.ptp(got["miou"]) > 0  # the grid is not flat
    if mode == "energy":
        return
    # each K equals a refinement_scan(num_steps=K) run
    for ei, eps in enumerate(EPS_GRID):
        for k in (0, 2):
            pl = []
            for x, lab in batches:
                y0, h = _jax_fcn_for_torch(jf)(tf, torch.from_numpy(x), return_features=("pool4",))
                yk = tit.refinement_scan(lambda y: tdae.dae_logits(td, y, h, depth=4), y0, eps=eps,
                                         num_steps=k)
                pl.append((yk.argmax(-1), torch.from_numpy(lab)))
            assert _miou(pl) == got["miou"][ei, k], (eps, k)


@pytest.mark.parametrize("tail,mode", [("full", "score"), ("full", "energy"), ("sep", "score")])
def test_half_search_matches_jax(tail, mode):
    jf, jd = jax_params(stem_pool=1, depth=3, tail=tail, fcn_scale=1.0)
    batches = _batches(seed=21)
    kw = dict(n_classes=C, eps_grid=EPS_GRID, k_max=K_MAX, depth=3, mode=mode)
    want = jsearch.grid_search_eps_k_half(jfcn8.fcn8_apply, jf, jd, batches, compute_dtype=jnp.float32, **kw)
    tf, td = both(jf)[1], both(jd)[1]
    got = tsearch.grid_search_eps_k_half(_jax_fcn_for_torch(jf), tf, td, batches, device="cpu", **kw)
    np.testing.assert_allclose(got["miou"], want["miou"], rtol=0, atol=1e-6)
    assert (got["best_eps"], got["best_k"]) == (want["best_eps"], want["best_k"])
    assert np.ptp(got["miou"]) > 0
    # row k equals the half engine run with num_steps=k (K=0: one rectification)
    for ei, eps in enumerate(EPS_GRID):
        for k in (0, K_MAX):
            fwd = tfused.flagship_forward_fn(eps=eps, num_steps=k, depth=3, compute_dtype=torch.float32,
                                             mode=mode, with_labels=True, fcn_apply=_jax_fcn_for_torch(jf))
            pl = []
            with tfused.no_autograd(mode):
                for x, lab in batches:
                    pl.append((fwd(tf, td, torch.from_numpy(x))[2], torch.from_numpy(lab)))
            assert _miou(pl) == got["miou"][ei, k], (eps, k)


def test_half_search_refuses_like_jax():
    _, jd = jax_params(stem_pool=0, depth=4, fcn_scale=1.0)
    with pytest.raises(ValueError, match="stem_pool"):
        tsearch.grid_search_eps_k_half(None, None, both(jd)[1], [], n_classes=C, eps_grid=(0.1,), k_max=1,
                                       device="cpu")
    _, jd = jax_params(stem_pool=1, depth=3)
    odd = [(np.zeros((1, 47, 64, 3), np.float32), np.zeros((1, 47, 64), np.int32))]
    with pytest.raises(ValueError, match="divisible"):
        tsearch.grid_search_eps_k_half(None, None, both(jd)[1], odd, n_classes=C, eps_grid=(0.1,), k_max=1,
                                       device="cpu")
