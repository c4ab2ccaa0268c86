"""The port's FCN-8 and DAE against the JAX package's, with the JAX params
carried across by ``utils/jax_bridge``, on the same numpy inputs (CPU).

Tolerances: f32 whole-model outputs within 1e-4 (about twenty convolutions
summed in another order); bf16 within 0.1 (mean 5e-3) plus argmax agreement
>= 99%.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from iterative_inference_segm_tpu.models import dae as jdae  # noqa: E402
from iterative_inference_segm_tpu.models import fcn8 as jfcn8  # noqa: E402
from iterative_inference_segm_tpu_torch.models import dae as tdae  # noqa: E402
from iterative_inference_segm_tpu_torch.models import fcn8 as tfcn8  # noqa: E402
from iterative_inference_segm_tpu_torch.utils.jax_bridge import params_from_jax  # noqa: E402

C = 5
TOL = dict(rtol=1e-4, atol=1e-4)


def _jax_randomize_up(tree, seed):
    """Random transposed-conv weights (the bilinear init is flip-symmetric)."""
    rng = np.random.default_rng(seed)
    return {
        k: ({kk: jnp.asarray(rng.normal(size=v.shape).astype(np.float32) * 0.3) for kk, v in lv.items()}
            if k.startswith("up") else lv)
        for k, lv in tree.items()
    }


@pytest.fixture(scope="module")
def fcn():
    j = _jax_randomize_up(jfcn8.init_fcn8(jax.random.PRNGKey(0), n_classes=C, fc_channels=16), 0)
    return j, params_from_jax(j)


def _dae(stem_pool, depth=3, h_specs=None):
    j = jdae.init_dae(
        jax.random.PRNGKey(1), n_classes=C, h_specs=h_specs or {"pool4": 512}, depth=depth,
        stem_pool=stem_pool, widths=(8, 16, 32, 64)[:depth],
    )
    j = _jax_randomize_up(j, 1)
    return j, params_from_jax(j)


def _img(shape=(2, 48, 64, 3), seed=2):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _probs(shape, seed):
    z = np.random.default_rng(seed).normal(size=shape).astype(np.float32) * 2
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def test_init_shapes_match_jax():
    jf = jfcn8.init_fcn8(jax.random.PRNGKey(0), n_classes=C, fc_channels=16)
    tf = tfcn8.init_fcn8(torch.Generator().manual_seed(0), n_classes=C, fc_channels=16)
    for j, t in ((jf, tf), (_dae(1)[0], tdae.init_dae(torch.Generator(), n_classes=C, h_specs={"pool4": 512},
                                                     depth=3, stem_pool=1, widths=(8, 16, 32)))):
        ported = params_from_jax(j)
        assert set(ported) == set(t)
        for layer in t:
            assert {k: tuple(v.shape) for k, v in t[layer].items()} == \
                   {k: tuple(v.shape) for k, v in ported[layer].items()}, layer
    # bilinear deconv inits equal the JAX ones exactly
    assert torch.equal(tf["upscore8"]["w"], params_from_jax(jf)["upscore8"]["w"])


def test_init_dae_rejects_like_jax():
    with pytest.raises(ValueError, match="stem_pool=1"):
        tdae.init_dae(torch.Generator(), n_classes=C, stem_pool=0, tail="sep")
    with pytest.raises(ValueError):
        tdae.init_dae(torch.Generator(), n_classes=C, tail="wide")
    with pytest.raises(ValueError):
        tdae.init_dae(torch.Generator(), n_classes=C, h_specs={"pool2": 128}, stem_pool=3)
    with pytest.raises(ValueError):
        tdae.init_dae(torch.Generator(), n_classes=C, depth=5)


def test_fcn8_apply_matches_jax(fcn):
    jp, tp = fcn
    x = _img()
    taps = ("pool4", "pool3", "fc7", "score")
    jprobs, jfeat = jfcn8.fcn8_apply(jp, jnp.asarray(x), return_features=taps)
    tprobs, tfeat = tfcn8.fcn8_apply(tp, torch.from_numpy(x), return_features=taps)
    assert tprobs.dtype == torch.float32 and tuple(tprobs.shape) == (2, 48, 64, C)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), **TOL)
    for k in taps:
        assert tuple(tfeat[k].shape) == tuple(jfeat[k].shape), k
        np.testing.assert_allclose(tfeat[k].numpy(), np.asarray(jfeat[k]), **TOL)


def test_fcn8_bf16_probs(fcn):
    jp, tp = fcn
    x = _img(seed=3)
    jprobs, _ = jfcn8.fcn8_apply(jp, jnp.asarray(x), compute_dtype=jnp.bfloat16, probs_dtype=jnp.bfloat16)
    tprobs, _ = tfcn8.fcn8_apply(tp, torch.from_numpy(x), compute_dtype=torch.bfloat16,
                                 probs_dtype=torch.bfloat16)
    assert tprobs.dtype == torch.bfloat16
    j = np.asarray(jprobs.astype(jnp.float32))
    t = tprobs.float().numpy()
    # bf16 roundings at different places through ~20 layers: measured max
    # 0.047, mean 1.5e-3, argmax agreement 99.6% over three seeds
    d = np.abs(t - j)
    assert d.max() <= 0.1 and d.mean() <= 5e-3
    assert (t.argmax(-1) == j.argmax(-1)).mean() >= 0.99


def test_fcn8_dropout_only_with_generator(fcn):
    _, tp = fcn
    x = torch.from_numpy(_img(seed=4))
    a, _ = tfcn8.fcn8_apply(tp, x)
    b, _ = tfcn8.fcn8_apply(tp, x)
    assert torch.equal(a, b)
    c, _ = tfcn8.fcn8_apply(tp, x, generator=torch.Generator().manual_seed(0))
    d, _ = tfcn8.fcn8_apply(tp, x, generator=torch.Generator().manual_seed(0))
    assert torch.equal(c, d) and not torch.allclose(a, c)


def test_precompute_bottleneck_h_matches_jax():
    jp, tp = _dae(1)
    h = np.random.default_rng(5).normal(size=(2, 3, 4, 512)).astype(np.float32)
    jb = jdae.precompute_bottleneck_h(jp, {"pool4": jnp.asarray(h)}, depth=3, stem_pool=1, in_hw=(24, 32))
    tb = tdae.precompute_bottleneck_h(tp, {"pool4": torch.from_numpy(h)}, depth=3, stem_pool=1, in_hw=(24, 32))
    assert tb[1] == jb[1] and tb[2] == {} and jb[2] == {}
    np.testing.assert_allclose(tb[0].numpy(), np.asarray(jb[0]), **TOL)
    assert tdae.precompute_bottleneck_h(tp, {}, depth=3, stem_pool=1, in_hw=(24, 32))[0] is None


@pytest.mark.parametrize("encoder", ["pool", "stride"])
@pytest.mark.parametrize("predense", [False, True])
@pytest.mark.parametrize("folded_h", [False, True])
def test_dae_core_matches_jax(encoder, predense, folded_h):
    jp, tp = _dae(1)
    x = _probs((2, 24, 32, C), 6)
    h = np.random.default_rng(7).normal(size=(2, 3, 4, 512)).astype(np.float32)
    jh, th = {"pool4": jnp.asarray(h)}, {"pool4": torch.from_numpy(h)}
    kw = dict(depth=3, stem_pool=1, encoder=encoder, predense=predense)
    if folded_h:
        jb = jdae.precompute_bottleneck_h(jp, jh, depth=3, stem_pool=1, in_hw=(24, 32))
        tb = tdae.precompute_bottleneck_h(tp, th, depth=3, stem_pool=1, in_hw=(24, 32))
        jh, th = jb[2], tb[2]
        kw_j, kw_t = dict(kw, bottleneck_h=jb), dict(kw, bottleneck_h=tb)
    else:
        kw_j = kw_t = kw
    want = jdae.dae_core(jp, jnp.asarray(x), jh, **kw_j)
    got = tdae.dae_core(tp, torch.from_numpy(x), th, **kw_t)
    if predense:
        (want, wskip), (got, gskip) = want, got
        assert (gskip is None) == (wskip is None)
        if wskip is not None:
            np.testing.assert_allclose(gskip.numpy(), np.asarray(wskip), **TOL)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize(
    "stem_pool,hw,depth",
    [(0, (48, 64), 4), (1, (48, 64), 3), (1, (47, 63), 3), (2, (48, 64), 2)],
)
def test_dae_apply_matches_jax(stem_pool, hw, depth):
    """Odd sizes take the edge-padded stem."""
    jp, tp = _dae(stem_pool, depth=depth)
    y = _probs((2, *hw, C), 8)
    sp4 = -(-hw[0] // 16), -(-hw[1] // 16)
    h = np.random.default_rng(9).normal(size=(2, *sp4, 512)).astype(np.float32)
    want = jdae.dae_apply(jp, jnp.asarray(y), {"pool4": jnp.asarray(h)}, depth=depth)
    got = tdae.dae_apply(tp, torch.from_numpy(y), {"pool4": torch.from_numpy(h)}, depth=depth)
    assert tuple(got.shape) == (2, *hw, C)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
