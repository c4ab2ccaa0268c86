"""``ops.corruption_kernel`` (K1, K2) and ``ops.corruption`` (the oracle).

The plain versions of K1/K2 against the TPU kernels they port
(``corrupt_onehot_pallas`` / ``corrupt_probs_pallas``, Pallas interpret
mode on the CPU) with the seed derived from the same JAX key; the wrappers'
routing and checks; the torch oracle against the JAX oracle's statistics;
and, on a card only, the CUDA kernels against their plain versions.

JAX is imported inside a fixture, so the card tests of this file also run
where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_corruption.py

Tolerances: at sigma = 0 no noise reaches K1's output, its exponentials
are exp(0) and exp(-1), and the plain version sums the softmax denominator
in the kernel's class order, so it is bit-equal to the Pallas kernel. K2 at
sigma = 0 takes exp of arbitrary values, where XLA's and PyTorch's f32 exp
differ by an ulp on about one argument in ten: within 4 ulps relative. At
sigma > 0 the two libms' log and cos differ by an ulp too, which moves an
output by ~1e-7: held to 1e-6.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from iterative_inference_segm_tpu_torch.ops import corruption as oracle  # noqa: E402
from iterative_inference_segm_tpu_torch.ops import corruption_kernel as ck  # noqa: E402

C = 11
SIGMA_TOL = 1e-6
EXP_ULPS = 4 * 2.0**-23
# At 128 classes the softmax's denominator has 128 terms: the port sums them
# class by class, as its kernel does, XLA's CPU reduction over the 128 lanes
# in another order, so the outputs are up to 16 ulps apart. The test below
# shows that this is the whole difference: the Pallas kernel's row is the
# plain version's numerators over ONE denominator within DEN_SPAN ulps of
# the exactly rounded sum (bit for bit for K1, whose numerators are exp(0)
# and exp(-1); within the 4 ulps of the two exps for K2).
WIDE_SUM_ULPS = 16 * 2.0**-23
DEN_SPAN = 8
# At sigma = 1 every class of every pixel, the rarest (8e-5) included, also
# agrees relatively (1.05e-6 at most here): a draw from another counter would
# move its class by a factor of order e.
SIGMA_RTOL = 4e-6


@pytest.fixture(scope="module")
def jx():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from iterative_inference_segm_tpu.ops import corruption as jcorr
    from iterative_inference_segm_tpu.ops.pallas import corrupt_onehot_pallas, corrupt_probs_pallas

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, jcorr=jcorr, onehot=corrupt_onehot_pallas, probs=corrupt_probs_pallas
    )


def _labels(shape=(2, 30, 17), lo=-2, hi=C + 2, seed=0):
    """Ragged 30x17 maps (not a multiple of the Pallas tile) with void
    labels >= C and < 0."""
    return np.random.default_rng(seed).integers(lo, hi, size=shape).astype(np.int32)


def _probs(shape=(2, 30, 17, C), seed=1):
    z = np.random.default_rng(seed).normal(size=shape) * 2.0
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _seed(jx, key):
    return ck.seed_from_key_data(jx.jax.random.key_data(key))


@pytest.mark.parametrize("sigma", [0.0, 0.7, 1.0])
@pytest.mark.parametrize("key_seed", [5, 123456])
def test_onehot_plain_matches_pallas_kernel(jx, sigma, key_seed):
    lab = _labels()
    key = jx.jax.random.PRNGKey(key_seed)
    want = np.asarray(jx.onehot(jx.jnp.asarray(lab), key, n_classes=C, sigma=sigma))
    got = ck.corrupt_onehot(torch.from_numpy(lab), _seed(jx, key), n_classes=C, sigma=sigma)
    assert got.dtype == torch.float32 and tuple(got.shape) == lab.shape + (C,)
    if sigma == 0.0:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        assert np.abs(got.numpy() - want).max() <= SIGMA_TOL
        assert (got.numpy().argmax(-1) == want.argmax(-1)).mean() == 1.0


@pytest.mark.parametrize("sigma", [0.0, 0.7, 1.0])
def test_probs_plain_matches_pallas_kernel(jx, sigma):
    p = _probs()
    key = jx.jax.random.PRNGKey(3)
    want = np.asarray(jx.probs(jx.jnp.asarray(p), key, sigma=sigma))
    got = ck.corrupt_probs(torch.from_numpy(p), _seed(jx, key), sigma=sigma)
    assert got.dtype == torch.float32 and tuple(got.shape) == p.shape
    if sigma == 0.0:
        # exp of arbitrary arguments: XLA's and PyTorch's f32 exp round
        # differently on about one argument in ten
        np.testing.assert_allclose(got.numpy(), want, rtol=EXP_ULPS, atol=0)
    else:
        assert np.abs(got.numpy() - want).max() <= SIGMA_TOL


def _over_one_denominator(e, want, rtol):
    """Whether each row of ``want`` is ``e`` over one f32 denominator among
    the 2 DEN_SPAN + 1 neighbours of the exactly rounded sum of ``e``'s row
    (every class within ``rtol`` of it; 0 for bit-equal)."""
    exact = e.astype(np.float64).sum(-1).astype(np.float32)
    cands, lo, hi = [exact], exact, exact
    for _ in range(DEN_SPAN):
        lo, hi = np.nextafter(lo, np.float32(0)), np.nextafter(hi, np.float32(np.inf))
        cands += [lo, hi]
    q = e[:, None, :] / np.stack(cands, 1)[:, :, None]
    return (np.abs(q - want[:, None, :]) <= rtol * want[:, None, :]).all(-1).any(-1)


@pytest.mark.parametrize("n_classes", [33, 128])
@pytest.mark.parametrize("which", ["onehot", "probs"])
def test_plain_versions_match_pallas_kernels_above_32_classes(jx, which, n_classes):
    """Up to the Pallas kernels' own 128 classes (one lane a class) the
    counter pixel * 128 + class draws their bits: both within 1e-6 at sigma
    = 1 with equal argmax, and every class within 4e-6 of its value; at
    sigma = 0 and 33 classes K1 bit-equal and K2 within 4 ulps, as at 11; at
    128 classes both within 16 ulps, all of it the order of the
    denominator's sum: the Pallas rows are the plain numerators over one
    denominator near the exact sum."""
    key = jx.jax.random.PRNGKey(7)
    for sigma in (0.0, 1.0):
        if which == "onehot":
            lab = _labels(shape=(1, 20, 13), hi=n_classes + 2)
            want = np.asarray(jx.onehot(jx.jnp.asarray(lab), key, n_classes=n_classes, sigma=sigma))
            got = ck.corrupt_onehot(torch.from_numpy(lab), _seed(jx, key), n_classes=n_classes, sigma=sigma).numpy()
            clean = (torch.from_numpy(lab).reshape(-1, 1) == torch.arange(n_classes)).float()
        else:
            p = _probs(shape=(1, 20, 13, n_classes))
            want = np.asarray(jx.probs(jx.jnp.asarray(p), key, sigma=sigma))
            got = ck.corrupt_probs(torch.from_numpy(p), _seed(jx, key), sigma=sigma).numpy()
            clean = torch.from_numpy(p).reshape(-1, n_classes)
        assert got.shape == want.shape
        if sigma > 0.0:
            assert np.abs(got - want).max() <= SIGMA_TOL
            assert (got.argmax(-1) == want.argmax(-1)).mean() == 1.0
            np.testing.assert_allclose(got, want, rtol=SIGMA_RTOL, atol=0)
        elif n_classes == 128:
            np.testing.assert_allclose(got, want, rtol=WIDE_SUM_ULPS, atol=0)
            # the numerators as the plain version computes them
            e = torch.exp(clean - clean.amax(dim=-1, keepdim=True)).numpy()
            rows = want.reshape(-1, n_classes)
            assert _over_one_denominator(e, rows, 0.0 if which == "onehot" else EXP_ULPS).all()
            if which == "onehot":
                # and the plain version's class-by-class sum is not that denominator: the
                # two differ in the sum alone
                assert not _over_one_denominator(e, got.reshape(-1, n_classes), 0.0).all()
        elif which == "onehot":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=EXP_ULPS, atol=0)


def test_more_than_128_classes_are_refused_as_in_jax(jx):
    """The counter has room for 128 classes a pixel; both packages refuse
    more, on any device."""
    lab = np.zeros((1, 4, 4), np.int32)
    with pytest.raises(ValueError, match="128"):
        jx.onehot(jx.jnp.asarray(lab), jx.jax.random.PRNGKey(0), n_classes=129, sigma=1.0)
    with pytest.raises(ValueError, match="129 classes.*1..128"):
        ck.corrupt_onehot(torch.from_numpy(lab), 0, n_classes=129, sigma=1.0)
    with pytest.raises(ValueError, match="129 classes.*1..128"):
        ck.corrupt_probs(torch.full((1, 4, 4, 129), 1.0 / 129), 0, sigma=1.0)
    assert ck.MAX_CLASSES == 128


def test_probs_plain_takes_bf16_input_as_pallas_does(jx):
    p = torch.from_numpy(_probs()).to(torch.bfloat16)
    key = jx.jax.random.PRNGKey(4)
    want = np.asarray(jx.probs(jx.jnp.asarray(p.float().numpy(), jx.jnp.bfloat16), key, sigma=0.8))
    got = ck.corrupt_probs(p, _seed(jx, key), sigma=0.8)
    assert got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= SIGMA_TOL


def test_seed_from_key_data_matches_the_jax_wrapper(jx):
    """The wrappers' ``kd[0] ^ (kd[-1] << 7)``, wrapping mod 2^32."""
    kd = np.array([0x12345678, 0xFFFFFFFF], np.uint32)
    assert ck.seed_from_key_data(kd) == (0x12345678 ^ ((0xFFFFFFFF << 7) & 0xFFFFFFFF))
    key = jx.jax.random.PRNGKey(9)
    kdj = jx.jax.random.key_data(key).astype(jx.jnp.uint32).reshape(-1)
    want = int(np.asarray((kdj[0] ^ (kdj[-1] << 7)).astype(jx.jnp.int32)).view(np.uint32))
    assert _seed(jx, key) == want


def test_void_rows_are_exactly_uniform_at_sigma_zero():
    lab = torch.tensor([[[-1, C, C + 5, 3]]], dtype=torch.int32)
    out = ck.corrupt_onehot(lab, 17, n_classes=C, sigma=0.0)
    void = out[0, 0, :3]
    assert torch.equal(void, torch.full_like(void, 1.0 / C))
    assert int(out[0, 0, 3].argmax()) == 3


def test_rows_sum_to_one_and_seed_changes_output():
    lab = torch.from_numpy(_labels(lo=0, hi=C))
    a = ck.corrupt_onehot(lab, 1, n_classes=C, sigma=1.0)
    b = ck.corrupt_onehot(lab, 1, n_classes=C, sigma=1.0)
    c = ck.corrupt_onehot(lab, 2, n_classes=C, sigma=1.0)
    assert torch.equal(a, b)
    assert (a - c).abs().max() > 0.1
    assert (a.sum(-1) - 1.0).abs().max() <= 1e-6
    p = torch.from_numpy(_probs())
    assert (ck.corrupt_probs(p, 1, sigma=1.0) - ck.corrupt_probs(p, 2, sigma=1.0)).abs().max() > 0.1


def test_kernel_noise_is_standard_normal():
    z = ck.kernel_noise(20000, C, 99)
    assert abs(float(z.mean())) < 0.01 and abs(float(z.std()) - 1.0) < 0.01
    # the counter wraps mod 2^32 like the TPU kernel's uint32 counter:
    # pixel p and pixel p + 2^25 share a counter (2^25 * 128 = 2^32)
    big = ck._fmix32(torch.tensor([(2**25 + 3) * 128 & 0xFFFFFFFF, 3 * 128]))
    assert int(big[0]) == int(big[1])


def test_mul32_is_exact_where_int64_would_overflow():
    x = torch.tensor([0xFFFFFFFF, 0x9E3779B9, 12345, 0], dtype=torch.int64)
    for k in (0x85EBCA6B, 0xC2B2AE35, 0x9E3779B9, 0x85EBCA77):
        want = [(int(v) * k) & 0xFFFFFFFF for v in x]
        assert ck._mul32(x, k).tolist() == want


@pytest.mark.parametrize(
    "case", ["float_labels", "too_many_classes", "zero_classes", "empty", "int_probs", "meta"]
)
def test_wrappers_reject_what_the_kernels_do_not_take(case):
    lab = torch.zeros((1, 4, 4), dtype=torch.int32)
    p = torch.full((1, 4, 4, C), 1.0 / C)
    with pytest.raises((TypeError, ValueError)):
        if case == "float_labels":
            ck.corrupt_onehot(lab.float(), 0, n_classes=C, sigma=1.0)
        elif case == "too_many_classes":
            ck.corrupt_onehot(lab, 0, n_classes=ck.MAX_CLASSES + 1, sigma=1.0)
        elif case == "zero_classes":
            ck.corrupt_probs(p[..., :0], 0, sigma=1.0)
        elif case == "empty":
            ck.corrupt_onehot(lab[:, :0], 0, n_classes=C, sigma=1.0)
        elif case == "int_probs":
            ck.corrupt_probs(p.to(torch.int32), 0, sigma=1.0)
        else:
            ck.corrupt_onehot(lab.to("meta"), 0, n_classes=C, sigma=1.0)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = (ck.corrupt_onehot.launches, ck.corrupt_probs.launches)
    lab = torch.from_numpy(_labels())
    got = ck.corrupt_onehot(lab, 5, n_classes=C, sigma=0.5)
    want = ck.corrupt_onehot_kernel_reference(lab, 5, n_classes=C, sigma=0.5)
    assert torch.equal(got, want)
    ck.corrupt_probs(torch.from_numpy(_probs()), 5, sigma=0.5)
    assert (ck.corrupt_onehot.launches, ck.corrupt_probs.launches) == before


def test_oracle_matches_jax_oracle_statistics(jx):
    """The torch oracle (``torch.randn``) and the JAX oracle draw different
    streams; their distributions match, as tests/test_pallas_kernels.py
    holds the Pallas kernel to the JAX oracle."""
    labels = np.zeros((4, 64, 64), np.int32)
    sigma = 0.7
    a = oracle.corrupt_onehot(torch.from_numpy(labels), torch.Generator().manual_seed(5),
                              n_classes=C, sigma=sigma).numpy()
    b = np.asarray(jx.jcorr.corrupt_onehot(jx.jnp.asarray(labels), jx.jax.random.PRNGKey(6),
                                           n_classes=C, sigma=sigma))
    assert abs(a.mean() - b.mean()) < 5e-3
    assert abs(a.std() - b.std()) < 5e-3
    assert abs((a.argmax(-1) == 0).mean() - (b.argmax(-1) == 0).mean()) < 0.03
    # ... and so does K1's plain version
    k = ck.corrupt_onehot(torch.from_numpy(labels), 11, n_classes=C, sigma=sigma).numpy()
    assert abs(k.std() - b.std()) < 5e-3


def test_oracle_matches_jax_oracle_exactly_without_noise(jx):
    lab = _labels()
    a = oracle.corrupt_onehot(torch.from_numpy(lab), torch.Generator(), n_classes=C, sigma=0.0)
    b = jx.jcorr.corrupt_onehot(jx.jnp.asarray(lab), jx.jax.random.PRNGKey(0), n_classes=C, sigma=0.0)
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(
        oracle.one_hot_probs(torch.from_numpy(lab), C).numpy(),
        np.asarray(jx.jcorr.one_hot_probs(jx.jnp.asarray(lab), C)),
    )
    p = _probs()
    a = oracle.corrupt_probs(torch.from_numpy(p), torch.Generator(), sigma=0.0)
    b = jx.jcorr.corrupt_probs(jx.jnp.asarray(p), jx.jax.random.PRNGKey(0), sigma=0.0)
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


def test_oracle_is_deterministic_in_its_generator():
    lab = torch.from_numpy(_labels(lo=0, hi=C))
    draw = lambda s: oracle.corrupt_onehot(lab, torch.Generator().manual_seed(s), n_classes=C, sigma=1.0)  # noqa: E731
    assert torch.equal(draw(3), draw(3))
    assert not torch.allclose(draw(3), draw(4))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _unaligned(t):
    """``t`` as a view that starts 4 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    buf[1:].copy_(t.reshape(-1))
    return buf[1:].view(t.shape)


# (kernel, classes, variant): C = 11 takes the exact instance, every other C
# the general one; 3 x 45 x 61 = 8235 pixels leave a last tile of 43 of the
# 128-pixel tile (473 elements at C = 11: the stores' scalar tail runs);
# labels run from -2 to C + 1 (void below 0 and at or above C); probs in
# bf16 (the wrapper widens them) or at an address that is not 16-byte
# aligned (the kernel stages them element by element).
# 33, 64 and 128 classes take the wide instance (a pixel's classes in shared
# memory, 64-pixel tiles: the last of 8235 pixels holds 43).
CARD_CASES = [(w, c, "f32") for w in ("onehot", "probs") for c in (1, 2, 11, 16, 17, 32, 33, 64, 128)] + [
    ("probs", 64, "bf16"), ("probs", 33, "unaligned"),
    ("probs", 11, "bf16"), ("probs", 2, "bf16"), ("probs", 11, "unaligned"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("sigma", [0.0, 1.0])
@pytest.mark.parametrize("which,n_classes,variant", CARD_CASES)
def test_kernels_match_plain_versions_on_card(cuda_device, sigma, which, n_classes, variant):
    """Bit for bit: the kernel and the plain version run the same f32
    operations in the same order, and on the card the same libm."""
    shape = (3, 45, 61)
    if which == "onehot":
        src = torch.from_numpy(_labels(shape=shape, hi=n_classes + 2)).to(cuda_device)
        fn, ref = ck.corrupt_onehot, ck.corrupt_onehot_kernel_reference
        kw = {"n_classes": n_classes, "sigma": sigma}
    else:
        src = torch.from_numpy(_probs(shape=(*shape, n_classes))).to(cuda_device)
        if variant == "bf16":
            src = src.to(torch.bfloat16)
        elif variant == "unaligned":
            src = _unaligned(src)
            assert src.data_ptr() % 16 == 4
        fn, ref = ck.corrupt_probs, ck.corrupt_probs_kernel_reference
        kw = {"sigma": sigma}
    before = fn.launches
    got = fn(src, 0xDEADBEEF, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = ref(src, 0xDEADBEEF, **kw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, want)
