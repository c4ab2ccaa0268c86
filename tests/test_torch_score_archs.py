"""The mirror DAE (untied and tied) and the context module against the JAX
package on the CPU: ``max_unpool`` on the tie cases, ``upsample_pool_
indices``, ``adjoint_kernel`` as the transpose, both networks' apply and
logits, the general engine in score and energy modes with each, the
registry's branches, ``Predictor`` and the trainers with the new archs; and
a 'sep'-tail DAE train step against the JAX step. Small shapes: C = 5,
48x64 (and odd sizes), mirror widths (8, 16, 32, 64).

Tolerances, f32: 1e-5 (the convolutions sum their fan-in in another order
on each side); 1e-4 for whole ``Predictor`` paths, which also run both FCNs.
``max_unpool`` is held bit-equal: the same values land at the same
positions. bf16 networks by the mean difference and the argmax.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch_port_helpers import TINY_J, TINY_T, images, jax_params, probs  # noqa: E402

from iterative_inference_segm_tpu.inference import iterative as jit_  # noqa: E402
from iterative_inference_segm_tpu.inference.predictor import Predictor as JPredictor  # noqa: E402
from iterative_inference_segm_tpu.models import contextmod as jctx  # noqa: E402
from iterative_inference_segm_tpu.models import dae_mirror as jmir  # noqa: E402
from iterative_inference_segm_tpu.models import fcn8 as jfcn8  # noqa: E402
from iterative_inference_segm_tpu.models import registry as jreg  # noqa: E402
from iterative_inference_segm_tpu.ops import conv as jconv  # noqa: E402
from iterative_inference_segm_tpu.train import loop as jloop  # noqa: E402
from iterative_inference_segm_tpu.train.train_dae import make_dae_train_step as j_make_step  # noqa: E402
from iterative_inference_segm_tpu.utils import checkpoint as jckpt  # noqa: E402
from iterative_inference_segm_tpu_torch.data import synthetic as tsynth  # noqa: E402
from iterative_inference_segm_tpu_torch.inference import fused as tfused  # noqa: E402
from iterative_inference_segm_tpu_torch.inference import iterative as tit  # noqa: E402
from iterative_inference_segm_tpu_torch.inference.predictor import Predictor  # noqa: E402
from iterative_inference_segm_tpu_torch.models import dae_mirror as tmir  # noqa: E402
from iterative_inference_segm_tpu_torch.models import fcn8 as tfcn8  # noqa: E402
from iterative_inference_segm_tpu_torch.models import registry as treg  # noqa: E402
from iterative_inference_segm_tpu_torch.ops import conv as tconv  # noqa: E402
from iterative_inference_segm_tpu_torch.train import loop as tloop  # noqa: E402
from iterative_inference_segm_tpu_torch.train.train_dae import StepRandomness, make_dae_train_step, train_dae  # noqa: E402
from iterative_inference_segm_tpu_torch.utils import checkpoint as tckpt  # noqa: E402
from iterative_inference_segm_tpu_torch.utils.jax_bridge import params_from_jax, params_to_jax  # noqa: E402

C = 5
TOL = dict(rtol=1e-5, atol=1e-5)
WIDTHS = (8, 16, 32, 64)
EPS = 0.3


def taps_of(arch, depth=4):
    """The context module conditions on the input; the mirror DAE on the FCN
    tap at its bottleneck (pool4 at depth 4, pool3 at depth 3)."""
    return ("input",) if arch == "contextmod" else (f"pool{depth}",)


# -- max_unpool: XLA's select_and_scatter keeps a window's first maximum ----

def _tie_case(name):
    """(pre, g) with many tied windows: ReLU'd small integers (all-zero and
    exactly tied windows), or pre with every value equal."""
    rng = np.random.default_rng(abs(hash(name)) % 2**32)
    shape = {"zero_windows": (2, 6, 8, 3), "exact_ties": (2, 6, 8, 3), "ragged_odd": (2, 7, 9, 4),
             "ragged_one_wide": (1, 5, 1, 2), "all_equal": (1, 5, 7, 2)}[name]
    if name == "zero_windows":
        pre = np.maximum(rng.normal(size=shape), 0) * (rng.random(shape) < 0.3)
    elif name == "all_equal":
        pre = np.full(shape, 0.5)
    else:
        pre = np.maximum(rng.integers(-2, 3, shape), 0)
    pooled = (shape[0], -(-shape[1] // 2), -(-shape[2] // 2), shape[3])
    return pre.astype(np.float32), rng.normal(size=pooled).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["zero_windows", "exact_ties", "ragged_odd", "ragged_one_wide", "all_equal"])
def test_max_unpool_picks_the_jax_positions(case, dtype):
    pre, g = _tie_case(case)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jconv.max_unpool(jnp.asarray(g, jd), jnp.asarray(pre, jd)).astype(jnp.float32))
    got = tconv.max_unpool(torch.from_numpy(g).to(td), torch.from_numpy(pre).to(td))
    assert got.dtype == td and tuple(got.shape) == pre.shape
    np.testing.assert_array_equal(got.float().numpy(), want)
    # exactly one position a window (a window's values may be all 0 or tied)
    assert int((got != 0).sum()) == int((torch.from_numpy(g).to(td) != 0).sum())


def test_max_unpool_is_linear_in_g_and_pre_is_a_constant():
    pre, g = _tie_case("exact_ties")
    tp = torch.from_numpy(pre).requires_grad_(True)
    tg = torch.from_numpy(g).requires_grad_(True)
    out = tconv.max_unpool(tg, tp)
    (out * torch.arange(out.numel()).reshape(out.shape)).sum().backward()
    assert tp.grad is None
    want = jax.grad(lambda gg: jnp.sum(jconv.max_unpool(gg, jnp.asarray(pre)) * jnp.arange(out.numel()).reshape(
        out.shape)))(jnp.asarray(g))
    np.testing.assert_array_equal(tg.grad.numpy(), np.asarray(want))


def test_upsample_pool_indices_matches_jax():
    x = np.random.default_rng(0).normal(size=(2, 3, 5, 4)).astype(np.float32)
    for f in (2, 3):
        np.testing.assert_array_equal(tconv.upsample_pool_indices(torch.from_numpy(x), factor=f).numpy(),
                                      np.asarray(jconv.upsample_pool_indices(jnp.asarray(x), factor=f)))


@pytest.mark.parametrize("cin,cout,k", [(3, 5, 3), (8, 2, 5), (4, 4, 1)])
def test_adjoint_kernel_is_the_transpose(cin, cout, k):
    """<conv(x, w), y> = <x, conv(y, adjoint(w))> for SAME-padded odd k, and
    the kernel is the JAX one in the port's layout."""
    rng = np.random.default_rng(k)
    w = torch.from_numpy(rng.normal(size=(cout, cin, k, k)).astype(np.float64))
    x = torch.from_numpy(rng.normal(size=(2, 7, 9, cin)))
    y = torch.from_numpy(rng.normal(size=(2, 7, 9, cout)))
    lhs = (tconv.conv2d(x, w) * y).sum()
    rhs = (x * tconv.conv2d(y, tmir.adjoint_kernel(w))).sum()
    assert abs(float(lhs - rhs)) <= 1e-10 * float(abs(lhs))
    w = w.float()
    jw = w.numpy().transpose(2, 3, 1, 0)  # OIHW -> HWIO
    np.testing.assert_array_equal(tmir.adjoint_kernel(w).numpy(),
                                  np.asarray(jmir.adjoint_kernel(jnp.asarray(jw))).transpose(3, 2, 0, 1))


# -- the networks -----------------------------------------------------------

def _randomized(tree, seed):
    """Random biases (the init's are 0) so that a dropped bias shows."""
    rng = np.random.default_rng(seed)
    return {k: {kk: (jnp.asarray(rng.normal(size=v.shape).astype(np.float32) * 0.1) if kk == "b" else v)
                for kk, v in lv.items()} for k, lv in tree.items()}


def jax_score_net(arch, tied=False, depth=4):
    return _randomized(jreg.init_score_template(arch, jax.random.PRNGKey(5), n_classes=C,
                                                h_taps=taps_of(arch, depth), depth=depth, widths=WIDTHS[:depth],
                                                tied=tied), 1)


ARCHS = [("mirror", False, 4), ("mirror", True, 4), ("mirror", False, 3), ("contextmod", False, 4)]
ARCH_IDS = ["mirror", "mirror_tied", "mirror_depth3", "contextmod"]


@pytest.fixture(scope="module")
def fcn():
    jf, _ = jax_params()
    x = jnp.asarray(images())
    y0, h = jfcn8.fcn8_apply(jf, x, return_features=("pool3", "pool4", "input"))
    return {"jf": jf, "y0": y0, "h": h, "ty0": torch.from_numpy(np.asarray(y0)),
            "th": {k: torch.from_numpy(np.asarray(v)) for k, v in h.items()}}


def _taps(fcn, arch, port, depth=4):
    return {name: (fcn["th"] if port else fcn["h"])[name] for name in taps_of(arch, depth)}


@pytest.mark.parametrize("arch,tied,depth", ARCHS, ids=ARCH_IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_and_logits_match_jax(fcn, arch, tied, depth, dtype):
    jp = jax_score_net(arch, tied, depth)
    tp = params_from_jax(jp)
    assert ("w" in tp["dec1"]) != tied if arch == "mirror" else "ctx7" in tp
    y = probs((2, 48, 64, C), seed=3)
    jkw = {"compute_dtype": getattr(jnp, dtype), **({"depth": depth} if arch == "mirror" else {})}
    tkw = {"compute_dtype": getattr(torch, dtype), **({"depth": depth} if arch == "mirror" else {})}
    japply = jmir.mirror_dae_apply if arch == "mirror" else jctx.contextmod_apply
    want = np.asarray(japply(jp, jnp.asarray(y), _taps(fcn, arch, False, depth), **jkw))
    got = treg.score_apply_fn(arch)(tp, torch.from_numpy(y), _taps(fcn, arch, True, depth), **tkw)
    logits = treg.score_logits_fn(arch)(tp, torch.from_numpy(y), _taps(fcn, arch, True, depth), **tkw)
    assert got.dtype == torch.float32 and tuple(got.shape) == y.shape
    assert logits.dtype == (torch.float32 if arch == "contextmod" else getattr(torch, dtype))
    torch.testing.assert_close(torch.softmax(logits.float(), -1), got, rtol=0, atol=0)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    else:
        # bf16 activations rounded at other places; in the mirror a rounding
        # that breaks or makes a tie moves an unpool switch, and the value
        # lands a pixel away (measured over three inputs: mean |d| 4.6e-4
        # contextmod, 1.0e-3..8.5e-3 mirror, the tied one the most; argmax
        # 99.3% / 93.7..99.5%)
        d = np.abs(got.numpy() - want)
        assert d.mean() <= 0.015 and (got.numpy().argmax(-1) == want.argmax(-1)).mean() >= 0.92


def test_tied_mirror_carries_no_decoder_kernels_and_uses_the_adjoints():
    jp = jax_score_net("mirror", tied=True)
    tp = params_from_jax(jp)
    assert all(set(tp[f"dec{i}"]) == {"b"} for i in (1, 2, 3, 4)) and tmir.mirror_tied_of(tp)
    assert tmir.mirror_depth_of(tp) == 4 and "mid" in tp
    untied = {**tp, **{f"dec{i}": {"w": tmir.adjoint_kernel(tp[f"enc{i}"]["w"]), "b": tp[f"dec{i}"]["b"]}
                       for i in (1, 2, 3, 4)}}
    y = torch.from_numpy(probs((1, 48, 64, C), seed=4))
    h = {"pool4": torch.randn((1, 3, 4, 512), generator=torch.Generator().manual_seed(0))}
    torch.testing.assert_close(tmir.mirror_dae_logits(tp, y, h), tmir.mirror_dae_logits(untied, y, h),
                               rtol=0, atol=0)


@pytest.mark.parametrize("arch,tied,depth", ARCHS, ids=ARCH_IDS)
@pytest.mark.parametrize("mode", ["score", "energy"])
def test_general_engine_matches_jax(fcn, arch, tied, depth, mode):
    jp = jax_score_net(arch, tied, depth)
    tp = params_from_jax(jp)
    jkw = treg.score_kwargs(arch, depth=depth)
    jfn = lambda y: jreg.score_apply_fn(arch)(jp, y, _taps(fcn, arch, False, depth), **jkw)  # noqa: E731
    tfn = lambda y: treg.score_logits_fn(arch)(tp, y, _taps(fcn, arch, True, depth), **jkw)  # noqa: E731
    kw = dict(eps=EPS, num_steps=3, mode=mode)
    want = np.asarray(jit_.refinement_scan(jfn, fcn["y0"], **kw))
    with tfused.no_autograd(mode):
        got = tit.logits_refinement_scan(tfn, fcn["ty0"], **kw)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert np.abs(want - np.asarray(fcn["y0"])).max() > 1e-3  # the steps moved y


@pytest.mark.parametrize("arch,tied", [("mirror", False), ("mirror", True), ("contextmod", False)])
def test_predictor_general_engine_matches_jax(fcn, arch, tied):
    jp = jax_score_net(arch, tied)
    kw = dict(num_steps=2, eps=EPS, batch_size=2, h_taps=taps_of(arch), dae_arch=arch,
              dae_kwargs=treg.score_kwargs(arch, depth=4))
    imgs = images(3, seed=6)
    want_lab, want = JPredictor(fcn["jf"], jp, dataset=TINY_J, compute_dtype=jnp.float32, **kw).predict(
        imgs, return_probs=True)
    lab, got = Predictor(params_from_jax(fcn["jf"]), params_from_jax(jp), device="cpu", dataset=TINY_T,
                         compute_dtype=torch.float32, **kw).predict(imgs, return_probs=True)
    # both FCNs run too: their last-ulp differences grow through K steps
    # (measured: 25-28 of 46080 values beyond 1e-5, the largest 1.8e-5)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert (lab == want_lab).mean() >= 0.999


# -- registry, entry points, refusals ---------------------------------------

@pytest.mark.parametrize("arch,tied", [("mirror", False), ("mirror", True), ("contextmod", False)])
def test_registry_matches_jax_and_round_trips_a_checkpoint(tmp_path, arch, tied):
    taps = taps_of(arch)
    kw = dict(h_taps=taps, depth=4, widths=WIDTHS, tied=tied)
    meta = treg.checkpoint_meta(arch, **kw)
    assert meta == jreg.checkpoint_meta(arch, **kw)
    load_kw = dict(depth=4, widths=WIDTHS, tied=tied)
    assert treg.expected_meta(arch, **load_kw) == jreg.expected_meta(arch, **load_kw)
    assert treg.score_kwargs(arch, depth=4) == jreg.score_kwargs(arch, depth=4)
    t = treg.init_score_template(arch, torch.Generator().manual_seed(0), n_classes=C, h_taps=taps, depth=4,
                                 widths=WIDTHS, tied=tied)
    j = jreg.init_score_template(arch, jax.random.PRNGKey(0), n_classes=C, h_taps=taps, depth=4,
                                 widths=WIDTHS, tied=tied)
    assert {k: {kk: v.shape for kk, v in lv.items()} for k, lv in params_to_jax(t).items()} == \
        {k: {kk: tuple(v.shape) for kk, v in lv.items()} for k, lv in j.items()}
    # the port's npz, stamped, loads in the JAX package and back under the same flags
    tckpt.save_npz(tmp_path / "s.npz", t, meta=meta)
    jckpt.check_npz_meta(tmp_path / "s.npz", jreg.expected_meta(arch, **load_kw))
    jckpt.load_npz(tmp_path / "s.npz", j)
    tckpt.check_npz_meta(tmp_path / "s.npz", treg.expected_meta(arch, **load_kw))
    back = tckpt.load_npz(tmp_path / "s.npz", t)
    assert all(torch.equal(back[k][kk], v) for k, lv in t.items() for kk, v in lv.items())
    if arch == "mirror":
        with pytest.raises(ValueError, match="tied"):
            tckpt.check_npz_meta(tmp_path / "s.npz", treg.expected_meta(arch, **{**load_kw, "tied": not tied}))


@pytest.mark.parametrize("refusal", ["contextmod_pool4_tap", "tied_dae", "half_engine_mirror",
                                     "half_engine_contextmod", "mirror_tap_too_deep"])
def test_new_refusals(refusal):
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError):
        if refusal == "contextmod_pool4_tap":
            treg.init_score_template("contextmod", gen, n_classes=C, h_taps=("pool4",))
        elif refusal == "tied_dae":
            treg.init_score_template("dae", gen, n_classes=C, tied=True)
        elif refusal.startswith("half_engine"):
            Predictor({}, None, device="cpu", engine="half", dae_arch=refusal.rsplit("_", 1)[1])
        else:
            treg.init_score_template("mirror", gen, n_classes=C, h_taps=("pool4",), depth=3)


@pytest.mark.parametrize("arch,tied", [("mirror", True), ("contextmod", False)])
def test_train_dae_with_the_new_archs_and_serve_from_npz(tmp_path, arch, tied):
    cfg = dataclasses.replace(TINY_T, height=48, width=64, train_crop=(32, 32))
    data = list(tsynth.synthetic_batches(cfg=cfg, batch_size=2, num_batches=2, height=48, width=64, seed=0))
    taps = taps_of(arch)
    fcn = tfcn8.init_fcn8(torch.Generator().manual_seed(0), n_classes=C, fc_channels=16)
    r = train_dae(fcn_params=fcn, dataset=cfg, train_data=data, val_data=data[:1], h_taps=taps,
                  dae_depth=4, dae_widths=WIDTHS, arch=arch, dae_tied=tied, sigma=0.5,
                  tcfg=tloop.TrainConfig(max_epochs=1), workdir=str(tmp_path))
    assert np.isfinite(r["history"][0]["train_loss"])
    assert jckpt.read_npz_meta(tmp_path / "best_dae.npz")["arch"] == arch
    tckpt.save_npz(tmp_path / "fcn.npz", fcn)
    pred = Predictor.from_npz(tmp_path / "fcn.npz", tmp_path / "best_dae.npz", device="cpu", dataset=cfg,
                              fc_channels=16, dae_arch=arch, dae_tied=tied, dae_depth=4, dae_widths=WIDTHS,
                              h_taps=taps, batch_size=2, num_steps=2, compute_dtype=torch.float32)
    labels = pred.predict(np.random.default_rng(0).random((3, 48, 64, 3), dtype=np.float32))
    assert labels.shape == (3, 48, 64) and labels.max() < C


def test_sep_tail_train_step_matches_jax():
    """One f32 DAE train step with the 'sep' tail (stem_pool 1, depth 3)
    against the JAX step, K1 in interpret mode against its plain version:
    loss 1e-5, Adam's first moment 1e-4 of each leaf's largest entry (as
    ``test_torch_train_step``)."""
    from iterative_inference_segm_tpu_torch.ops.corruption_kernel import seed_from_key_data

    jf, jd = jax_params(stem_pool=1, depth=3, tail="sep")
    step_kw = dict(h_taps=("pool4",), sigma=1.0, from_gt=True, augment=False, dae_depth=3)
    cfg_j = dataclasses.replace(TINY_J, train_crop=(32, 32))
    cfg_t = dataclasses.replace(TINY_T, height=48, width=64, train_crop=(32, 32))
    rng = np.random.default_rng(0)
    x = rng.random((2, 48, 64, 3), dtype=np.float32)
    y = rng.integers(0, C + 1, (2, 48, 64)).astype(np.int32)
    tx = jloop.make_optimizer(jloop.TrainConfig())
    j_step, _ = j_make_step(cfg_j, jloop.TrainConfig(), tx, corruption_impl="pallas", **step_kw)
    key = jax.random.PRNGKey(7)
    _, opt_state, jloss = j_step(jd, tx.init(jd), jf, jnp.asarray(x), jnp.asarray(y), key)
    mu = next(s for s in jax.tree.leaves(opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")).mu
    seed = seed_from_key_data(jax.random.key_data(jax.random.split(key)[1]))

    fcn_t, dae_t = params_from_jax(jf), params_from_jax(jd)
    assert "up_stem_dw" in dae_t and "mix" in dae_t
    opt = tloop.make_optimizer(tloop.TrainConfig(), dae_t)
    t_step, _ = make_dae_train_step(cfg_t, tloop.TrainConfig(), opt, corruption_impl="kernel", **step_kw)
    loss = float(t_step(dae_t, fcn_t, torch.from_numpy(x), torch.from_numpy(y), StepRandomness(seed)))
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    mu_t = params_to_jax({k: {kk: opt.state[t]["exp_avg"] for kk, t in lv.items()} for k, lv in dae_t.items()})
    for layer, leaves in jax.device_get(mu).items():
        for k, want in leaves.items():
            want = np.asarray(want)
            scale = float(np.abs(want).max())
            assert scale > 0, f"{layer}/{k}: zero gradient"
            np.testing.assert_allclose(mu_t[layer][k], want, rtol=1e-4, atol=1e-4 * scale, err_msg=f"{layer}/{k}")
