"""The port's DAE train and eval steps against the JAX package's, on the
same numpy inputs, the same (bridged) params and the same noise: the JAX
step runs K1 as its Pallas kernel in interpret mode, the port the kernel's
plain version with the seed derived from the same key. Also the pieces the
step is made of: the crop, the optimizer, rematerialization.

Tolerances (f32 on the CPU, both sides): loss within 1e-5 relative; Adam's
first moment (0.1 x the L2-coupled gradient after one step) within 1e-4 of
each leaf's largest entry (convolution gradients sum their fan-in in another
order on each side); confusion counts exactly equal.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from iterative_inference_segm_tpu.data import config_datasets as jcfg  # noqa: E402
from iterative_inference_segm_tpu.data.pipeline import random_crop_and_flip as j_crop  # noqa: E402
from iterative_inference_segm_tpu.models import dae as jdae  # noqa: E402
from iterative_inference_segm_tpu.models import fcn8 as jfcn8  # noqa: E402
from iterative_inference_segm_tpu.train import loop as jloop  # noqa: E402
from iterative_inference_segm_tpu.train.train_dae import make_dae_train_step as j_make_step  # noqa: E402
from iterative_inference_segm_tpu_torch.data import config_datasets as tcfg  # noqa: E402
from iterative_inference_segm_tpu_torch.data import pipeline as tpipe  # noqa: E402
from iterative_inference_segm_tpu_torch.models.dae import dae_apply  # noqa: E402
from iterative_inference_segm_tpu_torch.ops.corruption_kernel import seed_from_key_data  # noqa: E402
from iterative_inference_segm_tpu_torch.train import loop as tloop  # noqa: E402
from iterative_inference_segm_tpu_torch.train.train_dae import (  # noqa: E402
    StepRandomness,
    draw_step_randomness,
    make_dae_train_step,
)
from iterative_inference_segm_tpu_torch.utils.jax_bridge import params_from_jax, params_to_jax  # noqa: E402

C = 5
TINY_J = dataclasses.replace(jcfg.CAMVID, n_classes=C, void_label=C, height=48, width=64,
                             train_crop=(32, 32))
TINY_T = dataclasses.replace(tcfg.CAMVID, n_classes=C, void_label=C, height=48, width=64,
                             train_crop=(32, 32))
STEP_KW = dict(h_taps=("pool4",), sigma=1.0, from_gt=True, augment=False, dae_depth=3)


@pytest.fixture(scope="module")
def jparams():
    fcn = jfcn8.init_fcn8(jax.random.PRNGKey(0), n_classes=C, fc_channels=16)
    dae = jdae.init_dae(jax.random.PRNGKey(1), n_classes=C, h_specs={"pool4": 512}, depth=3,
                        stem_pool=1, widths=(8, 16, 32))
    return fcn, dae


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(0)
    x = rng.random((2, 48, 64, 3), dtype=np.float32)
    y = rng.integers(0, C + 1, (2, 48, 64)).astype(np.int32)  # C = void
    return x, y


@pytest.fixture(scope="module")
def jax_step(jparams, batch):
    """One JAX train step and one eval step (corruption_impl='pallas')."""
    fcn, dae = jparams
    x, y = batch
    tcfg_j = jloop.TrainConfig()
    tx = jloop.make_optimizer(tcfg_j)
    train_step, eval_step = j_make_step(TINY_J, tcfg_j, tx, corruption_impl="pallas", **STEP_KW)
    key = jax.random.PRNGKey(7)
    _, opt_state, loss = train_step(dae, tx.init(dae), fcn, jnp.asarray(x), jnp.asarray(y), key)
    cm, vloss = eval_step(dae, fcn, jnp.asarray(x), jnp.asarray(y), key)
    adam = next(s for s in jax.tree.leaves(opt_state, is_leaf=lambda s: hasattr(s, "mu"))
                if hasattr(s, "mu"))
    return {
        "loss": float(loss), "mu": jax.device_get(adam.mu),
        "cm": np.asarray(cm), "val_loss": float(vloss),
        # the train step splits its key into (aug, noise); eval uses it whole
        "train_seed": seed_from_key_data(jax.random.key_data(jax.random.split(key)[1])),
        "eval_seed": seed_from_key_data(jax.random.key_data(key)),
    }


def _port_step(jparams, remat=False, impl="kernel"):
    fcn, dae = jparams
    fcn_t, dae_t = params_from_jax(fcn), params_from_jax(dae)
    cfg = tloop.TrainConfig(remat=remat)
    opt = tloop.make_optimizer(cfg, dae_t)
    train_step, eval_step = make_dae_train_step(TINY_T, cfg, opt, corruption_impl=impl, **STEP_KW)
    return fcn_t, dae_t, opt, train_step, eval_step


def test_train_step_matches_jax(jparams, batch, jax_step):
    fcn_t, dae_t, opt, train_step, _ = _port_step(jparams)
    x, y = (torch.from_numpy(a) for a in batch)
    loss = float(train_step(dae_t, fcn_t, x, y, StepRandomness(jax_step["train_seed"])))
    np.testing.assert_allclose(loss, jax_step["loss"], rtol=1e-5)
    mu_t = params_to_jax({l: {k: opt.state[t]["exp_avg"] for k, t in lv.items()}
                          for l, lv in dae_t.items()})
    assert set(mu_t) == set(jax_step["mu"])
    for layer, leaves in jax_step["mu"].items():
        for k, want in leaves.items():
            want = np.asarray(want)
            scale = float(np.abs(want).max())
            assert scale > 0, f"{layer}/{k}: zero gradient"
            np.testing.assert_allclose(mu_t[layer][k], want, rtol=1e-4, atol=1e-4 * scale,
                                       err_msg=f"{layer}/{k}")


def test_eval_step_matches_jax(jparams, batch, jax_step):
    fcn_t, dae_t, _, _, eval_step = _port_step(jparams)
    x, y = (torch.from_numpy(a) for a in batch)
    cm, vloss = eval_step(dae_t, fcn_t, x, y, StepRandomness(jax_step["eval_seed"]))
    np.testing.assert_array_equal(cm.numpy(), jax_step["cm"])
    assert int(cm.sum()) == int((batch[1] < C).sum())
    np.testing.assert_allclose(float(vloss), jax_step["val_loss"], rtol=1e-5)


def test_remat_gives_the_same_step(jparams, batch, jax_step):
    x, y = (torch.from_numpy(a) for a in batch)
    rand = StepRandomness(jax_step["train_seed"])
    runs = []
    for remat in (False, True):
        fcn_t, dae_t, opt, train_step, _ = _port_step(jparams, remat=remat)
        loss = train_step(dae_t, fcn_t, x, y, rand)
        runs.append((float(loss), [opt.state[t]["exp_avg"] for lv in dae_t.values() for t in lv.values()]))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


def test_torch_oracle_step_runs_and_differs_from_kernel_noise(jparams, batch, jax_step):
    x, y = (torch.from_numpy(a) for a in batch)
    rand = StepRandomness(jax_step["train_seed"])
    fcn_t, dae_t, _, train_step, _ = _port_step(jparams, impl="torch")
    loss = float(train_step(dae_t, fcn_t, x, y, rand))
    assert np.isfinite(loss) and abs(loss - jax_step["loss"]) / jax_step["loss"] < 0.2


def test_crop_and_flip_matches_jax_on_the_same_offsets():
    rng = np.random.default_rng(3)
    images = rng.random((4, 20, 28, 3), dtype=np.float32)
    labels = rng.integers(0, C + 1, (4, 20, 28)).astype(np.int32)
    crop = (12, 16)
    key = jax.random.PRNGKey(11)
    want_x, want_y = j_crop(key, jnp.asarray(images), jnp.asarray(labels), crop=crop)
    # the offsets and flips as random_crop_and_flip draws them from its key
    k_off, k_flip = jax.random.split(key)
    oy = jax.random.randint(k_off, (4,), 0, 20 - 12 + 1)
    ox = jax.random.randint(jax.random.fold_in(k_off, 1), (4,), 0, 28 - 16 + 1)
    flip = jax.random.bernoulli(k_flip, 0.5, (4,))
    offsets = [torch.from_numpy(np.array(a)) for a in (oy, ox, flip)]
    got_x, got_y = tpipe.crop_and_flip(torch.from_numpy(images), torch.from_numpy(labels),
                                       *offsets, crop=crop)
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))
    assert np.asarray(flip).any() and not np.asarray(flip).all()


def test_random_crop_and_flip_draws_in_range_and_is_seeded():
    images = torch.arange(2 * 10 * 12 * 1, dtype=torch.float32).reshape(2, 10, 12, 1)
    labels = images[..., 0].to(torch.int32)
    draw = lambda: tpipe.random_crop_and_flip(torch.Generator().manual_seed(0), images, labels,  # noqa: E731
                                              crop=(4, 5))
    (x1, y1), (x2, y2) = draw(), draw()
    assert torch.equal(x1, x2) and torch.equal(y1, y2)
    assert tuple(x1.shape) == (2, 4, 5, 1) and torch.equal(x1[..., 0].to(torch.int32), y1)
    oy, ox, flip = tpipe.draw_crop_and_flip(torch.Generator().manual_seed(1), 1000, (10, 12), (4, 5))
    assert int(oy.min()) == 0 and int(oy.max()) == 6 and int(ox.max()) == 7
    assert 0.4 < float(flip.float().mean()) < 0.6
    with pytest.raises(ValueError):
        tpipe.draw_crop_and_flip(torch.Generator(), 1, (10, 12), (11, 5))


def test_step_randomness_is_drawn_from_the_generator():
    draw = lambda s: draw_step_randomness(torch.Generator().manual_seed(s), batch=3, hw=(20, 30),  # noqa: E731
                                          crop=(8, 8), p_gt=0.5)
    a, b, c = draw(0), draw(0), draw(1)
    assert a.noise_seed == b.noise_seed and 0 <= a.noise_seed < 2**32
    assert all(torch.equal(u, v) for u, v in zip(a.crop, b.crop))
    assert a.noise_seed != c.noise_seed
    coins = [draw_step_randomness(torch.Generator().manual_seed(s), batch=1, hw=(1, 1), crop=None,
                                  p_gt=0.5).take_gt for s in range(200)]
    assert 60 < sum(coins) < 140


def test_make_optimizer_matches_optax_over_three_steps():
    """Coupled L2 on the 'w' leaves only, then Adam: torch.optim.Adam with
    weight_decay on a w-only group, against optax.chain(add_decayed_weights,
    adam) on fixed gradients."""
    rng = np.random.default_rng(5)
    tree = {"conv": {"w": rng.normal(size=(3, 3, 2, 4)), "b": rng.normal(size=(4,))},
            "up1": {"w": rng.normal(size=(4, 4, 2, 2))}}
    tree = {k: {kk: v.astype(np.float32) for kk, v in lv.items()} for k, lv in tree.items()}
    grads = [{k: {kk: rng.normal(size=v.shape).astype(np.float32) * 0.1 for kk, v in lv.items()}
              for k, lv in tree.items()} for _ in range(3)]
    cfg_j = jloop.TrainConfig(learning_rate=1e-2, weight_decay=0.5)
    tx = jloop.make_optimizer(cfg_j)
    pj = jax.tree.map(jnp.asarray, tree)
    state = tx.init(pj)
    pt = {k: {kk: torch.from_numpy(v.copy()) for kk, v in lv.items()} for k, lv in tree.items()}
    opt = tloop.make_optimizer(tloop.TrainConfig(learning_rate=1e-2, weight_decay=0.5), pt)
    assert [g["weight_decay"] for g in opt.param_groups] == [0.5, 0.0]
    for g in grads:
        upd, state = tx.update(jax.tree.map(jnp.asarray, g), state, pj)
        pj = jax.tree.map(lambda p, u: p + u, pj, upd)
        for k, lv in pt.items():
            for kk, t in lv.items():
                t.grad = torch.from_numpy(g[k][kk])
        opt.step()
        for k, lv in pt.items():
            for kk, t in lv.items():
                # within 1e-4 of one step's size (lr): the two round the
                # coupled gradient g + wd * w and Adam's bias corrections
                # differently, which moves entries near 0 by a few ulps of lr
                np.testing.assert_allclose(t.detach().numpy(), np.asarray(pj[k][kk]), rtol=1e-6,
                                           atol=1e-6, err_msg=f"{k}/{kk}")
    # the decay reached the weights, not the bias: a zero-gradient step moves
    # only 'w'
    for lv in pt.values():
        for t in lv.values():
            t.grad = torch.zeros_like(t)
    before = {k: {kk: t.detach().clone() for kk, t in lv.items()} for k, lv in pt.items()}
    opt.step()
    assert not torch.equal(pt["conv"]["w"], before["conv"]["w"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dae_apply_backprops_to_f32_params(dtype):
    from iterative_inference_segm_tpu_torch.models.dae import init_dae

    params = init_dae(torch.Generator().manual_seed(0), n_classes=C, h_specs={"pool4": 8},
                      depth=3, stem_pool=1, widths=(8, 16, 32))
    for lv in params.values():
        for t in lv.values():
            t.requires_grad_(True)
    y = torch.softmax(torch.randn((2, 48, 64, C), generator=torch.Generator().manual_seed(1)), -1)
    h = {"pool4": torch.randn((2, 3, 4, 8), generator=torch.Generator().manual_seed(2)).to(dtype)}
    out = dae_apply(params, y, h, depth=3, compute_dtype=dtype)
    assert out.dtype == torch.float32
    (out[..., 0] ** 2).mean().backward()
    for name, lv in params.items():
        for k, t in lv.items():
            assert t.grad is not None and t.grad.dtype == torch.float32, f"{name}/{k}"
            assert torch.isfinite(t.grad).all()
    assert float(params["enc1"]["w"].grad.abs().max()) > 0


@pytest.mark.parametrize("bad", ["from_gt", "impl", "mesh"])
def test_make_dae_train_step_rejects(bad):
    cfg = tloop.TrainConfig()
    opt = tloop.make_optimizer(cfg, {"a": {"w": torch.zeros(1)}})
    kw = dict(h_taps=(), sigma=0.5, from_gt=True)
    if bad == "from_gt":
        kw["from_gt"] = 1.5
        err = ValueError
    elif bad == "impl":
        kw["corruption_impl"] = "pallas"
        err = ValueError
    else:
        kw["mesh"] = object()
        err = NotImplementedError
    with pytest.raises(err):
        make_dae_train_step(TINY_T, cfg, opt, **kw)


def test_auto_picks_the_oracle_on_the_cpu_and_says_so(capsys):
    cfg = tloop.TrainConfig()
    opt = tloop.make_optimizer(cfg, {"a": {"w": torch.zeros(1)}})
    make_dae_train_step(TINY_T, cfg, opt, h_taps=(), sigma=0.5, from_gt=True)
    out = capsys.readouterr().out
    assert "[train_dae] corruption_impl=torch (auto-selected for this platform)" in out


def test_eval_preprocess_matches_jax():
    from iterative_inference_segm_tpu.data.pipeline import eval_preprocess as j_eval

    x = np.random.default_rng(4).random((2, 6, 7, 3), dtype=np.float32)
    got = tpipe.eval_preprocess(torch.from_numpy(x), tcfg.CAMVID)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_eval(jnp.asarray(x), jcfg.CAMVID)),
                               rtol=1e-6, atol=1e-6)
