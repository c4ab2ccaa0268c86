"""The port's FCN-8 trainer against the JAX package's, on the same numpy
inputs and the same (bridged) params: ``fcn8_logits``; one f32 train step
with dropout on, its crop offsets, flips and keep-masks derived from the
JAX step's key exactly as the JAX step derives them; the eval step;
rematerialization; resume; ``best_fcn8.npz`` across the two packages; the
dropout itself. Small shapes: C = 5, 48x64 frames cropped to 32x48, fc 16.

Tolerances (f32 on the CPU, both sides): logits 1e-5 of their largest
value, loss and eval loss 1e-5 relative (the convolutions sum their fan-in in another order on each side,
~1e-6 relative a layer); confusion counts exactly equal; updated params
1e-5 relative to each leaf's largest entry, except where the combined
gradient (the JAX step's Adam first moment) lies within 1e-4 of the leaf's
largest of zero: there |g| nears Adam's 1e-8 and the gradients' relative
noise sets the step (such entries are held to 1e-4 of all, and every entry
to one step, lr).
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from iterative_inference_segm_tpu.data import config_datasets as jcfg  # noqa: E402
from iterative_inference_segm_tpu.models import fcn8 as jfcn8  # noqa: E402
from iterative_inference_segm_tpu.train import loop as jloop  # noqa: E402
from iterative_inference_segm_tpu.train.train_fcn8 import make_fcn8_train_step as j_make_step  # noqa: E402
from iterative_inference_segm_tpu.utils import checkpoint as jckpt  # noqa: E402
from iterative_inference_segm_tpu_torch.data import config_datasets as tcfg  # noqa: E402
from iterative_inference_segm_tpu_torch.data import synthetic as tsynth  # noqa: E402
from iterative_inference_segm_tpu_torch.models import fcn8 as tfcn8  # noqa: E402
from iterative_inference_segm_tpu_torch.train import loop as tloop  # noqa: E402
from iterative_inference_segm_tpu_torch.train.train_fcn8 import (  # noqa: E402
    StepRandomness,
    draw_step_randomness,
    make_fcn8_train_step,
    train_fcn8,
)
from iterative_inference_segm_tpu_torch.utils import checkpoint as tckpt  # noqa: E402
from iterative_inference_segm_tpu_torch.utils.jax_bridge import params_from_jax, params_to_jax  # noqa: E402

C = 5
FC = 16
CROP = (32, 48)
TINY_J = dataclasses.replace(jcfg.CAMVID, n_classes=C, void_label=C, height=48, width=64, train_crop=CROP)
TINY_T = dataclasses.replace(tcfg.CAMVID, n_classes=C, void_label=C, height=48, width=64, train_crop=CROP)


def assert_close(got, want):
    """1e-5 relative to the largest value (logits reach ~10 here)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def jparams():
    """FCN-8 at fc 16 with random score and transposed-conv layers (the
    bilinear init is symmetric and would hide a missing flip)."""
    rng = np.random.default_rng(0)
    p = jfcn8.init_fcn8(jax.random.PRNGKey(0), n_classes=C, fc_channels=FC)
    return {k: ({kk: jnp.asarray(rng.normal(size=v.shape).astype(np.float32) * 0.3) for kk, v in lv.items()}
                if k.startswith(("up", "score")) else lv) for k, lv in p.items()}


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(1)
    x = rng.random((2, 48, 64, 3), dtype=np.float32)
    y = rng.integers(0, C + 1, (2, 48, 64)).astype(np.int32)  # C = void
    return x, y


def jax_randomness(key, batch_hw):
    """The crop, flips and keep-masks the JAX train step derives from its
    key: ``aug, drop = split(key)`` (the step), ``k_off, k_flip =
    split(aug)`` (``random_crop_and_flip``), ``logits_rng, _ =
    split(drop)`` (the loss) and ``k1, k2 = split(logits_rng)``
    (``fcn8_head``), as port tensors."""
    b, h, w = batch_hw
    aug, drop = jax.random.split(key)
    k_off, k_flip = jax.random.split(aug)
    oy = jax.random.randint(k_off, (b,), 0, h - CROP[0] + 1)
    ox = jax.random.randint(jax.random.fold_in(k_off, 1), (b,), 0, w - CROP[1] + 1)
    flip = jax.random.bernoulli(k_flip, 0.5, (b,))
    logits_rng, _ = jax.random.split(drop)
    k1, k2 = jax.random.split(logits_rng)
    shape = tfcn8.fc_shape((b, *CROP), FC)
    masks = tuple(torch.from_numpy(np.array(jax.random.bernoulli(k, 0.5, shape))) for k in (k1, k2))
    return StepRandomness(dropout=masks, crop=tuple(torch.from_numpy(np.array(a)) for a in (oy, ox, flip)))


@pytest.fixture(scope="module")
def jax_step(jparams, batch):
    x, y = batch
    cfg = jloop.TrainConfig()
    tx = jloop.make_optimizer(cfg)
    train_step, eval_step = j_make_step(TINY_J, cfg, tx, fc_channels=FC)
    key = jax.random.PRNGKey(7)
    params, opt_state, loss = train_step(jparams, tx.init(jparams), jnp.asarray(x), jnp.asarray(y), key)
    cm, vloss = eval_step(jparams, jnp.asarray(x), jnp.asarray(y))
    adam = next(s for s in jax.tree.leaves(opt_state, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu"))
    return {"key": key, "loss": float(loss), "params": jax.device_get(params), "mu": jax.device_get(adam.mu),
            "cm": np.asarray(cm), "val_loss": float(vloss)}


def _port_step(jparams, remat=False):
    params = params_from_jax(jparams)
    cfg = tloop.TrainConfig(remat=remat)
    opt = tloop.make_optimizer(cfg, params)
    train_step, eval_step = make_fcn8_train_step(TINY_T, cfg, opt, fc_channels=FC)
    return params, opt, train_step, eval_step


def test_fcn8_logits_match_jax(jparams, batch):
    x = batch[0]
    for dt_j, dt_t in ((jnp.float32, torch.float32),):
        want = jfcn8.fcn8_logits(jparams, jnp.asarray(x), compute_dtype=dt_j)
        got = tfcn8.fcn8_logits(params_from_jax(jparams), torch.from_numpy(x), compute_dtype=dt_t)
        assert got.dtype == torch.float32 and tuple(got.shape) == (2, 48, 64, C)
        assert_close(got.numpy(), want)


def test_fcn8_logits_with_the_jax_masks_match_jax(jparams, batch):
    x = batch[0]
    key = jax.random.PRNGKey(3)
    want = jfcn8.fcn8_logits(jparams, jnp.asarray(x), dropout_rng=key)
    k1, k2 = jax.random.split(key)
    shape = tfcn8.fc_shape(x.shape, FC)
    masks = tuple(torch.from_numpy(np.array(jax.random.bernoulli(k, 0.5, shape))) for k in (k1, k2))
    got = tfcn8.fcn8_logits(params_from_jax(jparams), torch.from_numpy(x), dropout=masks)
    assert_close(got.numpy(), want)
    assert not np.allclose(np.asarray(want), np.asarray(jfcn8.fcn8_logits(jparams, jnp.asarray(x))))


def test_train_step_with_dropout_matches_jax(jparams, batch, jax_step):
    params, opt, train_step, _ = _port_step(jparams)
    x, y = (torch.from_numpy(a) for a in batch)
    rand = jax_randomness(jax_step["key"], y.shape)
    loss = float(train_step(params, x, y, rand))
    np.testing.assert_allclose(loss, jax_step["loss"], rtol=1e-5)
    got = params_to_jax(params)
    assert set(got) == set(jax_step["params"])
    off, total = 0, 0
    for layer, leaves in jax_step["params"].items():
        for k, want in leaves.items():
            want, mu = np.asarray(want), np.asarray(jax_step["mu"][layer][k])
            scale = float(np.abs(want).max())
            # Adam's first step is lr * g / (|g| + 1e-8): where the combined
            # gradient is within the sides' noise of 0 it sets the step
            near_zero = np.abs(mu) <= 1e-4 * float(np.abs(mu).max())
            bad = ~np.isclose(got[layer][k], want, rtol=1e-5, atol=1e-5 * scale)
            assert not (bad & ~near_zero).any(), f"{layer}/{k}: {int((bad & ~near_zero).sum())} entries off"
            assert np.abs(got[layer][k] - want).max() <= 2e-3 + 1e-5 * scale  # one Adam step is at most lr
            off += int(bad.sum())
            total += want.size
    assert off <= 1e-4 * total, f"{off} of {total} near-zero gradient entries differ"


def test_eval_step_matches_jax(jparams, batch, jax_step):
    params, _, _, eval_step = _port_step(jparams)
    x, y = (torch.from_numpy(a) for a in batch)
    cm, vloss = eval_step(params, x, y)
    np.testing.assert_array_equal(cm.numpy(), jax_step["cm"])
    assert int(cm.sum()) == int((batch[1] < C).sum())
    np.testing.assert_allclose(float(vloss), jax_step["val_loss"], rtol=1e-5)


def test_remat_gives_the_same_step(jparams, batch):
    x, y = (torch.from_numpy(a) for a in batch)
    runs = []
    for remat in (False, True):
        params, opt, train_step, _ = _port_step(jparams, remat=remat)
        # a generator, not masks: the step draws the masks before the
        # forward, so the recomputed forward sees the same ones
        rand = draw_step_randomness(torch.Generator().manual_seed(0), batch=2, hw=(48, 64), crop=CROP,
                                    device="cpu")
        loss = float(train_step(params, x, y, rand))
        runs.append((loss, [t.detach().clone() for lv in params.values() for t in lv.values()]))
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


def test_dropout_keeps_about_half_and_scales_by_one_over_keep():
    masks = tfcn8.dropout_masks(torch.Generator().manual_seed(0), (4, 8, 8, 64))
    assert all(m.dtype == torch.bool for m in masks) and not torch.equal(*masks)
    for rate in (0.5, 0.25):
        m = tfcn8.dropout_masks(torch.Generator().manual_seed(1), (100_000,), dropout_rate=rate)[0]
        assert abs(float(m.float().mean()) - (1 - rate)) < 0.01
        out = tfcn8._dropout(torch.full((100_000,), 3.0), rate, m)
        assert torch.equal(out[m], torch.full_like(out[m], 3.0 / (1 - rate))) and not out[~m].any()
    assert tfcn8.fc_shape((2, 360, 480, 3), 4096) == (2, 12, 15, 4096)
    assert tfcn8.fc_shape((2, 224, 224, 3), 4096) == (2, 7, 7, 4096)


def _data(n, seed):
    return list(tsynth.synthetic_batches(cfg=TINY_T, batch_size=2, num_batches=n, height=48, width=64, seed=seed))


def _train(**kw):
    args = dict(dataset=TINY_T, train_data=_data(3, 0), val_data=_data(1, 99), fc_channels=FC, device="cpu")
    args.update(kw)
    return train_fcn8(**args)


def test_resume_continues_from_the_saved_epoch(tmp_path):
    """Two epochs, then a resumed run to three, equals three epochs in one
    run: the params, the optimizer state and the generator come back from
    ckpt/<epoch>, the best params from best_fcn8.npz."""
    cfg = tloop.TrainConfig(learning_rate=1e-4, max_epochs=3, patience=10)
    whole = _train(tcfg=cfg, workdir=str(tmp_path / "whole"))
    wd = tmp_path / "resumed"
    first = _train(tcfg=dataclasses.replace(cfg, max_epochs=2), workdir=str(wd))
    assert tckpt.latest_step(wd / "ckpt") == 1 and (wd / "best_fcn8.npz").is_file()
    resumed = _train(tcfg=cfg, workdir=str(wd))
    assert [h["epoch"] for h in resumed["history"]] == [0, 1, 2]
    assert [h["train_loss"] for h in resumed["history"][:2]] == [h["train_loss"] for h in first["history"]]
    a, b = whole["history"][2], resumed["history"][2]
    assert set(a) == {"epoch", "train_loss", "val_loss", "val_miou", "val_acc", "epoch_seconds",
                      "train_images_per_sec"}
    assert a["train_loss"] == pytest.approx(b["train_loss"], rel=1e-6)
    assert a["val_miou"] == pytest.approx(b["val_miou"], rel=1e-6)
    assert resumed["best_epoch"] == whole["best_epoch"]
    for layer, leaves in whole["params"].items():
        for k, t in leaves.items():
            torch.testing.assert_close(resumed["params"][layer][k], t, rtol=1e-6, atol=1e-7)
    lines = (wd / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(line)["step"] for line in lines] == [0, 1, 2]


def test_best_fcn8_npz_crosses_between_the_packages(tmp_path, jparams):
    r = _train(tcfg=tloop.TrainConfig(max_epochs=1), workdir=str(tmp_path / "wd"))
    npz = tmp_path / "wd" / "best_fcn8.npz"
    assert jckpt.read_npz_meta(npz) == {"arch": "fcn8", "fc_channels": FC}
    loaded = jckpt.load_npz(npz, jfcn8.init_fcn8(jax.random.PRNGKey(1), n_classes=C, fc_channels=FC))
    back = params_to_jax(r["params"])
    for layer, leaves in back.items():
        for k, v in leaves.items():
            np.testing.assert_array_equal(np.asarray(loaded[layer][k]), v)
    jckpt.save_npz(tmp_path / "jax.npz", jparams, meta={"arch": "fcn8", "fc_channels": FC})
    template = tfcn8.init_fcn8(torch.Generator().manual_seed(1), n_classes=C, fc_channels=FC)
    port = tckpt.load_npz(tmp_path / "jax.npz", template)
    x = np.random.default_rng(2).random((1, 48, 64, 3), dtype=np.float32)
    assert_close(tfcn8.fcn8_logits(port, torch.from_numpy(x)).numpy(), jfcn8.fcn8_logits(jparams, jnp.asarray(x)))


def test_training_reduces_the_loss_and_mesh_raises():
    r = _train(tcfg=tloop.TrainConfig(learning_rate=1e-4, max_epochs=3, patience=10))
    losses = [h["train_loss"] for h in r["history"]]
    assert r["epochs"] == 3 and losses[-1] < losses[0]
    assert r["best_miou"] == max(h["val_miou"] for h in r["history"])
    assert all(t.dtype == torch.float32 for lv in r["params"].values() for t in lv.values())
    # a mesh is a DeviceMesh of a launched group (DP training runs in
    # test_torch_parallel.py)
    with pytest.raises(TypeError, match="DeviceMesh"):
        _train(mesh=object())
