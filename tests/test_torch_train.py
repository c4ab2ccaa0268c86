"""The port's DAE trainer end to end on the CPU at a tiny size: the three
corruption regimes, resume, early stopping, the CLI and its ``best_dae.npz``
(which the JAX package and the port's ``Predictor`` both load); and the
jax-free copies the trainer needs (synthetic data, registry metadata,
experiment naming, training checkpoints) against the JAX package's.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from iterative_inference_segm_tpu.data import synthetic as jsynth  # noqa: E402
from iterative_inference_segm_tpu.data.config_datasets import EM as J_EM  # noqa: E402
from iterative_inference_segm_tpu.models import registry as jreg  # noqa: E402
from iterative_inference_segm_tpu.utils import experiment as jexp  # noqa: E402
from iterative_inference_segm_tpu_torch.data import config_datasets as tcfg  # noqa: E402
from iterative_inference_segm_tpu_torch.data import synthetic as tsynth  # noqa: E402
from iterative_inference_segm_tpu_torch.inference.predictor import Predictor  # noqa: E402
from iterative_inference_segm_tpu_torch.models import registry as treg  # noqa: E402
from iterative_inference_segm_tpu_torch.models.fcn8 import init_fcn8  # noqa: E402
from iterative_inference_segm_tpu_torch.ops import corruption_kernel as ck  # noqa: E402
from iterative_inference_segm_tpu_torch.scripts import train_dae as cli  # noqa: E402
from iterative_inference_segm_tpu_torch.train.loop import EarlyStopper, TrainConfig  # noqa: E402
from iterative_inference_segm_tpu_torch.train.train_dae import train_dae  # noqa: E402
from iterative_inference_segm_tpu_torch.utils import checkpoint as tckpt  # noqa: E402
from iterative_inference_segm_tpu_torch.utils import experiment as texp  # noqa: E402

C = 4
TINY = dataclasses.replace(tcfg.CAMVID, name="tiny", n_classes=C, void_label=C, height=48,
                           width=64, train_crop=(32, 32))
DAE_KW = dict(h_taps=("pool4",), dae_depth=3, dae_stem_pool=1, dae_widths=(8, 16, 32))


def _data(n_batches, seed):
    return list(tsynth.synthetic_batches(cfg=TINY, batch_size=2, num_batches=n_batches,
                                         height=48, width=64, seed=seed))


@pytest.fixture(scope="module")
def train_val():
    return _data(4, seed=0), _data(2, seed=99)


def _fcn(seed=0):
    return init_fcn8(torch.Generator().manual_seed(seed), n_classes=C, fc_channels=16)


def _train(train_val, **kw):
    train, val = train_val
    args = dict(fcn_params=_fcn(), dataset=TINY, train_data=train, val_data=val, **DAE_KW)
    args.update(kw)
    return train_dae(**args)


def test_synthetic_batches_match_jax():
    jcfg = dataclasses.replace(J_EM, height=24, width=20)
    tcfg_em = dataclasses.replace(tcfg.EM, height=24, width=20)
    want = list(jsynth.synthetic_batches(cfg=jcfg, batch_size=2, num_batches=2, seed=3))
    got = list(tsynth.synthetic_batches(cfg=tcfg_em, batch_size=2, num_batches=2, seed=3))
    for (wx, wy), (gx, gy) in zip(want, got):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    assert gx.dtype == np.float32 and gy.dtype == np.int32 and gx.shape == (2, 24, 20, 1)


def test_dae_training_reduces_loss_in_the_gt_regime(train_val):
    before = (ck.corrupt_onehot.launches, ck.corrupt_probs.launches)
    r = _train(train_val, tcfg=TrainConfig(learning_rate=3e-4, weight_decay=0.0, max_epochs=3,
                                           patience=10), sigma=0.5, from_gt=True,
               corruption_impl="kernel")
    hist = r["history"]
    assert r["epochs"] == len(hist) == 3
    assert hist[-1]["train_loss"] < hist[0]["train_loss"]
    assert set(hist[0]) == {"epoch", "train_loss", "val_loss", "val_miou", "epoch_seconds",
                            "train_images_per_sec"}
    assert r["best_miou"] == max(h["val_miou"] for h in hist)
    assert hist[r["best_epoch"]]["val_miou"] == r["best_miou"]
    # CPU tensors take the kernels' plain versions: no launch is counted
    assert (ck.corrupt_onehot.launches, ck.corrupt_probs.launches) == before


@pytest.mark.parametrize("from_gt,sigma", [(False, 0.0), (False, 0.5), (0.5, 0.5)])
def test_dae_training_natural_and_mixed_regimes(train_val, from_gt, sigma):
    train, val = train_val
    r = _train((train[:2], val[:1]), tcfg=TrainConfig(learning_rate=1e-3, max_epochs=2,
                                                      patience=10),
               sigma=sigma, from_gt=from_gt)
    assert len(r["history"]) == 2
    assert np.isfinite([h["train_loss"] for h in r["history"]]).all()
    assert np.isfinite([h["val_loss"] for h in r["history"]]).all()


def test_bf16_compute_trains(train_val):
    train, val = train_val
    r = _train((train[:1], val[:1]), tcfg=TrainConfig(max_epochs=1, compute_dtype=torch.bfloat16),
               sigma=0.5)
    assert np.isfinite(r["history"][0]["train_loss"])
    assert all(t.dtype == torch.float32 for lv in r["params"].values() for t in lv.values())


def test_resume_continues_from_the_saved_epoch(train_val, tmp_path):
    """Two epochs, then a resumed run to four, equals four epochs in one
    run: the params, the optimizer state and the generator come back from
    ckpt/<epoch>, the best params from best_dae.npz."""
    cfg = TrainConfig(learning_rate=1e-3, max_epochs=4, patience=10)
    whole = _train(train_val, tcfg=cfg, workdir=str(tmp_path / "whole"))
    wd = str(tmp_path / "resumed")
    first = _train(train_val, tcfg=dataclasses.replace(cfg, max_epochs=2), workdir=wd)
    assert tckpt.latest_step(tmp_path / "resumed" / "ckpt") == 1
    resumed = _train(train_val, tcfg=cfg, workdir=wd)
    assert [h["epoch"] for h in resumed["history"]] == [0, 1, 2, 3]
    assert resumed["history"][:2] == [
        {**h, "step": h["epoch"], "time": resumed["history"][i]["time"]}
        for i, h in enumerate(first["history"])
    ]
    for a, b in zip(whole["history"][2:], resumed["history"][2:]):
        assert a["train_loss"] == pytest.approx(b["train_loss"], rel=1e-6)
        assert a["val_miou"] == pytest.approx(b["val_miou"], rel=1e-6)
    assert resumed["best_epoch"] == whole["best_epoch"]
    for layer, leaves in whole["params"].items():
        for k, t in leaves.items():
            torch.testing.assert_close(resumed["params"][layer][k], t, rtol=1e-6, atol=1e-7)
    lines = (tmp_path / "resumed" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(line)["step"] for line in lines] == [0, 1, 2, 3]


def test_resume_restores_best_params_from_npz(train_val, tmp_path):
    cfg = TrainConfig(max_epochs=1, patience=10)
    wd = tmp_path / "wd"
    _train(train_val, tcfg=cfg, workdir=str(wd))
    # make the checkpointed params differ from the best npz
    state = tckpt.restore_checkpoint(wd / "ckpt", 0)
    for lv in state["params"].values():
        for t in lv.values():
            t.add_(1.0)
    tckpt.save_checkpoint(wd / "ckpt", 0, state)
    r = _train(train_val, tcfg=cfg, workdir=str(wd))  # max_epochs reached: no epoch runs
    assert r["epochs"] == 1 and r["best_epoch"] == 0
    best = tckpt.load_npz(wd / "best_dae.npz", r["params"])
    for layer, leaves in best.items():
        for k, t in leaves.items():
            assert torch.equal(r["params"][layer][k], t)
            assert not torch.equal(state["params"][layer][k], t)


def test_early_stopper():
    s = EarlyStopper(patience=2)
    assert s.update(0, 0.5) and not s.should_stop
    assert not s.update(1, 0.4)
    assert not s.update(2, 0.3)
    assert not s.should_stop
    assert not s.update(3, 0.2)
    assert s.should_stop
    assert s.best == 0.5 and s.best_epoch == 0
    assert s.update(4, 0.6) and not s.should_stop


def test_early_stopping_ends_training(train_val):
    r = _train(train_val, tcfg=TrainConfig(learning_rate=0.0, weight_decay=0.0, max_epochs=10,
                                           patience=0))
    # lr 0: val mIoU never improves after epoch 0, so epoch 1 is the last
    assert r["epochs"] == 2 and r["best_epoch"] == 0


def test_training_checkpoints_round_trip(tmp_path):
    assert tckpt.latest_step(tmp_path / "none") is None
    state = {"params": {"a": {"w": torch.arange(3.0)}}, "opt_state": {"step": 3}, "rng": torch.Generator().get_state()}
    tckpt.save_checkpoint(tmp_path, 2, state)
    tckpt.save_checkpoint(tmp_path, 10, state)
    (tmp_path / "11").mkdir()  # an unfinished save: no state file
    assert tckpt.latest_step(tmp_path) == 10
    back = tckpt.restore_checkpoint(tmp_path, 10)
    assert torch.equal(back["params"]["a"]["w"], state["params"]["a"]["w"])
    assert back["opt_state"] == {"step": 3}
    tckpt.wait_for_checkpoints()


def test_experiment_name_and_metric_logger_match_jax(tmp_path):
    hp = dict(lr=1e-3, sigma=1.0, from_fcn=False, h=("pool3", "pool4"), seed=0)
    assert texp.build_experiment_name("dae_camvid", **hp) == jexp.build_experiment_name("dae_camvid", **hp)
    log = texp.MetricLogger(tmp_path / "run")
    log.log(0, loss=np.float32(1.5), tag="x")
    log.log(1, loss=torch.tensor(0.5))
    recs = log.read()
    assert [r["step"] for r in recs] == [0, 1] and recs[0]["loss"] == 1.5 and recs[0]["tag"] == "x"
    assert recs == jexp.MetricLogger(tmp_path / "run").read()


def test_save_checkpoint_takes_jaxs_wait(tmp_path):
    """``wait`` (JAX's orbax background save) is accepted either way; the
    file is whole when the call returns."""
    state = {"params": {"a": {"w": torch.arange(4.0)}}, "step": 1}
    for step, wait in ((1, False), (2, True)):
        tckpt.save_checkpoint(tmp_path, step, state, wait=wait)
        assert tckpt.latest_step(tmp_path) == step
        assert torch.equal(tckpt.restore_checkpoint(tmp_path, step)["params"]["a"]["w"], state["params"]["a"]["w"])


def test_restore_checkpoint_takes_jaxs_template(tmp_path):
    """``restore_checkpoint(dir, step, template)`` as JAX calls it: the
    template's structure, each tensor's dtype and device (here the meta
    device), a non-tensor leaf as written; a key or a shape that differs
    raises. Without a template, the state as written."""
    state = {"params": {"a": {"w": torch.arange(6.0).reshape(2, 3), "b": torch.ones(3)}},
             "opt": [torch.zeros(2), 7], "epoch": 4}
    tckpt.save_checkpoint(tmp_path, 0, state)
    template = {"params": {"a": {"w": torch.zeros((2, 3), dtype=torch.bfloat16),
                                 "b": torch.zeros(3, device="meta")}},
                "opt": [torch.zeros(2, dtype=torch.float64), 0], "epoch": 0}
    back = tckpt.restore_checkpoint(tmp_path, 0, template)
    assert back["params"]["a"]["w"].dtype == torch.bfloat16 and back["params"]["a"]["b"].is_meta
    assert torch.equal(back["params"]["a"]["w"], state["params"]["a"]["w"].bfloat16())
    assert isinstance(back["opt"], list) and back["opt"][0].dtype == torch.float64 and back["opt"][1] == 7
    assert back["epoch"] == 4
    plain = tckpt.restore_checkpoint(tmp_path, 0)
    assert plain["params"]["a"]["w"].dtype == torch.float32 and plain["epoch"] == 4
    bad_key = {**template, "params": {"a": {"w": template["params"]["a"]["w"]}}}
    with pytest.raises(ValueError, match="keys"):
        tckpt.restore_checkpoint(tmp_path, 0, bad_key)
    bad_shape = {**template, "opt": [torch.zeros(3), 0]}
    with pytest.raises(ValueError, match=r"\(2,\) does not match the template's \(3,\)"):
        tckpt.restore_checkpoint(tmp_path, 0, bad_shape)



@pytest.mark.parametrize("widths", [None, (8, 16, 32)])
def test_registry_checkpoint_meta_matches_jax(widths):
    kw = dict(h_taps=("pool4",), depth=3, stem_pool=1, tail="full", widths=widths, encoder="stride")
    assert treg.checkpoint_meta("dae", **kw) == jreg.checkpoint_meta("dae", **kw)
    load_kw = {k: v for k, v in kw.items() if k != "h_taps"}
    assert treg.expected_meta("dae", **load_kw) == jreg.expected_meta("dae", **load_kw)
    assert treg.score_kwargs("dae", depth=3) == jreg.score_kwargs("dae", depth=3)
    p = treg.init_score_template("dae", torch.Generator().manual_seed(0), n_classes=C,
                                 depth=3, stem_pool=1, widths=widths)
    assert int(p["enc1"]["w"].shape[0]) == (widths or (32,))[0]


@pytest.mark.parametrize("arch,err", [("mirror", None), ("contextmod", None), ("unet", ValueError)])
def test_registry_rejects_unported_archs(arch, err):
    """Only an unknown arch is refused now; mirror and contextmod, refused
    until they were ported, dispatch as in the JAX registry."""
    if err is None:
        assert callable(treg.score_apply_fn(arch)) and callable(treg.score_logits_fn(arch))
        kw = dict(h_taps=(), depth=3, tied=arch == "mirror")
        assert treg.checkpoint_meta(arch, **kw) == jreg.checkpoint_meta(arch, **kw)
        return
    with pytest.raises(err):
        treg.score_apply_fn(arch)
    with pytest.raises(err):
        treg.checkpoint_meta(arch, h_taps=(), depth=3)


def test_cli_trains_and_its_best_npz_loads_in_both_packages(tmp_path):
    """--tiny --synthetic on the CPU with a frozen FCN from --fcn-npz; the
    best_dae.npz it writes loads in the JAX package's load_npz and serves
    through the port's Predictor.from_npz."""
    import jax

    from iterative_inference_segm_tpu.models.dae import init_dae as j_init_dae
    from iterative_inference_segm_tpu.utils.checkpoint import load_npz as j_load_npz
    from iterative_inference_segm_tpu.utils.checkpoint import read_npz_meta

    fcn_npz = tmp_path / "fcn.npz"
    fcn = init_fcn8(torch.Generator().manual_seed(5), n_classes=11, fc_channels=64)
    tckpt.save_npz(fcn_npz, fcn)
    wd = tmp_path / "wd"
    rc = cli.main([
        "--tiny", "--synthetic", "--max-epochs", "1", "--device", "cpu",
        "--batch-size", "2", "--num-train-batches", "2", "--num-val-batches", "1",
        "--dae-depth", "3", "--dae-stem-pool", "1", "--fcn-npz", str(fcn_npz),
        "--workdir", str(wd),
    ])
    assert rc == 0
    assert (wd / "metrics.jsonl").is_file() and tckpt.latest_step(wd / "ckpt") == 0
    npz = wd / "best_dae.npz"
    meta = read_npz_meta(npz)
    assert meta["arch"] == "dae" and meta["depth"] == 3 and meta["stem_pool"] == 1
    template = j_init_dae(jax.random.PRNGKey(0), n_classes=11, h_specs={"pool4": 512}, depth=3,
                          stem_pool=1, widths=(32, 64, 128))
    loaded = j_load_npz(npz, template)
    assert set(loaded) == set(template)
    pred = Predictor.from_npz(fcn_npz, npz, device="cpu", fc_channels=64, dae_depth=3,
                              dae_stem_pool=1, engine="half", batch_size=2,
                              compute_dtype=torch.float32, num_steps=2)
    images = np.random.default_rng(0).random((3, 96, 128, 3), dtype=np.float32)
    labels = pred.predict(images)
    assert labels.shape == (3, 96, 128) and labels.dtype == np.int32
    assert labels.min() >= 0 and labels.max() < 11


# refused until the score networks, the 'sep' tail step, the data path
# and parallel/ were ported; none is refused now (--devices runs in
# test_torch_cli_parallel.py)
PORTED_FLAGS = (["--arch", "mirror"], ["--arch", "contextmod"], ["--dae-tail", "sep"], ["--dae-tied"],
                ["--packed", "x"], ["--data-root", "x"], ["--devices", "2"])


@pytest.mark.parametrize("flags", [
    ["--packed", "x"], ["--wire", "u8"], ["--data-root", "x"], ["--devices", "2"],
    ["--arch", "mirror"], ["--arch", "contextmod"], ["--dae-tail", "sep"], ["--dae-tied"],
])
def test_cli_rejects_unported_flags_naming_the_roadmap(flags, capsys):
    if flags in PORTED_FLAGS:
        args = cli.parse_args(flags)
        assert vars(args)[flags[0][2:].replace("-", "_")] == (flags[1] if len(flags) > 1 else True)
        return
    with pytest.raises(SystemExit) as e:
        cli.parse_args(flags)
    assert e.value.code == 2
    err = capsys.readouterr().err
    if flags == ["--wire", "u8"]:  # the JAX CLI's own refusal; with --packed it is taken
        assert "--wire u8 requires --packed" in err
        assert cli.parse_args([*flags, "--packed", "x"]).wire == "u8"
        return
    assert "ROADMAP.md, Queue 1 item 12" in err


def test_cli_device_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        cli.main(["--tiny", "--synthetic", "--max-epochs", "1"])
