"""The port's parallel layer (mesh, launch, sharding, dp) and the trainers',
the ``Predictor``'s and ``device_prefetch``'s ``mesh``/``sharding``, held to
the JAX package on matched device counts: the port's gloo ranks on the CPU
against the JAX package's faked CPU devices, restricted to the same count.

Most cases run in one launch of 2 ranks (``torch_parallel_ranks.run_cases``)
while this process computes the JAX side. Tolerances (f32 on both sides):
losses within 1e-5 relative; the DAE's Adam first moment within 1e-4 of
each leaf's largest entry (gradients sum their fan-in in another order on
each side); confusion counts exactly equal; the DP Predictor's
probabilities within 1e-5. FCN-8's gradients reach conv1_1 through 13 ReLU
layers, whose derivatives are steps: where a pre-activation lies within
the two sides' rounding of 0, one unit's gradient flips and moves a conv
leaf's gradient by up to ~1e-2 of its largest entry (it does so on a
single device too, on some batches). So FCN-8 is held as the single-device
step is (``tests/test_torch_fcn8_train.py``): the loss at 1e-5, every
Adam-updated param within one step of JAX's and at most 1e-3 of them
beyond 1e-5 (those whose gradient's sign differs); the
SGD step at the JAX package's own DP tolerance (``tests/test_parallel.py``:
rtol 2e-3, atol 1e-5); and the DP step's first moment is held to the mean
of single-device steps on the same shards at 1e-5 (the DP contract).
"""

import concurrent.futures
import dataclasses
import multiprocessing

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from iterative_inference_segm_tpu.data import config_datasets as jcfg  # noqa: E402
from iterative_inference_segm_tpu.inference.predictor import Predictor as JPredictor  # noqa: E402
from iterative_inference_segm_tpu.models import fcn8 as jfcn8  # noqa: E402
from iterative_inference_segm_tpu.ops.losses import masked_crossentropy as j_xent  # noqa: E402
from iterative_inference_segm_tpu.parallel.dp import make_dp_grad_step as j_dp_step  # noqa: E402
from iterative_inference_segm_tpu.parallel.dp import put_dp as j_put_dp  # noqa: E402
from iterative_inference_segm_tpu.parallel.mesh import make_mesh as j_make_mesh  # noqa: E402
from iterative_inference_segm_tpu.parallel.mesh import mesh_from_flag as j_mesh_from_flag  # noqa: E402
from iterative_inference_segm_tpu.train import loop as jloop  # noqa: E402
from iterative_inference_segm_tpu.train.train_dae import make_dae_train_step as j_dae_step  # noqa: E402
from iterative_inference_segm_tpu.train.train_fcn8 import make_fcn8_train_step as j_fcn_step  # noqa: E402
from iterative_inference_segm_tpu_torch.data import config_datasets as tcfg  # noqa: E402
from iterative_inference_segm_tpu_torch.ops.corruption_kernel import seed_from_key_data  # noqa: E402
from iterative_inference_segm_tpu_torch.parallel import launch as tlaunch  # noqa: E402
from iterative_inference_segm_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from iterative_inference_segm_tpu_torch.parallel import sharding as tsharding  # noqa: E402
from iterative_inference_segm_tpu_torch.parallel.mesh import MeshSpec  # noqa: E402

import torch_parallel_ranks as ranks  # noqa: E402
from torch_port_helpers import jax_params  # noqa: E402

N = 2  # the ranks, and the JAX devices they are held to
C = 5
FC = 16
DAE_CROP = (32, 32)
FCN_CROP = (32, 48)
DAE_J = dataclasses.replace(jcfg.CAMVID, n_classes=C, void_label=C, height=48, width=64, train_crop=DAE_CROP)
DAE_T = dataclasses.replace(tcfg.CAMVID, n_classes=C, void_label=C, height=48, width=64, train_crop=DAE_CROP)
FCN_J = dataclasses.replace(DAE_J, train_crop=FCN_CROP)
FCN_T = dataclasses.replace(DAE_T, train_crop=FCN_CROP)
DAE_KW = dict(h_taps=("pool4",), sigma=1.0, from_gt=True, augment=True, dae_depth=3)
KEY = jax.random.PRNGKey(7)


def jmesh(n=N):
    return j_make_mesh(("data",), devices=jax.devices()[:n])


def crop_draws(key, b, hw, crop):
    """The offsets and flips ``random_crop_and_flip`` draws from ``key``."""
    k_off, k_flip = jax.random.split(key)
    oy = jax.random.randint(k_off, (b,), 0, hw[0] - crop[0] + 1)
    ox = jax.random.randint(jax.random.fold_in(k_off, 1), (b,), 0, hw[1] - crop[1] + 1)
    flip = jax.random.bernoulli(k_flip, 0.5, (b,))
    return tuple(np.array(a) for a in (oy, ox, flip))


def dae_draws(b):
    """Device d's draws in the JAX DP DAE step: ``fold_in(key, d)``, split
    into (aug, noise); eval seeds K1 from ``fold_in(key, d)`` whole."""
    train, evals = [], []
    for d in range(N):
        k = jax.random.fold_in(KEY, d)
        aug, noise = jax.random.split(k)
        train.append((seed_from_key_data(jax.random.key_data(noise)), crop_draws(aug, b, (48, 64), DAE_CROP)))
        evals.append(seed_from_key_data(jax.random.key_data(k)))
    return train, evals


def fcn_draws(b):
    """Device d's crop, flips and keep-masks in the JAX DP FCN-8 step."""
    out = []
    for d in range(N):
        aug, drop = jax.random.split(jax.random.fold_in(KEY, d))
        logits_rng, _ = jax.random.split(drop)
        k1, k2 = jax.random.split(logits_rng)
        shape = (b, -(-FCN_CROP[0] // 32), -(-FCN_CROP[1] // 32), FC)
        masks = tuple(np.array(jax.random.bernoulli(k, 0.5, shape)) for k in (k1, k2))
        out.append((masks, crop_draws(aug, b, (48, 64), FCN_CROP)))
    return out


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    jfcn, jdae = jax_params()
    x = rng.random((4, 48, 64, 3), dtype=np.float32)
    y = rng.integers(0, C + 1, (4, 48, 64)).astype(np.int32)  # C = void
    x8 = rng.random((8, 48, 64, 3), dtype=np.float32)
    y8 = rng.integers(0, C, (8, 48, 64)).astype(np.int32)
    x5 = rng.random((5, 48, 64, 3), dtype=np.float32)
    y5 = rng.integers(0, C, (5, 48, 64)).astype(np.int32)
    draws = np.array([float(jax.random.normal(jax.random.fold_in(jax.random.PRNGKey(42), d), ())) for d in range(N)])
    return dict(jfcn=jax.device_get(jfcn), jdae=jax.device_get(jdae), x=x, y=y, x8=x8, y8=y8, x5=x5, y5=y5,
                draws=draws, targets=np.arange(8.0, dtype=np.float32), imgs=rng.random((3, 48, 64, 3), dtype=np.float32))


def port_cases(d, workdir):
    train_rand, eval_seeds = dae_draws(2)
    u8x = np.random.default_rng(1).integers(0, 256, (5, 8, 8, 3), np.uint8)
    u8y = np.random.default_rng(2).integers(0, 11, (5, 8, 8)).astype(np.uint8)
    items = [{"x": np.full((4, 2, 2, 1), i, np.float32) + np.arange(4, dtype=np.float32)[:, None, None, None]}
             for i in range(3)]
    return [
        ("who", "whoami", {}),
        ("mesh", "mesh_basics", {}),
        ("shard", "shard_and_replicate", {"x": d["x8"], "y": d["y8"]}),
        ("put_f32", "putter", {"x": d["x5"], "y": d["y5"], "void_label": C}),
        ("put_u8", "putter", {"x": u8x, "y": u8y, "void_label": 11}),
        ("prefetch", "prefetch_sharded", {"items": items}),
        ("dp_step", "dp_grad_step", {"jparams": d["jfcn"], "images": d["x8"], "labels": d["y8"], "n_classes": C,
                                     "lr": 1e-2}),
        ("dp_rng", "dp_rng_and_mean", {"draws": d["draws"], "targets": d["targets"]}),
        ("dae", "dae_dp_step", {"cfg": DAE_T, "jfcn": d["jfcn"], "jdae": d["jdae"], "images": d["x"],
                                "labels": d["y"], "train_rand": train_rand, "eval_seeds": eval_seeds,
                                "step_kw": DAE_KW}),
        ("fcn", "fcn_dp_step", {"cfg": FCN_T, "jparams": d["jfcn"], "images": d["x"], "labels": d["y"],
                                "rands": fcn_draws(2), "fc": FC}),
        ("padded", "fcn_eval_padded", {"cfg": FCN_T, "jparams": d["jfcn"], "images": d["x5"], "labels": d["y5"],
                                       "fc": FC}),
        ("pred_half", "predictor_dp", {"cfg": DAE_T, "jfcn": d["jfcn"], "jdae": d["jdae"], "images": d["imgs"],
                                       "kw": dict(batch_size=2, num_steps=2, eps=0.3, engine="half",
                                                  dae_kwargs={"depth": 3})}),
        ("pred_general", "predictor_dp", {"cfg": DAE_T, "jfcn": d["jfcn"], "jdae": d["jdae"], "images": d["imgs"],
                                          "kw": dict(batch_size=2, num_steps=2, eps=0.3, engine="general",
                                                     dae_kwargs={"depth": 3})}),
        ("trainers", "trainers_dp", {"cfg": DAE_T, "workdir": str(workdir), "fc": FC, "seed": 3}),
    ]


def adam_mu(opt_state):
    return jax.device_get(next(s for s in jax.tree.leaves(opt_state, is_leaf=lambda s: hasattr(s, "mu"))
                               if hasattr(s, "mu")).mu)


def jax_side(d):
    """The JAX package's results on the same inputs over N devices."""
    out = {}
    tx = optax.sgd(1e-2)
    batch = {"images": jnp.asarray(d["x8"]), "labels": jnp.asarray(d["y8"])}

    def loss_fn(p, b, rng):
        return j_xent(jfcn8.fcn8_logits(p, b["images"]), b["labels"], n_classes=C)

    p_r, o_r, b_r = j_put_dp(jmesh(), d["jfcn"], tx.init(d["jfcn"]), batch)
    p, _, loss = j_dp_step(loss_fn, tx, jmesh())(p_r, o_r, b_r, None)
    out["dp_step"] = {"loss": float(loss), "params": jax.device_get(p)}

    cfg = jloop.TrainConfig()
    tx = jloop.make_optimizer(cfg)
    train, evals = j_dae_step(DAE_J, cfg, tx, corruption_impl="pallas", mesh=jmesh(), **DAE_KW)
    x, y = jnp.asarray(d["x"]), jnp.asarray(d["y"])
    cm, vloss = evals(d["jdae"], d["jfcn"], x, y, KEY)
    _, opt, loss = train(d["jdae"], tx.init(d["jdae"]), d["jfcn"], x, y, KEY)
    out["dae"] = {"loss": float(loss), "mu": adam_mu(opt), "cm": np.asarray(cm), "val_loss": float(vloss)}

    train, evals = j_fcn_step(FCN_J, cfg, tx, fc_channels=FC, mesh=jmesh())
    cm, vloss = evals(d["jfcn"], x, y)
    p, opt, loss = train(d["jfcn"], tx.init(d["jfcn"]), x, y, KEY)
    out["fcn"] = {"loss": float(loss), "params": jax.device_get(p), "mu": adam_mu(opt),
                  "cm": np.asarray(cm), "val_loss": float(vloss)}

    for engine in ("half", "general"):
        jp = JPredictor(d["jfcn"], d["jdae"], dataset=DAE_J, compute_dtype=jnp.float32, mesh=jmesh(), batch_size=2,
                        num_steps=2, eps=0.3, engine=engine, dae_kwargs={"depth": 3})
        out[f"pred_{engine}"] = jp.predict(d["imgs"], return_probs=True)
    return out


@pytest.fixture(scope="module")
def both(data, tmp_path_factory):
    """Rank 0's results and every rank's, with the JAX side computed while
    the ranks run."""
    workdir = tmp_path_factory.mktemp("dp_trainers")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(tlaunch.launch_ranks, ranks.run_cases, port_cases(data, workdir),
                           mesh=MeshSpec(("data",), (N,)), device="cpu")
        want = jax_side(data)
        got = port.result()
    return got, want, workdir


def leaves_close(got, want, rtol, scale_tol, err=""):
    assert set(got) == set(want), err
    for layer, lv in want.items():
        for k, w in lv.items():
            w = np.asarray(w)
            np.testing.assert_allclose(got[layer][k], w, rtol=rtol, atol=scale_tol * float(np.abs(w).max()),
                                       err_msg=f"{err}{layer}/{k}")


# ------------------------------------------------------------------ mesh


def test_mesh_from_flag_semantics():
    """As ``tests/test_cli_dp.py`` pins for the JAX package, on the CPU's 8."""
    assert tmesh.mesh_from_flag(None) is None
    assert tmesh.mesh_from_flag("1", device_type="cpu") is None
    auto = tmesh.mesh_from_flag("auto", device_type="cpu")
    assert auto.shape["data"] == len(jax.devices()) == j_mesh_from_flag("auto").shape["data"]
    assert tmesh.mesh_from_flag("4", batch_size=8, device_type="cpu").shape == {"data": 4}
    with pytest.raises(ValueError, match="divisible"):
        tmesh.mesh_from_flag("8", batch_size=12, device_type="cpu")
    with pytest.raises(ValueError, match="visible"):
        tmesh.mesh_from_flag(str(len(jax.devices()) + 1), device_type="cpu")
    for flag, kw in (("8", {"batch_size": 12}), (str(len(jax.devices()) + 1), {})):
        with pytest.raises(ValueError) as je:
            j_mesh_from_flag(flag, **kw)
        with pytest.raises(ValueError) as te:
            tmesh.mesh_from_flag(flag, device_type="cpu", **kw)
        assert str(te.value) == str(je.value)


def test_local_device_count_on_the_cpu_is_the_jax_tests_count():
    assert tmesh.local_device_count("cpu") == tmesh.CPU_DEVICE_COUNT == len(jax.devices()) == 8


def test_mesh_spec_shape_and_size():
    spec = MeshSpec(("data", "stage"), (2, 3))
    assert spec.shape == {"data": 2, "stage": 3} and spec.size == 6
    with pytest.raises(ValueError):
        MeshSpec(("data",), (2, 2))


def test_make_mesh_needs_a_launched_group_and_the_helpers_a_mesh():
    with pytest.raises(RuntimeError, match="launched process group"):
        tmesh.make_mesh()
    with pytest.raises(TypeError, match="DeviceMesh"):
        tmesh.axis_size(object(), "data")


def test_mesh_in_a_rank(both):
    got = both[0][0]["mesh"]
    assert got["size"] == N and got["index"] == 0
    assert "do not multiply to device count 2" in got["bad_sizes"]
    assert got["no_axis"].startswith("ValueError") and "'stage'" in got["no_axis"]
    assert got["two"] == (1, 2, 0)
    assert [r["mesh"]["index"] for r in both[0]] == [0, 1]


# ------------------------------------------------------------------ launch


def test_launch_gives_each_rank_its_device_backend_and_mesh(both, capsys):
    who = [r["who"] for r in both[0]]
    assert [w["rank"] for w in who] == [0, 1]
    assert all(w["device"] == "cpu" and w["backend"] == "gloo" and w["names"] == ("data",) for w in who)


def test_launch_prints_rank_0_alone(capsys):
    assert tlaunch.launch(ranks.whoami, mesh=MeshSpec(("data",), (N,)), device="cpu")["rank"] == 0
    out = capsys.readouterr().out
    assert "printed by rank 0" in out and "printed by rank 1" not in out


def test_a_failing_rank_fails_the_launch_with_its_traceback():
    with pytest.raises(tlaunch.RankError) as e:
        tlaunch.launch(ranks.fail_on_rank, 1, mesh=MeshSpec(("data",), (N,)), device="cpu")
    assert str(e.value).startswith("rank 1 failed first:")
    assert "boom from rank 1" in str(e.value) and "Traceback" in str(e.value)
    assert "fail_on_rank" in str(e.value)
    assert not multiprocessing.active_children()


def test_backend_and_devices_are_explicit():
    cuda2 = [torch.device("cuda", 0)] * 2
    assert tlaunch.resolve_backend([torch.device("cpu")] * 2, None) == "gloo"
    assert tlaunch.resolve_backend(tlaunch.rank_devices("cuda", 2), None) == "nccl"
    assert tlaunch.rank_devices("cuda", 2) == [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert tlaunch.rank_devices("cuda:0", 2) == cuda2
    assert tlaunch.resolve_backend(cuda2, "gloo") == "gloo"
    with pytest.raises(ValueError, match="one card a rank"):
        tlaunch.resolve_backend(cuda2, None)
    with pytest.raises(ValueError, match="needs CUDA"):
        tlaunch.resolve_backend([torch.device("cpu")], "nccl")
    with pytest.raises(ValueError, match="unknown backend"):
        tlaunch.resolve_backend([torch.device("cpu")], "mpi")


def test_a_cuda_launch_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tlaunch.launch(ranks.whoami, mesh=MeshSpec(("data",), (N,)), device="cuda")


def test_importing_the_layer_forms_no_group_and_starts_no_process():
    import importlib

    import torch.distributed as dist

    for name in ("launch", "mesh", "sharding", "dp", "tp", "pp", "comm"):
        importlib.import_module(f"iterative_inference_segm_tpu_torch.parallel.{name}")
    assert not dist.is_initialized()
    assert not multiprocessing.active_children()


def test_the_launcher_builds_the_native_runtime_once(tmp_path, monkeypatch):
    """A 2-rank packed DP run on an empty build directory: the parent
    compiles the runtime before the spawn; the ranks load it, compiling
    nothing."""
    from iterative_inference_segm_tpu_torch.data.native_loader import pack_dataset
    from iterative_inference_segm_tpu_torch.ops import _build

    cfg = dataclasses.replace(tcfg.CAMVID, n_classes=C, void_label=C, train_crop=(32, 32))
    rng = np.random.default_rng(0)
    pack_dataset(tmp_path / "train.iist", rng.integers(0, 256, (6, 48, 64, 3), np.uint8),
                 rng.integers(0, C, (6, 48, 64)).astype(np.int32), cfg)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    compiles = []
    run = _build.subprocess.run
    monkeypatch.setattr(_build.subprocess, "run", lambda cmd, **kw: compiles.append(cmd[0]) or run(cmd, **kw))
    got = tlaunch.launch_ranks(ranks.prebuild_count, str(tmp_path / "train.iist"), cfg, mesh=MeshSpec(("data",), (N,)),
                               device="cpu", native_runtime=True)
    assert compiles == [_build.HOST_CXX] and [r["compiles"] for r in got] == [0, 0]
    assert all(r["build_dir"] == str(tmp_path / "build") for r in got)
    assert len(list((tmp_path / "build").glob("libinput_runtime-*.so"))) == 1
    assert len(list((tmp_path / "build").glob("libinput_runtime-*.log"))) == 1


# ------------------------------------------------------------------ sharding


def test_shard_batch_and_replicate(both, data):
    for r, res in enumerate(both[0]):
        got = res["shard"]
        np.testing.assert_array_equal(got["x"], data["x8"][4 * r : 4 * r + 4])
        np.testing.assert_array_equal(got["y"], data["y8"][4 * r : 4 * r + 4])
        np.testing.assert_array_equal(got["replicated"], np.ones(3, np.float32))  # rank 0's
        np.testing.assert_array_equal(got["gathered"], data["x8"])
        assert got["placements"] == ["Shard"] and got["replicated_placements"] == ["Replicate"]


def test_padded_batch_putter_pads_exactly_on_both_wires(both, data):
    """Zero images and void labels to a multiple of the axis, dtypes kept
    (the u8 wire stays bytes), the padded size pinned by the first batch."""
    for name, void in (("put_f32", C), ("put_u8", 11)):
        x_all = np.concatenate([r[name]["x"] for r in both[0]])
        y_all = np.concatenate([r[name]["y"] for r in both[0]])
        src_x = data["x5"] if name == "put_f32" else np.random.default_rng(1).integers(0, 256, (5, 8, 8, 3), np.uint8)
        assert x_all.shape[0] == 6 and x_all.dtype == src_x.dtype
        np.testing.assert_array_equal(x_all[:5], src_x)
        assert (x_all[5:] == 0).all() and (y_all[5:] == void).all()
        assert both[0][1][name]["x2_shape"][0] == 3 and (both[0][1][name]["y2"] == void).all()


def test_padded_eval_counts_exactly_the_real_rows(both):
    for r in both[0]:
        got = r["padded"]
        assert got["local_rows"] == 3
        np.testing.assert_array_equal(got["cm_dp"], got["cm_one"])
        assert np.isfinite(got["loss"])


def test_spatial_sharding_is_refused_naming_the_roadmap():
    """Spatial (H) sharding is ported (Queue 1 step I): ``spatial_axis`` is
    no longer refused, and like the batch axis it needs a launched mesh
    (``tests/test_torch_spatial.py`` holds what it places)."""
    with pytest.raises(TypeError, match="DeviceMesh"):
        tsharding.batch_sharding(None, 4, spatial_axis="space")
    with pytest.raises(TypeError, match="DeviceMesh"):
        tsharding.shard_batch(None, np.zeros((2, 2)), spatial_axis="space")


def test_device_prefetch_places_this_ranks_shard(both):
    for r, res in enumerate(both[0]):
        for i, item in enumerate(res["prefetch"]):
            np.testing.assert_array_equal(item["x"][:, 0, 0, 0], i + np.arange(2 * r, 2 * r + 2, dtype=np.float32))


# ------------------------------------------------------------------ dp


def test_dp_grad_step_matches_jax(both):
    got, want = both[0][0]["dp_step"], both[1]["dp_step"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    for layer, lv in want["params"].items():
        for k, w in lv.items():
            np.testing.assert_allclose(got["params"][layer][k], np.asarray(w), rtol=2e-3, atol=1e-5,
                                       err_msg=f"{layer}/{k}")
    leaves_close(both[0][1]["dp_step"]["params"], got["params"], 0, 0, "rank 1 ")  # replicated, to the bit


def test_dp_grad_step_is_one_all_reduce(both):
    assert [r["dp_step"]["all_reduce_calls"] for r in both[0]] == [1, 1]
    assert [r["dae"]["all_reduce_calls"] for r in both[0]] == [1, 1]


def test_dp_rng_is_each_ranks_own_and_the_mean_covers_every_shard(both, data):
    got = both[0][0]["dp_rng"]
    np.testing.assert_allclose(got["w"], -data["draws"].mean(), rtol=1e-5)
    assert np.std(data["draws"]) > 1e-3
    np.testing.assert_allclose(got["w_mean"], 1.75, rtol=1e-5)


def test_dae_dp_train_step_matches_jax(both):
    got, want = both[0][0]["dae"], both[1]["dae"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    leaves_close(got["mu"], want["mu"], 1e-4, 1e-4)
    assert both[0][1]["dae"]["loss"] == got["loss"]


def test_dae_dp_eval_step_matches_jax(both, data):
    got, want = both[0][0]["dae"], both[1]["dae"]
    np.testing.assert_array_equal(got["cm"], want["cm"])
    assert int(got["cm"].sum()) == int((data["y"] < C).sum())
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=1e-5)


def test_fcn8_dp_train_step_matches_jax(both):
    got, want = both[0][0]["fcn"], both[1]["fcn"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    leaves_close(got["mu"], got["mu_shards"], 1e-5, 1e-5)
    # Adam's first step is lr * g / (|g| + eps) per entry, so every entry is
    # within one step (lr) of JAX's; beyond 1e-5 only where the gradient's
    # sign differs, near 0 or at a flipped ReLU unit (the note above)
    off, total = 0, 0
    for layer, lv in want["params"].items():
        for k, w in lv.items():
            w = np.asarray(w)
            scale = float(np.abs(w).max())
            assert np.abs(got["params"][layer][k] - w).max() <= 2e-3 + 1e-5 * scale, f"{layer}/{k}"
            off += int((~np.isclose(got["params"][layer][k], w, rtol=1e-5, atol=1e-5 * scale)).sum())
            total += w.size
    assert off <= 1e-3 * total, f"{off} of {total} entries took another Adam step"


def test_fcn8_dp_eval_step_matches_jax(both):
    got, want = both[0][0]["fcn"], both[1]["fcn"]
    np.testing.assert_array_equal(got["cm"], want["cm"])
    np.testing.assert_allclose(got["val_loss"], want["val_loss"], rtol=1e-5)


def test_trainers_under_a_mesh_write_once_and_stay_replicated(both):
    """Both trainers for two epochs on 5-row batches (the last shard padded):
    the ranks started from other weights and end equal; rank 0 alone wrote
    metrics.jsonl (one line an epoch), best_*.npz and the checkpoints."""
    res, _, workdir = both
    for name in ("fcn", "dae"):
        assert res[0]["trainers"][name] == res[1]["trainers"][name]
        timing = ("epoch_seconds", "train_images_per_sec")
        strip = lambda hs: [{k: v for k, v in h.items() if k not in timing} for h in hs]  # noqa: E731
        assert strip(res[0]["trainers"][f"{name}_history"]) == strip(res[1]["trainers"][f"{name}_history"])
        lines = (workdir / name / "metrics.jsonl").read_text().splitlines()
        assert len(lines) == 2
        assert (workdir / name / f"best_{'fcn8' if name == 'fcn' else 'dae'}.npz").exists()
        assert sorted(p.name for p in (workdir / name / "ckpt").iterdir()) == ["0", "1"]
    assert res[0]["trainers"]["fcn_history"][0]["train_images_per_sec"] > 0


def test_dp_predictor_matches_jax(both, data):
    """Batch 2 over 3 images on 2 ranks: each rank serves one image of a
    chunk, the short last chunk padded; labels and probabilities gathered."""
    for engine in ("half", "general"):
        want_labels, want_probs = both[1][f"pred_{engine}"]
        for r in both[0]:
            got = r[f"pred_{engine}"]
            assert got["labels"].shape == (3, 48, 64) and got["probs"].dtype == np.float32
            np.testing.assert_allclose(got["probs"], want_probs, rtol=1e-5, atol=1e-5)
            np.testing.assert_array_equal(got["labels"], want_labels)
            assert "not divisible by mesh 'data' size 2" in got["indivisible"]
