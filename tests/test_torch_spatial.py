"""Spatial (H) sharding (``parallel/spatial.py``: explicit halo exchange in
place of XLA's), ``utils/checkpoint.restore_checkpoint_sharded`` and the
legs of ``entry multichip``, held to the JAX package's contract:

* ``tests/test_parallel.py:97`` (FCN-8 forward, rtol 2e-4 / atol 2e-5),
  ``:133`` (general engine, K = 3 through the DAE: y0 at 2e-4 / 2e-5, y_K
  at 5e-4 / 5e-5, non-vacuous) and ``:163`` (half engine: the stem
  avg-pool, the pooled scan, the full-res rectification; as ``:133``), at
  48x64, C = 5, fc 16, against the unsharded JAX functions (JAX's own tests
  hold its sharded forward to them at these tolerances) and against the
  port unsharded. Also at H = 40 over 2 shards, where the /8 map has 5
  rows: the ceil-mode pool's odd tail row lies on the last shard, and
  pool4's windows and the deconvs' reaches cross the shards' edges;
* ``:314`` (the communication contract), counted on the port's own calls
  in the FCN-8 forward: at least one neighbour transfer, at most one
  all-gather (exactly one on a (1, 4) mesh, where the /32 map has 2 rows
  for 4 shards; none on (2, 2)), no all-reduce;
* the sharded DAE step against the unsharded one (K1 on the gathered
  labels): loss within 1e-5, each leaf of the gradient (Adam's first
  moment) within 1e-5 of its largest entry, the eval confusion equal;
* ``tests/test_checkpoint.py:137,162``: a replicated save restored onto
  the fc6/fc7 TP layout and a TP-sharded save restored replicated, each
  leaf equal to the part its placement cuts from the whole.

Every case runs in one launch of 4 gloo ranks, on meshes formed over them
(('data', 'space') (2, 2) and (1, 4), ('data', 'model') (2, 2)), while
this process computes the JAX side once; ``entry multichip 3`` (the odd,
1-D mesh path) runs as a user runs it, beside them.
"""

import concurrent.futures
import dataclasses
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from iterative_inference_segm_tpu.inference import make_refiner  # noqa: E402
from iterative_inference_segm_tpu.inference.fused import make_half_refiner  # noqa: E402
from iterative_inference_segm_tpu.models import dae_apply, fcn8_apply  # noqa: E402
from iterative_inference_segm_tpu_torch.data import config_datasets as tcfg  # noqa: E402
from iterative_inference_segm_tpu_torch.parallel.launch import launch_ranks  # noqa: E402
from iterative_inference_segm_tpu_torch.parallel.mesh import MeshSpec  # noqa: E402
from iterative_inference_segm_tpu_torch.parallel.spatial import bounds  # noqa: E402

import torch_parallel_ranks as ranks  # noqa: E402
from torch_port_helpers import C, images, jax_params  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Y0 = dict(rtol=2e-4, atol=2e-5)
YK = dict(rtol=5e-4, atol=5e-5)
GENERAL = dict(eps=0.2, num_steps=3, h_taps=("pool4",))
HALF = dict(eps=0.3, num_steps=2, h_taps=("pool4",), depth=3)
STEP_CFG = dataclasses.replace(tcfg.CAMVID, n_classes=C, void_label=C, height=48, width=64, train_crop=(40, 48),
                               class_names=tcfg.CAMVID.class_names[:C])


def inputs():
    """Numpy trees (a rank that unpickled JAX arrays would import JAX)."""
    jf, jd_h = jax.device_get(jax_params())
    jd_g = jax.device_get(jax_params(stem_pool=0, depth=4)[1])
    rng = np.random.default_rng(11)
    labels = rng.integers(0, C + 1, size=(2, 48, 64)).astype(np.int32)
    crop = (np.array([3, 6]), np.array([9, 2]), np.array([True, False]))
    return dict(jf=jf, jd_g=jd_g, jd_h=jd_h, jf2=jax.device_get(jax_params(encoder_seed=3, fcn_scale=0.5)[0]),
                x=images(2, 4), x40=images(2, 5)[:, :40], labels=labels,
                raw=(images(2, 6) * 40 + 120).clip(0, 255), crop=crop)


def port_runs(p, workdir):
    cases = [
        ("forwards", "spatial_forwards", dict(jfcn=p["jf"], jdae_g=p["jd_g"], jdae_h=p["jd_h"], x=p["x"],
                                              x40=p["x40"])),
        ("ops", "spatial_ops", dict(heights=(1, 2, 3, 5, 7, 12, 45))),
        ("step", "spatial_dae_step", dict(cfg=STEP_CFG, jfcn=p["jf"], jdae=p["jd_g"], images=p["raw"],
                                          labels=p["labels"], crop=p["crop"], seed=1234)),
        ("trainer", "spatial_trainer", dict(cfg=STEP_CFG, jfcn=p["jf"], images=p["raw"], labels=p["labels"])),
        ("restore", "sharded_restore", dict(jparams=p["jf"], jparams2=p["jf2"], workdir=workdir)),
        ("dryrun", "dryrun_legs", dict(workdir=os.path.join(workdir, "dryrun"))),
        ("placements", "spatial_placements", dict(x=p["x"])),
    ]
    return launch_ranks(ranks.run_cases, cases, mesh=MeshSpec(("data",), (4,)), device="cpu")


def multichip_cli(n):
    # one intra-op thread, as this process has, so its ranks take one each
    return subprocess.run([sys.executable, "-m", "iterative_inference_segm_tpu_torch.entry", "multichip", str(n),
                           "--device", "cpu"], cwd=REPO, capture_output=True, text=True, timeout=600,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})


def jax_runs(p):
    general = make_refiner(fcn8_apply, dae_apply, p["jf"], p["jd_g"], **GENERAL)
    general2 = make_refiner(fcn8_apply, dae_apply, p["jf"], p["jd_g"], **dict(GENERAL, num_steps=2))
    half = make_half_refiner(fcn8_apply, p["jf"], p["jd_h"], **HALF)
    out = {"fcn": np.asarray(jax.jit(lambda q, x: fcn8_apply(q, x)[0])(p["jf"], jnp.asarray(p["x"])))}
    for name, fn, x in (("general14", general, p["x"]), ("general40", general2, p["x40"]),
                        ("half14", half, p["x"])):
        out[name] = tuple(np.asarray(a) for a in fn(jnp.asarray(x)))
    return out


@pytest.fixture(scope="module")
def runs():
    p = inputs()
    with tempfile.TemporaryDirectory() as td, concurrent.futures.ThreadPoolExecutor(2) as pool:
        port = pool.submit(port_runs, p, td)
        cli = pool.submit(multichip_cli, 3)
        want = jax_runs(p)
        got = port.result()
        cli = cli.result()
    return {"port": got, "rank0": got[0], "jax": want, "cli": cli, "inputs": p}


def test_sharded_fcn8_forward_matches_jax_and_unsharded(runs):
    """``tests/test_parallel.py:97``'s twin, on (2, 2) and on (1, 4) (the
    /32 map gathered)."""
    fw = runs["rank0"]["forwards"]
    for name in ("fcn22", "fcn14"):
        np.testing.assert_allclose(fw[name]["probs"], runs["jax"]["fcn"], **Y0)
        np.testing.assert_allclose(fw[name]["probs"], fw["fcn_unsharded"], **Y0)


@pytest.mark.parametrize("name", ["general14", "general40", "half14"])
def test_sharded_engines_match_jax_and_unsharded(runs, name):
    """``:133`` (the general engine, K = 3, on (1, 4)), the same at H = 40
    on (2, 2), and ``:163`` (the half engine on (1, 4))."""
    got = runs["rank0"]["forwards"][name]
    y0_ref, yk_ref = runs["jax"][name]
    np.testing.assert_allclose(got["y0"], y0_ref, **Y0)
    np.testing.assert_allclose(got["yk"], yk_ref, **YK)
    np.testing.assert_allclose(got["y0"], got["unsharded"][0], **Y0)
    np.testing.assert_allclose(got["yk"], got["unsharded"][1], **YK)
    assert float(np.abs(yk_ref - y0_ref).max()) > 1e-4  # refinement moved the iterate


def test_h40_puts_the_odd_tail_row_on_the_last_shard():
    """At H = 40 over 2 shards the /8 map has 5 rows, split (2, 3): pool4's
    last (ceil-mode) window holds one real row, on the last shard, and the
    bands' edge at row 2 is one a deconv's reach and a 3x3 conv's halo
    cross (the path ``test_sharded_engines_match_jax_and_unsharded
    [general40]`` holds to JAX)."""
    heights = [40]
    for _ in range(5):
        heights.append(-(-heights[-1] // 2))
    assert heights == [40, 20, 10, 5, 3, 2]
    assert bounds(5, 2) == ((0, 2), (2, 5))
    assert bounds(3, 2) == ((0, 1), (1, 3))
    assert bounds(2, 4) == ((0, 0), (0, 0), (0, 1), (1, 2))


@pytest.mark.parametrize("name,gathers", [("fcn22", 0), ("fcn14", 1)])
def test_forward_communication_is_halo_exchange(runs, name, gathers):
    """``:314``'s twin: every rank's FCN-8 forward made neighbour transfers
    (isend/irecv between adjacent 'space' ranks), at most one all-gather
    (the /32 map of 2 rows over 4 shards, once) and no all-reduce."""
    for rank_out in runs["port"]:
        log = rank_out["forwards"][name]["log"]
        assert log["all_reduce_"] == 0 and log["all_gather_cat"] == gathers
        assert log["isend"] and log["irecv"]
        assert any(abs(me - peer) == 1 for me, peer in log["isend"] + log["irecv"])
        if gathers == 0:
            assert all(abs(me - peer) == 1 for me, peer in log["isend"] + log["irecv"])


def test_each_sharded_op_matches_the_whole_map_forward_and_backward(runs):
    """conv2d (3x3, stride 2, 7x7, 1x1, dilated), both transposed convs,
    the depthwise pair, both pools, max_unpool and the Caffe crop, on bands
    of 1..45-row maps over 4 and 2 shards (empty bands included): the band
    of the whole map's output, and of its gradient, in f64."""
    for rank_out in runs["port"]:
        worst = rank_out["ops"]
        assert len(worst) == 13
        assert max(worst.values()) < 1e-10, worst


def test_sharded_dae_step_matches_unsharded(runs):
    """The DAE step on (1, 4) (K1 on the gathered labels, the loss's count
    and the one all-reduce summed over 'space') is the unsharded step."""
    step = runs["rank0"]["step"]
    ref, got = step["unsharded"], step["sharded"]
    assert abs(got["loss"] - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    assert abs(got["eval_loss"] - ref["eval_loss"]) <= 1e-5 * abs(ref["eval_loss"])
    np.testing.assert_array_equal(got["cm"], ref["cm"])
    for k, m1 in ref["m1"].items():
        assert np.abs(got["m1"][k] - m1).max() <= 1e-5 * np.abs(m1).max(), k
    assert np.abs(ref["m1"]["enc1/w"]).max() > 0


def test_sharded_dae_trainer_matches_unsharded(runs):
    """``train_dae`` on (1, 4): the trainer puts each rank's band and draws
    the crops for the whole frame; one epoch's losses and val mIoU are the
    unsharded trainer's."""
    got, ref = runs["rank0"]["trainer"]["sharded"], runs["rank0"]["trainer"]["unsharded"]
    for key in ("train_loss", "val_loss"):
        assert abs(got[key] - ref[key]) <= 1e-5 * abs(ref[key]), key
    assert got["val_miou"] == pytest.approx(ref["val_miou"], abs=1e-6)


def test_restore_checkpoint_sharded_tp_layout(runs):
    """``tests/test_checkpoint.py:137``'s twin: a replicated save restored
    onto ``tp_shardings``: fc6 column- and fc7 row-parallel parts, every
    other leaf whole."""
    for rank_out in runs["port"]:
        tp = rank_out["restore"]["tp"]
        for key, (got, want, placement) in tp.items():
            np.testing.assert_array_equal(got, want)
        assert tp["fc6/w"][2] == ("Replicate()", "Shard(dim=0)") and tp["fc6/w"][0].shape == (8, 512, 7, 7)
        assert tp["fc6/b"][2] == ("Replicate()", "Shard(dim=0)") and tp["fc6/b"][0].shape == (8,)
        assert tp["fc7/w"][2] == ("Replicate()", "Shard(dim=1)") and tp["fc7/w"][0].shape == (16, 8, 1, 1)
        assert tp["fc7/b"][2] == ("Replicate()", "Replicate()")
        assert tp["conv1_1/w"][2] == ("Replicate()", "Replicate()")


def test_restore_checkpoint_sharded_from_sharded_save(runs):
    """``tests/test_checkpoint.py:162``'s twin: the ranks' TP parts saved
    (gathered, written once) and restored replicated: the whole leaves."""
    for rank_out in runs["port"]:
        for key, (got, want, placement) in rank_out["restore"]["replicated"].items():
            np.testing.assert_array_equal(got, want)
            assert placement == ("Replicate()", "Replicate()")
        assert rank_out["restore"]["replicated"]["fc6/w"][0].shape == (16, 512, 7, 7)


def test_multichip_legs_in_four_ranks(runs):
    """``dryrun_multichip(4)``'s legs: DP x SP (2, 2), DP, TP, the 2-stage
    (x DP), 3-stage and stacked pipelines, the sharded restore."""
    legs = runs["rank0"]["dryrun"]
    assert np.isfinite(legs["sp_loss"]) and np.isfinite(legs["dp_loss"])
    assert legs["tp_probs"] == (2, 64, 64, 5)
    assert legs["pp2_yk"] == (3, 4, 64, 64, 5) and legs["pp3_yk"] == (2, 2, 64, 64, 5)
    assert legs["stacked"] == (3, 2, 16, 16, 8)
    assert legs["restored_fc6"] == (16, 512, 7, 7)


def test_multichip_cli_takes_the_1d_mesh_for_odd_n(runs):
    """``python -m iterative_inference_segm_tpu_torch.entry multichip 3
    --device cpu``: the ('data',) mesh, OK printed."""
    cli = runs["cli"]
    assert cli.returncode == 0, cli.stderr[-3000:]
    assert cli.stdout.strip().splitlines()[-1] == "dryrun_multichip(3) OK"


def test_spatial_placements_shard_and_gather_h(runs):
    """``batch_sharding``/``shard_batch`` with ``spatial_axis`` (the JAX
    ``P('data', 'space')``): each rank's equal band of its batch shard;
    1-D leaves keep H unsharded; ``gather_batch`` puts the whole back. The
    FCN-8 step refuses a 'space' axis (its gradient would be summed over
    ranks that hold the same rows)."""
    x = runs["inputs"]["x"]
    for rank_out in runs["port"]:
        pl = rank_out["placements"]
        d, s = pl["coords"]
        assert pl["placements"] == ("Shard(dim=0)", "Shard(dim=1)")
        np.testing.assert_array_equal(pl["band"], x[d:d + 1, 24 * s:24 * (s + 1)])
        np.testing.assert_array_equal(pl["flat"], np.arange(4.0)[2 * d:2 * d + 2])
        np.testing.assert_array_equal(pl["whole"], x)
        assert pl["fcn_refusal"].startswith("ValueError: the FCN-8 step shards the batch over 'data' alone")
