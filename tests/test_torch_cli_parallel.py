"""The CLI twins' parallel flags, run as ``tests/test_cli_dp.py`` runs the
JAX CLIs, with ``--device cpu --devices N`` (N gloo ranks; the JAX CLIs on
as many faked CPU devices): ``--devices`` in both trainers and in
``iterative_inference`` (sharded serving), and ``--pp``, ``--pp-stages``,
``--pp-microbatches`` (pipeline serving). At 96x128, fc 64, C=11, f32.

Three runs go through ``main`` with ``--devices`` as a user would (each
re-enters ``main`` in its ranks); the rest run ``main`` inside one launch of
2 ranks and one of 3 (``torch_parallel_ranks.cli_lines``), each on the mesh
its flags ask for. Served runs print exactly the single-device run's lines
(mIoU and accuracy to 4 decimals), and the sharded and DP x PP runs the JAX
CLI's lines on the same weights.
"""

import concurrent.futures

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from iterative_inference_segm_tpu_torch.data.config_datasets import CAMVID  # noqa: E402
from iterative_inference_segm_tpu_torch.data.native_loader import pack_dataset  # noqa: E402
from iterative_inference_segm_tpu_torch.parallel.launch import launch  # noqa: E402
from iterative_inference_segm_tpu_torch.parallel.mesh import MeshSpec  # noqa: E402
from iterative_inference_segm_tpu_torch.scripts import iterative_inference as tcli  # noqa: E402
from iterative_inference_segm_tpu_torch.scripts import train_dae as tdae_cli  # noqa: E402
from iterative_inference_segm_tpu_torch.scripts import train_fcn8 as tfcn_cli  # noqa: E402

import torch_parallel_ranks as ranks  # noqa: E402
from torch_port_helpers import cli_lines, jax_script, write_camvid_tree, write_cli_npz  # noqa: E402

CPU = ["--device", "cpu"]
HALF = ["--synthetic", "--tiny", "--num-steps", "3", "--engine", "half", "--dae-stem-pool", "1", "--dae-depth", "3",
        "--batch-size", "8", "--num-batches", "2", "--seed", "7"]
GENERAL = ["--synthetic", "--tiny", "--num-steps", "3", "--engine", "general", "--dae-depth", "4",
           "--batch-size", "8", "--num-batches", "2", "--seed", "7"]


def metrics(lines):
    return [ln for ln in lines if "mIoU" in ln]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Weights (FCN-8 fc 64 + DAE stem-pool 1, depth 3), a CamVid tree of 5
    frames a split (5 % 4 != 0) and packed files (6 train, 4 val, 4 test)."""
    d = tmp_path_factory.mktemp("cli_parallel")
    weights = write_cli_npz(d, 1, 3, "full")
    write_camvid_tree(d / "camvid", (64, 64), {"train": 5, "val": 5, "test": 5})
    rng = np.random.default_rng(0)
    (d / "packed").mkdir()
    for split, n in (("train", 6), ("val", 4), ("test", 4)):
        pack_dataset(d / "packed" / f"{split}.iist", rng.integers(0, 256, (n, 96, 128, 3), np.uint8),
                     rng.integers(0, CAMVID.n_classes, (n, 96, 128)).astype(np.int32), CAMVID)
    return d, weights


def rank_cases(d, weights):
    served = ["--synthetic", "--tiny", "--num-steps", "1", "--batch-size", "8", "--num-batches", "1",
              "--engine", "half", *weights]
    two = [
        ("served", "cli_lines", {"module": "iterative_inference", "argv": [*served, *CPU, "--devices", "2"]}),
        ("disk_served", "cli_lines", {"module": "iterative_inference", "argv": [
            "--dataset", "camvid", "--data-root", str(d / "camvid"), "--tiny", "--num-steps", "1",
            "--batch-size", "4", "--dae-widths", "8", "16", "32", "64", *CPU, "--devices", "2"]}),
        ("disk_train", "cli_lines", {"module": "train_fcn8", "argv": [
            "--dataset", "camvid", "--data-root", str(d / "camvid"), "--tiny", "--max-epochs", "1",
            "--batch-size", "4", "--workdir", str(d / "fcn_disk"), *CPU, "--devices", "2"]}),
        ("u8_train", "cli_lines", {"module": "train_fcn8", "argv": [
            "--packed", str(d / "packed"), "--wire", "u8", "--tiny", "--max-epochs", "1", "--batch-size", "4",
            "--workdir", str(d / "fcn_u8"), *CPU, "--devices", "2"]}),
        ("pp_general", "cli_lines", {"module": "iterative_inference", "argv": [*GENERAL, *CPU, "--pp", "--devices", "2"]}),
        ("pp_u8", "cli_lines", {"module": "iterative_inference", "argv": [
            "--packed", str(d / "packed"), "--wire", "u8", "--tiny", "--num-steps", "2", "--engine", "half",
            "--dae-stem-pool", "1", "--dae-depth", "3", "--dae-widths", "8", "16", "32", "--batch-size", "4",
            *CPU, "--pp", "--devices", "2"]}),
    ]
    three = [("pp3", "cli_lines", {"module": "iterative_inference",
                                   "argv": [*HALF, *weights, *CPU, "--pp", "--pp-stages", "3", "--devices", "3"]})]
    return two, three


@pytest.fixture(scope="module")
def runs(inputs):
    """Every run's printed lines: the ranks' runs in a thread, the runs
    through ``main`` (whose rank 0 prints into this process) here."""
    d, weights = inputs
    two, three = rank_cases(d, weights)

    def in_ranks():
        got = launch(ranks.run_cases, two, mesh=MeshSpec(("data",), (2,)), device="cpu")
        got.update(launch(ranks.run_cases, three, mesh=MeshSpec(("data",), (3,)), device="cpu"))
        return got

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(in_ranks)
        out = {
            "fcn8": cli_lines(tfcn_cli.main, ["--synthetic", "--tiny", "--max-epochs", "1", "--batch-size", "8",
                                              "--num-train-batches", "2", "--num-val-batches", "1",
                                              "--workdir", str(d / "fcn"), *CPU, "--devices", "2"]),
            "dae": cli_lines(tdae_cli.main, ["--synthetic", "--tiny", "--max-epochs", "1", "--batch-size", "8",
                                             "--num-train-batches", "2", "--num-val-batches", "1",
                                             "--dae-stem-pool", "1", "--dae-depth", "3", "--dae-widths", "8", "16",
                                             "32", "--workdir", str(d / "dae"), *CPU, "--devices", "2"]),
            "pp": cli_lines(tcli.main, [*HALF, *weights, *CPU, "--pp", "--devices", "4", "--pp-microbatches", "2"]),
            "seq_half": cli_lines(tcli.main, [*HALF, *weights, *CPU]),
            "seq_general": cli_lines(tcli.main, [*GENERAL, *CPU]),
        }
        jcli = jax_script("iterative_inference")
        served = ["--synthetic", "--tiny", "--num-steps", "1", "--batch-size", "8", "--num-batches", "1",
                  "--engine", "half", *weights]
        out["jax_served"] = cli_lines(jcli.main, [*served, "--devices", "2"])
        out["jax_pp"] = cli_lines(jcli.main, [*HALF, *weights, "--pp", "--devices", "4", "--pp-microbatches", "2"])
        out.update({k: v["lines"] for k, v in port.result().items()})
    return out, d


def test_train_fcn8_cli_dp(runs):
    out, d = runs
    assert out["fcn8"][0] == "[train_fcn8] data-parallel over 2 devices"
    assert out["fcn8"][-1].startswith("done: best val mIoU")
    assert (d / "fcn" / "best_fcn8.npz").exists()
    assert len((d / "fcn" / "metrics.jsonl").read_text().splitlines()) == 1  # rank 0 alone logs


def test_train_dae_cli_dp_and_its_npz_serves(runs):
    out, d = runs
    assert out["dae"][0] == "[train_dae] data-parallel over 2 devices"
    assert out["dae"][1] == "[train_dae] corruption_impl=torch (auto-selected for this platform)"
    npz = d / "dae" / "best_dae.npz"
    assert npz.exists()
    from iterative_inference_segm_tpu_torch.inference.predictor import Predictor

    p = Predictor.from_npz(d / "fcn" / "best_fcn8.npz", npz, device="cpu", fc_channels=64, dae_depth=3,
                           dae_stem_pool=1, dae_widths=(8, 16, 32), engine="half", batch_size=2, num_steps=1,
                           compute_dtype=torch.float32)
    assert p.predict(np.zeros((1, 96, 128, 3), np.float32)).shape == (1, 96, 128)


def test_sharded_inference_prints_the_jax_cli_lines(runs):
    out, _ = runs
    assert out["served"][0] == "eval batches sharded over 2 devices"
    assert out["served"] == out["jax_served"]


def test_sharded_inference_pads_a_short_last_batch(runs):
    out, _ = runs
    assert out["disk_served"][0] == "eval batches sharded over 2 devices"
    assert "per-class IoU (k=0 -> k=K):" in out["disk_served"]


@pytest.mark.parametrize("case", ["disk_train", "u8_train"])
def test_dp_training_pads_a_short_last_batch_on_both_wires(runs, case):
    out, d = runs
    assert out[case][0] == "[train_fcn8] data-parallel over 2 devices"
    assert (d / ("fcn_disk" if case == "disk_train" else "fcn_u8") / "best_fcn8.npz").exists()


def test_pp_dp_serving_matches_sequential_and_the_jax_cli(runs):
    out, _ = runs
    assert out["pp"][0] == "pipeline-parallel serving: 2 stages x 2-wide DP, 2 microbatches in flight"
    assert metrics(out["pp"]) and metrics(out["pp"]) == metrics(out["seq_half"])
    assert out["pp"] == out["jax_pp"]


def test_pp_general_engine_matches_sequential(runs):
    out, _ = runs
    assert out["pp_general"][0] == "pipeline-parallel serving: 2 stages, 2 microbatches in flight"
    assert metrics(out["pp_general"]) and metrics(out["pp_general"]) == metrics(out["seq_general"])


def test_pp_three_stage_matches_sequential(runs):
    out, _ = runs
    assert out["pp3"][0] == "pipeline-parallel serving: 3 stages, 2 microbatches in flight"
    assert metrics(out["pp3"]) == metrics(out["seq_half"])


def test_pp_on_the_u8_wire(runs):
    out, _ = runs
    assert out["pp_u8"][0] == "pipeline-parallel serving: 2 stages, 2 microbatches in flight"
    assert "per-class IoU (k=0 -> k=K):" in out["pp_u8"]


@pytest.mark.parametrize("flags,err,match", [
    (["--devices", "3", "--batch-size", "4"], ValueError, "batch size 4 not divisible by --devices 3"),
    (["--devices", "9"], ValueError, "--devices 9 requested but only 8 visible"),
    (["--pp", "--pp-microbatches", "0"], SystemExit, "--pp-microbatches must be >= 1; got 0"),
    (["--pp", "--devices", "3"], SystemExit, "--pp with 2 stages needs a device count divisible by 2; got 3"),
    (["--pp", "--devices", "10"], SystemExit, "--pp over 10 devices but only 8 visible"),
    (["--pp", "--devices", "4", "--batch-size", "4", "--pp-microbatches", "4"], SystemExit,
     "--batch-size 4 not divisible by --pp-microbatches 4 x DP width 2"),
])
def test_parallel_flags_refuse_what_the_jax_cli_refuses(flags, err, match):
    with pytest.raises(err) as e:
        tcli.main(["--synthetic", "--tiny", *CPU, *flags])
    assert str(e.value) == match


@pytest.mark.parametrize("main", [tdae_cli.main, tfcn_cli.main], ids=["train_dae", "train_fcn8"])
def test_trainer_devices_flag_checks_the_batch(main):
    with pytest.raises(ValueError, match="batch size 10 not divisible by --devices 3"):
        main(["--synthetic", "--tiny", *CPU, "--devices", "3"])
