"""The seams of the data flags of the port's CLI twins, each run
beside the JAX CLI at a tiny size (96x128 frames, fc 64, C=11, f32, the
same JAX-written weights): ``iterative_inference`` with ``--packed`` on both
wires (the u8 wire's val normalized on the device under ``--search``),
and ``--data-root`` print the JAX CLI's lines (mIoU and accuracy to 4
decimals); ``--dump-dir`` with ``--dump-trajectory`` writes the JAX CLI's
files. Then one short ``train_dae`` twin run from a packed file on the u8
wire. The weight flags' seams are in ``test_torch_cli_weights.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from PIL import Image  # noqa: E402

from iterative_inference_segm_tpu_torch.scripts import iterative_inference as tcli  # noqa: E402
from iterative_inference_segm_tpu_torch.scripts import pack_dataset as tpack  # noqa: E402
from iterative_inference_segm_tpu_torch.scripts import train_dae as tdae_cli  # noqa: E402
from iterative_inference_segm_tpu_torch.utils import checkpoint as tckpt  # noqa: E402
from torch_port_helpers import cli_lines, jax_script, write_camvid_tree, write_cli_npz  # noqa: E402


@pytest.fixture(scope="module")
def jcli():
    return jax_script("iterative_inference")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Weights (FCN-8 fc 64 + DAE depth 4), a packed synthetic CamVid at
    96x128 (4 train, 2 val, 3 test frames) and a CamVid tree of PNGs."""
    d = tmp_path_factory.mktemp("cli_data")
    weights = write_cli_npz(d, 0, 4, "full")
    tpack.main(["--synthetic", "--out", str(d / "packed"), "--num-train", "4", "--num-val", "2", "--num-test", "3",
                "--height", "96", "--width", "128", "--seed", "2"])
    write_camvid_tree(d / "camvid", (96, 128), {"val": 2, "test": 3})
    return d, weights


CASES = {
    "packed_f32": ["--packed", "{d}/packed"],
    "packed_u8": ["--packed", "{d}/packed", "--wire", "u8"],
    "packed_u8_search": ["--packed", "{d}/packed", "--wire", "u8", "--search", "--k-max", "2",
                         "--eps-grid", "0.1", "0.3"],
    "data_root": ["--data-root", "{d}/camvid", "--search", "--k-max", "2", "--eps-grid", "0.1", "0.3"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_data_flags_print_what_the_jax_cli_prints(jcli, inputs, case):
    d, weights = inputs
    flags = [f.format(d=d) for f in CASES[case]]
    argv = ["--tiny", "--num-batches", "1", "--batch-size", "2", *weights, *flags]
    want = cli_lines(jcli.main, argv)
    got = cli_lines(tcli.main, [*argv, "--device", "cpu"])
    n = 3 if "--search" in flags else 2
    assert got[:n] == want[:n]
    assert len(got) == len(want) == n + 1 + 11
    assert got[n - 2].startswith("step 0 (FCN-8 baseline): mIoU ")


def test_cli_dump_dir_writes_the_jax_cli_files(jcli, inputs, tmp_path):
    d, weights = inputs
    argv = ["--tiny", "--batch-size", "2", *weights, "--packed", str(d / "packed"), "--wire", "u8",
            "--num-steps", "2", "--dump-trajectory"]
    want = cli_lines(jcli.main, [*argv, "--dump-dir", str(tmp_path / "j")])
    got = cli_lines(tcli.main, [*argv, "--dump-dir", str(tmp_path / "t"), "--device", "cpu"])
    assert got[:2] == want[:2]
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == names
    # 3 test frames in batches of 2 (the tail padded by the runtime), k0 and
    # k2 each; the first batch's trajectory, steps 0..2
    assert len(names) == 2 * 2 * 2 + 2 * 3 and "traj_01_step02.png" in names and "b001_01_k2.png" in names
    for name in names:
        a, b = (np.asarray(Image.open(tmp_path / s / name)) for s in ("t", "j"))
        assert a.shape == b.shape == (96, 128, 3) and (a == b).all(-1).mean() >= 0.999, name


def test_train_dae_twin_trains_from_a_packed_file_on_the_u8_wire(inputs, tmp_path):
    d, _ = inputs
    lines = cli_lines(tdae_cli.main, [
        "--tiny", "--device", "cpu", "--packed", str(d / "packed"), "--wire", "u8", "--batch-size", "2",
        "--max-epochs", "2", "--dae-depth", "3", "--dae-stem-pool", "1", "--dae-widths", "8", "16", "32",
        "--workdir", str(tmp_path / "wd"),
    ])
    epochs = [ln for ln in lines if ln.startswith("epoch ")]
    assert [ln.split(":")[0] for ln in epochs] == ["epoch 0", "epoch 1"]
    assert lines[-1].startswith("done: best val mIoU")
    losses = [float(ln.split("train_loss=")[1].split()[0]) for ln in epochs]
    assert np.isfinite(losses).all()
    assert tckpt.latest_step(tmp_path / "wd" / "ckpt") == 1
