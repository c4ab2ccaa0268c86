"""The port's ``train_fcn8`` and ``demo_synthetic`` CLI twins and the
``seed_replication`` tool at a tiny size on the CPU, and each flag they
refuse, as cases of one test. The FCN twin writes the JAX trainer's
workdir (``metrics.jsonl``, ``best_fcn8.npz`` with its stamp, ``ckpt/``)
and starts from a JAX-written ``--load-npz``; the demo prints the JAX demo's
``--json`` keys, on both engines and with each score network.
"""

import contextlib
import io
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from iterative_inference_segm_tpu.models import fcn8 as jfcn8  # noqa: E402
from iterative_inference_segm_tpu.utils import checkpoint as jckpt  # noqa: E402
from iterative_inference_segm_tpu_torch.scripts import demo_synthetic as demo  # noqa: E402
from iterative_inference_segm_tpu_torch.scripts import pack_dataset as pack  # noqa: E402
from iterative_inference_segm_tpu_torch.scripts import train_fcn8 as fcn_cli  # noqa: E402
from iterative_inference_segm_tpu_torch.tools import seed_replication as seeds  # noqa: E402
from iterative_inference_segm_tpu_torch.utils import checkpoint as tckpt  # noqa: E402
from torch_port_helpers import lasagne_checkpoint, lasagne_positional, write_camvid_tree  # noqa: E402

TINY_DEMO = ["--height", "48", "--width", "64", "--fc-channels", "16", "--batch-size", "2",
             "--train-batches", "2", "--epochs-fcn", "1", "--epochs-dae", "1", "--k-max", "2",
             "--eps-grid", "0.1", "0.5", "--dae-widths", "8", "16", "32", "64", "--device", "cpu"]
TINY_FCN = ["--synthetic", "--tiny", "--device", "cpu", "--batch-size", "2", "--num-train-batches", "2",
            "--num-val-batches", "1"]
JSON_KEYS = {"test_miou_fcn", "test_miou_refined", "delta_miou", "best_eps", "best_k", "engine", "mode",
             "arch", "dae_encoder"}

CASES = {
    # runs
    "fcn8_tiny": ("fcn8", ["--max-epochs", "2"], None),
    "fcn8_load_npz": ("fcn8", ["--max-epochs", "1", "--bf16"], None),
    "demo_general": ("demo", ["--json"], None),
    "demo_half_gt": ("demo", ["--json", "--engine", "half", "--dae-stem-pool", "1", "--dae-depth", "3",
                              "--corruption", "gt", "--sigma", "0.5"], None),
    "demo_mirror_energy": ("demo", ["--json", "--arch", "mirror", "--dae-tied", "--mode", "energy"], None),
    "demo_contextmod_bf16": ("demo", ["--json", "--arch", "contextmod", "--bf16"], None),
    "seed_replication": ("seeds", [], None),
    # the data and utils flags (refused until items 8 and 10 were ported);
    # {name} is a file or directory the test writes
    "fcn8_packed": ("fcn8", ["--max-epochs", "1", "--packed", "{packed}"], None),
    "fcn8_data_root": ("fcn8", ["--max-epochs", "1", "--data-root", "{root}"], None),
    "fcn8_profile_dir": ("fcn8", ["--max-epochs", "1", "--profile-dir", "{trace}"], None),
    "fcn8_reference_npz": ("fcn8", ["--max-epochs", "1", "--load-reference-npz", "{ref}"], None),
    # refusals: --wire u8 without --packed gets the JAX CLI's refusal
    # (--devices runs: test_torch_cli_parallel.py)
    "fcn8_wire": ("fcn8", ["--wire", "u8"], "--wire u8 requires --packed"),
    # and the JAX demo's own validity checks
    "demo_half_no_stem": ("demo", ["--engine", "half"], "--engine half requires --dae-stem-pool >= 1"),
    "demo_half_mirror": ("demo", ["--engine", "half", "--dae-stem-pool", "1", "--arch", "mirror"],
                         "general engine only"),
}


def _stdout(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert fn(argv) == 0
    return buf.getvalue().splitlines()


def _fcn8_inputs(case, tmp):
    """The files a case's flags name, at the tiny size (96x128, fc 64)."""
    if case == "fcn8_packed":
        pack.main(["--synthetic", "--out", str(tmp / "packed"), "--num-train", "4", "--num-val", "2",
                   "--num-test", "1", "--height", "96", "--width", "128"])
    elif case == "fcn8_data_root":
        write_camvid_tree(tmp / "root", (96, 128), {"train": 4, "val": 2})
    elif case == "fcn8_reference_npz":  # a reference-era positional checkpoint of the tiny FCN-8
        jparams = jfcn8.init_fcn8(jax.random.PRNGKey(0), n_classes=11, fc_channels=64)
        np.savez(tmp / "ref.npz", *lasagne_positional(lasagne_checkpoint(jparams, 3)))
    return {"packed": tmp / "packed", "root": tmp / "root", "trace": tmp / "trace", "ref": tmp / "ref.npz"}


@pytest.mark.parametrize("case", list(CASES))
def test_twin(case, tmp_path, capsys, monkeypatch):
    tool, flags, refusal = CASES[case]
    if refusal is not None:
        with pytest.raises(SystemExit) as e:
            (fcn_cli.main if tool == "fcn8" else demo.main)(flags)
        if tool == "fcn8":  # argparse: exit 2, the reason on stderr
            why = f"ROADMAP.md, Queue 1 {refusal}" if refusal.startswith("item") else refusal
            assert e.value.code == 2 and why in capsys.readouterr().err
        else:
            assert refusal in str(e.value.code)
        return
    if tool == "fcn8":
        inputs = _fcn8_inputs(case, tmp_path)
        flags = [f.format(**inputs) for f in flags]
        argv = [*TINY_FCN, "--workdir", str(tmp_path / "wd"), *flags]
        if case == "fcn8_data_root":  # --synthetic would take precedence, as in JAX
            argv.remove("--synthetic")
        if case == "fcn8_load_npz":  # a JAX-written FCN-8 at the tiny width
            jckpt.save_npz(tmp_path / "j.npz", jfcn8.init_fcn8(jax.random.PRNGKey(3), n_classes=11, fc_channels=64))
            argv += ["--load-npz", str(tmp_path / "j.npz")]
        lines = _stdout(fcn_cli.main, argv)
        n = int(flags[1])
        assert [ln.split(":")[0] for ln in lines[:n]] == [f"epoch {e}" for e in range(n)]
        assert lines[-1].startswith("done: best val mIoU")
        wd = tmp_path / "wd"
        assert len((wd / "metrics.jsonl").read_text().splitlines()) == n
        assert tckpt.latest_step(wd / "ckpt") == n - 1
        assert jckpt.read_npz_meta(wd / "best_fcn8.npz") == {"arch": "fcn8", "fc_channels": 64}
        jckpt.load_npz(wd / "best_fcn8.npz", jfcn8.init_fcn8(jax.random.PRNGKey(0), n_classes=11, fc_channels=64))
        if case == "fcn8_profile_dir":  # a Chrome trace of the run, with the train step's convolutions
            trace = (tmp_path / "trace" / "trace.json").read_text()
            assert '"traceEvents"' in trace and "conv" in trace
        return
    if tool == "seeds":
        monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the demo's process, as this one, on one thread
        hist = tmp_path / "h.jsonl"
        assert seeds.main(["--seeds", "1", "--configs", "flagship", "--history", str(hist),
                           "--demo-args", *TINY_DEMO]) == 0
        rows = [json.loads(ln) for ln in hist.read_text().splitlines()]
        assert len(rows) == 1 and rows[0]["config"] == "flagship" and rows[0]["seed"] == 1
        assert set(rows[0]) == JSON_KEYS | {"config", "seed", "wall_s"} and rows[0]["engine"] == "half"
        return
    lines = _stdout(demo.main, [*TINY_DEMO, *flags])
    assert lines[0] == "== training FCN-8 ==" and any(ln.startswith("== training ") for ln in lines[1:])
    d = json.loads(lines[-1])
    assert set(d) == JSON_KEYS
    assert 0.0 <= d["test_miou_fcn"] <= 1.0 and 0 <= d["best_k"] <= 2 and d["best_eps"] in (0.1, 0.5)
    assert d["delta_miou"] == pytest.approx(d["test_miou_refined"] - d["test_miou_fcn"], abs=2e-4)
    assert d["arch"] == ({"--arch": flags[flags.index("--arch") + 1]} if "--arch" in flags else {}).get(
        "--arch", "dae")
    assert d["engine"] == ("half" if "half" in flags else "general")
    assert np.isfinite([d["test_miou_refined"]]).all()
