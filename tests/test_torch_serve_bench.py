"""The port's serving bench (``tools/serve_bench.py``) against the JAX
package's ``tools/serve_bench.py`` on the CPU.

- With ``--wire both`` its JSON line has JAX's keys plus ``device``. JAX's
  ``main`` runs in-process at a tiny size (batch 2, two batches, 48x64, one
  step) with its FCN-8 at fc 16 and its DAE at widths 8..32 (the keys are
  what is compared); the port's twin serves small params handed in.
- Its answers, the on-card scalar ``sum(argmax(y_K))`` of each batch, are
  equal across the wires (the u8 wire normalized by the pipeline, the f32
  wire by the native runtime) and equal the resident batch's.
- The packed file is removed, also when a stage raises.
"""

import contextlib
import io
import json
import pathlib
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402,F401

from iterative_inference_segm_tpu_torch.models.dae import init_dae  # noqa: E402
from iterative_inference_segm_tpu_torch.models.fcn8 import init_fcn8  # noqa: E402
from iterative_inference_segm_tpu_torch.tools import serve_bench as tsb  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = ["--batch", "2", "--num-batches", "2", "--epochs", "1", "--height", "48", "--width", "64", "--steps", "1",
        "--n-threads", "1", "--wire", "both"]


def small_params():
    fcn = init_fcn8(torch.Generator().manual_seed(0), n_classes=11, fc_channels=16)
    dae = init_dae(torch.Generator().manual_seed(1), n_classes=11, h_specs={"pool4": 512}, depth=3, stem_pool=1,
                   widths=(8, 16, 32))
    return fcn, dae


def jax_lines(monkeypatch):
    from iterative_inference_segm_tpu import models as jmodels
    from iterative_inference_segm_tpu.models import dae as jdae

    sys.path.insert(0, str(REPO / "tools"))
    try:
        import serve_bench as jsb
    finally:
        sys.path.pop(0)
    init_fcn8_j, init_dae_j = jmodels.init_fcn8, jdae.init_dae
    monkeypatch.setattr(jmodels, "init_fcn8", lambda key, **kw: init_fcn8_j(key, **{**kw, "fc_channels": 16}))
    monkeypatch.setattr(jdae, "init_dae", lambda key, **kw: init_dae_j(key, **{**kw, "widths": (8, 16, 32)}))
    saved = sys.argv
    sys.argv = ["serve_bench.py", *TINY]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            assert jsb.main() == 0
    finally:
        sys.argv = saved
    return buf.getvalue().splitlines()


@pytest.fixture(scope="module")
def runs():
    with pytest.MonkeyPatch.context() as mp:
        want = jax_lines(mp)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tsb.main([*TINY, "--device", "cpu"], params=small_params()) == 0
    return want, buf.getvalue().splitlines()


def test_json_keys_are_jax_serve_benchs(runs):
    want, got = runs
    jrec, trec = json.loads(want[-1]), json.loads(got[-1])
    assert set(trec) == set(jrec) | {"device"} and trec["device"] == "cpu"
    assert list(trec)[:-1] == list(jrec)
    assert all(v > 0 for k, v in trec.items() if k != "device")


def test_progress_lines_follow_jax(runs):
    """One line a stage, in JAX's order, each naming its stage as JAX's."""
    want, got = runs
    stage = lambda ln: ln.split(":")[0].split(" (")[0]  # noqa: E731
    assert [stage(ln) for ln in got[:-1]] == [stage(ln) for ln in want[:-1]]


def test_answers_agree_across_wires():
    args = tsb.parse_args([*TINY, "--device", "cpu"])
    results, sums = tsb.run(args, *small_params(), torch.device("cpu"))
    assert sorted(results) == sorted(["compute", "producer_f32", "transfer_f32", "e2e_f32", "producer_u8",
                                      "transfer_u8", "e2e_u8"])
    assert len(sums["e2e_f32"]) == args.num_batches
    assert sums["e2e_u8"] == sums["e2e_f32"] and sums["compute"] == sums["e2e_f32"][0] > 0


def test_packed_file_is_removed_when_a_stage_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(tsb.tempfile, "tempdir", str(tmp_path))

    def boom(*a, **k):
        raise RuntimeError("a stage failed")

    monkeypatch.setattr(tsb, "_stages", boom)
    with pytest.raises(RuntimeError, match="a stage failed"):
        tsb.run(tsb.parse_args([*TINY, "--device", "cpu"]), *small_params(), torch.device("cpu"))
    assert list(tmp_path.iterdir()) == []
