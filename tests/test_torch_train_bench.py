"""The port's training bench (``tools/train_bench.py``) against the JAX
package's ``tools/train_bench.py`` on the CPU.

- Its ``metric`` strings equal JAX's for both cells, both augment settings,
  ``--remat`` and ``--donate`` (JAX's ``main`` runs its own cells at a tiny
  width, fc 16 and DAE widths 8..32, with each step's compute stubbed out:
  the strings are what is compared, and a JAX train step at this size
  would take seconds to compile); the port's twin trains small params for
  one iteration at 48x64, crop 32, with K1's plain version.
- Its FLOPs an image are held against JAX's ``--_flops-probe`` (XLA's cost
  analysis of the same step, compiled for the CPU) at crop 32, full width.
  FCN-8: the port counts 1.0895x XLA's (held within 1.0..1.15): XLA
  leaves out the taps of a convolution that fall in its zero padding, and
  at crop 32 the SAME borders of maps of 1..32 pixels hold many (fc6's 7x7
  window on the 1x1 pool5 map reads one tap of 49);
  ``FlopCounterMode`` counts every tap. XLA's count also holds the
  elementwise work and the optimizer, which the port's does not.
  DAE: the port counts 1.1836x XLA's (held within 1.0..1.25): in the gt
  regime the frozen FCN-8's probabilities are never read, so the step runs
  the FCN only through pool4, the DAE's tap, as XLA drops the rest from
  the JAX step; the gap is FCN-8's, the padded taps of the small maps.
- The count on the meta device equals the count on the CPU.
- The history goes to the port's own file; the JAX runs leave
  ``TRAIN_HISTORY.jsonl`` byte for byte as it was.
"""

import contextlib
import io
import json
import pathlib
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from iterative_inference_segm_tpu_torch.models.dae import init_dae  # noqa: E402
from iterative_inference_segm_tpu_torch.models.fcn8 import init_fcn8  # noqa: E402
from iterative_inference_segm_tpu_torch.tools import train_bench as ttb  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
TRAIN_HISTORY = REPO / "TRAIN_HISTORY.jsonl"
TINY = ["--batches", "2", "--crops", "32", "--height", "48", "--width", "64", "--iters", "1", "--no-history"]
VARIANTS = {"both": [], "remat": ["--remat"], "on": ["--augment", "on"], "off": ["--augment", "off", "--remat"],
            "donate": ["--donate"]}
FCN_RATIO = (1.0, 1.15)  # measured 1.0895
DAE_RATIO = (1.0, 1.25)  # measured 1.1836


def jax_tool(argv, monkeypatch, *, stub_steps):
    """JAX's ``tools/train_bench.py`` ``main`` in-process; its stdout lines."""
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import train_bench as jtb
    finally:
        sys.path.pop(0)
    if stub_steps:
        from iterative_inference_segm_tpu.models import dae as jdae
        from iterative_inference_segm_tpu import models as jmodels

        init_fcn8_j, init_dae_j, cells_j = jmodels.init_fcn8, jdae.init_dae, jtb.make_cells
        monkeypatch.setattr(jmodels, "init_fcn8", lambda key, **kw: init_fcn8_j(key, **{**kw, "fc_channels": 16}))
        monkeypatch.setattr(jdae, "init_dae", lambda key, **kw: init_dae_j(key, **{**kw, "widths": (8, 16, 32)}))

        def stub(p, o, *rest):
            return p, o, jnp.float32(0.0)

        monkeypatch.setattr(jtb, "make_cells", lambda *a: [(label, stub, state, extra)
                                                            for label, _, state, extra in cells_j(*a)])
    saved = sys.argv
    sys.argv = ["train_bench.py", *argv]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            jtb.main()
    finally:
        sys.argv = saved
    return buf.getvalue().splitlines()


def small_params():
    fcn = init_fcn8(torch.Generator().manual_seed(0), n_classes=11, fc_channels=16)
    dae = init_dae(torch.Generator().manual_seed(1), n_classes=11, h_specs={"pool4": 512}, depth=3, stem_pool=1,
                   widths=(8, 16, 32))
    return fcn, dae


def port_tool(argv, params):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = ttb.main([*argv, "--device", "cpu"], params=params)
    assert rc == 0
    return [json.loads(ln) for ln in buf.getvalue().splitlines() if ln.startswith("{")]


@pytest.fixture(scope="module")
def runs():
    before = TRAIN_HISTORY.read_bytes()
    with pytest.MonkeyPatch.context() as mp:
        jax_lines = {k: jax_tool(TINY + ["--no-flops", *v], mp, stub_steps=True) for k, v in VARIANTS.items()}
    jax_flops = jax_tool(["--_flops-probe", "--crops", "32", "--augment", "off", "--height", "48", "--width", "64"],
                         None, stub_steps=False)
    params = small_params()
    port = {k: port_tool(TINY + v, params) for k, v in VARIANTS.items()}
    return {"jax": jax_lines, "jax_flops": jax_flops, "port": port, "before": before,
            "after": TRAIN_HISTORY.read_bytes()}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_metric_strings_are_jax_train_benchs(runs, variant):
    want = [json.loads(ln) for ln in runs["jax"][variant] if ln.startswith("{")]
    got = runs["port"][variant]
    assert [r["metric"] for r in got] == [r["metric"] for r in want] and got
    for r in got:
        assert r["unit"] == "images/sec/chip" and r["value"] > 0 and r["device"] == "cpu"
        # one rate, printed twice: value rounded to 2 decimals, ms_per_img to 4
        rate = 1e3 / r["ms_per_img"]
        assert abs(r["value"] - rate) <= 0.005 + 5e-5 * rate / r["ms_per_img"] + 1e-9
        assert r["gflops_per_img"] > 0 and "mfu_pct" in r and "mxu_pct" not in r


def test_flops_per_image_against_xla_cost_analysis(runs):
    line = next(ln for ln in runs["jax_flops"] if ln.startswith("FLOPS_JSON "))
    want = {k: v / ttb.FLOPS_PROBE_BATCH for k, v in json.loads(line[len("FLOPS_JSON "):]).items()}
    got = ttb.flops_per_image(ttb.parse_args(["--crops", "32", "--augment", "off", "--height", "48", "--width", "64"]))
    assert sorted(got) == sorted(want) == ["DAE(stem1,d3)|32|aug=0", "FCN-8|32|aug=0"]
    fcn = got["FCN-8|32|aug=0"] / want["FCN-8|32|aug=0"]
    dae = got["DAE(stem1,d3)|32|aug=0"] / want["DAE(stem1,d3)|32|aug=0"]
    assert FCN_RATIO[0] <= fcn <= FCN_RATIO[1], fcn
    assert DAE_RATIO[0] <= dae <= DAE_RATIO[1], dae


def test_meta_count_equals_the_cpu_count():
    args = ttb.parse_args(["--crops", "32", "--augment", "on", "--remat", "--height", "48", "--width", "64"])
    params = small_params()
    on_cpu = ttb.flops_per_image(args, device="cpu", params=params)
    assert ttb.flops_per_image(args, params=params) == on_cpu
    # remat recomputes the forward in the backward: it counts more
    assert all(v > ttb.flops_per_image(ttb.parse_args(["--crops", "32", "--augment", "on", "--height", "48",
                                                       "--width", "64"]), params=params)[k] for k, v in on_cpu.items())


def test_history_goes_to_the_ports_own_file(runs, tmp_path, monkeypatch):
    assert runs["before"] == runs["after"]
    monkeypatch.setattr(ttb, "HISTORY", tmp_path / "chiprun_out" / "train_history_torch.jsonl")
    recs = port_tool([a for a in TINY if a != "--no-history"] + ["--donate", "--no-flops"], small_params())
    assert [json.loads(ln) for ln in ttb.HISTORY.read_text().splitlines()] == recs
    assert len(recs) == 1 and recs[0]["metric"].endswith(", donate)")


def test_oom_is_recorded_as_jax_does(monkeypatch, capsys):
    def oom(*a, **k):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")

    monkeypatch.setattr(ttb, "make_cells", oom)
    assert ttb.main(TINY + ["--no-flops", "--device", "cpu"]) == 0
    recs = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["metric"] for r in recs] == ["train OOM (crop 32, bf16, batch=2, augment=True, remat=False)",
                                           "train OOM (crop 32, bf16, batch=2, augment=False, remat=False)"]
    assert all(r["oom"] and r["value"] is None for r in recs)
