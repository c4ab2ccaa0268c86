"""The port's bench twin (``tools/bench.py``) and ``entry()`` against the
JAX package's ``bench.py`` and ``__graft_entry__.entry()`` on the CPU.

- The ``metric`` string of each configuration equals JAX's ``bench.py``
  ``main`` letter for letter, run in-process with ``--no-history`` at a tiny
  size (48x64, fc 16, DAE widths 8..64, batch 2, one iteration); the key set
  is JAX's less ``frontier`` (a table of TPU readings) plus ``device``.
- ``build_pipeline``'s scalar ``sum(argmax(y_K))`` equals JAX's pipeline on
  the same carried-over weights in f32 (half, general and fused engines).
- ``--engine fused`` runs with a 'sep' tail and is refused with a 'full'
  one, in JAX's words; ``--check`` exits 1 under this card's floor;
  the history goes to the port's own file, and
  the JAX runs leave ``BENCH_HISTORY.jsonl`` and ``TRAIN_HISTORY.jsonl``
  byte for byte as they were.
- ``entry()`` returns the JAX entry's param shapes and input, and its
  forward JAX's output shape and dtype.
"""

import contextlib
import io
import json
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from iterative_inference_segm_tpu.data.config_datasets import CAMVID as JCAMVID  # noqa: E402
from iterative_inference_segm_tpu.data.synthetic import synthetic_batches as j_synthetic  # noqa: E402
from iterative_inference_segm_tpu.inference import iterative as jit_  # noqa: E402
from iterative_inference_segm_tpu.inference.fused import flagship_forward_fn as j_flagship  # noqa: E402
from iterative_inference_segm_tpu.inference.fused import fused_refinement_scan as j_fused_scan  # noqa: E402
from iterative_inference_segm_tpu.models import dae as jdae  # noqa: E402
from iterative_inference_segm_tpu.models import fcn8 as jfcn8  # noqa: E402
from iterative_inference_segm_tpu_torch import entry as tentry  # noqa: E402
from iterative_inference_segm_tpu_torch.tools import bench as tbench  # noqa: E402
from iterative_inference_segm_tpu_torch.utils.jax_bridge import params_from_jax, params_to_jax  # noqa: E402

from torch_port_helpers import jax_params  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parents[1]
HISTORIES = [REPO / "BENCH_HISTORY.jsonl", REPO / "TRAIN_HISTORY.jsonl"]
TINY = ["--no-history", "--height", "48", "--width", "64", "--fc-channels", "16", "--batch", "2", "--iters", "1",
        "--warmup", "1", "--dae-widths", "8", "16", "32", "64"]
CONFIGS = {"default": [], "fast": ["--preset", "fast"], "steps0": ["--steps", "0"],
           "general_energy": ["--engine", "general", "--mode", "energy"],
           "general_mirror": ["--engine", "general", "--arch", "mirror"],
           "fused": ["--engine", "fused", "--dae-tail", "sep"]}


def jax_bench(argv):
    import bench as jbench

    saved = sys.argv
    sys.argv = ["bench.py", *argv]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = jbench.main()
    finally:
        sys.argv = saved
    return rc, json.loads(buf.getvalue().splitlines()[-1])


def port_bench(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tbench.main([*argv, "--device", "cpu"])
    return rc, json.loads(buf.getvalue().splitlines()[-1])


@pytest.fixture(scope="module")
def runs():
    before = [p.read_bytes() for p in HISTORIES]
    out = {name: (jax_bench(TINY + argv), port_bench(TINY + argv)) for name, argv in CONFIGS.items()}
    return out, before, [p.read_bytes() for p in HISTORIES]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_metric_string_and_keys_are_jax_benchs(runs, name):
    (jrc, jrec), (trc, trec) = runs[0][name]
    assert jrc == trc == 0
    assert trec["metric"] == jrec["metric"]
    assert set(trec) == (set(jrec) - {"frontier"}) | {"device"}
    assert trec["unit"] == "images/sec/chip" and trec["device"] == "cpu"
    assert abs(trec["vs_baseline"] - trec["value"] / 1000.0) <= 1e-4


def test_jax_runs_leave_the_jax_history_files_unchanged(runs):
    _, before, after = runs
    assert before == after


def test_history_goes_to_the_ports_own_file(tmp_path, monkeypatch):
    monkeypatch.setattr(tbench, "HISTORY", tmp_path / "chiprun_out" / "bench_history_torch.jsonl")
    argv = [a for a in TINY if a != "--no-history"] + ["--steps", "0"]
    _, rec = port_bench(argv)
    assert [json.loads(ln) for ln in tbench.HISTORY.read_text().splitlines()] == [rec]
    assert tbench.HISTORY.name != "BENCH_HISTORY.jsonl"


def test_check_exits_1_under_this_cards_floor(monkeypatch, capsys):
    """``--check`` holds vs_baseline to the floor of its configuration (the
    card's own; a CPU run is far under it) and exits 1 as bench.py's."""
    argv = TINY + ["--steps", "0", "--check"]
    assert (tbench.PERF_FLOOR, tbench.FAST_PERF_FLOOR) == (0.886, 1.487)
    assert port_bench(argv)[0] == 1
    assert "PERF GATE FAILED: vs_baseline" in capsys.readouterr().err
    monkeypatch.setattr(tbench, "PERF_FLOOR", 0.0)
    assert port_bench(argv)[0] == 0


@pytest.mark.parametrize("argv,match", [
    (["--engine", "fused"], "requires --dae-tail sep"),
    (["--engine", "fused", "--mode", "energy"], "not supported by the fused"),
    (["--arch", "mirror"], "requires --engine general"),
    (["--dae-stem-pool", "0"], "requires --dae-stem-pool >= 1"),
], ids=["fused", "fused_energy", "mirror_half", "half_stem0"])
def test_refusals_are_jax_benchs(argv, match):
    with pytest.raises(SystemExit, match=match):
        tbench.parse_args(argv)


def jax_pipeline(engine, jf, jd, x):
    """bench.py's pipelines at f32 (its code, on the given params)."""
    if engine == "half":
        fwd = j_flagship(num_steps=5, depth=3, compute_dtype=jnp.float32, state_dtype=jnp.float32,
                         encoder="pool", mode="score", fold_tail=True)
        y0, yk = jax.jit(fwd)(jf, jd, x)
    elif engine == "fused":
        @jax.jit
        def run(jf, jd, x):
            y0, h = jfcn8.fcn8_apply(jf, x, return_features=("pool4",), compute_dtype=jnp.float32,
                                     probs_dtype=jnp.float32)
            bh = jdae.precompute_bottleneck_h(jd, h, depth=3, stem_pool=1, in_hw=(x.shape[1] >> 1, x.shape[2] >> 1))
            core_fn = lambda yp: jdae.dae_core(jd, yp.astype(jnp.float32), bh[2], depth=3, stem_pool=1,  # noqa: E731
                                               bottleneck_h=bh, encoder="pool")
            return y0, j_fused_scan(jd, core_fn, y0, eps=0.1, num_steps=5, state_dtype=jnp.float32)

        y0, yk = run(jf, jd, x)
    else:
        @jax.jit
        def run(jf, jd, x):
            y0, h = jfcn8.fcn8_apply(jf, x, return_features=("pool4",), compute_dtype=jnp.float32,
                                     probs_dtype=jnp.float32)
            fn = lambda y: jdae.dae_apply(jd, y, h, depth=3, compute_dtype=jnp.float32,  # noqa: E731
                                          out_dtype=jnp.float32, encoder="pool")
            return y0, jit_.refinement_scan(fn, y0, eps=jnp.asarray(0.1, jnp.float32), num_steps=5, mode="score")

        y0, yk = run(jf, jd, x)
    return int(jnp.sum(jnp.argmax(yk, axis=-1), dtype=jnp.int32)), np.asarray(yk)


@pytest.mark.parametrize("engine", ["half", "general", "fused"])
def test_build_pipeline_matches_jax_on_carried_over_weights(engine):
    tail = "sep" if engine == "fused" else "full"
    jf, jd = jax_params(tail=tail)
    ((images, _),) = j_synthetic(cfg=JCAMVID, batch_size=2, num_batches=1, height=48, width=64, seed=0)
    want, want_yk = jax_pipeline(engine, jf, jd, jnp.asarray(images))
    args = tbench.parse_args(TINY + ["--dtype", "f32", "--engine", engine, "--dae-tail", tail, "--device", "cpu"])
    pipeline = tbench.build_pipeline(args)
    got = pipeline(params_from_jax(jf), params_from_jax(jd), torch.from_numpy(images))
    assert got.dtype == torch.int64 and got.dim() == 0
    assert int(got) == want
    assert np.abs(want_yk - want_yk.mean()).max() > 1e-3  # a non-trivial map


def test_entry_returns_the_jax_entrys_shapes():
    import __graft_entry__ as jentry

    jshapes = jax.eval_shape(lambda: jentry.entry()[1])
    forward, (fcn, dae, x) = tentry.entry("cpu")
    for tree, jtree in ((fcn, jshapes[0]), (dae, jshapes[1])):
        got = params_to_jax(tree)
        assert sorted(got) == sorted(jtree)
        for layer, leaves in jtree.items():
            assert {k: v.shape for k, v in got[layer].items()} == {k: tuple(v.shape) for k, v in leaves.items()}
    assert tuple(x.shape) == tuple(jshapes[2].shape) == (1, 360, 480, 3) and x.dtype == torch.float32
    small = torch.zeros((1, 48, 64, 3))
    y = forward(fcn, dae, small)
    jy = jax.eval_shape(lambda: jentry.entry()[0](*jentry.entry()[1][:2], jnp.zeros((1, 48, 64, 3))))
    assert tuple(y.shape) == tuple(jy.shape) == (1, 48, 64, 11)
    assert y.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
    assert torch.isfinite(y.float()).all()


def test_entry_cli_line_and_multichip_refusal(capsys, monkeypatch):
    """``multichip [N]`` is no longer refused: it runs ``dryrun_multichip(N)``
    (8 by default, as the JAX file's) on the device asked for and prints
    the JAX line (the dry run itself: ``tests/test_torch_spatial.py``)."""
    runs = []
    monkeypatch.setattr(tentry, "dryrun_multichip", lambda n, device: runs.append((n, device)))
    assert tentry.main(["multichip", "--device", "cpu"]) == 0
    assert tentry.main(["multichip", "3", "--device", "cpu"]) == 0
    assert runs == [(8, "cpu"), (3, "cpu")]
    assert capsys.readouterr().out.split("\n")[:2] == ["dryrun_multichip(8) OK", "dryrun_multichip(3) OK"]
    monkeypatch.setattr(tentry, "entry", lambda device: (lambda f, d, x: torch.zeros((1, 360, 480, 11),
                                                                                    dtype=torch.bfloat16), (0, 0, 0)))
    assert tentry.main(["--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip() == "entry() OK (1, 360, 480, 11) torch.bfloat16"


@pytest.mark.parametrize("accumulate", [True, False])
def test_chained_ms_sums_the_block_or_skips_the_sum(accumulate):
    """The one timer of the benches and ``chip_smoke.py``: the warm-up
    calls, then ``repeats`` blocks of ``iters``; the last block's results
    summed on the device, or not summed for a call whose result is no
    tensor (a forward's tuple)."""
    from iterative_inference_segm_tpu_torch.tools.timing import chained_ms

    calls = []

    def fn():
        calls.append(1)
        return torch.tensor(2.0) if accumulate else (None, "not a tensor")

    ms, acc = chained_ms(fn, 4, device="cpu", warmup=3, repeats=2, accumulate=accumulate)
    assert ms >= 0.0 and len(calls) == 3 + 2 * 4
    assert (acc.item() == 8.0) if accumulate else acc is None
