"""The serving-side probe twins (``iterative_inference_segm_tpu_torch/tools/
{perf,pipeline,fcn_block,fwd_shape,half,core}_probe.py``) on the CPU.

Each probe's case functions, in f32 (no TF32 on the CPU), against the JAX
package's functions composed as the JAX probe composes them
(``tools/*_probe.py``), on the same numpy inputs, the weights crossing
through ``utils/jax_bridge`` (``tests/torch_port_helpers.py``: C = 5,
48x64, fc 16, DAE widths (8, 16, 32), the transposed-conv, tail and score
layers random): every map within 1e-5 of its largest entry, argmax labels
equal. Each row carries the JAX probe's label. Each tool refuses
``--device cuda`` without a card, and ``--device cpu`` prints one JSON line
a row (its sizes cut by patching the module's constants). The timings
themselves need the card (``chip_smoke.py`` phase 32).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from iterative_inference_segm_tpu.inference import fused as jfused  # noqa: E402
from iterative_inference_segm_tpu.inference.iterative import refinement_scan as j_scan  # noqa: E402
from iterative_inference_segm_tpu.models import dae as jdae  # noqa: E402
from iterative_inference_segm_tpu.models import fcn8 as jfcn8  # noqa: E402
from iterative_inference_segm_tpu.ops import conv as jconv  # noqa: E402
from iterative_inference_segm_tpu_torch.tools import (  # noqa: E402
    core_probe,
    fcn_block_probe,
    fwd_shape_probe,
    half_probe,
    perf_probe,
    pipeline_probe,
)
from iterative_inference_segm_tpu_torch.utils.jax_bridge import params_from_jax  # noqa: E402
from torch_port_helpers import C, HW, both, images, jax_params, probs  # noqa: E402

F32 = torch.float32


def close(got, want, name=""):
    """1e-5 relative to the largest value, as ``tests/test_torch_fcn8_train.
    py`` holds the FCN: rtol 1e-5, atol 1e-5 of ``want``'s largest entry."""
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape, name
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()),
                               err_msg=name)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module")
def models():
    """(JAX, port) FCN-8 and the stem_pool 1 / depth 3 DAE; the JAX
    ``init_dae`` defaults' DAE (depth 4, stem_pool 0) for perf_probe. The
    FCN's random score and transposed-conv layers at scale 0.1 keep its
    logits within ~6: at the helpers' 0.3 they reach ~20, and a softmax
    entry then moves 1.3e-5 for logits that agree to 2.8e-6 of their
    largest (the two packages' f32 convolutions sum in other orders)."""
    jf, jd = jax_params(stem_pool=1, depth=3, fcn_scale=0.1)
    _, jd0 = jax_params(stem_pool=0, depth=4)
    return both(jf), both(jd), both(jd0)


@pytest.fixture(scope="module")
def x():
    return images(2, seed=2)


def test_perf_probe_rows_match_jax(models, x):
    (jf, tf), _, (jd, td) = models
    y0j, hj = jfcn8.fcn8_apply(jf, jnp.asarray(x), return_features=("pool4",))
    y0, h = t(y0j), {"pool4": t(hj["pool4"])}
    rows = perf_probe.cases(tf, td, t(x), y0, h, steps=2, compute_dtype=F32)
    assert [r[0] for r in rows] == ["FCN-8 forward", "DAE forward (1 step)", "refinement scan (2 steps)",
                                    "full pipeline (FCN + 2 steps)"]

    @jax.jit
    def want(jf, jd, x, y0, h):
        def scan(y0_, h_):
            return j_scan(lambda y: jdae.dae_apply(jd, y, h_), y0_, eps=0.1, num_steps=2, mode="score")

        yf, hf = jfcn8.fcn8_apply(jf, x, return_features=("pool4",))
        return (jfcn8.fcn8_apply(jf, x)[0], jdae.dae_apply(jd, y0, h), scan(y0, h), scan(yf, hf))

    for (label, fn), w in zip(rows, want(jf, jd, jnp.asarray(x), y0j, {"pool4": hj["pool4"]})):
        (got,) = fn()
        close(got, w, label)


def test_pipeline_probe_rows_match_jax(models, x):
    (jf, tf), (jd, td), _ = models
    jd0 = jdae.init_dae(jax.random.PRNGKey(2), n_classes=C, h_specs={"pool3": 512}, depth=3, stem_pool=0,
                        widths=(8, 16, 32))
    rng = np.random.default_rng(3)
    y = probs((2, *HW, C), 4)
    s_half = rng.normal(size=(2, HW[0] // 2, HW[1] // 2, C)).astype(np.float32)
    yh = rng.normal(size=(2, HW[0] // 2, HW[1] // 2, C)).astype(np.float32)
    _, hj = jfcn8.fcn8_apply(jf, jnp.asarray(x), return_features=("pool4",))
    h = {"pool4": t(hj["pool4"])}

    @jax.jit
    def want(jf, jd, jd0, x, y, s_half, yh, h4):
        def steps(k):
            y0, h = jfcn8.fcn8_apply(jf, x, return_features=("pool4",))
            return j_scan(lambda yy: jdae.dae_apply(jd, yy, h, depth=3), y0, eps=0.1, num_steps=k, mode="score")

        y0, hp = jfcn8.fcn8_apply(jf, x, return_features=("pool4", "fc7"))
        u = jconv.conv_transpose2d(s_half, jd["up_stem1"]["w"], stride=2)[:, :HW[0], :HW[1], :]
        si = jconv.conv2d(y, jd["score_input"]["w"], jd["score_input"]["b"], padding="SAME")
        r = jax.nn.softmax(u + si, -1)
        e16 = jnp.bfloat16(0.1)
        return {
            "FCN backbone (to fc7)": (hp["fc7"],),
            "FCN fwd + decoder (y0 + pool4)": (y0, hp["pool4"]),
            "pipeline K=0": (steps(0),), "pipeline K=1": (steps(1),), "pipeline K=5": (steps(5),),
            "one dae_apply (f32 y in)": (jdae.dae_apply(jd, y, {"pool4": h4}, depth=3),),
            "tail: deconv+conv3x3+softmax+update (f32 y)": ((1 - 0.1) * y + 0.1 * r,),
            "tail all-bf16 state": ((1 - e16) * y + e16 * r,),
            # the kernel blends by (1 - eps) and eps in f32, eps = bf16(0.1), 1 - eps not rounded to bf16
            "tail all-bf16 state + refine_tail (K3)": ((1 - e16.astype(jnp.float32)) * y + e16 * r,),
            "stem avg_pool f32->bf16 @/1": (jconv.avg_pool(y, window=2, stride=2),),
            "mid-res enc+dec (stem0 dae on half-res)": (jdae.dae_apply(jd0, yh, {"pool3": h4}, depth=3),),
        }

    ref = want(jf, jd, jd0, jnp.asarray(x), jnp.asarray(y), jnp.asarray(s_half), jnp.asarray(yh), hj["pool4"])
    ref["stem avg_pool bf16 @/1"] = ref["stem avg_pool f32->bf16 @/1"]
    ref["tail: deconv+conv3x3 + refine_tail (K3) (f32 y)"] = ref["tail: deconv+conv3x3+softmax+update (f32 y)"]
    rows = pipeline_probe.pipeline_cases(tf, td, t(x), depth=3, compute_dtype=F32)
    rows += pipeline_probe.op_cases(td, params_from_jax(jd0), t(y), h, t(s_half), t(yh), depth=3, compute_dtype=F32)
    rows = [r for r in rows if "bf16 state" not in r[0]]  # at f32 the all-bf16 rows are the f32 ones, below
    rows += [(label, lambda fn=fn: (fn(),)) for label, fn in
             pipeline_probe.tail_maps(td, t(y), t(s_half), compute_dtype=F32, all_bf16=True)]
    assert sorted(r[0] for r in rows) == sorted(ref)
    for label, fn in rows:
        for got, w in zip(fn(), ref[label]):
            close(got, w, label)


def test_fcn_block_probe_rows_match_jax(models, x):
    (jf, tf), _, _ = models

    @jax.jit
    def want(jf, x):
        out, h, n = [], x, 0
        for item in jfcn8._VGG:
            n += 1
            h = jconv.max_pool(h) if item == "P" else jax.nn.relu(
                jconv.conv2d(h, jf[item[0]]["w"], jf[item[0]]["b"], padding="SAME"))
            if n in fcn_block_probe.MARKS:
                out.append(h)
        for name in ("fc6", "fc7"):
            h = jax.nn.relu(jconv.conv2d(h, jf[name]["w"], jf[name]["b"], padding="SAME"))
        return out + [h]

    rows = fcn_block_probe.cases(tf, t(x), compute_dtype=F32)
    assert [r[0] for r in rows] == [f"through block{i}" for i in range(1, 6)] + ["through fc7"]
    for (label, fn), w in zip(rows, want(jf, jnp.asarray(x))):
        close(fn()[0], w, label)


def test_fwd_shape_probe_rows_match_jax_and_count_flops(models):
    (jf, tf), _, _ = models
    rows = fwd_shape_probe.cases(tf, fwd_shape_probe.CPU_GRID, np.random.default_rng(0), compute_dtype=F32)
    rng = np.random.default_rng(0)
    for (label, fn, b, h, w, entry), jrow in zip(rows, fwd_shape_probe.CPU_GRID):
        xj = jnp.asarray(rng.random((b, h, w, 3), np.float32))
        want = jfcn8.fcn8_apply(jf, xj)[0] if entry == "apply" else jfcn8.fcn8_logits(jf, xj)
        assert label == jrow[0]
        close(fn()[0], want, label)
    assert [g[0] for g in fwd_shape_probe.GRID][1] == "apply 224x224 b64  (train shape)"  # JAX's two spaces
    f32, f64 = (fwd_shape_probe.flops_per_image("apply", tf, 2, s, s) for s in (32, 64))
    assert f32 > 0 and f64 == pytest.approx(4 * f32, rel=0.02)  # linear in pixels (fc6/fc7 on 1x1 -> 2x2)


def test_half_probe_rows_match_jax(models, x):
    (jf, tf), _, _ = models
    y0 = probs((2, *HW, C), 5)
    xh = probs((2, HW[0] // 2, HW[1] // 2, C), 6)
    _, hj = jfcn8.fcn8_apply(jf, jnp.asarray(x), return_features=("pool4",))
    for tail in ("full", "sep"):
        jd, td = both(jax_params(stem_pool=1, depth=3, tail=tail)[1])

        @jax.jit
        def want(jf, jd, x, xh, y0, h):
            e16 = jnp.bfloat16(0.1)
            in_hw = xh.shape[1:3]

            def core(yp, taps):
                bh = jdae.precompute_bottleneck_h(jd, taps, depth=3, stem_pool=1, in_hw=in_hw)
                return jdae.dae_core(jd, yp, bh[2], depth=3, stem_pool=1, bottleneck_h=bh)

            r = jax.nn.softmax(jfused.half_logits(jd, xh, core(xh, h)), -1)
            step = xh - e16 * (xh - r)
            r = jax.nn.softmax(jfused.full_logits(jd, core(xh, h), y0), -1)
            rect = jnp.argmax(y0 - e16 * (y0 - r), -1)
            y0p, hp = jfcn8.fcn8_apply(jf, x, return_features=("pool4",))
            bh = jdae.precompute_bottleneck_h(jd, hp, depth=3, stem_pool=1, in_hw=in_hw)
            yk = jfused.halfres_refinement_scan(
                jd, lambda yp: jdae.dae_core(jd, yp, bh[2], depth=3, stem_pool=1, bottleneck_h=bh), y0p, eps=0.1,
                num_steps=5, state_dtype=jnp.float32)
            return step, rect, jnp.argmax(yk, -1)

        ref = want(jf, jd, jnp.asarray(x), jnp.asarray(xh), jnp.asarray(y0), {"pool4": hj["pool4"]})
        rows = half_probe.cases(tail, tf, td, t(x), t(xh), t(y0), {"pool4": t(hj["pool4"])}, depth=3,
                                compute_dtype=F32)
        assert [r[0] for r in rows] == [f"{tail}: one half-res step", f"{tail}: rectification (core+tail+argmax)",
                                        f"{tail}: FULL pipeline K=5"]
        close(rows[0][1]()[0], ref[0], rows[0][0])
        for (label, fn), w in zip(rows[1:], ref[1:]):
            np.testing.assert_array_equal(fn()[0].numpy(), np.asarray(w), err_msg=label)
    assert [c[0] for c in half_probe.CONFIGS] == ["flagship d3 (32,64,128)", "lean d3 (24,48,96)",
                                                  "lean d3 (16,32,64)", "flagship sep tail"]


def _jax_core_rows(p, x, hb):
    """The JAX probe's five ``dae_core`` rows (``tools/core_probe.py``),
    the bottleneck's encoder inputs its first ``widths[-1]`` channels."""
    cw = hb.shape[-1]

    def bott(h):
        q = p["bottleneck"]
        return jax.nn.relu(jconv.conv2d(h, q["w"][:, :, :cw], q["b"], padding="SAME")
                           + jconv.crop_to(hb, h.shape[1], h.shape[2]))

    def enc(strided):
        skips, h = [], x
        for i in range(3):
            q = p[f"enc{i + 1}"]
            h = jax.nn.relu(jconv.conv2d(h, q["w"], q["b"], stride=2 if strided else 1, padding="SAME"))
            skips.append(h)
            if not strided:
                h = jconv.max_pool(h, window=2, stride=2, ceil_mode=True)
        return bott(h), skips

    def sc(name, v):
        return jconv.conv2d(v, p[name]["w"], p[name]["b"], padding="SAME")

    h, skips = enc(False)
    s = sc("score_bottleneck", h)
    for i in reversed(range(3)):
        s = jconv.conv_transpose2d(s, p[f"up{i + 1}"]["w"], stride=2)
        skc = sc(f"score_enc{i + 1}", skips[i])
        s = jconv.crop_to(s, skc.shape[1], skc.shape[2]) + skc
    full = sc("out", s)
    hs, sks = enc(True)
    s2 = sc("score_bottleneck", hs)
    for i in reversed(range(3)):
        skc = sc(f"score_enc{i + 1}", sks[i])
        s2 = jconv.crop_to(s2, skc.shape[1], skc.shape[2]) + skc
        s2 = jconv.conv_transpose2d(s2, p[f"up{i + 1}"]["w"], stride=2)
    return [(h,), (*(sc(f"score_enc{i + 1}", skips[i]) for i in range(3)), h), (full,), (hs,),
            (sc("out", jconv.crop_to(s2, x.shape[1], x.shape[2])),)]


def test_core_probe_rows_match_jax(models):
    _, (jd, td), _ = models
    xh = probs((2, HW[0] // 2, HW[1] // 2, C), 7)
    hb = np.random.default_rng(8).normal(size=(2, 3, 4, 32)).astype(np.float32)
    ref = jax.jit(_jax_core_rows)(jd, jnp.asarray(xh), jnp.asarray(hb))
    rows = core_probe.cases(td, t(xh), t(hb))
    assert [r[0] for r in rows] == [
        "encoder + bottleneck only", "encoder + skip 1x1 scores (no deconv chain)",
        "full core (enc + decoder chain + out)", "STRIDED encoder + bottleneck (candidate)",
        "STRIDED full core (candidate)"]
    for (label, fn), want in zip(rows, ref):
        got = fn()
        assert len(got) == len(want), label
        for g, w in zip(got, want):
            close(g, w, label)


SMALL = {  # module -> (constants patched to a CPU size, argv)
    perf_probe: ({"FC_CHANNELS": 16}, ["--batches", "2", "--height", "48", "--width", "64", "--steps", "1"]),
    pipeline_probe: ({"FC_CHANNELS": 16, "H": 32, "W": 64}, ["--batch", "1"]),
    fcn_block_probe: ({"FC_CHANNELS": 16, "B": 1, "H": 32, "W": 64}, []),
    fwd_shape_probe: ({"FC_CHANNELS": 16}, []),
    half_probe: ({"FC_CHANNELS": 16, "H": 32, "W": 64, "CONFIGS": half_probe.CONFIGS[2:]}, ["--batch", "1"]),
    core_probe: ({"B": 1, "HH": 16, "WH": 32}, []),
}


@pytest.mark.parametrize("module", list(SMALL), ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_tool_refuses_a_missing_card_and_prints_json_lines_on_the_cpu(module, monkeypatch, capsys):
    consts, argv = SMALL[module]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            module.main(argv)
    for k, v in consts.items():
        monkeypatch.setattr(module, k, v)
    assert module.main([*argv, "--device", "cpu", "--iters", "1", "--repeats", "1"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    name = module.__name__.rsplit(".", 1)[1]
    assert lines and all(rec["probe"] == name and rec["device"] == "cpu" for rec in lines)
    for rec in lines:
        if rec.get("derived"):
            assert np.isfinite(rec["ms"])
        else:
            assert rec["ms"] > 0 and rec["ms_per_img"] == pytest.approx(rec["ms"] / rec["batch"])
            assert np.isfinite(rec["value"])
