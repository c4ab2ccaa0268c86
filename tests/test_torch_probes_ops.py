"""The op-level probe twins (``iterative_inference_segm_tpu_torch/tools/
{tail_ops,dae_op,pool,fused}_probe.py``) on the CPU; the last test also runs
the seven later twins' mains (``tests/test_torch_probes_{tail,aug}.py`` hold
their rows).

Each probe's case functions, in f32, against the JAX package's functions
composed as the JAX probe composes them (``tools/*_probe.py``), on the same
numpy inputs and random weights (crossing through ``utils/jax_bridge``):
every map within 1e-5 relative to its largest entry (rtol 1e-5 and atol 1e-5
of the largest, as ``tests/test_torch_fcn8_train.py`` holds the FCN). The
tool's own copies of the JAX package's transposed-conv speed forms equal
the JAX ones and the port's ``conv_transpose2d``. The kernel rows (K3, S1)
take their plain versions on the CPU and are held to their op-by-op rows.
Equivalences, asserted: max-pool by reshape + maximum equals ``max_pool``;
the phase-strided conv1_2 equals conv + ReLU + pool1 (f32 1e-5), its kernel
built from the 3x3 one as the JAX probe builds it in HWIO and crossed by the
bridge's conv rule. Each tool refuses ``--device cuda`` without a card, and
``--device cpu`` prints one JSON line a row (sizes cut by patching the
module's constants).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from iterative_inference_segm_tpu.inference import fused as jfused  # noqa: E402
from iterative_inference_segm_tpu.models import dae as jdae  # noqa: E402
from iterative_inference_segm_tpu.ops import conv as jconv  # noqa: E402
from iterative_inference_segm_tpu_torch.ops.conv import conv_transpose2d, max_pool  # noqa: E402
from iterative_inference_segm_tpu_torch.tools import (  # noqa: E402
    aug_order_probe,
    aug_probe,
    aug_step_probe,
    dae_op_probe,
    fused_probe,
    int8_probe,
    pool_probe,
    scan_variants_probe,
    tail2_probe,
    tail_ops_probe,
    tailfold_probe,
)
from iterative_inference_segm_tpu_torch.utils.jax_bridge import params_from_jax  # noqa: E402
from torch_port_helpers import C, both, jax_params, probs  # noqa: E402

B, HH, WH = 2, 12, 16


def close(got, want, name=""):
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape, name
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()),
                               err_msg=name)


def normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def port_w(name, w):
    """A JAX-layout kernel in the port's layout (the bridge's rule for a
    layer called ``name``: 'up...' is a transposed conv)."""
    return params_from_jax({name: {"w": w}})[name]["w"]


def check_rows(rows, ref):
    assert sorted(r[0] for r in rows) == sorted(ref)  # (a jitted dict comes back in key order)
    for label, fn in rows:
        got = fn()
        assert len(got) == len(ref[label]), label
        for g, w in zip(got, ref[label]):
            close(g, w, label)


def test_deconv_speed_forms_match_jax_and_the_ports_deconv():
    s = normal((B, HH, WH, C), 0)
    w = normal((4, 4, C, C), 1, 0.3)
    wp = port_w("up", w)
    want = jconv._conv_transpose2d_dilated(jnp.asarray(s), jnp.asarray(w), stride=2)
    close(tail_ops_probe.deconv_dilated(t(s), wp), want, "dilated")
    close(tail_ops_probe.deconv_phase(t(s), wp), jconv.conv_transpose2d_phase(jnp.asarray(s), jnp.asarray(w), stride=2),
          "phase")
    close(conv_transpose2d(t(s), wp, stride=2), want, "the port's conv_transpose2d")


def test_tail_ops_rows_match_jax():
    y, s, y_pc = probs((B, 2 * HH, 2 * WH, C), 2), normal((B, HH, WH, C), 3), normal((B, HH, WH, 4 * C), 4)
    w_up, w_si, b_si, w44 = normal((4, 4, C, C), 5, 0.3), normal((3, 3, C, C), 6, 0.3), normal((C,), 7), normal(
        (3, 3, 4 * C, 4 * C), 8, 0.05)
    rows = tail_ops_probe.cases(t(y), t(s), t(y_pc), port_w("up", w_up), port_w("c", w_si), t(b_si),
                                port_w("c", w44))

    @jax.jit
    def want(y, s, y_pc, w_up, w_si, b_si, w44):
        e16, k99 = jnp.bfloat16(0.1), jnp.bfloat16(0.99)
        g = y_pc.reshape(B, HH, WH, 4, C)
        return {
            "baseline full-res (perturb+reduce)": (y,),
            "baseline half-res": (s,),
            "deconv k4s2 phase-major (conv44 + interleave)": (jconv.conv_transpose2d_phase(s, w_up, stride=2),),
            "deconv k4s2 input-dilated": (jconv._conv_transpose2d_dilated(s, w_up, stride=2),),
            "phase conv 11->44 only (no interleave)": (lax.conv_general_dilated(
                s, jnp.zeros((3, 3, C, 4 * C)), (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC")),),
            "conv3x3 11->11 full-res": (jconv.conv2d(y, w_si, b_si),),
            "softmax f32 full-res": (jax.nn.softmax(y, -1),),
            "softmax bf16 full-res": (jax.nn.softmax(y, -1),),
            "update elementwise full-res": (y - e16 * (y - y * k99),),
            "avg_pool 2x2 full-res": (jconv.avg_pool(y, window=2, stride=2),),
            "conv3x3 depthwise full-res": (jconv.conv2d_depthwise(y, jconv.delta_kernel_depthwise(3, C)),),
            "conv3x3 44->44 half-res (phase-channel)": (jconv.conv2d(y_pc, w44),),
            "grouped softmax (4x11) half-res": (jax.nn.softmax(g, -1).reshape(B, HH, WH, 4 * C),),
            "phase-channel pool to 11ch": (jnp.mean(g, 3),),
            "NHWC full-res -> phase-channel": (y.reshape(B, HH, 2, WH, 2, C).transpose(0, 1, 3, 2, 4, 5).reshape(
                B, HH, WH, 4 * C),),
        }

    check_rows(rows, want(*(jnp.asarray(a) for a in (y, s, y_pc, w_up, w_si, b_si, w44))))


def test_dae_op_rows_match_jax():
    y = probs((B, 2 * HH, 2 * WH, C), 9)
    x32, x180, s_half = normal((B, 2 * HH, 2 * WH, 32), 10), normal((B, HH, WH, 32), 11), normal((B, HH, WH, C), 12)
    w32, b32, up_w, sc_w = normal((3, 3, C, 32), 13, 0.3), normal((32,), 14), normal((4, 4, C, C), 15, 0.3), normal(
        (1, 1, 32, C), 16, 0.3)
    rows = dae_op_probe.cases(t(y), t(x32), t(x180), t(s_half), port_w("c", w32), t(b32), port_w("up", up_w),
                              port_w("c", sc_w), low=torch.float32)

    @jax.jit
    def want(y, x32, x180, s_half, w32, b32, up_w, sc_w):
        deconv = jconv.conv_transpose2d(s_half, up_w, stride=2)
        return {
            "elementwise pass f32 (B,H,W,11)": (y * 1.0001,),
            "softmax f32 (B,H,W,11)": (jax.nn.softmax(y, -1),),
            "conv3x3 11->32 bf16 @/1": (jconv.conv2d(y, w32, b32),),
            "conv3x3 32->32 bf16 @/1": (jconv.conv2d(x32, jnp.zeros((3, 3, 32, 32))),),
            "max_pool 2x2 bf16 @/1 (32ch)": (jconv.max_pool(x32),),
            "max_pool 2x2 f32 @/1 (11ch)": (jconv.max_pool(y),),
            "avg_pool 2x2 f32 @/1 (11ch)": (jconv.avg_pool(y),),
            "conv3x3 32->64 bf16 @/2": (jconv.conv2d(x180, jnp.zeros((3, 3, 32, 64))),),
            "deconv k4s2 11->11 f32 /2->/1": (deconv,),
            "deconv k4s2 11->11 bf16 /2->/1": (deconv,),
            "score 1x1 32->11 bf16 @/1": (jconv.conv2d(x32, sc_w),),
            "stage1: cast+conv+relu+pool @/1": (jconv.max_pool(jax.nn.relu(jconv.conv2d(y, w32, b32))),),
        }

    check_rows(rows, want(*(jnp.asarray(a) for a in (y, x32, x180, s_half, w32, b32, up_w, sc_w))))


def _jax_phase_weight(w3, b3):
    """The JAX probe's phase-strided kernel (``tools/pool_probe.py``), HWIO."""
    c = w3.shape[-1]
    w4 = jnp.zeros((4, 4, w3.shape[2], 4 * c), w3.dtype)
    for ph in range(2):
        for pw in range(2):
            phase = ph * 2 + pw
            w4 = w4.at[ph:ph + 3, pw:pw + 3, :, phase * c:(phase + 1) * c].set(w3)
    return w4, jnp.tile(b3, 4)


def test_pool_rows_match_jax_and_the_phase_conv_is_conv_and_pool():
    c = 8
    x, x1 = normal((B, 2 * HH, 2 * WH, c), 17), normal((B, 2 * HH, 2 * WH, c), 18)
    w3, b3 = normal((3, 3, c, c), 19, 0.3), normal((c,), 20)
    w4j, b4j = _jax_phase_weight(jnp.asarray(w3), jnp.asarray(b3))
    w4, b4 = pool_probe.phase_weight(port_w("c", w3), t(b3))
    assert torch.equal(w4, port_w("c", np.asarray(w4j))) and torch.equal(b4, t(b4j))

    @jax.jit
    def want(x, x1, w3, b3, w4, b4):
        def reshape_max(v):
            g = v.reshape(B, HH, 2, WH, 2, c)
            m = jnp.maximum(g[:, :, 0], g[:, :, 1])
            return jnp.maximum(m[:, :, :, 0], m[:, :, :, 1])

        h = jax.nn.relu(jconv.conv2d(x1, w3, b3, padding="SAME"))
        out = jax.nn.relu(lax.conv_general_dilated(x1, w4, (2, 2), ((1, 1), (1, 1)),
                                                   dimension_numbers=("NHWC", "HWIO", "NHWC")) + b4)
        m = jnp.maximum(out[..., :2 * c], out[..., 2 * c:])
        pooled = jconv.max_pool(x, window=2, stride=2, ceil_mode=True)
        shape = f"({2 * HH},{2 * WH},{c})"
        return {
            f"baseline read {shape}": (x,),
            f"max_pool reduce_window {shape}": (pooled,),
            f"max_pool reshape+maximum {shape}": (reshape_max(x),),
        }, {
            "conv1_2 + reduce_window pool1 (current)": (jconv.max_pool(h, window=2, stride=2, ceil_mode=True),),
            "conv1_2 + reshape-max pool1": (reshape_max(h),),
            "conv1_2 phase-strided conv + group-max (fused pool)": (jnp.maximum(m[..., :c], m[..., c:]),),
        }

    pools, convs = want(*(jnp.asarray(a) for a in (x, x1, w3, b3)), w4j, b4j)
    check_rows(pool_probe.pool_cases(t(x)), pools)
    check_rows(pool_probe.conv_cases(t(x1), port_w("c", w3), t(b3)), convs)
    assert torch.equal(pool_probe.pool_reshape(t(x)), max_pool(t(x)))
    err, top = pool_probe.equivalence_error(t(x1), port_w("c", w3), t(b3))
    assert top > 0 and err <= 1e-5 * top


def test_fused_rows_match_jax_and_s1_holds_to_its_row():
    jd, td = both(jax_params(stem_pool=1, depth=3, tail="sep")[1])
    jdf, tdf = both(jax_params(stem_pool=1, depth=3, tail="full")[1])
    y = probs((B, 2 * HH, 2 * WH, C), 21)
    s, yp, h4 = normal((B, HH, WH, C), 22), normal((B, HH, WH, C), 23), normal((B, 2, 2, 512), 24)
    s_cl = np.ascontiguousarray(s.transpose(0, 3, 1, 2))
    y_ph = np.asarray(jfused.phase_split(jnp.asarray(y)))
    rows = fused_probe.cases(td, tdf, t(y_ph), t(s_cl), t(y), t(s), t(yp), {"pool4": t(h4)})

    @jax.jit
    def want(jd, jdf, y_ph, s_cl, y, s, yp, h4):
        e16 = jnp.bfloat16(0.1)
        tail = {k: jd[k] for k in fused_probe.TAIL_LAYERS}
        r = jax.nn.softmax(jfused.septail_phase_logits(tail, s_cl, y_ph), 3)
        y_new = y_ph - e16 * (y_ph - r)
        phase = (y_new, jnp.transpose(jnp.mean(y_new, (1, 2)), (0, 2, 3, 1)))

        def nhwc(logits):
            yn = y - e16 * (y - jax.nn.softmax(logits, -1))
            return yn, jconv.avg_pool(yn, window=2, stride=2)

        full = jconv.conv_transpose2d(s, jdf["up_stem1"]["w"], stride=2) + jconv.conv2d(
            y, jdf["score_input"]["w"], jdf["score_input"]["b"])
        return {
            "baseline: perturb+reduce phase state": (y_ph,),
            "baseline: perturb+reduce NHWC state": (y,),
            "phase septail logits": (jfused.septail_phase_logits(tail, s_cl, y_ph),),
            "phase tail+softmax+update+pool+T": phase,
            "phase tail+softmax+update+pool+T, septail_step (S1)": phase,
            "NHWC tail full-CxC +update+pool (r1)": nhwc(full),
            "NHWC septail grouped-conv +update+pool": nhwc(jdae.dae_septail_logits(tail, s, y)),
            "dae_core mid-res (NHWC)": (jdae.dae_core(jd, yp, {"pool4": h4}, depth=3, stem_pool=1),),
            "phase pool only": (jnp.mean(y_ph, (1, 2)),),
            "s NHWC -> CL transpose": (jnp.transpose(s, (0, 3, 1, 2)),),
        }

    check_rows(rows, want(jd, jdf, *(jnp.asarray(a) for a in (y_ph, s_cl, y, s, yp, h4))))


SMALL = {  # module -> constants patched to a CPU size (and, under "argv", the flags that cut the rest)
    tail_ops_probe: {"B": 1, "HH": 8, "WH": 12},
    dae_op_probe: {"B": 1, "H": 16, "W": 24},
    pool_probe: {"B": 1, "MAPS": ((16, 24, 8), (8, 12, 16)), "CONV1": (16, 24, 8)},
    fused_probe: {"B": 1, "HH": 8, "WH": 12},
    tailfold_probe: {"B": 1, "H2": 12, "W2": 16},
    tail2_probe: {"B": 1, "HH": 6, "WH": 8},
    scan_variants_probe: {"B": 1, "H": 32, "W": 48, "FC_CHANNELS": 16},
    int8_probe: {"B": 1, "H": 4, "W": 6, "CH": 16, "DOT": (32, 16, 24)},
    aug_probe: {"argv": ["--batch", "2", "--height", "48", "--width", "64", "--crops", "32,16"]},
    aug_order_probe: {"FC_CHANNELS": 16, "argv": ["--batch", "2", "--crop", "32", "--height", "48", "--width", "64"]},
    aug_step_probe: {"FC_CHANNELS": 16, "HEIGHT": 48, "WIDTH": 64, "argv": ["--batch", "2", "--crop", "32"]},
}


@pytest.mark.parametrize("module", list(SMALL), ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_tool_refuses_a_missing_card_and_prints_json_lines_on_the_cpu(module, monkeypatch, capsys):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            module.main([])
    consts = dict(SMALL[module])
    argv = consts.pop("argv", [])
    for k, v in consts.items():
        monkeypatch.setattr(module, k, v)
    assert module.main([*argv, "--device", "cpu", "--iters", "1", "--repeats", "1"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    name = module.__name__.rsplit(".", 1)[1]
    assert lines and all(rec["probe"] == name and rec["device"] == "cpu" for rec in lines)
    for rec in lines:
        if rec.get("check"):
            assert rec["max_abs_err"] <= rec["limit"] or rec.get("asserted") is False
        elif rec.get("derived"):  # a marginal may be negative
            assert np.isfinite(rec["ms"])
        else:
            assert rec["ms"] > 0 and rec["ms_per_img"] == pytest.approx(rec["ms"] / rec["batch"])
            assert np.isfinite(rec["value"])
    if module is pool_probe:
        assert lines[-1]["label"] == "phase-conv vs conv+pool max abs err"
