"""The tail and arithmetic probe twins (``iterative_inference_segm_tpu_torch/
tools/{tailfold,tail2,int8}_probe.py``) on the CPU.

Each probe's rows, in f32, against the JAX package's functions composed as
the JAX probe composes them (``tools/*_probe.py``), on the same numpy
inputs and weights (crossing through ``utils/jax_bridge``): every map
within 1e-5 relative to its largest entry (rtol 1e-5 and atol 1e-5 of the
largest), an argmax map equal. ``tailfold``: the twin's DAE gets the JAX
side's numpy weights (the JAX probe's deconv draws are not reproducible
across processes); the port's folded kernels (``fold_half_tail``) equal the
JAX probe's HWIO composition through the bridge's rule; its checks hold
(v1, v2 against v0 below 1e-3, the port's folded step, whose K3 takes its
plain version here, against v2 below 1e-5). ``int8``: the int8 rows equal an
int64 reference and the JAX package's int32 conv and dot bit for bit
(``torch._int_mm`` runs on the CPU); the bf16 rows are within bf16's
rounding of it. Small shapes: C = 5, the pooled map 12x16 (24x32 full),
DAE widths (8, 16, 32).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from iterative_inference_segm_tpu.models import dae as jdae  # noqa: E402
from iterative_inference_segm_tpu.ops import conv as jconv  # noqa: E402
from iterative_inference_segm_tpu_torch.inference.fused import fold_half_tail  # noqa: E402
from iterative_inference_segm_tpu_torch.tools import int8_probe, tail2_probe, tailfold_probe  # noqa: E402
from iterative_inference_segm_tpu_torch.utils.jax_bridge import params_from_jax  # noqa: E402
from torch_port_helpers import C, probs  # noqa: E402

B, HH, WH = 2, 12, 16


def close(got, want, name=""):
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape, name
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()), err_msg=name)


def normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


# -- tailfold ----------------------------------------------------------------

def _jax_tailfold(p, x, hb):
    """The JAX probe's step_v0/v1/v2 and folded_kernels
    (``tools/tailfold_probe.py:84-167``), composed from the JAX package's
    ops, f32, with its K = 5 loops."""
    from iterative_inference_segm_tpu.ops.conv import conv2d, conv_transpose2d, crop_to, max_pool

    def encoder(x):
        skips, h = [], x
        for i in range(3):
            q = p[f"enc{i + 1}"]
            h = jax.nn.relu(conv2d(h, q["w"], q["b"], padding="SAME"))
            skips.append(h)
            h = max_pool(h, window=2, stride=2, ceil_mode=True)
        q = p["bottleneck"]
        cx = hb.shape[-1]
        h = jax.nn.relu(conv2d(h, q["w"][:, :, :cx], q["b"], padding="SAME") + crop_to(hb, h.shape[1], h.shape[2]))
        return h, skips

    def predense(h, skips):
        q = p["score_bottleneck"]
        s = conv2d(h, q["w"], q["b"], padding="SAME")
        for i in (2, 1):
            s = conv_transpose2d(s, p[f"up{i + 1}"]["w"], stride=2)
            q = p[f"score_enc{i + 1}"]
            sk = conv2d(skips[i], q["w"], q["b"], padding="SAME")
            s = crop_to(s, sk.shape[1], sk.shape[2]) + sk
        return s

    w_out, b_out = p["out"]["w"][0, 0], p["out"]["b"]
    se1_w, se1_b = p["score_enc1"]["w"], p["score_enc1"]["b"]
    fk = {"up1p": jnp.einsum("hwim,mo->hwio", p["up1"]["w"], w_out),
          "se1p_w": jnp.einsum("hwim,mo->hwio", se1_w, w_out), "bp": se1_b @ w_out + b_out}
    c1 = se1_w.shape[2]
    k = jnp.zeros((3, 3, c1 + C, C)).at[1, 1, :c1, :].set(fk["se1p_w"][0, 0]).at[:, :, c1:, :].set(
        p["score_input"]["w"])
    fk.update(cat_w=k, cat_b=fk["bp"] + p["score_input"]["b"])

    def blend(x, logits):
        return x - 0.1 * (x - jax.nn.softmax(logits, -1))

    def v0(x):
        h, skips = encoder(x)
        s = conv_transpose2d(predense(h, skips), p["up1"]["w"], stride=2)
        sk = conv2d(skips[0], se1_w, se1_b, padding="SAME")
        s = conv2d(crop_to(s, sk.shape[1], sk.shape[2]) + sk, p["out"]["w"], p["out"]["b"], padding="SAME")
        return blend(x, s + conv2d(x, p["score_input"]["w"], p["score_input"]["b"], padding="SAME"))

    def v1(x):
        h, skips = encoder(x)
        s = conv_transpose2d(predense(h, skips), fk["up1p"], stride=2)
        sk = conv2d(skips[0], fk["se1p_w"], fk["bp"], padding="SAME")
        s = crop_to(s, sk.shape[1], sk.shape[2]) + sk
        return blend(x, s + conv2d(x, p["score_input"]["w"], p["score_input"]["b"], padding="SAME"))

    def v2(x):
        h, skips = encoder(x)
        s = conv_transpose2d(predense(h, skips), fk["up1p"], stride=2)
        sk = conv2d(jnp.concatenate([skips[0], x], -1), fk["cat_w"], fk["cat_b"], padding="SAME")
        return blend(x, crop_to(s, sk.shape[1], sk.shape[2]) + sk)

    def scan5(step):
        return lax.scan(lambda c, _: (step(c), None), x, None, length=5)[0]

    rows = {"step v0 (current)": v0(x), "step v1 (out folded)": v1(x),
            "step v2 (out folded + concat-merged tail)": v2(x), "K=5 scan v0": scan5(v0), "K=5 scan v1": scan5(v1),
            "K=5 scan v2": scan5(v2)}
    return rows, fk


def test_tailfold_rows_match_jax_and_its_checks_hold():
    rng = np.random.default_rng(3)
    jp = jdae.init_dae(jax.random.PRNGKey(1), n_classes=C, h_specs={"pool4": 512}, depth=3, stem_pool=1,
                       widths=(8, 16, 32))
    # the deconvs re-drawn (the JAX probe's 0.1 N(0, 1)) and every bias random, the same numbers on both sides
    jp = {k: {kk: jnp.asarray(rng.normal(size=v.shape).astype(np.float32) * (0.1 if k.startswith("up") else 0.3))
              if (k.startswith("up") or kk == "b" or k in ("out", "score_input")) else v
              for kk, v in lv.items()} for k, lv in jp.items()}
    x, hb = probs((B, HH, WH, C), 4), normal((B, *tailfold_probe.bottleneck_hw(HH, WH), 32), 5)
    want, jfk = jax.jit(_jax_tailfold)(jp, jnp.asarray(x), jnp.asarray(hb))
    tp = params_from_jax(jp)
    fk = fold_half_tail(tp)
    for name in ("up1p", "se1p_w", "cat_w"):  # the HWIO composition through the bridge's rule
        close(fk[name], params_from_jax({("up" if name == "up1p" else "c"): {"w": jfk[name]}})[
            "up" if name == "up1p" else "c"]["w"], name)
    rows = tailfold_probe.cases(tp, fk, t(x), t(hb))
    assert [label for label, _ in rows] == ["step v0 (current)", "step v1 (out folded)",
                                            "step v2 (out folded + concat-merged tail)", tailfold_probe.PORT_LABEL,
                                            "K=5 scan v0", "K=5 scan v1", "K=5 scan v2"]
    with torch.inference_mode():
        for label, fn in rows:
            close(fn()[0], want["step v2 (out folded + concat-merged tail)" if label == tailfold_probe.PORT_LABEL
                                else label], label)
        errs = tailfold_probe.fold_errors(tp, t(x), t(hb))
    assert errs["v1"] < tailfold_probe.FOLD_TOL and errs["v2"] < tailfold_probe.FOLD_TOL
    assert errs["port"] < tailfold_probe.PORT_TOL
    assert float(np.abs(np.asarray(want["step v0 (current)"]) - x).max()) > 1e-3  # the step moved x


# -- tail2 -------------------------------------------------------------------

def test_tail2_rows_match_jax():
    y, logits = probs((B, 2 * HH, 2 * WH, C), 6), normal((B, 2 * HH, 2 * WH, C), 7)
    s, u = normal((B, HH, WH, C), 8), normal((B, 2 * HH, 2 * WH, C), 9)
    w_up, w_si, b_si = normal((4, 4, C, C), 10, 0.3), normal((3, 3, C, C), 11, 0.3), normal((C,), 12)
    port_up = params_from_jax({"up": {"w": w_up}})["up"]["w"]
    port_si = params_from_jax({"c": {"w": w_si}})["c"]["w"]
    cm = [np.ascontiguousarray(a.transpose(0, 3, 1, 2)) for a in (y, logits, u)]
    rows = tail2_probe.cases(t(y), t(cm[0]), t(logits), t(cm[1]), t(u), t(cm[2]), t(s), port_up, port_si, t(b_si),
                             low=torch.float32)

    @jax.jit
    def want(y, logits, u, s, w_up, w_si, b_si):
        eps = jnp.bfloat16(0.1)
        y_cm, u_cm = jnp.transpose(y, (0, 3, 1, 2)), jnp.transpose(u, (0, 3, 1, 2))
        dn = dict(dimension_numbers=("NHWC", "HWIO", "NCHW"), precision=lax.Precision.HIGHEST)
        conv_cm = lax.conv_general_dilated(y, w_si, (1, 1), "SAME", **dn) + b_si[None, :, None, None]
        conv_cc = lax.conv_general_dilated(y_cm, w_si, (1, 1), "SAME", dimension_numbers=("NCHW", "HWIO", "NCHW"),
                                           precision=lax.Precision.HIGHEST) + b_si[None, :, None, None]
        g = y.reshape(B, HH, 2, WH, 2, C)
        wp = jnp.full((2, 2, 1, 1), 0.25) * jnp.eye(C)[None, None]
        t_rect = jconv.conv_transpose2d(s, w_up, stride=2) + jconv.conv2d(y, w_si, b_si, padding="SAME")
        u_rect = lax.conv_general_dilated(y, w_si, (1, 1), "SAME", **dn) + jnp.transpose(
            jconv.conv_transpose2d_phase(s, w_up, stride=2), (0, 3, 1, 2)) + b_si[None, :, None, None]
        return {
            "baseline NHWC full-res": (y,),
            "baseline NCHW full-res": (y_cm,),
            "softmax+blend+argmax NHWC": (jnp.argmax(y - eps * (y - jax.nn.softmax(u, -1)), -1),),
            "softmax+blend+argmax NCHW": (jnp.argmax(y_cm - eps * (y_cm - jax.nn.softmax(u_cm, 1)), 1),),
            "probs: softmax f32->bf16 NHWC (current)": (jax.nn.softmax(logits, -1),),
            "probs: cast bf16 then softmax NHWC": (jax.nn.softmax(logits, -1),),
            "probs: softmax f32->bf16 NCHW": (jax.nn.softmax(jnp.transpose(logits, (0, 3, 1, 2)), 1),),
            "conv3x3 CxC full-res NHWC->NHWC (current)": (jconv.conv2d(y, w_si, b_si, padding="SAME"),),
            "conv3x3 CxC full-res NHWC->NCHW": (conv_cm,),
            "conv3x3 CxC full-res NCHW->NCHW": (conv_cc,),
            "transpose NHWC->NCHW full-res": (y_cm,),
            "avg_pool reduce_window bf16 (current)": (jconv.avg_pool(y, window=2, stride=2),),
            "avg_pool via reshape+phase-add": ((g[:, :, 0, :, 0] + g[:, :, 1, :, 0] + g[:, :, 0, :, 1]
                                                + g[:, :, 1, :, 1]) * 0.25,),
            "avg_pool via strided slices": ((y[:, 0::2, 0::2] + y[:, 1::2, 0::2] + y[:, 0::2, 1::2]
                                             + y[:, 1::2, 1::2]) * 0.25,),
            "avg_pool via 2x2 stride-2 conv (dense eye)": (jconv.conv2d(y, wp, stride=2, padding="VALID"),),
            "RECT: full tail NHWC (current)": (jnp.argmax(y - eps * (y - jax.nn.softmax(t_rect, -1)), -1),),
            "RECT: convs->NCHW + pointwise NCHW": (
                jnp.argmax(y_cm - eps * (y_cm - jax.nn.softmax(u_rect, 1)), 1),),
        }

    ref = want(*(jnp.asarray(a) for a in (y, logits, u, s, w_up, w_si, b_si)))
    assert sorted(label for label, _ in rows) == sorted(ref)  # (a jitted dict comes back in key order)
    with torch.inference_mode():
        for label, fn in rows:
            (got,), (w,) = fn(), ref[label]
            if got.dtype == torch.int64:
                np.testing.assert_array_equal(got.numpy(), np.asarray(w), err_msg=label)
            else:
                close(got, w, label)
        layouts = tail2_probe.conv_layouts(t(y), t(cm[0]), port_si, t(b_si))
    assert [layouts[label] for label in tail2_probe.CONV_LABELS] == [
        {"conv_in": "channels_last", "conv_out": "channels_last"},
        {"conv_in": "channels_last", "conv_out": "channels_last"},
        {"conv_in": "contiguous", "conv_out": "contiguous"}]


# -- int8 --------------------------------------------------------------------

def test_int8_rows_equal_the_int64_reference_and_jax_bit_for_bit():
    rng = np.random.default_rng(13)
    x8 = rng.integers(-127, 127, (2, 6, 8, 16), dtype=np.int8)
    w8 = rng.integers(-127, 127, (16, 16, 3, 3), dtype=np.int8)  # OIHW
    a8, bt8 = rng.integers(-127, 127, (32, 24), dtype=np.int8), rng.integers(-127, 127, (16, 24), dtype=np.int8)
    rows = dict(int8_probe.cases(*(torch.from_numpy(a) for a in (x8, w8, a8, bt8))))
    assert list(rows) == ["conv 3x3 16->16 @6x8 bf16", "conv 3x3 16->16 @6x8 int8->int32",
                          "conv 3x3 16->16 @6x8 bf16 as the int8 row's im2col GEMM", "dot 32x24x16 bf16",
                          "dot 32x24x16 int8->int32",
                          "conv 3x3 16->16 @6x8 int8 im2col GEMM alone (patches unfolded beforehand)",
                          "conv 3x3 16->16 @6x8 bf16 im2col GEMM alone (patches unfolded beforehand)"]
    whwio = w8.transpose(2, 3, 1, 0)
    jconv8 = np.asarray(lax.conv_general_dilated(jnp.asarray(x8), jnp.asarray(whwio), (1, 1), "SAME",
                                                 dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                                 preferred_element_type=jnp.int32))
    jdot8 = np.asarray(jnp.dot(jnp.asarray(a8), jnp.asarray(bt8.T), preferred_element_type=jnp.int32))
    ref_conv = torch.nn.functional.conv2d(torch.from_numpy(x8).permute(0, 3, 1, 2).double(),
                                          torch.from_numpy(w8).double(), padding=1).permute(0, 2, 3, 1)
    ref_conv = ref_conv.round().long()  # exact: every sum is an integer below 2^53
    ref_dot = torch.from_numpy(a8).long() @ torch.from_numpy(bt8).long().t()
    conv_i8, dot_i8 = rows["conv 3x3 16->16 @6x8 int8->int32"]()[0], rows["dot 32x24x16 int8->int32"]()[0]
    assert conv_i8.dtype == dot_i8.dtype == torch.int32
    assert torch.equal(conv_i8.long(), ref_conv) and np.array_equal(conv_i8.numpy(), jconv8)
    assert torch.equal(dot_i8.long(), ref_dot) and np.array_equal(dot_i8.numpy(), jdot8)
    alone = rows["conv 3x3 16->16 @6x8 int8 im2col GEMM alone (patches unfolded beforehand)"]()[0]
    assert alone.dtype == torch.int32 and torch.equal(alone.reshape(conv_i8.shape), conv_i8)
    bf16_rows = (("conv 3x3 16->16 @6x8 bf16", ref_conv),
                 ("conv 3x3 16->16 @6x8 bf16 as the int8 row's im2col GEMM", ref_conv), ("dot 32x24x16 bf16", ref_dot),
                 ("conv 3x3 16->16 @6x8 bf16 im2col GEMM alone (patches unfolded beforehand)", ref_conv))
    for label, ref in bf16_rows:
        got = rows[label]()[0].double().reshape(ref.shape)
        assert (got - ref.double()).abs().max() <= 2.0**-8 * ref.abs().max().double(), label
    work = int8_probe.row_work(*(torch.from_numpy(a) for a in (x8, w8, a8, bt8)))
    assert work["conv 3x3 16->16 @6x8 int8->int32"] == (2.0 * 2 * 6 * 8 * 16 * 9 * 16, "int8")
