"""The FCN-8 train-step probe twin (``iterative_inference_segm_tpu_torch/
tools/train_itemize_probe.py``) on the CPU.

Rows (1)-(4) in f32 against the JAX probe's composition (``fcn8_logits`` +
``masked_crossentropy``, ``jax.value_and_grad``; ``tools/
train_itemize_probe.py``) at C = 5, fc 16, batch 2, crop 32, the keep-masks
those the JAX ``fcn8_logits`` draws from its key (``k1, k2 = split(key)``):
the losses and every gradient within 1e-5 relative to the largest entry (rtol
1e-5 and atol 1e-5 of the largest, as ``tests/test_torch_fcn8_train.py``
holds the FCN); the full step returns the loss before its update and moves
every leaf. Row (5): PyTorch's max-pool gradient equals XLA's
(``reduce_window``'s) on an input without ties; the mask recompute
(``MaskPool``) equals the JAX probe's ``pool_mask_bwd`` formula on a tied
input, where it passes a window's gradient to every tied maximum and
PyTorch's backward to one. The tool refuses ``--device cuda`` without a
card and prints one JSON line a row on the CPU.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from iterative_inference_segm_tpu.models import fcn8 as jfcn8  # noqa: E402
from iterative_inference_segm_tpu.ops.losses import masked_crossentropy as j_mce  # noqa: E402
from iterative_inference_segm_tpu_torch.models.fcn8 import fc_shape  # noqa: E402
from iterative_inference_segm_tpu_torch.tools import train_itemize_probe as tip  # noqa: E402
from iterative_inference_segm_tpu_torch.train.loop import TrainConfig, make_optimizer  # noqa: E402
from iterative_inference_segm_tpu_torch.utils.jax_bridge import params_from_jax  # noqa: E402
from torch_port_helpers import C, jax_params  # noqa: E402

B, CROP = 2, 32


def close(got, want, name=""):
    want = np.asarray(want, np.float32)
    assert tuple(got.shape) == want.shape, name
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()),
                               err_msg=name)


@pytest.fixture(scope="module")
def setup():
    jf = jax_params(fcn_scale=0.1)[0]
    rng = np.random.default_rng(0)
    images = rng.normal(size=(B, CROP, CROP, 3)).astype(np.float32)
    labels = rng.integers(0, C, (B, CROP, CROP)).astype(np.int32)
    key = jax.random.PRNGKey(1)
    k1, k2 = jax.random.split(key)
    masks = tuple(torch.from_numpy(np.array(jax.random.bernoulli(k, 0.5, fc_shape((B, CROP, CROP), 16))))
                  for k in (k1, k2))

    def loss(p, drop):
        return j_mce(jfcn8.fcn8_logits(p, jnp.asarray(images), dropout_rng=drop), jnp.asarray(labels), n_classes=C)

    value, grads = jax.jit(jax.value_and_grad(lambda p: loss(p, key)))(jf)
    return {"jf": jf, "images": images, "labels": labels, "masks": masks, "loss": float(value), "grads": grads,
            "nodrop": float(jax.jit(lambda p: loss(p, None))(jf))}


def test_step_rows_match_jax(setup):
    params = params_from_jax(setup["jf"])
    opt = make_optimizer(TrainConfig(learning_rate=1e-3), params)
    rows = tip.step_cases(params, opt, torch.from_numpy(setup["images"]), torch.from_numpy(setup["labels"]),
                          setup["masks"], n_classes=C, compute_dtype=torch.float32)
    assert [r[0] for r in rows] == ["(1) fwd loss", "(2) fwd+bwd (value_and_grad)", "(3) full step (fwd+bwd+adam)",
                                    "(4) fwd, no dropout"]
    out = {label: fn() for label, fn in rows[:2]}
    want_grads = params_from_jax(jax.device_get(setup["grads"]))
    close(out["(1) fwd loss"][0], setup["loss"], "(1)")
    value, *grads = out["(2) fwd+bwd (value_and_grad)"]
    close(value, setup["loss"], "(2) loss")
    leaves = [(f"{layer}/{leaf}", t) for layer, v in params.items() for leaf, t in v.items()]
    assert len(grads) == len(leaves)
    for (name, _), g in zip(leaves, grads):
        layer, leaf = name.split("/")
        close(g, want_grads[layer][leaf], name)
    close(rows[3][1]()[0], setup["nodrop"], "(4)")
    before = [t.detach().clone() for _, t in leaves]
    (step_loss,) = rows[2][1]()
    close(step_loss, setup["loss"], "(3)")
    assert all(not torch.equal(b, t) for b, (_, t) in zip(before, leaves))


def test_pool_grads_match_xla_and_the_mask_formula_on_ties():
    x = np.random.default_rng(1).normal(size=(B, 8, 12, 4)).astype(np.float32)

    def pool_rw(v):
        return jax.lax.reduce_window(v, -jnp.inf, jax.lax.max, (1, 2, 2, 1), (1, 2, 2, 1), "VALID")

    want = jax.grad(lambda v: pool_rw(v).sum())(jnp.asarray(x))
    rows = dict(tip.pool_cases(torch.from_numpy(x)))
    assert list(rows) == ["(5a) pool grad: SelectAndScatter", "(5b) pool grad: mask recompute"]
    for fn in rows.values():  # no ties: both backwards are the one argmax's
        np.testing.assert_array_equal(fn()[0].numpy(), np.asarray(want))
    tied = np.round(x * 2) / 2  # windows of equal values
    tied[0, :2, :2, 0] = 1.5
    y = pool_rw(jnp.asarray(tied))
    up = jnp.repeat(jnp.repeat(y, 2, axis=1), 2, axis=2)
    g = jnp.ones_like(y)
    gup = jnp.repeat(jnp.repeat(g, 2, axis=1), 2, axis=2)
    formula = np.asarray(jnp.where(jnp.asarray(tied) == up, gup, 0))  # the JAX probe's pool_mask_bwd
    mask = tip.pool_grad(torch.from_numpy(tied), mask=True).numpy()
    np.testing.assert_array_equal(mask, formula)
    assert mask[0, :2, :2, 0].tolist() == [[1.0, 1.0], [1.0, 1.0]]
    first = tip.pool_grad(torch.from_numpy(tied), mask=False).numpy()
    assert first[0, :2, :2, 0].sum() == 1.0 and (mask.sum() > first.sum())
    np.testing.assert_array_equal(first, np.asarray(jax.grad(lambda v: pool_rw(v).sum())(jnp.asarray(tied))))


def test_tool_refuses_a_missing_card_and_prints_json_lines_on_the_cpu(monkeypatch, capsys):
    argv = ["--batch", "2", "--crop", "32"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            tip.main(argv)
    monkeypatch.setattr(tip, "FC_CHANNELS", 16)
    assert tip.main([*argv, "--device", "cpu", "--iters", "1", "--repeats", "1"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [rec["label"] for rec in lines] == [
        "(1) fwd loss", "(2) fwd+bwd (value_and_grad)", "(3) full step (fwd+bwd+adam)", "(4) fwd, no dropout",
        "bwd ~= (2)-(1)", "opt ~= (3)-(2)", "(5a) pool grad: SelectAndScatter", "(5b) pool grad: mask recompute"]
    for rec in lines:
        assert rec["probe"] == "train_itemize_probe" and rec["device"] == "cpu" and rec["batch"] == 2
        assert np.isfinite(rec["ms"]) and (rec.get("derived") or rec["ms"] > 0)
    assert lines[4]["share_of_step"] == pytest.approx(lines[4]["ms"] / lines[2]["ms"])
