"""The port's phase-major ``fused`` engine against the JAX package's, on the
CPU, on the same numpy inputs and the same weights (every DAE leaf moved by
0.1 x N(0, 1), as ``tests/test_fused.py`` does, so that the symmetric
bilinear and delta inits cannot hide a missing flip of ``up_stem_dw`` or a
transposed ``mix``; the port gets them through ``utils/jax_bridge``).

- ``phase_split`` / ``phase_merge``: JAX's layout and round trip; odd sizes
  refused.
- ``septail_phase_logits`` (f32, 1e-5), and ``septail_step_reference``
  against the JAX step's lines (``inference/fused.py:178-181``; f32 1e-5, a
  bf16 carry 2^-8: one bf16 ulp on [0.5, 1), the two sides round the
  tail's sums in another order).
- ``fused_refinement_scan`` against JAX's and against the port's own general
  engine with the 'sep' tail (rtol 2e-4, atol 2e-5, as JAX's own test).
- ``make_fused_refiner`` end to end against JAX's (the iterate moved by more
  than 1e-4); a 'full'-tail DAE refused with JAX's ``ValueError``.
- The gradient of ``sum(m * y_K)`` in ``mix/w`` and ``enc1/w`` against
  ``jax.grad`` (1e-4 of the leaf's largest entry), ``m`` a fixed random map:
  ``sum(y_K)`` itself is constant in the params (each blend keeps a pixel's
  classes summing to 1), so its gradient is round-off on both sides.

Every JAX side is jitted: ``septail_phase_logits`` is ~600 ops.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from iterative_inference_segm_tpu.inference import fused as jfused  # noqa: E402
from iterative_inference_segm_tpu.models import dae as jdae  # noqa: E402
from iterative_inference_segm_tpu.models import fcn8 as jfcn8  # noqa: E402
from iterative_inference_segm_tpu_torch.inference import fused as tfused  # noqa: E402
from iterative_inference_segm_tpu_torch.inference.iterative import refinement_scan  # noqa: E402
from iterative_inference_segm_tpu_torch.models.dae import dae_core, dae_logits  # noqa: E402
from iterative_inference_segm_tpu_torch.models.fcn8 import fcn8_apply  # noqa: E402
from iterative_inference_segm_tpu_torch.ops.septail_step import septail_step, septail_step_reference  # noqa: E402
from iterative_inference_segm_tpu_torch.utils.jax_bridge import params_from_jax  # noqa: E402

C = 5
HW = (16, 24)
F32 = dict(rtol=1e-5, atol=1e-5)
SCAN = dict(rtol=2e-4, atol=2e-5)


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return {k: {kk: jnp.asarray(np.asarray(v) + 0.1 * rng.normal(size=v.shape).astype(np.float32))
                for kk, v in lv.items()} for k, lv in tree.items()}


def _sep_dae(tail="sep", seed=1):
    return _perturbed(jdae.init_dae(jax.random.PRNGKey(seed), n_classes=C, h_specs={"pool4": 512}, depth=3,
                                    stem_pool=1, tail=tail, widths=(8, 16, 32)), seed + 10)


def _probs(shape, seed):
    z = np.random.default_rng(seed).normal(size=shape) * 2
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.fixture(scope="module")
def dae():
    jd = _sep_dae()
    return jd, params_from_jax(jd)


@pytest.fixture(scope="module")
def scan_inputs():
    y0 = _probs((2, *HW, C), 7)
    h = _normal((2, 1, 2, 512), 8)
    return y0, h


def test_phase_split_merge_match_jax_and_round_trip():
    y = _normal((2, 8, 12, C), 0)
    got = tfused.phase_split(torch.from_numpy(y))
    want = np.asarray(jfused.phase_split(jnp.asarray(y)))
    assert tuple(got.shape) == want.shape == (2, 2, 2, C, 4, 6)
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(got[1, 1, 0, 3, 2, 4]) == y[1, 5, 8, 3]  # [b, ph, pw, c, j, u] == y[b, 2j+ph, 2u+pw, c]
    np.testing.assert_array_equal(tfused.phase_merge(got.contiguous()).numpy(), y)


@pytest.mark.parametrize("hw", [(7, 8), (8, 7)])
def test_phase_split_refuses_odd_sizes_as_jax(hw):
    with pytest.raises(ValueError, match="even H, W"):
        jfused.phase_split(jnp.zeros((1, *hw, C)))
    with pytest.raises(ValueError, match="even H, W"):
        tfused.phase_split(torch.zeros((1, *hw, C)))


def test_septail_phase_logits_match_jax(dae):
    jd, td = dae
    y = _probs((2, *HW, C), 3)
    s_cl = _normal((2, C, HW[0] // 2, HW[1] // 2), 4)
    want = jax.jit(jfused.septail_phase_logits)(jd, jnp.asarray(s_cl), jfused.phase_split(jnp.asarray(y)))
    got = tfused.septail_phase_logits(td, torch.from_numpy(s_cl), tfused.phase_split(torch.from_numpy(y)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_step_reference_matches_the_jax_steps_lines(dae, dtype):
    """``septail_step_reference`` on the weights ``fused_refinement_scan``
    hands it against ``fused.py:178-181`` (s NHWC, as ``core_fn`` returns)."""
    jd, td = dae
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    y = _probs((2, *HW, C), 5)
    s = _normal((2, HW[0] // 2, HW[1] // 2, C), 6)
    eps = 0.1

    @jax.jit
    def jstep(params, y_ph, s):
        s_cl = jnp.transpose(s, (0, 3, 1, 2)).astype(jdt)
        logits = jfused.septail_phase_logits(params, s_cl, y_ph).astype(jnp.float32)
        r = jax.nn.softmax(logits, axis=3).astype(jdt)
        return y_ph - jnp.asarray(eps, jdt) * (y_ph - r)

    want = jstep(jd, jfused.phase_split(jnp.asarray(y)).astype(jdt), jnp.asarray(s))
    y_ph = tfused.phase_split(torch.from_numpy(y)).to(tdt).contiguous()
    weights = [t.to(tdt) for t in tfused.septail_weights(td)]
    got = septail_step_reference(y_ph, torch.from_numpy(s), *weights, eps)
    assert got.dtype == tdt
    tol = 1e-5 if dtype == "float32" else 2.0**-8
    assert np.abs(got.float().numpy() - np.asarray(want.astype(jnp.float32))).max() <= tol


def _jax_scan(jd, y0, h, eps, steps):
    @jax.jit
    def run(params, y0, h):
        core_fn = lambda yp: jdae.dae_core(params, yp, {"pool4": h}, depth=3, stem_pool=1)  # noqa: E731
        return jfused.fused_refinement_scan(params, core_fn, y0, eps=eps, num_steps=steps)

    return np.asarray(run(jd, jnp.asarray(y0), jnp.asarray(h)))


def _port_scan(td, y0, h, eps, steps):
    th = {"pool4": torch.from_numpy(h)}
    core_fn = lambda yp: dae_core(td, yp, th, depth=3, stem_pool=1)  # noqa: E731
    with torch.inference_mode():
        return tfused.fused_refinement_scan(td, core_fn, torch.from_numpy(y0), eps=eps, num_steps=steps)


def test_fused_scan_matches_jax(dae, scan_inputs):
    jd, td = dae
    y0, h = scan_inputs
    got = _port_scan(td, y0, h, 0.3, 3)
    assert got.dtype == torch.float32 and tuple(got.shape) == y0.shape
    np.testing.assert_allclose(got.numpy(), _jax_scan(jd, y0, h, 0.3, 3), **SCAN)


def test_fused_scan_matches_the_ports_general_engine_with_the_sep_tail(dae, scan_inputs):
    _, td = dae
    y0, h = scan_inputs
    th = {"pool4": torch.from_numpy(h)}
    with torch.inference_mode():
        want = refinement_scan(lambda y: dae_logits(td, y, th, depth=3), torch.from_numpy(y0), eps=0.3,
                               num_steps=3)
    got = _port_scan(td, y0, h, 0.3, 3)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **SCAN)
    assert float((want - torch.from_numpy(y0)).abs().max()) > 1e-3  # the steps moved the map


def test_make_fused_refiner_end_to_end_matches_jax(dae):
    jd, td = dae
    jf = jfcn8.init_fcn8(jax.random.PRNGKey(0), n_classes=C, fc_channels=16)
    x = _normal((2, 48, 64, 3), 3)
    jy0, jyk = jfused.make_fused_refiner(jfcn8.fcn8_apply, jf, jd, eps=0.2, num_steps=2, depth=3)(jnp.asarray(x))
    refine = tfused.make_fused_refiner(fcn8_apply, params_from_jax(jf), td, eps=0.2, num_steps=2, depth=3)
    y0, yk = refine(torch.from_numpy(x))
    np.testing.assert_allclose(y0.numpy(), np.asarray(jy0), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(yk.numpy(), np.asarray(jyk), **SCAN)
    assert float((yk - y0).abs().max()) > 1e-4  # the steps moved the iterate


def test_make_fused_refiner_refuses_a_full_tail_dae_as_jax():
    jd = _sep_dae(tail="full")
    jf = jfcn8.init_fcn8(jax.random.PRNGKey(0), n_classes=C, fc_channels=16)
    msg = "requires a stem_pool=1, tail='sep' DAE"
    with pytest.raises(ValueError, match=msg):
        jfused.make_fused_refiner(jfcn8.fcn8_apply, jf, jd, eps=0.1, num_steps=1, depth=3)
    td = params_from_jax(jd)
    with pytest.raises(ValueError, match=msg):
        tfused.make_fused_refiner(fcn8_apply, params_from_jax(jf), td, eps=0.1, num_steps=1, depth=3)
    with pytest.raises(ValueError, match=msg):
        tfused.fused_refinement_scan(td, lambda yp: yp, torch.zeros((1, *HW, C)), eps=0.1, num_steps=1)


@pytest.fixture(scope="module")
def grads(dae):
    """d sum(m * y_K) / d params through 2 fused steps, JAX and the port."""
    jd, _ = dae
    y0 = _probs((1, *HW, C), 11)
    h = _normal((1, 1, 2, 512), 12)
    m = _normal((1, *HW, C), 15)

    def loss(p):
        cf = lambda yp: jdae.dae_core(p, yp, {"pool4": jnp.asarray(h)}, depth=3, stem_pool=1)  # noqa: E731
        return jnp.sum(jnp.asarray(m) * jfused.fused_refinement_scan(p, cf, jnp.asarray(y0), eps=0.2, num_steps=2))

    want = params_from_jax(jax.jit(jax.grad(loss))(jd))
    td = params_from_jax(jd)
    for leaves in td.values():
        for t in leaves.values():
            t.requires_grad_(True)
    th = {"pool4": torch.from_numpy(h)}
    cf = lambda yp: dae_core(td, yp, th, depth=3, stem_pool=1)  # noqa: E731
    (torch.from_numpy(m) * tfused.fused_refinement_scan(td, cf, torch.from_numpy(y0), eps=0.2, num_steps=2)).sum().backward()
    return td, want


@pytest.mark.parametrize("layer", ["mix", "enc1"])
def test_gradient_matches_jax_grad(grads, layer):
    td, want = grads
    got, ref = td[layer]["w"].grad.numpy(), want[layer]["w"].numpy()
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())


def test_septail_step_on_a_cpu_tensor_launches_no_kernel(dae):
    _, td = dae
    y_ph = tfused.phase_split(torch.from_numpy(_probs((1, *HW, C), 13))).contiguous()
    s = torch.from_numpy(_normal((1, HW[0] // 2, HW[1] // 2, C), 14))
    before = septail_step.launches
    got = septail_step(y_ph, s, *tfused.septail_weights(td), 0.1)
    assert septail_step.launches == before
    assert torch.equal(got, septail_step_reference(y_ph, s, *tfused.septail_weights(td), 0.1))


def test_fused_bench_twin_runs_the_jax_tools_four_variants(monkeypatch, capsys):
    """``tools/fused_bench.py``'s twin on the CPU, its bench configuration
    (the JAX tool's 360x480, fc 4096) cut to 32x32, fc 16 for the test: the
    card line, then one line a variant, labelled as the JAX tool labels
    them; the twin's options are the JAX tool's, with ``--device``."""
    import pathlib
    import re

    from iterative_inference_segm_tpu_torch.tools import fused_bench

    src = (pathlib.Path(__file__).resolve().parents[1] / "tools" / "fused_bench.py").read_text()
    labels = [label.replace("{K}", "2") for label in re.findall(r'f"([^"]+\(K=\{K\}\))"', src)]
    assert len(labels) == 4
    assert set(vars(fused_bench.parse_args([]))) == set(re.findall(r'add_argument\("--(\w+)"', src)) | {"device"}
    assert (fused_bench.H, fused_bench.W, fused_bench.C, fused_bench.FC_CHANNELS) == (360, 480, 11, 4096)
    monkeypatch.setattr(fused_bench, "H", 32)
    monkeypatch.setattr(fused_bench, "W", 32)
    monkeypatch.setattr(fused_bench, "FC_CHANNELS", 16)
    assert fused_bench.main(["--device", "cpu", "--batch", "1", "--steps", "2", "--iters", "1"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "device: cpu" and len(lines) == 5
    for label, line in zip(labels, lines[1:]):
        assert line.startswith(label) and float(line.split("->")[1].split()[0]) > 0
