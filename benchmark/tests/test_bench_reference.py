"""The plain reference agrees with the port's ``Predictor`` for both engines
at a tiny size on the CPU, in float32, on the benchmark's own weights."""

import numpy as np
import pytest
import torch

from benchmark import harness, reference, weights
from benchmark.tests.bench_cells import load, tiny


@pytest.mark.parametrize("name", ["half_b32", "general_b128"])
def test_reference_matches_predictor_f32(name):
    cell = tiny(load(name), fc_channels=16, batch=2)
    cfg = dict(cell.config, compute_dtype="float32", state_dtype="float32")
    fcn, dae = weights.make_params(cfg, 5, "cpu")
    frames = weights.make_frames(1, 2, cfg, 5, "cpu")[0]
    labels, probs = harness.build_predictor(cfg, fcn, dae, 2, "cpu").predict(frames, return_probs=True)
    reference.exact_f32()
    with torch.no_grad():
        ref = reference.refine(fcn, dae, torch.from_numpy(frames), cfg).numpy()
    np.testing.assert_allclose(probs, ref, rtol=0, atol=2e-5)
    near_tie = np.sort(ref, -1)[..., -1] - np.sort(ref, -1)[..., -2] < 1e-4
    assert np.all((labels == ref.argmax(-1)) | near_tie)


def test_reference_refines():
    """The refinement moves the FCN's softmax: the engines' steps are not
    the identity at this size."""
    cell = tiny(load("general_b128"), fc_channels=16, batch=1)
    fcn, dae = weights.make_params(cell.config, 5, "cpu")
    x = torch.from_numpy(weights.make_frames(1, 1, cell.config, 5, "cpu")[0])
    with torch.no_grad():
        y0 = reference.fcn8(fcn, x, cell.config)[0].permute(0, 2, 3, 1)
        yk = reference.refine(fcn, dae, x, cell.config)
    assert float((yk - y0).abs().max()) > 1e-2
    torch.testing.assert_close(yk.sum(-1), torch.ones_like(yk[..., 0]))


def test_fp8_rounds_to_e4m3():
    t = torch.tensor([448.0, -1.0, 0.3, 0.0])
    q = reference.fp8_e4m3(t)
    assert q[0] == 448.0 and q[1] == -1.0 and q[3] == 0.0
    assert q[2] != 0.3 and abs(float(q[2]) - 0.3) < 0.3 / 16
