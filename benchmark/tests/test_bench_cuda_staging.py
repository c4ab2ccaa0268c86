"""``Predictor.predict`` on the card (marker ``cuda``; skips without one):
its labels are bit-equal to ``_predict`` on the same device tensor, and in
steady state the array it returns is page-locked host memory. Run on the
card with

    python -m pytest --noconftest -p no:cacheprovider -m cuda benchmark/tests
"""

import numpy as np
import pytest
import torch

from benchmark import harness, weights
from benchmark.tests.bench_cells import load


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["half_b32", "general_b128"])
def test_predict_serves_the_labels_of_predict_from_page_locked_memory(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell, device, batch = load(name), torch.device("cuda:0"), 16
    fcn, dae = weights.make_params(cell.config, 2**31 + 5, device)
    frames = weights.make_frames(1, batch, cell.config, 2**31 + 5, device)[0]
    p = harness.build_predictor(cell.config, fcn, dae, batch, device)
    with torch.inference_mode():
        want, _ = p._predict(torch.from_numpy(frames).to(device))
    want = want.cpu().numpy()
    for _ in range(3):  # the first call makes the buffers; the later ones reuse them
        got = p.predict(frames)
        assert got.shape == want.shape and got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    assert torch.from_numpy(got).is_pinned()
    held = p.predict(frames)
    assert torch.from_numpy(held).is_pinned() and not np.shares_memory(held, got)
    np.testing.assert_array_equal(held, want)
