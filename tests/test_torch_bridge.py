"""Checkpoint bridge: flat npz files written by the JAX package load in the
port (and back), with the layouts converted by ``utils/jax_bridge``.

Loads are exact (bitwise): the bridge only transposes and flips.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from iterative_inference_segm_tpu.models import init_dae as j_init_dae  # noqa: E402
from iterative_inference_segm_tpu.models import init_fcn8 as j_init_fcn8  # noqa: E402
from iterative_inference_segm_tpu.models.registry import checkpoint_meta  # noqa: E402
from iterative_inference_segm_tpu.utils import checkpoint as jckpt  # noqa: E402
from iterative_inference_segm_tpu_torch.models.dae import init_dae  # noqa: E402
from iterative_inference_segm_tpu_torch.models.fcn8 import init_fcn8  # noqa: E402
from iterative_inference_segm_tpu_torch.utils import checkpoint as tckpt  # noqa: E402
from iterative_inference_segm_tpu_torch.utils.jax_bridge import (  # noqa: E402
    params_from_jax,
    params_to_jax,
)

C = 5
DAE_KW = dict(n_classes=C, h_specs={"pool4": 512}, depth=3, stem_pool=1, widths=(8, 16, 32))


def _randomized(tree, seed):
    """Random values in every leaf, so a wrong transpose or a missing flip shows."""
    rng = np.random.default_rng(seed)
    return {k: {kk: rng.normal(size=np.shape(v)).astype(np.float32) for kk, v in leaves.items()}
            for k, leaves in tree.items()}


def _models():
    jfcn = _randomized(j_init_fcn8(jax.random.PRNGKey(0), n_classes=C, fc_channels=16), 0)
    jdae = _randomized(j_init_dae(jax.random.PRNGKey(1), **DAE_KW), 1)
    tfcn = init_fcn8(torch.Generator().manual_seed(0), n_classes=C, fc_channels=16)
    tdae = init_dae(torch.Generator().manual_seed(1), **DAE_KW)
    return [("fcn8", jfcn, tfcn), ("dae", jdae, tdae)]


@pytest.mark.parametrize("which", ["fcn8", "dae"])
def test_jax_npz_loads_in_port(tmp_path, which):
    name, jtree, template = next(m for m in _models() if m[0] == which)
    path = tmp_path / f"{name}.npz"
    jckpt.save_npz(path, jtree, meta={"arch": name})
    got = tckpt.load_npz(path, template)
    want = params_from_jax(jtree)
    assert set(got) == set(template) == set(jtree)
    for layer, leaves in got.items():
        assert set(leaves) == set(template[layer])
        for leaf, t in leaves.items():
            assert t.shape == template[layer][leaf].shape
            assert t.dtype == template[layer][leaf].dtype
            assert torch.equal(t, want[layer][leaf])
    # layouts: HWIO conv -> OIHW; transposed convs (I, O, k, k) flipped
    if which == "fcn8":
        np.testing.assert_array_equal(got["conv1_1"]["w"].numpy(), jtree["conv1_1"]["w"].transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(
            got["upscore8"]["w"].numpy(), jtree["upscore8"]["w"][::-1, ::-1].transpose(2, 3, 0, 1)
        )


@pytest.mark.parametrize("which", ["fcn8", "dae"])
def test_port_npz_loads_in_jax(tmp_path, which):
    name, jtree, template = next(m for m in _models() if m[0] == which)
    path = tmp_path / f"{name}.npz"
    tckpt.save_npz(path, params_from_jax(jtree))
    back = jckpt.load_npz(path, jtree)
    for layer, leaves in jtree.items():
        for leaf, v in leaves.items():
            np.testing.assert_array_equal(np.asarray(back[layer][leaf]), v)
    # and the two trees are exact inverses
    round_trip = params_to_jax(params_from_jax(jtree))
    assert all(np.array_equal(round_trip[k][kk], v) for k, lv in jtree.items() for kk, v in lv.items())


def test_npz_meta_checked_like_jax(tmp_path):
    _, jdae, _ = _models()[1]
    path = tmp_path / "dae.npz"
    meta = checkpoint_meta("dae", h_taps=("pool4",), depth=3, stem_pool=1, widths=(8, 16, 32))
    jckpt.save_npz(path, jdae, meta=meta)
    assert tckpt.read_npz_meta(path) == jckpt.read_npz_meta(path)
    expect = {"arch": "dae", "encoder": "pool", "depth": 3, "stem_pool": 1, "tail": "full",
              "widths": (8, 16, 32)}
    tckpt.check_npz_meta(path, expect)
    with pytest.raises(ValueError, match="encoder"):
        tckpt.check_npz_meta(path, dict(expect, encoder="stride"))
    with pytest.warns(UserWarning, match="no metadata"):
        tckpt.check_npz_meta(path, {"arch": "dae", "unknown_knob": 1})
    # meta stamped by the port reads back the same in the JAX package
    tckpt.save_npz(tmp_path / "port.npz", params_from_jax(jdae), meta=meta)
    assert jckpt.read_npz_meta(tmp_path / "port.npz") == jckpt.read_npz_meta(path)


def test_load_npz_rejects_missing_and_misshapen(tmp_path):
    _, jdae, tdae = _models()[1]
    path = tmp_path / "dae.npz"
    jckpt.save_npz(path, {k: v for k, v in jdae.items() if k != "out"})
    with pytest.raises(KeyError, match="out"):
        tckpt.load_npz(path, tdae)
    wide = init_dae(torch.Generator(), **dict(DAE_KW, widths=(8, 16, 64)))
    jckpt.save_npz(path, jdae)
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.load_npz(path, wide)
