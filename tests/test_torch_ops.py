"""The port's ops (``iterative_inference_segm_tpu_torch.ops.conv``) against the
JAX package's, on the same numpy inputs, in f32 on the CPU.

Tolerance: rtol = atol = 1e-5 — both sides compute in full f32 and differ
only in summation order.
"""

import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from iterative_inference_segm_tpu.ops import conv as jconv  # noqa: E402
from iterative_inference_segm_tpu_torch.ops import conv as tconv  # noqa: E402
from iterative_inference_segm_tpu_torch.utils.jax_bridge import params_from_jax  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _port(layer, w, b=None):
    """One JAX-layout layer through the bridge (``up*`` names are transposed convs)."""
    leaves = {"w": w} if b is None else {"w": w, "b": b}
    return params_from_jax({layer: leaves})[layer]


@pytest.mark.parametrize(
    "hw,k,stride,padding",
    [
        ((12, 16), 3, 1, "SAME"),
        ((12, 16), 3, 2, "SAME"),  # even input: JAX pads (0, 1)
        ((13, 17), 3, 2, "SAME"),  # odd input: (1, 1)
        ((12, 16), 1, 1, "SAME"),
        ((14, 15), 7, 1, "SAME"),  # fc6's 7x7
        ((12, 16), 3, 1, "VALID"),
        ((12, 16), 3, 1, ((2, 0), (1, 1))),
    ],
)
def test_conv2d_matches_jax(hw, k, stride, padding):
    x, w, b = _rand((2, *hw, 5), 0), _rand((k, k, 5, 6), 1), _rand((6,), 2)
    want = jconv.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride, padding=padding)
    p = _port("conv", w, b)
    got = tconv.conv2d(torch.from_numpy(x), p["w"], p["b"], stride=stride, padding=padding)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_conv2d_stride2_same_is_not_symmetric_padding():
    """The trap the explicit pads guard: torch's padding=1 shifts the
    stride-2 output on an even input by one pixel."""
    x, w = _rand((1, 12, 16, 3), 3), _rand((3, 3, 3, 4), 4)
    p = _port("conv", w)
    got = tconv.conv2d(torch.from_numpy(x), p["w"], stride=2, padding="SAME")
    naive = F.conv2d(torch.from_numpy(x).permute(0, 3, 1, 2), p["w"], stride=2, padding=1)
    assert got.shape == naive.permute(0, 2, 3, 1).shape
    assert not torch.allclose(got, naive.permute(0, 2, 3, 1), atol=1e-3)


@pytest.mark.parametrize("k,stride,hw", [(4, 2, (6, 7)), (16, 8, (3, 4)), (3, 2, (5, 6))])
def test_conv_transpose2d_matches_jax(k, stride, hw):
    """Random non-symmetric kernels: the bilinear init would hide a missing flip."""
    x, w = _rand((2, *hw, 5), 5), _rand((k, k, 5, 4), 6)
    want = jconv.conv_transpose2d(jnp.asarray(x), jnp.asarray(w), stride=stride)
    want_dilated = jconv._conv_transpose2d_dilated(jnp.asarray(x), jnp.asarray(w), stride=stride)
    got = tconv.conv_transpose2d(torch.from_numpy(x), _port("up", w)["w"], stride=stride)
    assert tuple(got.shape) == (2, hw[0] * stride, hw[1] * stride, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_dilated), **TOL)
    # the flip is load-bearing: the same weights without it disagree
    unflipped = torch.from_numpy(w.transpose(2, 3, 0, 1).copy())
    wrong = tconv.conv_transpose2d(torch.from_numpy(x), unflipped, stride=stride)
    assert not np.allclose(wrong.numpy(), np.asarray(want), atol=1e-3)


@pytest.mark.parametrize(
    "hw,ceil_mode", [((45, 30), True), ((23, 30), True), ((12, 16), True), ((45, 31), False)]
)
def test_max_pool_matches_jax(hw, ceil_mode):
    x = _rand((2, *hw, 3), 7)
    want = jconv.max_pool(jnp.asarray(x), window=2, stride=2, ceil_mode=ceil_mode)
    got = tconv.max_pool(torch.from_numpy(x), window=2, stride=2, ceil_mode=ceil_mode)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_max_pool_ceil_chain_360():
    shapes = []
    x = torch.zeros((1, 360, 480, 1))
    for _ in range(5):
        x = tconv.max_pool(x)
        shapes.append(tuple(x.shape[1:3]))
    assert shapes == [(180, 240), (90, 120), (45, 60), (23, 30), (12, 15)]


@pytest.mark.parametrize("c", [5, 96])  # JAX takes its conv form for c <= 64
def test_avg_pool_matches_jax(c):
    x = _rand((2, 12, 16, c), 8)
    want = jconv.avg_pool(jnp.asarray(x), window=2, stride=2)
    got = tconv.avg_pool(torch.from_numpy(x), window=2, stride=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("target", [(10, 13), (12, 16), (7, 9)])
def test_crop_to_matches_jax(target):
    x = _rand((2, 12, 16, 3), 9)
    want = jconv.crop_to(jnp.asarray(x), *target)
    got = tconv.crop_to(torch.from_numpy(x), *target)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        tconv.crop_to(torch.from_numpy(x), 13, 16)


@pytest.mark.parametrize("k", [3, 4, 16])
def test_bilinear_kernel_matches_jax(k):
    want = np.asarray(jconv.bilinear_kernel(k, 4, 3))
    got = tconv.bilinear_kernel(k, 4, 3)
    np.testing.assert_array_equal(got.numpy(), _port("up", want)["w"].numpy())
    init = tconv.init_conv_transpose_bilinear(k, 4, 3)
    assert set(init) == {"w"} and torch.equal(init["w"], got)


@pytest.mark.parametrize("scale,std", [("he", np.sqrt(2.0 / (9 * 64))), ("glorot", np.sqrt(2.0 / (9 * 64 + 9 * 128)))])
def test_init_conv_shapes_and_scale(scale, std):
    p = tconv.init_conv(torch.Generator().manual_seed(0), 3, 3, 64, 128, scale=scale)
    assert tuple(p["w"].shape) == (128, 64, 3, 3) and tuple(p["b"].shape) == (128,)
    assert torch.count_nonzero(p["b"]) == 0
    assert abs(float(p["w"].std()) / std - 1.0) < 0.03
    again = tconv.init_conv(torch.Generator().manual_seed(0), 3, 3, 64, 128, scale=scale)
    assert torch.equal(p["w"], again["w"])
    with pytest.raises(ValueError):
        tconv.init_conv(torch.Generator(), 1, 1, 1, 1, scale="xavier")


def test_port_imports_no_jax():
    """Every module of the port imports with jax and the JAX package blocked:
    the machine with the card has neither."""
    code = r"""
import importlib, pkgutil, sys
BLOCKED = ("jax", "jaxlib", "optax", "orbax", "iterative_inference_segm_tpu")
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import iterative_inference_segm_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
leaked = sorted(n for n in sys.modules if n.split(".")[0] in BLOCKED)
assert not leaked, leaked
print(" ".join(mods))
"""
    root = str(__import__("pathlib").Path(__file__).resolve().parent.parent)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=root, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    walked = set(out.stdout.split())
    assert len(walked) >= 34  # every module was walked, these among them:
    for mod in ("inference.iterative", "inference.search", "ops.vpu_probe", "tools.vpu_probe",
                "tools.profile_general", "tools.tail_bench", "scripts.iterative_inference", "parallel.spatial",
                "entry", "tools.tailfold_probe", "tools.tail2_probe", "tools.scan_variants_probe", "tools.int8_probe",
                "tools.aug_probe", "tools.aug_order_probe", "tools.aug_step_probe"):
        assert "iterative_inference_segm_tpu_torch." + mod in walked, mod
