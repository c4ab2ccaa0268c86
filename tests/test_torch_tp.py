"""The port's fc6/fc7 tensor parallelism (``parallel.tp``) against the JAX
package on the same inputs: 2 gloo ranks on a ('model',) mesh, and on a
('data', 'model') mesh of (1, 2) for the composition. JAX's TP layout is
GSPMD shardings on untouched ``fcn8_apply``, which ``tests/test_tp.py`` holds
to the replicated run; so the port's TP run is held to JAX's replicated
``fcn8_apply``/``fcn8_logits`` and ``jax.grad``.

Tolerances (f32): probabilities and logits within 1e-5 of the largest
value; each gradient leaf within 1e-5 of its largest entry (the rank's
slice of fc6/fc7 against the same slice of JAX's); the loss within 1e-5
relative; after one Adam step, each rank's fc6/fc7 slices moved by one
step (lr) at most and Adam's moments shaped as the slices (sharded).
"""

import concurrent.futures

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from iterative_inference_segm_tpu.models import fcn8 as jfcn8  # noqa: E402
from iterative_inference_segm_tpu.ops.losses import masked_crossentropy as j_xent  # noqa: E402
from iterative_inference_segm_tpu.parallel.mesh import make_mesh as j_make_mesh  # noqa: E402
from iterative_inference_segm_tpu.parallel.tp import tp_shardings as j_tp_shardings  # noqa: E402
from iterative_inference_segm_tpu_torch.parallel.launch import launch_ranks  # noqa: E402
from iterative_inference_segm_tpu_torch.parallel.mesh import MeshSpec  # noqa: E402

import torch_parallel_ranks as ranks  # noqa: E402
from torch_port_helpers import jax_params  # noqa: E402

N = 2
C = 5
FC = 16
LR = 1e-3


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    jfcn = jax.device_get(jax_params()[0])
    x = rng.random((2, 48, 64, 3), dtype=np.float32)
    y = rng.integers(0, C + 1, (2, 48, 64)).astype(np.int32)
    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)
    shape = (2, 2, 2, FC)  # fc_shape of a 48x64 batch of 2
    masks = tuple(np.array(jax.random.bernoulli(k, 0.5, shape)) for k in (k1, k2))
    return dict(jfcn=jfcn, x=x, y=y, key=key, masks=masks)


def jax_side(d):
    """Jitted (one compile each, kept by the persistent cache; op by op,
    every op compiles afresh in every run)."""
    p, x = d["jfcn"], jnp.asarray(d["x"])
    probs = jax.jit(lambda pp, xx: jfcn8.fcn8_apply(pp, xx)[0])(p, x)

    def loss_fn(pp, xx, yy):
        return j_xent(jfcn8.fcn8_logits(pp, xx), yy, n_classes=C)

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(p, x, jnp.asarray(d["y"]))
    masked = jax.jit(lambda pp, xx, k: jfcn8.fcn8_logits(pp, xx, dropout_rng=k))(p, x, d["key"])
    return {"probs": np.asarray(probs), "logits_masked": np.asarray(masked),
            "loss": float(loss), "grads": jax.device_get(grads)}


@pytest.fixture(scope="module")
def both(data):
    cases = [("tp", "tp_cases", {"jparams": data["jfcn"], "images": data["x"], "labels": data["y"],
                                 "masks": data["masks"], "lr": LR}),
             ("tp_data", "tp_with_data", {"jparams": data["jfcn"], "images": data["x"]})]
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(launch_ranks, ranks.run_cases, cases, mesh=MeshSpec(("model",), (N,)), device="cpu")
        want = jax_side(data)
        got = port.result()
    return got, want


def close(got, want, err=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()), err_msg=err)


def rank_slice(leaf, layer, k, r):
    """Rank r's part of a JAX-layout (HWIO) leaf under the TP layout."""
    leaf = np.asarray(leaf)
    if layer == "fc6":
        n = leaf.shape[-1] // N
        return leaf[..., r * n : (r + 1) * n]
    if layer == "fc7" and k == "w":
        n = leaf.shape[2] // N
        return leaf[:, :, r * n : (r + 1) * n, :]
    return leaf


def test_tp_shardings_layout(both):
    """fc6 column-parallel (OIHW dim 0 = JAX's output dim), fc7 row-parallel
    (dim 1 = JAX's input dim), fc7's bias and the rest replicated, as
    ``tp_shardings`` places them in the JAX package."""
    spec = j_tp_shardings(jax_params()[0], j_make_mesh(("data", "model"), (1, 2), devices=jax.devices()[:2]))
    assert str(spec["fc6"]["w"].spec) == "PartitionSpec(None, None, None, 'model')"
    assert both[0][0]["tp"]["layout"] == {
        "fc6": {"w": ["Shard(0)"], "b": ["Shard(0)"]},
        "fc7": {"w": ["Shard(1)"], "b": ["Replicate"]},
        "conv1_1": {"w": ["Replicate"], "b": ["Replicate"]},
    }


def test_tp_requires_a_divisible_fc_width(both):
    assert both[0][0]["tp"]["indivisible"] == "ValueError: fc_channels 17 not divisible by mesh axis 'model' size 2"


def test_each_rank_holds_half_of_fc6_and_fc7(both):
    for r, res in enumerate(both[0]):
        got = res["tp"]
        assert got["model_index"] == r
        assert got["shapes"] == {"fc6": (FC // N, 512, 7, 7), "fc7": (FC, FC // N, 1, 1), "score_fr": (C, FC, 1, 1)}
        whole = (FC * 512 * 49 + FC + FC * FC + FC) * 4
        assert got["bytes"] == (FC // N * 512 * 49 + FC // N + FC * FC // N + FC) * 4 < whole


def test_tp_forward_matches_replicated(both):
    for res in both[0]:
        close(res["tp"]["probs"], both[1]["probs"])


def test_tp_dropout_takes_the_ranks_slice_of_the_whole_mask(both):
    for res in both[0]:
        close(res["tp"]["logits_masked"], both[1]["logits_masked"])


def test_tp_gradients_match_and_stay_sharded(both):
    """The backbone's gradients are whole on each rank (fc6's input adjoint
    sums them); fc6/fc7's are the rank's slices of JAX's."""
    want = both[1]
    for r, res in enumerate(both[0]):
        got = res["tp"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        for layer, lv in want["grads"].items():
            for k, g in lv.items():
                close(got["grads"][layer][k], rank_slice(g, layer, k, r), f"rank {r} {layer}/{k}")


def test_tp_train_step_shards_optimizer_state(both):
    """One Adam step: the moments of fc6/fc7 have the slices' shapes; the
    updated slices move by at most one step from the start."""
    for r, res in enumerate(both[0]):
        got = res["tp"]
        assert got["moments"] == {"fc6": (FC // N, 512, 7, 7), "fc7": (FC, FC // N, 1, 1), "conv1_1": (64, 3, 3, 3)}
        for layer in ("fc6", "fc7"):
            start = rank_slice(jax_params()[0][layer]["w"], layer, "w", r)
            step = np.abs(got["params"][layer]["w"] - start)
            assert step.max() <= LR * (1 + 1e-3) and step.max() > 0.5 * LR


def test_tp_composes_with_a_data_axis(both):
    for res in both[0]:
        close(res["tp_data"], both[1]["probs"])
