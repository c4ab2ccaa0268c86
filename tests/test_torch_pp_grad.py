"""Gradients through the port's pipeline (``parallel.pp``) against
``jax.grad`` in the JAX package: the two-stage heterogeneous toy
(``make_gpipe``) and four homogeneous stages (``make_gpipe_stacked``, also
stage-resident) against JAX's pipelines on matched meshes; the flagship at 2
stages in score and energy mode (``make_pp_flagship``, the gradient in the
FCN-8 and the DAE params: in energy mode the FCN-8's reaches it through y0
and the closed-over features, past the DAE's own gradient) and DP x PP on
('data', 'stage') of (2, 2)
against ``jax.grad`` of JAX's sequential flagship on the same images, which
``tests/test_pp.py`` holds equal to its pipeline's at the tolerance below
(a JAX flagship pipeline's gradient takes ~40 s to compile on the CPU, the
sequential one ~10 s); ``remat=True`` against ``remat=False``. The port
runs in gloo ranks (two launches, started together), the JAX side on
faked CPU devices while the ranks run.

Tolerances: the JAX tests' own (``tests/test_pp.py``): the toys within
rtol 1e-4 / atol 1e-5 of JAX, the flagship within rtol 1e-4 / atol 1e-6 in
the DAE params; ``remat`` against no ``remat`` within rtol 1e-5 / atol
1e-6. The flagship's FCN-8 gradients are held per leaf in norm to 1e-4 of
the leaf's JAX gradient: across the two packages a ReLU pre-activation that
lies within their rounding of 0 moves single entries of an FCN-8 conv
gradient (``tests/test_torch_parallel.py`` holds FCN-8 steps so for the
same reason); the entrywise check stays on the DAE, whose gradient is the
one JAX's test holds.
"""

import concurrent.futures

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from iterative_inference_segm_tpu.inference.fused import flagship_forward_fn  # noqa: E402
from iterative_inference_segm_tpu.parallel import make_gpipe, make_gpipe_stacked, make_mesh  # noqa: E402
from iterative_inference_segm_tpu_torch.parallel.launch import launch_ranks  # noqa: E402
from iterative_inference_segm_tpu_torch.parallel.mesh import MeshSpec  # noqa: E402

import torch_parallel_ranks as ranks  # noqa: E402
from torch_port_helpers import jax_params  # noqa: E402

TOY = dict(rtol=1e-4, atol=1e-5)
FLAG = dict(rtol=1e-4, atol=1e-6)
REMAT = dict(rtol=1e-5, atol=1e-6)
FCN_NORM = 1e-4
HALF = dict(eps=0.1, depth=3, num_steps=2)


def jmesh(names, sizes):
    return make_mesh(names, sizes, devices=jax.devices()[: int(np.prod(sizes))])


def images(n, seed):
    return np.random.default_rng(seed).normal(size=(n, 48, 64, 3)).astype(np.float32)


def toy():
    ks = tuple(np.asarray(jax.random.normal(jax.random.PRNGKey(i), (4, 4))) for i in (0, 1))
    return ks, np.asarray(jax.random.normal(jax.random.PRNGKey(5), (3, 2, 4)))


def stacked(s):
    return (np.asarray(jax.random.normal(jax.random.PRNGKey(3), (s, 4, 4))),
            np.asarray(jax.random.normal(jax.random.PRNGKey(4), (6, 2, 4))))


@pytest.fixture(scope="module")
def params():
    jf, jd = jax_params()
    return jax.device_get(jf), jax.device_get(jd)


def port_runs(p):
    jf, jd = p
    ks, x = toy()
    ks4, x4 = stacked(4)
    ks2, _ = stacked(2)
    flag = {"jfcn": jf, "jdae": jd, "images": images(2, 2), "microbatches": 2}
    two = [
        ("toy", "gpipe_grad", {"params": ks, "x": x}),
        ("toy_remat", "gpipe_grad", {"params": ks, "x": x, "remat": True}),
        ("score", "flagship_grad", dict(flag, kw=HALF)),
        ("score_remat", "flagship_grad", dict(flag, kw=HALF, remat=True)),
        ("energy", "flagship_grad", dict(flag, kw=dict(HALF, mode="energy"))),
        ("energy_remat", "flagship_grad", dict(flag, kw=dict(HALF, mode="energy"), remat=True)),
        ("resident", "stacked_grad", {"stacked": ks2, "x": x4, "resident": True}),
    ]
    four = [
        ("stacked4", "stacked_grad", {"stacked": ks4, "x": x4, "mesh_shape": (("stage",), (4,))}),
        ("stacked4_remat", "stacked_grad", {"stacked": ks4, "x": x4, "remat": True,
                                            "mesh_shape": (("stage",), (4,))}),
        ("dpxpp", "flagship_grad", dict(flag, microbatches=1, kw=HALF, batch_axis="data")),
    ]
    with concurrent.futures.ThreadPoolExecutor(2) as pool:  # the two groups start together
        runs = {size: pool.submit(launch_ranks, ranks.run_cases, cases, mesh=MeshSpec(names, sizes), device="cpu")
                for size, names, sizes, cases in ((2, ("stage",), (2,), two), (4, ("data", "stage"), (2, 2), four))}
        return {size: run.result() for size, run in runs.items()}


def jax_runs(p):
    jf, jd = p
    out = {}
    ks, x = toy()

    def s0(q, w, x):
        return {**w, "a": jnp.tanh(x["a"] @ q)}

    def s1(q, w, x):
        return {**w, "a": w["a"] @ q + 1.0}

    het = make_gpipe((s0, s1), jmesh(("stage",), (2,)))
    out["toy"] = jax.grad(lambda q, xx: jnp.sum(het(q, {"a": xx}, {"a": jnp.zeros(x.shape[1:])})["a"] ** 2),
                          argnums=(0, 1))(ks, x)

    def stage(q, w):
        return {**w, "a": jnp.tanh(w["a"] @ q)}

    for name, s in (("stacked4", 4), ("stacked2", 2)):
        kq, xq = stacked(s)
        pipe = make_gpipe_stacked(stage, jmesh(("stage",), (s,)))
        out[name] = np.asarray(jax.grad(lambda q: jnp.sum(pipe(q, {"a": xq})["a"] ** 2))(kq))

    def flagship(wrt=(0, 1), **kw):
        fwd = flagship_forward_fn(compute_dtype=jnp.float32, fold_tail=None, **HALF, **kw)
        x = jnp.asarray(images(2, 2))

        def loss(f, d):
            return jnp.mean(jnp.square(fwd(f, d, x)[1]))

        value, grads = jax.jit(jax.value_and_grad(loss, argnums=wrt))(jf, jd)
        return float(value), dict(zip([("fcn", "dae")[i] for i in wrt], jax.device_get(grads)))

    out["score"] = flagship()
    out["energy"] = flagship(mode="energy")
    out["dpxpp"] = out["score"]  # the same loss on the same images
    return out


@pytest.fixture(scope="module")
def both(params):
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(port_runs, params)
        want = jax_runs(params)
        got = port.result()
    return got, want


def leaves(tree):
    return [(f"{k}/{kk}", np.asarray(v)) for k, layer in sorted(tree.items()) for kk, v in sorted(layer.items())]


def hold_flagship(got, want):
    value, grads = want
    np.testing.assert_allclose(got["loss"], value, rtol=1e-5)
    for (name, a), (_, b) in zip(leaves(got["dae"]), leaves(grads["dae"])):
        np.testing.assert_allclose(a, b, **FLAG, err_msg=name)
    for (name, a), (_, b) in zip(leaves(got.get("fcn", {})), leaves(grads.get("fcn", {}))):
        assert np.linalg.norm(a - b) <= FCN_NORM * max(np.linalg.norm(b), 1e-12), name
    assert ("fcn" in got) == ("fcn" in grads)


def test_gpipe_grad_matches_jax(both):
    """Two heterogeneous stages, M = 3: the gradient in both stages' params
    and in the stream, on every rank (the stages' sum over the group)."""
    for res in both[0][2]:
        for a, b in zip(res["toy"], [*both[1]["toy"][0], both[1]["toy"][1]]):
            np.testing.assert_allclose(a, np.asarray(b), **TOY)


def test_gpipe_stacked_grad_matches_jax(both):
    """Four stages on 4 ranks, each reading its slice of the stacked params;
    each rank returns the whole gradient."""
    for res in both[0][4]:
        np.testing.assert_allclose(res["stacked4"]["grad"], both[1]["stacked4"], **TOY)


def test_gpipe_stacked_resident_grad_is_the_ranks_slice(both):
    """With per-stage residency each rank holds its slice and its slice's
    gradient, JAX's gradient sharded over 'stage'."""
    for res in both[0][2]:
        r = res["resident"]
        assert r["grad"].shape == (1, 4, 4)
        np.testing.assert_allclose(r["grad"][0], both[1]["stacked2"][r["stage"]], **TOY)


@pytest.mark.parametrize("mode", ["score", "energy"])
def test_pp_flagship_grad_matches_jax(both, mode):
    """FCN forward | pooled refinement on 2 ranks: the loss on y_K and its
    gradient in both networks' params, so the wire's gradient crosses back
    to stage 0 (energy: through the DAE's own gradient, which the refinement
    stage builds with ``create_graph``)."""
    for res in both[0][2]:
        hold_flagship(res[mode], both[1][mode])


@pytest.mark.parametrize("case", ["toy", "score", "energy", "stacked4"])
def test_remat_grads_equal_plain_grads(both, case):
    """``remat=True`` recomputes each stage in the backward: the same
    gradients as keeping the stage's graph."""
    runs = both[0][4] if case == "stacked4" else both[0][2]
    for res in runs:
        a, b = res[case], res[f"{case}_remat"]
        if case == "toy":
            pairs = list(zip(a, b))
        elif case == "stacked4":
            pairs = [(a["grad"], b["grad"])]
        else:
            pairs = [(x, y) for net in ("fcn", "dae") if net in a
                     for (_, x), (_, y) in zip(leaves(a[net]), leaves(b[net]))]
        for x, y in pairs:
            np.testing.assert_allclose(y, x, **REMAT)


def test_pp_flagship_grad_composes_with_dp(both):
    """('data', 'stage') of (2, 2): each rank's 'data' block of the
    cotangent, the gradients summed over 'data' and 'stage'."""
    for res in both[0][4]:
        hold_flagship(res["dpxpp"], both[1]["dpxpp"])
