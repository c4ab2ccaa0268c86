"""The port's pipeline (``parallel.pp``, serving) against the JAX package on
the same inputs and (bridged) weights: ``make_gpipe`` and
``make_gpipe_stacked`` on toy stages, ``make_pp_flagship`` at 2 stages (2
gloo ranks) and 3 stages (3 ranks) on the half and the general engine,
DP x PP on a ('data', 'stage') mesh of (2, 2) (4 ranks), and
``Predictor(pp_mesh=...)``, all in one launch of 4 ranks (the 2- and
3-stage meshes over its first ranks); the JAX side runs on as many faked
CPU devices.
The toy's gradient is held here too; ``tests/test_torch_pp_grad.py`` holds
the gradients of the rest.

Tolerances: f32 within 1e-4 (relative and absolute), the whole-path
tolerance the port's sequential flagship is held to JAX's with
(``tests/test_torch_flagship.py``; the toy stages within 1e-5); bf16
within 0.1 with argmax agreement >= 98%, as the port's bf16 flagship is held
to JAX's (``tests/test_torch_flagship.py``); the mirror DAE statistically,
within 5e-3 with argmax agreement >= 99.9%, as ``tests/test_pp.py`` holds
JAX's own pipelined mirror (its unpool switches move on ties).
"""

import concurrent.futures

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from iterative_inference_segm_tpu.inference import make_refiner  # noqa: E402
from iterative_inference_segm_tpu.inference.fused import flagship_forward_fn  # noqa: E402
from iterative_inference_segm_tpu.inference.predictor import Predictor as JPredictor  # noqa: E402
from iterative_inference_segm_tpu.models import fcn8_apply  # noqa: E402
from iterative_inference_segm_tpu.models.registry import init_score_template, score_apply_fn  # noqa: E402
from iterative_inference_segm_tpu.parallel import make_gpipe, make_gpipe_stacked, make_mesh  # noqa: E402
from iterative_inference_segm_tpu.parallel import merge_microbatches as j_merge  # noqa: E402
from iterative_inference_segm_tpu.parallel import split_microbatches as j_split  # noqa: E402
from iterative_inference_segm_tpu_torch.data import config_datasets as tcfg  # noqa: E402
from iterative_inference_segm_tpu_torch.parallel import pp as tpp  # noqa: E402
from iterative_inference_segm_tpu_torch.parallel.launch import launch_ranks  # noqa: E402
from iterative_inference_segm_tpu_torch.parallel.mesh import MeshSpec  # noqa: E402

import torch_parallel_ranks as ranks  # noqa: E402
from torch_port_helpers import TINY_J, TINY_T, jax_params  # noqa: E402

C = 5
F32 = dict(rtol=1e-4, atol=1e-4)
HALF = dict(eps=0.1, depth=3)
GENERAL = dict(eps=0.1, num_steps=3, depth=4, engine="general")


def jmesh(names, sizes):
    return make_mesh(names, sizes, devices=jax.devices()[: int(np.prod(sizes))])


def images(n, seed):
    return np.random.default_rng(seed).normal(size=(n, 64, 64, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def params():
    g = jax.device_get
    jf, jd = jax_params()
    mirror = init_score_template("mirror", jax.random.PRNGKey(1), n_classes=C, depth=4, widths=(8, 16, 32, 64))
    return {"jf": g(jf), "jd": g(jd), "jd_q": g(jax_params(stem_pool=2)[1]),
            "jd_g": g(jax_params(stem_pool=0, depth=4)[1]), "mirror": g(mirror)}


def toy():
    k0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (4, 4)))
    k1 = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (4, 4)))
    xs = [np.asarray(jax.random.normal(jax.random.PRNGKey(m), (m, 2, 4))) for m in (4, 1, 7)]
    return (k0, k1), xs


def stacked_inputs(s):
    return (np.asarray(jax.random.normal(jax.random.PRNGKey(3), (s, 4, 4))),
            np.asarray(jax.random.normal(jax.random.PRNGKey(4), (6, 4, 4))))


def port_runs(p):
    (k0, k1), xs = toy()
    ks4, x4 = stacked_inputs(4)
    ks2, _ = stacked_inputs(2)
    two = [
        ("toy", "gpipe_toy", {"params": (k0, k1), "xs": xs}),
        ("stacked_resident", "gpipe_stacked", {"stacked": ks2, "x": x4, "resident": True}),
        ("f32", "flagship", {"jfcn": p["jf"], "jdae": p["jd"], "images": images(8, 2), "microbatches": 4,
                             "kw": dict(num_steps=3, **HALF)}),
        ("bf16", "flagship", {"jfcn": p["jf"], "jdae": p["jd"], "images": images(4, 6), "microbatches": 2,
                              "kw": dict(num_steps=3, compute_dtype="bfloat16", **HALF)}),
        ("quarter", "flagship", {"jfcn": p["jf"], "jdae": p["jd_q"], "images": images(4, 2), "microbatches": 2,
                                 "kw": dict(num_steps=2, **HALF)}),
        ("energy", "flagship", {"jfcn": p["jf"], "jdae": p["jd"], "images": images(4, 2), "microbatches": 2,
                                "kw": dict(num_steps=2, mode="energy", **HALF)}),
        ("stride", "flagship", {"jfcn": p["jf"], "jdae": p["jd"], "images": images(4, 2), "microbatches": 2,
                                "kw": dict(num_steps=2, encoder="stride", **HALF)}),
        ("general", "flagship", {"jfcn": p["jf"], "jdae": p["jd_g"], "images": images(4, 8), "microbatches": 2,
                                 "kw": GENERAL}),
        ("mirror", "flagship", {"jfcn": p["jf"], "jdae": p["mirror"], "images": images(4, 9), "microbatches": 2,
                                "kw": dict(GENERAL, num_steps=2, dae_arch="mirror")}),
        ("predictor", "predictor_pp", {"cfg": TINY_T, "jfcn": p["jf"], "jdae": p["jd"], "images": images(6, 11),
                                       "kw": dict(batch_size=4, num_steps=2, eps=0.3, engine="half",
                                                  pp_microbatches=2, dae_kwargs={"depth": 3})}),
    ]
    three = [
        ("half3", "flagship", {"jfcn": p["jf"], "jdae": p["jd"], "images": images(6, 7), "microbatches": 3,
                               "kw": dict(num_steps=3, **HALF)}),
        ("general3", "flagship", {"jfcn": p["jf"], "jdae": p["jd_g"], "images": images(6, 10), "microbatches": 3,
                                  "kw": dict(GENERAL, num_steps=2)}),
        ("errors3", "flagship_errors", {}),
    ]
    four = [
        ("dpxpp", "flagship", {"jfcn": p["jf"], "jdae": p["jd"], "images": images(8, 2), "microbatches": 4,
                               "kw": dict(num_steps=3, **HALF), "batch_axis": "data"}),
        ("stacked_dp", "gpipe_stacked", {"stacked": ks2, "x": stacked_inputs(2)[1][:3], "batch_axis": "data"}),
        ("stacked4", "gpipe_stacked", {"stacked": ks4, "x": x4, "mesh_shape": (("stage",), (4,))}),
        ("misuse", "pipeline_misuse", {}),
    ]
    groups = [(("stage",), (2,), two), (("stage",), (3,), three), (("data", "stage"), (2, 2), four)]
    # one launch of 4 ranks; each group on a mesh over its first ranks
    got = launch_ranks(ranks.run_groups, groups, mesh=MeshSpec(("data",), (4,)), device="cpu")
    return {sizes: [res[sizes] for res in got[: int(np.prod(sizes))]] for _, sizes, _ in groups}


def jax_runs(p):
    out = {}
    (k0, k1), xs = toy()

    def s0(q, w, x):
        return {**w, "a": jnp.tanh(x["a"] @ q)}

    def s1(q, w, x):
        return {**w, "a": w["a"] @ q + 1.0}

    pipe = jax.jit(make_gpipe((s0, s1), jmesh(("stage",), (2,))))
    out["toy"] = [np.asarray(pipe((k0, k1), {"a": x}, {"a": jnp.zeros(x.shape[1:])})["a"]) for x in xs]
    out["toy_grad"] = np.asarray(jax.grad(lambda k: jnp.sum(
        pipe((k, k1), {"a": xs[0]}, {"a": jnp.zeros(xs[0].shape[1:])})["a"] ** 2))(k0))

    def stage(q, w):
        return {**w, "a": jnp.tanh(w["a"] @ q)}

    ks4, x4 = stacked_inputs(4)
    ks2, x6 = stacked_inputs(2)
    out["stacked4"] = np.asarray(make_gpipe_stacked(stage, jmesh(("stage",), (4,)))(ks4, {"a": x4})["a"])
    out["stacked_resident"] = np.asarray(make_gpipe_stacked(stage, jmesh(("stage",), (2,)))(ks2, {"a": x4})["a"])
    out["stacked_dp"] = np.asarray(make_gpipe_stacked(stage, jmesh(("data", "stage"), (2, 2)), batch_axis="data")(
        ks2, {"a": x6[:3]})["a"])

    def seq(dae, x, **kw):
        y0, yk = jax.jit(flagship_forward_fn(**kw))(p["jf"], dae, jnp.asarray(x))
        return np.asarray(y0.astype(jnp.float32)), np.asarray(yk.astype(jnp.float32))

    f32 = dict(compute_dtype=jnp.float32, **HALF)
    out["f32"] = seq(p["jd"], images(8, 2), num_steps=3, **f32)
    out["dpxpp"] = out["f32"]
    out["bf16"] = seq(p["jd"], images(4, 6), num_steps=3, **HALF)
    out["quarter"] = seq(p["jd_q"], images(4, 2), num_steps=2, fold_tail=None, **f32)
    out["energy"] = seq(p["jd"], images(4, 2), num_steps=2, fold_tail=None, mode="energy", **f32)
    out["stride"] = seq(p["jd"], images(4, 2), num_steps=2, fold_tail=None, encoder="stride", **f32)
    out["half3"] = seq(p["jd"], images(6, 7), num_steps=3, **f32)

    def general(arch, dae, x, k):
        r = make_refiner(fcn8_apply, score_apply_fn(arch), p["jf"], dae, eps=0.1, num_steps=k, h_taps=("pool4",),
                         compute_dtype=jnp.float32, dae_kwargs={"depth": 4})
        return tuple(np.asarray(a) for a in r(jnp.asarray(x)))

    out["general"] = general("dae", p["jd_g"], images(4, 8), 3)
    out["mirror"] = general("mirror", p["mirror"], images(4, 9), 2)
    out["general3"] = general("dae", p["jd_g"], images(6, 10), 2)
    jp = JPredictor(p["jf"], p["jd"], dataset=TINY_J, compute_dtype=jnp.float32, pp_mesh=jmesh(("stage",), (2,)),
                    batch_size=4, num_steps=2, eps=0.3, engine="half", pp_microbatches=2, dae_kwargs={"depth": 3})
    out["predictor"] = jp.predict(images(6, 11), return_probs=True)
    return out


@pytest.fixture(scope="module")
def both(params):
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        port = pool.submit(port_runs, params)
        want = jax_runs(params)
        got = port.result()
    return got, want


def two(both):
    return both[0][(2,)]


def test_microbatch_split_merge_roundtrip():
    x = torch.arange(24.0).reshape(12, 2)
    xm = tpp.split_microbatches(x, 4)
    assert tuple(xm.shape) == (4, 3, 2)
    assert torch.equal(tpp.merge_microbatches(xm), x)
    np.testing.assert_array_equal(xm.numpy(), np.asarray(j_split(jnp.arange(24.0).reshape(12, 2), 4)))
    np.testing.assert_array_equal(tpp.merge_microbatches({"a": xm})["a"].numpy(), np.asarray(j_merge(j_split(
        jnp.arange(24.0).reshape(12, 2), 4))))
    with pytest.raises(ValueError, match="not divisible by num_microbatches 5"):
        tpp.split_microbatches(x, 5)


@pytest.mark.parametrize("i,m", [(0, 4), (1, 1), (2, 7)], ids=["M4", "M1", "M7"])
def test_gpipe_heterogeneous_matches_jax(both, i, m):
    """Every bubble ratio, M = 1 (all bubble) to M >> S; on every rank."""
    for res in two(both):
        np.testing.assert_allclose(res["toy"]["out"][i], both[1]["toy"][i], rtol=1e-5, atol=1e-6)


def test_gpipe_hands_over_one_wire_per_microbatch(both):
    """Stage 0 sends each microbatch's one-leaf wire once; the last stage
    sends nothing (it broadcasts the result)."""
    sends = [res["toy"]["isend_calls"] for res in two(both)]
    assert sends == [4 + 1 + 7, 0] and [res["toy"]["stage"] for res in two(both)] == [0, 1]


@pytest.mark.parametrize("case,match", [
    ("count", "3 stage fns for a 2-wide 'stage' axis"), ("no_axis", "has no 'stage' axis"),
    ("no_axis_stacked", "has no 'stage' axis"), ("no_axis_flagship", "has no 'stage' axis"),
    ("width", "splits 2 or 3 ways"), ("renorm", "renorm"), ("knobs", "pooled-engine knobs"),
    ("engine", "unknown engine"), ("arch", "dae_arch='dae' only"),
])
def test_pipeline_misuse_raises_as_in_jax(both, case, match):
    errors = {**two(both)[0]["toy"]["errors"], **both[0][(2, 2)][0]["misuse"]}  # misuse: meshes over all 4 ranks
    assert errors[case].startswith("ValueError") and match in errors[case]


@pytest.mark.parametrize("case", ["grad", "remat", "remat_stacked"])
def test_gradients_through_the_pipeline_are_refused_naming_the_roadmap(both, case):
    """Refused until the reverse schedule was ported; now (the name kept)
    the toy's gradient in k0 equals jax.grad of JAX's pipeline (rtol 1e-4,
    atol 1e-5, as ``tests/test_pp.py``), and ``remat`` gives the gradient
    without it (rtol 1e-5, atol 1e-6), heterogeneous and stacked, on every
    rank. ``tests/test_torch_pp_grad.py`` holds the rest."""
    for res in two(both):
        got = res["toy"]["grads"][case]
        if case == "grad":
            np.testing.assert_allclose(got, both[1]["toy_grad"], rtol=1e-4, atol=1e-5)
        else:
            np.testing.assert_allclose(got[0], got[1], rtol=1e-5, atol=1e-6)


def test_gpipe_stacked_matches_jax(both):
    """4 homogeneous stages on 4 ranks (each reads its own slice), and with
    per-stage residency (each rank holds only its slice) on 2."""
    for res in both[0][(2, 2)]:
        np.testing.assert_allclose(res["stacked4"]["out"], both[1]["stacked4"], rtol=1e-5, atol=1e-6)
    for res in two(both):
        np.testing.assert_allclose(res["stacked_resident"]["out"], both[1]["stacked_resident"], rtol=1e-5, atol=1e-6)
        assert res["stacked_resident"]["held"] == (1, 4, 4)


def test_gpipe_stacked_composes_with_dp(both):
    for res in both[0][(2, 2)]:
        np.testing.assert_allclose(res["stacked_dp"]["out"], both[1]["stacked_dp"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ["f32", "quarter", "energy", "stride"])
def test_pp_flagship_matches_jax(both, case):
    """FCN forward | pooled refinement on 2 ranks, y0 and y_K, against JAX's
    sequential flagship (f32; quarter iteration, energy mode, stride
    encoder)."""
    want = both[1][case]
    for res in two(both):
        np.testing.assert_allclose(res[case]["y0"], want[0], **F32)
        np.testing.assert_allclose(res[case]["yk"], want[1], **F32)


def test_pp_flagship_bf16_matches_jax(both):
    want = both[1]["bf16"][1]
    for res in two(both):
        got = res["bf16"]["yk"]
        assert np.abs(got - want).max() < 0.1
        assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.98


def test_pp_flagship_general_engine_matches_jax(both):
    want = both[1]["general"]
    for res in two(both):
        np.testing.assert_allclose(res["general"]["y0"], want[0], **F32)
        np.testing.assert_allclose(res["general"]["yk"], want[1], **F32)


def test_pp_general_serves_mirror_arch(both):
    want = both[1]["mirror"][1]
    for res in two(both):
        got = res["mirror"]["yk"]
        np.testing.assert_allclose(got, want, atol=5e-3)
        assert (got.argmax(-1) == want.argmax(-1)).mean() > 0.999


@pytest.mark.parametrize("case", ["half3", "general3"])
def test_pp_flagship_three_stage_matches_jax(both, case):
    """VGG backbone | FCN-8 head | refinement on 3 ranks."""
    want = both[1][case]
    for res in both[0][(3,)]:
        np.testing.assert_allclose(res[case]["y0"], want[0], **F32)
        np.testing.assert_allclose(res[case]["yk"], want[1], **F32)


def test_pp_flagship_three_stage_rejects_head_taps_and_bad_images(both):
    errors = both[0][(3,)][0]["errors3"]
    assert errors["taps"].startswith("ValueError") and "pool" in errors["taps"]
    assert "(M, Bm, H, W, 3) microbatches" in errors["rank5"]


def test_pp_flagship_composes_with_dp(both):
    """('data', 'stage') of (2, 2): each microbatch's batch split over
    'data', the emits gathered back."""
    want = both[1]["dpxpp"][1]
    for res in both[0][(2, 2)]:
        np.testing.assert_allclose(res["dpxpp"]["yk"], want, **F32)


def test_predictor_pp_mesh_matches_jax(both):
    """Batch 4 over 6 images, 2 microbatches in flight: the short last chunk
    padded, every check of the JAX constructor."""
    want_labels, want_probs = both[1]["predictor"]
    for res in two(both):
        got = res["predictor"]
        np.testing.assert_array_equal(got["labels"], want_labels)
        np.testing.assert_allclose(got["probs"], want_probs, **F32)
        assert "pass either mesh" in got["errors"]["both"]
        assert "requires a DAE" in got["errors"]["no_dae"]
        assert "pp_microbatches must be >= 1" in got["errors"]["microbatches"]
        assert "not divisible by pp_microbatches 3 x DP width 1" in got["errors"]["indivisible"]
