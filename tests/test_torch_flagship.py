"""The port's main path against the JAX package's, on the same numpy inputs
and the same (bridged) weights, on the CPU: the folded tail, the flagship
forward (half and quarter engines, folded and unfolded), and the half-engine
``Predictor`` with its zero-pad chunking and npz loading.

Tolerances: f32 within 1e-4 (whole paths); bf16 within 0.1 with argmax
agreement >= 98% (the port rounds once per refinement step where the JAX
package rounds after every op; see the port's ``inference/fused.py``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from iterative_inference_segm_tpu.data import config_datasets as jcfg  # noqa: E402
from iterative_inference_segm_tpu.data.pipeline import normalize_image as j_normalize  # noqa: E402
from iterative_inference_segm_tpu.inference import fused as jfused  # noqa: E402
from iterative_inference_segm_tpu.inference.predictor import Predictor as JPredictor  # noqa: E402
from iterative_inference_segm_tpu.models import dae as jdae  # noqa: E402
from iterative_inference_segm_tpu.models import fcn8 as jfcn8  # noqa: E402
from iterative_inference_segm_tpu.models.registry import checkpoint_meta  # noqa: E402
from iterative_inference_segm_tpu.utils.checkpoint import save_npz as j_save_npz  # noqa: E402
from iterative_inference_segm_tpu_torch.data import config_datasets as tcfg  # noqa: E402
from iterative_inference_segm_tpu_torch.data.pipeline import normalize_image  # noqa: E402
from iterative_inference_segm_tpu_torch.inference import fused as tfused  # noqa: E402
from iterative_inference_segm_tpu_torch.inference.predictor import Predictor  # noqa: E402
from iterative_inference_segm_tpu_torch.models.dae import dae_core  # noqa: E402
from iterative_inference_segm_tpu_torch.ops.refine_tail import refine_tail  # noqa: E402
from iterative_inference_segm_tpu_torch.utils.jax_bridge import params_from_jax  # noqa: E402

C = 5
TOL = dict(rtol=1e-4, atol=1e-4)
TINY_J = dataclasses.replace(jcfg.CAMVID, n_classes=C, void_label=C, height=48, width=64)
TINY_T = dataclasses.replace(tcfg.CAMVID, n_classes=C, void_label=C)


def _randomized(tree, seed, scale=0.3):
    """Random transposed-conv and score weights: the bilinear inits are
    flip-symmetric and the zero biases would hide a wrong bias path."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, lv in tree.items():
        if k.startswith("up") or k in ("out", "score_input", "score_enc1"):
            lv = {kk: jnp.asarray(rng.normal(size=v.shape).astype(np.float32) * scale) for kk, v in lv.items()}
        out[k] = lv
    return out


def _params(stem_pool=1):
    fcn = _randomized(jfcn8.init_fcn8(jax.random.PRNGKey(0), n_classes=C, fc_channels=16), 0)
    dae = _randomized(jdae.init_dae(
        jax.random.PRNGKey(1), n_classes=C, h_specs={"pool4": 512}, depth=3,
        stem_pool=stem_pool, widths=(8, 16, 32),
    ), 1)
    return fcn, dae


def _images(n=2, seed=2):
    return np.random.default_rng(seed).random((n, 48, 64, 3), dtype=np.float32)


def test_dataset_config_and_normalize_match_jax():
    assert set(tcfg.DATASET_CONFIGS) == set(jcfg.DATASET_CONFIGS)
    for name, cfg in tcfg.DATASET_CONFIGS.items():
        for f in dataclasses.fields(cfg):
            got, want = getattr(cfg, f.name), getattr(jcfg.DATASET_CONFIGS[name], f.name)
            if f.name == "palette":
                assert got.dtype == want.dtype == np.uint8 and np.array_equal(got, want), name
            else:
                assert got == want, (name, f.name)
    assert tcfg.CAMVID.train_crop == (224, 224) and (tcfg.CAMVID.height, tcfg.CAMVID.width) == (360, 480)
    x = _images() * 255.0
    for scale in (1.0, 255.0):
        want = np.asarray(j_normalize(jnp.asarray(x), jcfg.CAMVID, input_scale=scale))
        got = normalize_image(torch.from_numpy(x), tcfg.CAMVID, input_scale=scale)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("encoder", ["pool", "stride"])
def test_fold_half_tail_matches_jax(encoder):
    _, jd = _params()
    jfk = jfused.fold_half_tail(jd, encoder=encoder)
    tfk = tfused.fold_half_tail(params_from_jax(jd), encoder=encoder)
    assert set(tfk) == set(jfk)
    layers = {"up1p": {"w": jfk["up1p"]}, "si": {"w": jfk["si_w"], "b": jfk["si_b"]}}
    if encoder == "pool":
        layers.update(cat={"w": jfk["cat_w"], "b": jfk["cat_b"]}, se1p={"w": jfk["se1p_w"], "b": jfk["bp"]})
    ported = params_from_jax(layers)
    pairs = [("up1p", ported["up1p"]["w"]), ("si_w", ported["si"]["w"]), ("si_b", ported["si"]["b"]),
             ("b_out", torch.from_numpy(np.array(jfk["b_out"])))]
    if encoder == "pool":
        pairs += [("cat_w", ported["cat"]["w"]), ("cat_b", ported["cat"]["b"]),
                  ("se1p_w", ported["se1p"]["w"]), ("bp", ported["se1p"]["b"])]
    for name, want in pairs:
        np.testing.assert_allclose(tfk[name].numpy(), want.numpy(), rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("encoder", ["pool", "stride"])
def test_folded_logits_and_core_out_match_unfolded(encoder):
    """folded_step_logits == out(core) + score_input(x); folded_core_out == dae_core."""
    _, jd = _params()
    td = params_from_jax(jd)
    x = torch.softmax(torch.randn((2, 24, 32, C), generator=torch.Generator().manual_seed(3)), -1)
    h = {"pool4": torch.randn((2, 3, 4, 512), generator=torch.Generator().manual_seed(4))}
    core = dae_core(td, x, h, depth=3, stem_pool=1, encoder=encoder)
    pre, skip1 = dae_core(td, x, h, depth=3, stem_pool=1, encoder=encoder, predense=True)
    fk = tfused.fold_half_tail(td, encoder=encoder)
    got = tfused.folded_step_logits(fk, pre, skip1, x, encoder=encoder)
    torch.testing.assert_close(got, tfused.half_logits(td, x, core), **TOL)
    got_core = tfused.folded_core_out(fk, pre, skip1, encoder=encoder, out_hw=(24, 32))
    torch.testing.assert_close(got_core, core, **TOL)


@pytest.mark.parametrize(
    "stem_pool,fold,encoder",
    [(1, True, "pool"), (1, False, "pool"), (2, True, "pool"), (2, False, "pool"), (1, True, "stride")],
)
def test_flagship_forward_matches_jax_f32(stem_pool, fold, encoder):
    jf, jd = _params(stem_pool)
    x = np.random.default_rng(5).normal(size=(2, 48, 64, 3)).astype(np.float32)
    kw = dict(num_steps=3, depth=3, eps=0.3, encoder=encoder, fold_tail=fold)
    jy0, jyk = jax.jit(jfused.flagship_forward_fn(compute_dtype=jnp.float32, **kw))(jf, jd, jnp.asarray(x))
    before = refine_tail.launches
    fwd = tfused.flagship_forward_fn(compute_dtype=torch.float32, with_labels=True, **kw)
    with torch.inference_mode():
        ty0, tyk, labels = fwd(params_from_jax(jf), params_from_jax(jd), torch.from_numpy(x))
    assert refine_tail.launches == before  # CPU tensors: the plain version
    assert tyk.dtype == torch.float32 and tuple(tyk.shape) == (2, 48, 64, C)
    np.testing.assert_allclose(ty0.numpy(), np.asarray(jy0), **TOL)
    np.testing.assert_allclose(tyk.numpy(), np.asarray(jyk), **TOL)
    assert float(np.abs(tyk.numpy() - np.asarray(jy0)).max()) > 1e-3  # the refinement moved y
    np.testing.assert_array_equal(labels.numpy(), tyk.numpy().argmax(-1))


def test_flagship_forward_matches_jax_bf16():
    jf, jd = _params()
    x = np.random.default_rng(6).normal(size=(2, 48, 64, 3)).astype(np.float32)
    kw = dict(num_steps=3, depth=3, eps=0.3)
    _, jyk = jax.jit(jfused.flagship_forward_fn(compute_dtype=jnp.bfloat16, **kw))(jf, jd, jnp.asarray(x))
    with torch.inference_mode():
        _, tyk = tfused.flagship_forward_fn(compute_dtype=torch.bfloat16, **kw)(
            params_from_jax(jf), params_from_jax(jd), torch.from_numpy(x)
        )
    assert tyk.dtype == torch.bfloat16
    j, t = np.asarray(jyk.astype(jnp.float32)), tyk.float().numpy()
    assert np.abs(t - j).max() <= 0.1
    assert (t.argmax(-1) == j.argmax(-1)).mean() >= 0.98


def test_make_half_refiner_equals_flagship():
    jf, jd = _params()
    tf, td = params_from_jax(jf), params_from_jax(jd)
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(1, 48, 64, 3)).astype(np.float32))
    refine = tfused.make_half_refiner(None, tf, td, eps=0.3, num_steps=2, depth=3)
    y0, yk = refine(x)
    with torch.inference_mode():
        want = tfused.flagship_forward_fn(compute_dtype=torch.float32, eps=0.3, num_steps=2, depth=3)(tf, td, x)
    assert torch.equal(y0, want[0]) and torch.equal(yk, want[1])


def test_engine_rejects_what_is_not_ported():
    jf, jd = _params()
    tf, td = params_from_jax(jf), params_from_jax(jd)
    # energy mode runs, unfolded: folding it is refused, as in the JAX package
    with pytest.raises(ValueError, match="fold_tail"):
        tfused.make_half_refiner(None, tf, td, eps=0.1, num_steps=1, mode="energy", fold_tail=True)
    for fused_engine in (tfused.fused_refinement_scan, tfused.make_fused_refiner):
        with pytest.raises(NotImplementedError):
            fused_engine(td, None, torch.zeros((1, 48, 64, C)), eps=0.1, num_steps=1)
    with pytest.raises(ValueError):
        tfused.flagship_forward_fn(mode="langevin")
    y_odd = torch.zeros((1, 47, 64, C))
    with pytest.raises(ValueError):
        tfused.halfres_refinement_scan(td, lambda x: x, y_odd, eps=0.1, num_steps=1)
    d0 = params_from_jax(jdae.init_dae(jax.random.PRNGKey(1), n_classes=C, depth=4, stem_pool=0))
    with pytest.raises(ValueError):
        tfused.halfres_refinement_scan_folded(d0, None, torch.zeros((1, 48, 64, C)), eps=0.1, num_steps=1)


def test_predictor_matches_jax_predictor():
    """Batch 2 over 3 images: the last chunk is zero-padded."""
    jf, jd = _params()
    imgs = _images(3, seed=8)
    kw = dict(batch_size=2, num_steps=2, eps=0.3, engine="half", dae_kwargs={"depth": 3})
    jp = JPredictor(jf, jd, dataset=TINY_J, compute_dtype=jnp.float32, **kw)
    want_labels, want_probs = jp.predict(imgs, return_probs=True)
    tp = Predictor(params_from_jax(jf), params_from_jax(jd), device="cpu", dataset=TINY_T,
                   compute_dtype=torch.float32, **kw)
    labels, probs = tp.predict(imgs, return_probs=True)
    assert labels.dtype == np.int32 and labels.shape == (3, 48, 64)
    assert probs.dtype == np.float32 and probs.shape == (3, 48, 64, C)
    np.testing.assert_array_equal(labels, want_labels)
    np.testing.assert_allclose(probs, want_probs, **TOL)
    np.testing.assert_array_equal(tp.predict(imgs), labels)
    # an unrefined predictor serves the FCN's f32 argmax
    fcn_only = Predictor(params_from_jax(jf), device="cpu", dataset=TINY_T, batch_size=2)
    want = JPredictor(jf, dataset=TINY_J, batch_size=2, num_steps=0).predict(imgs)
    assert (fcn_only.predict(imgs) == want).mean() >= 0.99  # bf16 features


def test_predictor_from_npz(tmp_path):
    jf, jd = _params()
    j_save_npz(tmp_path / "fcn.npz", jf)
    meta = checkpoint_meta("dae", h_taps=("pool4",), depth=3, stem_pool=1, widths=(8, 16, 32))
    j_save_npz(tmp_path / "dae.npz", jd, meta=meta)
    kw = dict(dataset=TINY_T, fc_channels=16, dae_depth=3, dae_stem_pool=1, dae_widths=(8, 16, 32),
              batch_size=2, num_steps=2, eps=0.3, compute_dtype=torch.float32)
    p = Predictor.from_npz(tmp_path / "fcn.npz", tmp_path / "dae.npz", device="cpu", **kw)
    direct = Predictor(params_from_jax(jf), params_from_jax(jd), device="cpu", dataset=TINY_T, batch_size=2,
                       num_steps=2, eps=0.3, compute_dtype=torch.float32, dae_kwargs={"depth": 3})
    imgs = _images(2, seed=9)
    np.testing.assert_array_equal(p.predict(imgs), direct.predict(imgs))
    with pytest.raises(ValueError, match="encoder"):
        Predictor.from_npz(tmp_path / "fcn.npz", tmp_path / "dae.npz", device="cpu", dae_encoder="stride", **kw)


@pytest.mark.parametrize(
    "kw,exc",
    # the mesh checks that need no launched group (the meshes run in
    # test_torch_parallel.py and test_torch_pp.py): mesh with pp_mesh, and
    # pp_mesh without a DAE, raise as in the JAX Predictor
    [({"engine": "general", "mesh": object(), "pp_mesh": object()}, ValueError), ({"engine": "fused"}, ValueError),
     ({"dae_arch": "mirror", "engine": "half"}, ValueError), ({"dae_arch": "unet"}, ValueError),
     ({"mesh": object()}, TypeError), ({"pp_mesh": object()}, ValueError),
     ({"batch_size": 0}, ValueError)],
)
def test_predictor_rejects_what_is_not_ported(kw, exc):
    with pytest.raises(exc):
        Predictor({}, None, device="cpu", **kw)
