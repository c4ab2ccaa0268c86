"""The port's data layer against the JAX package's on the same inputs: the
disk loaders on fixture trees written here (ISBI TIFF stacks, directory
layouts with the ``valid`` alias and resizing, CamVid ``<split>annot``, the
errors), ``iterate_split`` / ``epoch_reshuffled`` orders, ``pack_dataset``'s
bytes and the native runtime's batches (f32 and the u8 wire, shuffled or
not, tail padding) — all equal bit for bit — and the port's own pieces:
the native build into the package's ``build/`` (never ``native/``; a failed
build raises), ``device_prefetch`` on the CPU, and the u8 wire's labels
giving the loss of int32 ones.
"""

import contextlib
import dataclasses
import io
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)
from PIL import Image  # noqa: E402

from iterative_inference_segm_tpu.data import camvid as jcamvid  # noqa: E402
from iterative_inference_segm_tpu.data import config_datasets as jcfg  # noqa: E402
from iterative_inference_segm_tpu.data import em as jem  # noqa: E402
from iterative_inference_segm_tpu.data import loaders as jloaders  # noqa: E402
from iterative_inference_segm_tpu.data import native_loader as jnative  # noqa: E402
from iterative_inference_segm_tpu.data import polyps as jpolyps  # noqa: E402
from iterative_inference_segm_tpu_torch.data import camvid as tcamvid  # noqa: E402
from iterative_inference_segm_tpu_torch.data import config_datasets as tcfg  # noqa: E402
from iterative_inference_segm_tpu_torch.data import em as tem  # noqa: E402
from iterative_inference_segm_tpu_torch.data import loaders as tloaders  # noqa: E402
from iterative_inference_segm_tpu_torch.data import native_loader as tnative  # noqa: E402
from iterative_inference_segm_tpu_torch.data import polyps as tpolyps  # noqa: E402
from iterative_inference_segm_tpu_torch.data.prefetch import device_prefetch  # noqa: E402
from iterative_inference_segm_tpu_torch.ops import _build  # noqa: E402
from iterative_inference_segm_tpu_torch.ops.losses import crossentropy_probs  # noqa: E402
from iterative_inference_segm_tpu_torch.train.loop import to_device  # noqa: E402
from torch_port_helpers import jax_script, write_camvid_tree  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------- fixtures


def _isbi_tree(root):
    """ISBI multi-page TIFF stacks: 30 slices of 32x32."""
    rng = np.random.default_rng(0)
    vol = rng.integers(0, 256, size=(30, 32, 32), dtype=np.uint8)
    lab = np.where(rng.random((30, 32, 32)) < 0.3, 0, 255).astype(np.uint8)
    for name, stack in (("train-volume.tif", vol), ("train-labels.tif", lab)):
        frames = [Image.fromarray(v) for v in stack]
        frames[0].save(root / name, save_all=True, append_images=frames[1:])
    return dataclasses.replace(jcfg.EM, height=32, width=32)


def _write_dir(root, split, n, hw, *, img_sub="images", lab_sub="labels", channels=3, lab_values=(0, 255)):
    rng = np.random.default_rng(len(split) * 7 + n)
    (root / split / img_sub).mkdir(parents=True)
    (root / split / lab_sub).mkdir(parents=True)
    for i in range(n):
        img = rng.integers(0, 256, size=(*hw, channels), dtype=np.uint8)
        Image.fromarray(img[..., 0] if channels == 1 else img).save(root / split / img_sub / f"s{i:02d}.png")
        lab = rng.choice(np.array(lab_values, np.uint8), size=hw)
        Image.fromarray(lab).save(root / split / lab_sub / f"mask_s{i:02d}.png")


def _camvid_tree(root, hw=(24, 32), n=3):
    write_camvid_tree(root, hw, {"train": n, "val": n, "test": n})
    return dataclasses.replace(jcfg.CAMVID, height=hw[0], width=hw[1])


def _port_cfg(jax_cfg):
    return dataclasses.replace(tcfg.DATASET_CONFIGS[jax_cfg.name], height=jax_cfg.height, width=jax_cfg.width)


# ---------------------------------------------------------------- loaders


def _em_dir(root):
    _write_dir(root, "train", 2, (20, 24), channels=1)
    return dataclasses.replace(jcfg.EM, height=32, width=32)  # resized up


def _polyps_valid(root):
    _write_dir(root, "train", 3, (24, 20), lab_sub="masks")
    _write_dir(root, "valid", 2, (48, 40), lab_sub="masks")  # the 'valid' alias
    return dataclasses.replace(jcfg.POLYPS, height=48, width=40)


def _polyps_camvid_style(root):
    _write_dir(root, "x", 2, (16, 16))  # makes the layout below, then renamed
    (root / "x" / "images").rename(root / "val")
    (root / "x" / "labels").rename(root / "valannot")
    return dataclasses.replace(jcfg.POLYPS, height=12, width=20)


LOADER_CASES = {
    "em_isbi_train": ("em", _isbi_tree, "train"),
    "em_isbi_val": ("em", _isbi_tree, "val"),
    "em_isbi_test": ("em", _isbi_tree, "test"),
    "em_dir_resized": ("em", _em_dir, "train"),
    "polyps_train_resized": ("polyps", _polyps_valid, "train"),
    "polyps_valid_alias": ("polyps", _polyps_valid, "val"),
    "polyps_camvid_style": ("polyps", _polyps_camvid_style, "val"),
    "camvid_annot": ("camvid", _camvid_tree, "test"),
}


@pytest.mark.parametrize("case", list(LOADER_CASES))
def test_loaders_give_the_jax_arrays(case, tmp_path):
    dataset, make, split = LOADER_CASES[case]
    cfg = make(tmp_path)
    want = jloaders.load_dataset_split(dataset, tmp_path, split, cfg)
    got = tloaders.load_dataset_split(dataset, tmp_path, split, _port_cfg(cfg))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[0].shape[1:3] == (cfg.height, cfg.width)
    if dataset != "camvid":
        assert set(np.unique(got[1])) <= {0, 1}


JAX_MODS = {"loaders": jloaders, "polyps": jpolyps, "em": jem, "camvid": jcamvid, "cfg": jcfg}
PORT_MODS = {"loaders": tloaders, "polyps": tpolyps, "em": tem, "camvid": tcamvid, "cfg": tcfg}


def _counts_mismatch(root):
    _write_dir(root, "train", 2, (16, 16), lab_sub="masks")
    sorted((root / "train" / "masks").iterdir())[0].unlink()


ERROR_CASES = {
    # name: (set-up, call, exception)
    "missing_layout": (None, lambda root, m: m["polyps"].load_split(root, "train", m["cfg"].POLYPS),
                       FileNotFoundError),
    "counts_mismatch": (_counts_mismatch, lambda root, m: m["polyps"].load_split(
        root, "train", dataclasses.replace(m["cfg"].POLYPS, height=16, width=16)), ValueError),
    "unknown_em_split": (_isbi_tree, lambda root, m: m["em"].load_split(root, "blurf", m["cfg"].EM), ValueError),
    "camvid_missing": (None, lambda root, m: m["camvid"].load_split(root, "train", m["cfg"].CAMVID),
                       FileNotFoundError),
    "unknown_dataset": (None, lambda root, m: m["loaders"].load_dataset_split("nope", root, "val", m["cfg"].CAMVID),
                        ValueError),
}


@pytest.mark.parametrize("case", list(ERROR_CASES))
def test_loader_errors_are_the_jax_errors(case, tmp_path):
    setup, call, exc = ERROR_CASES[case]
    if setup is not None:
        setup(tmp_path)
    for mods in (JAX_MODS, PORT_MODS):
        with pytest.raises(exc):
            call(tmp_path, mods)


def test_missing_pillow_names_it_and_the_flag(monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_pil(name, *a, **k):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("No module named 'PIL'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ImportError, match="--data-root.*Pillow"):
        tloaders.pil_image()


# ---------------------------------------------------------------- iterators


def test_iterate_split_and_epoch_reshuffled_give_the_jax_order():
    imgs = np.arange(13, dtype=np.float32).reshape(13, 1, 1, 1).repeat(3, -1)
    labs = np.arange(13, dtype=np.int32).reshape(13, 1, 1)

    def order(batches):
        return [[int(v) for v in lab[:, 0, 0]] for _, lab in batches]

    for kw in ({}, {"drop_last": True}, {"shuffle": True, "seed": 3}, {"shuffle": True, "seed": 3, "drop_last": True}):
        want = order(jcamvid.iterate_split(imgs, labs, batch_size=4, **kw))
        got = order(tcamvid.iterate_split(imgs, labs, batch_size=4, **kw))
        assert got == want, kw
    j = jloaders.epoch_reshuffled(lambda seed: jcamvid.iterate_split(imgs, labs, batch_size=5, shuffle=True,
                                                                     seed=seed), 7)
    t = tloaders.epoch_reshuffled(lambda seed: tcamvid.iterate_split(imgs, labs, batch_size=5, shuffle=True,
                                                                     seed=seed), 7)
    epochs = [order(t()) for _ in range(3)]
    assert epochs == [order(j()) for _ in range(3)]
    assert epochs[0] != epochs[1]


# ---------------------------------------------------------------- packed runtime


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    """13 samples of 24x32x3 (a tail batch at 4), labels 0..11 and -1 / 255
    (void), written by both packages."""
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, size=(13, 24, 32, 3), dtype=np.uint8)
    labels = rng.integers(0, 12, size=(13, 24, 32)).astype(np.int32)
    labels[0, 0, :4] = (-1, 255, 11, 12)
    d = tmp_path_factory.mktemp("packed")
    jnative.pack_dataset(d / "jax.iist", images, labels, jcfg.CAMVID)
    tnative.pack_dataset(d / "port.iist", images, labels, tcfg.CAMVID)
    return d


def test_pack_dataset_writes_the_jax_bytes(packed, tmp_path):
    assert (packed / "port.iist").read_bytes() == (packed / "jax.iist").read_bytes()
    # float images in [0, 1] and a one-channel config with other statistics
    rng = np.random.default_rng(1)
    images = rng.random((3, 8, 12, 1), dtype=np.float32)
    labels = rng.integers(-1, 4, size=(3, 8, 12))
    jcf = dataclasses.replace(jcfg.EM, mean=(0.3,), std=(0.7,))
    tcf = dataclasses.replace(tcfg.EM, mean=(0.3,), std=(0.7,))
    jnative.pack_dataset(tmp_path / "j.iist", images, labels, jcf)
    tnative.pack_dataset(tmp_path / "t.iist", images, labels, tcf)
    assert (tmp_path / "t.iist").read_bytes() == (tmp_path / "j.iist").read_bytes()


@pytest.mark.parametrize("bad", ["ndim", "label_shape", "channels", "void"])
def test_pack_dataset_refuses_what_jax_refuses(bad, tmp_path):
    images, labels, cfgs = np.zeros((2, 4, 4, 3), np.uint8), np.zeros((2, 4, 4), np.int32), (jcfg.CAMVID, tcfg.CAMVID)
    if bad == "ndim":
        images = images[0]
    elif bad == "label_shape":
        labels = labels[:, :3]
    elif bad == "channels":
        images = np.zeros((2, 4, 4, 5), np.uint8)
    else:
        cfgs = tuple(dataclasses.replace(c, void_label=300) for c in cfgs)
    for pack, cfg in zip((jnative.pack_dataset, tnative.pack_dataset), cfgs):
        with pytest.raises(ValueError):
            pack(tmp_path / "x.iist", images, labels, cfg)


BATCH_CASES = {
    "f32": {},
    "f32_shuffled": {"shuffle": True, "seed": 5},
    "f32_drop_last": {"drop_last": True},
    "raw": {"raw": True},
    "raw_shuffled": {"raw": True, "shuffle": True, "seed": 5},
    "raw_one_thread": {"raw": True, "shuffle": True, "seed": 9, "n_threads": 1, "queue_depth": 1},
}


@pytest.mark.parametrize("case", list(BATCH_CASES))
def test_native_dataset_gives_the_jax_batches(packed, case):
    kw = BATCH_CASES[case]
    with jnative.NativeDataset(packed / "jax.iist") as jds, tnative.NativeDataset(packed / "jax.iist") as tds:
        assert (tds.n, tds.height, tds.width, tds.channels, tds.n_classes) == (13, 24, 32, 3, 11)
        assert (tds.mean, tds.std) == (jds.mean, jds.std)
        want, got = list(jds.batches(4, **kw)), list(tds.batches(4, **kw))
    assert len(got) == len(want) == (3 if kw.get("drop_last") else 4)
    for (gi, gl), (wi, wl) in zip(got, want):
        assert (gi.dtype, gl.dtype) == (wi.dtype, wl.dtype) == (
            (np.uint8, np.uint8) if kw.get("raw") else (np.float32, np.int32))
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
    if not kw.get("drop_last"):  # the tail: 1 sample, then 3 padded with zeros and void
        tail_i, tail_l = got[-1]
        assert (tail_l[1:] == 11).all() and (tail_i[1:] == 0).all()
    if not kw.get("shuffle"):  # -1, 255, 11 and 12 were packed as void
        assert got[0][1][0, 0, :4].tolist() == [11] * 4


def test_native_mode_mismatch_and_missing_file_raise_as_jax(packed):
    with tnative.NativeDataset(packed / "port.iist") as ds:
        f32_gen = ds.batches(4)
        next(f32_gen)
        raw_gen = ds.batches(4, raw=True)
        next(raw_gen)
        with pytest.raises(RuntimeError, match="raw"):
            next(f32_gen)
    with pytest.raises(FileNotFoundError):
        tnative.NativeDataset(packed / "missing.iist")


def test_native_build_goes_to_the_package_build_dir_and_a_failure_raises(tmp_path, monkeypatch):
    native = ROOT / "native"
    before = {p.name: p.stat().st_mtime_ns for p in native.iterdir()}
    lib = _build.build_host(tnative.NATIVE_SRC, "input_runtime")
    assert lib.parent == _build.BUILD_DIR and lib.is_file() and lib.name.startswith("libinput_runtime-")
    tnative._load_lib()
    assert {p.name: p.stat().st_mtime_ns for p in native.iterdir()} == before  # native/ untouched
    # an edited source builds and loads a library of its own, never the old one ...
    edited = tmp_path / "input_runtime.cc"
    edited.write_text(tnative.NATIVE_SRC.read_text() + "\n// edited\n")
    monkeypatch.setattr(tnative, "NATIVE_SRC", edited)
    assert _build.build_host(edited, "input_runtime") != lib
    assert tnative._load_lib() is not tnative._libs[lib]
    # ... and a source that does not compile raises with the compiler's stderr
    broken = tmp_path / "broken.cc"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "NATIVE_SRC", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed .*broken.cc.*\n.*error"):
        tnative._load_lib()
    assert not list(_build.BUILD_DIR.glob("*.tmp"))


def test_jax_packed_file_under_other_stats_gives_one_batch_on_both_wires(tmp_path):
    """Trap: the u8 wire normalizes with the FILE header's statistics. A file
    packed under other statistics than the --dataset config's gives the same
    normalized batch on both wires."""
    from iterative_inference_segm_tpu_torch.data.pipeline import normalize_image

    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, size=(4, 16, 20, 3), dtype=np.uint8)
    labels = rng.integers(0, 11, size=(4, 16, 20))
    cfg = dataclasses.replace(tcfg.CAMVID, mean=(0.2, 0.4, 0.6), std=(0.5, 0.25, 0.125))
    tnative.pack_dataset(tmp_path / "x.iist", images, labels, cfg)
    with tnative.NativeDataset(tmp_path / "x.iist") as ds:
        (fi, fl), = ds.batches(4)
        (ri, rl), = ds.batches(4, raw=True)
        file_cfg = dataclasses.replace(tcfg.CAMVID, mean=ds.mean, std=ds.std)
    x, y = to_device(ri, rl, "cpu")
    assert x.dtype == torch.uint8 and y.dtype == torch.int32
    on_device = normalize_image(x, file_cfg, input_scale=255.0)
    np.testing.assert_allclose(on_device.numpy(), fi, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(y.numpy(), fl)
    wrong = normalize_image(x, tcfg.CAMVID, input_scale=255.0)  # the config's stats: not the same batch
    assert np.abs(wrong.numpy() - fi).max() > 0.1


def test_u8_wire_labels_give_the_int32_loss():
    rng = np.random.default_rng(4)
    labels = rng.integers(0, 12, size=(2, 8, 8)).astype(np.int32)  # 11 = void
    probs = torch.softmax(torch.from_numpy(rng.normal(size=(2, 8, 8, 11)).astype(np.float32)), -1)
    _, y8 = to_device(np.zeros((2, 8, 8, 3), np.uint8), labels.astype(np.uint8), "cpu")
    _, y32 = to_device(np.zeros((2, 8, 8, 3), np.float32), labels, "cpu")
    assert y8.dtype == y32.dtype == torch.int32
    assert torch.equal(crossentropy_probs(probs, y8, n_classes=11), crossentropy_probs(probs, y32, n_classes=11))


# ---------------------------------------------------------------- prefetch


def test_device_prefetch_on_the_cpu_keeps_order_and_copies_nothing():
    items = [{"x": np.full((2, 2), i, np.float32), "y": (np.arange(3) + i, torch.tensor([i]))} for i in range(5)]
    for depth in (1, 2, 7):
        out = list(device_prefetch(items, depth=depth, device="cpu"))
        assert len(out) == 5
        for i, (item, src) in enumerate(zip(out, items)):
            assert isinstance(item["x"], torch.Tensor) and isinstance(item["y"], tuple)
            assert item["x"].data_ptr() == src["x"].ctypes.data  # a view, no copy
            assert (item["x"] == i).all() and item["y"][0].tolist() == [i, i + 1, i + 2]
            assert item["y"][1] is src["y"][1]
    assert len(list(device_prefetch([np.ones(1)], depth=4, device="cpu"))) == 1
    assert list(device_prefetch([], device="cpu")) == []


def test_device_prefetch_refuses_sharding_and_a_bad_depth():
    # a sharding is a parallel.sharding.Placement (the sharded path runs in
    # test_torch_parallel.py)
    with pytest.raises(TypeError, match="Placement"):
        next(device_prefetch([np.ones(1)], sharding=object(), device="cpu"))
    with pytest.raises(ValueError, match="depth"):
        next(device_prefetch([np.ones(1)], depth=0, device="cpu"))


# ---------------------------------------------------------------- pack_dataset CLI


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue().splitlines()


def test_pack_dataset_cli_twin_writes_the_jax_files(tmp_path):
    from iterative_inference_segm_tpu_torch.scripts import pack_dataset as tpack

    jpack = jax_script("pack_dataset")
    _camvid_tree(tmp_path / "cv", hw=(16, 24), n=2)
    for argv in (["--synthetic", "--dataset", "em", "--num-train", "3", "--num-val", "1", "--num-test", "2",
                  "--height", "16", "--width", "24", "--seed", "4"],
                 ["--from-camvid", str(tmp_path / "cv")]):
        want = _run(jpack.main, [*argv, "--out", str(tmp_path / "j")])
        got = _run(tpack.main, [*argv, "--out", str(tmp_path / "t")])
        assert got == [ln.replace(str(tmp_path / "j"), str(tmp_path / "t")) for ln in want]
        for split in ("train", "val", "test"):
            assert (tmp_path / "t" / f"{split}.iist").read_bytes() == (tmp_path / "j" / f"{split}.iist").read_bytes()
