"""The CPU side of ``chip_smoke.py``: reading the build's register report
and kernel names, and the edge cases of K3, K1/K2 and K4/K5 it holds on the
card (phases 3, 7 and 11; run here through the wrappers, which take the
plain versions on the CPU); the unpool tie cases (17); the check of the two
wires, the device's idle share (18) and the inverse converters (20); and
the checks of the parallel phases (21-25) over every rank's results, with
a stand-in for the launcher: the launches they add up, and a spoiled
result in any one rank failing the run; and the checks of the measuring
entry points' phases (26-29) over stand-ins for the twins: the launches
each configuration must make, and a wrong count, stamp or line failing;
refine_tail held at the shapes each bench configuration hands it; and
phase 31's: septail_step's bound, edge cases and check against its plain
version (a spoiled kernel failing), the layouts recorded through the fused
engine, and its main path's launches over stand-ins for the two twins."""

import importlib
import json
import pathlib

import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from iterative_inference_segm_tpu_torch.ops import corruption_kernel as ck  # noqa: E402

EXACT_K1 = "_ZN47_GLOBAL__N__575d5534_14_corruption_cu_c5d6d6a714corrupt_kernelILb1ELi11ELb1EEEvPKiPKfxijfPf"
GENERAL_K2 = "_ZN47_GLOBAL__N__575d5534_14_corruption_cu_c5d6d6a714corrupt_kernelILb0ELi32ELb0EEEvPKiPKfxijfPf"


def test_kernel_name_keeps_the_template_arguments():
    assert chip_smoke.kernel_name(EXACT_K1) == "corrupt_kernel<Lb1ELi11ELb1>"
    assert chip_smoke.kernel_name(GENERAL_K2) == "corrupt_kernel<Lb0ELi32ELb0>"
    assert chip_smoke.kernel_name("k_plain") == "k_plain"


def test_ptxas_entries_reads_registers_and_spills_per_instance(tmp_path):
    log = tmp_path / "libcorruption.log"
    log.write_text(
        f"ptxas info    : Compiling entry function '{GENERAL_K2}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {GENERAL_K2}\n"
        "    32 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 76 registers, used 1 barriers, 32 bytes cumulative stack size, 16384 bytes smem\n"
        f"ptxas info    : Compiling entry function '{EXACT_K1}' for 'sm_90a'\n"
        f"ptxas info    : Function properties for {EXACT_K1}\n"
        "    0 bytes stack frame, 20 bytes spill stores, 24 bytes spill loads\n"
        "ptxas info    : Used 32 registers, used 1 barriers, 5632 bytes smem\n"
    )
    assert chip_smoke.ptxas_entries(log) == {
        "corrupt_kernel<Lb0ELi32ELb0>": (76, "spill 0/0 B", 16384),
        "corrupt_kernel<Lb1ELi11ELb1>": (32, "spill 20/24 B", 5632),
    }
    assert chip_smoke.ptxas_summary(log) == (
        "corrupt_kernel<Lb0ELi32ELb0>: 76 regs, spill 0/0 B | corrupt_kernel<Lb1ELi11ELb1>: 32 regs, spill 20/24 B"
    )


@pytest.mark.parametrize("sigma", [0.0, 1.0])
def test_corrupt_edge_cases_cover_both_instances_and_the_staging_paths(sigma):
    cases = chip_smoke.corrupt_edge_cases("cpu", torch.Generator().manual_seed(0))
    names = [c[0] for c in cases]
    assert names == [f"{w} C={c}" for c in (1, 2, 11, 16, 17, 32, 33, 64, 128) for w in ("onehot", "probs")] + [
        "probs bf16", "probs unaligned"]
    for name, fn, ref, src, kw in cases:
        assert fn in (ck.corrupt_onehot, ck.corrupt_probs)
        n_px = 3 * 45 * 61
        assert n_px % 128 == 43 and n_px % 64 == 43  # the last tile is ragged, in the wide instance too
        if fn is ck.corrupt_onehot:
            c = kw["n_classes"]
            assert int(src.min()) < 0 and int(src.max()) >= c  # void on both sides
        if name == "probs bf16":
            assert src.dtype == torch.bfloat16
        if name == "probs unaligned":
            assert src.data_ptr() % 16 != 0
        got = fn(src, 7, sigma=sigma, **kw)
        assert torch.equal(got, ref(src, 7, sigma=sigma, **kw))


def test_kernel_edge_cases_reach_the_wide_instance():
    """Phase 3's cases hold 33, 64 and 128 classes (the wide instance), its
    y.W + b path, a strided map and bf16 logits beside an f32 iterate."""
    cases = {c[0]: c for c in chip_smoke.edge_cases("cpu", torch.Generator().manual_seed(0))}
    for tag in ("bf16", "f32"):
        for c in chip_smoke.WIDE_CLASSES:
            assert cases[f"C={c}_{tag}"][3].shape[-1] == c
        assert cases[f"w_C=40_{tag}"][5].shape == (40, 40)
        assert cases[f"strided_C=33_{tag}"][8] is True
    name, dt, u, y, v, wm, bias, lab, strided = cases["C=128_bf16_u"]
    assert (u.dtype, y.dtype) == (torch.bfloat16, torch.float32) and not strided
    got, labels = chip_smoke.refine_tail(u, y, chip_smoke.EPS, with_labels=lab)
    assert got.shape == y.shape and int(labels.max()) < 128


def test_probe_edge_cases_cover_the_vector_ends_and_the_scalar_instance():
    cases = chip_smoke.probe_edge_cases("cpu", torch.Generator().manual_seed(0))
    names = [c[0] for c in cases]
    assert len(names) == len(set(names)) == 2 * (7 + 10)
    for tag in ("float32", "bfloat16"):
        assert f"fma_chain {tag} n=1003 at element 3" in names
        assert f"pattern_softmax {tag} (2, 1, 11, 33) at element 0" in names
        assert f"pattern_softmax {tag} (1, 4, 16, 1000) at element 0" in names  # one row a tile in f32
        assert any(n.startswith(f"pattern_softmax {tag} (2, 3, 11, 8) at element") and not n.endswith(" 0")
                   for n in names)
    for name, kernel, call, plain, f32_tol in cases:
        got, want = call(), plain()
        assert kernel in ("fma_chain", "pattern_softmax") and got.shape == want.shape
        assert torch.equal(got, want)  # on the CPU both are the plain version
        assert (f32_tol is None) == (kernel == "fma_chain")


def test_pattern_ops_count_the_exponential_and_the_divide():
    assert chip_smoke.PATTERN_OPS == 36


def test_unpool_tie_cases_pick_the_jax_positions_on_the_cpu():
    """Phase 17 holds max_unpool on the card to the CPU on these cases; here
    the CPU is held to the JAX package on them (bit for bit)."""
    import jax.numpy as jnp
    import numpy as np

    from iterative_inference_segm_tpu.ops.conv import max_unpool as j_max_unpool

    cases = chip_smoke.unpool_tie_cases(torch.Generator().manual_seed(31))
    assert [c[0] for c in cases] == [f"{n} {d}" for n in ("stage1_zero_windows", "exact_ties", "ragged_odd", "all_equal")
                                     for d in ("float32", "bfloat16")]
    for name, pre, g in cases:
        jd = jnp.bfloat16 if pre.dtype == torch.bfloat16 else jnp.float32
        got = chip_smoke.max_unpool(g, pre)
        want = j_max_unpool(jnp.asarray(g.float().numpy(), jd), jnp.asarray(pre.float().numpy(), jd))
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)), err_msg=name)


def test_hold_wires_takes_the_runtime_batches_and_catches_a_wrong_one(tmp_path):
    """Phase 18's check of the two wires, on the CPU: the first batch of a
    file the runtime reads on each wire agrees within WIRE_TOL on its real
    frames with equal labels; the padded frames, the config's statistics in
    place of the file's, a label moved, or the f32 batch on the u8 wire
    fail."""
    import dataclasses

    import numpy as np

    from iterative_inference_segm_tpu_torch.data.native_loader import NativeDataset, pack_dataset

    rng = np.random.default_rng(0)
    cfg = dataclasses.replace(chip_smoke.CAMVID, mean=(0.3, 0.5, 0.45), std=(0.2, 0.3, 0.25))
    pack_dataset(tmp_path / "x.iist", rng.integers(0, 256, size=(5, 12, 16, 3), dtype=np.uint8),
                 rng.integers(-1, 12, size=(5, 12, 16)), cfg)
    with NativeDataset(tmp_path / "x.iist") as ds:
        (f32,), (raw,) = list(ds.batches(8)), list(ds.batches(8, raw=True))
        file_cfg = dataclasses.replace(chip_smoke.CAMVID, mean=ds.mean, std=ds.std)
    assert chip_smoke.hold_wires(raw, f32, file_cfg, "cpu", 5) <= chip_smoke.WIRE_TOL
    with pytest.raises(AssertionError, match="off the f32 wire"):  # the padding is not normalized alike
        chip_smoke.hold_wires(raw, f32, file_cfg, "cpu", 8)
    with pytest.raises(AssertionError, match="off the f32 wire"):
        chip_smoke.hold_wires(raw, f32, chip_smoke.CAMVID, "cpu", 5)
    moved = raw[1].copy()
    moved[0, 0, 0] = (moved[0, 0, 0] + 1) % 11
    with pytest.raises(AssertionError, match="labels differ"):
        chip_smoke.hold_wires((raw[0], moved), f32, file_cfg, "cpu", 5)
    with pytest.raises(AssertionError, match="wires"):
        chip_smoke.hold_wires(f32, f32, file_cfg, "cpu", 5)


def test_lasagne_arrays_invert_the_import_converters(tmp_path):
    """Phase 20 writes the FCN's own weights as a Lasagne positional npz with
    these inverse converters: both packages' imports give the weights back
    bit for bit (the JAX import in its layout)."""
    import jax
    import numpy as np

    from iterative_inference_segm_tpu.models import fcn8 as jfcn8
    from iterative_inference_segm_tpu.utils import import_weights as jiw
    from iterative_inference_segm_tpu_torch.utils.import_weights import import_lasagne_npz
    from iterative_inference_segm_tpu_torch.utils.jax_bridge import params_from_jax, params_to_jax

    fcn = params_from_jax(jfcn8.init_fcn8(jax.random.PRNGKey(3), n_classes=11, fc_channels=16))
    gen = torch.Generator().manual_seed(0)
    fcn = {k: {kk: torch.randn(t.shape, generator=gen) for kk, t in v.items()} for k, v in fcn.items()}
    arrays = chip_smoke.lasagne_arrays(fcn)
    assert len(arrays) == 2 * (len(jiw.FCN8_LASAGNE_ORDER) - 3) + 3  # deconvs carry no bias
    assert arrays[26].shape == (16, 512 * 7 * 7) and arrays[28].shape == (16, 16)  # fc6, fc7 flat
    np.savez(tmp_path / "ref.npz", *arrays)
    template = params_from_jax(jfcn8.init_fcn8(jax.random.PRNGKey(4), n_classes=11, fc_channels=16))
    back = import_lasagne_npz(tmp_path / "ref.npz", template, strict=True)
    assert all(torch.equal(back[k][kk], t) for k, v in fcn.items() for kk, t in v.items())
    jback = jiw.import_lasagne_npz(tmp_path / "ref.npz", params_to_jax(template), strict=True)
    want = params_to_jax(fcn)
    for k, v in want.items():
        for kk, a in v.items():
            np.testing.assert_array_equal(np.asarray(jback[k][kk]), a, err_msg=f"{k}/{kk}")


def test_idle_share_merges_overlapping_device_spans_within_the_window():
    spans = [(0.0, 1000.0), (500.0, 1500.0), (3000.0, 4000.0), (3100.0, 3200.0)]
    busy, window, idle = chip_smoke.idle_share(spans)
    assert (busy, window) == (2.5, 4.0) and idle == pytest.approx(0.375)
    assert chip_smoke.idle_share([(10.0, 20.0)]) == (0.01, 0.01, 0.0)
    # a window clips the spans: 1000..3500 holds 500 + 500 us of device time
    assert chip_smoke.idle_share(spans, (1000.0, 3500.0)) == (1.0, 2.5, pytest.approx(0.6))
    with pytest.raises(AssertionError, match="no device time"):
        chip_smoke.idle_share([])
    with pytest.raises(AssertionError, match="no device time"):
        chip_smoke.idle_share(spans, (1600.0, 2900.0))


def test_profiled_training_marks_each_batch_copy(monkeypatch):
    """Phase 18 finds the train steps' window from the marked copies of the
    trainer's batches; on the CPU the profiler marks them (it traces no
    device time here, which the window's idle share refuses)."""
    import dataclasses

    from iterative_inference_segm_tpu_torch.data.synthetic import synthetic_batches
    from iterative_inference_segm_tpu_torch.models.fcn8 import init_fcn8
    # the module (the package's ``train_dae`` is the trainer function)
    trainer = importlib.import_module("iterative_inference_segm_tpu_torch.train.train_dae")
    from iterative_inference_segm_tpu_torch.train.loop import TrainConfig

    cfg = dataclasses.replace(chip_smoke.CAMVID, n_classes=3, void_label=3, train_crop=(32, 32))
    seen = []
    monkeypatch.setattr(chip_smoke, "idle_share", lambda spans, window=None: seen.append(window) or (0, 0, 0))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)

    def epoch():
        data = list(synthetic_batches(cfg=cfg, batch_size=2, num_batches=3, height=64, width=64))
        return trainer.train_dae(
            fcn_params=init_fcn8(torch.Generator().manual_seed(0), n_classes=3, fc_channels=8), dataset=cfg,
            train_data=data[:2], val_data=data[2:], tcfg=TrainConfig(max_epochs=1), dae_depth=3,
            dae_stem_pool=1, dae_widths=(4, 8, 8))

    result, _, _ = chip_smoke.profiled_training(epoch, 2)
    assert result["epochs"] == 1 and trainer.to_device is chip_smoke.to_device
    assert seen[1] is None and seen[0][0] < seen[0][1]  # the train window, then the whole run
    with pytest.raises(AssertionError, match="marked copies"):
        chip_smoke.profiled_training(epoch, 3)


def test_split_flags_name_pack_datasets_counts():
    assert chip_smoke.split_flags(chip_smoke.EM_SPLITS) == ["--num-train", "24", "--num-val", "3", "--num-test", "3"]


def _fake_launch(plant=None):
    """A stand-in for ``launch_ranks`` that answers phases 21-24's cases as
    ranks that pass would: per rank, its stage and its kernel launches.
    ``plant(name, rank, result)`` may spoil one result."""

    def launch_ranks(fn, cases, *, mesh, device, backend, kernels):
        assert fn is chip_smoke.par_cases and set(kernels) == {"refine_tail", "corruption"}
        assert (backend, device) == ((None, "cuda") if mesh.size == 1 else ("gloo", "cuda:0"))
        out = [{} for _ in range(mesh.size)]
        for name, fname, kw in cases:
            for r in range(mesh.size):
                res = {"secs": 1.0}
                if fname == "par_dae_step":
                    res.update(k1=int(kw["from_gt"] is True), k2=int(kw["from_gt"] is False), loss=3.0, step_s=1.0)
                    if r == 0:
                        res.update(loss_rel=0.0, param_rel=0.0, param_leaf="all", moved=1e-3)
                elif fname == "par_fcn_step":
                    res.update(loss=3.0, step_s=1.0, loss_rel=0.0, moment_rel=0.0, moment_leaf="fc6/w",
                               param_rel=0.0, unset=0, total=1)
                elif fname == "par_serve":
                    per = chip_smoke.K_STEPS + (kw["engine"] == "half")
                    res.update(launches=2 * per, strided=0, agree=1.0, max_abs=0.0, off_beyond_ties=0, serve_s=1.0)
                elif fname == "par_tp":
                    res.update(logits_rel=0.0, loss_rel=0.0, grad_rel=0.0, grad_leaf="fc6/w", held=50, whole=100,
                               moments=100, step_s=0.1, shapes={"fc6": (2048,), "fc7": (4096, 2048)})
                elif fname == "par_ppgrad":
                    per = (chip_smoke.K_STEPS + 1) * (r % 2)  # the refinement stage launches the kernel
                    res.update(stage=r % 2, launches_0=2 * per, launches_1=4 * per, strided_0=0, strided_1=0,
                               checksum_0=5.0, checksum_1=5.0, secs_0=1.0, secs_1=1.0)
                    if r == 0:
                        res.update(loss=0.05, loss_rel=0.0, grad_rel=3e-7, remat_rel=0.0, nonzero=63, leaves=63)
                else:
                    sizes = kw.get("sizes", mesh.axis_sizes)
                    stage = r % sizes[-1]
                    per = chip_smoke.K_STEPS + (kw["engine"] == "half")
                    m = kw["microbatches"] * (2 if kw.get("predictor") else 1)
                    res.update(stage=stage, launches=per * m if stage == sizes[-1] - 1 else 0, strided=0, pp_s=1.0,
                               agree=1.0, agree_whole=0.999, max_abs=0.0, beyond=0.0)
                if plant:
                    plant(name, r, res)
                out[r][name] = res
        return out

    return launch_ranks


def test_parallel_phases_add_up_every_ranks_launches(monkeypatch, capsys):
    """Phases 21-25 read each rank's counts: K1 in the f32 DP steps (2 ranks
    and 1 over NCCL), K2 in the bf16 one, refine_tail in the DP Predictor's
    ranks and in the pipeline's refinement stage alone (its forward under
    autograd, again in the backward under remat)."""
    from iterative_inference_segm_tpu_torch.parallel import launch

    monkeypatch.setattr(launch, "launch_ranks", _fake_launch())
    got = chip_smoke.run_parallel_phases("NVIDIA H100 80GB HBM3, 700.00 W")
    k = chip_smoke.K_STEPS
    serve = 2 * 2 * (k + 1) + 2 * 2 * k
    pp = (k + 1) * 2 + (k + 1) * 4 + k * 2 + k * 4 + (k + 1) * 4 + (k + 1) * 4 + k * 2 + 2 * (k + 1) * 2
    ppgrad = (k + 1) * 2 + (k + 1) * 4
    assert got == {"refine_tail": serve + pp + ppgrad, "corrupt_onehot": 3, "corrupt_probs": 2}
    out = capsys.readouterr().out
    assert out.count("not a multi-card figure") >= 6 and "phases 21-25:" in out


@pytest.mark.parametrize("case,name,rank,spoil", [
    ("k1_missing_in_a_rank", "dae_f32", 1, {"k1": 0}),
    ("f32_loss_off", "dae_f32", 0, {"loss_rel": 2e-5}),
    ("nccl_params_off", "dae_nccl", 0, {"param_rel": 2e-5}),
    ("step_did_not_move", "dae_bf16", 0, {"moved": 0.0}),
    ("fcn_moments_off", "fcn", 0, {"moment_rel": 0.5}),
    ("serve_bf16_agreement", "serve_half", 0, {"agree": 0.99}),
    ("serve_f32_label_off", "serve_general", 0, {"off_beyond_ties": 1}),
    ("serve_strided", "serve_general", 1, {"strided": 1}),
    ("tp_holds_everything", "tp", 1, {"held": 100}),
    ("tp_gradient_off", "tp", 0, {"grad_rel": 1e-3}),
    ("pp_launch_in_stage_0", "pp_half_m2", 0, {"launches": 1}),
    ("pp_f32_off", "pp3_general", 0, {"max_abs": 1e-3}),
    ("pp_mirror_agreement", "pp_mirror", 0, {"agree": 0.99}),
    ("dpxpp_agreement", "dpxpp", 0, {"agree": 0.9}),
    ("ppgrad_gradient_off", "ppgrad", 0, {"grad_rel": 1e-4}),
    ("ppgrad_remat_off", "ppgrad", 0, {"remat_rel": 1e-4}),
    ("ppgrad_loss_off", "ppgrad", 0, {"loss_rel": 1e-4}),
    ("ppgrad_rank_returns_another_gradient", "ppgrad", 1, {"checksum_1": 4.0}),
    ("ppgrad_a_leaf_without_gradient", "ppgrad", 0, {"nonzero": 62}),
    ("ppgrad_launch_in_stage_0", "ppgrad", 0, {"launches_0": 1}),
    ("ppgrad_no_recompute_under_remat", "ppgrad", 1, {"launches_1": 12}),
])
def test_parallel_phases_fail_on_a_spoiled_rank(monkeypatch, case, name, rank, spoil):
    from iterative_inference_segm_tpu_torch.parallel import launch

    def plant(n, r, res):
        if (n, r) == (name, rank):
            res.update(spoil)

    monkeypatch.setattr(launch, "launch_ranks", _fake_launch(plant))
    with pytest.raises(AssertionError):
        chip_smoke.run_parallel_phases("card")


def test_leaf_rel_names_the_worst_leaf():
    a = {"x": {"w": torch.tensor([1.0, 2.0])}, "y": {"b": torch.tensor([4.0])}}
    b = {"x": {"w": torch.tensor([1.0, 2.5])}, "y": {"b": torch.tensor([4.0])}}
    assert chip_smoke._leaf_rel(a, b) == (0.2, "x/w")
    assert chip_smoke._leaf_rel(a, a) == (0.0, "all")


SMI = "NVIDIA H100 80GB HBM3, 700.00 W"


def _fake_bench(spoil=None):
    """A stand-in for the bench twin's main that launches refine_tail as the
    configuration's forwards would, and prints a line stamped with SMI."""

    def main(argv):
        args = chip_smoke.bench_tool.parse_args(argv)
        per = 0 if args.mode == "energy" else args.steps + (args.engine == "half")
        chip_smoke.refine_tail.launches += per * (args.warmup + 3 * args.iters)
        rec = {"metric": chip_smoke.bench_tool.metric(args), "value": 100.0 * args.batch, "unit": "images/sec/chip",
               "vs_baseline": 0.1 * args.batch, "device": SMI}
        if spoil:
            spoil(args, rec)
        print(json.dumps(rec))
        return 0

    return main


def test_bench_cases_count_the_launches_of_each_configuration(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke.bench_tool, "main", _fake_bench())
    launches, readings = chip_smoke.bench_cases(SMI)
    k, forwards = chip_smoke.K_STEPS, chip_smoke.BENCH_WARMUP + 3 * chip_smoke.BENCH_ITERS
    assert launches == forwards * (4 * (k + 1) + 1 + k)  # b128, b8, b32, fast; steps 0; general; energy none
    assert readings["b128"] == 12800.0 and set(readings) == {name for name, _, _ in chip_smoke.BENCH_CASES}
    assert capsys.readouterr().out.count("[bench]") == len(chip_smoke.BENCH_CASES)


@pytest.mark.parametrize("what", ["launch", "device", "frontier"])
def test_bench_cases_fail_on_a_wrong_count_stamp_or_key(monkeypatch, what):
    def spoil(args, rec):
        if args.batch == 8 and args.engine == "general" and args.mode == "energy":
            if what == "launch":
                chip_smoke.refine_tail.launches += 1
            elif what == "device":
                rec["device"] = "cpu"
            else:
                rec["frontier"] = "a TPU table"

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke.bench_tool, "main", _fake_bench(spoil))
    with pytest.raises(AssertionError, match="bench energy"):
        chip_smoke.bench_cases(SMI)


@pytest.mark.parametrize("spoil", [None, "b128"])
def test_bench_kernel_cases_hold_each_configuration_at_its_batches(monkeypatch, capsys, spoil):
    """refine_tail at what each configuration hands it (recorded through the
    twins' own pipelines at a small size), at each batch the phases run:
    the folded half engine's step and rectification at batch 8, 32 and 128,
    the fast preset's at 128, the general engine's step at 8, serve_bench's
    at 32; a kernel wrong at batch 128 alone fails the run."""
    from iterative_inference_segm_tpu_torch.models.dae import DAE_H_CHANNELS, init_dae
    from iterative_inference_segm_tpu_torch.models.fcn8 import init_fcn8

    init = chip_smoke.bench_tool.init_params
    monkeypatch.setattr(chip_smoke.bench_tool, "init_params", lambda args, dev: init(
        type(args)(**{**vars(args), "fc_channels": 16, "dae_widths": [8, 16, 32]}), dev))
    monkeypatch.setattr(chip_smoke, "flagship_params", lambda dev: (
        init_fcn8(torch.Generator().manual_seed(0), n_classes=11, fc_channels=16),
        init_dae(torch.Generator().manual_seed(1), n_classes=11, h_specs={"pool4": DAE_H_CHANNELS["pool4"]},
                 depth=3, stem_pool=1, widths=(8, 16, 32))))
    monkeypatch.setattr(chip_smoke, "H", 48)
    monkeypatch.setattr(chip_smoke, "W", 64)
    if spoil:
        kernel = chip_smoke.tail_bench.Case.kernel

        def spoiled(case):
            out = kernel(case)
            y = out[0] if case.with_labels else out
            if y.shape[0] == 128:
                y[0, 0, 0] += 0.25
            return out

        monkeypatch.setattr(chip_smoke.tail_bench.Case, "kernel", spoiled)
        with pytest.raises(AssertionError, match="bench step b128"):
            chip_smoke.bench_kernel_cases("cpu")
        return
    assert chip_smoke.bench_kernel_cases("cpu") == 0.0
    lines = [ln for ln in capsys.readouterr().out.splitlines() if "refine_tail, " in ln]
    names = [ln.split("refine_tail, ")[1].split(":")[0] for ln in lines]
    assert names == [f"bench {site} b{b} bfloat16" for b in (8, 32, 128) for site in ("step", "rect")] + [
        "bench fast step b128 bfloat16", "bench fast rect b128 bfloat16", "bench general step b8 bfloat16",
        "serve_bench step b32 bfloat16", "serve_bench rect b32 bfloat16"]
    # the pool encoder's folded step takes (u, v), the stride encoder's (fast) also the bias b
    assert all(("v True b True" if "fast" in ln else "v True b False") in ln
               for ln in lines if " step b" in ln and "general" not in ln)


@pytest.mark.parametrize("spoil", [None, "k1_short", "oom"])
def test_tbench_phase_wants_one_k1_launch_a_dae_step(monkeypatch, spoil):
    def main(argv):
        args = chip_smoke.train_tool.parse_args(argv)
        for crop in args.crops:
            for augment in chip_smoke.train_tool.augment_settings(args):
                for label in ("FCN-8", "DAE(stem1,d3)"):
                    rec = {"metric": chip_smoke.train_tool.metric(args, label, crop, 32, augment), "value": 1.0,
                           "mfu_pct": 1.0, "device": SMI}
                    if spoil == "oom" and label == "FCN-8":
                        rec = chip_smoke.train_tool.oom_line(args, crop, 32, augment) | {"device": SMI}
                    print(json.dumps(rec))
                    if label.startswith("DAE"):
                        chip_smoke.ck.corrupt_onehot.launches += 1 + 3 * args.iters - (spoil == "k1_short")
        return 0

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(chip_smoke.train_tool, "main", main)
    if spoil is None:
        assert chip_smoke.run_tbench_phase("cpu", SMI) == 2 * 2 * (1 + 3 * 3)
    else:
        with pytest.raises(AssertionError, match="tbench"):
            chip_smoke.run_tbench_phase("cpu", SMI)


@pytest.mark.parametrize("spoil", [None, "wires", "launches"])
def test_sbench_phase_holds_the_wires_to_each_other(monkeypatch, spoil):
    def run(args, fcn, dae, dev):
        forwards = 1 + max(args.num_batches * args.epochs, 8) + 2 * args.epochs * args.num_batches
        chip_smoke.refine_tail.launches += (chip_smoke.K_STEPS + 1) * forwards - (spoil == "launches")
        sums = {"compute": 1000, "e2e_f32": [1000, 2000], "e2e_u8": [1000, 2000 + (spoil == "wires")]}
        return {"compute": 1.0, "e2e_f32": 1.0, "e2e_u8": 1.0}, sums

    monkeypatch.setattr(chip_smoke.serve_tool, "run", run)
    monkeypatch.setattr(chip_smoke.serve_tool, "device_stamp", lambda dev: SMI)
    if spoil is None:
        assert chip_smoke.run_sbench_phase("cpu", None, None, SMI) == (chip_smoke.K_STEPS + 1) * 25
    else:
        with pytest.raises(AssertionError, match="sbench"):
            chip_smoke.run_sbench_phase("cpu", None, None, SMI)


def test_entry_phase_wants_the_jax_line(monkeypatch):
    from iterative_inference_segm_tpu_torch.scripts import _parallel

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(_parallel, "check_device", lambda device: None)

    def fake_entry(dev):
        def forward(f, d, x):
            chip_smoke.refine_tail.launches += chip_smoke.K_STEPS + 1
            return torch.full((1, chip_smoke.H, chip_smoke.W, chip_smoke.N_CLASSES), 1.0 / chip_smoke.N_CLASSES,
                              dtype=torch.bfloat16)

        return forward, (None, None, None)

    monkeypatch.setattr(chip_smoke.entry_point, "entry", fake_entry)
    assert chip_smoke.run_entry_phase("cpu") == 2 * (chip_smoke.K_STEPS + 1)
    monkeypatch.setattr(chip_smoke, "ENTRY_LINE", "entry() OK (1, 360, 480, 11) bfloat16")
    with pytest.raises(AssertionError, match="entry"):
        chip_smoke.run_entry_phase("cpu")


def _fake_space_launch(plant=None):
    """A stand-in for phase 30's one launch: 2 ranks that pass, each with
    its exchanges and launches. ``plant(rank, result)`` may spoil one."""
    k = chip_smoke.K_STEPS

    def launch_ranks(fn, cases, *, mesh, device, backend, kernels):
        assert fn is chip_smoke.par_cases and cases == [("space", "par_space", {})]
        assert (mesh.axis_names, mesh.axis_sizes, backend, device) == (("data", "space"), (1, 2), "gloo", "cuda:0")
        assert set(kernels) == {"refine_tail", "corruption"}
        out = []
        for r in range(2):
            res = {"secs": 1.0, "fcn_s": 1.0, "general_s": 1.0, "half_s": 1.0, "step_s": 1.0, "loss": 2.0,
                   "log": {"isend": [(r, 1 - r)] * 3, "irecv": [(r, 1 - r)] * 3, "all_gather_cat": 0,
                           "all_reduce_": 0},
                   "k3": 3 + k + 1, "strided": 0, "k1": 1, "tail_err": 1e-7, "tail_agree": 1.0, "tail_layouts": 4,
                   "k1_equal": True, "k1_shapes": [(2, 224, 224)]}
            if r == 0:
                names = ("fcn", "g0", "gk", "h0", "hk")
                res.update(err={n: 1e-6 for n in names}, agree={n: 1.0 for n in names}, loss_rel=1e-7, m1_rel=1e-6,
                           m1_leaf="enc1/w")
            if plant:
                plant(r, res)
            out.append({"space": res})
        return out

    return launch_ranks


@pytest.mark.parametrize("case,rank,spoil", [
    (None, 0, {}),
    ("a_gather", 1, {"log": {"isend": [(1, 0)], "irecv": [(1, 0)], "all_gather_cat": 1, "all_reduce_": 0}}),
    ("an_all_reduce", 0, {"log": {"isend": [(0, 1)], "irecv": [(0, 1)], "all_gather_cat": 0, "all_reduce_": 1}}),
    ("no_halo", 0, {"log": {"isend": [], "irecv": [], "all_gather_cat": 0, "all_reduce_": 0}}),
    ("k3_missing_in_a_rank", 1, {"k3": 0}),
    ("k1_missing_in_a_rank", 1, {"k1": 0}),
    ("k3_strided", 0, {"strided": 1}),
    ("k3_off_its_plain_version", 1, {"tail_err": 1e-3}),
    ("k1_off_its_plain_version", 1, {"k1_equal": False}),
    ("y_k_off", 0, {"err": {"fcn": 1e-6, "g0": 1e-6, "gk": 1e-3, "h0": 1e-6, "hk": 1e-6}}),
    ("half_argmax_off", 0, {"agree": {"fcn": 1.0, "g0": 1.0, "gk": 1.0, "h0": 1.0, "hk": 0.99}}),
    ("step_loss_off", 0, {"loss_rel": 1e-4}),
    ("step_gradient_off", 0, {"m1_rel": 1e-3}),
])
def test_space_phase_holds_the_ranks_to_one_process_and_the_contract(monkeypatch, capsys, case, rank, spoil):
    """Phase 30's checks over every rank: the FCN forward's exchanges
    (neighbours only, no gather, no all-reduce at 12 /32 rows over 2), the
    launches each rank must make, the kernels against their plain versions,
    the sharded runs against one process; then ``multichip 4``'s line."""
    from iterative_inference_segm_tpu_torch.parallel import launch

    def plant(r, res):
        if r == rank:
            res.update(spoil)

    def multichip(argv):
        assert argv == ["multichip", "4"]
        print(chip_smoke.MULTICHIP_LINE)
        return 0

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(launch, "launch_ranks", _fake_space_launch(plant))
    monkeypatch.setattr(chip_smoke.entry_point, "main", multichip)
    if case is None:
        got = chip_smoke.run_space_phase(SMI)
        assert got == {"refine_tail": 2 * (3 + chip_smoke.K_STEPS + 1), "corrupt_onehot": 2}
        out = capsys.readouterr().out
        assert "dryrun_multichip(4) OK" in out and "not a speed figure" in out
    else:
        with pytest.raises(AssertionError, match="space"):
            chip_smoke.run_space_phase(SMI)


def test_septail_bound_counts_each_byte_once_and_the_codes_operations():
    """Phase 31's bound at the bench step: y_ph read and written once, s read
    once (1.095 GB in bf16, 0.327 ms at 3.35 TB/s, bytes-bound over the
    operations counted from the kernel's code)."""
    assert chip_smoke.septail_ops(11) == 2 * 13 + 22 + 1 + 27 + 2
    y_ph = torch.empty((128, 2, 2, 11, 180, 240), dtype=torch.bfloat16, device="meta")
    s = torch.empty((128, 180, 240, 11), dtype=torch.bfloat16, device="meta")
    b = chip_smoke.septail_bound(y_ph, s)
    assert b["bytes"] == 2 * 243302400 * 2 + 60825600 * 2 == 1094860800
    assert b["bound_by"] == "bytes" and abs(b["bound_ms"] - 1094860800 / 3.35e9) < 1e-9
    assert b["flops"] == 4 * 128 * 180 * 240 * 11 * chip_smoke.septail_ops(11)


def test_fused_edge_cases_reach_every_instance_and_edge():
    cases = {c[0]: c for c in chip_smoke.FUSED_EDGE}
    assert {c[2] for c in cases.values()} == {2, 11, 33}  # the 16-class, exact and wide instances
    assert any(c[3] == c[4] == 1 for c in cases.values())  # a 2x2 frame: every tap on an edge
    assert {c[5] for c in cases.values()} == {False, True}  # NHWC and channel-leading s
    assert {c[6] for c in cases.values()} == {torch.float32, torch.bfloat16}


def test_fused_edge_cases_reach_the_tile_edges_and_both_stagings():
    # the tiled form's 12 x 16 tile: Hh and Wh one below and one above a multiple of it, maps smaller
    # than one tile, y_ph staged by 16-byte copies (whole 16-byte rows) and a value at a time, at batch > 1
    tj, tu = 12, 16
    tiled = [c for c in chip_smoke.FUSED_EDGE if c[2] <= 16 and c[1] > 1]
    assert {c[3] % tj for c in tiled} >= {tj - 1, 1} and {c[4] % tu for c in tiled} >= {tu - 1, 1}
    assert any(c[3] < tj and c[4] < tu and c[3] * c[4] > 1 for c in tiled)

    def by_copies(c):
        return c[4] * (2 if c[6] == torch.bfloat16 else 4) % 16 == 0

    for dt in (torch.float32, torch.bfloat16):
        assert {by_copies(c) for c in tiled if c[6] == dt} == {False, True}
    assert {c[5] for c in tiled if by_copies(c)} == {False, True} == {c[5] for c in tiled if not by_copies(c)}
    assert any(c[4] % tu and by_copies(c) for c in tiled)  # a ragged tile by 16-byte copies


def _septail_log(tmp_path, bf16_exact=True):
    mangled = {
        "bf16": "_ZN12_GLOBAL__N_119septail_tile_kernelI13__nv_bfloat16Li11ELb1ELi2ELi3EEEvNS_10TileParamsE",
        "f32": "_ZN12_GLOBAL__N_119septail_tile_kernelIfLi11ELb1ELi2ELi3EEEvNS_10TileParamsE",
        "wide": "_ZN12_GLOBAL__N_119septail_step_kernelIfLi128ELb0EEEvNS_6ParamsE",
    }
    if not bf16_exact:
        del mangled["bf16"]
    lines = []
    for i, name in enumerate(mangled.values()):
        lines += [f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
                  f"    0 bytes stack frame, {4 * i} bytes spill stores, {4 * i} bytes spill loads",
                  f"ptxas info    : Used {100 + i} registers, used 1 barriers, 400 bytes cmem[0]"]
    lib = tmp_path / "libseptail_step-0.so"
    lib.with_suffix(".log").write_text("\n".join(lines) + "\n")
    return lib


@pytest.mark.parametrize("bf16_exact", [True, False])
def test_septail_instances_read_ptxas_and_each_launch_plan(monkeypatch, tmp_path, capsys, bf16_exact):
    lib = _septail_log(tmp_path, bf16_exact)
    monkeypatch.setattr(chip_smoke._build, "build", lambda name: lib)
    monkeypatch.setattr(chip_smoke, "sass_counts", lambda lib: {
        "septail_tile_kernel<fLi11ELb1ELi2ELi3>": {"instructions": 4096, "stg128": 0, "stg32": 44}})
    asked = []

    def plan(dt, c, wh, dev):
        asked.append((dt, c, wh))
        return {"form": "tiled" if c <= 16 else "first", "threads": 192, "smem_bytes": 1000 * c,
                "blocks_per_sm": 3, "registers": 100, "cp_async": wh % 8 == 0}

    monkeypatch.setattr(chip_smoke, "septail_plan", plan)
    if not bf16_exact:
        with pytest.raises(AssertionError, match="no tiled C=11 instance"):
            chip_smoke.septail_instances("cpu", 240)
        return
    plans = chip_smoke.septail_instances("cpu", 240)
    assert sorted(asked, key=str) == sorted(((dt, c, 240) for dt in (torch.bfloat16, torch.float32)
                                             for c in (11, 2, 33)), key=str)
    b, f = plans[(torch.bfloat16, 11)], plans[(torch.float32, 11)]
    assert b["instance"].startswith("septail_tile_kernel<13__nv_bfloat16Li11") and b["spill"] == "spill 0/0 B"
    assert f["instance"].startswith("septail_tile_kernel<fLi11") and f["spill"] == "spill 4/4 B"
    assert b["static_smem"] == 0 and plans[(torch.float32, 33)]["form"] == "first"
    assert f["sass_instructions"] == 4096 and b["sass_instructions"] is None
    out = capsys.readouterr().out
    assert "101 registers, spill 4/4 B, 0 B static shared (ptxas); 4096 static SASS instructions" in out


@pytest.mark.parametrize("spoil", [None, "ulp", "dtype", "strides"])
def test_check_septail_holds_the_kernel_to_its_plain_version(monkeypatch, spoil):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    y_ph, s, w = chip_smoke.septail_inputs("cpu", 2, 11, 8, 12, True, torch.bfloat16, 0)
    assert not s.is_contiguous() and s.stride()[3] == 8 * 12  # channel-leading memory, NHWC shape
    real = chip_smoke.septail_step

    def spoiled(*args):
        out = real(*args)
        if spoil == "ulp":
            out = out.clone()
            out[1, 1, 0, 3, 4, 5] += 2.0**-6
        elif spoil == "dtype":
            out = out.float()
        elif spoil == "strides":
            out = out.transpose(-1, -2).contiguous().transpose(-1, -2)
        return out

    monkeypatch.setattr(chip_smoke, "septail_step", spoiled)
    if spoil:
        with pytest.raises(AssertionError, match="septail_step edge"):
            chip_smoke.check_septail("edge", y_ph, s, w)
        return
    assert chip_smoke.check_septail("edge", y_ph, s, w) == (0.0, 1.0)


def test_record_septail_sees_each_step_and_restores_the_engine():
    from iterative_inference_segm_tpu_torch.inference import fused
    from iterative_inference_segm_tpu_torch.models.dae import init_dae

    dae = init_dae(torch.Generator().manual_seed(1), n_classes=5, h_specs={}, depth=2, stem_pool=1, tail="sep",
                   widths=(8, 16))
    y0 = torch.softmax(torch.randn((1, 16, 24, 5), generator=torch.Generator().manual_seed(2)), -1)
    real = fused.septail_step
    recs = chip_smoke.record_septail(lambda: fused.fused_refinement_scan(
        dae, lambda yp: chip_smoke.dae_core(dae, yp, depth=2, stem_pool=1), y0, eps=0.1, num_steps=3))
    assert fused.septail_step is real and len(recs) == 3
    assert recs[0]["y_ph"][0] == (1, 2, 2, 5, 8, 12) and recs[0]["s"][0] == (1, 8, 12, 5)


def _fake_fused_tools(spoil=None):
    """Stand-ins for the bench twin's and the fused_bench twin's mains that
    launch septail_step and refine_tail as their forwards would."""

    def bench_main(argv):
        args = chip_smoke.bench_tool.parse_args(argv)
        chip_smoke.septail_step.launches += args.steps * (args.warmup + 3 * args.iters) + (spoil == "bench")
        print(json.dumps({"metric": chip_smoke.bench_tool.metric(args), "value": 880.0, "unit": "images/sec/chip",
                          "vs_baseline": 0.88, "device": SMI}))
        return 0

    def fused_main(argv):
        args = chip_smoke.fused_tool.parse_args(argv)
        n = 2 * args.steps * (1 + 3 * args.iters)
        chip_smoke.septail_step.launches += n
        chip_smoke.refine_tail.launches += n - (spoil == "fused_bench")
        print(f"device: {SMI}")
        for label in ("full tail, general engine", "sep tail, general engine", "sep tail, FUSED bf16 state",
                      "sep tail, FUSED f32 state"):
            print(f"{label + f' (K={args.steps})':<44s} {150.0:8.2f} ms/iter {1.17:7.4f} ms/img -> {853.3:7.1f} img/s")
        return 0

    return bench_main, fused_main


@pytest.mark.parametrize("spoil", [None, "bench", "fused_bench"])
def test_fused_main_path_counts_k_launches_a_forward(monkeypatch, capsys, spoil):
    """Phase 31's main path over stand-ins for the two twins: septail_step K
    a forward in both, refine_tail K a forward of the general variants; a
    wrong count fails the run. Only the twins' forwards are counted."""
    from iterative_inference_segm_tpu_torch.ops.septail_step import septail_step

    bench_main, fused_main = _fake_fused_tools(spoil)
    monkeypatch.setattr(chip_smoke.bench_tool, "main", bench_main)
    monkeypatch.setattr(chip_smoke.fused_tool, "main", fused_main)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(septail_step, "launches", 0)
    monkeypatch.setattr(chip_smoke.refine_tail, "launches", 0)
    if spoil:
        with pytest.raises(AssertionError, match="fused bench|fused_bench"):
            chip_smoke.run_fused_main_path(SMI)
        return
    readings = chip_smoke.run_fused_main_path(SMI)
    k = chip_smoke.K_STEPS
    assert septail_step.launches == 2 * k * (chip_smoke.BENCH_WARMUP + 3 * chip_smoke.BENCH_ITERS) + 2 * k * (
        1 + 3 * chip_smoke.FUSED_BENCH_ITERS)
    assert chip_smoke.refine_tail.launches == 2 * k * (1 + 3 * chip_smoke.FUSED_BENCH_ITERS)
    assert readings["bench fused bf16"] == readings["bench fused f32"] == 880.0
    assert readings["sep tail, FUSED f32 state"] == 853.3 and len(readings) == 6


@pytest.mark.parametrize("spoil", [None, "no_kernel"])
def test_fused_engine_checks_run_outside_the_counted_window(monkeypatch, capsys, spoil):
    """Phase 31's engine checks at a tiny size on the CPU (run for real): the
    engine against the general engine, make_fused_refiner card against CPU,
    then one bench forward under a stand-in for the profiler; a profile that
    traced no septail_step kernel fails the run."""
    from iterative_inference_segm_tpu_torch.tools import profile_general

    parse = chip_smoke.bench_tool.parse_args
    monkeypatch.setattr(chip_smoke.bench_tool, "parse_args", lambda argv: type(parse(argv))(
        **{**vars(parse(argv)), "batch": 1, "fc_channels": 16, "dae_widths": [8, 16, 32]}))
    monkeypatch.setattr(chip_smoke, "H", 32)
    monkeypatch.setattr(chip_smoke, "W", 32)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    seen = []

    def fake_profile(refine, x, iters, tail):
        seen.append((tuple(x.shape), int(refine(x)), tail))
        name = "other_kernel" if spoil else "septail_tile_kernel<bf16>"
        return {"event_ms": 2.0, **profile_general.summarize([("conv", 600.0), (name, 200.0)], iters, 0.8, tail)}

    monkeypatch.setattr(chip_smoke.profile_tool, "profile", fake_profile)
    if spoil:
        with pytest.raises(AssertionError, match="no septail_step kernel"):
            chip_smoke.run_fused_engine_checks("cpu", SMI)
        return
    prof = chip_smoke.run_fused_engine_checks("cpu", SMI)
    assert seen == [((1, 32, 32, 3), seen[0][1], "septail_")]  # either form's kernel
    assert prof["tail"] == [("septail_tile_kernel<bf16>", pytest.approx(0.1), pytest.approx(0.25))]
    out = capsys.readouterr().out
    assert "make_fused_refiner, 1 image, f32, card vs CPU" in out and "against the general engine" in out
    assert "septail_step 0.100 ms a forward (25.0% of device time)" in out


def _probe_line(name, **kw):
    rec = {"probe": name, "label": "row", "ms": 2.0, "ms_per_img": 1.0, "batch": 2, "value": 3.0, "device": SMI}
    rec.update(kw)
    return json.dumps(rec)


@pytest.mark.parametrize("spoil", [None, "probe", "device", "ms", "value", "per_img", "check", "derived", "report"])
def test_check_probe_lines_takes_only_stamped_finite_rows(spoil):
    """Phase 32's check of a twin's lines: each its probe's and stamped with
    the card; a timed row's ms positive and its value finite; a derived row
    (a delta may be negative) finite; a check within its limit, one that
    only reports (``"asserted": false``) finite."""
    lines = [_probe_line("perf_probe"), _probe_line("perf_probe", label="delta", derived=True, ms=-0.5),
             _probe_line("perf_probe", label="equivalence", check=True, max_abs_err=1e-3, limit=2e-3),
             _probe_line("perf_probe", label="equality C", check=True, max_abs_err=0.5, limit=0.0, asserted=False)]
    bad = {"probe": _probe_line("pool_probe"), "device": _probe_line("perf_probe", device="cpu"),
           "ms": _probe_line("perf_probe", ms=0.0, ms_per_img=0.0),
           "value": _probe_line("perf_probe", value=float("nan")),
           "per_img": _probe_line("perf_probe", ms_per_img=2.0),
           "check": _probe_line("perf_probe", check=True, max_abs_err=3e-3, limit=2e-3),
           "derived": _probe_line("perf_probe", derived=True, ms=float("inf")),
           "report": _probe_line("perf_probe", check=True, max_abs_err=float("nan"), limit=0.0, asserted=False)}
    if spoil:
        with pytest.raises(AssertionError, match="perf_probe line"):
            chip_smoke.check_probe_lines("perf_probe", lines + [bad[spoil]], SMI)
        return
    assert len(chip_smoke.check_probe_lines("perf_probe", lines, SMI)) == 4


def _fake_probes(spoil=None):
    """Stand-ins for the eighteen twins: each prints a row and launches
    refine_tail and septail_step as PROBE_RUNS says its rows do."""
    import types

    fakes = []
    for module, argv, k3, s1, k3_once in chip_smoke.PROBE_RUNS:
        name = chip_smoke.probe_name(module)

        def main(args, name=name, k3=k3, s1=s1, k3_once=k3_once):
            assert args[-4:] == ["--iters", str(chip_smoke.PROBE_ITERS), "--repeats", "1"]
            chip_smoke.refine_tail.launches += k3 * chip_smoke.PROBE_CALLS + k3_once + (spoil == name)
            chip_smoke.septail_step.launches += s1 * chip_smoke.PROBE_CALLS
            labels = {"half_probe": "flagship d3 (32,64,128): FULL pipeline K=5", "fcn_block_probe": "delta fc6+fc7"}
            print(_probe_line(name, label=labels.get(name, "row"), ms=150.0, ms_per_img=75.0))
            return 0

        fakes.append((types.SimpleNamespace(__name__=module.__name__, main=main), argv, k3, s1, k3_once))
    return fakes


@pytest.mark.parametrize("spoil", [None, "perf_probe", "half_probe", "scan_variants_probe", "tailfold_probe"])
def test_probe_main_path_counts_the_launches_each_twin_implies(monkeypatch, capsys, spoil):
    """Phase 32's main path over stand-ins for the twins: K3 launched as
    perf_probe's, pipeline_probe's, half_probe's, tailfold_probe's and
    scan_variants_probe's rows imply (the last's four K = 5 pipelines, its
    graph replays counted, and its two captured rows each held once to a
    replay and an uncaptured loop; tailfold_probe's f32 check once), S1 as
    fused_probe's; a wrong count fails the run."""
    monkeypatch.setattr(chip_smoke, "PROBE_RUNS", _fake_probes(spoil))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke.refine_tail, "launches", 0)
    monkeypatch.setattr(chip_smoke.refine_tail, "strided_launches", 0)
    monkeypatch.setattr(chip_smoke.septail_step, "launches", 0)
    if spoil:
        with pytest.raises(AssertionError, match=f"{spoil} launched"):
            chip_smoke.probe_main_path(SMI)
        return
    recs, k3, s1, walls = chip_smoke.probe_main_path(SMI)
    k, calls = chip_smoke.K_STEPS, chip_smoke.PROBE_CALLS
    assert k3 == calls * (2 * k * len(chip_smoke.PROBE_BATCHES) + (1 + k + 2) + 4 * (k + 1) + 1 + 4 * k) + 1 + 4 * k
    assert s1 == calls and len(recs) == 18 and set(walls) == set(recs)
    assert {chip_smoke.probe_name(m) for m in chip_smoke.LATER_PROBES} <= set(recs)
    assert chip_smoke.PROBE_RUNS[0][1] == ["--batches", 4, 8, 16, 32, 128]
    assert capsys.readouterr().out.count("lines in") == 18


def test_probe_kernel_checks_hold_the_rows_and_a_spoiled_kernel_fails(monkeypatch, capsys):
    """Phase 32's kernel rows at a tiny size on the CPU (the wrappers take
    their plain versions there): held to their plain versions and op-by-op
    rows; a kernel one bf16 ulp-and-a-bit off fails."""
    from iterative_inference_segm_tpu_torch.ops import refine_tail as rt

    monkeypatch.setattr(chip_smoke, "H", 16)
    monkeypatch.setattr(chip_smoke, "W", 24)
    monkeypatch.setattr(chip_smoke.pipeline_probe, "parse_args", lambda argv: type("A", (), {"batch": 2}))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    worst = chip_smoke.probe_kernel_checks("cpu")
    assert worst["refine_tail"] <= chip_smoke.BF16_TOL and worst["septail_step"] <= chip_smoke.BF16_TOL
    out = capsys.readouterr().out
    assert out.count("against its plain version") == 6 and out.count("differing only at near-ties True") == 12
    assert out.count("scan_variants_probe pipeline step") == 4 and out.count("tailfold_probe") == 2
    real = rt.refine_tail_reference  # what the wrapper runs on a CPU tensor; chip_smoke holds its own name
    monkeypatch.setattr(rt, "refine_tail_reference", lambda *a, **k: real(*a, **k) + 2.0**-6)
    with pytest.raises(AssertionError, match="pipeline_probe 'tail: deconv"):
        chip_smoke.probe_kernel_checks("cpu")


def test_probe_conv_traces_print_each_rows_top_kernels(monkeypatch, capsys):
    """Phase 32's traces of tail2_probe's three conv rows and tailfold_probe's
    v1 and v2 steps, over a stand-in for the profiler at a tiny size: each
    row runs, and its top three kernels are printed."""
    monkeypatch.setattr(chip_smoke, "H", 16)
    monkeypatch.setattr(chip_smoke, "W", 24)
    monkeypatch.setattr(chip_smoke.pipeline_probe, "parse_args", lambda argv: type("A", (), {"batch": 1}))
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    shapes = []

    def fake_profile(refine, x, iters):
        shapes.append(tuple(refine(x)[0].shape))
        return {"event_ms": 1.0, "device_ms": 0.9, "top": [(f"kernel{i}", 0.3 - 0.1 * i, 0.3) for i in range(4)]}

    monkeypatch.setattr(chip_smoke.profile_tool, "profile", fake_profile)
    tops = chip_smoke.probe_conv_traces("cpu")
    assert list(tops) == [*(f"tail2_probe '{label}'" for label in chip_smoke.tail2_probe.CONV_LABELS),
                          "tailfold_probe step v1", "tailfold_probe step v2"]
    assert shapes == [(1, 16, 24, 11), (1, 11, 16, 24), (1, 11, 16, 24), (1, 8, 12, 11), (1, 8, 12, 11)]
    out = capsys.readouterr().out
    assert out.count("top kernels: kernel0 0.300 ms (30.0%); kernel1") == 5 and "kernel3" not in out


@pytest.mark.parametrize("rc", [0, 1])
def test_fresh_conv_traces_relay_the_lines_and_a_failure_raises(monkeypatch, capsys, rc):
    """The conv traces run in a fresh process (``python -c`` importing
    chip_smoke from its own directory): its lines are printed here; a
    non-zero exit raises with its stderr."""
    import types

    seen = []

    def fake_run(cmd, cwd, **kw):
        seen.append((cmd[1:], cwd))
        return types.SimpleNamespace(returncode=rc, stdout="[probes] a trace line\n", stderr="boom")

    monkeypatch.setattr(chip_smoke.subprocess, "run", fake_run)
    if rc:
        with pytest.raises(AssertionError, match="conv traces failed: boom"):
            chip_smoke.fresh_conv_traces()
        return
    assert chip_smoke.fresh_conv_traces() >= 0.0
    assert "[probes] a trace line" in capsys.readouterr().out
    (args, cwd), = seen
    assert args[0] == "-c" and "chip_smoke.probe_conv_traces" in args[1]
    assert (pathlib.Path(cwd) / "chip_smoke.py").is_file()


@pytest.mark.parametrize("spoil", [None, "no_fc6"])
def test_probe_profiles_report_fc6s_share(monkeypatch, capsys, spoil):
    """Phase 32's traces over a stand-in for the profiler: the flagship at
    batch 128 and 32 through the bench twin's pipeline, fc6's convolutions'
    share printed; a trace that gives fc6 no device time fails."""
    from iterative_inference_segm_tpu_torch.tools import profile_general

    parse = chip_smoke.bench_tool.parse_args
    monkeypatch.setattr(chip_smoke.bench_tool, "parse_args", lambda argv: type(parse(argv))(
        **{**vars(parse(argv)), "batch": 1, "fc_channels": 16, "dae_widths": [8, 16, 32]}))
    monkeypatch.setattr(chip_smoke, "synthetic_batches", lambda **kw: [(
        np.zeros((1, 32, 32, 3), np.float32), None)])
    monkeypatch.setattr(chip_smoke, "H", 32)
    monkeypatch.setattr(chip_smoke, "W", 32)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    seen = []

    def fake_profile(refine, x, iters, weights):
        seen.append((tuple(x.shape), int(refine(x)) >= 0, weights))
        summary = profile_general.summarize([("conv", 600.0), ("fc6 gemm", 200.0)], iters, 0.8, "refine_tail")
        summary["by_weight"] = {w: (0.05, 0.125) for w in weights}
        summary["by_weight"][weights[0]] = (0.0 if spoil else 0.1, 0.0 if spoil else 0.25)
        return {"event_ms": 2.0, "busy_ms": 0.4, **summary}

    import numpy as np

    monkeypatch.setattr(chip_smoke.profile_tool, "profile", fake_profile)
    if spoil:
        with pytest.raises(AssertionError, match="no device time to fc6"):
            chip_smoke.probe_profiles("cpu", SMI)
        return
    profs = chip_smoke.probe_profiles("cpu", SMI)
    assert list(profs) == [128, 32] and seen == [((1, 32, 32, 3), True, tuple(chip_smoke.PROBE_LAYERS.values()))] * 2
    out = capsys.readouterr().out
    assert out.count("fc6 0.100 ms (25.0% of device time)") == 2 and out.count("DAE enc1 0.050 ms (12.5%)") == 2


def test_conv_device_ms_sums_the_convolutions_of_one_weight():
    """profile_general.conv_device_ms over stand-in trace events: the
    aten::conv2d events holding the weight shape, their device time a
    forward."""
    import types

    from iterative_inference_segm_tpu_torch.tools import profile_general

    ev = [types.SimpleNamespace(name="aten::conv2d", input_shapes=[[8, 512, 12, 15], [4096, 512, 7, 7], [4096]],
                                device_time_total=3000.0),
          types.SimpleNamespace(name="aten::conv2d", input_shapes=[[8, 4096, 12, 15], [4096, 4096, 1, 1], [4096]],
                                device_time_total=900.0),
          types.SimpleNamespace(name="aten::cudnn_convolution", input_shapes=[[8, 512, 12, 15], [4096, 512, 7, 7]],
                                device_time_total=2900.0),
          types.SimpleNamespace(name="aten::conv2d", input_shapes=[[8, 512, 12, 15], [4096, 512, 7, 7], [4096]],
                                device_time_total=3000.0)]
    assert profile_general.conv_device_ms(ev, (4096, 512, 7, 7), iters=2) == pytest.approx(3.0)
    assert profile_general.conv_device_ms(ev, (11, 11, 3, 3), iters=2) == 0.0


def test_busy_us_is_the_union_of_overlapping_intervals():
    """Kernels on concurrent streams overlap: their summed durations pass the
    time the device was busy, which the idle share reads."""
    from iterative_inference_segm_tpu_torch.tools import profile_general

    assert profile_general.busy_us([(0.0, 10.0), (5.0, 12.0), (20.0, 25.0), (21.0, 22.0)]) == 17.0
    assert profile_general.busy_us([]) == 0.0


def test_chip_smoke_defines_each_top_level_name_once():
    """A phase's function defined twice silently replaces the first (phase
    11's ``run_probe_phase`` and phase 32's once shared a name)."""
    import ast
    import collections
    import pathlib

    tree = ast.parse(pathlib.Path(chip_smoke.__file__).read_text())
    names = [n.name for n in tree.body if isinstance(n, (ast.FunctionDef, ast.ClassDef))]
    names += [t.id for n in tree.body if isinstance(n, ast.Assign) for t in n.targets if isinstance(t, ast.Name)]
    assert [k for k, v in collections.Counter(names).items() if v > 1] == []
