"""The CPU side of ``chip_smoke.py`` phases 3, 7 and 11: reading the build's
register report and kernel names, and the edge cases of K3, K1/K2 and K4/K5
it holds on the card (run here through the wrappers, which take the plain
versions on the CPU)."""

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
        "corrupt_kernel<Lb0ELi32ELb0>": (76, "spill 0/0 B"),
        "corrupt_kernel<Lb1ELi11ELb1>": (32, "spill 20/24 B"),
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
