"""``tools/tail_bench.py``, the refinement-tail kernel's timing tool, on the
CPU: the bound it times the kernel against (bytes and f32 operations from
the shapes), the call-site recorder (through ``refine_tail.layouts``: the
three sites the engines reach and the layouts they hand over; calls it
cannot place raise), the main-path cases
built from a recording, the distinct calls of a pipeline and seeded cases
at their shapes and terms at another batch, and its refusal without a
card. The timings
themselves need the card (``chip_smoke.py`` phase 3).
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from iterative_inference_segm_tpu_torch.inference import fused, iterative  # noqa: E402
from iterative_inference_segm_tpu_torch.models.dae import DAE_H_CHANNELS, init_dae  # noqa: E402
from iterative_inference_segm_tpu_torch.models.fcn8 import init_fcn8  # noqa: E402
from iterative_inference_segm_tpu_torch.ops.refine_tail import refine_tail  # noqa: E402
from iterative_inference_segm_tpu_torch.tools import tail_bench as tb  # noqa: E402


def _case(shape, dt_y, dt_u=None, v=True, labels=False, w=False):
    y = torch.zeros(shape, dtype=dt_y)
    c = shape[-1]
    return tb.Case("x", torch.zeros(shape, dtype=dt_u or dt_y), y, torch.zeros(shape, dtype=dt_y) if v else None,
                   w=torch.zeros((c, c)) if w else None, b=torch.zeros((c,)) if w else None, with_labels=labels)


@pytest.mark.parametrize("name,case,mb", [
    ("step_bf16", _case((8, 180, 240, 11), torch.bfloat16), 30.4128),
    ("rect_bf16", _case((8, 360, 480, 11), torch.bfloat16, labels=True), 127.1808),
    ("general_bf16", _case((4, 360, 480, 11), torch.float32, torch.bfloat16, v=False), 76.032),
    ("general_f32", _case((4, 360, 480, 11), torch.float32, v=False), 91.2384),
])
def test_bound_counts_each_byte_once(name, case, mb):
    """88 B/pixel for the bf16 step (u, v, y, y'), 92 with labels, 110 for
    bf16 logits beside f32 maps; memory, not operations, sets the bound."""
    got = tb.bound(case)
    assert got["bytes"] == pytest.approx(mb * 1e6) and got["bound_by"] == "bytes"
    assert got["bound_ms"] == pytest.approx(mb * 1e6 / tb.HBM_BYTES_PER_S * 1e3)


def test_bound_counts_the_class_mix_as_operations():
    """y.W adds 2C operations an element and b one; even at C=32 in bf16
    the bytes still take longer than the f32 operations."""
    got = tb.bound(_case((8, 180, 240, 32), torch.bfloat16, v=False, w=True))
    px, c = 8 * 180 * 240, 32
    assert got["flops"] == px * c * (8 + 1 + 2 * c) and got["bytes"] == px * c * 2 * 3
    t_ops = got["flops"] / tb.F32_FLOPS_PER_S * 1e3
    assert got["bound_by"] == "bytes" and got["bound_ms"] == pytest.approx(got["bytes"] / tb.HBM_BYTES_PER_S * 1e3)
    assert 0.5 < t_ops / got["bound_ms"] < 1.0


@pytest.fixture(scope="module")
def recorded():
    fcn = init_fcn8(torch.Generator().manual_seed(0), n_classes=11, fc_channels=16)
    h = {"pool4": DAE_H_CHANNELS["pool4"]}
    flag = init_dae(torch.Generator().manual_seed(1), n_classes=11, h_specs=h, depth=3, stem_pool=1, tail="full")
    gen = init_dae(torch.Generator().manual_seed(11), n_classes=11, h_specs=h, depth=4, stem_pool=0)
    return tb.record_main_path("cpu", fcn, flag, gen, hw=(48, 64))


def test_recorder_sees_the_three_sites_row_packed(recorded):
    assert set(recorded) == {"step", "rect", "general"}
    assert recorded["step"]["y"]["shape"] == (1, 24, 32, 11) and not recorded["step"]["labels"]
    assert recorded["rect"]["y"]["shape"] == (1, 48, 64, 11) and recorded["rect"]["labels"]
    gen = recorded["general"]
    assert gen["v"] is None and (gen["u"]["dtype"], gen["y"]["dtype"]) == ("bfloat16", "float32")
    for site in recorded.values():
        assert all(r["row_packed"] for r in site.values() if isinstance(r, dict))
    assert refine_tail.layouts is None  # the record is off once the recording ends


def test_recorder_refuses_calls_it_cannot_place(monkeypatch):
    """Engines that call the kernel other than once a site (here the general
    engine twice) raise instead of being given a site by guess."""
    y = torch.full((1, 4, 4, 3), 1 / 3)

    def flagship(**kw):
        return lambda *a: (refine_tail(y, y, 0.1), refine_tail(y, y, 0.1, with_labels=True))

    monkeypatch.setattr(fused, "flagship_forward_fn", flagship)
    monkeypatch.setattr(iterative, "make_refiner",
                        lambda *a, **kw: lambda x: [refine_tail(y, y, 0.1) for _ in range(2)])
    assert len(tb.layouts_of(lambda: flagship()(None))) == 2 and refine_tail.layouts is None
    with pytest.raises(RuntimeError, match="one step, one rectification and one general step"):
        tb.record_main_path("cpu", None, None, None, hw=(4, 4))
    assert refine_tail.layouts is None


def test_main_path_cases_follow_the_recording(recorded):
    cases = {c.name: c for c in tb.main_path_cases("cpu", recorded)}
    assert sorted(cases) == sorted(f"{s}_{t}" for s in ("step", "rect", "general") for t in ("bf16", "f32"))
    assert tuple(cases["step_bf16"].y.shape) == (8, 24, 32, 11) and cases["step_bf16"].v is not None
    assert cases["rect_f32"].with_labels and cases["rect_f32"].y.dtype == torch.float32
    g = cases["general_bf16"]
    assert (g.u.dtype, g.y.dtype, g.v) == (torch.bfloat16, torch.float32, None) and g.y.shape[0] == 4
    assert torch.equal(g.kernel(), g.plain())  # CPU tensors take the plain version


def test_record_layouts_keeps_each_distinct_call_with_its_terms():
    """The folded flagship at K = 2 makes two identical step calls (u, v)
    and one rectification (u, v, labels): two records, and seeded cases at
    another batch with the same shapes, dtypes and terms (``w`` and ``b``
    where a call was given them: the stride encoder's folded bias)."""
    fcn = init_fcn8(torch.Generator().manual_seed(0), n_classes=11, fc_channels=16)
    dae = init_dae(torch.Generator().manual_seed(1), n_classes=11, h_specs={"pool4": DAE_H_CHANNELS["pool4"]},
                   depth=3, stem_pool=1, tail="full", widths=(8, 16, 32))
    fwd = fused.flagship_forward_fn(num_steps=2, eps=0.1, depth=3, compute_dtype=torch.bfloat16, with_labels=True)
    x = torch.randn((1, 48, 64, 3), generator=torch.Generator().manual_seed(2))
    with torch.inference_mode():
        assert len(tb.layouts_of(lambda: fwd(fcn, dae, x))) == 3
        recs = tb.record_layouts(lambda: fwd(fcn, dae, x))
    assert [(r["labels"], r["b"], r["w"], r["v"] is not None) for r in recs] == [
        (False, False, False, True), (True, False, False, True)]
    step, rect = tb.cases_at("cpu", recs, 3, prefix="t ")
    assert (step.name, rect.name) == ("t step b3 bfloat16", "t rect b3 bfloat16")
    assert tuple(step.y.shape) == (3, 24, 32, 11) and step.v.dtype == torch.bfloat16 and step.b is None
    assert tuple(rect.y.shape) == (3, 48, 64, 11) and rect.with_labels and rect.w is None
    assert tuple(rect.u.shape[1:]) == recs[1]["u"]["shape"][1:] and rect.u.dtype == torch.bfloat16
    assert torch.equal(rect.kernel()[0], rect.plain()[0])  # CPU tensors take the plain version
    (mixed,) = tb.cases_at("cpu", [dict(recs[0], w=True, b=True)], 2)
    assert mixed.w.shape == (11, 11) and mixed.b.shape == (11,) and mixed.w.dtype == torch.float32
    again = tb.cases_at("cpu", recs, 3, prefix="t ")[0]
    assert torch.equal(again.u, step.u) and torch.equal(again.y, step.y)  # seeded


def test_tool_refuses_without_a_card():
    assert tb.main() == 1 or torch.cuda.is_available()
