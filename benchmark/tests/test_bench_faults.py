"""``correct`` comes out false when the served path is broken underneath.

Each test drives a whole run (set-up, window, check) on the CPU at a tiny
size, without the look for a card, with one fault of ``faults.NAMES``
planted in the port (``faults.plant``). A sound run at the same size comes
out correct.
"""

import time

import pytest

from benchmark import faults, harness
from benchmark.tests.bench_cells import load, tiny

CELLS = ("half_b32", "general_b128")


def _run(cell):
    return harness.run_cell(cell, seed=2**31 + 11, seconds=1.0, trace=False, device="cpu",
                            t0=time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out = _run(tiny(load(name)))
    assert out["correct"], out["check"]
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert list(out["check"]) == list(load(name).config["limits"])


@pytest.mark.parametrize("fault", faults.NAMES)
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault):
    with faults.plant(fault):
        out = _run(tiny(load(name)))
    assert not out["correct"], out["check"]
