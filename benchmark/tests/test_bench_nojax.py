"""No module of JAX or of the JAX package in a run's process; the port's own
name, which begins with the JAX package's, passes."""

import subprocess
import sys

from benchmark import harness
from benchmark.tests.bench_cells import ROOT


def test_top_level_names_compared_whole():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax", "optax._src", "orbax.checkpoint",
             "iterative_inference_segm_tpu", "iterative_inference_segm_tpu.models.fcn8",
             "iterative_inference_segm_tpu_torch", "iterative_inference_segm_tpu_torch.inference.predictor",
             "jax_fake_other", "numpy", "benchmark.harness"]
    assert harness.forbidden_modules(names) == sorted(names[:8])


RUN = """
import sys, time
from benchmark import harness
from benchmark.tests.bench_cells import load, tiny
out = harness.run_cell(tiny(load("half_b32"), fc_channels=16), seed=3, seconds=0.5, trace=True, device="cpu",
                       t0=time.perf_counter())
assert "iterative_inference_segm_tpu_torch.inference.predictor" in sys.modules
print("FORBIDDEN", harness.forbidden_modules(list(sys.modules)))
"""


def test_a_run_loads_no_jax():
    """A whole run (traced) in a fresh interpreter, without the repository's
    test configuration, which imports JAX."""
    out = subprocess.run([sys.executable, "-c", RUN], cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(ROOT), "HOME": str(ROOT)})
    assert out.returncode == 0, out.stderr[-3000:]
    assert "FORBIDDEN []" in out.stdout, out.stdout[-2000:]


def test_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "half_b32", "--seed", str(2**33 + 1),
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=600,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(ROOT), "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
