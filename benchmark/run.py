"""Run one cell of the benchmark on this machine's card and print its result.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints one JSON object as the last line of standard output (see
README.md), and the numbers that decide ``correct``, each beside its limit,
as the last lines of standard error. Exits non-zero and prints no result
when the machine lacks the cards the cell needs, when the port cannot be
imported, or when the process holds a module of JAX or of the JAX package
once the window has closed.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# the checkout's root in place of this script's folder, whose module names
# (trace, check, ...) would shadow others'
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != HERE]

import argparse  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402

CACHE = Path(ROOT) / ".bench_cache"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # every compiler cache at a fixed path inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    from benchmark import harness

    cell = harness.load_cell(Path(ROOT), args.workload)
    why = harness.require_devices(cell.chips)
    if why is not None:
        print(f"run.py: {why}", file=sys.stderr)
        return 2
    result = harness.run_cell(cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                              device="cuda:0", t0=T0)
    bad = harness.forbidden_modules(list(sys.modules))
    if bad:
        print(f"run.py: the process holds modules of JAX or the JAX package: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, c in result["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
