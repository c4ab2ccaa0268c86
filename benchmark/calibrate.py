"""The readings that the limits of ``correct`` are set from, many seeds in
one process.

    python3 benchmark/calibrate.py --workload <name> --seeds 1-14 --control-seeds 1-4 [--calls 3]
        [--faults] [--fault half_batch --fault-seeds 1-3] [--f32-seeds 1-2]

For each seed: the cell's set-up, ``--calls`` calls of the timed path at
the cell's batch (sampled as a run samples its window), the
``return_probs`` call, then the check's numbers (``check.numbers``), and
the scale of the reference FCN's logits on the sampled frames (``logits``:
the median and largest per-pixel spread of the logits, the median and
least margin of the best over the second). For each control seed also the
numbers of the control: the reference in float8 e4m3
(``reference.fp8_e4m3``) put in the program's place, on the same frames,
and with ``--faults`` those of the reference whose every refinement step
returns its state unchanged. For each ``--fault-seeds`` seed the numbers of
the program with each ``--fault`` of ``faults.NAMES`` planted, at the
cell's size. For each ``--f32-seeds`` seed those of the program computing
in float32 with TF32 off, through the same ``Predictor``. One JSON line a
reading, then a summary line: the largest program reading and the
smallest control and fault readings of each number. Runs on the card; the
benchmark's runs never run the control.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or ".") != HERE]

import argparse  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402


def seed_list(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        a, _, b = part.partition("-")
        out.extend(range(int(a), int(b) + 1) if b else [int(a)])
    return out


def logit_scale(fcn, config, samples, device) -> dict:
    """The reference FCN's logits on the sampled frames: the per-pixel
    spread (largest less smallest) and margin (best less second), as the
    median and the extreme over every pixel."""
    import torch

    from benchmark import reference

    spread, margin = [], []
    with torch.no_grad():
        for s in samples:
            for a in range(len(s.frames)):
                y0, _ = reference.fcn8(fcn, torch.from_numpy(s.frames[a: a + 1]).to(device), config)
                logp = y0.clamp(min=1e-38).log()
                top = logp.topk(2, dim=1).values
                spread.append((logp.amax(1) - logp.amin(1)).flatten().cpu())
                margin.append((top[:, 0] - top[:, 1]).flatten().cpu())
    spread, margin = torch.cat(spread), torch.cat(margin)
    return {"spread_median": float(spread.median()), "spread_max": float(spread.max()),
            "margin_median": float(margin.median()), "margin_min": float(margin.min())}


def _served(cell, predictor, pool, seed, calls):
    import numpy as np

    from benchmark import harness, weights

    rng = np.random.default_rng(weights.sub_seed(seed, "sample"))
    _, failed, kept, _ = harness.serve(cell, predictor, pool, rng, calls=calls)
    return failed, harness.samples_of(cell, predictor, pool, rng, kept)


def readings(cell, seed: int, *, calls: int, control: bool, faults: bool, fault_names=(), f32: bool = False,
             device) -> list[dict]:
    import copy

    import torch

    from benchmark import check, harness, reference
    from benchmark import faults as planted

    fcn, dae, pool, predictor = harness.set_up(cell, seed, device)
    failed, samples = _served(cell, predictor, pool, seed, calls)
    at_fault = []
    for name in fault_names:
        with planted.plant(name):
            at_fault.append((name, *_served(cell, predictor, pool, seed, calls)))
    del predictor
    harness.free(device)
    block = int(cell.traffic["ref_block"])
    out = [{"seed": seed, "kind": "program", "failed": failed,
            **check.numbers(fcn, dae, cell.config, samples, device, block),
            "logits": logit_scale(fcn, cell.config, samples, device)}]
    for kind, stand_in, wanted in (("control", "fp8", control), ("unrefined", "unrefined", control and faults)):
        if wanted:
            out.append({"seed": seed, "kind": kind,
                        **check.numbers(fcn, dae, cell.config, samples, device, block, stand_in=stand_in)})
    for name, bad, fsamples in at_fault:
        out.append({"seed": seed, "kind": f"fault:{name}", "failed": bad,
                    **check.numbers(fcn, dae, cell.config, fsamples, device, block)})
    if f32:
        reference.exact_f32()
        cfg32 = copy.deepcopy(cell.config)
        cfg32["compute_dtype"] = "float32"
        p32 = harness.build_predictor(cfg32, fcn, dae, int(cell.traffic["batch"]), device)
        bad, s32 = _served(cell, p32, pool, seed, calls)
        del p32
        harness.free(device)
        out.append({"seed": seed, "kind": "program_f32", "failed": bad,
                    **check.numbers(fcn, dae, cell.config, s32, device, block)})
    torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seed_list, required=True)
    p.add_argument("--control-seeds", type=seed_list, default=[])
    p.add_argument("--calls", type=int, default=3)
    p.add_argument("--faults", action="store_true", help="also read the unchanged-step fault on the control seeds")
    p.add_argument("--fault", action="append", default=[], help="a fault of faults.NAMES planted in the program")
    p.add_argument("--fault-seeds", type=seed_list, default=[])
    p.add_argument("--f32-seeds", type=seed_list, default=[])
    args = p.parse_args(argv)
    from benchmark import harness

    cell = harness.load_cell(Path(ROOT), args.workload)
    why = harness.require_devices(cell.chips)
    if why is not None:
        print(f"calibrate.py: {why}", file=sys.stderr)
        return 2
    rows = []
    for seed in sorted(set(args.seeds) | set(args.control_seeds) | set(args.fault_seeds) | set(args.f32_seeds)):
        for row in readings(cell, seed, calls=args.calls, control=seed in args.control_seeds,
                            faults=args.faults, fault_names=args.fault if seed in args.fault_seeds else (),
                            f32=seed in args.f32_seeds, device="cuda:0"):
            row["workload"] = cell.name
            print(json.dumps(row), flush=True)
            rows.append(row)
    names = sorted({k for r in rows for k in r} - {"seed", "kind", "failed", "workload", "logits"})
    kinds = sorted({r["kind"] for r in rows} - {"program"})
    summary = {"workload": cell.name, "card": harness.card_stamp()}
    for n in names:
        prog = [r[n] for r in rows if r["kind"] == "program" and n in r]
        summary[n] = {"program_max": max(prog, default=None), "program_seeds": len(prog)}
        for k in kinds:
            vals = [r[n] for r in rows if r["kind"] == k and n in r]
            summary[n][f"{k}_max" if k == "program_f32" else f"{k}_min"] = (
                max(vals, default=None) if k == "program_f32" else min(vals, default=None))
            summary[n][f"{k}_seeds"] = len(vals)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
