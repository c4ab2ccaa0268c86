"""Seed replication of the synthetic accuracy demo (PyTorch port).

The twin of the JAX package's ``tools/seed_replication.py``: it runs
``scripts/demo_synthetic.py`` (the port's) once per config and seed, each in
a process of its own, and appends one JSON row per run to ``--history``
(``config``, ``seed``, ``wall_s`` and the demo's ``--json`` line, or ``rc``
and the end of stderr when the run failed). The configs are the JAX tool's
four, the half engine at bf16 with depth 3:

  flagship    : pool encoder,   stem_pool 1
  stride-stem1: stride encoder, stem_pool 1
  quarter     : pool encoder,   stem_pool 2
  composed    : stride encoder, stem_pool 2

Usage (on the card):
    python -m iterative_inference_segm_tpu_torch.tools.seed_replication --seeds 1,2,3
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
DEMO = "iterative_inference_segm_tpu_torch.scripts.demo_synthetic"
HISTORY = REPO / "chiprun_out" / "demo_history_torch.jsonl"

CONFIGS = {
    "flagship": ["--engine", "half", "--dae-encoder", "pool",
                 "--dae-stem-pool", "1", "--dae-depth", "3", "--bf16"],
    "stride-stem1": ["--engine", "half", "--dae-encoder", "stride",
                     "--dae-stem-pool", "1", "--dae-depth", "3", "--bf16"],
    "quarter": ["--engine", "half", "--dae-encoder", "pool",
                "--dae-stem-pool", "2", "--dae-depth", "3", "--bf16"],
    "composed": ["--engine", "half", "--dae-encoder", "stride",
                 "--dae-stem-pool", "2", "--dae-depth", "3", "--bf16"],
}


def run_one(name: str, seed: int, extra: list[str], timeout: int) -> dict:
    """One demo run in a fresh process; its row."""
    cmd = [sys.executable, "-m", DEMO, "--json", "--seed", str(seed), *CONFIGS[name], *extra]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [str(REPO), os.environ.get("PYTHONPATH")])))
    t0 = time.time()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, cwd=REPO, env=env)
    line = next((ln for ln in reversed(res.stdout.splitlines()) if ln.startswith("{")), None)
    if res.returncode or line is None:
        return {"config": name, "seed": seed, "rc": res.returncode, "error": res.stderr[-400:]}
    return {"config": name, "seed": seed, "wall_s": round(time.time() - t0, 1), **json.loads(line)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--seeds", type=str, default="1,2")
    p.add_argument("--configs", type=str, default=",".join(CONFIGS))
    p.add_argument("--timeout", type=int, default=3600, help="per run, seconds")
    p.add_argument("--history", default=str(HISTORY), help="JSON lines file the rows are appended to")
    p.add_argument("--demo-args", nargs=argparse.REMAINDER, default=[],
                   help="further demo flags, after everything else (e.g. --device cpu)")
    args = p.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",")]
    names = [c for c in args.configs.split(",") if c]
    unknown = [c for c in names if c not in CONFIGS]
    if unknown:
        raise SystemExit(f"unknown configs {unknown}; known: {sorted(CONFIGS)}")
    history = Path(args.history)
    history.parent.mkdir(parents=True, exist_ok=True)

    rc = 0
    for name in names:
        for seed in seeds:
            rec = run_one(name, seed, args.demo_args, args.timeout)
            rc |= int("rc" in rec)
            with open(history, "a") as f:
                f.write(json.dumps(rec) + "\n")
            print(json.dumps(rec), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
