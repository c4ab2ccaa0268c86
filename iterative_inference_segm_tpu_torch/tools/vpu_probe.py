"""Throughput probes K4 and K5 on the card (port of ``tools/vpu_probe.py``).

The JAX tool measured a vector-register FMA against Mosaic's lane shifts on
the TPU. On Hopper the same two kernels answer where the class-width tail
ops cross from memory-bound to compute-bound: K4 (``fma_chain``) runs
``n_fma`` chained f32 multiply-adds per element of a (160, 36, 11, 240) map
for n in {2, 26, 50, 100}, in bf16 and f32; K5 (``pattern_softmax``) runs
the separable tail's access pattern (shifted adds along W and R, then a
softmax over C) on (32, 36, 11, 240) maps. Each call is timed as the JAX
tool times it: a chain of LOOP launches, each fed the previous output
(CUDA events, best of 3 after one warm-up chain), as ms per call and ms
per image-equivalent (per call / B). The plain PyTorch version's time is
printed beside each kernel time. The marginal 26 -> 100 rate is in
multiply-adds per second over the map's 15,206,400 elements x 74 passes,
beside the card's FP32 FMA peak (SMs x 128 lanes x max SM clock), which is
arithmetic from the card's numbers, not a measurement. The crossover is
measured: K4 is also timed at n in CROSSOVER_N, and the first n whose time
exceeds the n=2 time by more than CROSSOVER_RISE is reported with the
measured point below it.

A chain is issued from the host, one launch after another, and the host
cannot issue a launch every few microseconds: a chain time near or under
0.01 ms per call is the host's launch rate, not the kernel. So
``device_sweep`` also times every case on the device alone
(``tools/tail_bench.device_times``: the calls queued behind a device-side
sleep; cold, after the L2 was flushed by reading 128 MB, the median of 30
launches, and warm, back to back), with an empty kernel launched through the
same route as the floor, and ``run`` prints those beside the chain times.

Run on a card (there is no CPU mode, and no kernel failure is caught):

    python -m iterative_inference_segm_tpu_torch.tools.vpu_probe
"""

from __future__ import annotations

import statistics
import subprocess
import sys

import torch

from iterative_inference_segm_tpu_torch.ops.vpu_probe import (
    empty_launch,
    fma_chain,
    fma_chain_reference,
    pattern_softmax,
    pattern_softmax_reference,
)
from iterative_inference_segm_tpu_torch.tools import tail_bench

R, C, W = 36, 11, 240
NH = 5
B = 32
LOOP = 20
REPS = 3
N_FMA = (2, 26, 50, 100)
CROSSOVER_N = (4, 8, 12, 16, 20)  # timed besides N_FMA, to bracket the crossover
CROSSOVER_RISE = 0.10
DTYPES = (torch.bfloat16, torch.float32)
FP32_LANES_PER_SM = 128
HOST_BOUND_RATIO = 1.25  # a chain this much slower than the warm device time waits on the host


def fma_inputs(dtype, device, seed: int = 0):
    """x (B * NH, R, C, W) ~ N(0, 1) at ``dtype``; the 8 weights 0.9..1.1."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B * NH, R, C, W), generator=g).to(device=device, dtype=dtype)
    return x, torch.linspace(0.9, 1.1, 8)


def pattern_inputs(dtype, device, seed: int = 0):
    """x (B, R, C, W) ~ N(0, 1) at ``dtype``; k = 0.5..1.5 over the classes."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B, R, C, W), generator=g).to(device=device, dtype=dtype)
    return x, torch.linspace(0.5, 1.5, C, device=device)


def chain_ms(step, x) -> float:
    """Best of REPS timings of a LOOP-launch chain ``x = step(x)``, in ms per
    call (CUDA events; one warm-up chain first)."""

    def chain():
        out = x
        for _ in range(LOOP):
            out = step(out)
        return out

    chain()
    best = float("inf")
    for _ in range(REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        chain()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / LOOP)
    return best


def launches_per_sweep() -> dict[str, int]:
    """Kernel launches one ``run`` makes: (1 warm-up + REPS) chains of LOOP
    per timed configuration."""
    per = (1 + REPS) * LOOP
    fma = per * (len(N_FMA) + len(CROSSOVER_N)) * len(DTYPES)
    return {"fma_chain": fma, "pattern_softmax": per * len(DTYPES)}


def max_sm_clock_mhz(device) -> float:
    """The card's maximum SM clock, as nvidia-smi reads it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits",
         f"--id={torch.device(device).index or 0}"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return float(out.stdout.strip().splitlines()[0])


def fp32_fma_peak(device) -> tuple[float, str]:
    """SMs x 128 x max SM clock, in multiply-adds per second, and how it was
    read: arithmetic from the card's own numbers, not a measurement."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    mhz = max_sm_clock_mhz(device)
    return sms * FP32_LANES_PER_SM * mhz * 1e6, f"{sms} SMs x {FP32_LANES_PER_SM} x {mhz:.0f} MHz"


def _line(label: str, ms: float, plain_ms: float, dev: dict | None = None) -> None:
    alone = "" if dev is None else (
        f" | on the device alone: cold {dev['cold_ms']:.4f} ms ({dev['cold_min_ms']:.4f}..{dev['cold_max_ms']:.4f}), "
        f"warm {dev['warm_ms']:.4f}, host ahead {dev['host_ahead']}; plain cold {dev['plain_cold_ms']:.4f}"
        + ("; the chain is bound by the host" if ms > HOST_BOUND_RATIO * dev["warm_ms"] else ""))
    print(f"{label:<30s} {ms:8.4f} ms/call {ms / B:8.5f} ms/img-eq | plain {plain_ms:8.4f} ms/call "
          f"{plain_ms / B:8.5f} ms/img-eq{alone}", flush=True)


def device_ms(fn, flush, plain=None) -> dict:
    """``fn``'s time on the device alone: cold (the median, least and most
    of 30 launches, each after a read flush of the L2), warm (back to back),
    the plain version's cold median of 5, and whether the host had queued
    both of the kernel's loops before their device-side sleep ended (the
    plain K4 copies its weights to the card, which waits for the sleep; its
    calls take milliseconds, which the host's wait does not change)."""
    cold, ahead_cold = tail_bench.device_times(fn, flush=flush)
    warm, ahead_warm = tail_bench.device_times(fn)
    out = {"cold_ms": statistics.median(cold), "cold_min_ms": min(cold), "cold_max_ms": max(cold),
           "warm_ms": warm[0], "host_ahead": ahead_cold and ahead_warm}
    if plain is not None:
        out["plain_cold_ms"] = statistics.median(tail_bench.device_times(plain, iters=5, flush=flush)[0])
    return out


def device_sweep(device) -> dict:
    """Every case of ``run`` (K4 over N_FMA and, without the plain version,
    CROSSOVER_N; K5; both dtypes) and an empty kernel, each timed on the
    device alone by ``device_ms``: {('fma', dtype, n) | ('pattern', dtype) |
    'empty': its dict}. Its launches are not part of ``launches_per_sweep``."""
    flush = tail_bench.flush_buffer(device)
    res = {"empty": device_ms(lambda: empty_launch(device), flush)}
    e = res["empty"]
    print(f"empty kernel, the same route: cold {e['cold_ms']:.4f} ms ({e['cold_min_ms']:.4f}..{e['cold_max_ms']:.4f}), "
          f"warm {e['warm_ms']:.4f}; host ahead {e['host_ahead']}", flush=True)
    for dt in DTYPES:
        x, w = fma_inputs(dt, device)
        wv = tuple(w.tolist())
        for n in N_FMA:
            res[("fma", dt, n)] = device_ms(lambda n=n: fma_chain(x, wv, n), flush,
                                            lambda n=n: fma_chain_reference(x, wv, n))
        for n in CROSSOVER_N:
            res[("fma", dt, n)] = device_ms(lambda n=n: fma_chain(x, wv, n), flush)
        xp, k = pattern_inputs(dt, device)
        res[("pattern", dt)] = device_ms(lambda: pattern_softmax(xp, k), flush,
                                         lambda: pattern_softmax_reference(xp, k))
    return res


def crossover(times: dict[int, float]) -> tuple[int, int | None]:
    """``(lo, hi)``: ``hi`` the first measured n whose chain time exceeds
    the n=2 time by more than CROSSOVER_RISE (None if none does), ``lo`` the
    measured n below it."""
    ns = sorted(times)
    limit = (1.0 + CROSSOVER_RISE) * times[2]
    for lo, hi in zip(ns, ns[1:]):
        if times[hi] > limit:
            return lo, hi
    return ns[-1], None


def run(device, alone: dict | None = None) -> dict:
    """The whole sweep, with ``device_sweep``'s times (``alone``) printed
    beside the chain times where given; returns {('fma', dtype, n) | ('pattern', dtype):
    {'ms', 'plain_ms'}, ('fma_ms', dtype): {n: ms} over N_FMA and
    CROSSOVER_N, ('floor', dtype): ms, ('marginal', dtype): rate,
    ('crossover', dtype): (lo, hi), with ``alone`` ('crossover_alone',
    dtype) from its cold times, 'peak': rate}."""
    res: dict = {}
    peak, how = fp32_fma_peak(device)
    res["peak"] = peak
    for dt in DTYPES:
        name = str(dt).removeprefix("torch.")
        x, w = fma_inputs(dt, device)
        wv = tuple(w.tolist())
        for n in N_FMA:
            ms = chain_ms(lambda t, n=n: fma_chain(t, wv, n), x)
            plain_ms = chain_ms(lambda t, n=n: fma_chain_reference(t, wv, n), x)
            res[("fma", dt, n)] = {"ms": ms, "plain_ms": plain_ms}
            _line(f"fma chain n={n:3d} {name}", ms, plain_ms, alone and alone[("fma", dt, n)])
        times = {n: res[("fma", dt, n)]["ms"] for n in N_FMA}
        for n in CROSSOVER_N:
            times[n] = chain_ms(lambda t, n=n: fma_chain(t, wv, n), x)
        res[("fma_ms", dt)] = times
        out = torch.empty_like(x)
        floor = chain_ms(lambda t: out.fill_(0.5), x)
        res[("floor", dt)] = floor
        dt_ms = times[100] - times[26]
        rate = x.numel() * 74 / (dt_ms * 1e-3) if dt_ms > 0 else float("inf")
        res[("marginal", dt)] = rate
        lo, hi = res[("crossover", dt)] = crossover(times)
        print(f"   store floor (fill_ of the output): {floor:.4f} ms; marginal 26->100: {dt_ms:.4f} ms for "
              f"74 passes -> {rate / 1e9:.1f} G multiply-adds/s over {x.numel()} elements, against an "
              f"FP32 FMA peak of {peak / 1e9:.1f} G/s ({how}; arithmetic, not measured): "
              f"{rate / peak:.1%}" + (" (above 100%: the 26->100 difference does not isolate the arithmetic)"
                                      if rate > peak else ""), flush=True)
        print("   fma chain ms/call by n: " + ", ".join(f"{n}: {times[n]:.4f}" for n in sorted(times)),
              flush=True)
        print(f"   crossover (measured): the time first exceeds the n=2 time {times[2]:.4f} ms by more than "
              f"{CROSSOVER_RISE:.0%} " + (f"between n={lo} and n={hi}" if hi else f"at no n up to {lo}"),
              flush=True)
        if alone is not None:
            cold = {n: alone[("fma", dt, n)]["cold_ms"] for n in times}
            lo, hi = res[("crossover_alone", dt)] = crossover(cold)
            print("   on the device alone, cold, ms by n: " + ", ".join(f"{n}: {cold[n]:.4f}" for n in sorted(cold))
                  + f"; crossover {f'between n={lo} and n={hi}' if hi else f'at no n up to {lo}'} (a chain time "
                  "under the host's launch interval says nothing of the kernel)", flush=True)
    for dt in DTYPES:
        name = str(dt).removeprefix("torch.")
        x, k = pattern_inputs(dt, device)
        ms = chain_ms(lambda t: pattern_softmax(t, k), x)
        plain_ms = chain_ms(lambda t: pattern_softmax_reference(t, k), x)
        res[("pattern", dt)] = {"ms": ms, "plain_ms": plain_ms}
        _line(f"pattern kernel ({name})", ms, plain_ms, alone and alone[("pattern", dt)])
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("vpu_probe: no CUDA device; the probes run on the card only", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(f"{torch.cuda.get_device_name(0)}: B={B} NH={NH} (R, C, W)=({R}, {C}, {W}) LOOP={LOOP}", flush=True)
    run(dev, device_sweep(dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
