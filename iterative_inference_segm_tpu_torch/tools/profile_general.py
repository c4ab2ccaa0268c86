"""Device-time profile of the general engine on the card, at the JAX CLI's
full width: FCN-8 / VGG16 fc 4096, C=11, 360x480; DAE depth 4, stem_pool 0,
widths (32, 64, 128, 256), pool encoder, pool4 conditioning; K=5, eps=0.1,
bf16. Weights are random from a seed.

For each mode (score, energy) it prints the CUDA-event time per forward
over ITERS calls, then runs ITERS calls under ``torch.profiler`` and prints
the device time per forward (the sum of the traced device operations), the
idle share (1 - device time / event time), the device operations per
forward, the TOP operations by device time with their shares, and the
refinement-tail kernel's own line. It
raises if the profiler traced no device time.

Run on a card:

    python -m iterative_inference_segm_tpu_torch.tools.profile_general
"""

from __future__ import annotations

import sys
from collections import defaultdict

import torch

ITERS = 5
TOP = 12
TAIL = "refine_tail_kernel"  # reported whether or not it is among the TOP
BATCH = 4
K_STEPS = 5


def summarize(ops: list[tuple[str, float]], iters: int, event_ms: float, tail: str = TAIL) -> dict:
    """``ops``: (name, device microseconds) of every traced device operation
    over ``iters`` forwards, each of ``event_ms`` by CUDA events. Returns
    {'device_ms', 'idle', 'ops', 'top': [(name, ms per forward, share)],
    'tail': the same for every operation whose name holds ``tail``}."""
    if not ops:
        raise RuntimeError("the profiler traced no device time; time with CUDA events instead")
    by_name: dict[str, float] = defaultdict(float)
    for name, us in ops:
        by_name[name] += us
    total_us = sum(by_name.values())
    device_ms = total_us / 1e3 / iters
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "device_ms": device_ms,
        "idle": 1.0 - device_ms / event_ms,
        "ops": len(ops) / iters,
        "top": [(name, us / 1e3 / iters, us / total_us) for name, us in top],
        "tail": [(name, us / 1e3 / iters, us / total_us) for name, us in by_name.items() if tail in name],
    }


def profile(refine, x, iters: int = ITERS, tail: str = TAIL) -> dict:
    """CUDA-event ms per forward, then the profiler's summary of ``iters``
    forwards of ``refine(x)`` (``summarize``, its kernel named ``tail``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    for _ in range(3):
        refine(x)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        refine(x)
    end.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(end) / iters
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            refine(x)
        torch.cuda.synchronize()
    ops = [(e.name, e.time_range.elapsed_us()) for e in prof.events() if e.device_type == DeviceType.CUDA]
    return {"event_ms": event_ms, **summarize(ops, iters, event_ms, tail)}


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_general: no CUDA device; the profile runs on the card only", file=sys.stderr)
        return 1

    from iterative_inference_segm_tpu_torch.inference.iterative import make_refiner
    from iterative_inference_segm_tpu_torch.models.dae import DAE_H_CHANNELS, dae_logits, init_dae
    from iterative_inference_segm_tpu_torch.models.fcn8 import fcn8_apply, init_fcn8

    dev = torch.device("cuda", 0)
    fcn = init_fcn8(torch.Generator().manual_seed(0), n_classes=11, fc_channels=4096, device=dev)
    dae = init_dae(torch.Generator().manual_seed(1), n_classes=11,
                   h_specs={"pool4": DAE_H_CHANNELS["pool4"]}, depth=4, stem_pool=0, device=dev)
    x = torch.randn((BATCH, 360, 480, 3), generator=torch.Generator().manual_seed(2)).to(dev)
    print(f"{torch.cuda.get_device_name(0)}: general engine, bf16, batch {BATCH}, K={K_STEPS}, "
          f"eps 0.1, 360x480, {ITERS} forwards per reading", flush=True)
    for mode, steps in (("fcn only", 0), ("score", K_STEPS), ("energy", K_STEPS)):
        refine = make_refiner(fcn8_apply, dae_logits, fcn, dae, eps=0.1, num_steps=steps,
                              mode="score" if steps == 0 else mode, compute_dtype=torch.bfloat16,
                              dae_kwargs={"depth": 4})
        r = profile(refine, x)
        print(f"{mode}: {r['event_ms']:.3f} ms a forward by CUDA events; device time {r['device_ms']:.3f} ms "
              f"({r['idle']:.1%} idle); {r['ops']:.0f} device operations a forward", flush=True)
        for name, ms, share in r["top"]:
            print(f"   {ms:8.4f} ms {share:6.1%}  {name[:110]}", flush=True)
        for name, ms, share in r["tail"]:
            print(f"   refine_tail: {ms:8.4f} ms {share:6.1%}  {name[:110]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
