"""Kernel K3 (``refine_tail``): the least time its launches in the traced
window could take (bytes at the card's memory rate or float32 operations at
its float32 rate, whichever is larger, counted from the configuration's
shapes by ``counts.refine_tail_launches``) over their device time, in %.
Nothing is read when the launches do not come as whole calls."""

from benchmark import counts


def read(run):
    t, peak = run.trace, counts.peaks(run.device_kind)
    if t is None or peak is None:
        return None
    times = [b - a for a, b, name in t.device if "refine_tail" in name]
    per_call = counts.refine_tail_launches(run.cell.config, run.batch)
    if not times or len(times) != len(t.calls) * len(per_call):
        return None
    bound_s = sum(max(n["bytes"] / peak["hbm_bytes_per_s"], n["flops"] / peak["f32_flops"]) for n in per_call)
    return 100.0 * bound_s * len(t.calls) / (sum(times) / 1e9)
