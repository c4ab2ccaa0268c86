"""Whole step: the model's operations an image (the frozen reference at
batch 1, counted by ``FlopCounterMode``) times the images completed in the
traced window, over its seconds and the card's dense peak at the
configuration's compute dtype, in %."""

from benchmark import counts


def read(run):
    t, peak = run.trace, counts.peaks(run.device_kind)
    if t is None or not t.device or peak is None:
        return None
    key = "bf16_flops" if run.cell.config["compute_dtype"] == "bfloat16" else "f32_flops"
    flops = counts.model_flops_per_image(run.cell.config) * len(t.calls) * run.batch
    return 100.0 * flops / (t.window_ns / 1e9) / peak[key]
