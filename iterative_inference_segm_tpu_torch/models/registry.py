"""Score-network architecture registry: one dispatch table for the zoo.

Port of ``iterative_inference_segm_tpu.models.registry`` for ``arch="dae"``:
the normalized apply, the per-step kwargs, the param template (the load
target of checkpoints), the metadata the trainer stamps into
``best_dae.npz`` and what a loader expects of it. The other two
architectures are not ported yet.
"""

from __future__ import annotations

import torch

SCORE_ARCHS = ("dae", "mirror", "contextmod")


def validate_arch(arch: str) -> None:
    if arch not in SCORE_ARCHS:
        raise ValueError(f"unknown score-network arch {arch!r}; expected one of {SCORE_ARCHS}")
    if arch != "dae":
        raise NotImplementedError(
            f"arch={arch!r} is not ported yet (ROADMAP.md, Queue 1 item 6)"
        )


def score_apply_fn(arch: str):
    """Normalized ``(params, y, h, **kw)`` apply."""
    validate_arch(arch)
    from iterative_inference_segm_tpu_torch.models.dae import dae_apply

    return dae_apply


def score_logits_fn(arch: str):
    """Normalized ``(params, y, h, **kw)`` apply up to the logits: what the
    refinement engines call, since the tail kernel takes the softmax."""
    validate_arch(arch)
    from iterative_inference_segm_tpu_torch.models.dae import dae_logits

    return dae_logits


def score_kwargs(arch: str, *, depth: int, encoder: str = "pool") -> dict:
    """Per-step apply kwargs (the refinement machinery's ``dae_kwargs``)."""
    validate_arch(arch)
    return {"depth": depth, "encoder": encoder}


def init_score_template(
    arch: str,
    generator: torch.Generator,
    *,
    n_classes: int,
    h_taps: tuple[str, ...] = ("pool4",),
    depth: int = 4,
    stem_pool: int = 0,
    tail: str = "full",
    widths: tuple[int, ...] | None = None,
    tied: bool = False,
    dtype=torch.float32,
    device: torch.device | str = "cpu",
) -> dict:
    """Random params of the arch (the load target for checkpoints)."""
    validate_arch(arch)
    if tied:
        raise ValueError("tied=True applies to arch='mirror' only")
    from iterative_inference_segm_tpu_torch.models.dae import DAE_H_CHANNELS, init_dae

    extra = {"widths": tuple(widths)} if widths else {}
    return init_dae(
        generator, n_classes=n_classes,
        h_specs={name: DAE_H_CHANNELS[name] for name in h_taps}, depth=depth,
        stem_pool=stem_pool, tail=tail, dtype=dtype, device=device, **extra,
    )


def expected_meta(
    arch: str,
    *,
    depth: int,
    stem_pool: int = 0,
    tail: str = "full",
    widths: tuple[int, ...] | None = None,
    encoder: str = "pool",
) -> dict:
    """Load-side ``check_npz_meta`` expectation: the shape-invisible knobs
    that would otherwise load silently under the wrong flag. ``widths`` is
    checked only when the caller declares it."""
    validate_arch(arch)
    w = {"widths": tuple(widths)} if widths else {}
    return {
        "arch": arch, "encoder": encoder, "depth": depth,
        "stem_pool": stem_pool, "tail": tail, **w,
    }


def checkpoint_meta(
    arch: str,
    *,
    h_taps: tuple[str, ...],
    depth: int,
    stem_pool: int = 0,
    tail: str = "full",
    widths: tuple[int, ...] | None = None,
    encoder: str = "pool",
    tied: bool = False,
) -> dict:
    """What the trainer stamps into ``best_dae.npz``; always records the
    resolved widths so a later load can verify them."""
    validate_arch(arch)
    from iterative_inference_segm_tpu_torch.models.dae import DEFAULT_WIDTHS

    resolved = tuple(widths) if widths else DEFAULT_WIDTHS[:depth]
    return {
        "arch": arch, "encoder": encoder, "depth": depth,
        "stem_pool": stem_pool, "tail": tail,
        "widths": resolved, "h": tuple(h_taps),
    }
