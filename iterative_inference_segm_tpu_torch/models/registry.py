"""Score-network architecture registry: one dispatch table for the zoo.

Port of ``iterative_inference_segm_tpu.models.registry`` for the three score
networks, ``dae``, ``mirror`` and ``contextmod``: the normalized apply and
the apply up to the logits (what the refinement engines call, since the
tail kernel takes the softmax), the per-step kwargs, the param template
(the load target of checkpoints), the metadata the trainer stamps into
``best_dae.npz`` and what a loader expects of it.
"""

from __future__ import annotations

import torch

SCORE_ARCHS = ("dae", "mirror", "contextmod")


def validate_arch(arch: str) -> None:
    if arch not in SCORE_ARCHS:
        raise ValueError(f"unknown score-network arch {arch!r}; expected one of {SCORE_ARCHS}")


def _contextmod_only_dtype(fn):
    """The context module takes ``compute_dtype`` (and an H-sharded map's
    ``space``) alone: forward them and drop the rest (dropping the dtype
    too would run the network in f32 under bf16). The wrapper keeps ``fn`` as
    its ``__wrapped__`` (``score_logits_of`` reads it)."""
    def wrapper(p, y, h, **kw):
        return fn(p, y, h, compute_dtype=kw.get("compute_dtype", torch.float32), space=kw.get("space"))

    wrapper.__wrapped__ = fn
    return wrapper


def score_apply_fn(arch: str):
    """Normalized ``(params, y, h, **kw)`` apply: the denoised probabilities."""
    validate_arch(arch)
    if arch == "mirror":
        from iterative_inference_segm_tpu_torch.models.dae_mirror import mirror_dae_apply

        return mirror_dae_apply
    if arch == "contextmod":
        from iterative_inference_segm_tpu_torch.models.contextmod import contextmod_apply

        return _contextmod_only_dtype(contextmod_apply)
    from iterative_inference_segm_tpu_torch.models.dae import dae_apply

    return dae_apply


def score_logits_fn(arch: str):
    """Normalized ``(params, y, h, **kw)`` apply up to the logits."""
    validate_arch(arch)
    if arch == "mirror":
        from iterative_inference_segm_tpu_torch.models.dae_mirror import mirror_dae_logits

        return mirror_dae_logits
    if arch == "contextmod":
        from iterative_inference_segm_tpu_torch.models.contextmod import contextmod_logits

        return _contextmod_only_dtype(contextmod_logits)
    from iterative_inference_segm_tpu_torch.models.dae import dae_logits

    return dae_logits


def _drop_out_dtype(fn):
    """A logits apply that takes the probability apply's ``out_dtype`` and
    drops it: the refinement's softmax is taken in f32 and rounded to the
    iterate's dtype, whatever dtype the probability apply would emit."""
    def logits(p, y, h=None, *, out_dtype=None, **kw):
        return fn(p, y, h, **kw)

    return logits


def score_logits_of(apply):
    """The logits twin of a score network's probability apply: the
    ``dae_apply`` / ``mirror_dae_apply`` / ``contextmod_apply`` that JAX's
    ``make_refiner`` and ``grid_search_eps_k`` take (or the wrapper
    ``score_apply_fn`` returns) -> the apply up to the logits, with the
    same call (``out_dtype`` accepted and dropped), which the general
    engine's tail kernel K3 takes. Any other callable raises a
    ``ValueError`` naming the three."""
    from iterative_inference_segm_tpu_torch.models.contextmod import contextmod_apply, contextmod_logits
    from iterative_inference_segm_tpu_torch.models.dae import dae_apply, dae_logits
    from iterative_inference_segm_tpu_torch.models.dae_mirror import mirror_dae_apply, mirror_dae_logits

    twins = {dae_apply: dae_logits, mirror_dae_apply: mirror_dae_logits, contextmod_apply: contextmod_logits}
    if apply in twins:
        return _drop_out_dtype(twins[apply])
    if getattr(apply, "__wrapped__", None) is contextmod_apply:  # score_apply_fn("contextmod")
        return _contextmod_only_dtype(contextmod_logits)
    raise ValueError(
        f"expected a score network's probability apply (dae_apply, mirror_dae_apply or contextmod_apply, "
        f"as JAX's make_refiner and grid_search_eps_k take, or models.registry.score_apply_fn's); got {apply!r}"
    )


def score_kwargs(arch: str, *, depth: int, encoder: str = "pool") -> dict:
    """Per-step apply kwargs (the refinement machinery's ``dae_kwargs``)."""
    validate_arch(arch)
    if arch == "mirror":
        return {"depth": depth}
    if arch == "contextmod":
        return {}
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
    """Random params of the arch (the load target for checkpoints). The
    context module conditions at input scale only, so any other tap is
    refused here with its name (no taps: unconditioned)."""
    validate_arch(arch)
    from iterative_inference_segm_tpu_torch.models.dae import DAE_H_CHANNELS, init_dae

    kw = {"dtype": dtype, "device": device}
    if arch == "contextmod":
        from iterative_inference_segm_tpu_torch.models.contextmod import init_contextmod

        bad = [t for t in h_taps if t != "input"]
        if bad:
            raise ValueError(f"contextmod conditions at input scale only; got taps {bad}")
        h_ch = DAE_H_CHANNELS["input"] if "input" in h_taps else 0
        return init_contextmod(generator, n_classes=n_classes, h_channels=h_ch, **kw)
    h_specs = {name: DAE_H_CHANNELS[name] for name in h_taps}
    extra = {"widths": tuple(widths)} if widths else {}
    if arch == "mirror":
        from iterative_inference_segm_tpu_torch.models.dae_mirror import init_mirror_dae

        return init_mirror_dae(generator, n_classes=n_classes, h_specs=h_specs, depth=depth, tied=tied,
                               **extra, **kw)
    if tied:
        raise ValueError("tied=True applies to arch='mirror' only")
    return init_dae(generator, n_classes=n_classes, h_specs=h_specs, depth=depth, stem_pool=stem_pool,
                    tail=tail, **extra, **kw)


def expected_meta(
    arch: str,
    *,
    depth: int,
    stem_pool: int = 0,
    tail: str = "full",
    widths: tuple[int, ...] | None = None,
    encoder: str = "pool",
    tied: bool = False,
) -> dict:
    """Load-side ``check_npz_meta`` expectation: the shape-invisible knobs
    that would otherwise load silently under the wrong flag. ``widths`` is
    checked only when the caller declares it."""
    validate_arch(arch)
    if arch == "contextmod":
        return {"arch": "contextmod"}
    w = {"widths": tuple(widths)} if widths else {}
    if arch == "mirror":
        return {"arch": "mirror", "depth": depth, "tied": tied, **w}
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
    resolved widths (of the DAEs) so a later load can verify them."""
    validate_arch(arch)
    if arch == "contextmod":
        return {"arch": arch, "h": tuple(h_taps)}
    from iterative_inference_segm_tpu_torch.models.dae import DEFAULT_WIDTHS

    resolved = tuple(widths) if widths else DEFAULT_WIDTHS[:depth]
    if arch == "mirror":
        return {"arch": arch, "depth": depth, "tied": tied, "widths": resolved, "h": tuple(h_taps)}
    return {
        "arch": arch, "encoder": encoder, "depth": depth,
        "stem_pool": stem_pool, "tail": tail,
        "widths": resolved, "h": tuple(h_taps),
    }
