"""Pipeline parallelism for serving: GPipe microbatches over a 'stage' axis.

Port of ``iterative_inference_segm_tpu.parallel.pp``, serving only. Each
stage rank runs one contiguous slice of the network; microbatches stream
through the stages. The JAX package writes the schedule as ONE SPMD program
(``shard_map`` + a ``lax.scan`` over T = M + S - 1 ticks + one ``ppermute``
a tick); the port writes it in point-to-point form, one process a stage:
stage s runs its function on microbatches 0..M-1 in order, receives each
input wire from stage s - 1 (``irecv``, posted one microbatch ahead) and
sends each output wire to stage s + 1 (``isend``). A stage starts a
microbatch as soon as its wire arrives, so the bubble ticks the SPMD
program computes on zeros are skipped; the last stage's M emits are the
result, broadcast over the stage group so that every rank returns them
whole, as the JAX controller sees them.

Data-flow contract (``make_gpipe``): the per-microbatch INPUT stream and
the inter-stage WIRE are separate pytrees (nested dicts, tuples or lists of
tensors). Every rank is handed the whole stream; only the wire crosses
ranks. The wire is one fixed format (``wire0``, the zero wire, gives every
leaf's shape and dtype, which is what a receiving stage allocates); every
stage function takes ``(wire, inp)``: stage 0 reads ``inp`` and ignores its
zero wire, later stages read the wire and may consult ``inp``'s shape.
``make_gpipe_stacked`` (homogeneous stages) keeps the uniform format where
the stream IS the wire.

DP x PP: on a ``("data", "stage")`` mesh with ``batch_axis='data'`` each
rank takes its 'data' shard of every microbatch, and the emits are gathered
over 'data' at the end.

Not ported yet (ROADMAP.md, Queue 1): gradients through the pipeline (the
reverse schedule) and ``remat``; both raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from iterative_inference_segm_tpu_torch.parallel import comm
from iterative_inference_segm_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size, has_axis

_NO_GRAD = ("gradients through the pipeline are not ported yet (ROADMAP.md, Queue 1 item 12: the "
            "reverse schedule); run the pipeline under torch.no_grad")
_NO_REMAT = ("remat (recomputing each tick in the reverse pipeline) is not ported yet (ROADMAP.md, "
             "Queue 1 item 12: gradients through the pipeline)")


def _flatten(tree) -> tuple[list, Callable]:
    """Leaves in a fixed order, and the function that rebuilds the tree."""
    leaves, spec = tree_flatten(tree)
    return leaves, lambda ls: tree_unflatten(list(ls), spec)


def split_microbatches(tree, num_microbatches: int):
    """Leaves (B, ...) -> (M, B/M, ...). B must divide evenly."""

    def split(a):
        b = a.shape[0]
        if b % num_microbatches:
            raise ValueError(f"batch {b} not divisible by num_microbatches {num_microbatches}")
        return a.reshape((num_microbatches, b // num_microbatches) + tuple(a.shape[1:]))

    return tree_map(split, tree)


def merge_microbatches(tree):
    """Inverse of ``split_microbatches``: (M, Bm, ...) -> (M*Bm, ...)."""
    return tree_map(lambda a: a.reshape((-1,) + tuple(a.shape[2:])), tree)


def _check_stage_axis(mesh, stage_axis: str) -> int:
    if not has_axis(mesh, stage_axis):
        shape = dict(zip(mesh.mesh_dim_names or (), mesh.shape))
        raise ValueError(
            f"mesh {shape} has no '{stage_axis}' axis — pipeline meshes need one, "
            f"e.g. make_mesh(('data', '{stage_axis}'), (n, 2))"
        )
    return axis_size(mesh, stage_axis)


def _check_no_grad(*trees) -> None:
    if torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad for tree in trees for t in _flatten(tree)[0]
    ):
        raise NotImplementedError(_NO_GRAD)


def _check_leaves(tree, lead: int) -> None:
    for a in _flatten(tree)[0]:
        if a.ndim < lead + 1:
            raise ValueError(f"pipeline leaves need at least {lead + 1} dims (…, batch, features); got rank {a.ndim}")


def _data_shard(tree, mesh, batch_axis: str | None, dim: int):
    """This rank's 'data' block of ``dim`` of every leaf."""
    if batch_axis is None:
        return tree
    n = axis_size(mesh, batch_axis)
    i = axis_index(mesh, batch_axis)

    def cut(a):
        if a.shape[dim] % n:
            raise ValueError(f"microbatch of {a.shape[dim]} does not split over '{batch_axis}' ({n})")
        k = a.shape[dim] // n
        return a.narrow(dim, i * k, k)

    return tree_map(cut, tree)


def _gpipe_schedule(run_stage: Callable, stream, wire0, mesh, *, stage_axis: str, num_stages: int,
                    num_microbatches: int, batch_axis: str | None):
    """This rank's part of the schedule; returns the last stage's M emits,
    stacked to (M, Bm, ...) leaves and whole on every rank."""
    s = axis_index(mesh, stage_axis)
    group = axis_group(mesh, stage_axis)
    last = num_stages - 1
    stream = _data_shard(stream, mesh, batch_axis, 1)
    wire0 = _data_shard(wire0, mesh, batch_axis, 0)
    templ, rebuild = _flatten(wire0)
    n_leaves = len(templ)

    def post_recv(m):
        return [comm.irecv(t, s - 1, group, tag=m * n_leaves + i) for i, t in enumerate(templ)]

    pending = post_recv(0) if s > 0 and num_microbatches else None
    sends, emits = [], []
    for m in range(num_microbatches):
        inp = tree_map(lambda a: a[m], stream)
        if s == 0:
            wire = wire0
        else:
            wire = rebuild([finish() for finish in pending])
            if m + 1 < num_microbatches:
                pending = post_recv(m + 1)
        out = run_stage(wire, inp)
        leaves, _ = _flatten(out)
        if len(leaves) != n_leaves or any(a.shape != t.shape or a.dtype != t.dtype for a, t in zip(leaves, templ)):
            raise ValueError(f"stage {s} emitted a wire that is not wire0's format "
                             f"({[tuple(a.shape) for a in leaves]} vs {[tuple(t.shape) for t in templ]})")
        if s < last:
            sends += [comm.isend(a, s + 1, group, tag=m * n_leaves + i) for i, a in enumerate(leaves)]
        else:
            emits.append(leaves)
    for work, _buf in sends:
        work.wait()

    # the result: the last stage's emits, on every rank of the stage group
    if s == last:
        result = [torch.stack([e[i] for e in emits]) for i in range(n_leaves)]
    else:
        result = [torch.empty((num_microbatches, *t.shape), dtype=t.dtype, device=t.device) for t in templ]
    for t in result:
        comm.broadcast_(t, last, group)
    if batch_axis is not None:
        result = [comm.all_gather_cat(t, axis_group(mesh, batch_axis), dim=1) for t in result]
    return rebuild(result)


def make_gpipe(
    stage_fns: Sequence[Callable],
    mesh,
    *,
    stage_axis: str = "stage",
    batch_axis: str | None = None,
    remat: bool = False,
) -> Callable:
    """Heterogeneous-stage pipeline: ``pipeline(stage_params, stream, wire0)
    -> wires``.

    ``stage_fns[i](stage_params[i], wire, inp) -> wire``; rank s runs
    ``stage_fns[s]``. ``stream`` leaves are (M, Bm, ...), the whole stream
    on every rank; ``wire0`` the zero wire with (Bm, ...) leaves. Returns
    the last stage's wires, (M, Bm, ...) leaves, on every rank."""
    num_stages = _check_stage_axis(mesh, stage_axis)
    if len(stage_fns) != num_stages:
        raise ValueError(f"{len(stage_fns)} stage fns for a {num_stages}-wide '{stage_axis}' axis")
    if remat:
        raise NotImplementedError(_NO_REMAT)

    def pipeline(stage_params, stream, wire0):
        _check_leaves(stream, 1)
        _check_leaves(wire0, 0)
        _check_no_grad(stage_params, stream)
        s = axis_index(mesh, stage_axis)

        def run_stage(wire, inp):
            return stage_fns[s](stage_params[s], wire, inp)

        return _gpipe_schedule(run_stage, stream, wire0, mesh, stage_axis=stage_axis, num_stages=num_stages,
                               num_microbatches=int(_flatten(stream)[0][0].shape[0]), batch_axis=batch_axis)

    return pipeline


def stage_slice(stage_params, mesh, *, stage_axis: str = "stage"):
    """This rank's slice of stage-stacked params, leading dim kept at 1:
    what ``make_gpipe_stacked`` takes for per-stage parameter residency."""
    s = axis_index(mesh, stage_axis)
    return tree_map(lambda a: a[s : s + 1].clone(), stage_params)


def make_gpipe_stacked(
    stage_fn: Callable,
    mesh,
    *,
    stage_axis: str = "stage",
    batch_axis: str | None = None,
    remat: bool = False,
) -> Callable:
    """Homogeneous-stage pipeline: ``pipeline(stage_params, wires) ->
    wires``. ``stage_fn(params_i, wire) -> wire`` over one format (the
    stream IS the wire: stage 0 takes each microbatch as its wire).
    ``stage_params`` leaves carry a leading stage dim: S (every stage's;
    rank s reads slice s) or 1 (this rank's slice alone, ``stage_slice``:
    the per-stage parameter residency that makes PP worth running)."""
    num_stages = _check_stage_axis(mesh, stage_axis)
    if remat:
        raise NotImplementedError(_NO_REMAT)

    def pipeline(stage_params, wires):
        _check_leaves(wires, 1)
        _check_no_grad(stage_params, wires)
        for leaf in _flatten(stage_params)[0]:
            if leaf.shape[0] not in (1, num_stages):
                raise ValueError(f"stacked stage params need leading dim {num_stages}; got {tuple(leaf.shape)}")
        s = axis_index(mesh, stage_axis)
        local = tree_map(lambda a: a[0] if a.shape[0] == 1 else a[s], stage_params)

        def run_stage(wire, inp):
            return stage_fn(local, inp if s == 0 else wire)

        wire0 = tree_map(lambda a: torch.zeros(a.shape[1:], dtype=a.dtype, device=a.device), wires)
        return _gpipe_schedule(run_stage, wires, wire0, mesh, stage_axis=stage_axis, num_stages=num_stages,
                               num_microbatches=int(_flatten(wires)[0][0].shape[0]), batch_axis=batch_axis)

    return pipeline


def _meta(tree):
    return tree_map(lambda t: t.to("meta"), tree)


def _zeros_like(tree, device):
    return tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype, device=device), tree)


def make_pp_flagship(
    mesh,
    *,
    eps: float,
    num_steps: int,
    h_taps: tuple[str, ...] = ("pool4",),
    depth: int = 3,
    compute_dtype=torch.bfloat16,
    state_dtype=None,
    encoder: str = "pool",
    mode: str = "score",
    fold_tail: bool | None = None,
    engine: str = "half",
    renorm: str = "none",
    dae_arch: str = "dae",
    stage_axis: str = "stage",
    batch_axis: str | None = None,
    fcn_apply: Callable | None = None,
) -> Callable:
    """The flagship split at the model's seams: a 2-wide ``stage_axis``
    splits FCN-8 forward | refinement, a 3-wide one VGG backbone | FCN-8
    head | refinement (``fcn8_backbone`` / ``fcn8_head``). ``engine='half'``
    refines through ``inference.fused.halfres_refine`` (the DAE only);
    'general' through ``inference.iterative.refinement_scan`` with the
    registry's score network (``dae_arch``) and ``renorm``. The wire carries
    {y0, the h taps, yk} (2 stages) or {pool3/4/5, y0, yk} (3 stages, which
    condition on pool taps alone); the images stay out of it.

    Returns ``forward(fcn_params, dae_params, images) -> (y0, y_k)``,
    ``images`` (M, Bm, H, W, 3) (``split_microbatches``), both results
    (M, Bm, H, W, C) on every rank. Run it under ``torch.no_grad`` (energy
    mode: ``inference.fused.no_autograd``)."""
    from iterative_inference_segm_tpu_torch.models.fcn8 import fcn8_backbone, fcn8_head

    n_stages = _check_stage_axis(mesh, stage_axis)
    if n_stages not in (2, 3):
        raise ValueError(f"the flagship pipeline splits 2 or 3 ways; mesh axis '{stage_axis}' has size {n_stages}")
    if fcn_apply is None:
        from iterative_inference_segm_tpu_torch.models.fcn8 import fcn8_apply as fcn_apply

    if engine == "half":
        from iterative_inference_segm_tpu_torch.inference.fused import halfres_refine

        if dae_arch != "dae":
            raise ValueError("engine='half' pipelines dae_arch='dae' only")
        if renorm != "none":
            raise ValueError("renorm is a general-engine knob (the pooled engine's update has no "
                             "renormalization step); pass engine='general'")
        probs_dtype = state_dtype or compute_dtype

        def refine(dae_params, y0, h, in_hw):
            return halfres_refine(dae_params, y0, h, in_hw, eps=eps, num_steps=num_steps, depth=depth,
                                  compute_dtype=compute_dtype, state_dtype=state_dtype, encoder=encoder,
                                  mode=mode, fold_tail=fold_tail)

    elif engine == "general":
        from iterative_inference_segm_tpu_torch.inference.iterative import refinement_scan
        from iterative_inference_segm_tpu_torch.models.registry import score_kwargs, score_logits_fn

        if state_dtype is not None or fold_tail is not None:
            raise ValueError("state_dtype/fold_tail are pooled-engine knobs; the general engine carries "
                             "f32 full-res state with the unfolded tail")
        s_logits = score_logits_fn(dae_arch)
        s_kw = dict(score_kwargs(dae_arch, depth=depth, encoder=encoder), compute_dtype=compute_dtype)
        probs_dtype = torch.float32  # the general engine's convention

        def refine(dae_params, y0, h, in_hw):
            return refinement_scan(lambda y: s_logits(dae_params, y, h, **s_kw), y0, eps=eps,
                                   num_steps=num_steps, mode=mode, renorm=renorm)

    else:
        raise ValueError(f"unknown engine {engine!r}; expected 'half' or 'general'")

    def hw(x):
        return int(x.shape[1]), int(x.shape[2])

    if n_stages == 2:

        def fcn_fwd(fcn_params, x):
            return fcn_apply(fcn_params, x, return_features=h_taps, compute_dtype=compute_dtype,
                             probs_dtype=probs_dtype)

        def stage0(fcn_params, wire, x):
            y0, h = fcn_fwd(fcn_params, x)
            return {**wire, "y0": y0, "h": h}

        def stage1(dae_params, wire, x):
            return {**wire, "yk": refine(dae_params, wire["y0"], wire["h"], hw(x))}

        stage_fns = (stage0, stage1)

        def make_wire0(fcn_params, mb):
            y0_s, h_s = fcn_fwd(_meta(fcn_params), mb.to("meta"))
            return _zeros_like({"y0": y0_s, "h": h_s, "yk": y0_s}, mb.device)

        def stage_params_of(fcn_params, dae_params):
            return (fcn_params, dae_params)

    else:
        if not set(h_taps) <= {"pool3", "pool4", "pool5"}:
            raise ValueError("the 3-stage flagship pipeline conditions the DAE from the backbone's pool "
                             f"taps (pool3/pool4/pool5); got {h_taps!r}")

        def stage0(fcn_params, wire, x):
            pools, _ = fcn8_backbone(fcn_params, x, compute_dtype=compute_dtype)
            return {**wire, "pools": pools}

        def stage1(fcn_params, wire, x):
            y0, _ = fcn8_head(fcn_params, wire["pools"], hw(x), probs_dtype=probs_dtype)
            return {**wire, "y0": y0}

        def stage2(dae_params, wire, x):
            h = {t: wire["pools"][t] for t in h_taps}
            return {**wire, "yk": refine(dae_params, wire["y0"], h, hw(x))}

        stage_fns = (stage0, stage1, stage2)

        def make_wire0(fcn_params, mb):
            meta = _meta(fcn_params)
            pools_s, _ = fcn8_backbone(meta, mb.to("meta"), compute_dtype=compute_dtype)
            y0_s, _ = fcn8_head(meta, pools_s, hw(mb), probs_dtype=probs_dtype)
            return _zeros_like({"pools": pools_s, "y0": y0_s, "yk": y0_s}, mb.device)

        def stage_params_of(fcn_params, dae_params):
            return (fcn_params, fcn_params, dae_params)

    pipeline = make_gpipe(stage_fns, mesh, stage_axis=stage_axis, batch_axis=batch_axis)

    def forward(fcn_params, dae_params, images):
        if images.ndim != 5:
            raise ValueError(f"images must be (M, Bm, H, W, 3) microbatches; got {tuple(images.shape)}")
        wire0 = make_wire0(fcn_params, images[0])
        out = pipeline(stage_params_of(fcn_params, dae_params), images, wire0)
        return out["y0"], out["yk"]

    return forward
