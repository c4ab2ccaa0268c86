"""Pipeline parallelism: GPipe microbatches over a 'stage' axis, for
serving and, through ``torch.autograd``, for training.

Port of ``iterative_inference_segm_tpu.parallel.pp``. Each stage rank runs
one contiguous slice of the network; microbatches stream through the
stages. The JAX package writes the schedule as ONE SPMD program
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

Gradients. JAX differentiates its SPMD program with ``jax.grad``: the
transpose of ``ppermute`` is the inverse permutation and the transpose of
the scan runs the ticks backwards. Here each rank's part of the schedule is
one ``torch.autograd.Function`` (``_StagePart``), taken whenever grad is
enabled and a parameter or stream leaf requires it:
- its forward is the schedule above; it keeps each microbatch's input wire
  (and, without ``remat``, the graph of the stage's computation on it);
- its backward runs the reverse schedule: microbatches in reverse order,
  each output wire's gradient received from stage s + 1 and the input
  wire's gradient sent to s - 1, with tags past every forward tag;
- the result is broadcast from the last stage, so every rank computes the
  same loss: the last stage takes the cotangent once, and the other ranks'
  copies are ignored (under DP x PP each last-stage rank takes its own
  'data' block, the adjoint of the gather);
- each rank computes the gradients of the stage it owns; the gradients are
  summed over the stage group (zeros from the ranks that do not own a
  stage, so the sum is exact) and over 'data', and every rank returns the
  whole gradient, as the JAX controller sees it. A stage-resident slice
  (``stage_slice``, leading dim 1) is its own rank's: it is summed over
  'data' only.
Every rank of the stage (and data) group must run the backward: it holds
collectives. ``remat=True`` keeps only each microbatch's input wire and
recomputes the stage's computation in the backward (``jax.checkpoint``
around each tick in JAX): the same gradients, less memory. A stage whose
own computation takes a gradient (energy mode in the refinement stage)
builds it with ``create_graph`` when grad is enabled, so it is
differentiated in turn, with or without ``remat``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from iterative_inference_segm_tpu_torch.parallel import comm
from iterative_inference_segm_tpu_torch.parallel.mesh import axis_group, axis_index, axis_size, has_axis


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


@dataclass
class _Plan:
    """One rank's part of a pipeline call: what it runs and with whom.

    ``call(param_leaves, wire_leaves, inp_leaves) -> out_leaves`` runs this
    rank's stage on one microbatch; ``stage_reduced[i]`` says whether
    parameter leaf i's gradient is summed over the stage group (every
    stage's params, of which this rank uses its own) or is this rank's alone
    (a stage-resident slice)."""

    call: Callable
    mesh: object
    stage_axis: str
    batch_axis: str | None
    num_stages: int
    num_microbatches: int
    wire0: list  # this rank's zero wire leaves (its 'data' block)
    rebuild_wire: Callable
    stage_reduced: list
    remat: bool = False

    @property
    def stage(self) -> int:
        return axis_index(self.mesh, self.stage_axis)

    @property
    def group(self):
        return axis_group(self.mesh, self.stage_axis)

    def local(self, stream_leaves):
        """This rank's 'data' block of every (M, Bm, ...) stream leaf."""
        return _data_shard(list(stream_leaves), self.mesh, self.batch_axis, 1)

    def check(self, leaves) -> None:
        templ = self.wire0
        if len(leaves) != len(templ) or any(a.shape != t.shape or a.dtype != t.dtype for a, t in zip(leaves, templ)):
            raise ValueError(f"stage {self.stage} emitted a wire that is not wire0's format "
                             f"({[tuple(a.shape) for a in leaves]} vs {[tuple(t.shape) for t in templ]})")


def _forward_schedule(plan: _Plan, step: Callable) -> list:
    """The forward schedule: ``step(m, wire_leaves) -> out_leaves`` on
    microbatches 0..M-1 in order, each input wire received from s - 1 and
    each output sent to s + 1. Returns the last stage's emits (one leaf list
    a microbatch; [] on the other stages)."""
    s, group, last, m_total = plan.stage, plan.group, plan.num_stages - 1, plan.num_microbatches
    templ = plan.wire0
    n = len(templ)

    def post_recv(m):
        return [comm.irecv(t, s - 1, group, tag=m * n + i) for i, t in enumerate(templ)]

    pending = post_recv(0) if s > 0 and m_total else None
    sends, emits = [], []
    for m in range(m_total):
        if s == 0:
            wire = templ
        else:
            wire = [finish() for finish in pending]
            if m + 1 < m_total:
                pending = post_recv(m + 1)
        out = step(m, wire)
        plan.check(out)
        if s < last:
            sends += [comm.isend(a.detach(), s + 1, group, tag=m * n + i) for i, a in enumerate(out)]
        else:
            emits.append([a.detach() for a in out])
    for work, _buf in sends:
        work.wait()
    return emits


def _backward_schedule(plan: _Plan, step: Callable, cotangents: list | None) -> None:
    """The reverse schedule: ``step(m, out_grads) -> in_grads`` on
    microbatches M-1..0, each output wire's gradient received from s + 1
    (on the last stage: ``cotangents[i][m]``) and each input wire's
    gradient sent to s - 1. Tags start past every forward tag."""
    s, group, last, m_total = plan.stage, plan.group, plan.num_stages - 1, plan.num_microbatches
    templ = plan.wire0
    n = len(templ)
    base = m_total * n

    def post_recv(m):
        return [comm.irecv(t, s + 1, group, tag=base + m * n + i) for i, t in enumerate(templ)]

    pending = post_recv(m_total - 1) if s < last and m_total else None
    sends = []
    for m in reversed(range(m_total)):
        if s == last:
            g_out = [c[m] for c in cotangents]
        else:
            g_out = [finish() for finish in pending]
            if m > 0:
                pending = post_recv(m - 1)
        g_in = step(m, g_out)
        if s > 0:
            sends += [comm.isend(g, s - 1, group, tag=base + m * n + i) for i, g in enumerate(g_in)]
    for work, _buf in sends:
        work.wait()


def _result(plan: _Plan, emits: list) -> list:
    """The last stage's emits stacked to (M, Bm, ...) leaves, on every rank
    of the stage group; gathered over 'data' under DP x PP."""
    s, last = plan.stage, plan.num_stages - 1
    if s == last:
        result = [torch.stack([e[i] for e in emits]) for i in range(len(plan.wire0))]
    else:
        result = [torch.empty((plan.num_microbatches, *t.shape), dtype=t.dtype, device=t.device) for t in plan.wire0]
    for t in result:
        comm.broadcast_(t, last, plan.group)
    if plan.batch_axis is not None:
        result = [comm.all_gather_cat(t, axis_group(plan.mesh, plan.batch_axis), dim=1) for t in result]
    return result


def _differentiable(t: torch.Tensor) -> bool:
    return t.is_floating_point() or t.is_complex()


class _StagePart(torch.autograd.Function):
    """This rank's part of the schedule, differentiable (module doc)."""

    @staticmethod
    def forward(ctx, plan: _Plan, n_params: int, *tensors):
        needs = ctx.needs_input_grad[2:]
        params = [t.detach().requires_grad_(bool(g)) for t, g in zip(tensors[:n_params], needs)]
        stream = [t.detach().requires_grad_(bool(g)) for t, g in zip(tensors[n_params:], needs[n_params:])]
        s = plan.stage
        kept_in, kept_out = [], []

        def step(m, wire):
            if plan.remat:
                kept_in.append(wire)
                with torch.no_grad():
                    return plan.call(params, wire, [a[m] for a in plan.local(stream)])
            with torch.enable_grad():
                wire_in = wire if s == 0 else [w.detach().requires_grad_(_differentiable(w)) for w in wire]
                out = plan.call(params, wire_in, [a[m] for a in plan.local(stream)])
            kept_in.append(wire_in)
            kept_out.append(out)
            return out

        result = _result(plan, _forward_schedule(plan, step))
        ctx.plan, ctx.params, ctx.stream = plan, params, stream
        ctx.kept_in, ctx.kept_out = kept_in, kept_out
        ctx.mark_non_differentiable(*[t for t in result if not _differentiable(t)])
        return tuple(result)

    @staticmethod
    def backward(ctx, *grad_result):
        plan, params, stream = ctx.plan, ctx.params, ctx.stream
        s, last = plan.stage, plan.num_stages - 1
        cot = None
        if s == last:  # the cotangent, taken once: the other ranks' copies are the same loss's
            cot = [torch.zeros((plan.num_microbatches, *t.shape), dtype=t.dtype, device=t.device)
                   if g is None else g for g, t in zip(grad_result, plan.wire0)]
            if plan.batch_axis is not None:
                cot = plan.local(cot)
        targets = [t for t in params + stream if t.requires_grad]
        sums = [torch.zeros_like(t) for t in targets]

        def step(m, g_out):
            if plan.remat:
                with torch.enable_grad():
                    wire_in = ctx.kept_in[m]
                    if s > 0:
                        wire_in = [w.detach().requires_grad_(_differentiable(w)) for w in wire_in]
                    out = plan.call(params, wire_in, [a[m] for a in plan.local(stream)])
            else:
                wire_in, out = ctx.kept_in[m], ctx.kept_out[m]
            wires = [w for w in wire_in if w.requires_grad] if s > 0 else []
            pairs = [(o, g) for o, g in zip(out, g_out) if o.requires_grad]
            got = [None] * (len(wires) + len(targets))
            if pairs and wires + targets:
                got = torch.autograd.grad([o for o, _ in pairs], wires + targets, [g for _, g in pairs],
                                          allow_unused=True)
            for acc, g in zip(sums, got[len(wires):]):
                if g is not None:
                    acc += g
            if s == 0:
                return []
            return _wire_grads(wire_in, got[: len(wires)])

        _backward_schedule(plan, step, cot)
        _reduce(plan, params, stream, sums)
        grads = iter(sums)
        out = [next(grads) if t.requires_grad else None for t in params + stream]
        return (None, None, *out)


def _wire_grads(wire_in: list, got: list) -> list:
    """The input wire's gradient leaf by leaf, zeros where a leaf has none
    (``got`` holds one entry a leaf that requires grad)."""
    it = iter(got)
    out = []
    for w in wire_in:
        g = next(it) if w.requires_grad else None
        out.append(torch.zeros_like(w) if g is None else g)
    return out


def _reduce(plan: _Plan, params: list, stream: list, sums: list) -> None:
    """Sum the gradients over the stage group (but stage-resident slices)
    and over 'data', in place, one flat buffer a dtype and a group."""
    stage_reduced = plan.stage_reduced + [True] * len(stream)
    chosen = [t.requires_grad for t in params + stream]
    over_stage = [r for r, c in zip(stage_reduced, chosen) if c]
    groups = [(plan.group, over_stage)]
    if plan.batch_axis is not None:
        groups.append((axis_group(plan.mesh, plan.batch_axis), [True] * len(sums)))
    for group, which in groups:
        by_dtype: dict = {}
        for g, w in zip(sums, which):
            if w:
                by_dtype.setdefault(g.dtype, []).append(g)
        for gs in by_dtype.values():
            flat = torch.cat([g.reshape(-1) for g in gs])
            comm.all_reduce_(flat, group)
            for g, part in zip(gs, torch.split(flat, [g.numel() for g in gs])):
                g.copy_(part.view_as(g))


def _run(plan: _Plan, params: list, stream: list) -> list:
    """The pipeline's result leaves on this rank: through ``_StagePart``
    when a gradient is wanted, else the forward schedule alone."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in params + stream):
        return list(_StagePart.apply(plan, len(params), *params, *stream))

    def step(m, wire):
        return plan.call(params, wire, [a[m] for a in plan.local(stream)])

    return _result(plan, _forward_schedule(plan, step))


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
    the last stage's wires, (M, Bm, ...) leaves, on every rank.
    Differentiable in ``stage_params`` and ``stream`` (module doc);
    ``remat=True`` recomputes each stage in the backward."""
    num_stages = _check_stage_axis(mesh, stage_axis)
    if len(stage_fns) != num_stages:
        raise ValueError(f"{len(stage_fns)} stage fns for a {num_stages}-wide '{stage_axis}' axis")

    def pipeline(stage_params, stream, wire0):
        _check_leaves(stream, 1)
        _check_leaves(wire0, 0)
        s = axis_index(mesh, stage_axis)
        params, rebuild_params = _flatten(stage_params)
        stream_leaves, rebuild_stream = _flatten(stream)
        templ, rebuild_wire = _flatten(_data_shard(wire0, mesh, batch_axis, 0))

        def call(p, wire, inp):
            out = stage_fns[s](rebuild_params(p)[s], rebuild_wire(wire), rebuild_stream(inp))
            return _flatten(out)[0]

        plan = _Plan(call, mesh, stage_axis, batch_axis, num_stages, int(stream_leaves[0].shape[0]), templ,
                     rebuild_wire, [True] * len(params), remat)
        return rebuild_wire(_run(plan, params, stream_leaves))

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
    the per-stage parameter residency that makes PP worth running; its
    gradient is this rank's slice's). Differentiable as ``make_gpipe``."""
    num_stages = _check_stage_axis(mesh, stage_axis)

    def pipeline(stage_params, wires):
        _check_leaves(wires, 1)
        for leaf in _flatten(stage_params)[0]:
            if leaf.shape[0] not in (1, num_stages):
                raise ValueError(f"stacked stage params need leading dim {num_stages}; got {tuple(leaf.shape)}")
        s = axis_index(mesh, stage_axis)
        params, rebuild_params = _flatten(stage_params)
        stream_leaves, rebuild_stream = _flatten(wires)
        wire0 = tree_map(lambda a: torch.zeros(a.shape[1:], dtype=a.dtype, device=a.device), wires)
        templ, rebuild_wire = _flatten(_data_shard(wire0, mesh, batch_axis, 0))

        def call(p, wire, inp):
            local = rebuild_params([a[0] if a.shape[0] == 1 else a[s] for a in p])
            return _flatten(stage_fn(local, rebuild_stream(inp) if s == 0 else rebuild_wire(wire)))[0]

        resident = [a.shape[0] == 1 and num_stages > 1 for a in params]
        plan = _Plan(call, mesh, stage_axis, batch_axis, num_stages, int(stream_leaves[0].shape[0]), templ,
                     rebuild_wire, [not r for r in resident], remat)
        return rebuild_wire(_run(plan, params, stream_leaves))

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
    remat: bool = False,
) -> Callable:
    """The flagship split at the model's seams: a 2-wide ``stage_axis``
    splits FCN-8 forward | refinement, a 3-wide one VGG backbone | FCN-8
    head | refinement (``fcn8_backbone`` / ``fcn8_head``). ``engine='half'``
    refines through ``inference.fused.halfres_refine`` (the DAE only);
    'general' through ``inference.iterative.logits_refinement_scan`` with the
    registry's score network (``dae_arch``) and ``renorm``. The wire carries
    {y0, the h taps, yk} (2 stages) or {pool3/4/5, y0, yk} (3 stages, which
    condition on pool taps alone); the images stay out of it.

    Returns ``forward(fcn_params, dae_params, images) -> (y0, y_k)``,
    ``images`` (M, Bm, H, W, 3) (``split_microbatches``), both results
    (M, Bm, H, W, C) on every rank. Serve it under ``torch.no_grad`` (energy
    mode: ``inference.fused.no_autograd``); with grad enabled and params
    that require it, it is differentiable as ``make_gpipe``, and ``remat``
    recomputes each stage in the backward (the JAX function has no
    ``remat`` knob)."""
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
        from iterative_inference_segm_tpu_torch.inference.iterative import logits_refinement_scan
        from iterative_inference_segm_tpu_torch.models.registry import score_kwargs, score_logits_fn

        if state_dtype is not None or fold_tail is not None:
            raise ValueError("state_dtype/fold_tail are pooled-engine knobs; the general engine carries "
                             "f32 full-res state with the unfolded tail")
        s_logits = score_logits_fn(dae_arch)
        s_kw = dict(score_kwargs(dae_arch, depth=depth, encoder=encoder), compute_dtype=compute_dtype)
        probs_dtype = torch.float32  # the general engine's convention

        def refine(dae_params, y0, h, in_hw):
            return logits_refinement_scan(lambda y: s_logits(dae_params, y, h, **s_kw), y0, eps=eps,
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

    pipeline = make_gpipe(stage_fns, mesh, stage_axis=stage_axis, batch_axis=batch_axis, remat=remat)

    def forward(fcn_params, dae_params, images):
        if images.ndim != 5:
            raise ValueError(f"images must be (M, Bm, H, W, 3) microbatches; got {tuple(images.shape)}")
        wire0 = make_wire0(fcn_params, images[0])
        out = pipeline(stage_params_of(fcn_params, dae_params), images, wire0)
        return out["y0"], out["yk"]

    return forward
