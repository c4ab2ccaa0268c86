"""Spatial (H) sharding: each rank of a 'space' group holds a band of rows
of every map, and the ops that look across rows fetch the rows they need
from the ranks that hold them.

This module has no counterpart in the JAX package. There, H is one more
mesh axis of a ``NamedSharding`` (``parallel.sharding.batch_sharding(...,
spatial_axis='space')``) and XLA inserts the halo exchanges
(collective-permutes) around each conv, pool and transposed conv. The port
runs one process a device, so it writes the exchange out:

* ``Rows`` is the layout of one map: its global height, and the band
  ``bounds(height, n)[index]`` that this rank holds. Rows split as evenly
  as they can; the odd rows go to the last shards, so a ceil-mode pool's
  tail window lies on the last shard. A map with fewer rows than shards
  leaves the first shards empty.
* ``fetch_rows`` is the one primitive that moves rows. A rank that holds
  rows ``[lo, hi)`` and needs ``[a, b)`` gets the rows it lacks from their
  owners with ``comm.isend``/``comm.irecv`` (neighbours, for a halo);
  beyond the map's edges it reads a fill (zeros, ``-inf`` for a max-pool,
  or the edge row). It is an ``autograd.Function``: its backward sends the
  gradient of each fetched row back to the row's owner, which adds it.
  Halos, the Caffe centre crop and the re-partition before a strided op
  are all instances of it (``ops/conv.py``, each op's ``space``).
* ``gather_rows`` is the one all-gather: a map with fewer rows than shards
  (FCN-8's /32 map at a small height) is gathered once and run replicated;
  ``own_rows`` re-shards it, a slice.
* ``sum_over`` sums a loss's numerator or count over the group.

The ops take the layout of their input explicitly (``space=``), as the
tensor-parallel head takes its ``model_group``; per-pixel work (bias,
ReLU, softmax, argmax, the blend) needs none and stays local. Every rank
runs the same ops in the same order, also when its band of a map is empty
(it then computes one row of fill and keeps none of it), so the exchanges
of the forward and of the backward meet.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch
import torch.distributed as dist

from iterative_inference_segm_tpu_torch.parallel import comm

# Each exchange takes a tag of its own, the same on every rank (every rank
# makes the same exchanges in the same order); a backward's tag is its
# forward's plus one.
_TAG = [0]
_TAG_WRAP = 1 << 20


def bounds(height: int, n: int) -> tuple[tuple[int, int], ...]:
    """The rows ``[lo, hi)`` of each of ``n`` shards of a ``height``-row
    map: ``height // n`` each, one more on each of the last ``height % n``."""
    base, extra = divmod(int(height), int(n))
    out, lo = [], 0
    for i in range(n):
        hi = lo + base + (1 if i >= n - extra else 0)
        out.append((lo, hi))
        lo = hi
    return tuple(out)


@dataclass(frozen=True)
class Rows:
    """The layout of an H-sharded map: ``height`` global rows over the ``n``
    ranks of ``group``, this rank (``index``) holding ``span``."""

    group: object
    n: int
    index: int
    height: int

    @property
    def bounds(self) -> tuple[tuple[int, int], ...]:
        return bounds(self.height, self.n)

    @property
    def span(self) -> tuple[int, int]:
        return self.bounds[self.index]

    def at(self, height: int) -> "Rows":
        """The layout of a map of ``height`` rows over the same ranks."""
        return replace(self, height=int(height))

    def scaled(self, k: int) -> "Rows":
        """The layout of this map after ``k`` ceil-mode halvings (a pool
        chain: 360 -> 180 -> 90 -> 45 -> 23 -> 12)."""
        return self.at(-(-self.height // (1 << k)))


def rows_of(group, x: torch.Tensor) -> Rows:
    """The layout of an input map ``x`` (NHWC) split evenly over ``group``:
    this rank's ``x`` holds its 1/n of the rows."""
    if group is None:
        raise RuntimeError("spatial sharding needs the 'space' group of a launched mesh (parallel.launch)")
    n = dist.get_world_size(group)
    return Rows(group, n, dist.get_rank(group), int(x.shape[1]) * n)


def _clip(want, height):
    out = []
    for w in want:
        if w is not None:
            lo, hi = max(w[0], 0), min(w[1], height)
            w = (lo, max(lo, hi))
        out.append(w)
    return out


def _overlap(p, q):
    lo, hi = max(p[0], q[0]), min(p[1], q[1])
    return (lo, hi) if hi > lo else None


def _exchange(space: Rows, sends, recvs, like: torch.Tensor, tag: int):
    """Post every send and receive of one exchange, then wait for them all.
    ``sends``: ``[(group rank, tensor)]``; ``recvs``: ``[(group rank,
    shape)]``. Returns the received tensors, in ``recvs``' order."""
    works, finishes = [], []
    for peer, shape in recvs:
        finishes.append(comm.irecv(like.new_empty(shape), peer, space.group, tag=tag))
    for peer, t in sends:
        works.append(comm.isend(t, peer, space.group, tag=tag))
    got = [f() for f in finishes]
    for work, _buf in works:
        work.wait()
    return got


class _Fetch(torch.autograd.Function):
    """Rows ``want[index]`` (inside the map) of an H-sharded map, from
    their owners; ``want`` holds every rank's request (None = none)."""

    @staticmethod
    def forward(ctx, x, space: Rows, want):
        me = space.index
        own = space.bounds
        tag = _TAG[0]
        _TAG[0] = (_TAG[0] + 2) % _TAG_WRAP
        ctx.space, ctx.want, ctx.tag, ctx.x_shape = space, want, tag, tuple(x.shape)
        sends, recvs, pieces = [], [], []
        for j in range(space.n):
            if j != me and want[j] is not None:
                ov = _overlap(own[me], want[j])
                if ov:
                    sends.append((j, x[:, ov[0] - own[me][0]: ov[1] - own[me][0]]))
        mine = want[me]
        for j in range(space.n if mine is not None else 0):
            ov = _overlap(own[j], mine)
            if ov is None:
                continue
            if j == me:
                pieces.append((j, x[:, ov[0] - own[me][0]: ov[1] - own[me][0]]))
            else:
                recvs.append((j, (x.shape[0], ov[1] - ov[0], *x.shape[2:])))
                pieces.append((j, None))
        got = iter(_exchange(space, sends, recvs, x, tag))
        if not pieces:
            return x[:, :0].clone()
        return torch.cat([t if t is not None else next(got) for _, t in pieces], dim=1)

    @staticmethod
    def backward(ctx, g):
        space, want, me = ctx.space, ctx.want, ctx.space.index
        own = space.bounds
        gx = torch.zeros(ctx.x_shape, dtype=g.dtype, device=g.device)
        sends, recvs, adds = [], [], []
        mine = want[me]
        if mine is not None:
            for j in range(space.n):
                ov = _overlap(own[j], mine)
                if ov is None:
                    continue
                piece = g[:, ov[0] - mine[0]: ov[1] - mine[0]]
                if j == me:
                    gx[:, ov[0] - own[me][0]: ov[1] - own[me][0]] += piece
                else:
                    sends.append((j, piece))
        for j in range(space.n):
            if j != me and want[j] is not None:
                ov = _overlap(own[me], want[j])
                if ov:
                    recvs.append((j, (g.shape[0], ov[1] - ov[0], *g.shape[2:])))
                    adds.append(ov)
        for ov, got in zip(adds, _exchange(space, sends, recvs, g, ctx.tag + 1)):
            gx[:, ov[0] - own[me][0]: ov[1] - own[me][0]] += got
        return gx, None, None


def fetch_rows(x: torch.Tensor, space: Rows, want, fill=0.0) -> torch.Tensor:
    """This rank's block of rows ``want[space.index] = (a, b)`` of the map
    whose band ``x`` holds (``space``). ``want`` is every rank's request,
    in group-rank order (None: that rank asks for nothing); every rank of
    the group must call this with the same ``want``. Rows above 0 or from
    ``space.height`` on read ``fill``: a number, or ``'edge'`` for the
    map's first or last row. Returns ``(B, b - a, W, C)``."""
    height = space.height
    block = _Fetch.apply(x, space, _clip(want, height))
    if want[space.index] is None:
        return block
    a, b = want[space.index]
    top, bottom = max(0, min(b, 0) - a), max(0, b - max(a, height))
    if not (top or bottom):
        return block
    parts = []
    if fill == "edge" and block.shape[1]:
        parts = [block[:, :1].expand(-1, top, -1, -1), block, block[:, -1:].expand(-1, bottom, -1, -1)]
    else:
        value = 0.0 if fill == "edge" else fill
        pad = lambda k: torch.full((block.shape[0], k, *block.shape[2:]), value, dtype=block.dtype,
                                   device=block.device)
        parts = [pad(top), block, pad(bottom)]
    return torch.cat(parts, dim=1)


def rowwise(x: torch.Tensor, space: Rows, out_height: int, need, compute, fill=0.0) -> torch.Tensor:
    """Run a row-local op on an H-sharded map: this rank's band of the
    output (a map of ``out_height`` rows, laid out as ``space.at(
    out_height)``). ``need(lo, hi) -> (a, b)`` gives the input rows that
    output rows ``[lo, hi)`` read (past the edges they read ``fill``);
    ``compute(block, a, lo, hi)`` computes those output rows from the
    block of input rows ``[a, b)``. A rank whose band of the output is
    empty computes one row of fill alone and keeps none of it."""
    out = space.at(out_height)
    want = [need(lo, hi) if hi > lo else None for lo, hi in out.bounds]
    lo, hi = out.span
    block = fetch_rows(x, space, want, fill)
    if hi > lo:
        return compute(block, want[out.index][0], lo, hi)
    a, b = need(out_height, out_height + 1)
    shape = (block.shape[0], b - a, *block.shape[2:])
    block = torch.cat([block, torch.zeros(shape, dtype=block.dtype, device=block.device)], dim=1)
    return compute(block, a, out_height, out_height + 1)[:, :0]


class _Gather(torch.autograd.Function):
    """Every rank's band of a map, concatenated: the whole map on every
    rank (one all-gather, each band padded to the largest). Backward: the
    gradient of the whole map summed over the ranks, this rank's band."""

    @staticmethod
    def forward(ctx, x, space: Rows):
        ctx.space = space
        spans = space.bounds
        most = max(hi - lo for lo, hi in spans)
        pad = most - int(x.shape[1])
        xp = torch.cat([x, x.new_zeros((x.shape[0], pad, *x.shape[2:]))], dim=1) if pad else x
        parts = comm.all_gather_cat(xp.contiguous(), space.group, dim=1)
        return torch.cat([parts[:, j * most: j * most + hi - lo] for j, (lo, hi) in enumerate(spans)], dim=1)

    @staticmethod
    def backward(ctx, g):
        lo, hi = ctx.space.span
        g = comm.all_reduce_(g.contiguous().clone(), ctx.space.group)
        return g[:, lo:hi], None


def gather_rows(x: torch.Tensor, space: Rows) -> torch.Tensor:
    """The whole map whose band ``x`` holds, on every rank."""
    return _Gather.apply(x, space)


def own_rows(full: torch.Tensor, space: Rows) -> torch.Tensor:
    """This rank's band of a map every rank holds whole (a slice)."""
    lo, hi = space.span
    return full[:, lo:hi]


def sum_over(t: torch.Tensor, space: Rows | None) -> torch.Tensor:
    """``t`` summed over the space group (a loss's numerator or count; no
    gradient flows through the sum); ``t`` itself without a layout."""
    if space is None:
        return t
    return comm.all_reduce_(t.detach().clone(), space.group)
