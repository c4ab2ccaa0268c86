"""Host->device prefetch: overlap the copies with compute.

The port of ``iterative_inference_segm_tpu.data.prefetch``: keep ``depth``
batches already on the device while the current step computes. On a CUDA
device each array of a batch is copied into a pinned host buffer and sent
with a ``non_blocking`` copy on a side stream, so the copy overlaps the
consumer's kernels. Three rules keep that sound:

* the consumer's stream waits on the copy's event before it sees the batch;
* each tensor is ``record_stream``-ed on the consumer's stream, so the
  caching allocator does not hand its memory out again while the consumer's
  kernels may still read it;
* a pinned buffer is refilled only after the copy that last read it has
  finished (its event is waited on first).

On the CPU it yields ``torch.from_numpy`` views: no copy. ``sharding`` (a
``parallel.sharding.Placement``, e.g. ``batch_sharding(mesh, 4)``) places
each leaf over a mesh: each rank copies only its own part of every leaf
(cut on the host, so only the shard's bytes are pinned and sent).
"""

from __future__ import annotations

import collections
import itertools
from typing import Iterable, Iterator

import numpy as np
import torch


def _tree_map(fn, item):
    if isinstance(item, (tuple, list)):
        return type(item)(_tree_map(fn, x) for x in item)
    if isinstance(item, dict):
        return {k: _tree_map(fn, v) for k, v in item.items()}
    return fn(item)


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))


class _PinnedSlot:
    """The pinned host buffers of one batch in flight, and the event that
    marks the end of their copies to the device."""

    def __init__(self):
        self.buffers: dict[int, torch.Tensor] = {}
        self.event: torch.cuda.Event | None = None

    def claim(self) -> None:
        """Wait until this slot's last copies have read their buffers."""
        if self.event is not None:
            self.event.synchronize()
        self.event = None

    def buffer(self, i: int, src: torch.Tensor) -> torch.Tensor:
        """The slot's i-th pinned buffer, shaped as ``src`` and filled with it."""
        buf = self.buffers.get(i)
        if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
            buf = self.buffers[i] = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        buf.copy_(src)
        return buf


def device_prefetch(
    iterator: Iterable,
    *,
    depth: int = 2,
    device: torch.device | str | None = None,
    sharding=None,
) -> Iterator:
    """Yield the items of ``iterator`` (tuples, lists or dicts of numpy
    arrays or tensors) with every leaf on ``device`` (default: the current
    CUDA device), ``depth`` items ahead of the consumer; with ``sharding``,
    this rank's part of every leaf."""
    if sharding is not None:
        from iterative_inference_segm_tpu_torch.parallel.sharding import Placement

        if not isinstance(sharding, Placement):
            raise TypeError(f"sharding must be a parallel.sharding.Placement; got {type(sharding).__name__}")
        iterator = (_tree_map(sharding.local, item) for item in iterator)
    if depth < 1:
        raise ValueError(f"depth must be >= 1; got {depth}")
    device = torch.device("cuda" if device is None else device)
    queue: collections.deque = collections.deque()
    it = iter(iterator)

    if device.type == "cuda":
        copy_stream = torch.cuda.Stream(device)
        slots = [_PinnedSlot() for _ in range(depth + 1)]
        n_put = 0

        def put(item):
            nonlocal n_put
            slot = slots[n_put % len(slots)]
            n_put += 1
            slot.claim()
            leaves = itertools.count()
            with torch.cuda.stream(copy_stream):
                out = _tree_map(
                    lambda x: slot.buffer(next(leaves), _as_tensor(x)).to(device, non_blocking=True), item)
                slot.event = torch.cuda.Event()
                slot.event.record(copy_stream)
            return out, slot.event

        def take(entry):
            out, event = entry
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(event)

            def hand_over(t):
                t.record_stream(consumer)
                return t

            return _tree_map(hand_over, out)
    else:
        def put(item):
            return _tree_map(lambda x: _as_tensor(x).to(device), item)

        def take(entry):
            return entry

    for item in it:
        queue.append(put(item))
        if len(queue) == depth:
            break
    while queue:
        out = take(queue.popleft())
        for item in it:
            queue.append(put(item))
            break
        yield out
