"""One function's device work captured once as a CUDA graph and replayed.

A function of a tree of tensors (nested tuples, NamedTuples included) that
queues its work with no host read and no host-to-device copy can be
captured: :class:`CapturedStep` copies the arguments into static buffers,
runs the function once eagerly on a side stream (which creates the cuBLAS
and cuSOLVER handles and fills any cache the function keeps), captures a
second call into a graph, and returns the eager call's results. Every later
call copies its arguments in, replays the graph and copies the results out:
a handful of launches in place of one per operator.

The copies in and out group the tensors by dtype, one
``torch._foreach_copy_`` a group. The results are always copies: the graph
rewrites its outputs at every replay, and a result may be one of the static
inputs itself. A leaf that the function returns twice is copied once and
returned twice, as the eager call returns one tensor twice.

Counts the function makes through ``utils/trace.py`` are kept at the capture
and made again at every replay (``trace.recount``), the device ones from a
copy of their tensors stacked inside the graph.

:class:`ChainedStep` captures one step of a loop, ``fn(invariants, carry)
-> carry``: the graph ends by writing the carry it computed back into its
own static carry, so replay i + 1 reads what replay i wrote and n replays
run n steps with nothing on the host between them but the launches. The
invariants are copied in once per loop and the carry copied out after the
last replay.
"""

from __future__ import annotations

from typing import Callable

import torch

from gfplslam_torch.utils import trace

_STREAMS: dict = {}


def leaves(tree) -> list:
    """The tensors of ``tree`` in order."""
    if isinstance(tree, tuple):
        return [t for x in tree for t in leaves(x)]
    return [tree]


def rebuild(tree, flat):
    """``tree`` with its leaves replaced, in order, from the iterator
    ``flat``."""
    if isinstance(tree, tuple):
        items = [rebuild(x, flat) for x in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)
    return next(flat)


def signature(tree) -> tuple:
    """Shape and dtype of each leaf of ``tree``, and its nesting."""
    if isinstance(tree, tuple):
        return (type(tree).__name__, tuple(signature(x) for x in tree))
    return (tuple(tree.shape), tree.dtype)


def copy_all(dst: list, src: list) -> None:
    """``dst[i].copy_(src[i])`` for every i, one ``_foreach_copy_`` per
    pair of dtypes."""
    groups: dict = {}
    for d, s in zip(dst, src):
        g = groups.setdefault((d.dtype, s.dtype), ([], []))
        g[0].append(d)
        g[1].append(s)
    for ds, ss in groups.values():
        torch._foreach_copy_(ds, ss)


def clone_all(src: list) -> list:
    """A copy of each tensor of ``src``; a tensor listed twice is copied
    once."""
    uniq = {id(t): t for t in src}
    out = {k: torch.empty_like(t) for k, t in uniq.items()}
    copy_all(list(out.values()), list(uniq.values()))
    return [out[id(t)] for t in src]


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    s = _STREAMS.get(device)
    if s is None:
        s = _STREAMS[device] = torch.cuda.Stream(device=device)
    return s


class CapturedStep:
    """``fn`` captured on the shapes of ``args``; :attr:`first` holds the
    results of the eager call made at construction."""

    def __init__(self, fn: Callable, args: tuple):
        device = leaves(args)[0].device
        with torch.cuda.device(device):
            flat = leaves(args)
            self.static = [torch.empty(t.shape, dtype=t.dtype, device=device)
                           for t in flat]
            copy_all(self.static, flat)
            static_args = rebuild(args, iter(self.static))
            side, main = _side_stream(device), torch.cuda.current_stream(device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                first = fn(*static_args)
            main.wait_stream(side)
            first_flat = leaves(first)
            for t in first_flat:
                t.record_stream(main)
            self.first = rebuild(first, iter(clone_all(first_flat)))

            self.graph = torch.cuda.CUDAGraph()
            with trace.captured_counts() as counts, torch.cuda.graph(
                    self.graph, stream=side, capture_error_mode="thread_local"):
                out = fn(*static_args)
                flags = (torch.stack([t.reshape(()) for _, t, _ in counts.device])
                         if counts.device else None)
            self.counts = counts
            self.out_tree = out
            self.out = leaves(out) + ([flags] if flags is not None else [])

    def __call__(self, args: tuple):
        """Copy ``args`` in, replay, and return copies of the results."""
        copy_all(self.static, leaves(args))
        self.graph.replay()
        res = clone_all(self.out)
        trace.recount(self.counts, res[-1] if self.counts.device else None)
        return rebuild(self.out_tree, iter(res))


class ChainedStep:
    """``fn(invariants, carry) -> carry`` captured on the shapes of its
    arguments, each replay one step of a loop whose carry stays in the
    graph's static buffers. Construction runs one step eagerly on a side
    stream (the warm-up) and captures the next. A loop then calls
    :meth:`load` with its arguments, :meth:`replay` once per step and
    :meth:`result` for the carry. ``fn`` makes no count through
    ``utils/trace.py``."""

    def __init__(self, fn: Callable, invariants: tuple, carry: tuple):
        device = leaves(carry)[0].device
        with torch.cuda.device(device):
            self.invariants = [torch.empty_like(t) for t in leaves(invariants)]
            self.carry = [torch.empty_like(t) for t in leaves(carry)]
            self.tree = rebuild(carry, iter(self.carry))
            self.load(invariants, carry)
            args = (rebuild(invariants, iter(self.invariants)), self.tree)
            side, main = _side_stream(device), torch.cuda.current_stream(device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                self._write_back(fn(*args))
            main.wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, stream=side,
                                  capture_error_mode="thread_local"):
                self._write_back(fn(*args))

    def _write_back(self, out) -> None:
        """The step's carry into the static carry; a result that is a
        static buffer itself is copied first, so no copy reads what
        another has overwritten."""
        mine = {t.untyped_storage().data_ptr() for t in self.carry}
        copy_all(self.carry, [t.clone() if t.untyped_storage().data_ptr() in mine
                              else t for t in leaves(out)])

    def load(self, invariants: tuple, carry: tuple) -> None:
        """Copy a new loop's invariants and first carry in."""
        copy_all(self.invariants + self.carry, leaves(invariants) + leaves(carry))

    def replay(self) -> None:
        """One step, on the current stream."""
        self.graph.replay()

    def result(self):
        """A copy of the carry, shaped as the carry given at construction."""
        return rebuild(self.tree, iter(clone_all(self.carry)))
