"""The one policy of every CUDA-graph capture in the process.

A model module makes one call here, :func:`step` for a single step or
:func:`loop` for a loop of chained steps, with a name (the prefix of the
spans and counters), the function, its arguments (trees of tensors: nested
tuples, NamedTuples included), the settings the function bakes in as
constants, and whether it can be captured at all. The call is keyed on
``(name, device, signature(args), settings)``, and one rule decides, in
this order: eager when an input leaf is not on a CUDA device; eager when
the function cannot be captured; eager while the tracer synchronises every
span (``run_slam --timing``, where each stage span times its own work);
otherwise eager at a key's first sight in the process (so a step made once,
such as ``finish``'s global BA, pins no graph), captured at its second
(span ``<name>.capture``, counter ``<name>.graph_captures``) and replayed
from then on (counter ``<name>.graph_replays``). The graphs are kept by key
for the process, so engines that follow each other share them.

A captured function queues its work with no host read and no host-to-device
copy. A capture runs it once eagerly on a side stream (which creates the
cuBLAS and cuSOLVER handles and fills any cache it keeps), then captures a
second call.

:class:`CapturedStep` holds ``fn(*args) -> result``: a replay copies the
arguments into static buffers, replays the graph and copies the results
out, each copy one ``torch._foreach_copy_`` per dtype. The results are
always copies: the graph rewrites its outputs at every replay, and a result
may be a static input itself. A leaf returned twice is copied once and
returned twice, as the eager call returns it. Counts the function makes
through ``utils/trace.py`` are kept at the capture and made again at every
replay (``trace.recount``), the device ones from a copy of their tensors
stacked inside the graph.

:class:`ChainedStep` holds one step of a loop, ``fn(invariants, carry) ->
carry``: the graph ends by writing its carry back into its own static
carry, so replay i + 1 reads what replay i wrote and n replays run n steps
with nothing on the host between them but the launches. The invariants are
copied in once per loop and the carry copied out after the last replay.
"""

from __future__ import annotations

from typing import Callable

import torch

from gfplslam_torch.utils import trace

_STREAMS: dict = {}
# every captured step of the process, by key, and every key seen
_GRAPHS: dict = {}
_SEEN: set = set()


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


def _on_card(flat: list) -> bool:
    """Whether every tensor of ``flat`` is on a CUDA device."""
    return all(t.is_cuda for t in flat)


def _graph(name: str, tree, settings: tuple, capturable: bool,
           make: Callable):
    """The captured step for a call on ``tree`` under the policy: None
    where the call runs eagerly, else the key's step, made by ``make()``
    at the key's second sight."""
    flat = leaves(tree)
    if not capturable or not _on_card(flat) or trace.synchronizing():
        return None
    key = (name, flat[0].device, signature(tree), settings)
    g = _GRAPHS.get(key)
    if g is None and key in _SEEN:
        with trace.span(f"{name}.capture"):
            g = _GRAPHS[key] = make()
        trace.count(f"{name}.graph_captures", 1)
    _SEEN.add(key)
    return g


def step(name: str, fn: Callable, args: tuple, *, settings: tuple,
         capturable: bool = True):
    """``fn(*args)``, run eagerly, captured or replayed as the policy
    decides; a replay inside span ``<name>.replay``."""
    g = _graph(name, args, settings, capturable, lambda: CapturedStep(fn, args))
    if g is None:
        return fn(*args)
    if g.first is not None:
        first, g.first = g.first, None
        return first
    with trace.span(f"{name}.replay"):
        out = g(args)
    trace.count(f"{name}.graph_replays", 1)
    return out


def loop(name: str, fn: Callable, invariants: tuple, carry: tuple, n: int, *,
         settings: tuple, capturable: bool = True):
    """``carry = fn(invariants, carry)`` ``n`` times, each step eagerly or
    as a replay as the policy decides, inside span ``<name>.iter``; the
    last carry."""
    g = _graph(name, (invariants, carry), settings, capturable,
               lambda: ChainedStep(fn, invariants, carry))
    if g is None:
        for _ in range(n):
            with trace.span(f"{name}.iter"):
                carry = fn(invariants, carry)
        return carry
    g.load(invariants, carry)
    for _ in range(n):
        with trace.span(f"{name}.iter"):
            g.replay()
    trace.count(f"{name}.graph_replays", n)
    return g.result()


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    s = _STREAMS.get(device)
    if s is None:
        s = _STREAMS[device] = torch.cuda.Stream(device=device)
    return s


def _capture(device: torch.device, body: Callable):
    """``body()`` run once eagerly on the device's side stream, the warm-up,
    then a second call captured there into a graph. Returns the warm-up's
    result, the graph, the captured call's result, the counts the capture
    made (``trace.captured_counts``) and a stack of their device values
    that the graph rewrites at each replay (None without one)."""
    with torch.cuda.device(device):
        side, main = _side_stream(device), torch.cuda.current_stream(device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            first = body()
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with trace.captured_counts() as counts, torch.cuda.graph(
                graph, stream=side, capture_error_mode="thread_local"):
            out = body()
            flags = (torch.stack([t.reshape(()) for _, t, _ in counts.device])
                     if counts.device else None)
    return first, graph, out, counts, flags


class CapturedStep:
    """``fn`` captured on the shapes of ``args``; :attr:`first` holds the
    results of the eager call made at construction until :func:`step`
    returns them."""

    def __init__(self, fn: Callable, args: tuple):
        flat = leaves(args)
        self.static = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
                       for t in flat]
        copy_all(self.static, flat)
        static_args = rebuild(args, iter(self.static))
        first, self.graph, out, self.counts, flags = _capture(
            flat[0].device, lambda: fn(*static_args))
        first_flat = leaves(first)
        for t in first_flat:
            t.record_stream(torch.cuda.current_stream(t.device))
        self.first = rebuild(first, iter(clone_all(first_flat)))
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
        self.invariants = [torch.empty_like(t) for t in leaves(invariants)]
        self.carry = [torch.empty_like(t) for t in leaves(carry)]
        self.tree = rebuild(carry, iter(self.carry))
        self.load(invariants, carry)
        args = (rebuild(invariants, iter(self.invariants)), self.tree)
        _, self.graph, _, _, _ = _capture(
            self.carry[0].device, lambda: self._write_back(fn(*args)))

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
