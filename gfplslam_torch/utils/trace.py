"""Spans and counters of the program's host time, by layer.

A span marks one piece of host work: the dispatch of a pipeline stage, or a
blocking device-to-host read (a span of kind ``wait``). Every span name is
declared once in :data:`SPANS` with the layer it belongs to; readers (the
benchmark's metrics, ``run_slam --trace-out``, the tests) use these same
strings. Counters count host integers (:func:`count`) or hold references to
device values the program already computed (:func:`count_device`), read in
one transfer per device by :func:`snapshot`, never on the hot path.

Recording is off by default. A span that does not record costs one flag
check and returns a shared null context: no allocation, no device op, no
host read. It records after :func:`enable`, or while a ``torch.profiler``
session is active (one read of the profiler's enabled flag). A recorded span
holds its name, kind, start and end on ``time.perf_counter_ns()``, its parent
span and the frame id :func:`frame` set last; inside a profiler session it is
also a ``record_function`` range, so the profiler's trace holds the program's
spans on its own clock and :func:`idle_by_span` can put each device-idle gap
down to the span the host was in. ``enable(sync=True)`` ends every span with
a device synchronise: per-stage wall times, at the cost of the overlap
between host dispatch and device work (``run_slam --timing``).

Spans mark host dispatch. Nothing records while a CUDA stream is being
captured into a graph; under a later replay, the span around the replay
stands for the spans inside it. Counts made while a graph is captured are
kept for it instead (:func:`captured_counts`), and :func:`recount` adds
them again at each replay, so a counter counts a replayed step as it
counts an eager one. The tracer is process state for the one thread that
drives the engine.

Where several processes run sessions as ranks of one group
(``parallel/batch.py::run_slam_batch``), each rank's snapshot is brought to
rank 0 and kept there by :func:`absorb`, tagged with its rank, so that one
:func:`snapshot` holds the whole batch; every process reads the same
``perf_counter`` clock, so their spans share one time line.
"""

from __future__ import annotations

import contextlib
import functools
import json
import time
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

_LAYER_SLAM = "SLAM driver, per-frame path"
_LAYER_MAP = "mapping step and local BA"
_LAYER_VO = "host dispatch: VO driver, front-end, tracker"
_LAYER_BATCH = "batch driver: sessions over ranks sharing a card"

# every span the program opens, with its layer (PERF.md section 3)
SPANS: dict[str, str] = {
    # SLAM driver (models/slam.py)
    "slam.init": _LAYER_SLAM,
    "slam.process": _LAYER_SLAM,
    "slam.harvest": _LAYER_SLAM,
    "slam.upload": _LAYER_SLAM,
    "slam.scan_chunk": _LAYER_SLAM,
    "slam.process_scanned": _LAYER_SLAM,
    "slam.drain_lc": _LAYER_SLAM,
    "slam.close_loop": _LAYER_SLAM,
    "slam.finish": _LAYER_SLAM,
    "wait.kf_pose": _LAYER_SLAM,
    "wait.lc_row": _LAYER_SLAM,
    "wait.lc_rows": _LAYER_SLAM,
    "wait.chunk_scalars": _LAYER_SLAM,
    "wait.n_kf": _LAYER_SLAM,
    "wait.pgo_poses": _LAYER_SLAM,
    "wait.pgo_step": _LAYER_SLAM,
    "wait.fuse_counts": _LAYER_SLAM,
    "wait.snapshot_dropped": _LAYER_SLAM,
    "wait.trajectory": _LAYER_SLAM,
    # VO driver, front-end, tracker (models/vo.py, frame.py, tracker.py)
    "vo.process": _LAYER_VO,
    "vo.scan_step": _LAYER_VO,
    "vo.frontend": _LAYER_VO,
    "frontend.points": _LAYER_VO,
    "frontend.lines": _LAYER_VO,
    "frontend.line_desc": _LAYER_VO,
    "frontend.stereo_hamming": _LAYER_VO,
    "frontend.stereo_points": _LAYER_VO,
    "frontend.stereo_lines": _LAYER_VO,
    "vo.track": _LAYER_VO,
    "track.cross_hamming": _LAYER_VO,
    "track.cross_points": _LAYER_VO,
    "track.cross_lines": _LAYER_VO,
    "track.linecut": _LAYER_VO,
    "track.pose_opt": _LAYER_VO,
    "track.finalize": _LAYER_VO,
    "track.capture": _LAYER_VO,
    "track.replay": _LAYER_VO,
    "wait.vo_frame": _LAYER_VO,
    # mapping step, local BA, loop closure (models/mapping.py, ba.py, slam.py)
    "mapping.step": _LAYER_MAP,
    "map.add_keyframe": _LAYER_MAP,
    "map.ba_problem": _LAYER_MAP,
    "ba.solve": _LAYER_MAP,
    "ba.iter": _LAYER_MAP,
    "ba.capture": _LAYER_MAP,
    "map.apply_ba": _LAYER_MAP,
    "map.cull": _LAYER_MAP,
    "loop.insert_bow": _LAYER_MAP,
    "loop.candidates": _LAYER_MAP,
    "loop.verify": _LAYER_MAP,
    "loop.pose_graph": _LAYER_MAP,
    "map.fuse_landmarks": _LAYER_MAP,
    # batch driver (parallel/batch.py)
    "batch.sequence": _LAYER_BATCH,
    "batch.gather": _LAYER_BATCH,
}

# every counter, with what it counts
COUNTERS: dict[str, str] = {
    "pose_opt.iters_dispatched": "Gauss-Newton iterations queued by the tracker's pose solves",
    "pose_opt.iters_active": "of those, iterations that began not yet converged",
    "ba.iters_dispatched": "LM iterations queued by the bundle adjustments",
    "ba.iters_active": "of those, iterations that began not yet converged (BAResult.iters)",
    "pgo.steps_dispatched": "Gauss-Newton steps queued by the pose-graph solves",
    "pgo.steps_active": "of those, steps that began not yet converged",
    "ba.obs_pt": "valid point observations of each local BA problem",
    "ba.obs_ln": "valid line observations of each local BA problem",
    "track.graph_captures": "CUDA graphs captured of the tracker's step after its Hamming launch",
    "track.graph_replays": "tracker steps run as a replay of such a graph",
    "ba.graph_captures": "CUDA graphs captured of the local BA's LM iteration",
    "ba.graph_replays": "LM iterations run as a replay of such a graph",
    "batch.sessions": "SLAM sessions a rank ran in a batch",
    "batch.frames": "frames of those sessions",
}


class Span(NamedTuple):
    """One recorded span; ``parent`` is the index of the enclosing span in
    the snapshot's list, or -1; ``rank`` the rank of the process that
    recorded it (0 but for spans :func:`absorb` brought in)."""
    name: str
    kind: str            # "span" or "wait"
    start_ns: int        # time.perf_counter_ns()
    end_ns: int
    parent: int
    frame: int | None
    rank: int = 0

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


@dataclass
class Snapshot:
    """The spans and counters recorded since the last :func:`reset`:
    ``counters`` holds each counter's total, ``series`` each of its
    :func:`count` or :func:`count_device` calls in order, over every
    rank."""
    spans: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)
    series: dict = field(default_factory=dict)

    def ms(self, name: str) -> list:
        """The duration of every span named ``name``, in ms."""
        return [s.ms for s in self.spans if s.name == name]

    def ancestor(self, i: int, name: str) -> int:
        """Index of the innermost span named ``name`` enclosing span ``i``
        (``i`` itself included), or -1."""
        while i >= 0 and self.spans[i].name != name:
            i = self.spans[i].parent
        return i


class CapturedCounts(NamedTuple):
    """The counts made while one graph was captured: ``host`` as (name,
    n), ``device`` as (name, tensor, negate), each tensor one the graph
    rewrites at every replay."""
    host: list
    device: list


class Tracer:
    """The recorder behind the module's functions."""

    def __init__(self):
        self.on = False
        self.sync = False
        self.frame: int | None = None
        self.spans: list = []       # [name, kind, start_ns, end_ns, parent, frame]
        self.open: list = []        # indices of the spans not yet ended
        self.host: dict = {}        # name -> [int, ...]
        self.device: list = []      # (name, 0-d tensor, negate)
        self.last_s: dict = {}      # timed span name -> its last duration, s
        self.capture: CapturedCounts | None = None  # while a graph is captured
        self.absorbed: list = []    # (rank, Snapshot) of other processes


_T = Tracer()
_NULL = contextlib.nullcontext()


def recording() -> bool:
    """Whether spans and counters record now: after :func:`enable`, or
    while a ``torch.profiler`` session is active."""
    return _T.on or _autograd_profiler._is_profiler_enabled


def profiling() -> bool:
    """Whether a ``torch.profiler`` session is active."""
    return _autograd_profiler._is_profiler_enabled


def synchronizing() -> bool:
    """Whether every span ends with a device synchronise."""
    return _T.on and _T.sync


def _capturing() -> bool:
    return torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing()


def _synchronize() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _declared(name: str) -> str:
    if name not in SPANS:
        raise KeyError(f"span {name!r} is not declared in trace.SPANS")
    return name


class _Recorded:
    """One span being recorded."""
    __slots__ = ("name", "kind", "i", "rf")

    def __init__(self, name: str, kind: str):
        self.name, self.kind = _declared(name), kind

    def __enter__(self):
        t = _T
        self.i = len(t.spans)
        t.spans.append([self.name, self.kind, time.perf_counter_ns(), 0,
                        t.open[-1] if t.open else -1, t.frame])
        t.open.append(self.i)
        self.rf = None
        if _autograd_profiler._is_profiler_enabled:
            self.rf = _autograd_profiler.record_function(self.name)
            self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        t = _T
        if t.sync:
            _synchronize()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        t.spans[self.i][3] = time.perf_counter_ns()
        if t.open and t.open[-1] == self.i:
            t.open.pop()
        return False


def span(name: str, kind: str = "span"):
    """A context manager around one piece of host work named ``name``."""
    if not (_T.on or _autograd_profiler._is_profiler_enabled) or _capturing():
        return _NULL
    return _Recorded(name, kind)


def wait(name: str):
    """A span of kind ``wait``, around a blocking device-to-host read."""
    return span(name, "wait")


def spanned(name: str):
    """Decorator: every call of the function is a span named ``name``."""
    _declared(name)

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


class _Timed:
    """A span whose duration is measured whether or not it records (two
    clock reads); :func:`last_s` returns it. One object per name, so a
    timed span does not nest inside itself."""
    __slots__ = ("name", "t0", "inner")

    def __init__(self, name: str):
        self.name = _declared(name)

    def __enter__(self):
        self.inner = span(self.name)
        self.inner.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.inner.__exit__(*exc)
        _T.last_s[self.name] = (time.perf_counter_ns() - self.t0) * 1e-9
        return False


_TIMED: dict = {}


def timed(name: str):
    """:func:`span`, with its duration measured even when not recording."""
    t = _TIMED.get(name)
    if t is None:
        t = _TIMED[name] = _Timed(name)
    return t


def last_s(name: str) -> float:
    """Seconds of the last :func:`timed` span named ``name`` (0 before one)."""
    return _T.last_s.get(name, 0.0)


def frame(i: int | None) -> None:
    """Set the frame id that the spans opened from now on carry."""
    _T.frame = i


def count(name: str, n: int) -> None:
    """Add the host integer ``n`` to counter ``name``."""
    if _T.capture is not None:
        _T.capture.host.append((name, int(n)))
    elif _T.on or _autograd_profiler._is_profiler_enabled:
        _T.host.setdefault(name, []).append(int(n))


def count_device(name: str, t: torch.Tensor, negate: bool = False) -> None:
    """Add the device value ``t`` (a 0-d tensor the program computed
    anyway) to counter ``name``; with ``negate``, a flag's complement
    ``1 - t``. Holds a reference: no device op, no host read."""
    if _T.capture is not None:
        _T.capture.device.append((name, t, negate))
    elif (_T.on or _autograd_profiler._is_profiler_enabled) and not _capturing():
        _T.device.append((name, t, negate))


@contextlib.contextmanager
def captured_counts():
    """Around the capture of a graph: every :func:`count` and
    :func:`count_device` inside is kept in the yielded
    :class:`CapturedCounts`, whether or not recording is on, and counts
    nothing now."""
    outer, _T.capture = _T.capture, CapturedCounts([], [])
    try:
        yield _T.capture
    finally:
        _T.capture = outer


def recount(counts: CapturedCounts, device_values: torch.Tensor | None) -> None:
    """After a replay of the graph whose capture made ``counts``: count
    each of them again, the device ones from ``device_values``, the
    replay's values of their tensors in order (a copy, stacked)."""
    if not (_T.on or _autograd_profiler._is_profiler_enabled):
        return
    for name, n in counts.host:
        count(name, n)
    if counts.device:
        for (name, _, negate), v in zip(counts.device, device_values.unbind(0)):
            count_device(name, v, negate)


def enable(sync: bool = False) -> None:
    """Record from now on; with ``sync``, end every span with a device
    synchronise."""
    _T.on, _T.sync = True, bool(sync)


def disable() -> None:
    """Stop recording (what was recorded stays until :func:`reset`)."""
    _T.on, _T.sync = False, False


def reset() -> None:
    """Drop every recorded span, counter and frame id."""
    _T.spans, _T.open, _T.host, _T.device = [], [], {}, []
    _T.frame = None
    _T.absorbed = []


def absorb(snap: Snapshot, rank: int) -> None:
    """Keep another rank's snapshot (what it recorded, as :func:`snapshot`
    gave it there) until :func:`reset`: :func:`snapshot` adds its spans,
    tagged with ``rank``, and its counters."""
    _T.absorbed.append((rank, snap))


@contextlib.contextmanager
def recorded_as(mode: int | None, device: torch.device):
    """Around a rank's part of a batch, recording as rank 0 does: ``mode``
    0 not at all, 1 the tracer alone, 2 under a profiler session of this
    process (:func:`profile_spans`, whose trace is dropped); None leaves
    the tracer as it is. With a mode, what was recorded before is dropped
    on entry, and what was recorded inside on exit."""
    if not mode:
        yield
        return
    reset()
    try:
        if mode == 1:
            enable()
            yield
        else:
            with profile_spans(device):
                yield
    finally:
        disable()
        reset()


def mark() -> int:
    """A position in the span record, for :func:`totals_since`."""
    return len(_T.spans)


def totals_since(position: int) -> dict:
    """Seconds by name of the spans recorded after ``position`` that have
    ended."""
    out: dict = {}
    for name, _, t0, t1, _, _ in _T.spans[position:]:
        if t1:
            out[name] = out.get(name, 0.0) + (t1 - t0) * 1e-9
    return out


def snapshot() -> Snapshot:
    """Everything recorded since the last :func:`reset`, every device
    counter read in one transfer per device."""
    spans = [Span(n, k, t0, t1, p, f) for n, k, t0, t1, p, f in _T.spans if t1]
    # spans still open are left out; re-number the parents of those kept
    if len(spans) != len(_T.spans):
        keep = [i for i, s in enumerate(_T.spans) if s[3]]
        new = {old: j for j, old in enumerate(keep)}
        spans = [s._replace(parent=new.get(s.parent, -1)) for s in spans]
    series: dict = {k: list(v) for k, v in _T.host.items()}
    by_dev: dict = {}
    for k, (_, t, _) in enumerate(_T.device):
        by_dev.setdefault(t.device, []).append(k)
    vals = [0.0] * len(_T.device)
    for dev, ks in by_dev.items():
        read = torch.stack([_T.device[k][1].reshape(()).to(torch.float64)
                            for k in ks]).cpu().numpy()
        for k, v in zip(ks, read):
            vals[k] = float(v)
    for (name, _, negate), v in zip(_T.device, vals):
        v = 1.0 - v if negate else v
        series.setdefault(name, []).append(int(v) if float(v).is_integer() else v)
    for rank, other in _T.absorbed:
        base = len(spans)
        spans += [s._replace(rank=rank, parent=s.parent + base if s.parent >= 0 else -1)
                  for s in other.spans]
        for k, v in other.series.items():
            series.setdefault(k, []).extend(v)
    counters = {k: sum(v) for k, v in series.items()}
    return Snapshot(spans=spans, counters=counters, series=series)


def export_chrome(path: str, snap: Snapshot | None = None) -> Snapshot:
    """Write the recorded spans as a Chrome trace (``chrome://tracing``,
    Perfetto): one complete event per span, its kind as the category and
    its frame id and layer as arguments, on one process track per rank
    (the rank is the event's ``pid``).
    Returns the snapshot written."""
    snap = snapshot() if snap is None else snap
    t0 = min((s.start_ns for s in snap.spans), default=0)
    events = [{"name": s.name, "cat": s.kind, "ph": "X", "pid": s.rank, "tid": 0,
               "ts": (s.start_ns - t0) * 1e-3, "dur": (s.end_ns - s.start_ns) * 1e-3,
               "args": {"frame": s.frame, "layer": SPANS[s.name]}}
              for s in snap.spans]
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return snap


@contextlib.contextmanager
def profile_spans(device: torch.device):
    """A profiler session that records the device's activities and the
    program's spans, and no operator events (recording every operator
    doubles the host's time in a host-bound sequence). Yields an object
    whose ``kineto_results`` :func:`idle_by_span` reads once the session
    has ended."""
    from torch._C._autograd import (_disable_profiler, _enable_profiler,
                                    _prepare_profiler)
    from torch._C._profiler import (ProfilerActivity, ProfilerConfig,
                                    ProfilerState, RecordScope,
                                    _ExperimentalConfig)

    class Session:
        kineto_results = None

    acts = {ProfilerActivity.CPU}
    if device.type == "cuda":
        acts.add(ProfilerActivity.CUDA)
    cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                         _ExperimentalConfig())
    out = Session()
    _prepare_profiler(cfg, acts)
    _autograd_profiler._run_on_profiler_start()
    _enable_profiler(cfg, acts, {RecordScope.USER_SCOPE})
    try:
        yield out
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    finally:
        out.kineto_results = _disable_profiler()
        _autograd_profiler._run_on_profiler_stop()


def _union(iv: np.ndarray) -> np.ndarray:
    """Merged [start, end] rows of rows sorted by start."""
    if not len(iv):
        return iv.reshape(0, 2)
    reach = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > reach[:-1]
    first = np.nonzero(new)[0]
    return np.stack([iv[first, 0], np.maximum.reduceat(iv[:, 1], first)], 1)


def attribute_idle(device_iv, spans, window, n_longest: int = 10) -> dict:
    """Put each device-idle gap of ``window`` (start, end) down to the
    innermost span of ``spans`` ([(start, end, name)]) open at the gap's
    middle; ``device_iv`` holds the device activities as (start, end).
    Returns ``idle_s``, ``in_span_share`` (the share of idle time inside
    some span), ``by_span`` (idle seconds by span name, longest first;
    ``"(outside every span)"`` for the rest) and ``longest`` ([span,
    seconds] of the longest gaps)."""
    w0, w1 = int(window[0]), int(window[1])
    merged = _union(np.asarray(sorted(device_iv), np.int64).reshape(-1, 2))
    edges = np.concatenate([[w0], merged.reshape(-1), [w1]]).reshape(-1, 2)
    gap = np.maximum(edges[:, 1] - edges[:, 0], 0)
    mid = (edges[:, 0] + edges[:, 1]) // 2
    ss = np.asarray([s for s, _, _ in spans], np.int64)
    se = np.asarray([e for _, e, _ in spans], np.int64)
    outside = "(outside every span)"
    label = []
    for m in mid:
        inside = np.nonzero((ss <= m) & (se >= m))[0] if len(ss) else []
        label.append(spans[inside[np.argmax(ss[inside])]][2] if len(inside)
                     else outside)
    by: dict = {}
    for lb, g in zip(label, gap):
        if g > 0:
            by[lb] = by.get(lb, 0.0) + float(g) * 1e-9
    idle = float(gap.sum()) * 1e-9
    order = np.argsort(-gap)[:n_longest]
    return {"idle_s": idle,
            "in_span_share": (1.0 - by.get(outside, 0.0) / idle) if idle > 0 else None,
            "by_span": dict(sorted(by.items(), key=lambda kv: -kv[1])),
            "longest": [[label[i], float(gap[i]) * 1e-9] for i in order if gap[i] > 0]}


def idle_by_span(prof, n_longest: int = 10) -> dict:
    """:func:`attribute_idle` over a profile that holds the program's spans
    (:func:`profile_spans`, or a ``torch.profiler`` session that records
    the CPU): the device's activities from its trace, the window from its
    first event to its last, as the benchmark's trace summary takes it."""
    res = getattr(prof, "kineto_results", None)
    if res is None:
        res = prof.profiler.kineto_results
    cuda = torch.autograd.DeviceType.CUDA
    dev, spans, lo, hi = [], [], None, None
    for e in res.events():
        s = e.start_ns()
        t = s + e.duration_ns()
        user = e.is_user_annotation()
        on_dev = e.device_type() == cuda
        if user and on_dev:
            continue        # the profiler's device-side copy of a range
        lo = s if lo is None else min(lo, s)
        hi = t if hi is None else max(hi, t)
        if on_dev:
            dev.append((s, t))
        elif user and e.name() in SPANS:
            spans.append((s, t, e.name()))
    if lo is None:
        return {"idle_s": 0.0, "in_span_share": None, "by_span": {}, "longest": []}
    return attribute_idle(dev, spans, (lo, hi), n_longest)
