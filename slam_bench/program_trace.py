"""What the program's own tracer (``gfplslam_torch.utils.trace``) recorded
in a traced run: its spans and counters, read through ``snapshot()``.

The tracer records while a ``torch.profiler`` session is on, so after the
window it holds exactly the traced sequence's spans and counters (one
process runs one cell). A program that has no tracer, or a run in which it
recorded nothing, gives ``None`` to every reader here.
"""

from __future__ import annotations

import statistics


def snapshot():
    """The tracer's snapshot, or None without a tracer or a recording."""
    try:
        from gfplslam_torch.utils import trace
    except ImportError:
        return None
    snap = trace.snapshot()
    return snap if snap.spans or snap.counters else None


def median_ms(name: str, inside: str | None = None):
    """Median ms of the spans named ``name`` (only those within a span
    named ``inside``, when given); None without one."""
    snap = snapshot()
    if snap is None:
        return None
    ms = [s.ms for s in snap.spans if s.name == name
          and (inside is None or snap.ancestor(s.parent, inside) >= 0)]
    return statistics.median(ms) if ms else None


def idle_iters_pct(solver: str, unit: str = "iters"):
    """Share, in %, of a solver's dispatched iterations that began
    converged: 100 * (dispatched - active) / dispatched."""
    snap = snapshot()
    if snap is None:
        return None
    sent = snap.counters.get(f"{solver}.{unit}_dispatched", 0)
    if not sent:
        return None
    return 100.0 * (sent - snap.counters.get(f"{solver}.{unit}_active", 0)) / sent


def keyframe_wait_ms():
    """Median over keyframe frames (a ``slam.process`` span that holds a
    ``mapping.step``) of the ms of the ``wait`` spans inside the frame's
    ``slam.process``."""
    snap = snapshot()
    if snap is None:
        return None
    waits: dict = {}
    keyframes = set()
    for i, s in enumerate(snap.spans):
        frame = snap.ancestor(i, "slam.process")
        if frame < 0:
            continue
        waits.setdefault(frame, 0.0)
        if s.kind == "wait":
            waits[frame] += s.ms
        elif s.name == "mapping.step":
            keyframes.add(frame)
    ms = [waits[f] for f in keyframes]
    return statistics.median(ms) if ms else None
