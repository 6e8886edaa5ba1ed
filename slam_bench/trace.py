"""The device trace of one sequence: ``torch.profiler`` (CUPTI) over the
sequence, reduced to what the per-layer metrics and the result's
``breakdown`` read.

The profiler records the device's activities and the host's CUDA runtime
calls only (no operator events: recording every operator would double the
host's time in a host-bound sequence and the events to read). The busy
time is the union of the intervals of every device activity (kernels,
copies, fills), the method of the port's
``profile_torch_vo.py::device_summary``, copied; the span runs from the
first event of the trace, host or device, to the last, so the idle share
counts the host's time before the first kernel and after the last. An
idle gap is named by the runtime call the host was in at its middle.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class TraceSummary:
    window_s: float                 # the traced sequence's span
    busy_s: float                   # union of device activity inside it
    n_ops: int                      # device activities inside it
    by_name: dict                   # device op name -> (seconds, count)
    gaps: list = field(default_factory=list)   # [(host op, seconds)], longest first

    def kernel_s(self, part: str) -> tuple[float, int]:
        """Device seconds and launches of every op whose name holds ``part``."""
        hits = [v for k, v in self.by_name.items() if part in k]
        return sum(s for s, _ in hits), sum(c for _, c in hits)

    def breakdown(self, n: int = 10) -> dict:
        top = sorted(self.by_name.items(), key=lambda kv: -kv[1][0])[:n]
        return {"device_ops": [[k, v[0]] for k, v in top],
                "idle_gaps": [[k, s] for k, s in self.gaps[:n]]}


def idle_pct(run):
    """Share of the traced sequence's span with no device activity, in %;
    None without a trace or without device activity."""
    t = run.trace
    return None if t is None or t.busy_s <= 0 else 100.0 * (1.0 - t.busy_s / t.window_s)


def _name(e) -> str:
    return e.name() if callable(e.name) else e.name


def _events(prof):
    """The trace's device activities as sorted (start_ns, end_ns, name)
    rows, and its host events as (start_ns, end_ns, event) rows (a host
    event's name is read only where a gap needs it)."""
    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    try:
        for e in prof.profiler.kineto_results.events():
            if e.is_user_annotation():
                continue
            s = e.start_ns()
            if e.device_type() == cuda:
                dev.append((s, s + e.duration_ns(), e.name()))
            else:
                host.append((s, s + e.duration_ns(), e))
    except AttributeError:  # an older profiler: the slower event list
        for e in prof.events():
            s, t = int(e.time_range.start * 1e3), int(e.time_range.end * 1e3)
            (dev.append((s, t, e.name)) if e.device_type == cuda
             else host.append((s, t, e)))
    dev.sort(key=lambda r: r[0])
    return dev, host


def _union(iv: np.ndarray) -> np.ndarray:
    """Merged [start, end] rows of rows sorted by start."""
    if not len(iv):
        return iv.reshape(0, 2)
    reach = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > reach[:-1]
    first = np.nonzero(new)[0]
    return np.stack([iv[first, 0], np.maximum.reduceat(iv[:, 1], first)], 1)


def summarize(prof, n_gaps: int = 10) -> TraceSummary:
    """The summary of the whole trace."""
    dev, host = _events(prof)
    allv = np.asarray([(s, t) for s, t, _ in dev] + [(s, t) for s, t, _ in host],
                      np.int64).reshape(-1, 2)
    w0, w1 = int(allv[:, 0].min()), int(allv[:, 1].max())
    by_name: dict = {}
    for s, e, name in dev:
        sec, cnt = by_name.get(name, (0.0, 0))
        by_name[name] = (sec + (e - s) * 1e-9, cnt + 1)
    merged = _union(np.asarray([(s, e) for s, e, _ in dev], np.int64).reshape(-1, 2))
    busy_ns = int((merged[:, 1] - merged[:, 0]).sum())
    # idle gaps: before the first activity, between activities, after the last
    edges = np.concatenate([[w0], merged.reshape(-1), [w1]]).reshape(-1, 2)
    gap_len = edges[:, 1] - edges[:, 0]
    hs = np.asarray([h[0] for h in host], np.int64)
    he = np.asarray([h[1] for h in host], np.int64)
    gaps = []
    for i in np.argsort(-gap_len)[:n_gaps]:
        if gap_len[i] <= 0:
            continue
        mid = (edges[i, 0] + edges[i, 1]) // 2
        inside = np.nonzero((hs <= mid) & (he >= mid))[0] if len(hs) else []
        # the innermost host event running at the gap's middle
        label = (_name(host[inside[np.argmax(hs[inside])]][2]) if len(inside)
                 else "(host outside the CUDA runtime)")
        gaps.append((label, float(gap_len[i]) * 1e-9))
    return TraceSummary(window_s=(w1 - w0) * 1e-9, busy_s=busy_ns * 1e-9,
                        n_ops=len(dev), by_name=by_name, gaps=gaps)


def profiled(fn, device: torch.device):
    """Run ``fn()`` under the profiler, then wait for the device; returns
    (its result, the profiler). On a CPU (the tests) it records the host's
    operators, there being no device."""
    import warnings

    from torch.profiler import ProfilerActivity, profile
    act = ProfilerActivity.CUDA if device.type == "cuda" else ProfilerActivity.CPU
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*Profiler clears events.*")
        with profile(activities=[act]) as prof:
            out = fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    return out, prof
