"""The per-layer metrics read from the program's own tracer: each reader on a
hand-made snapshot, none without one, and a traced CPU window that prints
every one of them in its cells."""

import pytest
import torch

from slam_bench import program_trace, registry
from slam_bench.run import run_cell
from slam_bench.tests.conftest import SMALL_LOOP, small_cell

trace = pytest.importorskip("gfplslam_torch.utils.trace")
SEED = 2 ** 31 + 41
NEW = {"euroc-vo-replay": ["frontend_ms.vo", "track_ms.vo", "pose_opt_idle_iters.vo"],
       "euroc-slam-loop": ["ba_iter_ms.slam", "ba_idle_iters.slam"],
       "kitti-live-frames": ["ba_iter_ms.slam", "ba_idle_iters.slam",
                             "kf_mapping_ms.live", "kf_wait_ms.live"]}


def _span(name, t0, t1, parent, kind="span"):
    return trace.Span(name, kind, int(t0 * 1e6), int(t1 * 1e6), parent, None)


def _snapshot():
    """Two frames on the per-frame path, times in ms: frame 0 a keyframe
    (mapping 30 ms, two BA iterations of 4 and 6 ms, waits of 2 and 5 ms),
    frame 1 not (a wait of 9 ms); a scan step with its front-end and
    tracker; and the solvers' counters."""
    s = [_span("slam.process", 0, 100, -1),                  # 0
         _span("vo.process", 0, 40, 0),                      # 1
         _span("vo.frontend", 0, 20, 1),                     # 2
         _span("vo.track", 20, 30, 1),                       # 3
         _span("wait.vo_frame", 30, 32, 1, "wait"),          # 4
         _span("slam.harvest", 40, 50, 0),                   # 5
         _span("wait.kf_pose", 45, 50, 5, "wait"),           # 6
         _span("mapping.step", 50, 80, 0),                   # 7
         _span("ba.solve", 55, 70, 7),                       # 8
         _span("ba.iter", 55, 59, 8),                        # 9
         _span("ba.iter", 59, 65, 8),                        # 10
         _span("slam.process", 100, 150, -1),                # 11
         _span("vo.process", 100, 140, 11),                  # 12
         _span("wait.vo_frame", 130, 139, 12, "wait"),       # 13
         _span("vo.scan_step", 200, 260, -1),                # 14
         _span("vo.frontend", 200, 230, 14),                 # 15
         _span("vo.track", 230, 250, 14),                    # 16
         _span("mapping.step", 300, 310, -1)]                # 17: chunk path
    c = {"pose_opt.iters_dispatched": 30, "pose_opt.iters_active": 12,
         "ba.iters_dispatched": 40, "ba.iters_active": 30}
    return trace.Snapshot(spans=s, counters=c, series={k: [v] for k, v in c.items()})


def test_each_reader_on_a_hand_made_snapshot(monkeypatch):
    monkeypatch.setattr(program_trace, "snapshot", _snapshot)
    want = {"frontend_ms.vo": 25.0, "track_ms.vo": 15.0,
            "pose_opt_idle_iters.vo": 60.0, "ba_iter_ms.slam": 5.0,
            "ba_idle_iters.slam": 25.0, "kf_mapping_ms.live": 30.0,
            "kf_wait_ms.live": 7.0}
    for name, value in want.items():
        got = registry.module("metrics", name).read(None)
        assert got == pytest.approx(value), name
    monkeypatch.setattr(program_trace, "snapshot", lambda: None)
    for name in want:
        assert registry.module("metrics", name).read(None) is None, name


def test_nothing_recorded_reads_nothing():
    trace.disable()
    trace.reset()
    assert program_trace.snapshot() is None
    assert registry.module("metrics", "ba_idle_iters.slam").read(None) is None


@pytest.mark.parametrize("workload,n,slam", [
    ("euroc-vo-replay", 6, None), ("euroc-slam-loop", 9, SMALL_LOOP),
    ("kitti-live-frames", 7, None)])
def test_a_traced_window_prints_every_new_metric(workload, n, slam):
    cell = small_cell(workload, n, slam=slam)
    assert {m["name"] for m in cell.per_layer} >= set(NEW[workload])
    trace.reset()
    try:
        _, _, result = run_cell(cell, SEED, 0.0, True, torch.device("cpu"))
    finally:
        trace.reset()
    for name in NEW[workload]:
        assert name in result["metrics"], (name, sorted(result["metrics"]))
        assert result["metrics"][name]["value"] >= 0
