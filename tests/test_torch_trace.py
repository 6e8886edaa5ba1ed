"""The program's tracer (``gfplslam_torch.utils.trace``): what it records and
when, its place in a profiler's trace, its counters against the solvers'
own counts, and that recording leaves every result bit-equal."""

import json
import re
import statistics
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from gfplslam_torch.apps import run_slam
from gfplslam_torch.config import CameraParams, load_config
from gfplslam_torch.io import synthetic
from gfplslam_torch.models import loop as loop_ops
from gfplslam_torch.models import pose_opt
from gfplslam_torch.models.slam import SLAMSystem
from gfplslam_torch.models.vo import run_vo_scan
from gfplslam_torch.utils import se3, trace

torch.set_num_threads(2)
CPU = torch.device("cpu")
PACKAGE = Path(trace.__file__).resolve().parents[1]
CAM = dict(width=376, height=240, fx=217.6, fy=217.6, cx=183.7, cy=126.1,
           baseline=0.11)
# the benchmark harness's small budgets: a keyframe every third frame, so
# six frames run two mapping steps and their local BAs
SMALL = load_config({
    "cap": {"n_pt": 256, "n_ln": 128, "n_kf_window": 4, "n_kf_max": 32,
            "n_map_pt": 2048, "n_map_ln": 512, "n_obs_pt": 1024,
            "n_obs_ln": 256, "vocab_k": 128},
    "orb": {"nlevels": 2}, "slam": {"max_kf_num_frames": 2, "max_iters_lba": 10},
}).replace(camera=CameraParams(**CAM))
N_FRAMES = 6


@pytest.fixture(scope="module")
def frames():
    world = synthetic.make_world(n_frames=N_FRAMES, n_points=300, n_lines=40, seed=4)
    return world, [synthetic.render_frame(world, i, noise=1.0) for i in range(N_FRAMES)]


@pytest.fixture(autouse=True)
def clean_tracer():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _slam(frames, mode: str):
    """Six frames through SLAMSystem.process and finish() with recording
    ``off``, ``on`` or in ``sync`` mode; returns (engine, snapshot)."""
    world, imgs = frames
    if mode != "off":
        trace.enable(sync=mode == "sync")
    try:
        s = SLAMSystem(SMALL, device=CPU)
        for i, (il, ir) in enumerate(imgs):
            s.process(il, ir, float(world.timestamps[i]))
        s.finish()
    finally:
        trace.disable()
    snap = trace.snapshot()
    trace.reset()
    return s, snap


def test_recording_off_stores_nothing(frames):
    world, imgs = frames
    assert not trace.recording()
    assert trace.span("vo.process") is trace.span("ba.iter")   # one shared null
    s = SLAMSystem(SMALL, device=CPU)
    for i, (il, ir) in enumerate(imgs[:2]):
        s.process(il, ir, float(world.timestamps[i]))
    trace.count("ba.iters_dispatched", 3)
    trace.count_device("ba.iters_active", torch.ones(()))
    snap = trace.snapshot()
    assert snap.spans == [] and snap.counters == {} and snap.series == {}
    # the two timed spans measure their duration all the same
    assert trace.last_s("vo.frontend") > 0 and trace.last_s("vo.track") > 0


def test_nesting_parents_and_frame_ids():
    trace.enable()
    trace.frame(7)
    with trace.span("slam.process"):
        with trace.span("vo.process"):
            with trace.wait("wait.vo_frame"):
                pass
        trace.frame(8)
        with trace.span("mapping.step"):
            with trace.timed("vo.track"):
                pass
    with pytest.raises(KeyError):
        trace.span("no.such_span")
    snap = trace.snapshot()
    got = [(s.name, s.kind, s.parent, s.frame) for s in snap.spans]
    assert got == [("slam.process", "span", -1, 7), ("vo.process", "span", 0, 7),
                   ("wait.vo_frame", "wait", 1, 7), ("mapping.step", "span", 0, 8),
                   ("vo.track", "span", 3, 8)]
    assert all(s.start_ns <= s.end_ns for s in snap.spans)
    outer, inner = snap.spans[0], snap.spans[1]
    assert outer.start_ns <= inner.start_ns and inner.end_ns <= outer.end_ns
    assert snap.ancestor(4, "slam.process") == 0 and snap.ancestor(2, "mapping.step") == -1


def test_recording_follows_the_profiler_flag():
    # the flag the tracer reads: a torch upgrade that renames or stops
    # setting it fails here rather than turning recording off unseen
    assert autograd_profiler._is_profiler_enabled is False
    assert not trace.recording()
    with profile(activities=[ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
        assert trace.recording()
        with trace.span("ba.solve"):
            trace.count("ba.iters_dispatched", 4)
    assert autograd_profiler._is_profiler_enabled is False
    assert not trace.recording()
    with trace.span("ba.solve"):
        pass
    snap = trace.snapshot()
    assert [s.name for s in snap.spans] == ["ba.solve"]
    assert snap.counters == {"ba.iters_dispatched": 4}
    with trace.profile_spans(CPU) as session:
        assert trace.recording()
        with trace.span("ba.iter"):
            torch.ones(3).sum()
    assert not trace.recording()
    names = [e.name() for e in session.kineto_results.events()]
    assert names == ["ba.iter"]         # the spans, and no operator


def test_every_span_is_a_profiler_annotation_of_the_same_length(frames):
    world, imgs = frames
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        s = SLAMSystem(SMALL, device=CPU)
        for i, (il, ir) in enumerate(imgs[:4]):
            s.process(il, ir, float(world.timestamps[i]))
        s.finish()
    snap = trace.snapshot()
    ann = sorted(((e.start_ns(), e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.is_user_annotation()),
                 key=lambda a: a[0])
    assert sorted(a[2] for a in ann) == sorted(s.name for s in snap.spans)
    names = {s.name for s in snap.spans}
    assert {"slam.process", "vo.process", "vo.frontend", "vo.track", "mapping.step",
            "ba.solve", "ba.iter", "wait.vo_frame", "wait.kf_pose"} <= names
    diffs = []
    for name in names:
        mine = [s.end_ns - s.start_ns for s in snap.spans if s.name == name]
        theirs = [d for _, d, n in ann if n == name]
        diffs += [abs(a - b) for a, b in zip(mine, theirs)]
    assert statistics.median(diffs) < 50_000


def test_every_span_name_in_the_source_is_declared_and_used():
    pattern = re.compile(r'trace\.(?:span|wait|timed|spanned)\(\s*"([^"]+)"')
    # a step handed to utils/cuda_graph.py under a name opens and counts
    # the names its policy derives from it
    graphed = re.compile(r'cuda_graph\.(step|loop)\(\s*"([^"]+)"')
    used, counted = set(), set()
    for path in PACKAGE.rglob("*.py"):
        text = path.read_text()
        used |= set(pattern.findall(text))
        counted |= set(re.findall(r'trace\.count(?:_device)?\(\s*"([^"]+)"', text))
        for kind, name in graphed.findall(text):
            each = "replay" if kind == "step" else "iter"
            used |= {f"{name}.capture", f"{name}.{each}"}
            counted |= {f"{name}.graph_captures", f"{name}.graph_replays"}
    assert used == set(trace.SPANS)
    assert counted == set(trace.COUNTERS)


def test_ba_and_pose_counters_against_the_solvers_own_counts(frames, monkeypatch):
    # a host read of each device value as it is counted, in the loop
    read_now: dict = {}
    keep = trace.count_device

    def counted(name, t, negate=False):
        v = float(t)
        read_now[name] = read_now.get(name, 0.0) + (1.0 - v if negate else v)
        keep(name, t, negate)
    monkeypatch.setattr(trace, "count_device", counted)
    from gfplslam_torch.models import ba as ba_ops
    results = []
    solve = ba_ops.solve_ba
    monkeypatch.setattr(ba_ops, "solve_ba",
                        lambda *a, **k: results.append(solve(*a, **k)) or results[-1])
    s, snap = _slam(frames, "on")
    c = snap.counters
    assert len(results) >= 2
    assert c["ba.iters_active"] == sum(int(r.iters) for r in results) == read_now["ba.iters_active"]
    assert c["ba.iters_dispatched"] == 10 * len(results)
    assert c["ba.iters_dispatched"] > c["ba.iters_active"] > 0
    opt = SMALL.optimizer
    n_solves = len(snap.ms("vo.track")) + len(snap.ms("loop.verify"))
    assert c["pose_opt.iters_dispatched"] == n_solves * (opt.max_iters + opt.max_iters_ref)
    assert c["pose_opt.iters_active"] == read_now["pose_opt.iters_active"]
    assert 0 < c["pose_opt.iters_active"] <= c["pose_opt.iters_dispatched"]
    assert len(snap.series["ba.obs_pt"]) == len(snap.series["ba.obs_ln"]) == len(results)
    assert min(snap.series["ba.obs_pt"]) > 0


def test_pose_graph_counters_against_a_host_count(monkeypatch):
    steps = []
    keep = loop_ops._edge_terms
    monkeypatch.setattr(loop_ops, "_edge_terms", lambda *a: (steps.append(1), keep(*a))[1])
    rng = np.random.default_rng(3)
    k = 5
    truth = np.stack([se3.expmap_se3(torch.tensor(
        [0.3 * i, 0.0, 0.1 * i, 0.0, 0.05 * i, 0.0], dtype=torch.float32)).numpy()
        for i in range(k)])
    noisy = torch.as_tensor(np.stack([
        truth[i] @ se3.expmap_se3(torch.tensor(rng.normal(0, 0.02, 6),
                                               dtype=torch.float32)).numpy()
        for i in range(k)]))
    i_idx = torch.tensor([0, 1, 2, 3, 0])
    j_idx = torch.tensor([1, 2, 3, 4, 4])
    t_ij = torch.as_tensor(np.stack([np.linalg.inv(truth[a]) @ truth[b]
                                     for a, b in zip(i_idx.tolist(), j_idx.tolist())]))
    edges = loop_ops.PoseGraphEdges(i=i_idx, j=j_idx, t_ij=t_ij.float(),
                                    valid=torch.ones(5, dtype=torch.bool))
    fixed = torch.zeros(k, dtype=torch.bool)
    fixed[0] = True
    trace.enable()
    loop_ops.optimize_pose_graph(noisy.float(), torch.ones(k, dtype=torch.bool), edges,
                                 fixed, iters=30)
    c = trace.snapshot().counters
    # the solve stops at convergence: every step it queued began unconverged
    assert c["pgo.steps_dispatched"] == c["pgo.steps_active"] == len(steps)
    assert 0 < len(steps) < 30


def test_results_bit_equal_off_on_and_in_sync_mode(frames):
    runs = {mode: _slam(frames, mode) for mode in ("off", "on", "sync")}
    base = runs["off"][0]
    assert runs["off"][1].spans == []
    for mode in ("on", "sync"):
        s, snap = runs[mode]
        np.testing.assert_array_equal(s.all_frame_trajectory, base.all_frame_trajectory)
        np.testing.assert_array_equal(s.keyframe_trajectory, base.keyframe_trajectory)
        assert s.kf_frame_ids == base.kf_frame_ids
        assert len(snap.ms("slam.process")) == N_FRAMES
        assert len(snap.ms("mapping.step")) >= 2
    # the sync mode fills every stage field from the stage spans
    rows = runs["sync"][0].vo.timelog.rows[1:]
    assert all(r.time_ln_detect > 0 and r.time_pt_cross > 0 for r in rows)
    assert all(r.time_ln_detect == 0 for r in base.vo.timelog.rows)

    world, imgs = frames
    il = np.stack([a for a, _ in imgs[:3]])
    ir = np.stack([b for _, b in imgs[:3]])
    scans = []
    for mode in ("off", "on", "sync"):
        if mode != "off":
            trace.enable(sync=mode == "sync")
        try:
            poses, aux = run_vo_scan(SMALL, il, ir, world.timestamps[:3], device=CPU)
        finally:
            trace.disable()
        scans.append((poses.numpy(), aux["is_kf"].numpy(), trace.snapshot()))
        trace.reset()
    for poses, is_kf, snap in scans[1:]:
        np.testing.assert_array_equal(poses, scans[0][0])
        np.testing.assert_array_equal(is_kf, scans[0][1])
        assert [s.frame for s in snap.spans if s.name == "vo.scan_step"] == [1, 2]


def test_idle_by_span_puts_each_gap_on_the_innermost_span():
    # device busy 10-20 and 40-50 in a window 0-100; spans: slam.process
    # 0-100 holding vo.frontend 5-35 and a wait 55-90
    spans = [(0, 100, "slam.process"), (5, 35, "vo.frontend"), (55, 90, "wait.vo_frame")]
    got = trace.attribute_idle([(40, 50), (10, 20)], spans, (0, 100))
    # gaps: 0-10 (mid 5: vo.frontend), 20-40 (30: vo.frontend), 50-100 (75: wait)
    assert got["idle_s"] == pytest.approx(80e-9)
    assert got["by_span"] == {"wait.vo_frame": pytest.approx(50e-9),
                              "vo.frontend": pytest.approx(30e-9)}
    assert got["in_span_share"] == pytest.approx(1.0)
    assert got["longest"][0] == ["wait.vo_frame", pytest.approx(50e-9)]
    bare = trace.attribute_idle([(10, 20)], [], (0, 100))
    assert bare["in_span_share"] == pytest.approx(0.0)
    assert list(bare["by_span"]) == ["(outside every span)"]


def test_pose_solver_counts_one_solve():
    """One pose solve's dispatched iterations: its two Gauss-Newton stages."""
    opt = SMALL.optimizer
    pts = pose_opt.PointMatches(p3d=torch.randn(40, 3) + torch.tensor([0, 0, 5.0]),
                                obs=torch.rand(40, 2) * 200,
                                sigma2=torch.ones(40), valid=torch.ones(40, dtype=torch.bool))
    lns = pose_opt.LineMatches(sp3d=torch.zeros(4, 3), ep3d=torch.ones(4, 3),
                               le_obs=torch.ones(4, 3), sigma2=torch.ones(4),
                               valid=torch.zeros(4, dtype=torch.bool))
    trace.enable()
    pose_opt.optimize_pose(SMALL.camera, torch.eye(4), pts, lns, opt)
    c = trace.snapshot().counters
    assert c["pose_opt.iters_dispatched"] == opt.max_iters + opt.max_iters_ref
    assert 2 <= c["pose_opt.iters_active"] <= c["pose_opt.iters_dispatched"]


def test_run_slam_writes_the_trace_and_the_counters(tmp_path):
    out = tmp_path / "syn.trace.json"
    got = run_slam.main(["--synthetic", "--small", "--frames", "3", "--device", "cpu",
                         "-o", str(tmp_path / "syn"), "--trace-out", str(out), "--profile"])
    assert got["frames"] == 3 and not trace.recording()
    events = json.loads(out.read_text())["traceEvents"]
    names = {e["name"] for e in events}
    assert {"slam.process", "vo.frontend", "vo.track", "wait.vo_frame"} <= names
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events)
    counters = json.loads((tmp_path / "syn.trace.counters.json").read_text())
    c = counters["counters"]
    assert c["pose_opt.iters_dispatched"] >= c["pose_opt.iters_active"] > 0
    assert set(counters["idle_iters_pct"]) >= {"pose_opt"}
    assert counters["idle_by_span"]["in_span_share"] is not None
