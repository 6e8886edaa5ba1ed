"""The tracker's step as a CUDA graph (``models/tracker.py``,
``utils/cuda_graph.py``, whose policy ``tests/test_torch_cuda_graph.py``
tests): the tracer's counts made inside a capture, and the benchmark's
reader of the replays; on a card, that replays give what the eager body
gives, bit for bit.

The tests marked ``gpu`` skip without a card. On a machine with a card and
without JAX, run them with

    python -m pytest tests/test_torch_track_graph.py -m gpu --noconftest -q

This file imports no JAX."""

import dataclasses

import numpy as np
import pytest
import torch

from gfplslam_torch.config import KITTI_00_CAMERA, CameraParams, Config
from gfplslam_torch.io import synthetic
from gfplslam_torch.models import tracker, vo
from gfplslam_torch.utils import cuda_graph, trace
from slam_bench import program_trace, registry


@pytest.fixture(autouse=True)
def clean_state():
    """An empty tracer, and no graph or seen key left by another test."""
    saved = dict(cuda_graph._GRAPHS), set(cuda_graph._SEEN)
    cuda_graph._GRAPHS.clear()
    cuda_graph._SEEN.clear()
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()
    cuda_graph._GRAPHS.clear()
    cuda_graph._GRAPHS.update(saved[0])
    cuda_graph._SEEN.clear()
    cuda_graph._SEEN.update(saved[1])


def _equal(a, b):
    """Bit for bit, NaN where NaN."""
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


# ---------------------------------------------------------------- CPU tests

@pytest.mark.parametrize("recording", [True, False])
def test_counts_made_during_a_capture_are_kept_and_made_again(recording):
    if recording:
        trace.enable()
    flag = torch.tensor(False)
    with trace.captured_counts() as counts:
        trace.count("pose_opt.iters_dispatched", 5)
        trace.count_device("pose_opt.iters_active", flag, negate=True)
    assert counts.host == [("pose_opt.iters_dispatched", 5)]
    assert [(n, t is flag, neg) for n, t, neg in counts.device] == [
        ("pose_opt.iters_active", True, True)]
    assert trace.snapshot().counters == {}
    trace.recount(counts, torch.tensor([True]))
    trace.recount(counts, torch.tensor([False]))
    want = ({"pose_opt.iters_dispatched": 10, "pose_opt.iters_active": 1}
            if recording else {})
    assert trace.snapshot().counters == want


def _span(name, t0, t1):
    return trace.Span(name, "span", int(t0 * 1e6), int(t1 * 1e6), -1, None)


@pytest.mark.parametrize("replays,want", [(4, 100.0), (3, 75.0), (0, 0.0)])
def test_track_graph_pct_reads_replays_over_tracked_frames(monkeypatch, replays, want):
    spans = [_span("vo.track", 10 * i, 10 * i + 5) for i in range(4)]
    counters = {"track.graph_replays": replays} if replays else {}
    counters["pose_opt.iters_dispatched"] = 60
    monkeypatch.setattr(program_trace, "snapshot", lambda: trace.Snapshot(
        spans=spans, counters=counters, series={}))
    got = registry.module("metrics", "track_graph_pct.vo").read(None)
    assert got == pytest.approx(want)


@pytest.mark.parametrize("case", ["no recording", "no tracked frame",
                                  "a program without the counter"])
def test_track_graph_pct_reads_nothing_without_something_to_read(monkeypatch, case):
    reader = registry.module("metrics", "track_graph_pct.vo")
    if case == "no recording":
        assert program_trace.snapshot() is None
    elif case == "no tracked frame":
        monkeypatch.setattr(program_trace, "snapshot", lambda: trace.Snapshot(
            spans=[_span("vo.frontend", 0, 1)], counters={}, series={}))
    else:
        monkeypatch.setattr(program_trace, "snapshot", lambda: trace.Snapshot(
            spans=[_span("vo.track", 0, 1)], counters={}, series={}))
        monkeypatch.setattr(trace, "COUNTERS", {k: v for k, v in trace.COUNTERS.items()
                                                if not k.startswith("track.graph")})
    assert reader.read(None) is None


def test_track_graph_pct_is_a_benchmark_metric():
    import json
    bench = json.loads(registry.BENCHMARK.read_text())
    entry = next(m for m in bench["per_layer"] if m["name"] == "track_graph_pct.vo")
    assert entry["moves"] == "vo_fps"
    assert entry["workloads"] == ["euroc-vo-replay", "kitti-vo-replay"]
    assert entry["layer"] == trace.SPANS["vo.track"]


# ------------------------------------------------------------- on the card

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA graph has no CPU mode)")
    return torch.device("cuda", 0)


def _eager_step(cfg, state, prev, curr, delta_t):
    """``track_step`` with the body run eagerly on the card."""
    with trace.timed("vo.track"):
        d_pt, d_ln = tracker.cross_hamming(prev, curr)
        return tracker.track_body(cfg, state, prev, curr, delta_t, d_pt, d_ln)


def _world(cam, n, seed):
    world = synthetic.make_world(n_frames=n, n_points=900, n_lines=90, seed=seed, cam=cam)
    pairs = [synthetic.render_frame(world, i, noise=1.5) for i in range(n)]
    return (np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs]),
            np.asarray(world.timestamps, np.float32))


@pytest.fixture(scope="module")
def euroc_world():
    return _world(CameraParams(), 16, 11)


@pytest.fixture(scope="module")
def kitti_world():
    return _world(KITTI_00_CAMERA, 10, 12)


EUROC = Config()
KITTI = Config(camera=KITTI_00_CAMERA)


def _scan(world, dev):
    trace.reset()
    trace.enable()
    poses, aux = vo.run_vo_scan(EUROC, *world, device=dev)
    snap = trace.snapshot()
    trace.disable()
    return poses, aux, snap


@pytest.mark.gpu
def test_vo_scan_replays_equal_the_eager_body_bit_for_bit(dev, euroc_world, monkeypatch):
    poses_g, aux_g, snap_g = _scan(euroc_world, dev)
    # of the tracked frames, the first runs eagerly and the second captures
    assert snap_g.counters["track.graph_replays"] == len(euroc_world[0]) - 3
    with monkeypatch.context() as m:
        m.setattr(tracker, "track_step", _eager_step)
        poses_e, aux_e, snap_e = _scan(euroc_world, dev)
    assert "track.graph_replays" not in snap_e.counters
    _equal(poses_g, poses_e)
    assert aux_g.keys() == aux_e.keys()
    for k in aux_g:
        _equal(aux_g[k], aux_e[k])
    assert bool(aux_g["accepted"].all())
    # the pose solver's counters count each replay as the eager step
    for name in ("pose_opt.iters_dispatched", "pose_opt.iters_active"):
        assert snap_g.series[name] == snap_e.series[name], name
    assert snap_g.counters["pose_opt.iters_active"] > 0


@pytest.mark.gpu
def test_no_two_frames_outputs_alias(dev, euroc_world, monkeypatch):
    outs = []
    step = tracker.track_step
    monkeypatch.setattr(tracker, "track_step",
                        lambda *a: outs.append(step(*a)) or outs[-1])
    vo.run_vo_scan(EUROC, *euroc_world, device=dev)
    eager = []
    monkeypatch.setattr(tracker, "track_step",
                        lambda *a: eager.append(_eager_step(*a)) or eager[-1])
    vo.run_vo_scan(EUROC, *euroc_world, device=dev)
    seen: dict = {}
    for i, out in enumerate(outs):
        for t in cuda_graph.leaves(out):
            owner = seen.setdefault(t.untyped_storage().data_ptr(), i)
            assert owner == i, f"frame {i} shares an output with frame {owner}"
    for i, (g, e) in enumerate(zip(outs, eager)):
        for a, b in zip(cuda_graph.leaves(g), cuda_graph.leaves(e)):
            _equal(a, b)


@pytest.mark.gpu
def test_live_frames_on_kitti_equal_the_eager_body(dev, kitti_world, monkeypatch):
    def run():
        engine = vo.VisualOdometry(KITTI, device=dev)
        for l, r, t in zip(*kitti_world):
            engine.process(l, r, float(t))
        return engine.records
    graph = run()
    monkeypatch.setattr(tracker, "track_step", _eager_step)
    eager = run()
    assert len(graph) == len(eager) == len(kitti_world[0])
    for i, (g, e) in enumerate(zip(graph, eager)):
        assert np.array_equal(g.t_cam_w, e.t_cam_w), i
        assert (g.is_kf, g.n_pt, g.n_ln, g.accepted, g.base_kf) == (
            e.is_kf, e.n_pt, e.n_ln, e.accepted, e.base_kf), i
    assert all(r.accepted for r in graph)


@pytest.mark.gpu
def test_fresh_engines_reuse_one_graph_per_key(dev, euroc_world, kitti_world):
    trace.enable()
    for _ in range(2):
        vo.run_vo_scan(EUROC, *euroc_world, device=dev)
    c = trace.snapshot().counters
    n = len(euroc_world[0]) - 1
    # a key's first step runs eagerly, its second captures, the rest replay
    assert c["track.graph_captures"] == 1
    assert c["track.graph_replays"] == 2 * n - 2
    for _ in range(2):
        engine = vo.VisualOdometry(KITTI, device=dev)
        for l, r, t in zip(*kitti_world):
            engine.process(l, r, float(t))
    c = trace.snapshot().counters
    assert c["track.graph_captures"] == 2
    assert c["track.graph_replays"] == 2 * n - 2 + 2 * (len(kitti_world[0]) - 1) - 2
    assert len(cuda_graph._GRAPHS) == 2
    (k_euroc, k_kitti) = cuda_graph._GRAPHS
    # both rigs run the default capacities: the same shapes, keyed apart
    # by the camera the body reads
    assert k_euroc[:2] == k_kitti[:2] == ("track", dev) and k_euroc[2] == k_kitti[2]
    assert EUROC.camera in k_euroc[3] and KITTI.camera in k_kitti[3]


@pytest.mark.gpu
def test_min_eigenvalue_line_cut_runs_eagerly_on_the_card(dev, euroc_world):
    cfg = EUROC.replace(stvo=dataclasses.replace(EUROC.stvo, max_vol_line_cut=False))
    trace.enable()
    poses, aux = vo.run_vo_scan(cfg, *(x[:4] for x in euroc_world), device=dev)
    snap = trace.snapshot()
    assert "track.graph_captures" not in snap.counters
    assert len(snap.ms("track.linecut")) == 3 and bool(aux["accepted"].all())
