"""The tracker's step as a CUDA graph (``models/tracker.py``,
``utils/cuda_graph.py``): what the graph is keyed on, the eager path that
CPU inputs take, the tracer's counts of captures and replays, and the
benchmark's reader of them; on a card, that replays give what the eager
body gives, bit for bit.

The tests marked ``gpu`` skip without a card. On a machine with a card and
without JAX, run them with

    python -m pytest tests/test_torch_track_graph.py -m gpu --noconftest -q

This file imports no JAX."""

import dataclasses

import numpy as np
import pytest
import torch

from gfplslam_torch.config import KITTI_00_CAMERA, CameraParams, Config, load_config
from gfplslam_torch.io import synthetic
from gfplslam_torch.models import tracker, vo
from gfplslam_torch.models.frame import process_stereo_pair
from gfplslam_torch.utils import cuda_graph, trace
from gfplslam_torch.utils.timing import STAGE_SPANS
from slam_bench import program_trace, registry

CPU = torch.device("cpu")
CAM = dict(width=376, height=240, fx=217.6, fy=217.6, cx=183.7, cy=126.1,
           baseline=0.11)
SMALL = load_config({"cap": {"n_pt": 256, "n_ln": 128}, "orb": {"nlevels": 2}}
                    ).replace(camera=CameraParams(**CAM))
SMALL_PT = SMALL.replace(cap=dataclasses.replace(SMALL.cap, n_pt=128))


@pytest.fixture(autouse=True)
def clean_tracer():
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()


def _frames(cfg, n=3, seed=5):
    world = synthetic.make_world(n_frames=n, n_points=300, n_lines=40, seed=seed)
    out = []
    for i in range(n):
        l, r = synthetic.render_frame(world, i, noise=1.0)
        out.append(process_stereo_pair(torch.as_tensor(l), torch.as_tensor(r), cfg,
                                       torch.tensor(10.0)))
    return out


@pytest.fixture(scope="module")
def frames():
    return {"small": _frames(SMALL), "small_pt": _frames(SMALL_PT, n=2)}


def _equal(a, b):
    """Bit for bit, NaN where NaN."""
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def _args(cfg, f, state=None, delta_t=0.05, pair=(0, 1)):
    prev, curr = f[pair[0]], f[pair[1]]
    d_pt, d_ln = tracker.cross_hamming(prev, curr)
    state = tracker.initial_state(cfg, CPU) if state is None else state
    return (state, prev, curr, torch.tensor(delta_t), d_pt, d_ln)


# ---------------------------------------------------------------- CPU tests

@pytest.mark.parametrize("change", ["state values", "frame values", "delta_t value"])
def test_graph_key_holds_when_only_values_change(frames, change):
    f = frames["small"]
    base = tracker.graph_key(SMALL, *_args(SMALL, f))
    if change == "state values":
        st = tracker.initial_state(SMALL, CPU)
        st = st._replace(t_cam_w=st.t_cam_w * 2, fast_th=st.fast_th + 5)
        other = _args(SMALL, f, state=st)
    elif change == "frame values":
        other = _args(SMALL, f, pair=(1, 2))
    else:
        other = _args(SMALL, f, delta_t=0.1)
    assert tracker.graph_key(SMALL, *other) == base


@pytest.mark.parametrize("change", ["point capacity", "use_line_conf_cut",
                                    "max_vol_line_cut", "optimizer iterations",
                                    "camera"])
def test_graph_key_changes_with_shapes_and_settings(frames, change):
    base = tracker.graph_key(SMALL, *_args(SMALL, frames["small"]))
    cfg, f = SMALL, frames["small"]
    if change == "point capacity":
        cfg, f = SMALL_PT, frames["small_pt"]
    elif change == "use_line_conf_cut":
        cfg = SMALL.replace(stvo=dataclasses.replace(SMALL.stvo, use_line_conf_cut=False))
    elif change == "max_vol_line_cut":
        cfg = SMALL.replace(stvo=dataclasses.replace(SMALL.stvo, max_vol_line_cut=False))
    elif change == "optimizer iterations":
        cfg = SMALL.replace(optimizer=dataclasses.replace(SMALL.optimizer, max_iters=6))
    else:
        cfg = SMALL.replace(camera=dataclasses.replace(SMALL.camera, fx=218.0))
    assert tracker.graph_key(cfg, *_args(cfg, f)) != base


def test_cpu_inputs_take_the_eager_path_and_create_no_graph(frames, monkeypatch):
    def no_graph(*a, **k):
        raise AssertionError("a CPU input reached the graph path")
    monkeypatch.setattr(cuda_graph, "CapturedStep", no_graph)
    before = dict(tracker._GRAPHS)
    f = frames["small"]
    st = tracker.initial_state(SMALL, CPU)
    trace.enable()
    got = tracker.track_step(SMALL, st, f[0], f[1], torch.tensor(0.05))
    snap = trace.snapshot()
    assert tracker._GRAPHS == before
    assert "track.graph_captures" not in snap.counters
    assert "track.graph_replays" not in snap.counters
    names = {s.name for s in snap.spans}
    assert {"track.cross_points", "track.linecut", "track.pose_opt"} <= names
    assert not names & {"track.capture", "track.replay"}
    want = tracker.track_body(SMALL, st, *_args(SMALL, f)[1:])
    for g, w in zip(cuda_graph.leaves(got), cuda_graph.leaves(want)):
        _equal(g, w)


@pytest.mark.parametrize("name", ["track.capture", "track.replay"])
def test_new_spans_are_declared_in_the_tracker_layer(name):
    assert trace.SPANS[name] == trace.SPANS["vo.track"]


@pytest.mark.parametrize("name", ["track.graph_captures", "track.graph_replays"])
def test_new_counters_are_declared(name):
    assert trace.COUNTERS[name]


def test_replay_span_times_the_pose_stage():
    assert "track.replay" in STAGE_SPANS["time_pose_optim"]
    assert sum(n == "track.replay" for ns in STAGE_SPANS.values() for n in ns) == 1


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


def test_tree_helpers_rebuild_what_they_flatten(frames):
    args = _args(SMALL, frames["small"])
    flat = cuda_graph.leaves(args)
    assert len(flat) > 60 and all(isinstance(t, torch.Tensor) for t in flat)
    back = cuda_graph.rebuild(args, iter(flat))
    assert cuda_graph.signature(back) == cuda_graph.signature(args)
    assert type(back[1]) is type(args[1]) and type(back[1].points) is type(args[1].points)
    assert all(a is b for a, b in zip(cuda_graph.leaves(back), flat))


def test_copies_group_by_dtype_and_a_repeated_tensor_is_copied_once():
    a = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    b = torch.tensor([True, False])
    c = torch.arange(4, dtype=torch.int64)
    dst = [torch.empty_like(a), torch.empty_like(b), torch.empty_like(c)]
    cuda_graph.copy_all(dst, [a, b, c])
    assert all(torch.equal(d, s) for d, s in zip(dst, [a, b, c]))
    out = cuda_graph.clone_all([a, b, a, c])
    assert out[0] is out[2] and out[0] is not a
    assert all(torch.equal(o, s) for o, s in zip(out, [a, b, a, c]))
    a += 1
    assert torch.equal(out[0], torch.arange(6, dtype=torch.float32).reshape(2, 3))


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
    assert snap_g.counters["track.graph_replays"] >= len(euroc_world[0]) - 2
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
    tracker._GRAPHS.clear()
    trace.enable()
    for _ in range(2):
        vo.run_vo_scan(EUROC, *euroc_world, device=dev)
    c = trace.snapshot().counters
    n = len(euroc_world[0]) - 1
    assert c["track.graph_captures"] == 1
    assert c["track.graph_replays"] == 2 * n - 1
    for _ in range(2):
        engine = vo.VisualOdometry(KITTI, device=dev)
        for l, r, t in zip(*kitti_world):
            engine.process(l, r, float(t))
    c = trace.snapshot().counters
    assert c["track.graph_captures"] == 2
    assert c["track.graph_replays"] == 2 * n - 1 + 2 * (len(kitti_world[0]) - 1) - 1
    assert len(tracker._GRAPHS) == 2
    (k_euroc, k_kitti) = tracker._GRAPHS
    # both rigs run the default capacities: the same shapes, keyed apart
    # by the camera the body reads
    assert k_euroc[0] == k_kitti[0] == dev and k_euroc[1] == k_kitti[1]
    assert EUROC.camera in k_euroc and KITTI.camera in k_kitti


@pytest.mark.gpu
def test_min_eigenvalue_line_cut_runs_eagerly_on_the_card(dev, euroc_world):
    cfg = EUROC.replace(stvo=dataclasses.replace(EUROC.stvo, max_vol_line_cut=False))
    trace.enable()
    poses, aux = vo.run_vo_scan(cfg, *(x[:4] for x in euroc_world), device=dev)
    snap = trace.snapshot()
    assert "track.graph_captures" not in snap.counters
    assert len(snap.ms("track.linecut")) == 3 and bool(aux["accepted"].all())
