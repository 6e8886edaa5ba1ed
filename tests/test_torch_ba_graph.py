"""The local BA's LM iteration as a CUDA graph (``models/ba.py``,
``utils/cuda_graph.py::ChainedStep``): what the graph is keyed on, the
eager paths that CPU tensors and the sharded solver take, when a key is
captured and replayed, the tracer's counts of both, and the benchmark's
reader of them; on a card, that replayed solves give what the eager solve
gives, bit for bit.

The tests marked ``gpu`` skip without a card. On a machine with a card and
without JAX, run them with

    python -m pytest tests/test_torch_ba_graph.py -m gpu --noconftest -q

This file imports no JAX."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from gfplslam_torch.config import CameraParams, Config
from gfplslam_torch.models import ba
from gfplslam_torch.utils import cuda_graph, trace
from slam_bench import program_trace, registry

CPU = torch.device("cpu")
CAM = CameraParams(width=376, height=240, fx=217.6, fy=217.6, cx=183.7, cy=126.1,
                   baseline=0.11)
WINDOW = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "full_capacity_kf13_window.npz")
LAM0 = Config().slam.lambda_lba_lm


@pytest.fixture(autouse=True)
def clean_state():
    """An empty tracer, and no graph or seen key left by another test."""
    saved = dict(ba._GRAPHS), set(ba._SEEN)
    ba._GRAPHS.clear()
    ba._SEEN.clear()
    trace.disable()
    trace.reset()
    yield
    trace.disable()
    trace.reset()
    ba._GRAPHS.clear()
    ba._GRAPHS.update(saved[0])
    ba._SEEN.clear()
    ba._SEEN.update(saved[1])


def _problem(seed: int = 0, n_kf: int = 4, n_pt: int = 48, n_ln: int = 12,
             device=CPU) -> ba.BAProblem:
    """A small window: keyframes along x looking down z, every landmark
    seen by every keyframe with pixel noise, the landmarks and the free
    keyframes' poses moved off their truth so the solve has work."""
    rng = np.random.default_rng(seed)
    pose = np.tile(np.eye(4, dtype=np.float32), (n_kf, 1, 1))
    pose[:, 0, 3] = 0.2 * np.arange(n_kf)

    def world(n):
        return np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                         rng.uniform(4, 8, n)], 1).astype(np.float32)

    def pixel(x, k):
        pc = x - pose[k, :3, 3]
        return np.stack([CAM.fx * pc[:, 0] / pc[:, 2] + CAM.cx,
                         CAM.fy * pc[:, 1] / pc[:, 2] + CAM.cy], 1)

    pts, sp, ep = world(n_pt), world(n_ln), world(n_ln)
    po_kf = np.repeat(np.arange(n_kf), n_pt)
    po_lm = np.tile(np.arange(n_pt), n_kf)
    po_uv = np.concatenate([pixel(pts, k) for k in range(n_kf)])
    po_uv = po_uv + rng.normal(0, 0.5, po_uv.shape)
    lo_kf = np.repeat(np.arange(n_kf), n_ln)
    lo_lm = np.tile(np.arange(n_ln), n_kf)
    le = []
    for k in range(n_kf):
        a = np.concatenate([pixel(sp, k), np.ones((n_ln, 1))], 1)
        b = np.concatenate([pixel(ep, k), np.ones((n_ln, 1))], 1)
        line = np.cross(a, b)
        le.append(line / np.linalg.norm(line[:, :2], axis=1, keepdims=True))
    moved = pose.copy()
    moved[1:, :3, 3] += rng.normal(0, 0.02, (n_kf - 1, 3))
    f32 = np.float32

    def t(x, dtype=None):
        return torch.as_tensor(np.asarray(x, dtype), device=device)

    return ba.BAProblem(
        kf_pose=t(moved), kf_free=t(np.arange(n_kf) > 0), kf_valid=t(np.ones(n_kf, bool)),
        pt_pos=t(pts + rng.normal(0, 0.05, pts.shape), f32), pt_valid=t(np.ones(n_pt, bool)),
        ln_sp=t(sp + rng.normal(0, 0.05, sp.shape), f32),
        ln_ep=t(ep + rng.normal(0, 0.05, ep.shape), f32), ln_valid=t(np.ones(n_ln, bool)),
        po_kf=t(po_kf, np.int32), po_lm=t(po_lm, np.int32), po_uv=t(po_uv, f32),
        po_sigma2=t(np.ones(len(po_kf)), f32), po_valid=t(np.ones(len(po_kf), bool)),
        lo_kf=t(lo_kf, np.int32), lo_lm=t(lo_lm, np.int32), lo_le=t(np.concatenate(le), f32),
        lo_sigma2=t(np.ones(len(lo_kf)), f32), lo_valid=t(np.ones(len(lo_kf), bool)))


def _equal(a, b):
    """Bit for bit, NaN where NaN."""
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def _assert_results_equal(got: ba.BAResult, want: ba.BAResult):
    for name, g, w in zip(ba.BAResult._fields, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        _equal(g, w)


def _identity(x):
    """A ``psum`` other than the default, with the default's arithmetic."""
    return x


class _Emulated:
    """``cuda_graph.ChainedStep`` run eagerly on the CPU: the control flow
    of capture, load, replay and result, without a graph."""
    made = 0

    def __init__(self, fn, invariants, carry):
        type(self).made += 1
        self.fn = fn

    def load(self, invariants, carry):
        self.invariants = invariants
        self.carry = carry

    def replay(self):
        self.carry = self.fn(self.invariants, self.carry)

    def result(self):
        flat = cuda_graph.leaves(self.carry)
        return cuda_graph.rebuild(self.carry, iter(cuda_graph.clone_all(flat)))


@pytest.fixture
def emulated(monkeypatch):
    """``solve_ba`` on CPU tensors through the card's path, emulated."""
    monkeypatch.setattr(ba, "_replayable", lambda device, psum: psum is ba._no_sum)
    monkeypatch.setattr(cuda_graph, "ChainedStep", _Emulated)
    _Emulated.made = 0
    return _Emulated


# ---------------------------------------------------------------- CPU tests

@pytest.mark.parametrize("device,psum,want", [
    ("cuda", ba._no_sum, True), ("cuda", _identity, False),
    ("cpu", ba._no_sum, False), ("cpu", _identity, False)])
def test_only_default_solves_on_a_card_replay(device, psum, want):
    assert ba._replayable(torch.device(device), psum) is want


@pytest.mark.parametrize("psum", [ba._no_sum, _identity])
def test_cpu_tensors_take_the_eager_path_and_count_no_graph(monkeypatch, psum):
    def no_graph(*a, **k):
        raise AssertionError("a CPU solve reached the graph path")
    monkeypatch.setattr(cuda_graph, "ChainedStep", no_graph)
    prob = _problem()
    trace.enable()
    for _ in range(3):
        res = ba.solve_ba(CAM, prob, lambda0=LAM0, max_iters=5, psum=psum)
    snap = trace.snapshot()
    assert not ba._GRAPHS and not ba._SEEN
    assert not {"ba.graph_captures", "ba.graph_replays"} & set(snap.counters)
    assert "ba.capture" not in {s.name for s in snap.spans}
    assert len(snap.ms("ba.iter")) == 15
    assert float(res.err) < float(ba.solve_ba(CAM, prob, max_iters=0).err)


def test_first_solve_eager_second_captures_then_replays(emulated):
    probs = [_problem(seed) for seed in (0, 1, 2, 3)]
    want = [ba.solve_ba(CAM, p, lambda0=LAM0, psum=_identity) for p in probs]
    assert not ba._SEEN and emulated.made == 0
    trace.enable()
    got, replays = [], []
    for p in probs:
        got.append(ba.solve_ba(CAM, p, lambda0=LAM0))
        replays.append(trace.snapshot().counters.get("ba.graph_replays", 0))
    snap = trace.snapshot()
    assert emulated.made == 1 and len(ba._GRAPHS) == 1 and len(ba._SEEN) == 1
    assert snap.counters["ba.graph_captures"] == 1
    assert replays == [0, 20, 40, 60]
    assert snap.counters["ba.iters_dispatched"] == 80
    assert len(snap.ms("ba.iter")) == 80 and len(snap.ms("ba.capture")) == 1
    for g, w in zip(got, want):
        _assert_results_equal(g, w)
    assert int(got[0].iters) > 1


def test_a_sharded_psum_stays_eager_on_the_graph_path(emulated):
    prob = _problem()
    for _ in range(3):
        ba.solve_ba(CAM, prob, max_iters=2, psum=_identity)
    assert emulated.made == 0 and not ba._GRAPHS and not ba._SEEN


def _keys(monkeypatch, solves):
    """The graph key of each solve in ``solves`` ((cam, prob, kwargs))."""
    keys = []
    key = ba.graph_key
    monkeypatch.setattr(ba, "_replayable", lambda device, psum: True)
    monkeypatch.setattr(ba, "graph_key", lambda *a: keys.append(key(*a)) or keys[-1])
    for cam, prob, kw in solves:
        ba._SEEN.clear()
        ba.solve_ba(cam, prob, **{"max_iters": 1, **kw})
    return keys


@pytest.mark.parametrize("change", ["camera", "lambda_k", "tol", "points", "lines",
                                    "point observations", "keyframes"])
def test_graph_key_changes_with_settings_and_shapes(monkeypatch, change):
    cam, prob, kw = CAM, _problem(), {}
    if change == "camera":
        cam = dataclasses.replace(CAM, fx=218.0)
    elif change == "lambda_k":
        kw = dict(lambda_k=5.0)
    elif change == "tol":
        kw = dict(tol=1e-6)
    elif change == "points":
        prob = _problem(n_pt=40)
    elif change == "lines":
        prob = _problem(n_ln=10)
    elif change == "point observations":
        prob = _problem()
        keep = torch.arange(prob.po_kf.shape[0]) < 100
        prob = prob._replace(**{f: getattr(prob, f)[keep] for f in
                                ("po_kf", "po_lm", "po_uv", "po_sigma2", "po_valid")})
    else:
        prob = _problem(n_kf=5)
    base, other = _keys(monkeypatch, [(CAM, _problem(), {}), (cam, prob, kw)])
    assert base != other


@pytest.mark.parametrize("change", ["values", "lambda0", "inlier_chi2", "max_iters"])
def test_graph_key_holds_when_only_values_change(monkeypatch, change):
    prob, kw = _problem(), {}
    if change == "values":
        prob = _problem(seed=7)
    elif change == "lambda0":
        kw = dict(lambda0=1e-2)
    elif change == "inlier_chi2":
        kw = dict(inlier_chi2=5.0)
    else:
        kw = dict(max_iters=3)
    base, other = _keys(monkeypatch, [(CAM, _problem(), {}), (CAM, prob, kw)])
    assert base == other


@pytest.mark.parametrize("name", ["ba.graph_captures", "ba.graph_replays"])
def test_new_counters_are_declared(name):
    assert trace.COUNTERS[name]


def test_capture_span_is_in_the_mapping_layer():
    assert trace.SPANS["ba.capture"] == trace.SPANS["ba.iter"]


def _snapshot(counters):
    return trace.Snapshot(spans=[trace.Span("ba.iter", "span", 0, 1000, -1, None)],
                          counters=counters, series={})


@pytest.mark.parametrize("replays,want", [(260, 100.0), (240, 240 / 2.6), (0, 0.0)])
def test_ba_graph_pct_reads_replays_over_dispatched_iterations(monkeypatch, replays, want):
    counters = {"ba.iters_dispatched": 260, "ba.iters_active": 225}
    if replays:
        counters["ba.graph_replays"] = replays
    monkeypatch.setattr(program_trace, "snapshot", lambda: _snapshot(counters))
    got = registry.module("metrics", "ba_graph_pct.slam").read(None)
    assert got == pytest.approx(want)


@pytest.mark.parametrize("case", ["no recording", "no local BA",
                                  "a program without the counter"])
def test_ba_graph_pct_reads_nothing_without_something_to_read(monkeypatch, case):
    reader = registry.module("metrics", "ba_graph_pct.slam")
    if case == "no recording":
        assert program_trace.snapshot() is None
    elif case == "no local BA":
        monkeypatch.setattr(program_trace, "snapshot",
                            lambda: _snapshot({"pose_opt.iters_dispatched": 60}))
    else:
        monkeypatch.setattr(program_trace, "snapshot", lambda: _snapshot(
            {"ba.iters_dispatched": 20, "ba.graph_replays": 20}))
        monkeypatch.setattr(trace, "COUNTERS", {k: v for k, v in trace.COUNTERS.items()
                                                if not k.startswith("ba.graph")})
    assert reader.read(None) is None


def test_ba_graph_pct_is_a_benchmark_metric():
    bench = json.loads(registry.BENCHMARK.read_text())
    entry = next(m for m in bench["per_layer"] if m["name"] == "ba_graph_pct.slam")
    assert (entry["moves"], entry["source"], entry["better"]) == (
        "slam_fps", "program_counter", "higher")
    assert entry["workloads"] == ["euroc-slam-loop", "kitti-live-frames",
                                  "euroc-batch4-slam-loop"]
    assert entry["layer"] == trace.SPANS["ba.iter"]


def test_chained_step_write_back_copies_an_aliased_result_first():
    """The carry copied back into the static buffers when the step returns
    static buffers themselves, swapped: each reads what the step saw."""
    step = cuda_graph.ChainedStep.__new__(cuda_graph.ChainedStep)
    step.carry = [torch.tensor([1.0]), torch.tensor([2.0])]
    step._write_back((step.carry[1], step.carry[0]))
    assert [float(t) for t in step.carry] == [2.0, 1.0]


# ------------------------------------------------------------- on the card

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA graph has no CPU mode)")
    return torch.device("cuda", 0)


def _windows(device):
    """The full-capacity loop world's keyframe-13 window and two more of
    its signature: its landmarks and free poses moved by seeded noise."""
    z = np.load(WINDOW)
    cam = CameraParams(**{f: type(getattr(CameraParams, f))(z[f"cam_{f}"])
                          for f in CameraParams.__dataclass_fields__})
    base = ba.BAProblem(*(torch.from_numpy(z[f]) for f in ba.BAProblem._fields))
    out = [base]
    for seed in (1, 2):
        g = torch.Generator().manual_seed(seed)
        pose = base.kf_pose.clone()
        pose[:, :3, 3] += torch.where(base.kf_free[:, None],
                                      0.01 * torch.randn(pose.shape[0], 3, generator=g), 0.0)
        out.append(base._replace(
            kf_pose=pose,
            pt_pos=base.pt_pos + 0.02 * torch.randn(base.pt_pos.shape, generator=g),
            ln_sp=base.ln_sp + 0.02 * torch.randn(base.ln_sp.shape, generator=g),
            ln_ep=base.ln_ep + 0.02 * torch.randn(base.ln_ep.shape, generator=g)))
    return cam, [ba.BAProblem(*(t.to(device) for t in p)) for p in out]


@pytest.mark.gpu
def test_replayed_solves_equal_the_eager_solve_bit_for_bit(dev):
    cam, probs = _windows(dev)
    want = [ba.solve_ba(cam, p, lambda0=LAM0, psum=_identity) for p in probs]
    assert not ba._SEEN and not ba._GRAPHS
    trace.enable()
    got, replays = [], []
    for p in probs:
        got.append(ba.solve_ba(cam, p, lambda0=LAM0))
        torch.cuda.synchronize(dev)
        replays.append(trace.snapshot().counters.get("ba.graph_replays", 0))
    snap = trace.snapshot()
    assert snap.counters["ba.graph_captures"] == 1 and len(ba._GRAPHS) == 1
    assert replays == [0, 20, 40]
    assert snap.series["ba.iters_active"] == [int(w.iters) for w in want]
    for i, (g, w) in enumerate(zip(got, want)):
        _assert_results_equal(g, w)
        assert float(g.err) < float(ba.solve_ba(cam, probs[i], max_iters=0,
                                                psum=_identity).err), i
    # the three problems differ, and so do their answers
    assert not torch.equal(got[1].pt_pos, got[2].pt_pos)
    assert not torch.equal(got[1].kf_pose, got[2].kf_pose)


@pytest.mark.gpu
def test_two_replayed_solves_share_no_storage(dev):
    cam, probs = _windows(dev)
    for p in probs[:2]:
        ba.solve_ba(cam, p, lambda0=LAM0)           # eager, then the capture
    a = ba.solve_ba(cam, probs[1], lambda0=LAM0)
    a_copy = [t.clone() for t in a]
    b = ba.solve_ba(cam, probs[2], lambda0=LAM0)
    owners: dict = {}
    for name, res in (("a", a), ("b", b)):
        for t in res:
            owner = owners.setdefault(t.untyped_storage().data_ptr(), name)
            assert owner == name, f"{name} shares an output with {owner}"
    for t, c in zip(a, a_copy):
        _equal(t, c)
    assert not torch.equal(a.pt_pos, b.pt_pos)


@pytest.mark.gpu
def test_sharded_psum_runs_eagerly_on_the_card(dev):
    cam, probs = _windows(dev)
    trace.enable()
    for _ in range(3):
        ba.solve_ba(cam, probs[0], lambda0=LAM0, max_iters=2, psum=_identity)
    assert not ba._GRAPHS and not ba._SEEN
    assert "ba.graph_replays" not in trace.snapshot().counters
