"""The local BA's LM iteration as a CUDA graph (``models/ba.py``,
``utils/cuda_graph.py``, whose policy ``tests/test_torch_cuda_graph.py``
tests): the benchmark's reader of the replays; on a card, that replayed
solves give what the eager solve gives, bit for bit, and that the sharded
solver stays eager.

The tests marked ``gpu`` skip without a card. On a machine with a card and
without JAX, run them with

    python -m pytest tests/test_torch_ba_graph.py -m gpu --noconftest -q

This file imports no JAX."""

import json
import os

import numpy as np
import pytest
import torch

from gfplslam_torch.config import CameraParams, Config
from gfplslam_torch.models import ba
from gfplslam_torch.utils import cuda_graph, trace
from slam_bench import program_trace, registry

WINDOW = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "full_capacity_kf13_window.npz")
LAM0 = Config().slam.lambda_lba_lm


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


def _assert_results_equal(got: ba.BAResult, want: ba.BAResult):
    for name, g, w in zip(ba.BAResult._fields, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        _equal(g, w)


def _identity(x):
    """A ``psum`` other than the default, with the default's arithmetic."""
    return x


# ---------------------------------------------------------------- CPU tests

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
    assert not cuda_graph._SEEN and not cuda_graph._GRAPHS
    trace.enable()
    got, replays = [], []
    for p in probs:
        got.append(ba.solve_ba(cam, p, lambda0=LAM0))
        torch.cuda.synchronize(dev)
        replays.append(trace.snapshot().counters.get("ba.graph_replays", 0))
    snap = trace.snapshot()
    assert snap.counters["ba.graph_captures"] == 1 and len(cuda_graph._GRAPHS) == 1
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
    assert not cuda_graph._GRAPHS and not cuda_graph._SEEN
    assert "ba.graph_replays" not in trace.snapshot().counters
