"""Loop verification's matching and pose solve as a CUDA graph
(``models/loop.py::verify_loop``, ``utils/cuda_graph.py``, whose policy
``tests/test_torch_cuda_graph.py`` tests): the snapshot rows gathered with
no host read, the spans and counters, and the benchmark's entry for the
replays (its reader is tested beside the tracker's, in
``tests/test_torch_track_graph.py``); on a card, that replayed verifications give what the eager body
gives, bit for bit, and a loop-world session what it gives with the step
forced eager.

The tests marked ``gpu`` skip without a card. On a machine with a card and
without JAX, run them with

    python -m pytest tests/test_torch_verify_graph.py -m gpu --noconftest -q

This file imports no JAX."""

import json

import numpy as np
import pytest
import torch

from gfplslam_torch.apps import bench
from gfplslam_torch.config import CapacityParams, Config
from gfplslam_torch.models import loop
from gfplslam_torch.models.slam import SLAMSystem
from gfplslam_torch.utils import cuda_graph, trace
from slam_bench import registry

CPU = torch.device("cpu")
SMALL = Config(cap=CapacityParams(n_kf_max=8, vocab_k=16))


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
    assert a.dtype == b.dtype and a.shape == b.shape
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)


def _random_snapshots(ls: loop.LoopState, seed: int) -> loop.LoopState:
    """``ls`` with every snapshot field drawn at random."""
    g = torch.Generator().manual_seed(seed)
    fields = {}
    for name in loop.Snapshot._fields:
        x = getattr(ls, name)
        if x.dtype == torch.bool:
            fields[name] = torch.rand(x.shape, generator=g) < 0.7
        elif x.dtype == torch.int32:
            fields[name] = torch.randint(-2 ** 31, 2 ** 31 - 1, x.shape,
                                         generator=g, dtype=torch.int32)
        else:
            fields[name] = torch.randn(x.shape, generator=g)
    return ls._replace(**fields)


# ---------------------------------------------------------------- CPU tests

@pytest.mark.parametrize("slot", ["first", "middle", "last"])
def test_snapshot_rows_equal_indexing_bit_for_bit(slot):
    ls = _random_snapshots(loop.empty_loop_state(SMALL, CPU), seed=3)
    k = {"first": 0, "middle": SMALL.cap.n_kf_max // 2,
         "last": SMALL.cap.n_kf_max - 1}[slot]
    row = loop.snapshot_row(ls, torch.tensor(k))
    for name in loop.Snapshot._fields:
        _equal(getattr(row, name), getattr(ls, name)[k])


def test_snapshot_rows_read_no_index_on_the_host():
    """On meta tensors, which hold no values, the gather runs; indexing by
    the 0-d tensor calls ``Tensor.item()`` and raises."""
    meta = torch.device("meta")
    ls = loop.empty_loop_state(SMALL, meta)
    k = torch.zeros((), dtype=torch.long, device=meta)
    row = loop.snapshot_row(ls, k)
    for name in loop.Snapshot._fields:
        x = getattr(ls, name)
        got = getattr(row, name)
        assert got.device == meta and got.shape == x.shape[1:] and got.dtype == x.dtype
    with pytest.raises(RuntimeError, match="item"):
        ls.pt_desc[k]


def test_verify_loop_on_the_cpu_runs_eagerly():
    ls = _random_snapshots(loop.empty_loop_state(SMALL, CPU), seed=4)
    trace.enable()
    for _ in range(3):
        ver = loop.verify_loop(SMALL, ls, torch.tensor(1), torch.tensor(5))
    assert not cuda_graph._SEEN and not cuda_graph._GRAPHS
    c = trace.snapshot().counters
    assert "verify.graph_replays" not in c and "verify.graph_captures" not in c
    # the pose solve's counts: 5 + 10 Gauss-Newton iterations a verification
    assert c["pose_opt.iters_dispatched"] == 3 * 15
    assert ver.accepted.dtype == torch.bool and ver.t_rel.shape == (4, 4)


def test_verify_spans_and_counters_are_declared():
    for name in ("verify.capture", "verify.replay"):
        assert trace.SPANS[name] == trace.SPANS["loop.verify"]
    for name in ("verify.graph_captures", "verify.graph_replays"):
        assert name in trace.COUNTERS


def test_verify_graph_pct_is_a_benchmark_metric():
    spec = json.loads(registry.BENCHMARK.read_text())
    entry = next(m for m in spec["per_layer"] if m["name"] == "verify_graph_pct.slam")
    assert entry["moves"] == "slam_fps" and entry["source"] == "program_counter"
    assert entry["workloads"] == ["euroc-slam-loop", "kitti-live-frames",
                                  "euroc-batch4-slam-loop"]
    assert entry["layer"] == trace.SPANS["loop.verify"]


# ------------------------------------------------------------- on the card

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA graph has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def loop_world():
    """The port's bench's small revisit world: 18 frames at 376x240 whose
    loop closes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA graph has no CPU mode)")
    return bench.world_arrays(bench.SMALL, names=("slam",))["slam"]


def _force_eager(monkeypatch):
    """``cuda_graph.step`` running the ``verify`` step eagerly, every other
    step as the policy decides."""
    step = cuda_graph.step

    def eager_verify(name, fn, args, **kw):
        return fn(*args) if name == "verify" else step(name, fn, args, **kw)
    monkeypatch.setattr(cuda_graph, "step", eager_verify)


def _session(world, dev, calls=None, monkeypatch=None):
    """One traced session over ``world``; with ``calls``, every
    verification's (loop state, prev, curr, result) appended to it."""
    if calls is not None:
        verify = loop.verify_loop

        def recorded(cfg, ls, kp, kc):
            out = verify(cfg, ls, kp, kc)
            calls.append((ls, kp, kc, out))
            return out
        monkeypatch.setattr(loop, "verify_loop", recorded)
    trace.reset()
    trace.enable()
    s = SLAMSystem(bench.SMALL.cfg, device=dev)
    s.run_sequence(world.left, world.right, world.ts, chunk=bench.SMALL.chunk)
    s.finish()
    snap = trace.snapshot()
    trace.disable()
    if calls is not None:
        monkeypatch.setattr(loop, "verify_loop", verify)
    return s, snap


def _pairs(calls):
    """A verification the session accepted and one it rejected, each as
    (loop state, prev, curr)."""
    accepted = [(ls, kp, kc) for ls, kp, kc, out in calls if bool(out.accepted)]
    rejected = [(ls, kp, kc) for ls, kp, kc, out in calls if not bool(out.accepted)]
    assert accepted and rejected
    return accepted[0], rejected[-1]


@pytest.mark.gpu
@pytest.mark.parametrize("pair", ["revisit", "unrelated"])
def test_replayed_verification_equals_the_eager_body(dev, loop_world, monkeypatch, pair):
    calls = []
    _session(loop_world, dev, calls, monkeypatch)
    revisit, unrelated = _pairs(calls)
    ls, kp, kc = revisit if pair == "revisit" else unrelated
    cfg = bench.SMALL.cfg
    cuda_graph._GRAPHS.clear()
    cuda_graph._SEEN.clear()
    trace.reset()
    trace.enable()
    # a key's first sight runs eagerly, its second captures, the third replays
    outs = [loop.verify_loop(cfg, ls, kp, kc) for _ in range(3)]
    c = trace.snapshot().counters
    assert c["verify.graph_captures"] == 1 and c["verify.graph_replays"] == 1
    with monkeypatch.context() as m:
        _force_eager(m)
        eager = loop.verify_loop(cfg, ls, kp, kc)
    assert bool(eager.accepted) == (pair == "revisit")
    for out in outs:
        for name, g, e in zip(loop.LoopVerification._fields, out, eager):
            _equal(g, e)


@pytest.mark.gpu
def test_no_two_replays_share_storage(dev, loop_world, monkeypatch):
    calls = []
    _session(loop_world, dev, calls, monkeypatch)
    pairs = _pairs(calls)
    cfg = bench.SMALL.cfg
    with monkeypatch.context() as m:
        _force_eager(m)
        want = [loop.verify_loop(cfg, *p) for p in pairs]
    trace.reset()
    trace.enable()
    # the session captured the step: both replay
    got = [loop.verify_loop(cfg, *p) for p in pairs]
    assert trace.snapshot().counters["verify.graph_replays"] == 2
    seen: dict = {}
    for i, out in enumerate(got):
        for t in cuda_graph.leaves(out):
            owner = seen.setdefault(t.untyped_storage().data_ptr(), i)
            assert owner == i, f"replay {i} shares an output with replay {owner}"
    # the first replay's results survive the second
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            _equal(a, b)


@pytest.mark.gpu
def test_loop_session_equals_the_session_with_verification_eager(dev, loop_world,
                                                                 monkeypatch):
    graph, snap_g = _session(loop_world, dev)
    n = len(snap_g.ms("loop.verify"))
    # the session's first verification runs eagerly, its second captures
    assert snap_g.counters["verify.graph_captures"] == 1
    assert snap_g.counters["verify.graph_replays"] == n - 2 > 0
    with monkeypatch.context() as m:
        _force_eager(m)
        eager, snap_e = _session(loop_world, dev)
    assert "verify.graph_replays" not in snap_e.counters
    assert len(snap_e.ms("loop.verify")) == n
    assert graph.n_loop_closures == eager.n_loop_closures >= 1
    assert graph.kf_frame_ids == eager.kf_frame_ids
    assert np.array_equal(graph.keyframe_trajectory, eager.keyframe_trajectory)
    assert np.array_equal(graph.all_frame_trajectory, eager.all_frame_trajectory)
    for name in ("pose_opt.iters_dispatched", "pose_opt.iters_active"):
        assert snap_g.series[name] == snap_e.series[name], name
