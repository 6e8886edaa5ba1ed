"""The one CUDA-graph policy (``utils/cuda_graph.py``) and the two callers
that hand it their steps: the tracker's step after its Hamming launch
(``"track"``, a single step) and the local BA's LM iteration (``"ba"``, a
chained loop). On the CPU the two step classes are emulated eagerly, so the
policy's control flow (eager, capture, replay; the key; the cases that stay
eager) runs without a graph; on a card, a step and a loop of a small
function through the real classes.

The tests marked ``gpu`` skip without a card. On a machine with a card and
without JAX, run them with

    python -m pytest tests/test_torch_cuda_graph.py -m gpu --noconftest -q

This file imports no JAX."""

import dataclasses

import numpy as np
import pytest
import torch

from gfplslam_torch.config import CameraParams, Config, load_config
from gfplslam_torch.io import synthetic
from gfplslam_torch.models import ba, tracker
from gfplslam_torch.models.frame import process_stereo_pair
from gfplslam_torch.utils import cuda_graph, trace
from gfplslam_torch.utils.timing import STAGE_SPANS

CPU = torch.device("cpu")
CAM = CameraParams(width=376, height=240, fx=217.6, fy=217.6, cx=183.7, cy=126.1,
                   baseline=0.11)
SMALL = load_config({"cap": {"n_pt": 256, "n_ln": 128}, "orb": {"nlevels": 2}}
                    ).replace(camera=CAM)
SMALL_PT = SMALL.replace(cap=dataclasses.replace(SMALL.cap, n_pt=128))
MIN_EIG = SMALL.replace(stvo=dataclasses.replace(SMALL.stvo, max_vol_line_cut=False))
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


def _trees_equal(got, want):
    g, w = cuda_graph.leaves(got), cuda_graph.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape
        _equal(a, b)


# ------------------------------------------------------------ the two callers

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


def _args(cfg, f, state=None, delta_t=0.05, pair=(0, 1)):
    """``track_body``'s arguments: the state, the two frames, ``delta_t``
    and the cross-frame Hamming matrices."""
    prev, curr = f[pair[0]], f[pair[1]]
    d_pt, d_ln = tracker.cross_hamming(prev, curr)
    state = tracker.initial_state(cfg, CPU) if state is None else state
    return (state, prev, curr, torch.tensor(delta_t), d_pt, d_ln)


def _track(cfg, f, **kw):
    """One ``track_step`` on ``_args``' inputs."""
    state, prev, curr, delta_t, _, _ = _args(cfg, f, **kw)
    return tracker.track_step(cfg, state, prev, curr, delta_t)


def _problem(seed: int = 0, n_kf: int = 4, n_pt: int = 48, n_ln: int = 12) -> ba.BAProblem:
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
        return torch.as_tensor(np.asarray(x, dtype))

    return ba.BAProblem(
        kf_pose=t(moved), kf_free=t(np.arange(n_kf) > 0), kf_valid=t(np.ones(n_kf, bool)),
        pt_pos=t(pts + rng.normal(0, 0.05, pts.shape), f32), pt_valid=t(np.ones(n_pt, bool)),
        ln_sp=t(sp + rng.normal(0, 0.05, sp.shape), f32),
        ln_ep=t(ep + rng.normal(0, 0.05, ep.shape), f32), ln_valid=t(np.ones(n_ln, bool)),
        po_kf=t(po_kf, np.int32), po_lm=t(po_lm, np.int32), po_uv=t(po_uv, f32),
        po_sigma2=t(np.ones(len(po_kf)), f32), po_valid=t(np.ones(len(po_kf), bool)),
        lo_kf=t(lo_kf, np.int32), lo_lm=t(lo_lm, np.int32), lo_le=t(np.concatenate(le), f32),
        lo_sigma2=t(np.ones(len(lo_kf)), f32), lo_valid=t(np.ones(len(lo_kf), bool)))


def _identity(x):
    """A ``psum`` other than the default, with the default's arithmetic."""
    return x


# ------------------------------------------------------ the step emulations

class _Captured:
    """``cuda_graph.CapturedStep`` run eagerly on the CPU: the control flow
    of capture and replay, without a graph."""
    made = 0

    def __init__(self, fn, args):
        type(self).made += 1
        self.fn = fn
        self.first = fn(*args)

    def __call__(self, args):
        return self.fn(*args)


class _Chained:
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
    """CPU tensors through the card's path, both step kinds emulated;
    returns the number of steps made so far."""
    monkeypatch.setattr(cuda_graph, "_on_card", lambda flat: True)
    monkeypatch.setattr(cuda_graph, "CapturedStep", _Captured)
    monkeypatch.setattr(cuda_graph, "ChainedStep", _Chained)
    _Captured.made = _Chained.made = 0
    return lambda: _Captured.made + _Chained.made


def _no_graph(*a, **k):
    raise AssertionError("a call reached the graph path")


# ----------------------------------------------------------- the eager cases

@pytest.mark.parametrize("kind", ["track", "ba", "ba sharded"])
def test_cpu_tensors_take_the_eager_path_and_create_no_graph(frames, monkeypatch, kind):
    monkeypatch.setattr(cuda_graph, "CapturedStep", _no_graph)
    monkeypatch.setattr(cuda_graph, "ChainedStep", _no_graph)
    trace.enable()
    if kind == "track":
        f = frames["small"]
        got = _track(SMALL, f)
        _trees_equal(got, tracker.track_body(SMALL, *_args(SMALL, f)))
    else:
        psum = ba._no_sum if kind == "ba" else _identity
        prob = _problem()
        for _ in range(3):
            res = ba.solve_ba(CAM, prob, lambda0=LAM0, max_iters=5, psum=psum)
        assert float(res.err) < float(ba.solve_ba(CAM, prob, max_iters=0).err)
    snap = trace.snapshot()
    assert not cuda_graph._GRAPHS and not cuda_graph._SEEN
    assert not {f"{n}.graph_{c}" for n in ("track", "ba")
                for c in ("captures", "replays")} & set(snap.counters)
    names = {s.name for s in snap.spans}
    assert not names & {"track.capture", "track.replay", "ba.capture"}
    if kind == "track":
        assert {"track.cross_points", "track.linecut", "track.pose_opt"} <= names
    else:
        assert len(snap.ms("ba.iter")) == 15


@pytest.mark.parametrize("kind,on_card,capturable,want", [
    ("track", True, True, True), ("track", True, False, False),
    ("track", False, True, False),
    ("ba", True, True, True), ("ba", True, False, False),
    ("ba", False, True, False), ("ba", False, False, False)])
def test_only_capturable_calls_on_a_card_replay(frames, emulated, monkeypatch, kind,
                                                on_card, capturable, want):
    """A card's inputs and a capturable body (for the tracker, not the
    min-eigenvalue line cut; for the BA, the default ``psum``), and
    nothing else, reach a graph."""
    monkeypatch.setattr(cuda_graph, "_on_card", lambda flat: on_card)
    for _ in range(3):
        if kind == "track":
            _track(SMALL if capturable else MIN_EIG, frames["small"])
        else:
            ba.solve_ba(CAM, _problem(), max_iters=2,
                        psum=ba._no_sum if capturable else _identity)
    assert (emulated() == 1) is want and bool(cuda_graph._GRAPHS) is want
    assert bool(cuda_graph._SEEN) is want


@pytest.mark.parametrize("kind", ["track", "ba"])
def test_a_body_that_cannot_be_captured_stays_eager(frames, emulated, kind):
    """The min-eigenvalue line cut (batched ``eigvalsh`` refuses capture)
    and the sharded solver's ``psum`` (collectives) run eagerly on the
    card's path, and leave no key."""
    trace.enable()
    for _ in range(3):
        if kind == "track":
            _track(MIN_EIG, frames["small"])
        else:
            ba.solve_ba(CAM, _problem(), max_iters=2, psum=_identity)
    assert emulated() == 0 and not cuda_graph._GRAPHS and not cuda_graph._SEEN
    assert not any(k.endswith(("captures", "replays")) for k in trace.snapshot().counters)


@pytest.mark.parametrize("kind", ["track", "ba"])
def test_the_sync_mode_stays_eager_and_times_every_stage(frames, emulated, kind):
    """While the tracer synchronises every span (``run_slam --timing``)
    nothing is seen, captured or replayed: the tracker's stage spans
    record, each under ``vo.track`` and under no replay."""
    trace.enable(sync=True)
    for i in range(3):
        if kind == "track":
            _track(SMALL, frames["small"], pair=(i % 2, 2))
        else:
            ba.solve_ba(CAM, _problem(i), max_iters=2)
    snap = trace.snapshot()
    assert emulated() == 0 and not cuda_graph._GRAPHS and not cuda_graph._SEEN
    assert not any(k.endswith(("captures", "replays")) for k in snap.counters)
    if kind == "track":
        for name in ("track.linecut", "track.cross_lines"):
            idx = [i for i, s in enumerate(snap.spans) if s.name == name]
            assert len(idx) == 3, name
            assert all(snap.ancestor(i, "vo.track") >= 0 for i in idx)
            assert all(snap.ancestor(i, "track.replay") < 0 for i in idx)
    else:
        assert len(snap.ms("ba.iter")) == 6


@pytest.mark.parametrize("suffix", [".replay", ".iter"])
def test_no_stage_span_is_a_replay_or_an_iteration(suffix):
    assert not [n for ns in STAGE_SPANS.values() for n in ns if n.endswith(suffix)]


# ------------------------------------------------- eager, capture, replay

def test_first_sight_eager_second_captures_then_replays_a_step(frames, emulated):
    f = frames["small"]
    st = tracker.initial_state(SMALL, CPU)
    st2 = st._replace(fast_th=st.fast_th + 3)
    inputs = [dict(), dict(pair=(1, 2)), dict(state=st2, pair=(0, 2)),
              dict(delta_t=0.1)]
    want = [tracker.track_body(SMALL, *_args(SMALL, f, **kw)) for kw in inputs]
    assert not cuda_graph._SEEN and emulated() == 0
    trace.enable()
    got, replays = [], []
    for kw in inputs:
        got.append(_track(SMALL, f, **kw))
        replays.append(trace.snapshot().counters.get("track.graph_replays", 0))
    snap = trace.snapshot()
    assert emulated() == 1 and len(cuda_graph._GRAPHS) == 1 and len(cuda_graph._SEEN) == 1
    assert snap.counters["track.graph_captures"] == 1
    assert replays == [0, 0, 1, 2]
    assert len(snap.ms("track.capture")) == 1 and len(snap.ms("track.replay")) == 2
    assert len(snap.ms("vo.track")) == 4
    for g, w in zip(got, want):
        _trees_equal(g, w)


def test_first_solve_eager_second_captures_then_replays(emulated):
    probs = [_problem(seed) for seed in (0, 1, 2, 3)]
    want = [ba.solve_ba(CAM, p, lambda0=LAM0, psum=_identity) for p in probs]
    assert not cuda_graph._SEEN and emulated() == 0
    trace.enable()
    got, replays = [], []
    for p in probs:
        got.append(ba.solve_ba(CAM, p, lambda0=LAM0))
        replays.append(trace.snapshot().counters.get("ba.graph_replays", 0))
    snap = trace.snapshot()
    assert emulated() == 1 and len(cuda_graph._GRAPHS) == 1 and len(cuda_graph._SEEN) == 1
    assert snap.counters["ba.graph_captures"] == 1
    assert replays == [0, 20, 40, 60]
    assert snap.counters["ba.iters_dispatched"] == 80
    assert len(snap.ms("ba.iter")) == 80 and len(snap.ms("ba.capture")) == 1
    for g, w in zip(got, want):
        _trees_equal(g, w)
    assert int(got[0].iters) > 1


# ------------------------------------------------------------------ the key

def _keys(monkeypatch, calls):
    """The key of each call of ``calls`` (each a function of no argument),
    read from the seen set, the card's path taken (emulated) even for a
    body that could not be captured."""
    monkeypatch.setattr(cuda_graph, "_on_card", lambda flat: True)
    monkeypatch.setattr(tracker, "_refuses_capture", lambda cfg: False)
    keys = []
    for call in calls:
        cuda_graph._SEEN.clear()
        call()
        (key,) = cuda_graph._SEEN
        keys.append(key)
    return keys


def _solve(cam=CAM, prob=None, **kw):
    return lambda: ba.solve_ba(cam, _problem() if prob is None else prob,
                               **{"max_iters": 1, **kw})


def _small_step(name="a", x=None, settings=(1,)):
    x = torch.arange(4, dtype=torch.float32) if x is None else x
    return lambda: cuda_graph.step(name, torch.neg, (x,), settings=settings)


@pytest.mark.parametrize("change", [
    "track: state values", "track: frame values", "track: delta_t value",
    "ba: values", "ba: lambda0", "ba: inlier_chi2", "ba: max_iters",
    "step: values"])
def test_graph_key_holds_when_only_values_change(frames, monkeypatch, change):
    f = frames["small"]
    if change.startswith("track"):
        base = lambda: _track(SMALL, f)  # noqa: E731
        st = tracker.initial_state(SMALL, CPU)
        st = st._replace(t_cam_w=st.t_cam_w * 2, fast_th=st.fast_th + 5)
        other = {"track: state values": lambda: _track(SMALL, f, state=st),
                 "track: frame values": lambda: _track(SMALL, f, pair=(1, 2)),
                 "track: delta_t value": lambda: _track(SMALL, f, delta_t=0.1)}[change]
    elif change.startswith("ba"):
        base = _solve()
        other = {"ba: values": _solve(prob=_problem(seed=7)),
                 "ba: lambda0": _solve(lambda0=1e-2),
                 "ba: inlier_chi2": _solve(inlier_chi2=5.0),
                 "ba: max_iters": _solve(max_iters=3)}[change]
    else:
        base, other = _small_step(), _small_step(x=torch.ones(4))
    a, b = _keys(monkeypatch, [base, other])
    assert a == b


@pytest.mark.parametrize("change", [
    "track: point capacity", "track: use_line_conf_cut", "track: max_vol_line_cut",
    "track: optimizer iterations", "track: camera",
    "ba: camera", "ba: lambda_k", "ba: tol", "ba: points", "ba: lines",
    "ba: point observations", "ba: keyframes",
    "step: name", "step: dtype", "step: shape", "step: settings"])
def test_graph_key_changes_with_shapes_settings_and_name(frames, monkeypatch, change):
    if change.startswith("track"):
        base = lambda: _track(SMALL, frames["small"])  # noqa: E731
        cfg, f = SMALL, frames["small"]
        what = change.split(": ")[1]
        if what == "point capacity":
            cfg, f = SMALL_PT, frames["small_pt"]
        elif what == "use_line_conf_cut":
            cfg = SMALL.replace(stvo=dataclasses.replace(SMALL.stvo, use_line_conf_cut=False))
        elif what == "max_vol_line_cut":
            cfg = MIN_EIG
        elif what == "optimizer iterations":
            cfg = SMALL.replace(optimizer=dataclasses.replace(SMALL.optimizer, max_iters=6))
        else:
            cfg = SMALL.replace(camera=dataclasses.replace(SMALL.camera, fx=218.0))
        other = lambda: _track(cfg, f)  # noqa: E731
    elif change.startswith("ba"):
        base = _solve()
        prob = _problem()
        keep = torch.arange(prob.po_kf.shape[0]) < 100
        fewer_obs = prob._replace(**{f: getattr(prob, f)[keep] for f in
                                     ("po_kf", "po_lm", "po_uv", "po_sigma2", "po_valid")})
        other = {"ba: camera": _solve(cam=dataclasses.replace(CAM, fx=218.0)),
                 "ba: lambda_k": _solve(lambda_k=5.0),
                 "ba: tol": _solve(tol=1e-6),
                 "ba: points": _solve(prob=_problem(n_pt=40)),
                 "ba: lines": _solve(prob=_problem(n_ln=10)),
                 "ba: point observations": _solve(prob=fewer_obs),
                 "ba: keyframes": _solve(prob=_problem(n_kf=5))}[change]
    else:
        base = _small_step()
        other = {"step: name": _small_step(name="b"),
                 "step: dtype": _small_step(x=torch.arange(4, dtype=torch.float64)),
                 "step: shape": _small_step(x=torch.arange(5, dtype=torch.float32)),
                 "step: settings": _small_step(settings=(2,))}[change]
    a, b = _keys(monkeypatch, [base, other])
    assert a != b


# ------------------------------------------------------------ declarations

@pytest.mark.parametrize("name,beside", [("track.capture", "vo.track"),
                                         ("track.replay", "vo.track"),
                                         ("ba.capture", "ba.iter")])
def test_new_spans_are_declared_in_their_layer(name, beside):
    assert trace.SPANS[name] == trace.SPANS[beside]


@pytest.mark.parametrize("name", ["track.graph_captures", "track.graph_replays",
                                  "ba.graph_captures", "ba.graph_replays"])
def test_new_counters_are_declared(name):
    assert trace.COUNTERS[name]


# ----------------------------------------------------------------- helpers

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


def _counted(x, y):
    """A step that counts on the host and on the device, and returns one
    of its results twice."""
    z = torch.tanh(x @ y)
    trace.count("pose_opt.iters_dispatched", 2)
    trace.count_device("pose_opt.iters_active", (z > 0).sum())
    return z, z.sum(), z


@pytest.mark.gpu
def test_a_step_on_the_card_is_eager_then_captured_then_replayed(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    inputs = [(torch.randn(8, 8, device=dev, generator=g),
               torch.randn(8, 3, device=dev, generator=g)) for _ in range(5)]
    want = [_counted(*a) for a in inputs]
    trace.enable()
    got = [cuda_graph.step("track", _counted, a, settings=()) for a in inputs]
    torch.cuda.synchronize(dev)
    snap = trace.snapshot()
    assert (snap.counters["track.graph_captures"], snap.counters["track.graph_replays"]) == (1, 3)
    assert snap.counters["pose_opt.iters_dispatched"] == 2 * 5
    assert snap.series["pose_opt.iters_active"] == [int((w[0] > 0).sum()) for w in want]
    owners: dict = {}
    for i, (out, w) in enumerate(zip(got, want)):
        _trees_equal(out, w)
        assert out[0] is out[2]
        for t in out[:2]:
            assert owners.setdefault(t.untyped_storage().data_ptr(), i) == i


def _chained(inv, carry):
    a, = inv
    x, n = carry
    return torch.tanh(a @ x), n + 1


@pytest.mark.gpu
def test_a_loop_on_the_card_is_eager_then_captured_then_replayed(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    inputs = [((torch.randn(6, 6, device=dev, generator=g),),
               (torch.randn(6, 2, device=dev, generator=g),
                torch.zeros((), dtype=torch.int32, device=dev))) for _ in range(4)]

    def eager(inv, carry):
        for _ in range(7):
            carry = _chained(inv, carry)
        return carry
    want = [eager(*a) for a in inputs]
    trace.enable()
    got = [cuda_graph.loop("ba", _chained, inv, carry, 7, settings=())
           for inv, carry in inputs]
    torch.cuda.synchronize(dev)
    snap = trace.snapshot()
    # the capture's own loop replays too
    assert (snap.counters["ba.graph_captures"], snap.counters["ba.graph_replays"]) == (1, 21)
    assert len(snap.ms("ba.iter")) == 28
    for out, w in zip(got, want):
        _trees_equal(out, w)
    trace.disable()
    trace.reset()
    trace.enable(sync=True)
    _trees_equal(cuda_graph.loop("ba", _chained, *inputs[0], 7, settings=()), want[0])
    assert "ba.graph_replays" not in trace.snapshot().counters
