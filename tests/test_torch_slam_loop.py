"""Loop closure end to end: the port's back-end on the revisit world of
tests/test_slam_loop_e2e.py (40 frames, per-keyframe drift injected),
held to that file's gates: at least one closure with fused landmarks, ATE
without loop closure > 0.04 m, ATE with it < 0.75 x without, asynchronous
against synchronous mapping (within 2x, same keyframes), and a keyframe
trajectory that the correction moved.

The back-end is driven with the reference VO's own keyframe stream (frames,
drifted keyframe motions, records), recorded once from the reference's run
on the same world (``record_reference``, into
``tests/data/loop_world_reference.pkl.gz``, with the rest of what this file
compares with: every tracking step, the closure's calls, and the
reference's back-end on the stream in f64): the VO is upstream of
everything this file tests, and on
this world the port's own VO keyframes 17 frames where the reference's
``VisualOdometry`` keyframes 16. Where the two runs part is pinned below:

- Frames 1-7: every integer output of every tracking step is equal (feature
  counts, cross-frame match indices, inlier masks, ``accepted``,
  ``need_kf``); the relative poses differ by up to 4.5e-5 (f32 op order).
- Frame 8 is the first divergent frame, and the pose solve the first
  divergent stage: one point's stage-1 inlier flag. On the reference's own
  inputs at frame 8 every port stage agrees with the reference's (match
  indices, the line-cut mask, both inlier masks, ``accepted``, ``need_kf``,
  ``frames_since``; ``ent_ratio`` to 1e-5), so no port stage departs. The
  stage-1 Gauss-Newton has not converged after its 5 iterations (a 6th
  moves the pose by more than 1e-3), so the 4.5e-5 difference in the
  constant-velocity start moves the residuals: point 195 lies 1.0e-4
  inside the MAD gate (0.45874 against 0.45884) on the reference's inputs
  and 2.9e-3 outside it (0.45907 against 0.45622) on the port's.
- The keyframe decisions part at frame 15 (the reference's ``ent_ratio``
  0.936, the port's 0.792, against 0.90): the gap built up over frames 8-14
  (the first match index differs at frame 13).
- The reference is as sensitive to its own op order: its ``run_vo_scan``
  path on the same world keyframes 17, at the same frames as the port's
  VO ([0, 3, 6, 8, 10, 13, 15, 18, 20, ...]); its inlier counts part from
  its ``VisualOdometry``'s at frame 11.

With 17 keyframes the far window of the final keyframe admits a frame-15
keyframe that outscores KF0, its verification fails, and that run closes
no loop; test_port_vo_on_the_loop_world records this run's gates that do
hold. The port's own VO closes the loop on the textured variant of the
world, decoded by the port's C++ loader (the last test).

``PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_slam_loop.py``
prints the per-frame comparison of the three VO loops (the reference's
``VisualOdometry`` and ``run_vo_scan``, the port's ``VisualOdometry``) on
this world.
"""

import dataclasses
import gzip
import hashlib
import pickle
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gfplslam_tpu.config import (CameraParams, CapacityParams, Config,
                                 OrbParams, SlamParams)
from gfplslam_tpu.io import synthetic
from gfplslam_tpu.models import loop as ref_loop
from gfplslam_tpu.models import map as ref_map
from gfplslam_tpu.models import tracker as ref_trk
from gfplslam_tpu.models import vo as ref_vo
from gfplslam_tpu.models.slam import SLAMSystem as RefSLAM

from gfplslam_torch.io import native_loader
from gfplslam_torch.models import loop, map as map_ops, pose_opt, tracker, vo as vo_mod
from gfplslam_torch.models.slam import SLAMSystem
from gfplslam_torch.utils import convert, se3
from gfplslam_torch.utils.robust import masked_stdv_mad
from gfplslam_torch.utils.trajectory import ate_rmse

import test_slam_loop_e2e as ref_test
from test_torch_ba_observed_subspace import reference_ba_in_f64

torch.set_num_threads(2)
CPU = torch.device("cpu")
N = ref_test.N_FRAMES
# the integer outputs of one tracking step, compared exactly between runs
INT_OUTPUTS = ("n_pt", "n_ln", "pt_curr_idx", "ln_curr_idx", "pt_inlier",
               "ln_inlier", "accepted", "need_kf")
FIRST_DIVERGENT = 8   # first frame whose integer outputs differ
FIRST_KF_DIVERGENT = 15   # first frame whose keyframe decision differs
REF_RECORD = Path(__file__).resolve().parent / "data" / "loop_world_reference.pkl.gz"


def _step_record(frame_idx, state, prev, curr, delta_t, out, entropy):
    """What one tracking step read (its inputs, as given) and wrote (its
    integer outputs, pose result and keyframe-decision floats, numpy)."""
    def a(x):
        return np.asarray(x.cpu() if torch.is_tensor(x) else x)
    return dict(
        frame=frame_idx, state=state, prev=prev, curr=curr, delta_t=float(delta_t),
        n_pt=int(a(curr.points.valid).sum()), n_ln=int(a(curr.lines.valid).sum()),
        pt_curr_idx=a(out.matches.pt_curr_idx), ln_curr_idx=a(out.matches.ln_curr_idx),
        pt_inlier=a(out.pose.pt_inlier), ln_inlier=a(out.pose.ln_inlier),
        accepted=bool(a(out.pose.accepted)), need_kf=bool(a(out.need_kf)),
        pose=out.pose, frames_since=int(a(out.state.frames_since_kf)),
        ent_ratio=float(a(entropy(out.state.cov_prev_kf)))
        / float(a(out.state.entropy_first_prev_kf)))


class RecordingVO(ref_test.DriftingVO):
    """The reference's drifting VO, recording what the back-end reads and
    every tracking step (``steps``)."""

    def __init__(self, cfg, drift):
        super().__init__(cfg, drift)
        self.stream = []
        self.steps = []

    def _track(self, frame, delta_t, log, timer):
        state, prev = self.state, self.prev_frame
        out = super()._track(frame, delta_t, log, timer)
        self.steps.append(_step_record(
            self.frame_idx, *jax.tree.map(np.asarray, (state, prev, frame)),
            delta_t, out._replace(pose=jax.tree.map(np.asarray, out.pose)),
            ref_trk._entropy))
        return out

    def process(self, img_l, img_r, timestamp):
        rec = super().process(img_l, img_r, timestamp)
        self.stream.append((dataclasses.asdict(rec),
                            jax.tree.map(np.asarray, self.prev_frame),
                            np.array(self.last_kf_rel), bool(self.lost)))
        return rec


class _Replaying:
    """Plays a recorded keyframe stream into a SLAMSystem in place of its
    VO (``_frame`` converts a recorded frame, ``_record`` is the package's
    FrameRecord)."""

    def process(self, img_l, img_r, timestamp):
        rec, frame, kf_rel, lost = self.stream[self.frame_idx]
        rec = self._record(**rec)
        self.prev_frame = self._frame(frame)
        self.last_kf_rel = kf_rel.copy()
        self.lost = lost
        self.records.append(rec)
        self.frame_idx += 1
        self.kf_count += int(rec.is_kf)
        return rec


class ReplayVO(_Replaying, vo_mod.VisualOdometry):
    """The stream into the port's SLAMSystem."""
    _record = vo_mod.FrameRecord

    def __init__(self, cfg, stream):
        super().__init__(cfg, device=CPU)
        self.stream = stream

    def _frame(self, frame):
        return convert.to_torch(frame, CPU)


class RefReplayVO(_Replaying, ref_vo.VisualOdometry):
    """The same stream into the reference's SLAMSystem."""
    _record = ref_vo.FrameRecord

    def __init__(self, cfg, stream):
        super().__init__(cfg)
        self.stream = stream

    def _frame(self, frame):
        return jax.tree.map(jnp.asarray, frame)


class DriftingVO(vo_mod.VisualOdometry):
    """tests/test_slam_loop_e2e.py's DriftingVO around the port's VO,
    recording every tracking step as ``RecordingVO`` does."""

    def __init__(self, cfg, drift):
        super().__init__(cfg, device=CPU)
        self._drift = np.asarray(drift, np.float64)
        self.steps = []

    def _track(self, frame, delta_t):
        state, prev = self.state, self.prev_frame
        out = super()._track(frame, delta_t)
        self.steps.append(_step_record(self.frame_idx, state, prev, frame, delta_t,
                                       out, tracker._entropy))
        return out

    def process(self, img_l, img_r, timestamp):
        pre_base = self.t_base_w.copy()
        rec = super().process(img_l, img_r, timestamp)
        if rec.is_kf and self.kf_count > 1:
            self.last_kf_rel = self.last_kf_rel @ self._drift
            self.t_base_w = pre_base @ self.last_kf_rel
            rec.t_cam_w = self.t_base_w.copy()
        return rec


def _loop_world():
    """tests/test_slam_loop_e2e.py's cfg, world and frames fixtures."""
    cfg_ref = Config(
        cap=CapacityParams(n_pt=256, n_ln=128, n_kf_window=4, n_kf_max=32,
                           n_map_pt=2048, n_map_ln=512,
                           n_obs_pt=1024, n_obs_ln=256, vocab_k=128),
        orb=OrbParams(nlevels=2),
        camera=CameraParams(width=376, height=240, fx=217.6, fy=217.6,
                            cx=183.7, cy=126.1, baseline=0.11),
        slam=SlamParams(max_kf_num_frames=2, lc_kf_dist=8, lc_kf_max_dist=3,
                        lc_nkf_closest=2))
    world = synthetic.make_world(n_frames=N, n_points=400, n_lines=50, seed=21,
                                 motion="loop")
    frames = [synthetic.render_frame(world, i, noise=1.0) for i in range(N)]
    return cfg_ref, world, frames


def _frames_digest(frames) -> str:
    h = hashlib.sha256()
    for il, ir in frames:
        h.update(np.ascontiguousarray(il).tobytes())
        h.update(np.ascontiguousarray(ir).tobytes())
    return h.hexdigest()


def record_reference() -> dict:
    """The reference's runs on the loop world that this file compares with,
    recorded once into ``REF_RECORD`` (``PYTHONPATH=. JAX_PLATFORMS=cpu
    python tests/test_torch_slam_loop.py --record``, ~2.5 min of the
    reference's compiles): its SLAMSystem around the drifting, recording VO
    (the keyframe stream, every tracking step, the closure's pose-graph and
    fusion calls with their inputs and outputs, its keyframes) and its
    back-end on that stream with the local BA solved in f64
    (``reference_ba_in_f64``). A tracking step keeps its inputs (state,
    previous and current frame) only at ``FIRST_DIVERGENT``, the one step a
    test re-runs; the digest of the rendered frames ties the record to the
    world."""
    cfg_ref, world, frames = _loop_world()
    vo = RecordingVO(cfg_ref, ref_test._drift_transform())
    ref = RefSLAM(cfg_ref, vo=vo)
    # record the closure's pose-graph and fusion calls, inputs and outputs
    calls = {}

    def spy(mod, name):
        orig = getattr(mod, name)

        def wrapped(*args, **kw):
            out = orig(*args, **kw)
            calls.setdefault(name, (jax.tree.map(np.asarray, (args, kw)),
                                    jax.tree.map(np.asarray, out)))
            return out
        return orig, wrapped
    patched = [(m, n, *spy(m, n)) for m, n in ((ref_loop, "optimize_pose_graph"),
                                                (ref_map, "fuse_loop_landmarks"))]
    for mod, name, _, wrapped in patched:
        setattr(mod, name, wrapped)
    try:
        for i in range(N):
            ref.process(*frames[i], world.timestamps[i])
        ref.finish()
    finally:
        for mod, name, orig, _ in patched:
            setattr(mod, name, orig)
    ref64 = RefSLAM(cfg_ref, vo=RefReplayVO(cfg_ref, vo.stream))
    with reference_ba_in_f64():
        for i in range(N):
            ref64.process(*frames[i], world.timestamps[i])
        ref64.finish()
    inputs = ("state", "prev", "curr")
    steps = [s if s["frame"] == FIRST_DIVERGENT else {k: v for k, v in s.items()
                                                      if k not in inputs}
             for s in vo.steps]
    return dict(frames_digest=_frames_digest(frames), stream=vo.stream, steps=steps,
                calls=calls, kf_frame_ids=ref.kf_frame_ids,
                n_keyframes=len(ref.keyframe_trajectory),
                f64=dict(kf_frame_ids=ref64.kf_frame_ids,
                         n_loop_closures=ref64.n_loop_closures,
                         all_frame_trajectory=ref64.all_frame_trajectory))


@pytest.fixture(scope="module")
def setup():
    """The loop world and the reference's recorded runs on it
    (``record_reference``)."""
    cfg_ref, world, frames = _loop_world()
    with gzip.open(REF_RECORD, "rb") as f:
        rec = pickle.load(f)
    assert rec.pop("frames_digest") == _frames_digest(frames), \
        "the loop world changed: record the reference's runs again"
    return dict(cfg=convert.config_from_ref(cfg_ref), cfg_ref=cfg_ref, world=world,
                frames=frames, **rec)


def _replay(setup, **kw):
    slam = SLAMSystem(setup["cfg"], device=CPU, vo=ReplayVO(setup["cfg"], setup["stream"]),
                      **kw)
    for i in range(N):
        slam.process(*setup["frames"][i], setup["world"].timestamps[i])
    slam.finish()
    assert not slam.vo.lost
    return slam


@pytest.fixture(scope="module")
def ref_f64(setup):
    """The reference's back-end on the same recorded stream with its local
    BA solved in f64 (``reference_ba_in_f64``), as recorded."""
    return SimpleNamespace(**setup["f64"])


@pytest.fixture(scope="module")
def runs(setup):
    return {"lc": _replay(setup), "nolc": _replay(setup, run_loop_closure=False),
            "sync": _replay(setup, async_mapping=False)}


def _ate(setup, slam):
    return ate_rmse(slam.all_frame_trajectory, setup["world"].poses)


def test_loop_closure_fires(runs):
    assert runs["lc"].n_loop_closures >= 1
    assert runs["lc"].n_fused_landmarks > 0


def test_loop_closure_reduces_ate(setup, runs):
    ate_lc, ate_nolc = _ate(setup, runs["lc"]), _ate(setup, runs["nolc"])
    assert runs["nolc"].n_loop_closures == 0
    assert ate_nolc > 0.04, ate_nolc
    assert ate_lc < 0.75 * ate_nolc, (ate_lc, ate_nolc)


def test_async_mapping_matches_sync(setup, runs):
    """Decisions harvested one keyframe late (async, the default) against
    the blocking driver."""
    assert runs["sync"].n_loop_closures >= 1
    ate_sync, ate_async = _ate(setup, runs["sync"]), _ate(setup, runs["lc"])
    assert ate_async < 2.0 * max(ate_sync, 0.01), (ate_async, ate_sync)
    assert len(runs["lc"].keyframe_trajectory) == len(runs["sync"].keyframe_trajectory)


def test_kf_trajectory_reflects_correction(runs):
    kf_lc, kf_nolc = runs["lc"].keyframe_trajectory, runs["nolc"].keyframe_trajectory
    n = min(len(kf_lc), len(kf_nolc))
    assert n >= 10
    assert np.abs(kf_lc[:n, :3, 3] - kf_nolc[:n, :3, 3]).max() > 1e-3


def test_closure_agrees_with_reference(setup, runs, ref_f64):
    """Same closures and keyframes as the reference's back-end on the same
    stream with its local BA in f64, ATE within 2 cm (measured: 0.19369 m
    against 0.19328 m). Not its f32 BA: it rounds low-parallax landmarks'
    blocks away (tests/test_torch_ba.py) and, on this stream, ends at
    0.13387 m. The count of fused landmarks is not compared: each loop side
    is compacted to 256 of ~500 candidates by (last keyframe, landmark id),
    and the ids that landmarks get depend on which pool slots culling freed,
    so a different subset can enter the fusion. The fusion itself is held
    exactly on the reference's own map below."""
    port = runs["lc"]
    assert ref_f64.kf_frame_ids == setup["kf_frame_ids"]
    assert port.n_loop_closures == ref_f64.n_loop_closures >= 1
    assert port.n_fused_landmarks > 0
    assert port.kf_frame_ids == ref_f64.kf_frame_ids
    assert abs(_ate(setup, port) - _ate(setup, ref_f64)) < 0.02


def test_closure_stages_on_reference_inputs(setup):
    """The reference's own closure, stage by stage: its pose-graph solve
    (1e-4 relative) and its landmark fusion (every leaf exact)."""
    (args, kw), want = setup["calls"]["optimize_pose_graph"]
    kf_pose, kf_valid, edges, fixed = (convert.to_torch(a, CPU) if isinstance(a, tuple)
                                       else torch.from_numpy(np.array(a)) for a in args)
    got = loop.optimize_pose_graph(kf_pose, kf_valid, edges, fixed, **kw).numpy()
    assert np.abs(got - want).max() < 1e-4 * np.abs(want).max()
    (args, _), want = setup["calls"]["fuse_loop_landmarks"]
    _, m, kf_prev, kf_curr = args
    got_m, n_fused, n_over = map_ops.fuse_loop_landmarks(
        setup["cfg"], convert.to_torch(m, CPU), torch.tensor(int(kf_prev)),
        torch.tensor(int(kf_curr)))
    assert int(n_fused) == int(want[1]) > 0 and int(n_over) == int(want[2])
    got_m = convert.to_numpy(got_m)
    for name, g, w in zip(got_m._fields, got_m, want[0]):
        np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.fixture(scope="module")
def port_run(setup):
    """The port's own drifting VO on the same world, loop closure on."""
    slam = SLAMSystem(setup["cfg"], device=CPU,
                      vo=DriftingVO(setup["cfg"], ref_test._drift_transform()))
    for i in range(N):
        slam.process(*setup["frames"][i], setup["world"].timestamps[i])
    slam.finish()
    return slam


def test_port_vo_on_the_loop_world(setup, port_run):
    """The port's own drifting VO on the same world, loop closure on: not
    lost, keyframe count within 3 of the reference's, trajectory finite and
    within the no-closure drift (see the module docstring for why this run
    closes no loop)."""
    slam = port_run
    assert not slam.vo.lost
    assert abs(len(slam.keyframe_trajectory) - setup["n_keyframes"]) <= 3
    traj = slam.all_frame_trajectory
    assert np.isfinite(traj).all() and _ate(setup, slam) < 0.5


def _parted(a, b) -> list:
    return [k for k in INT_OUTPUTS if not np.array_equal(a[k], b[k])]


def _kf_frames(steps) -> list:
    return [0] + [s["frame"] for s in steps if s["need_kf"]]


def test_first_divergent_frame(setup, port_run):
    """The port's VO and the reference's, each on its own outputs: every
    integer output of frames 1-7 equal, the first difference one point's
    inlier flag at frame 8, the first keyframe decision apart at frame 15,
    and 17 keyframes against 16."""
    ref_steps, port_steps = setup["steps"], port_run.vo.steps
    assert len(ref_steps) == len(port_steps) == N - 1
    parted = [(a["frame"], _parted(a, b)) for a, b in zip(ref_steps, port_steps)]
    first = next(p for p in parted if p[1])
    assert first == (FIRST_DIVERGENT, ["pt_inlier"])
    a, b = ref_steps[FIRST_DIVERGENT - 1], port_steps[FIRST_DIVERGENT - 1]
    assert int((a["pt_inlier"] != b["pt_inlier"]).sum()) == 1
    for a, b in zip(ref_steps[:FIRST_DIVERGENT - 1], port_steps):
        assert np.abs(a["pose"].dt - b["pose"].dt.numpy()).max() < 1e-4
    ref_kf, port_kf = _kf_frames(ref_steps), _kf_frames(port_steps)
    assert (len(ref_kf), len(port_kf)) == (16, 17)
    assert next(a["frame"] for a, b in zip(ref_steps, port_steps)
                if a["need_kf"] != b["need_kf"]) == FIRST_KF_DIVERGENT
    a, b = ref_steps[FIRST_KF_DIVERGENT - 1], port_steps[FIRST_KF_DIVERGENT - 1]
    th = setup["cfg"].slam.min_entropy_ratio
    assert a["ent_ratio"] > th + 0.02 and b["ent_ratio"] < th - 0.02


def _stage1_margin(cfg, dt_pred, pts, lns, i) -> float:
    """MAD gate minus point ``i``'s residual at the stage-1 pose: the
    quantity whose sign is point ``i``'s inlier flag."""
    opt = cfg.optimizer
    dt1 = pose_opt.gauss_newton(cfg.camera, dt_pred, pts, lns, opt, opt.max_iters)[0]
    r = pose_opt._point_terms(cfg.camera, dt1, pts, 1e-7)[1] * torch.sqrt(pts.sigma2)
    return float(opt.inlier_k * masked_stdv_mad(r, pts.valid) - r[i])


def test_port_stages_at_the_first_divergent_frame(setup, port_run):
    """At frame 8, on the reference's own inputs (its tracker state, previous
    and current frame), every port stage gives the reference's integers:
    cross-frame match indices, the line-cut mask, both inlier masks and
    ``accepted``, ``need_kf`` and ``frames_since`` (``ent_ratio`` to 1e-5).
    The stage-1 Gauss-Newton has not converged after 5 iterations, and the
    point whose flag parts the two runs sits 1.0e-4 inside the MAD gate on
    the reference's inputs and 2.9e-3 outside it on the port's."""
    cfg, cfg_ref = setup["cfg"], setup["cfg_ref"]
    s = setup["steps"][FIRST_DIVERGENT - 1]
    assert s["frame"] == FIRST_DIVERGENT
    state, prev, curr = (convert.to_torch(x, CPU) for x in (s["state"], s["prev"], s["curr"]))
    dt_pred = se3.inverse_se3(state.dt_store)

    m = tracker.cross_frame_matching(cfg, prev, curr, dt_pred)
    np.testing.assert_array_equal(m.pt_curr_idx.numpy(), s["pt_curr_idx"])
    np.testing.assert_array_equal(m.ln_curr_idx.numpy(), s["ln_curr_idx"])

    j = jax.tree.map(jax.numpy.asarray, (s["state"], s["prev"], s["curr"]))
    ref_pred = ref_trk.se3.inverse_se3(j[0].dt_store)
    ref_m = jax.jit(ref_trk.cross_frame_matching, static_argnums=0)(cfg_ref, j[1], j[2], ref_pred)
    ref_cut = jax.jit(ref_trk.apply_linecut, static_argnums=0)(cfg_ref, j[1], ref_m, ref_pred)
    ref_m, ref_cut = (convert.to_torch(jax.tree.map(np.asarray, x), CPU) for x in (ref_m, ref_cut))
    lns = tracker.apply_linecut(cfg, prev, ref_m, dt_pred)
    assert torch.equal(lns.valid, ref_cut.valid)

    res = pose_opt.optimize_pose(cfg.camera, dt_pred, ref_m.points, ref_cut, cfg.optimizer,
                                 torch.tensor(s["delta_t"]))
    np.testing.assert_array_equal(res.pt_inlier.numpy(), s["pt_inlier"])
    np.testing.assert_array_equal(res.ln_inlier.numpy(), s["ln_inlier"])
    assert bool(res.accepted) == s["accepted"]

    out = tracker.finalize_track(cfg, state, ref_m, convert.to_torch(s["pose"], CPU))
    assert bool(out.need_kf) == s["need_kf"]
    assert int(out.state.frames_since_kf) == s["frames_since"]
    ent = float(tracker._entropy(out.state.cov_prev_kf) / out.state.entropy_first_prev_kf)
    assert abs(ent - s["ent_ratio"]) < 1e-5

    # the parting: a stage-1 solve that has not converged, and one point at its gate
    opt = cfg.optimizer
    dt5, dt6 = (pose_opt.gauss_newton(cfg.camera, dt_pred, ref_m.points, ref_cut, opt, k)[0]
                for k in (opt.max_iters, opt.max_iters + 1))
    assert float((dt6 - dt5).abs().max()) > 1e-3
    p = port_run.vo.steps[FIRST_DIVERGENT - 1]
    i = int(np.flatnonzero(s["pt_inlier"] != p["pt_inlier"])[0])
    assert s["pt_inlier"][i] and not p["pt_inlier"][i]
    assert 0 < _stage1_margin(cfg, dt_pred, ref_m.points, ref_cut, i) < 2e-4
    p_pred = se3.inverse_se3(p["state"].dt_store)
    p_m = tracker.cross_frame_matching(cfg, p["prev"], p["curr"], p_pred)
    p_cut = tracker.apply_linecut(cfg, p["prev"], p_m, p_pred)
    assert -5e-3 < _stage1_margin(cfg, p_pred, p_m.points, p_cut, i) < 0
    assert float((p_pred - dt_pred).abs().max()) < 1e-4


def test_port_closes_the_loop_on_the_textured_world(setup, tmp_path):
    """The port end to end, its own VO included, on the textured revisit
    world of tests/test_slam_loop_e2e.py::test_file_backed_loop_reduced
    (trained 128-word vocabulary): the frames written as PGM, decoded by the
    port's C++ loader (``io/native_loader.py``) equal to the rounded
    frames, and held to that test's gates: not lost, ATE < 0.25 m, at least
    one closure (measured: 1 closure, 16 fused landmarks, ATE 0.126 m)."""
    cfg = setup["cfg"]
    assert cfg.cap.vocab_k in loop.trained_sizes()
    world = synthetic.make_world(n_frames=N, n_points=400, n_lines=50, seed=21,
                                 motion="loop", cam=setup["cfg_ref"].camera,
                                 textured=True)
    paths_l, paths_r, rendered = [], [], []
    for i in range(N):
        il, ir = synthetic.render_frame(world, i, noise=1.0)
        for side, img, paths in (("l", il, paths_l), ("r", ir, paths_r)):
            paths.append(str(tmp_path / f"{side}_{i:04d}.pgm"))
            ref_test._write_pgm(paths[-1], img)
        rendered.append((np.round(np.clip(il, 0, 255)), np.round(np.clip(ir, 0, 255))))
    decoded = [None] * N
    with native_loader.StereoLoader(paths_l, paths_r, cfg.camera.width, cfg.camera.height,
                                    n_threads=2, queue_depth=4) as loader:
        for k, il, ir in loader:
            decoded[k] = (il, ir)
    for k in range(N):
        np.testing.assert_array_equal(decoded[k][0], rendered[k][0])
        np.testing.assert_array_equal(decoded[k][1], rendered[k][1])
    slam = SLAMSystem(cfg, device=CPU)
    for i in range(N):
        slam.process(*decoded[i], world.timestamps[i])
    slam.finish()
    assert not slam.vo.lost
    assert ate_rmse(slam.all_frame_trajectory, world.poses) < 0.25
    assert slam.n_loop_closures >= 1 and slam.n_fused_landmarks > 0


def _compare_vo_loops():
    """The three VO loops on the loop world, frame by frame (the tracker's
    outputs do not depend on the back-end, so the VOs run alone)."""
    from gfplslam_tpu.models.vo import run_vo_scan as ref_run_vo_scan

    cfg_ref, world, frames = _loop_world()
    cfg = convert.config_from_ref(cfg_ref)
    ref_vo = RecordingVO(cfg_ref, ref_test._drift_transform())
    port_vo = DriftingVO(cfg, ref_test._drift_transform())
    for vo in (ref_vo, port_vo):
        for i in range(N):
            vo.process(*frames[i], world.timestamps[i])
    _, aux = ref_run_vo_scan(cfg_ref, *(jax.numpy.asarray(np.stack([f[k] for f in frames]))
                                        for k in (0, 1)),
                             jax.numpy.asarray(world.timestamps, jax.numpy.float32))
    aux = jax.tree.map(np.asarray, aux)
    print("frame  inliers pt/ln: ref VO  ref scan  port VO   keyframe   ent_ratio ref/port"
          "   integer outputs apart")
    for i, (a, b) in enumerate(zip(ref_vo.steps, port_vo.steps)):
        print(f"{a['frame']:5d}  {a['pt_inlier'].sum():6d}/{a['ln_inlier'].sum():<3d}"
              f"{aux['n_pt'][i]:6d}/{aux['n_ln'][i]:<3d}"
              f"{b['pt_inlier'].sum():6d}/{b['ln_inlier'].sum():<3d}"
              f"   {a['need_kf']:d}{bool(aux['is_kf'][i]):d}{b['need_kf']:d}"
              f"   {a['ent_ratio']:.7f}/{b['ent_ratio']:.7f}   {_parted(a, b)}")
    scan_kf = [0] + [int(i) + 1 for i in np.flatnonzero(aux["is_kf"])]
    for name, kfs in (("ref VisualOdometry", _kf_frames(ref_vo.steps)),
                      ("ref run_vo_scan", scan_kf),
                      ("port VisualOdometry", _kf_frames(port_vo.steps))):
        print(f"{name}: {len(kfs)} keyframes at {kfs}")


if __name__ == "__main__":
    if sys.argv[1:] == ["--record"]:
        with gzip.open(REF_RECORD, "wb") as f:
            pickle.dump(record_reference(), f, protocol=pickle.HIGHEST_PROTOCOL)
        print(f"wrote {REF_RECORD}")
    else:
        _compare_vo_loops()
