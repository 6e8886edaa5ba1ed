"""The tracker (models/tracker.py): cross-frame matching, line cutting and
one whole ``track_step``, run on two frames and a tracker state that the
reference produced, at 376x240 with the small capacities of
tests/test_vo_e2e.py.

Held exactly: match validity and indices, cut ratios, inlier masks, the
keyframe decision and the adaptive FAST threshold. Floats: the pose within
1e-4 (f32 normal-equation sums in another order, converging GN), the cut
endpoints within rtol 1e-6, the pose covariance by its variances and
log-volume (it inverts an ill-conditioned f32 Hessian; see the test)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfplslam_tpu.config import CameraParams, CapacityParams, Config, OrbParams
from gfplslam_tpu.io import synthetic as ref_synthetic
from gfplslam_tpu.models import frame as ref_frame
from gfplslam_tpu.models import tracker as ref_tracker
from gfplslam_tpu.utils import se3 as ref_se3

from gfplslam_torch.models import tracker
from gfplslam_torch.utils import convert, se3

torch.set_num_threads(2)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def case():
    cfg_ref = Config(
        cap=CapacityParams(n_pt=256, n_ln=128, n_pt_match=128, n_ln_match=64),
        orb=OrbParams(nlevels=2),
        camera=CameraParams(width=376, height=240, fx=217.6, fy=217.6,
                            cx=183.7, cy=126.1, baseline=0.11))
    world = ref_synthetic.make_world(n_frames=8, n_points=300, n_lines=40, seed=4)
    st0 = ref_tracker.initial_state(cfg_ref)
    f0 = ref_frame.process_stereo_pair(
        *map(jnp.asarray, ref_synthetic.render_frame(world, 0, noise=1.0)),
        cfg_ref, jnp.asarray(10.0))
    f1 = ref_frame.process_stereo_pair(
        *map(jnp.asarray, ref_synthetic.render_frame(world, 1, noise=1.0)),
        cfg_ref, st0.fast_th)
    out = ref_tracker.track_step(cfg_ref, st0, f0, f1, jnp.asarray(0.05))
    as_np = lambda t: jax.tree.map(np.array, t)  # noqa: E731
    return dict(cfg_ref=cfg_ref, cfg=convert.config_from_ref(cfg_ref),
                st0=as_np(st0), f0=as_np(f0), f1=as_np(f1), out=as_np(out))


def _t(case, key):
    return convert.to_torch(case[key], CPU)


def test_initial_state_and_mark_keyframe_match(case):
    got = convert.to_numpy(tracker.initial_state(case["cfg"], CPU))
    for g, w in zip(got, case["st0"]):
        np.testing.assert_array_equal(g, w)
    st = case["out"].state
    got = convert.to_numpy(tracker.mark_keyframe(convert.to_torch(st, CPU)))
    want = jax.tree.map(np.asarray, ref_tracker.mark_keyframe(
        jax.tree.map(jnp.asarray, st)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_cross_frame_matching_exact(case):
    st0 = case["st0"]
    dt_pred = np.array(ref_se3.inverse_se3(jnp.asarray(st0.dt_store)))
    got = convert.to_numpy(tracker.cross_frame_matching(
        case["cfg"], _t(case, "f0"), _t(case, "f1"), torch.from_numpy(dt_pred)))
    want = case["out"].matches
    np.testing.assert_array_equal(got.pt_curr_idx, want.pt_curr_idx)
    np.testing.assert_array_equal(got.ln_curr_idx, want.ln_curr_idx)
    np.testing.assert_array_equal(got.points.valid, want.points.valid)
    np.testing.assert_array_equal(got.lines.valid, want.lines.valid)
    assert want.points.valid.sum() > 10
    v = want.points.valid
    np.testing.assert_array_equal(got.points.obs[v], want.points.obs[v])


def test_apply_linecut_on_reference_matches(case):
    cfg, cfg_ref = case["cfg"], case["cfg_ref"]
    dt_pred = np.eye(4, dtype=np.float32)
    matches = case["out"].matches
    want = ref_tracker.apply_linecut(
        cfg_ref, jax.tree.map(jnp.asarray, case["f0"]),
        jax.tree.map(jnp.asarray, matches), jnp.asarray(dt_pred))
    got = tracker.apply_linecut(cfg, _t(case, "f0"),
                                convert.to_torch(matches, CPU),
                                torch.from_numpy(dt_pred))
    v = matches.lines.valid
    assert v.sum() >= 1
    for g, w in ((got.sp3d, want.sp3d), (got.ep3d, want.ep3d)):
        np.testing.assert_allclose(g.numpy()[v], np.asarray(w)[v], rtol=1e-6,
                                   atol=1e-6)


def test_track_step_on_reference_frames(case):
    got = tracker.track_step(case["cfg"], _t(case, "st0"), _t(case, "f0"),
                             _t(case, "f1"), torch.tensor(0.05))
    want = case["out"]
    assert bool(got.pose.accepted) == bool(want.pose.accepted) is True
    np.testing.assert_array_equal(got.pose.pt_inlier.numpy(), want.pose.pt_inlier)
    np.testing.assert_array_equal(got.pose.ln_inlier.numpy(), want.pose.ln_inlier)
    np.testing.assert_allclose(got.pose.dt.numpy(), want.pose.dt, rtol=0, atol=1e-4)
    # dt_cov = H^-1 of an f32 Hessian whose condition number is ~1e7 here:
    # entries carry relative errors up to cond * eps on both sides, so the
    # variances are held to 5% and the log-volume (what the keyframe
    # entropy reads, ~-57 here) to 0.2
    cov_g, cov_w = got.pose.dt_cov.numpy(), want.pose.dt_cov
    np.testing.assert_allclose(np.diag(cov_g), np.diag(cov_w), rtol=0.05)
    assert abs(np.linalg.slogdet(cov_g.astype(np.float64))[1]
               - np.linalg.slogdet(cov_w.astype(np.float64))[1]) < 0.2
    st = convert.to_numpy(got.state)
    np.testing.assert_allclose(st.t_cam_w, want.state.t_cam_w, rtol=0, atol=1e-4)
    for name in ("fast_th", "num_frame_loss", "frames_since_kf", "prev_f_is_kf"):
        np.testing.assert_array_equal(getattr(st, name), getattr(want.state, name))
    assert bool(got.need_kf) == bool(want.need_kf)
    assert int(got.n_inliers_pt) == int(want.n_inliers_pt)
    assert int(got.n_inliers_ln) == int(want.n_inliers_ln)
    assert bool(got.track_lost) == bool(want.track_lost)


@pytest.mark.parametrize("accepted,err,n_pt,n_all", [
    (False, 0.1, 100, 300), (True, 0.9, 100, 300), (True, 0.1, 20, 300),
    (True, 0.1, 60, 80), (True, 0.1, 60, 250), (True, 0.1, 60, 160),
    (True, 0.1, 60, 120)])
def test_update_fast_th_branches(case, accepted, err, n_pt, n_all):
    for th in (10.0, 30.0, 50.0):
        want = ref_tracker._update_fast_th(
            case["cfg_ref"], jnp.asarray(th), jnp.asarray(accepted),
            jnp.asarray(err), jnp.asarray(n_pt), jnp.asarray(n_all))
        got = tracker._update_fast_th(
            case["cfg"], torch.tensor(th), torch.tensor(accepted),
            torch.tensor(err), torch.tensor(n_pt), torch.tensor(n_all))
        assert float(got) == float(want)


def test_entropy_matches(case):
    cov = case["out"].pose.dt_cov
    for c in (cov, np.zeros((6, 6), np.float32), -np.eye(6, dtype=np.float32)):
        want = float(ref_tracker._entropy(jnp.asarray(c)))
        got = float(tracker._entropy(torch.from_numpy(np.array(c))))
        if np.isnan(want):
            assert np.isnan(got)
        else:
            assert got == pytest.approx(want, rel=1e-5)
    assert se3.is_finite(torch.from_numpy(cov))
