"""Pose Gauss-Newton and line cutting: the port against the reference on
synthetic scenes of known motion (the scenes of tests/test_pose_opt.py and
tests/test_linecut.py, made with numpy from a seed).

Tolerances: normal equations within rtol 1e-5 of their largest entry (f32
sums over the matches in another order); the optimized pose within 5e-4 of
the reference's (see the test for why) and near ground truth; line-cut
factors within rtol 2e-4 as tests/test_linecut.py holds them; cut ratios
exactly equal (they move on a 0.05 grid, so only a near-tie in the log-det
objective could move them, and these scenes have none)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfplslam_tpu.config import EUROC_CAMERA, OptimizerParams as RefOpt
from gfplslam_tpu.models import linecut as ref_linecut
from gfplslam_tpu.models import pose_opt as ref_pose_opt
from gfplslam_tpu.utils import se3 as ref_se3

from gfplslam_torch.config import CameraParams, OptimizerParams
from gfplslam_torch.models import linecut, pose_opt
from gfplslam_torch.utils import convert

torch.set_num_threads(2)
CPU = torch.device("cpu")
CAM = CameraParams()


def _proj(p, t):
    q = p @ t[:3, :3].T + t[:3, 3]
    return np.stack([EUROC_CAMERA.fx * q[:, 0] / q[:, 2] + EUROC_CAMERA.cx,
                     EUROC_CAMERA.fy * q[:, 1] / q[:, 2] + EUROC_CAMERA.cy], 1)


def make_scene(seed, n_pt=64, n_ln=32, twist_scale=0.05, n_outliers=0):
    rng = np.random.default_rng(seed)
    dt_gt = np.array(ref_se3.expmap_se3(jnp.asarray(
        rng.normal(size=6).astype(np.float32) * twist_scale)))
    p3d = np.stack([rng.uniform(-3, 3, n_pt), rng.uniform(-2, 2, n_pt),
                    rng.uniform(3, 10, n_pt)], 1).astype(np.float32)
    # 0.3 px observation noise: with exact observations the residuals, and
    # so the MAD inlier gate, would be round-off noise
    obs = (_proj(p3d, dt_gt) + rng.normal(0, 0.3, (n_pt, 2))).astype(np.float32)
    obs[:n_outliers] += rng.uniform(20, 40, (n_outliers, 2)).astype(np.float32)
    sp = np.stack([rng.uniform(-3, 3, n_ln), rng.uniform(-2, 2, n_ln),
                   rng.uniform(3, 10, n_ln)], 1).astype(np.float32)
    ep = sp + rng.normal(size=(n_ln, 3)).astype(np.float32)
    ep[:, 2] = np.abs(ep[:, 2]) + 3
    s2 = _proj(sp, dt_gt) + rng.normal(0, 0.3, (n_ln, 2))
    e2 = _proj(ep, dt_gt) + rng.normal(0, 0.3, (n_ln, 2))
    le = np.cross(np.concatenate([s2, np.ones((n_ln, 1))], 1),
                  np.concatenate([e2, np.ones((n_ln, 1))], 1))
    le = (le / np.linalg.norm(le[:, :2], axis=1, keepdims=True)).astype(np.float32)
    pts = ref_pose_opt.PointMatches(p3d=p3d, obs=obs, sigma2=np.ones(n_pt, np.float32),
                                    valid=np.ones(n_pt, bool))
    lns = ref_pose_opt.LineMatches(sp3d=sp, ep3d=ep, le_obs=le,
                                   sigma2=np.ones(n_ln, np.float32),
                                   valid=np.ones(n_ln, bool))
    return dt_gt, pts, lns


def _j(nt):
    return jax.tree.map(jnp.asarray, nt)


def test_normal_equations_match():
    _, pts, lns = make_scene(0)
    dt0 = np.eye(4, dtype=np.float32)
    want = ref_pose_opt.build_normal_equations(EUROC_CAMERA, jnp.asarray(dt0),
                                               _j(pts), _j(lns))
    got = pose_opt.build_normal_equations(CAM, torch.from_numpy(dt0),
                                          convert.to_torch(pts, CPU),
                                          convert.to_torch(lns, CPU))
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * max(np.abs(w).max(), 1e-6))


@pytest.mark.parametrize("seed,n_pt,n_ln,outliers", [
    (1, 64, 32, 0), (2, 64, 0, 6), (3, 0, 40, 0)])
def test_optimize_pose_matches_reference(seed, n_pt, n_ln, outliers):
    dt_gt, pts, lns = make_scene(seed, n_pt=max(n_pt, 1), n_ln=max(n_ln, 1),
                                 n_outliers=outliers)
    if n_pt == 0:
        pts = pts._replace(valid=np.zeros_like(pts.valid))
    if n_ln == 0:
        lns = lns._replace(valid=np.zeros_like(lns.valid))
    dt0 = np.eye(4, dtype=np.float32)
    want = jax.tree.map(np.asarray, ref_pose_opt.optimize_pose(
        EUROC_CAMERA, jnp.asarray(dt0), _j(pts), _j(lns), RefOpt(), delta_t=1.0))
    got = convert.to_numpy(pose_opt.optimize_pose(
        CAM, torch.from_numpy(dt0), convert.to_torch(pts, CPU),
        convert.to_torch(lns, CPU), OptimizerParams(), delta_t=1.0))
    assert bool(got.accepted) and bool(want.accepted)
    np.testing.assert_array_equal(got.pt_inlier, want.pt_inlier)
    np.testing.assert_array_equal(got.ln_inlier, want.ln_inlier)
    # the GN early stop compares an f32 error change with 1e-7, so the two
    # sides may stop one iteration apart: 5e-4 on the pose entries
    np.testing.assert_allclose(got.dt, want.dt, rtol=0, atol=5e-4)
    # against ground truth, at 0.3 px noise (lines-only pins translation
    # least)
    np.testing.assert_allclose(got.dt, dt_gt, rtol=0, atol=2e-2)
    if outliers:
        assert not got.pt_inlier[:outliers].any()


def test_optimize_pose_identity_fallback():
    """Too few matches: both sides return the identity, not accepted."""
    _, pts, lns = make_scene(4, n_pt=5, n_ln=3)
    dt0 = np.eye(4, dtype=np.float32)
    want = ref_pose_opt.optimize_pose(EUROC_CAMERA, jnp.asarray(dt0), _j(pts),
                                      _j(lns), RefOpt())
    got = pose_opt.optimize_pose(CAM, torch.from_numpy(dt0),
                                 convert.to_torch(pts, CPU),
                                 convert.to_torch(lns, CPU), OptimizerParams())
    assert not bool(got.accepted) and not bool(want.accepted)
    np.testing.assert_array_equal(got.dt.numpy(), np.eye(4, dtype=np.float32))
    assert float(got.err) == float(want.err) == -1.0


def _cut_case(seed, m=12, noisy_end=True):
    rng = np.random.default_rng(seed)
    _, pts, lns = make_scene(seed, n_pt=16, n_ln=m, twist_scale=0.0)
    cov_s = np.tile(np.eye(3, dtype=np.float32)[None] * 1e-4, (m, 1, 1))
    cov_e = np.tile(np.eye(3, dtype=np.float32)[None] * (1.0 if noisy_end else 1e-4),
                    (m, 1, 1))
    r0 = rng.uniform(0, 0.5, m).astype(np.float32)
    r1 = rng.uniform(0, 0.5, m).astype(np.float32)
    return pts, lns, cov_s, cov_e, r0, r1


def test_line_info_factors_batch_match():
    pts, lns, cov_s, cov_e, r0, r1 = _cut_case(5)
    dt = np.array(ref_se3.expmap_se3(jnp.asarray(
        np.array([0.05, -0.02, 0.1, 0.01, 0.02, -0.01], np.float32))))
    want_j, want_d = jax.vmap(
        lambda s, e, cs, ce, l, a, b: ref_linecut.line_info_factors(
            EUROC_CAMERA, jnp.asarray(dt), s, e, cs, ce, l, a, b))(
        *map(jnp.asarray, (lns.sp3d, lns.ep3d, cov_s, cov_e, lns.le_obs, r0, r1)))
    got_j, got_d = linecut.line_info_factors_batch(
        CAM, torch.from_numpy(dt), *map(torch.from_numpy, (
            lns.sp3d, lns.ep3d, cov_s, cov_e, lns.le_obs, r0, r1)))
    np.testing.assert_allclose(got_j.numpy(), np.asarray(want_j), rtol=2e-4, atol=1e-3)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=2e-4)


@pytest.mark.parametrize("seed", [6, 7])
def test_cut_lines_matches_reference(seed):
    """The main path's objective (max_vol_line_cut: log-det)."""
    pts, lns, cov_s, cov_e, _, _ = _cut_case(seed)
    dt = np.eye(4, dtype=np.float32)
    want = jax.tree.map(np.asarray, ref_linecut.cut_lines(
        EUROC_CAMERA, jnp.asarray(dt), _j(lns), jnp.asarray(cov_s),
        jnp.asarray(cov_e), _j(pts)))
    got = linecut.cut_lines(CAM, torch.from_numpy(dt), convert.to_torch(lns, CPU),
                            torch.from_numpy(cov_s), torch.from_numpy(cov_e),
                            convert.to_torch(pts, CPU))
    np.testing.assert_array_equal(got.r0.numpy(), want.r0)
    np.testing.assert_array_equal(got.r1.numpy(), want.r1)
    assert int(got.iters) == int(want.iters)
    assert want.r1.sum() > want.r0.sum()         # the noisy side is trimmed
    np.testing.assert_allclose(got.info_sum.numpy(), want.info_sum, rtol=2e-4,
                               atol=1e-3 * np.abs(want.info_sum).max())
    cut = linecut.apply_cut(CAM, convert.to_torch(lns, CPU), got)
    want_cut = ref_linecut.apply_cut(
        EUROC_CAMERA, _j(lns), jax.tree.map(jnp.asarray, want))
    np.testing.assert_allclose(cut.sp3d.numpy(), np.asarray(want_cut.sp3d), rtol=1e-6)
    np.testing.assert_allclose(cut.ep3d.numpy(), np.asarray(want_cut.ep3d), rtol=1e-6)


def test_cut_lines_min_eig_objective_improves():
    """The min-eigenvalue objective (max_vol_line_cut off). Its f32 minimum
    eigenvalues of fx^2-scale 6x6 sums are round-off dominated in the
    reference too, so the choice of cut is not compared; both must keep the
    feasible set and never lower the objective they climb."""
    pts, lns, cov_s, cov_e, _, _ = _cut_case(6)
    args = (CAM, torch.eye(4), convert.to_torch(lns, CPU),
            torch.from_numpy(cov_s), torch.from_numpy(cov_e),
            convert.to_torch(pts, CPU))
    cut = linecut.cut_lines(*args, use_logdet=False)
    base = linecut.cut_lines(*args, use_logdet=False, max_steps=0)
    r0, r1 = cut.r0.numpy(), cut.r1.numpy()
    assert np.all((r0 >= 0) & (r1 >= 0) & (r0 + r1 <= 1.0 + 1e-6))
    ev = torch.linalg.eigvalsh(cut.info_sum.double())[0]
    ev0 = torch.linalg.eigvalsh(base.info_sum.double())[0]
    assert float(ev) >= float(ev0) - 1e-3 * abs(float(ev0))
