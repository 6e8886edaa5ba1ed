"""Bundle adjustment (models/ba_core.py, models/ba.py) against the
reference, on the synthetic window of tests/test_ba.py.

Each stage runs on the reference's own upstream outputs. Tolerances:
closed-form 3x3/6x6 inverses and eigenvalues 1e-5 relative on
well-conditioned blocks; residuals and Jacobians 1e-5 relative to each
tensor's largest entry; the accumulated normal-equation blocks 1e-4
relative (robust weights differ by up to 1e-4, see
test_residuals_and_jacobians, and f32 sums run in another order); the Schur reduction, camera solve and
back-substitution 1e-4 relative.

The whole LM solve is held to the reference's own gates (tests/test_ba.py)
and to the reference's solve in f64 (``jax.enable_x64``): poses within
1e-2, the same inlier marks. Not to its f32 solve: the reference holds a
landmark block's unobserved direction with a 1e8 stiffness, which in f32
rounds the block's observed entries away, so its f32 solve ends at error
0.02928 (noise 0) and 0.11228 (noise 0.3) where its f64 solve ends at
0.00292 and 0.08368. The port inverts on the observed subspace, the limit
of that stiffness (ba_core.landmark_inverses), and ends within 2e-4
relative of the f64 errors. The iteration counts are not compared: both converge, but the
last steps change the error by less than f32 resolves (1e-5 relative, the
convergence tolerance), so the f64 solve stops at 11 iterations and the
port at 9 and 13."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gfplslam_tpu.models import ba as ref_ba
from gfplslam_tpu.models import ba_core as ref_core
from gfplslam_tpu.utils import se3 as ref_se3

from gfplslam_torch.config import CameraParams
from gfplslam_torch.models import ba, ba_core
from gfplslam_torch.utils import convert, se3

from test_ba import build_problem

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(got, want):
    """Largest absolute difference over the reference tensor's largest entry."""
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _case(obs_noise=0.0):
    cam_ref, gt, pts, prob = build_problem(np.random.default_rng(0),
                                           obs_noise=obs_noise)
    cam = CameraParams(**{f: getattr(cam_ref, f)
                          for f in cam_ref.__dataclass_fields__})
    return dict(cam_ref=cam_ref, cam=cam, gt=gt, prob_ref=prob,
                prob=convert.to_torch(prob, CPU))


@pytest.fixture(scope="module")
def case():
    c = _case()
    prob = c["prob_ref"]
    t_cw0 = jax.vmap(ref_se3.inverse_se3)(prob.kf_pose)
    sel = ref_core.make_selectors(prob)
    bk = ref_core.build_blocks(c["cam_ref"], prob, sel, ref_ba._point_residuals,
                               ref_ba._line_residuals, t_cw0, prob.pt_pos,
                               prob.ln_sp, prob.ln_ep)
    c.update(t_cw0=np.asarray(t_cw0), bk=jax.tree.map(np.asarray, bk))
    return c


def _spd(rng, n, d):
    b = rng.normal(0, 1, (n, d, d)).astype(np.float32)
    return (b @ b.transpose(0, 2, 1) + d * np.eye(d, dtype=np.float32)).astype(np.float32)


@pytest.mark.parametrize("d", [3, 6])
def test_closed_form_inverses(d):
    """inv3 / inv6 on well-conditioned SPD blocks: 1e-5 relative."""
    m = _spd(np.random.default_rng(d), 64, d)
    port = (ba_core.inv3 if d == 3 else ba_core.inv6)(_t(m))
    ref = (ref_core.inv3 if d == 3 else ref_core.inv6)(jnp.asarray(m))
    assert _rel(port, ref) < 1e-5
    assert _rel(port, np.linalg.inv(m.astype(np.float64))) < 1e-5


def test_sym3_eigvals_and_projector(case):
    """Smith's closed-form spectrum and the observability projector on the
    problem's point blocks and on random SPD blocks: 1e-5 relative."""
    for h in (case["bk"].hpp, _spd(np.random.default_rng(1), 64, 3)):
        assert _rel(ba_core._sym3_eigvals(_t(h)), ref_core._sym3_eigvals(jnp.asarray(h))) < 1e-5
        assert _rel(ba_core._keep_projector3(_t(h)),
                    ref_core._keep_projector3(jnp.asarray(h))) < 1e-5


def test_projector_branches():
    """n_keep = 3, 2, 1, 0: blocks with chosen spectra."""
    rng = np.random.default_rng(7)
    q, _ = np.linalg.qr(rng.normal(0, 1, (4, 3, 3)))
    spectra = np.array([[1e3, 5e2, 2e2], [1e3, 5e2, 1e-4], [1e3, 1e-5, 1e-4],
                        [1e-5, 1e-4, 1e-3]])
    h = np.einsum("nij,nj,nkj->nik", q, spectra, q).astype(np.float32)
    port = ba_core._keep_projector3(_t(h)).numpy()
    ref = np.asarray(ref_core._keep_projector3(jnp.asarray(h)))
    assert np.abs(port - ref).max() < 1e-5
    np.testing.assert_allclose(np.trace(port, axis1=1, axis2=2), [3, 2, 1, 0],
                               atol=1e-5)


def test_residuals_and_jacobians(case):
    """Jacobians 1e-5 relative. Residuals are differences of ~400 px
    projections and observations, so they are held to 2e-4 px (a few ulps of
    the projection), and the robust weights in [0, 1] to 1e-4."""
    prob, t_cw = case["prob"], _t(case["t_cw0"])
    pr, t_ref = case["prob_ref"], jnp.asarray(case["t_cw0"])
    got_p = ba._point_residuals(case["cam"], t_cw, prob, prob.pt_pos)
    ref_p = ref_ba._point_residuals(case["cam_ref"], t_ref, pr, pr.pt_pos)
    got_l = ba._line_residuals(case["cam"], t_cw, prob, prob.ln_sp, prob.ln_ep)
    ref_l = ref_ba._line_residuals(case["cam_ref"], t_ref, pr, pr.ln_sp, pr.ln_ep)
    for got, want in ((got_p, ref_p), (got_l, ref_l)):
        assert np.abs(got[0].numpy() - np.asarray(want[0])).max() < 2e-4
        assert np.abs(got[-1].numpy() - np.asarray(want[-1])).max() < 1e-4
        for g, w in zip(got[1:-1], want[1:-1]):
            assert _rel(g, w) < 1e-5
    chi2 = ba._point_chi2(case["cam"], t_cw, prob, prob.pt_pos).numpy()
    chi2_ref = np.asarray(ref_ba._point_chi2(case["cam_ref"], t_ref, pr, pr.pt_pos))
    assert np.abs(np.sqrt(chi2) - np.sqrt(chi2_ref)).max() < 2e-4


def test_build_blocks_on_reference_state(case):
    prob = case["prob"]
    bk = ba_core.build_blocks(case["cam"], prob, ba_core.make_selectors(prob),
                              ba._point_residuals, ba._line_residuals,
                              _t(case["t_cw0"]), prob.pt_pos, prob.ln_sp,
                              prob.ln_ep)
    for name, got, want in zip(bk._fields, bk, case["bk"]):
        if want.dtype == bool:
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        else:
            assert _rel(got, want) < 1e-4, name


def test_schur_solve_backsubstitute_on_reference_blocks(case):
    """Schur reduction, damped camera solve and back-substitution on the
    reference's blocks and landmark inverses: 1e-4 relative."""
    bk_ref = case["bk"]
    lam = 1e-3
    inv_ref = ref_core.landmark_inverses(jax.tree.map(jnp.asarray, bk_ref), lam)
    s_ref, rhs_ref = ref_core.schur_reduce(jax.tree.map(jnp.asarray, bk_ref), *inv_ref)
    bk = ba_core.BABlocks(*(_t(x) for x in bk_ref))
    inv = tuple(_t(x) for x in inv_ref)
    s, rhs = ba_core.schur_reduce(bk, *inv)
    assert _rel(s, s_ref) < 1e-4 and _rel(rhs, rhs_ref) < 1e-4
    kf_opt = case["prob_ref"].kf_free & case["prob_ref"].kf_valid
    dx_ref = ref_core.camera_solve(s_ref, rhs_ref, kf_opt, lam)
    dx = ba_core.camera_solve(_t(s_ref), _t(rhs_ref), _t(kf_opt), torch.tensor(lam))
    assert _rel(dx, dx_ref) < 1e-4
    for got, want in zip(ba_core.back_substitute(bk, *inv, _t(dx_ref)),
                         ref_core.back_substitute(jax.tree.map(jnp.asarray, bk_ref),
                                                  *inv_ref, dx_ref)):
        assert _rel(got, want) < 1e-4
    assert _rel(ba_core.block_diag_embed(bk.hcc), ref_core.block_diag_embed(
        jnp.asarray(bk_ref.hcc))) == 0.0


def test_landmark_inverses_on_well_conditioned_blocks():
    """Damped, projected landmark inverses on random SPD blocks (every
    direction observable, so the blocks are well conditioned): 1e-5
    relative; inactive landmarks get zero. On the problem's own blocks the
    projector is held above, and the inverses are not compared: there every
    point block has a cut direction (see the module docstring)."""
    rng = np.random.default_rng(11)
    p, l, k = 32, 16, 4
    hpp = 1e3 * _spd(rng, p, 3)
    hll = 1e3 * _spd(rng, l, 6)
    z = lambda *shape: np.zeros(shape, np.float32)  # noqa: E731
    fields = dict(hcc=z(k, 6, 6), bc=z(k, 6), hpp=hpp, bp=z(p, 3),
                  hcl_p=z(p, k, 6, 3), hll=hll, bl=z(l, 6), hcl_l=z(l, k, 6, 6),
                  pt_act=rng.random(p) < 0.8, ln_act=rng.random(l) < 0.8,
                  err_sum=np.float32(0), err_cnt=np.float32(0))
    bk_ref = ref_core.BABlocks(**{n: jnp.asarray(v) for n, v in fields.items()})
    bk = ba_core.BABlocks(**{n: _t(v) for n, v in fields.items()})
    for lam in (1e-3, 10.0):
        for got, want in zip(ba_core.landmark_inverses(bk, torch.tensor(lam)),
                             ref_core.landmark_inverses(bk_ref, lam)):
            assert _rel(got, want) < 1e-5
    hpp_inv, hll_inv = ba_core.landmark_inverses(bk, torch.tensor(1e-3))
    assert not hpp_inv[~bk.pt_act].any() and not hll_inv[~bk.ln_act].any()


@pytest.fixture(scope="module")
def solved():
    out = {}
    for noise in (0.0, 0.3):
        c = _case(noise)
        with jax.enable_x64(True):
            prob64 = jax.tree.map(lambda x: jnp.asarray(
                x.astype(np.float64) if x.dtype == np.float32 else x),
                jax.tree.map(np.asarray, c["prob_ref"]))
            c["ref"] = jax.tree.map(np.asarray, ref_ba.solve_ba(c["cam_ref"], prob64))
        c["port"] = ba.solve_ba(c["cam"], c["prob"])
        out[noise] = c
    return out


def _pose_err(gt, est):
    rel = np.linalg.inv(gt) @ est
    return float(np.linalg.norm(se3.logmap_se3(torch.from_numpy(
        rel.astype(np.float32))).numpy()))


@pytest.mark.parametrize("gate", ["reduces_error", "recovers_poses", "gauge_fixed",
                                  "noisy_converges"])
def test_solve_ba_reference_gates(solved, gate):
    """The gates of tests/test_ba.py, on the port's solve."""
    c = solved[0.3 if gate == "noisy_converges" else 0.0]
    res, prob = c["port"], c["prob"]
    if gate == "reduces_error":
        t_cw0 = se3.inverse_se3(prob.kf_pose)
        err0 = float(ba._total_error(c["cam"], t_cw0, prob, prob.pt_pos,
                                     prob.ln_sp, prob.ln_ep))
        assert float(res.err) < err0 * 0.05
    elif gate == "gauge_fixed":
        np.testing.assert_allclose(res.kf_pose[0].numpy(), prob.kf_pose[0].numpy(),
                                   atol=1e-6)
    else:
        bound = 5e-2 if gate == "noisy_converges" else 5e-3
        est = res.kf_pose.numpy()
        for i in range(len(c["gt"])):
            assert _pose_err(c["gt"][i], est[i]) < bound, i


def test_solve_ba_marks_outlier_observation():
    c = _case()
    uv = c["prob"].po_uv.clone()
    uv[3] += 50.0
    res = ba.solve_ba(c["cam"], c["prob"]._replace(po_uv=uv))
    assert not bool(res.po_inlier[3])
    assert res.po_inlier[c["prob"].po_valid].float().mean() > 0.9


def test_finish_with_global_ba():
    """tests/test_global_ba_ckpt.py::test_finish_with_global_ba on the port:
    ``finish(run_global_ba=True)`` solves the whole 6-frame map densely,
    leaves every keyframe finite and moves none by 0.5 or more, and the
    keyframes stay within 0.08 m ATE of the ground truth."""
    from gfplslam_torch.config import CapacityParams, Config, OrbParams
    from gfplslam_torch.io import synthetic
    from gfplslam_torch.models.slam import SLAMSystem
    from gfplslam_torch.utils.trajectory import ate_rmse
    cfg = Config(cap=CapacityParams(n_pt=256, n_ln=128, n_kf_window=4, n_kf_max=16,
                                    n_map_pt=2048, n_map_ln=512, n_obs_pt=1024,
                                    n_obs_ln=256, vocab_k=64),
                 orb=OrbParams(nlevels=2),
                 camera=CameraParams(width=376, height=240, fx=217.6, fy=217.6,
                                     cx=183.7, cy=126.1, baseline=0.11))
    world = synthetic.make_world(n_frames=6, n_points=300, n_lines=40, seed=21)
    slam = SLAMSystem(cfg, device=CPU, run_loop_closure=False)
    for i in range(6):
        slam.process(*synthetic.render_frame(world, i, noise=1.0), world.timestamps[i])
    before = slam.keyframe_trajectory.copy()
    assert len(before) >= 2
    slam.finish(run_global_ba=True)
    after = slam.keyframe_trajectory
    assert np.all(np.isfinite(after))
    assert np.abs(after - before).max() < 0.5
    assert ate_rmse(after, world.poses[slam.kf_frame_ids]) < 0.08


def test_solve_ba_agrees_with_reference(solved):
    """Poses within 1e-2 of the reference's f64 solve, and the final error
    within 1e-3 relative (measured 1.3e-4 and 3.3e-5); both converge within
    the iteration budget (see the module docstring); line inlier marks
    equal, point marks on >= 95% of the observations (measured: 100%)."""
    for c in solved.values():
        ref, res = c["ref"], c["port"]
        assert ref.kf_pose.dtype == np.float64
        assert np.abs(res.kf_pose.numpy() - ref.kf_pose).max() < 1e-2
        assert abs(float(res.err) - float(ref.err)) < 1e-3 * float(ref.err)
        assert int(res.iters) < 20 and int(ref.iters) < 20
        np.testing.assert_array_equal(res.lo_inlier.numpy(), ref.lo_inlier)
        valid = np.asarray(c["prob_ref"].po_valid)
        agree = (res.po_inlier.numpy() == ref.po_inlier)[valid].mean()
        assert agree >= 0.95, agree
