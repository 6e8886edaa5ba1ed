"""Pose-only robust Gauss-Newton over point + line reprojection residuals.

Port of ``gfplslam_tpu/models/pose_opt.py`` (the reference's two-stage
solver, stereoFrameHandler.cpp:1939-2245):

- point residual  r = || project(DT * P) - pl_obs ||
- line residual   r = || (l . proj(DT*sP), l . proj(DT*eP)) ||
- robust weight   w = 1 / (1 + r^2 sigma^2)
- update          H dx = g ;  DT <- DT * exp(dx)^-1,  DT_cov = H^-1

The GN loop is unrolled with masked updates (no host read per iteration),
and the 6x6 step is a pivoted LU solve: f32 Hessians at fx^2 scale are often
indefinite by round-off, which breaks an unpivoted Cholesky.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gfplslam_torch.config import CameraParams, OptimizerParams
from gfplslam_torch.ops.camera import project
from gfplslam_torch.utils import se3
from gfplslam_torch.utils.robust import masked_stdv_mad


class PointMatches(NamedTuple):
    """Cross-frame point matches."""
    p3d: torch.Tensor     # [N, 3] 3D point in previous camera frame
    obs: torch.Tensor     # [N, 2] observed pixel in current frame
    sigma2: torch.Tensor  # [N] residual information scale
    valid: torch.Tensor   # [N] bool


class LineMatches(NamedTuple):
    """Cross-frame line matches."""
    sp3d: torch.Tensor    # [M, 3] start endpoint, previous frame
    ep3d: torch.Tensor    # [M, 3] end endpoint, previous frame
    le_obs: torch.Tensor  # [M, 3] normalized 2D line coefficients in current
    sigma2: torch.Tensor  # [M]
    valid: torch.Tensor   # [M] bool


class PoseResult(NamedTuple):
    dt: torch.Tensor          # [4, 4] optimized relative pose (T_curr<-prev)
    dt_cov: torch.Tensor      # [6, 6]
    err: torch.Tensor         # scalar normalized error (-1 on fallback)
    accepted: torch.Tensor    # bool: accepted (not the identity fallback)
    pt_inlier: torch.Tensor   # [N] bool final point inlier mask
    ln_inlier: torch.Tensor   # [M] bool final line inlier mask


def _transform(dt: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return (dt[:3, :3] @ p[:, :, None])[:, :, 0] + dt[:3, 3]


def twist_jac(cam: CameraParams, pc: torch.Tensor, lx: torch.Tensor,
              ly: torch.Tensor, homog_th: float) -> torch.Tensor:
    """[N, 6] d(l . proj(p))/d(twist) at camera-frame points ``pc``: the
    closed form shared by the point and line residuals and the line cutter
    (stereoFrameHandler.cpp:2131-2215)."""
    gx, gy, gz = pc[:, 0], pc[:, 1], pc[:, 2]
    fgz2 = cam.fx / torch.clamp(gz * gz, min=homog_th)
    return torch.stack([
        fgz2 * lx * gz,
        fgz2 * ly * gz,
        -fgz2 * (gx * lx + gy * ly),
        -fgz2 * (gx * gy * lx + gy * gy * ly + gz * gz * ly),
        fgz2 * (gx * gx * lx + gz * gz * lx + gx * gy * ly),
        fgz2 * (gx * gz * ly - gy * gz * lx),
    ], -1)


def _point_terms(cam: CameraParams, dt: torch.Tensor, pts: PointMatches,
                 homog_th: float):
    """Per-point (J [N,6], r [N], w [N]) of the scalarized residual."""
    pc = _transform(dt, pts.p3d)
    err = project(cam, pc) - pts.obs
    r = torch.sqrt(err[:, 0] ** 2 + err[:, 1] ** 2)
    j = (twist_jac(cam, pc, err[:, 0], err[:, 1], homog_th)
         / torch.clamp(r, min=homog_th)[:, None])
    w = 1.0 / (1.0 + r * r * pts.sigma2)
    return j, r, w


def _line_terms(cam: CameraParams, dt: torch.Tensor, lns: LineMatches,
                homog_th: float):
    """Per-line (J [M,6], r [M], w [M])."""
    spc = _transform(dt, lns.sp3d)
    epc = _transform(dt, lns.ep3d)
    sproj, eproj = project(cam, spc), project(cam, epc)
    lx, ly, lz = lns.le_obs[:, 0], lns.le_obs[:, 1], lns.le_obs[:, 2]
    ds = lx * sproj[:, 0] + ly * sproj[:, 1] + lz
    de = lx * eproj[:, 0] + ly * eproj[:, 1] + lz
    r = torch.sqrt(ds * ds + de * de)
    js = twist_jac(cam, spc, lx, ly, homog_th)
    je = twist_jac(cam, epc, lx, ly, homog_th)
    j = (js * ds[:, None] + je * de[:, None]) / torch.clamp(r, min=homog_th)[:, None]
    w = 1.0 / (1.0 + r * r * lns.sigma2)
    return j, r, w


def build_normal_equations(cam: CameraParams, dt: torch.Tensor,
                           pts: PointMatches, lns: LineMatches,
                           homog_th: float = 1e-7):
    """Masked H (6x6), g (6), normalized error."""
    jp, rp, wp = _point_terms(cam, dt, pts, homog_th)
    jl, rl, wl = _line_terms(cam, dt, lns, homog_th)
    mp = pts.valid.to(jp.dtype)
    ml = lns.valid.to(jl.dtype)
    h = (torch.einsum("ni,nj,n->ij", jp, jp, wp * mp)
         + torch.einsum("ni,nj,n->ij", jl, jl, wl * ml))
    g = (torch.einsum("ni,n->i", jp, rp * wp * mp)
         + torch.einsum("ni,n->i", jl, rl * wl * ml))
    n = mp.sum() + ml.sum()
    e = ((rp * rp * wp * mp).sum() + (rl * rl * wl * ml).sum()) / torch.clamp(n, min=1.0)
    return h, g, e


def gauss_newton(cam: CameraParams, dt0: torch.Tensor, pts: PointMatches,
                 lns: LineMatches, opt: OptimizerParams, max_iters: int):
    """GN with early stop (gaussNewtonOptimization, :2032-2056), unrolled
    with masked updates: converged iterations are no-ops under ``done``."""
    eye6 = torch.eye(6, dtype=dt0.dtype, device=dt0.device)
    dt = dt0
    err_prev = torch.full((), 1e9, dtype=dt0.dtype, device=dt0.device)
    done = torch.zeros((), dtype=torch.bool, device=dt0.device)
    for _ in range(max_iters):
        h, g, err = build_normal_equations(cam, dt, pts, lns, opt.homog_th)
        stop = (torch.abs(err - err_prev) < opt.min_error_change) | (err < opt.min_error)
        # pivoted LU; solve_ex never raises on a singular H (the is_finite
        # gates downstream catch it) and never syncs with the host
        dx = torch.linalg.solve_ex(h + 1e-12 * eye6, g)[0]
        new_dt = dt @ se3.inverse_se3(se3.expmap_se3(dx))
        small = torch.sqrt((dx * dx).sum()) < 1e-7
        dt = torch.where(done | stop, dt, new_dt)
        err_prev = torch.where(done, err_prev, err)
        done = done | stop | small
    h, g, err = build_normal_equations(cam, dt, pts, lns, opt.homog_th)
    cov = torch.linalg.inv_ex(h + 1e-12 * eye6)[0]
    return dt, cov, err


def remove_outliers(cam: CameraParams, dt: torch.Tensor, pts: PointMatches,
                    lns: LineMatches, inlier_k: float):
    """MAD residual gate per family (removeOutliers, :2058-2116)."""
    _, rp, _ = _point_terms(cam, dt, pts, 1e-7)
    _, rl, _ = _line_terms(cam, dt, lns, 1e-7)
    rp = rp * torch.sqrt(pts.sigma2)
    rl = rl * torch.sqrt(lns.sigma2)
    th_p = inlier_k * masked_stdv_mad(rp, pts.valid)
    th_l = inlier_k * masked_stdv_mad(rl, lns.valid)
    return (pts.valid & (rp <= th_p)), (lns.valid & (rl <= th_l))


def optimize_pose(cam: CameraParams, dt_ini: torch.Tensor, pts: PointMatches,
                  lns: LineMatches, opt: OptimizerParams,
                  delta_t=1.0 / 20.0) -> PoseResult:
    """Two-stage robust pose solve (optimizePose, :1939-2030): stage 1 on all
    matches, MAD outlier strip, stage 2 from DT_ini on the inliers, then the
    finite checks and the motion-step gate decide between the estimate and
    the identity fallback."""
    eye4 = torch.eye(4, dtype=dt_ini.dtype, device=dt_ini.device)
    enough = (pts.valid.sum() + lns.valid.sum()) > opt.min_features

    dt1, _, _ = gauss_newton(cam, dt_ini, pts, lns, opt, opt.max_iters)
    stage1_ok = se3.is_finite(dt1) & enough
    pt_in, ln_in = remove_outliers(cam, dt1, pts, lns, opt.inlier_k)
    pt_in = torch.where(stage1_ok, pt_in, pts.valid)
    ln_in = torch.where(stage1_ok, ln_in, lns.valid)
    enough2 = (pt_in.sum() + ln_in.sum()) > opt.min_features

    dt2, cov2, err2 = gauss_newton(cam, dt_ini, pts._replace(valid=pt_in),
                                   lns._replace(valid=ln_in), opt,
                                   opt.max_iters_ref)
    ok = stage1_ok & enough2 & se3.is_finite(dt2) & se3.is_finite(cov2)
    dt_est = torch.where(ok, dt2, eye4)
    cov = torch.where(ok, cov2, torch.zeros_like(cov2))

    # motion-step sanity gate (:1984-2012)
    t_inv = se3.inverse_se3(dt_est)[:3, 3]
    trans = torch.sqrt((t_inv * t_inv).sum())
    step_ok = trans < opt.motion_step_th * torch.as_tensor(
        delta_t, dtype=dt_ini.dtype, device=dt_ini.device)
    accepted = ok & step_ok
    return PoseResult(dt=torch.where(accepted, dt_est, eye4), dt_cov=cov,
                      err=torch.where(accepted, err2, torch.full_like(err2, -1.0)),
                      accepted=accepted, pt_inlier=pt_in, ln_inlier=ln_in)
