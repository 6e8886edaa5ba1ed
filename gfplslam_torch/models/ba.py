"""Sliding-window bundle adjustment via Schur complement, batched LM.

Port of ``gfplslam_tpu/models/ba.py`` (localBundleAdjustment /
levMarquardtOptimizationLBA, mapHandler.cpp:1108-1838): Levenberg-Marquardt
over window keyframe poses + point landmarks (3-dof) + line landmarks (two
3-dof endpoints), robust weight 1/(1+r^2 sigma^2), lambda *=/= k schedule,
post-BA outlier marking.

The reference's ``lax.while_loop`` is a loop of exactly ``max_iters``
iterations here, in which an ``active`` mask (not yet converged) freezes
the state with ``torch.where`` once the reference would have stopped: the
same result, and no host read of the convergence flag.

Pose convention: ``kf_pose`` is cam->world; the solver perturbs the inverse
(world->cam) on the left: T_cw <- exp(dx) T_cw. Twist ordering [rho, phi].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gfplslam_torch.config import CameraParams
from gfplslam_torch.models import ba_core
from gfplslam_torch.utils import se3


class BAProblem(NamedTuple):
    """Padded BA window. K keyframes, P points, L lines, Op/Ol observations."""
    kf_pose: torch.Tensor    # [K, 4, 4] cam->world
    kf_free: torch.Tensor    # [K] bool — optimized (False = gauge/frozen)
    kf_valid: torch.Tensor   # [K] bool — participates at all
    pt_pos: torch.Tensor     # [P, 3] world
    pt_valid: torch.Tensor   # [P] bool
    ln_sp: torch.Tensor      # [L, 3] world
    ln_ep: torch.Tensor      # [L, 3]
    ln_valid: torch.Tensor   # [L] bool
    po_kf: torch.Tensor      # [Op] int32 window-kf slot per point obs
    po_lm: torch.Tensor      # [Op] int32 point-landmark slot
    po_uv: torch.Tensor      # [Op, 2] observed pixel
    po_sigma2: torch.Tensor  # [Op]
    po_valid: torch.Tensor   # [Op] bool
    lo_kf: torch.Tensor      # [Ol] int32
    lo_lm: torch.Tensor      # [Ol] int32
    lo_le: torch.Tensor      # [Ol, 3] observed 2D line coefficients
    lo_sigma2: torch.Tensor  # [Ol]
    lo_valid: torch.Tensor   # [Ol] bool


class BAResult(NamedTuple):
    kf_pose: torch.Tensor
    pt_pos: torch.Tensor
    ln_sp: torch.Tensor
    ln_ep: torch.Tensor
    err: torch.Tensor        # final mean robust error
    iters: torch.Tensor      # int32 LM iterations run
    po_inlier: torch.Tensor  # [Op] bool post-BA outlier marking
    lo_inlier: torch.Tensor  # [Ol] bool


def _to_cam(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[N, 4, 4] world->cam transforms applied to [N, 3] points."""
    return (t[:, :3, :3] @ x[:, :, None])[:, :, 0] + t[:, :3, 3]


def _project_jac(cam: CameraParams, pc: torch.Tensor):
    """Pixel projection [N, 2] and d proj / d pc [N, 2, 3]."""
    z = torch.where(torch.abs(pc[:, 2]) < 1e-9, 1e-9, pc[:, 2])
    iz = 1.0 / z
    proj = torch.stack([cam.fx * pc[:, 0] * iz + cam.cx,
                        cam.fy * pc[:, 1] * iz + cam.cy], -1)
    zero = 0.0 * iz
    j_proj = torch.stack([
        torch.stack([cam.fx * iz, zero, -cam.fx * pc[:, 0] * iz * iz], -1),
        torch.stack([zero, cam.fy * iz, -cam.fy * pc[:, 1] * iz * iz], -1),
    ], -2)
    return proj, j_proj


def _dpc_dtwist(pc: torch.Tensor) -> torch.Tensor:
    """d pc / d twist = [I | -skew(pc)] for T_cw <- exp(dx) T_cw, [N, 3, 6]."""
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[0], 3, 3)
    return torch.cat([eye, -se3.skew(pc)], -1)


def _point_residuals(cam: CameraParams, t_cw: torch.Tensor, prob: BAProblem,
                     pt_pos: torch.Tensor):
    """Per point-obs: residual [2], J_pose [2,6], J_lm [2,3], weight."""
    t = t_cw[prob.po_kf]
    pc = _to_cam(t, pt_pos[prob.po_lm])
    proj, j_proj = _project_jac(cam, pc)
    r = proj - prob.po_uv
    j_pose = j_proj @ _dpc_dtwist(pc)
    j_lm = j_proj @ t[:, :3, :3]
    w = 1.0 / (1.0 + (r * r).sum(-1) * prob.po_sigma2)
    return r, j_pose, j_lm, w


def _line_residuals(cam: CameraParams, t_cw: torch.Tensor, prob: BAProblem,
                    ln_sp: torch.Tensor, ln_ep: torch.Tensor):
    """Per line-obs: residual [2] (signed endpoint-line distances),
    J_pose [2,6], J_sp [2,3], J_ep [2,3], weight."""
    t = t_cw[prob.lo_kf]
    le = prob.lo_le
    j_uv = le[:, :2]                                     # d r / d proj

    def endpoint(xw):
        pc = _to_cam(t, xw)
        proj, j_proj = _project_jac(cam, pc)
        r = le[:, 0] * proj[:, 0] + le[:, 1] * proj[:, 1] + le[:, 2]
        j_pose = torch.einsum("ni,nij->nj", j_uv, j_proj @ _dpc_dtwist(pc))
        j_lm = torch.einsum("ni,nij->nj", j_uv, j_proj @ t[:, :3, :3])
        return r, j_pose, j_lm

    rs, jps, jls = endpoint(ln_sp[prob.lo_lm])
    re, jpe, jle = endpoint(ln_ep[prob.lo_lm])
    r = torch.stack([rs, re], -1)
    j_pose = torch.stack([jps, jpe], 1)                  # [Ol, 2, 6]
    zero = torch.zeros_like(jls)
    j_sp = torch.stack([jls, zero], 1)                   # [Ol, 2, 3]
    j_ep = torch.stack([zero, jle], 1)
    w = 1.0 / (1.0 + (r * r).sum(-1) * prob.lo_sigma2)
    return r, j_pose, j_sp, j_ep, w


def _pixel(cam: CameraParams, pc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    z = torch.where(torch.abs(pc[:, 2]) < 1e-9, 1e-9, pc[:, 2])
    return cam.fx * pc[:, 0] / z + cam.cx, cam.fy * pc[:, 1] / z + cam.cy


def _point_chi2(cam: CameraParams, t_cw: torch.Tensor, prob: BAProblem,
                pt_pos: torch.Tensor) -> torch.Tensor:
    """Per point-obs squared reprojection error [Op] (no Jacobians)."""
    u, v = _pixel(cam, _to_cam(t_cw[prob.po_kf], pt_pos[prob.po_lm]))
    du = u - prob.po_uv[:, 0]
    dv = v - prob.po_uv[:, 1]
    return du * du + dv * dv


def _line_chi2(cam: CameraParams, t_cw: torch.Tensor, prob: BAProblem,
               ln_sp: torch.Tensor, ln_ep: torch.Tensor) -> torch.Tensor:
    """Per line-obs squared endpoint-to-line error [Ol]."""
    t = t_cw[prob.lo_kf]
    le = prob.lo_le

    def ep_err(xw):
        u, v = _pixel(cam, _to_cam(t, xw))
        return le[:, 0] * u + le[:, 1] * v + le[:, 2]

    rs = ep_err(ln_sp[prob.lo_lm])
    re = ep_err(ln_ep[prob.lo_lm])
    return rs * rs + re * re


def _total_error(cam, t_cw, prob, pt_pos, ln_sp, ln_ep):
    rp, _, _, wp = _point_residuals(cam, t_cw, prob, pt_pos)
    rl, _, _, _, wl = _line_residuals(cam, t_cw, prob, ln_sp, ln_ep)
    ep = torch.where(prob.po_valid, (rp * rp).sum(-1) * wp, 0.0).sum()
    el = torch.where(prob.lo_valid, (rl * rl).sum(-1) * wl, 0.0).sum()
    n = prob.po_valid.sum() + prob.lo_valid.sum()
    return (ep + el) / torch.clamp(n, min=1)


def _no_sum(x: torch.Tensor) -> torch.Tensor:
    return x


def solve_ba(cam: CameraParams, prob: BAProblem, lambda0: float = 1e-3,
             lambda_k: float = 10.0, max_iters: int = 20,
             inlier_chi2: float = 7.815, tol: float = 1e-5, *,
             sel=None, psum=_no_sum) -> BAResult:
    """LM loop with Schur-complement camera solve.

    lambda schedule and iteration budget mirror lambda_lba_lm/_k and
    max_iters_lba (config.cpp:55-57, mapHandler.cpp:1654-1678). After
    convergence, observations with robust chi2 above ``inlier_chi2`` are
    marked outliers (the reference's post-BA marking, :1714-1836).
    Runs ``max_iters`` iterations; once converged they change nothing.

    ``sel`` and ``psum`` serve the landmark-sharded solver
    (``parallel/dist_ba.py``): the selectors of the shard's own landmark
    ids, and the sum over ranks of the robust error's two parts and of the
    reduced camera system (the reference's ``psum``s). The defaults solve
    ``prob`` alone."""
    dev = prob.kf_pose.device
    t_cw0 = se3.inverse_se3(prob.kf_pose)
    if sel is None:
        sel = ba_core.make_selectors(prob)
    kf_opt = prob.kf_free & prob.kf_valid

    def build_blocks(t_cw, pt_pos, ln_sp, ln_ep):
        bk = ba_core.build_blocks(cam, prob, sel, _point_residuals,
                                  _line_residuals, t_cw, pt_pos, ln_sp, ln_ep)
        err_sum, err_cnt = psum(torch.stack([bk.err_sum, bk.err_cnt]))
        return bk, err_sum / torch.clamp(err_cnt, min=1.0)

    def solve_with_lam(bk, t_cw, pt_pos, ln_sp, ln_ep, lam):
        """Damped Schur solve + retraction + per-landmark acceptance."""
        hpp_inv, hll_inv = ba_core.landmark_inverses(bk, lam)
        s_local, rhs_local = ba_core.schur_reduce(bk, hpp_inv, hll_inv)
        k6 = s_local.shape[0]
        s_rhs = psum(torch.cat([s_local, rhs_local.reshape(k6, 1)], 1))
        s_full, rhs = s_rhs[:, :k6], s_rhs[:, k6].reshape(rhs_local.shape)
        dx_cam = ba_core.camera_solve(s_full, rhs, kf_opt, lam)
        dx_pt, dx_ln = ba_core.back_substitute(bk, hpp_inv, hll_inv, dx_cam)
        t_new, pt_new, sp_new, ep_new = ba_core.retract(
            bk, t_cw, pt_pos, ln_sp, ln_ep, dx_cam, dx_pt, dx_ln)
        pt_fin, sp_fin, ep_fin = ba_core.accept_landmarks(
            sel, prob,
            _point_chi2(cam, t_new, prob, pt_pos),
            _point_chi2(cam, t_new, prob, pt_new),
            _line_chi2(cam, t_new, prob, ln_sp, ln_ep),
            _line_chi2(cam, t_new, prob, sp_new, ep_new),
            pt_pos, pt_new, ln_sp, sp_new, ln_ep, ep_new)
        return t_new, pt_fin, sp_fin, ep_fin

    x = (t_cw0, prob.pt_pos, prob.ln_sp, prob.ln_ep)
    bk, err = build_blocks(*x)
    lam = torch.tensor(lambda0, dtype=torch.float32, device=dev)
    iters = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(max_iters):
        cand = solve_with_lam(bk, *x, lam)
        bk_cand, new_err = build_blocks(*cand)
        active = ~done
        improve = new_err < err
        take = active & improve
        # lambda schedule (:1661-1678)
        lam = torch.where(active, torch.where(improve, lam / lambda_k,
                                              lam * lambda_k), lam)
        x = tuple(torch.where(take, c, o) for c, o in zip(cand, x))
        bk = ba_core.BABlocks(*(torch.where(take, c, o)
                                for c, o in zip(bk_cand, bk)))
        conv = improve & (err - new_err < tol * torch.clamp(new_err, min=1e-12))
        err = torch.where(take, new_err, err)
        iters = iters + active.to(torch.int32)
        done = done | conv
    t_cw, pt_pos, ln_sp, ln_ep = x

    # post-BA outlier marking by chi2 (:1714-1836)
    rp, _, _, _ = _point_residuals(cam, t_cw, prob, pt_pos)
    rl, _, _, _, _ = _line_residuals(cam, t_cw, prob, ln_sp, ln_ep)
    po_in = prob.po_valid & ((rp * rp).sum(-1) * prob.po_sigma2 < inlier_chi2)
    lo_in = prob.lo_valid & ((rl * rl).sum(-1) * prob.lo_sigma2 < inlier_chi2)
    return BAResult(kf_pose=se3.inverse_se3(t_cw), pt_pos=pt_pos, ln_sp=ln_sp,
                    ln_ep=ln_ep, err=err, iters=iters, po_inlier=po_in,
                    lo_inlier=lo_in)
