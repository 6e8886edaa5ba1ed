"""Good-line-cutting preconditioner: information-maximizing sub-segment
selection, all lines in parallel.

Port of ``gfplslam_tpu/models/linecut.py`` (the reference's
``estimateProjUncertainty_submodular``, stereoFrameHandler.cpp:1342-1764):
per matched line, cut ratios (r0, r1) on a 0.05 grid with r0 + r1 <= 1 that
maximize the log-volume (or min eigenvalue) of the summed 6x6 pose
information. Every line takes a coordinate-ascent step per iteration
against the shared total; candidates are scored by a rank-4 determinant
lemma against one Cholesky of the total. The loop is unrolled with a masked
"improved" flag, so no iteration reads the device from the host.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from gfplslam_torch.config import CameraParams
from gfplslam_torch.models.pose_opt import LineMatches, PointMatches, twist_jac

# 8-neighborhood on the (r0, r1) grid (:1624-1633)
_NEIGHBOR_STEPS = np.array([
    [1, 0], [-1, 0], [0, 1], [0, -1],
    [1, 1], [1, -1], [-1, 1], [-1, -1],
], dtype=np.float32)


def _proj_jac(cam: CameraParams, p: torch.Tensor) -> torch.Tensor:
    """[..., 3] camera-frame points -> [..., 2, 3] d(u,v)/d(X,Y,Z) pinhole
    Jacobians (getJacob3D_2D)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    iz = 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    iz2 = iz * iz
    zero = 0.0 * iz
    return torch.stack([
        torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2], -1),
        torch.stack([zero, cam.fy * iz, -cam.fy * y * iz2], -1),
    ], -2)


def _residual_jac(cam: CameraParams, p: torch.Tensor, lx: torch.Tensor,
                  ly: torch.Tensor, homog_th: float = 1e-7) -> torch.Tensor:
    """[..., 6] d(l . proj(p))/d(twist) (shared with the pose solver)."""
    return twist_jac(cam, p, lx, ly, homog_th)


def endpoint_info(cam: CameraParams, dt: torch.Tensor, p_prev: torch.Tensor,
                  cov_p: torch.Tensor, le_obs: torch.Tensor):
    """One endpoint's residual Jacobian [..., 6] and scalar residual
    variance [...]: the point [..., 3] and its covariance [..., 3, 3]
    carried into the current frame by ``dt`` and projected onto the
    observed line's normal (getPoseInfoOnLine, :1342-1411)."""
    rot = dt[:3, :3]
    pc = (rot @ p_prev[..., :, None])[..., 0] + dt[:3, 3]
    a = _proj_jac(cam, pc) @ rot                              # [..., 2, 3]
    cov_uv = a @ cov_p @ a.transpose(-1, -2)                  # [..., 2, 2]
    j_loss = le_obs[..., :2]
    cov_r = ((j_loss[..., None, :] @ cov_uv)[..., 0, :] * j_loss).sum(-1)
    return _residual_jac(cam, pc, le_obs[..., 0], le_obs[..., 1]), cov_r


def line_info_factors(cam: CameraParams, dt: torch.Tensor, sp3d: torch.Tensor,
                      ep3d: torch.Tensor, cov_s: torch.Tensor,
                      cov_e: torch.Tensor, le_obs: torch.Tensor,
                      r0: torch.Tensor, r1: torch.Tensor):
    """Rank-2 factors of a cut line's pose information, for one line or a
    batch of them (any leading shape, broadcast with the ratios ``r0``,
    ``r1``): info = J diag(d) J^T with J [..., 6, 2] = [j_start, j_end]
    and d [..., 2] the inverse residual variances (getPoseInfoOnLine,
    :1342-1411)."""
    r0v, r1v = r0[..., None], r1[..., None]
    sp = (1 - r0v) * sp3d + r0v * ep3d
    ep = (1 - r1v) * ep3d + r1v * sp3d
    r0m, r1m = r0v[..., None], r1v[..., None]
    cov_sp = (1 - r0m) ** 2 * cov_s + r0m ** 2 * cov_e
    cov_ep = (1 - r1m) ** 2 * cov_e + r1m ** 2 * cov_s
    js, cs = endpoint_info(cam, dt, sp, cov_sp, le_obs)
    je, ce = endpoint_info(cam, dt, ep, cov_ep, le_obs)
    d = torch.stack([1.0 / torch.clamp(cs, min=1e-12),
                     1.0 / torch.clamp(ce, min=1e-12)], -1)
    return torch.stack([js, je], -1), d


def pose_info_line(cam: CameraParams, dt: torch.Tensor, sp3d: torch.Tensor,
                   ep3d: torch.Tensor, cov_s: torch.Tensor,
                   cov_e: torch.Tensor, le_obs: torch.Tensor,
                   r0: torch.Tensor, r1: torch.Tensor) -> torch.Tensor:
    """[..., 6, 6] pose information of a cut line (getPoseInfoOnLine,
    :1342-1411). ``dt`` is T_curr<-prev (the reference's DT_inv); the
    endpoints and covariances are interpolated by the cut ratios before
    transport."""
    j, d = line_info_factors(cam, dt, sp3d, ep3d, cov_s, cov_e, le_obs, r0, r1)
    return (j * d[..., None, :]) @ j.transpose(-1, -2)


def line_info_factors_batch(cam: CameraParams, dt: torch.Tensor,
                            sp3d: torch.Tensor, ep3d: torch.Tensor,
                            cov_s: torch.Tensor, cov_e: torch.Tensor,
                            le_obs: torch.Tensor, r0: torch.Tensor,
                            r1: torch.Tensor):
    """Rank-2 factors of each cut line's pose information over a flat batch
    [B]: info = J diag(d) J^T with J [B, 6, 2] = [j_start, j_end] and d [B, 2]
    the inverse residual variances (getPoseInfoOnLine, :1342-1411), written
    per component."""
    rot = dt[:3, :3]
    tr = dt[:3, 3]
    lx, ly = le_obs[:, 0], le_obs[:, 1]

    def lerp3(a, b, r):
        return [(1 - r) * a[:, k] + r * b[:, k] for k in range(3)]

    def cov_mix(ca, cb, ra, rb):
        # (1-ra)^2 * ca + rb^2 * cb, as the 6 unique symmetric components
        wa, wb = (1 - ra) ** 2, rb ** 2
        return {k: wa * ca[:, i, j] + wb * cb[:, i, j]
                for k, (i, j) in (("00", (0, 0)), ("01", (0, 1)),
                                  ("02", (0, 2)), ("11", (1, 1)),
                                  ("12", (1, 2)), ("22", (2, 2)))}

    def endpoint(p, c):
        x = rot[0, 0] * p[0] + rot[0, 1] * p[1] + rot[0, 2] * p[2] + tr[0]
        y = rot[1, 0] * p[0] + rot[1, 1] * p[1] + rot[1, 2] * p[2] + tr[1]
        z = rot[2, 0] * p[0] + rot[2, 1] * p[1] + rot[2, 2] * p[2] + tr[2]
        iz = 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
        iz2 = iz * iz
        # b = (l . J_proj) @ rot, components b_m = lx*a0m + ly*a1m
        b = [lx * (cam.fx * iz * rot[0, m] - cam.fx * x * iz2 * rot[2, m])
             + ly * (cam.fy * iz * rot[1, m] - cam.fy * y * iz2 * rot[2, m])
             for m in range(3)]
        cov_r = (b[0] * b[0] * c["00"] + b[1] * b[1] * c["11"]
                 + b[2] * b[2] * c["22"]
                 + 2.0 * (b[0] * b[1] * c["01"] + b[0] * b[2] * c["02"]
                          + b[1] * b[2] * c["12"]))
        fgz2 = cam.fx / torch.clamp(z * z, min=1e-7)
        j = [fgz2 * lx * z,
             fgz2 * ly * z,
             -fgz2 * (x * lx + y * ly),
             -fgz2 * (x * y * lx + y * y * ly + z * z * ly),
             fgz2 * (x * x * lx + z * z * lx + x * y * ly),
             fgz2 * (x * z * ly - y * z * lx)]
        return j, cov_r

    js, cs = endpoint(lerp3(sp3d, ep3d, r0), cov_mix(cov_s, cov_e, r0, r0))
    je, ce = endpoint(lerp3(ep3d, sp3d, r1), cov_mix(cov_e, cov_s, r1, r1))
    d = torch.stack([1.0 / torch.clamp(cs, min=1e-12),
                     1.0 / torch.clamp(ce, min=1e-12)], -1)
    j = torch.stack([torch.stack(js, -1), torch.stack(je, -1)], -1)
    return j, d


def pose_info_point(cam: CameraParams, dt: torch.Tensor, p3d: torch.Tensor,
                    obs: torch.Tensor) -> torch.Tensor:
    """[N, 6, 6] pose information of each point (getPoseInfoPoint,
    :1414-1447)."""
    pc = (dt[:3, :3] @ p3d[:, :, None])[:, :, 0] + dt[:3, 3]
    z = pc[:, 2]
    iz = 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    err = torch.stack([cam.fx * pc[:, 0] * iz + cam.cx,
                       cam.fy * pc[:, 1] * iz + cam.cy], -1) - obs
    j = twist_jac(cam, pc, err[:, 0], err[:, 1], 1e-7)
    r = torch.sqrt(err[:, 0] ** 2 + err[:, 1] ** 2)
    j = j / torch.clamp(r, min=1e-7)[:, None]
    return j[:, :, None] * j[:, None, :] * (r * r)[:, None, None]


def _det4(m: torch.Tensor) -> torch.Tensor:
    """Explicit 4x4 determinant by cofactor expansion on 2x2 minors."""
    a, b, c, d = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2], m[..., 0, 3]
    e, f, g, h = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2], m[..., 1, 3]
    i, j, k, l = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2], m[..., 2, 3]
    mm, n, o, p = m[..., 3, 0], m[..., 3, 1], m[..., 3, 2], m[..., 3, 3]
    kp_lo = k * p - l * o
    jp_ln = j * p - l * n
    jo_kn = j * o - k * n
    ip_lm = i * p - l * mm
    io_km = i * o - k * mm
    in_jm = i * n - j * mm
    return (a * (f * kp_lo - g * jp_ln + h * jo_kn)
            - b * (e * kp_lo - g * ip_lm + h * io_km)
            + c * (e * jp_ln - f * ip_lm + h * in_jm)
            - d * (e * jo_kn - f * io_km + g * in_jm))


def _sym(m: torch.Tensor) -> torch.Tensor:
    """(M + M^T) / 2, as the reference's solvers symmetrize their input."""
    return (m + m.transpose(-1, -2)) / 2


def _cholesky_or_nan(m: torch.Tensor) -> torch.Tensor:
    """Cholesky factor of the symmetrized matrix, all-NaN where it is not
    positive definite (what the reference's solver returns), without a host
    check."""
    l, info = torch.linalg.cholesky_ex(_sym(m))
    return torch.where(info[..., None, None] == 0, l, torch.full_like(l, float("nan")))


def _logdet_pd(m: torch.Tensor) -> torch.Tensor:
    """log det of (near-)PD [..., 6, 6] matrices by Cholesky (linespec.cpp
    logdet); -inf where the factorization fails."""
    l = _cholesky_or_nan(m + 1e-9 * torch.eye(6, dtype=m.dtype, device=m.device))
    d = torch.diagonal(l, dim1=-2, dim2=-1)
    val = 2.0 * torch.log(torch.clamp(d, min=1e-30)).sum(-1)
    return torch.where(torch.isfinite(d).all(-1), val,
                       torch.full_like(val, float("-inf")))


def _min_eig(m: torch.Tensor) -> torch.Tensor:
    """Smallest eigenvalue of symmetric [..., 6, 6] matrices."""
    return torch.linalg.eigvalsh(_sym(m))[..., 0]


class CutResult(NamedTuple):
    r0: torch.Tensor        # [M] start-point cut ratios
    r1: torch.Tensor        # [M]
    info: torch.Tensor      # [M, 6, 6] per-line info at the final ratios
    info_sum: torch.Tensor  # [6, 6]
    iters: torch.Tensor     # scalar int64


@lru_cache(maxsize=16)
def _steps(step: float, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_NEIGHBOR_STEPS * np.float32(step)).to(device)


def cut_lines(cam: CameraParams, dt: torch.Tensor, lns: LineMatches,
              cov_s: torch.Tensor, cov_e: torch.Tensor, pts: PointMatches,
              step: float = 0.05, rng_lo: float = 0.0, rng_hi: float = 1.0,
              use_logdet: bool = True, max_steps: int = 10) -> CutResult:
    """Parallel coordinate-ascent line cutting (submodular solver,
    :1618-1764). ``dt`` = T_curr<-prev."""
    m = lns.sp3d.shape[0]
    dev, dtype = dt.device, dt.dtype

    def factors(r0, r1):
        """Factors at [M] ratios, or at an [M, C] candidate grid flattened
        into the batch."""
        if r0.dim() == 1:
            j, d = line_info_factors_batch(
                cam, dt, lns.sp3d, lns.ep3d, cov_s, cov_e, lns.le_obs, r0, r1)
            return j, torch.where(lns.valid[:, None], d, torch.zeros_like(d))
        mm, cc = r0.shape

        def rep(a):
            return a[:, None].expand(mm, cc, *a.shape[1:]).reshape(
                mm * cc, *a.shape[1:])

        j, d = line_info_factors_batch(
            cam, dt, rep(lns.sp3d), rep(lns.ep3d), rep(cov_s), rep(cov_e),
            rep(lns.le_obs), r0.reshape(-1), r1.reshape(-1))
        d = d.reshape(mm, cc, 2)
        return (j.reshape(mm, cc, 6, 2),
                torch.where(lns.valid[:, None, None], d, torch.zeros_like(d)))

    def info_of(j, d):
        return torch.einsum("...ik,...k,...jk->...ij", j, d, j)

    pt_infos = pose_info_point(cam, dt, pts.p3d, pts.obs)
    pt_sum = torch.where(pts.valid[:, None, None], pt_infos,
                         torch.zeros_like(pt_infos)).sum(0)

    r0 = torch.zeros(m, dtype=dtype, device=dev)
    r1 = torch.zeros(m, dtype=dtype, device=dev)
    j0, d0 = factors(r0, r1)
    steps = _steps(step, dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    eye4 = torch.eye(4, dtype=dtype, device=dev)
    neg_inf = torch.full((), float("-inf"), dtype=dtype, device=dev)

    def cand_metrics_logdet(total, j_own, d_own, js, ds):
        """logdet(total - own + cand) - logdet(total) by the rank-4
        determinant lemma with U = [j_own | j_cand], D = diag(-d_own, d_cand):
        one shared 6x6 Cholesky, then a triangular solve and a 4x4
        determinant per (line, candidate)."""
        l = _cholesky_or_nan(total + 1e-8 * eye6)
        u = torch.cat([j_own[:, None].expand_as(js), js], -1)      # [M,9,6,4]
        d4 = torch.cat([-d_own[:, None].expand_as(ds), ds], -1)    # [M,9,4]
        rhs = u.reshape(-1, 6, 4).permute(1, 0, 2).reshape(6, -1)
        y = torch.linalg.solve_triangular(l, rhs, upper=False)
        y = y.reshape(6, -1, 4).permute(1, 0, 2)                   # [M*9,6,4]
        g = torch.einsum("bir,bis->brs", y, y).reshape(*ds.shape[:2], 4, 4)
        det = _det4(eye4 + d4[..., :, None] * g)
        val = torch.where(det > 0, torch.log(torch.clamp(det, min=1e-30)), neg_inf)
        return torch.where(torch.isfinite(val), val, neg_inf)

    def cand_metrics_mineig(rest, js, ds):
        return _min_eig(rest[:, None] + info_of(js, ds))

    def body(carry):
        r0, r1, j_cur, d_cur, it, _ = carry
        info_sum = torch.einsum("mik,mk,mjk->ij", j_cur, d_cur, j_cur) + pt_sum
        # candidate grid: slot 0 = stay, slots 1..8 = moves
        c0 = torch.cat([r0[:, None], r0[:, None] + steps[None, :, 0]], 1)
        c1 = torch.cat([r1[:, None], r1[:, None] + steps[None, :, 1]], 1)
        feas = ((c0 + c1 <= 1.0) & (c0 >= rng_lo) & (c0 <= rng_hi)
                & (c1 >= rng_lo) & (c1 <= rng_hi))
        js, ds = factors(c0, c1)                                # [M,9,6,2]
        if use_logdet:
            metric = cand_metrics_logdet(info_sum, j_cur, d_cur, js, ds)
        else:
            metric = cand_metrics_mineig(
                info_sum[None] - info_of(j_cur, d_cur), js, ds)
        metric = torch.where(feas & lns.valid[:, None], metric, neg_inf)
        base = metric[:, 0]
        best = torch.argmax(metric[:, 1:], dim=1) + 1
        take = torch.gather(metric, 1, best[:, None])[:, 0] > base + 1e-12
        nr0 = torch.where(take, torch.gather(c0, 1, best[:, None])[:, 0], r0)
        nr1 = torch.where(take, torch.gather(c1, 1, best[:, None])[:, 0], r1)
        rows = torch.arange(m, device=dev)
        nj = torch.where(take[:, None, None], js[rows, best], j_cur)
        nd = torch.where(take[:, None], ds[rows, best], d_cur)
        return nr0, nr1, nj, nd, it + 1, take.any()

    carry = (r0, r1, j0, d0, torch.zeros((), dtype=torch.int64, device=dev),
             torch.ones((), dtype=torch.bool, device=dev))
    for _ in range(max_steps):
        nxt = body(carry)
        improved = carry[5]
        carry = tuple(torch.where(improved, new, old)
                      for new, old in zip(nxt, carry))
    r0, r1, j_cur, d_cur, iters, _ = carry
    infos = info_of(j_cur, d_cur)
    return CutResult(r0=r0, r1=r1, info=infos, info_sum=infos.sum(0) + pt_sum,
                     iters=iters)


def apply_cut(cam: CameraParams, lns: LineMatches, cut: CutResult
              ) -> LineMatches:
    """Rewrite matched-line endpoints by the cut ratios
    (updateEndPointByRatio, :1451-1470)."""
    sp = (1 - cut.r0)[:, None] * lns.sp3d + cut.r0[:, None] * lns.ep3d
    ep = (1 - cut.r1)[:, None] * lns.ep3d + cut.r1[:, None] * lns.sp3d
    return lns._replace(sp3d=sp, ep3d=ep)
