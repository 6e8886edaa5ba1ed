"""Shared BA numerics: block accumulation, Schur reduction, camera solve.

Port of ``gfplslam_tpu/models/ba_core.py`` (levMarquardtOptimizationLBA,
mapHandler.cpp:1217-1838): the pieces of one Levenberg-Marquardt iteration
of :func:`gfplslam_torch.models.ba.solve_ba`. As in the reference, the
index-summed accumulations are one-hot matrix products (deterministic on
the card, where a duplicate-index ``index_add_`` sums in no fixed order),
the landmark block inverses are closed-form (adjugate 3x3, block-Schur 6x6),
and the symmetric 3x3 spectra are Smith's closed form.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gfplslam_torch.utils import se3


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def inv3(m: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a = e * i - f * h
    co_b = f * g - d * i
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    idet = 1.0 / torch.where(torch.abs(det) < 1e-18, torch.full_like(det, 1e-18), det)
    adj = torch.stack([
        torch.stack([co_a, c * h - b * i, b * f - c * e], -1),
        torch.stack([co_b, a * i - c * g, c * d - a * f], -1),
        torch.stack([co_c, b * g - a * h, a * e - b * d], -1),
    ], -2)
    return adj * idet[..., None, None]


def inv6(m: torch.Tensor) -> torch.Tensor:
    """Batched 6x6 inverse via 2x2-of-3x3 block Schur with closed-form 3x3
    inverses. Valid for the damped symmetric blocks used here."""
    a, b = m[..., :3, :3], m[..., :3, 3:]
    c, d = m[..., 3:, :3], m[..., 3:, 3:]
    a_inv = inv3(a)
    s_inv = inv3(d - c @ a_inv @ b)
    aib = a_inv @ b
    cai = c @ a_inv
    top = torch.cat([a_inv + aib @ s_inv @ cai, -aib @ s_inv], -1)
    bot = torch.cat([-s_inv @ cai, s_inv], -1)
    return torch.cat([top, bot], -2)


class BABlocks(NamedTuple):
    """Undamped normal-equation blocks at one state + the robust error
    pieces that come free from the residual pass."""
    hcc: torch.Tensor      # [K, 6, 6] camera diag blocks
    bc: torch.Tensor       # [K, 6]
    hpp: torch.Tensor      # [P, 3, 3] point landmark blocks
    bp: torch.Tensor       # [P, 3]
    hcl_p: torch.Tensor    # [P, K, 6, 3] camera-point cross blocks
    hll: torch.Tensor      # [L, 6, 6] line landmark blocks (endpoint 6-dof)
    bl: torch.Tensor       # [L, 6]
    hcl_l: torch.Tensor    # [L, K, 6, 6]
    pt_act: torch.Tensor   # [P] bool — landmark has support
    ln_act: torch.Tensor   # [L]
    err_sum: torch.Tensor  # robust error numerator
    err_cnt: torch.Tensor  # observation count


def one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """[N] indices -> [N, n] float32; an index outside [0, n) gives a zero
    row (``jax.nn.one_hot`` semantics; ``F.one_hot`` raises instead)."""
    return (idx[:, None] == torch.arange(n, device=idx.device)).to(torch.float32)


def make_selectors(prob) -> tuple:
    """One-hot selector matrices, built once per problem (loop-invariant)."""
    k = prob.kf_pose.shape[0]
    return (one_hot(prob.po_kf, k), one_hot(prob.lo_kf, k),
            one_hot(prob.po_lm, prob.pt_pos.shape[0]),
            one_hot(prob.lo_lm, prob.ln_sp.shape[0]))


# Obs-chunking threshold for the landmark-family one-hot contractions (the
# reference's, models/ba_core.py:109): global BA at full capacity would
# otherwise hold [Op, P] and [Op, K, 6, 3] intermediates of ~9 GB.
OBS_CHUNK = 8192


def _lm_family_blocks(oh_lm, oh_kf, w, j_pose, j_lm, r, width):
    """[Obs]-indexed landmark-family accumulation: returns [N_lm, width]
    with columns (H_lm | b_lm | per-KF cross blocks), summed over
    observation chunks when there are many."""
    d = j_lm.shape[-1]

    def values(oh_kf_c, w_c, jp_c, jl_c, r_c):
        v_h = w_c[:, None, None] * torch.einsum("nri,nrj->nij", jl_c, jl_c)
        v_b = w_c[:, None] * torch.einsum("nri,nr->ni", jl_c, r_c)
        v_x = (oh_kf_c[:, :, None, None]
               * (w_c[:, None, None] * torch.einsum(
                   "nri,nrj->nij", jp_c, jl_c))[:, None])  # [n,K,6,d]
        return torch.cat([v_h.reshape(-1, d * d), v_b,
                          v_x.reshape(v_x.shape[0], -1)], 1)

    n = w.shape[0]
    if n <= OBS_CHUNK or n % OBS_CHUNK != 0:
        return oh_lm.T @ values(oh_kf, w, j_pose, j_lm, r)
    acc = torch.zeros((oh_lm.shape[1], width), dtype=w.dtype, device=w.device)
    for s in range(0, n, OBS_CHUNK):
        sl = slice(s, s + OBS_CHUNK)
        acc = acc + oh_lm[sl].T @ values(oh_kf[sl], w[sl], j_pose[sl],
                                         j_lm[sl], r[sl])
    return acc


def _trace(h: torch.Tensor) -> torch.Tensor:
    return torch.diagonal(h, dim1=-2, dim2=-1).sum(-1)


def build_blocks(cam, prob, sel, point_residuals, line_residuals,
                 t_cw, pt_pos, ln_sp, ln_ep) -> BABlocks:
    """Residual pass + block accumulation at one state."""
    oh_pk, oh_lk, oh_pp, oh_ll = sel
    k = prob.kf_pose.shape[0]
    p = pt_pos.shape[0]
    l = ln_sp.shape[0]
    rp, jp_pose, jp_lm, wp = point_residuals(cam, t_cw, prob, pt_pos)
    rl, jl_pose, jl_sp, jl_ep, wl = line_residuals(cam, t_cw, prob, ln_sp, ln_ep)
    wp = torch.where(prob.po_valid, wp, 0.0)
    wl = torch.where(prob.lo_valid, wl, 0.0)
    err_sum = (((rp * rp).sum(-1) * wp).sum() + ((rl * rl).sum(-1) * wl).sum())
    err_cnt = (prob.po_valid.sum() + prob.lo_valid.sum()).to(torch.float32)

    # camera family: [Op+Ol, 42] (Hcc 36 + bc 6) against [Op+Ol, K]
    v_cc_p = wp[:, None, None] * torch.einsum("nri,nrj->nij", jp_pose, jp_pose)
    v_cc_l = wl[:, None, None] * torch.einsum("nri,nrj->nij", jl_pose, jl_pose)
    v_bc_p = wp[:, None] * torch.einsum("nri,nr->ni", jp_pose, rp)
    v_bc_l = wl[:, None] * torch.einsum("nri,nr->ni", jl_pose, rl)
    v_cam = torch.cat([torch.cat([v_cc_p.reshape(-1, 36), v_bc_p], 1),
                       torch.cat([v_cc_l.reshape(-1, 36), v_bc_l], 1)], 0)
    cam_blocks = torch.cat([oh_pk, oh_lk], 0).T @ v_cam       # [K, 42]
    hcc = cam_blocks[:, :36].reshape(k, 6, 6)
    bc = cam_blocks[:, 36:]

    # point-landmark family: [Op, 9 + 3 + K*18] against [Op, P]
    pt_blocks = _lm_family_blocks(oh_pp, oh_pk, wp, jp_pose, jp_lm, rp,
                                  12 + 18 * k)
    hpp = pt_blocks[:, :9].reshape(p, 3, 3)
    bp = pt_blocks[:, 9:12]
    hcl_p = pt_blocks[:, 12:].reshape(p, k, 6, 3)

    # line-landmark family: [Ol, 36 + 6 + K*36] against [Ol, L]
    jl_lm = torch.cat([jl_sp, jl_ep], -1)                      # [Ol, 2, 6]
    ln_blocks = _lm_family_blocks(oh_ll, oh_lk, wl, jl_pose, jl_lm, rl,
                                  42 + 36 * k)
    hll = ln_blocks[:, :36].reshape(l, 6, 6)
    bl = ln_blocks[:, 36:42]
    hcl_l = ln_blocks[:, 42:].reshape(l, k, 6, 6)

    # activity gate: a landmark with ~zero weighted information takes no
    # step (models/ba_core.py:190-197 of the reference)
    pt_act = prob.pt_valid & (_trace(hpp) > 1e-2)
    ln_act = prob.ln_valid & (_trace(hll) > 1e-2)
    return BABlocks(hcc=hcc, bc=bc, hpp=hpp, bp=bp, hcl_p=hcl_p,
                    hll=hll, bl=bl, hcl_l=hcl_l, pt_act=pt_act, ln_act=ln_act,
                    err_sum=err_sum, err_cnt=err_cnt)


# Observability gates for landmark update directions (see landmark_inverses)
EIG_REL_GATE = 1e-3
EIG_ABS_GATE = 1e-2


def _sym3_eigvals(h: torch.Tensor) -> torch.Tensor:
    """Closed-form (trigonometric) eigenvalues of batched symmetric 3x3
    matrices, ascending [..., 3] (Smith's method)."""
    q = _trace(h) / 3.0
    a = h - q[..., None, None] * _eye(3, h)
    p2 = (a * a).sum((-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    d = (a[..., 0, 0] * (a[..., 1, 1] * a[..., 2, 2]
                         - a[..., 1, 2] * a[..., 2, 1])
         - a[..., 0, 1] * (a[..., 1, 0] * a[..., 2, 2]
                           - a[..., 1, 2] * a[..., 2, 0])
         + a[..., 0, 2] * (a[..., 1, 0] * a[..., 2, 1]
                           - a[..., 1, 1] * a[..., 2, 0]))
    r = torch.clamp(d / (2.0 * p ** 3), -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)                         # largest
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)   # smallest
    e2 = 3.0 * q - e1 - e3
    return torch.stack([e3, e2, e1], -1)


def _outer_unit(m: torch.Tensor) -> torch.Tensor:
    """Rank-1 projector from the dominant column of m (safe norm)."""
    j = torch.argmax((m * m).sum(-2), -1)
    v = torch.take_along_dim(m, j[..., None, None].expand(*j.shape, 3, 1),
                             dim=-1)[..., 0]
    v = v / torch.sqrt(torch.clamp((v * v).sum(-1, keepdim=True), min=1e-30))
    return v[..., :, None] * v[..., None, :]


def _keep_projector3(h: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] projector onto the observable eigenspace of symmetric 3x3
    blocks: eigendirections with eigenvalue > max(EIG_ABS_GATE,
    EIG_REL_GATE * lambda_max), eigenvectors from (H - l2 I)(H - l3 I)."""
    w = _sym3_eigvals(h)                                      # ascending
    gate = torch.clamp(EIG_REL_GATE * torch.clamp(w[..., 2], min=0.0),
                       min=EIG_ABS_GATE)
    n_keep = (w > gate[..., None]).sum(-1)[..., None, None]
    eye = _eye(3, h)
    l1, l2, l3 = (w[..., i, None, None] for i in range(3))
    # n_keep==2: cut the weakest direction; n_keep==1: keep the strongest
    p_cut1 = eye - _outer_unit((h - l2 * eye) @ (h - l3 * eye))
    p_keep1 = _outer_unit((h - l1 * eye) @ (h - l2 * eye))
    return torch.where(n_keep == 3, eye,
                       torch.where(n_keep == 2, p_cut1,
                                   torch.where(n_keep == 1, p_keep1, 0.0)))


# stiffness added along unobservable directions
_CUT_STIFFNESS = 1e8


def _damped_diag(h: torch.Tensor, lam) -> torch.Tensor:
    return lam * torch.diag_embed(torch.clamp(
        torch.diagonal(h, dim1=-2, dim2=-1), min=1e-6))


def landmark_inverses(bk: BABlocks, lam) -> tuple[torch.Tensor, torch.Tensor]:
    """Damped landmark block inverses restricted to observable
    eigendirections (zero for empty slots): ~infinite stiffness along
    sub-gate eigendirections holds low-parallax landmarks fixed along their
    unobservable axes (reference docstring, models/ba_core.py:280-296)."""
    eye3 = _eye(3, bk.hpp)
    eye6 = _eye(6, bk.hll)
    hpp_d = (bk.hpp + _damped_diag(bk.hpp, lam)
             + _CUT_STIFFNESS * (eye3 - _keep_projector3(bk.hpp)))
    # line blocks: per-endpoint observability (block-diagonal projector)
    pa = _keep_projector3(bk.hll[:, :3, :3])
    pb = _keep_projector3(bk.hll[:, 3:, 3:])
    z = torch.zeros_like(pa)
    proj_l = torch.cat([torch.cat([pa, z], -1), torch.cat([z, pb], -1)], -2)
    hll_d = (bk.hll + _damped_diag(bk.hll, lam)
             + _CUT_STIFFNESS * (eye6 - proj_l))
    pt_act = bk.pt_act[:, None, None]
    ln_act = bk.ln_act[:, None, None]
    hpp_inv = torch.where(pt_act, inv3(torch.where(pt_act, hpp_d, eye3)), 0.0)
    hll_inv = torch.where(ln_act, inv6(torch.where(ln_act, hll_d, eye6)), 0.0)
    return hpp_inv, hll_inv


def schur_reduce(bk: BABlocks, hpp_inv, hll_inv):
    """Reduced camera system: S = blockdiag(Hcc) - sum_lm Hcl Hll^-1 Hlc and
    rhs = bc - sum_lm Hcl Hll^-1 bl, as two-step contractions with an
    explicit [6K, P*d] product."""
    k = bk.hcc.shape[0]
    a_p = torch.einsum("pkil,plm->pkim", bk.hcl_p, hpp_inv)   # [P,K,6,3]
    a_l = torch.einsum("pkil,plm->pkim", bk.hcl_l, hll_inv)   # [L,K,6,6]

    def flat(x):
        return x.permute(1, 2, 0, 3).reshape(6 * k, -1)
    s_red = flat(a_p) @ flat(bk.hcl_p).T + flat(a_l) @ flat(bk.hcl_l).T
    s_local = block_diag_embed(bk.hcc) - s_red
    rhs_local = (bk.bc - torch.einsum("pkim,pm->ki", a_p, bk.bp)
                 - torch.einsum("pkim,pm->ki", a_l, bk.bl))
    return s_local, rhs_local


def camera_solve(s_full, rhs, kf_opt, lam) -> torch.Tensor:
    """Damp + freeze + solve the reduced camera system (pivoted LU;
    ``solve_ex`` does not read the device's error flag back to the host)."""
    k = kf_opt.shape[0]
    diag_mask = kf_opt.repeat_interleave(6)
    s_full = s_full + lam * torch.diag(torch.clamp(torch.diagonal(s_full), min=1e-6))
    s_full = torch.where(diag_mask[:, None] & diag_mask[None, :], s_full, 0.0)
    s_full = s_full + torch.diag(torch.where(diag_mask, 0.0, 1.0))
    rhs_f = torch.where(diag_mask, rhs.reshape(-1), 0.0)
    dx_cam = torch.linalg.solve_ex(s_full + 1e-10 * _eye(6 * k, s_full),
                                   rhs_f)[0].reshape(k, 6)
    return torch.where(kf_opt[:, None], dx_cam, 0.0)


def back_substitute(bk: BABlocks, hpp_inv, hll_inv, dx_cam):
    """Landmark updates given the camera step: Hll dxl = bl - Hlc dxc."""
    hlc_dc_p = torch.einsum("pkil,ki->pl", bk.hcl_p, dx_cam)
    dx_pt = torch.einsum("plm,pm->pl", hpp_inv, bk.bp - hlc_dc_p)
    hlc_dc_l = torch.einsum("pkil,ki->pl", bk.hcl_l, dx_cam)
    dx_ln = torch.einsum("plm,pm->pl", hll_inv, bk.bl - hlc_dc_l)
    return dx_pt, dx_ln


MAX_LM_STEP = 1.0  # metres — per-iteration landmark trust region


def _clip_step(dx: torch.Tensor, cap: float = MAX_LM_STEP) -> torch.Tensor:
    """Scale a [N, 3] step down to at most ``cap`` metres per landmark."""
    n = torch.linalg.vector_norm(dx, dim=-1, keepdim=True)
    return dx * (cap / torch.clamp(n, min=cap))


def retract(bk: BABlocks, t_cw, pt_pos, ln_sp, ln_ep, dx_cam, dx_pt, dx_ln):
    """Apply the step (GN direction is -dx since b = J^T r)."""
    t_cw_new = se3.expmap_se3(-dx_cam) @ t_cw
    pt_act = bk.pt_act[:, None]
    ln_act = bk.ln_act[:, None]
    pt_new = pt_pos - torch.where(pt_act, _clip_step(dx_pt), 0.0)
    ln_sp_new = ln_sp - torch.where(ln_act, _clip_step(dx_ln[:, :3]), 0.0)
    ln_ep_new = ln_ep - torch.where(ln_act, _clip_step(dx_ln[:, 3:]), 0.0)
    return t_cw_new, pt_new, ln_sp_new, ln_ep_new


def accept_landmarks(sel, prob, chi2_p_old, chi2_p_new, chi2_l_old,
                     chi2_l_new, pt_old, pt_new, sp_old, sp_new,
                     ep_old, ep_new):
    """Per-landmark step acceptance: keep a landmark's candidate position
    only if it does not worsen that landmark's own (unweighted) reprojection
    chi2 at the candidate cameras (reference docstring,
    models/ba_core.py:388-409)."""
    _, _, oh_pp, oh_ll = sel
    keep_p = (torch.where(prob.po_valid, chi2_p_new, 0.0) @ oh_pp
              <= torch.where(prob.po_valid, chi2_p_old, 0.0) @ oh_pp)
    keep_l = (torch.where(prob.lo_valid, chi2_l_new, 0.0) @ oh_ll
              <= torch.where(prob.lo_valid, chi2_l_old, 0.0) @ oh_ll)
    return (torch.where(keep_p[:, None], pt_new, pt_old),
            torch.where(keep_l[:, None], sp_new, sp_old),
            torch.where(keep_l[:, None], ep_new, ep_old))


def block_diag_embed(blocks: torch.Tensor) -> torch.Tensor:
    """[K,6,6] -> [6K,6K] block diagonal."""
    k = blocks.shape[0]
    out = blocks.new_zeros((k, 6, k, 6))
    idx = torch.arange(k, device=blocks.device)
    out[idx, :, idx, :] = blocks
    return out.reshape(6 * k, 6 * k)
