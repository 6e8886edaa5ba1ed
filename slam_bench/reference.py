"""The plain reference that decides ``correct``: numpy and plain PyTorch
operations only, importing nothing of the program.

- :func:`ate_m`: a trajectory's absolute error against the world's ground
  truth (the generator's own poses), after the rigid alignment (rotation
  and translation, no scale) of the standard ATE protocol.
- :func:`fast9_scores`: the FAST-9 segment score of every pixel as the
  configuration states it (ORB-SLAM's ``FAST`` with the reference engine's
  bf16 arithmetic: the image, every difference and every margin rounded
  to bf16, the best 9-pixel arc of the 16-pixel circle, 0 where there is
  none and on the 3-pixel border), from the benchmark's own frames.
- :func:`hamming`: masked Hamming distances of 256-bit descriptors.
- :func:`ba_cost`: the local BA's objective, the configuration's robust
  reprojection error, of a BA problem at given poses and landmarks.
- :func:`pose_graph_cost`: the loop closure's pose-graph objective at
  given keyframe poses.
"""

from __future__ import annotations

import numpy as np
import torch

BIG = 1 << 16   # the distance of a masked row or column
# Bresenham circle of radius 3 as (dx, dy), clockwise from (0, -3)
CIRCLE = ((0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
          (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3))
ARC = 9


def ate_m(est: np.ndarray, gt: np.ndarray) -> float:
    """RMSE of the positions of ``est`` [N, 4, 4] against ``gt`` [N, 4, 4]
    after the least-squares rotation and translation (Umeyama, no scale)."""
    e = np.asarray(est, np.float64)[:, :3, 3]
    g = np.asarray(gt, np.float64)[:, :3, 3]
    if not np.isfinite(e).all():
        return float("inf")
    ec, gc = e - e.mean(0), g - g.mean(0)
    u, _, vt = np.linalg.svd(gc.T @ ec)
    d = np.diag([1.0, 1.0, np.sign(np.linalg.det(u @ vt)) or 1.0])
    r = u @ d @ vt
    res = ec @ r.T - gc
    return float(np.sqrt((res ** 2).sum(1).mean()))


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Round float32 values to ``dtype`` and back: one rounding per op."""
    return x.to(dtype).to(torch.float32)


def fast9_scores(imgs: torch.Tensor, threshold: float,
                 dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """[B, H, W] images (any real dtype) -> [B, H, W] float32 FAST-9
    scores, every value rounded to ``dtype`` where the configuration rounds
    to bf16 (a lower ``dtype`` is the control)."""
    x = _round(imgs.to(torch.float32), dtype)
    b, h, w = x.shape
    t = _round(torch.tensor(float(threshold), device=x.device), dtype)
    pad = torch.nn.functional.pad(x, (3, 3, 3, 3))
    ring = torch.stack([pad[:, 3 + dy:3 + dy + h, 3 + dx:3 + dx + w]
                        for dx, dy in CIRCLE])                 # [16, B, H, W]
    d = _round(ring - x[None], dtype)
    neg = torch.tensor(float("-inf"), device=x.device)
    bright = torch.where(d > t, _round(d - t, dtype), neg)
    dark = torch.where(d < -t, _round(-d - t, dtype), neg)
    best = torch.full_like(x, float("-inf"))
    for m in (bright, dark):
        ext = torch.cat([m, m[:ARC - 1]])
        for s in range(16):
            best = torch.maximum(best, ext[s:s + ARC].amin(0))
    score = torch.where(torch.isfinite(best), best, torch.zeros_like(best)).clamp(min=0)
    border = torch.zeros((h, w), dtype=torch.bool, device=x.device)
    border[3:h - 3, 3:w - 3] = True
    return torch.where(border, score, torch.zeros_like(score))


_POPCOUNT8 = torch.tensor([bin(i).count("1") for i in range(256)], dtype=torch.int32)


def hamming(a: torch.Tensor, b: torch.Tensor, valid_a=None, valid_b=None
            ) -> torch.Tensor:
    """[N, 8] x [M, 8] int32 descriptors -> [N, M] int32 Hamming distances
    over all 256 bits; a row or column that its mask marks invalid gets
    :data:`BIG`. Works in blocks of rows of about 2**24 bytes each."""
    lut = _POPCOUNT8.to(a.device)
    ab = a.contiguous().view(torch.uint8).reshape(a.shape[0], 32)
    bb = b.contiguous().view(torch.uint8).reshape(b.shape[0], 32)
    out = torch.empty((a.shape[0], b.shape[0]), dtype=torch.int32, device=a.device)
    rows = max(1, (1 << 24) // max(1, 32 * b.shape[0]))
    for s in range(0, a.shape[0], rows):
        x = ab[s:s + rows, None, :] ^ bb[None, :, :]
        out[s:s + rows] = lut[x.long()].sum(-1, dtype=torch.int32)
    if valid_a is not None:
        out[~valid_a.bool()] = BIG
    if valid_b is not None:
        out[:, ~valid_b.bool()] = BIG
    return out


def ba_cost(cam: dict, prob: dict, state: dict) -> float:
    """The local BA's objective in float64: the mean, over the problem's
    valid observations, of the robust squared reprojection error
    ``r^2 / (1 + r^2 s)`` (the weight ``1 / (1 + r^2 s)`` of the reference
    engine's Levenberg-Marquardt, ``s`` the observation's ``sigma2``); a
    point's ``r`` is its pixel error, a line's the signed distances of its
    two projected endpoints to the observed line ``(a, b, c)``. ``prob``
    holds the observations (the fields of the program's ``BAProblem``),
    ``state`` the cam->world keyframe poses ``kf_pose`` and the landmarks
    ``pt_pos``, ``ln_sp``, ``ln_ep`` at which it is taken. ``cam`` is the
    configuration's camera."""
    t_cw = torch.linalg.inv(state["kf_pose"].double())

    def pixel(kf, xw):
        t = t_cw[kf.long()]
        pc = (t[:, :3, :3] @ xw.double()[:, :, None])[:, :, 0] + t[:, :3, 3]
        z = torch.where(pc[:, 2].abs() < 1e-9, 1e-9, pc[:, 2])
        return cam["fx"] * pc[:, 0] / z + cam["cx"], cam["fy"] * pc[:, 1] / z + cam["cy"]

    def robust(r2, sigma2, valid):
        return torch.where(valid.bool(), r2 / (1.0 + r2 * sigma2.double()), 0.0).sum()

    u, v = pixel(prob["po_kf"], state["pt_pos"][prob["po_lm"].long()])
    uv = prob["po_uv"].double()
    pts = robust((u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2, prob["po_sigma2"],
                 prob["po_valid"])
    le = prob["lo_le"].double()
    r2 = 0.0
    for end in ("ln_sp", "ln_ep"):
        u, v = pixel(prob["lo_kf"], state[end][prob["lo_lm"].long()])
        r2 = r2 + (le[:, 0] * u + le[:, 1] * v + le[:, 2]) ** 2
    lines = robust(r2, prob["lo_sigma2"], prob["lo_valid"])
    n = int(prob["po_valid"].sum()) + int(prob["lo_valid"].sum())
    return float((pts + lines) / max(n, 1))


def _skew(v: np.ndarray) -> np.ndarray:
    z = np.zeros(len(v))
    return np.stack([np.stack([z, -v[:, 2], v[:, 1]], 1),
                     np.stack([v[:, 2], z, -v[:, 0]], 1),
                     np.stack([-v[:, 1], v[:, 0], z], 1)], 1)


def se3_log(t: np.ndarray) -> np.ndarray:
    """[N, 4, 4] rigid transforms -> [N, 6] twists (rho, phi): ``phi`` the
    rotation's axis times its angle, ``rho = V(phi)^-1 t``."""
    r, p = t[:, :3, :3], t[:, :3, 3]
    cos = np.clip((np.trace(r, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    th = np.arccos(cos)
    sin = np.sin(th)
    small = th < 1e-6
    vee = np.stack([r[:, 2, 1] - r[:, 1, 2], r[:, 0, 2] - r[:, 2, 0],
                    r[:, 1, 0] - r[:, 0, 1]], 1)
    k = np.where(small, 0.5 + th ** 2 / 12.0, th / (2.0 * np.where(small, 1.0, sin)))
    phi = k[:, None] * vee
    w = _skew(phi)
    c = np.where(small, 1.0 / 12.0,
                 (1.0 - th * sin / (2.0 * np.where(small, 1.0, 1.0 - cos)))
                 / np.where(small, 1.0, th ** 2))
    v_inv = np.eye(3) - 0.5 * w + c[:, None, None] * (w @ w)
    return np.concatenate([(v_inv @ p[:, :, None])[:, :, 0], phi], 1)


def pose_graph_cost(kf_pose, edges: dict) -> float:
    """The pose graph's objective in float64: the sum, over its valid edges
    between two keyframes, of ``|log(T_ij^-1 T_i^-1 T_j)|^2`` (identity
    information), ``T`` the cam->world keyframe poses ``kf_pose`` and
    ``T_ij`` the edge's measurement. ``edges`` holds the fields of the
    program's ``PoseGraphEdges`` (``i``, ``j``, ``t_ij``, ``valid``)."""
    x = torch.as_tensor(kf_pose).double().cpu().numpy()
    i, j = (edges[k].long().cpu().numpy() for k in ("i", "j"))
    keep = edges["valid"].bool().cpu().numpy() & (i != j)
    i, j = i[keep], j[keep]
    t_ij = edges["t_ij"].double().cpu().numpy()[keep]
    err = np.linalg.inv(t_ij) @ np.linalg.inv(x[i]) @ x[j]
    return float((se3_log(err) ** 2).sum())
