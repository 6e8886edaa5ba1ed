"""TUM-format trajectory IO + ATE evaluation.

Parity with the reference's outputs (plslam_mod.cpp:288-301, 538-566: one row
``t tx ty tz qx qy qz qw`` per frame, all-frame + keyframe files) and with the
external ATE evaluation its batch scripts rely on — built in here so the
engine measures itself (SURVEY.md section 6).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def _rot_to_quat(r: np.ndarray) -> np.ndarray:
    """Rotation matrix -> [qx, qy, qz, qw]."""
    tr = np.trace(r)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        return np.array([(r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s,
                         (r[1, 0] - r[0, 1]) / s, 0.25 * s])
    i = int(np.argmax(np.diag(r)))
    if i == 0:
        s = np.sqrt(1.0 + r[0, 0] - r[1, 1] - r[2, 2]) * 2
        q = [0.25 * s, (r[0, 1] + r[1, 0]) / s, (r[0, 2] + r[2, 0]) / s,
             (r[2, 1] - r[1, 2]) / s]
    elif i == 1:
        s = np.sqrt(1.0 + r[1, 1] - r[0, 0] - r[2, 2]) * 2
        q = [(r[0, 1] + r[1, 0]) / s, 0.25 * s, (r[1, 2] + r[2, 1]) / s,
             (r[0, 2] - r[2, 0]) / s]
    else:
        s = np.sqrt(1.0 + r[2, 2] - r[0, 0] - r[1, 1]) * 2
        q = [(r[0, 2] + r[2, 0]) / s, (r[1, 2] + r[2, 1]) / s, 0.25 * s,
             (r[1, 0] - r[0, 1]) / s]
    return np.asarray(q)


def write_tum(path: str, timestamps: Sequence[float],
              poses: Sequence[np.ndarray]) -> None:
    """Write cam->world poses in TUM format (plslam_mod.cpp:293)."""
    with open(path, "w") as f:
        for t, p in zip(timestamps, poses):
            q = _rot_to_quat(np.asarray(p)[:3, :3])
            tx, ty, tz = np.asarray(p)[:3, 3]
            f.write(f"{t:.6f} {tx:.6f} {ty:.6f} {tz:.6f} "
                    f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n")


def read_tum(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Returns (timestamps [N], poses [N,4,4])."""
    ts, poses = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            vals = [float(x) for x in line.split()]
            t, tx, ty, tz, qx, qy, qz, qw = vals[:8]
            n = qx * qx + qy * qy + qz * qz + qw * qw
            qx, qy, qz, qw = (v / np.sqrt(n) for v in (qx, qy, qz, qw))
            r = np.array([
                [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
                [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
                [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)],
            ])
            p = np.eye(4)
            p[:3, :3] = r
            p[:3, 3] = [tx, ty, tz]
            ts.append(t)
            poses.append(p)
    return np.asarray(ts), np.stack(poses)


def align_umeyama(est: np.ndarray, gt: np.ndarray
                  ) -> tuple[np.ndarray, np.ndarray, float]:
    """SE(3) alignment (no scale) of est->gt translation tracks; returns
    (R, t, rmse_after_alignment) — the standard ATE protocol."""
    mu_e = est.mean(0)
    mu_g = gt.mean(0)
    xe = est - mu_e
    xg = gt - mu_g
    cov = xg.T @ xe / len(est)
    u, _, vt = np.linalg.svd(cov)
    s = np.eye(3)
    if np.linalg.det(u @ vt) < 0:
        s[2, 2] = -1
    r = u @ s @ vt
    t = mu_g - r @ mu_e
    aligned = est @ r.T + t
    rmse = float(np.sqrt(np.mean(np.sum((aligned - gt) ** 2, axis=1))))
    return r, t, rmse


def ate_rmse(est_poses: np.ndarray, gt_poses: np.ndarray) -> float:
    """Absolute trajectory error RMSE after SE(3) alignment, over matched
    pose arrays [N,4,4]."""
    est_t = est_poses[:, :3, 3]
    gt_t = gt_poses[:, :3, 3]
    _, _, rmse = align_umeyama(est_t, gt_t)
    return rmse
