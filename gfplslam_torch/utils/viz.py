"""Headless visualization: trajectory / map / match plots to PNG.

Replaces the reference's MRPT/cv::viz live scenes (voScene.cpp, slamScene.cpp
— SURVEY.md: "deliberately dropped ... replace with headless plot dumps"):
same content (estimated vs GT trajectory, 3D landmarks, keyframe frusta,
per-frame match overlays) rendered with matplotlib Agg.
"""

from __future__ import annotations

import numpy as np

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402


def plot_trajectory(path: str, est_poses: np.ndarray,
                    gt_poses: np.ndarray | None = None,
                    kf_poses: np.ndarray | None = None) -> None:
    """Top-down (x-z) + height profile, est vs GT (voScene trajectory view)."""
    fig, axes = plt.subplots(1, 2, figsize=(11, 5))
    t = est_poses[:, :3, 3]
    axes[0].plot(t[:, 0], t[:, 2], "b-", label="estimate", lw=1.5)
    if gt_poses is not None:
        g = gt_poses[:, :3, 3]
        axes[0].plot(g[:, 0], g[:, 2], "k--", label="ground truth", lw=1.0)
    if kf_poses is not None and len(kf_poses):
        k = kf_poses[:, :3, 3]
        axes[0].plot(k[:, 0], k[:, 2], "r^", ms=4, label="keyframes")
    axes[0].set_xlabel("x [m]")
    axes[0].set_ylabel("z [m]")
    axes[0].axis("equal")
    axes[0].legend()
    axes[0].set_title("trajectory (top-down)")
    axes[1].plot(t[:, 1], "b-", label="est y")
    if gt_poses is not None:
        axes[1].plot(gt_poses[:, 1, 3], "k--", label="gt y")
    axes[1].set_xlabel("frame")
    axes[1].set_ylabel("y [m]")
    axes[1].legend()
    axes[1].set_title("height")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def plot_map(path: str, pt_pos: np.ndarray, pt_valid: np.ndarray,
             ln_sp: np.ndarray, ln_ep: np.ndarray, ln_valid: np.ndarray,
             kf_poses: np.ndarray | None = None) -> None:
    """Top-down map scatter: point landmarks, line landmarks, KF positions
    (slamScene content)."""
    fig, ax = plt.subplots(figsize=(7, 7))
    p = pt_pos[pt_valid]
    ax.plot(p[:, 0], p[:, 2], ".", ms=2, color="#888", label="points")
    for s, e in zip(ln_sp[ln_valid], ln_ep[ln_valid]):
        ax.plot([s[0], e[0]], [s[2], e[2]], "g-", lw=0.8)
    if kf_poses is not None and len(kf_poses):
        k = kf_poses[:, :3, 3]
        ax.plot(k[:, 0], k[:, 2], "r^-", ms=5, lw=1.0, label="keyframes")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.axis("equal")
    ax.legend()
    ax.set_title("map (top-down)")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def plot_matches(path: str, img_l: np.ndarray, img_r: np.ndarray,
                 xy_l: np.ndarray, xy_r: np.ndarray,
                 valid: np.ndarray) -> None:
    """Side-by-side stereo match overlay (the canvas plots in
    stereoFrame.cpp:1603-1748)."""
    h = max(img_l.shape[0], img_r.shape[0])
    w = img_l.shape[1] + img_r.shape[1]
    canvas = np.zeros((h, w), np.float32)
    canvas[:img_l.shape[0], :img_l.shape[1]] = img_l
    canvas[:img_r.shape[0], img_l.shape[1]:] = img_r
    fig, ax = plt.subplots(figsize=(12, 5))
    ax.imshow(canvas, cmap="gray", vmin=0, vmax=255)
    off = img_l.shape[1]
    for (xl, yl), (xr, yr) in zip(xy_l[valid], xy_r[valid]):
        ax.plot([xl, xr + off], [yl, yr], "-", lw=0.5, alpha=0.6)
    ax.plot(xy_l[valid, 0], xy_l[valid, 1], "r.", ms=2)
    ax.plot(xy_r[valid, 0] + off, xy_r[valid, 1], "b.", ms=2)
    ax.axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
