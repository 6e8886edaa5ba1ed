"""Pinhole stereo camera: projection, back-projection, rectification.

Port of ``gfplslam_tpu/ops/camera.py`` (pinholeStereoCamera.cpp:24-170).
Every projection function takes a leading batch of any shape in place of
the reference's per-point form + ``vmap``. The rectification maps are
precomputed on the host in numpy, once per dataset (the reference's code,
copied); applying them (``remap_bilinear``, ``rectify_pair``) is a gather
on the images' device, both cameras in one call.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from gfplslam_torch.config import CameraParams


def _safe(z: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.where(torch.abs(z) < eps, torch.full_like(z, eps), z)


def project(cam: CameraParams, p: torch.Tensor) -> torch.Tensor:
    """[..., 3] camera-frame points -> [..., 2] pixels (u, v)."""
    inv_z = 1.0 / _safe(p[..., 2], 1e-12)
    return torch.stack([cam.fx * p[..., 0] * inv_z + cam.cx,
                        cam.fy * p[..., 1] * inv_z + cam.cy], -1)


def back_project(cam: CameraParams, u: torch.Tensor, v: torch.Tensor,
                 disp: torch.Tensor) -> torch.Tensor:
    """(u, v, disparity) -> [..., 3] points; X = (b/d)(u-cx) form."""
    b_over_d = cam.baseline / _safe(disp, 1e-9)
    x = b_over_d * (u - cam.cx)
    y = b_over_d * (v - cam.cy) * (cam.fx / cam.fy)
    z = b_over_d * cam.fx
    return torch.stack([x, y, z], -1)


def get_disparity(cam: CameraParams, z: torch.Tensor) -> torch.Tensor:
    """Depth -> disparity = fx*b/Z."""
    return cam.fx * cam.baseline / _safe(z, 1e-12)


def project_batch(cam: CameraParams, pts: torch.Tensor) -> torch.Tensor:
    """[N,3] -> [N,2] pixel coordinates."""
    return project(cam, pts)


def back_project_batch(cam: CameraParams, uv: torch.Tensor,
                       disp: torch.Tensor) -> torch.Tensor:
    """[N,2] pixels + [N] disparities -> [N,3] camera-frame points."""
    return back_project(cam, uv[..., 0], uv[..., 1], disp)


# ---------------------------------------------------------------------------
# Rectification (host-side precompute + device-side remap)
# ---------------------------------------------------------------------------

class RectifyMaps(NamedTuple):
    """Per-camera sampling maps: rectified pixel -> source pixel coords."""
    map_x_l: np.ndarray  # [H, W] float32
    map_y_l: np.ndarray
    map_x_r: np.ndarray
    map_y_r: np.ndarray
    cam: CameraParams    # rectified intrinsics + baseline


def _distort_radtan(x, y, d):
    """Apply radial-tangential distortion (k1, k2, p1, p2[, k3]) to normalized
    coords — the forward model used when building inverse maps."""
    k1, k2, p1, p2 = d[0], d[1], d[2], d[3]
    k3 = d[4] if len(d) > 4 else 0.0
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return xd, yd


def _distort_equidistant(x, y, d):
    """Kannala-Brandt equidistant model (k1..k4), as in the reference's
    fisheye branch (pinholeStereoCamera.cpp:76-84)."""
    k1, k2, k3, k4 = d[0], d[1], d[2], d[3]
    r = np.sqrt(x * x + y * y)
    r = np.maximum(r, 1e-12)
    theta = np.arctan(r)
    t2 = theta * theta
    theta_d = theta * (1 + k1 * t2 + k2 * t2**2 + k3 * t2**3 + k4 * t2**4)
    scale = theta_d / r
    return x * scale, y * scale


def stereo_rectify(kl: np.ndarray, dl: np.ndarray, kr: np.ndarray,
                   dr: np.ndarray, r_lr: np.ndarray, t_lr: np.ndarray,
                   width: int, height: int,
                   equidistant: bool = False) -> RectifyMaps:
    """Bouguet-style stereo rectification from scratch.

    Inputs follow the reference's EuRoC constructor
    (pinholeStereoCamera.cpp:56-104): ``r_lr, t_lr`` map right-camera points
    into the left frame. Produces sampling maps such that
    ``rectified(u,v) = source(map_x[u,v], map_y[u,v])`` and rectified
    intrinsics shared by both cameras with epipolar lines horizontal.
    """
    kl, kr = np.asarray(kl, np.float64), np.asarray(kr, np.float64)
    r_lr = np.asarray(r_lr, np.float64)
    t_lr = np.asarray(t_lr, np.float64).reshape(3)

    # Split the inter-camera rotation evenly between the two cameras.
    rvec = _rot_to_vec(r_lr)
    r_half_l = _vec_to_rot(-0.5 * rvec)   # rotate left by half inverse
    r_half_r = _vec_to_rot(-0.5 * rvec)
    # After applying r_half to each side, residual translation:
    t = r_half_l @ t_lr
    # New x-axis along the baseline.
    e1 = t / np.linalg.norm(t)
    if abs(t[0]) >= np.linalg.norm(t):  # degenerate guard
        e1 = np.array([1.0, 0, 0]) * np.sign(t[0] if t[0] != 0 else 1.0)
    e2 = np.cross(np.array([0.0, 0.0, 1.0]), e1)
    e2 /= np.linalg.norm(e2)
    e3 = np.cross(e1, e2)
    r_align = np.stack([e1, e2, e3])  # rows
    # Ensure right-handed, z forward
    if r_align[2, 2] < 0:
        r_align[1] *= -1
        r_align[2] *= -1
    rect_l = r_align @ r_half_l            # world(left) -> rectified-left
    rect_r = r_align @ r_half_l @ r_lr     # right -> rectified (shared frame)

    # Shared rectified intrinsics: mean focal, centered principal point.
    f = 0.5 * (kl[0, 0] + kr[0, 0])
    cx = width / 2.0
    cy = height / 2.0
    baseline = float(np.linalg.norm(t_lr))
    cam = CameraParams(width=width, height=height, fx=float(f), fy=float(f),
                       cx=float(cx), cy=float(cy), baseline=baseline)

    distort = _distort_equidistant if equidistant else _distort_radtan
    maps = []
    for k_src, d_src, r_rect in ((kl, dl, rect_l), (kr, dr, rect_r)):
        u, v = np.meshgrid(np.arange(width, dtype=np.float64),
                           np.arange(height, dtype=np.float64))
        # rectified pixel -> rectified normalized ray
        x = (u - cx) / f
        y = (v - cy) / f
        rays = np.stack([x, y, np.ones_like(x)], axis=-1)  # [H,W,3]
        # rotate back into the source camera frame
        src = rays @ r_rect  # == (r_rect.T @ ray) batched
        xs = src[..., 0] / src[..., 2]
        ys = src[..., 1] / src[..., 2]
        # apply source distortion then source intrinsics
        d_src = np.asarray(d_src, np.float64).reshape(-1)
        if np.any(np.abs(d_src) > 0):
            xs, ys = distort(xs, ys, d_src)
        map_x = k_src[0, 0] * xs + k_src[0, 2]
        map_y = k_src[1, 1] * ys + k_src[1, 2]
        maps.append((map_x.astype(np.float32), map_y.astype(np.float32)))
    return RectifyMaps(maps[0][0], maps[0][1], maps[1][0], maps[1][1], cam)


def _rot_to_vec(r: np.ndarray) -> np.ndarray:
    cos_t = np.clip((np.trace(r) - 1.0) * 0.5, -1.0, 1.0)
    theta = np.arccos(cos_t)
    if theta < 1e-10:
        return np.zeros(3)
    w = np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])
    return theta / (2.0 * np.sin(theta)) * w


def _vec_to_rot(v: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(v)
    if theta < 1e-10:
        return np.eye(3)
    k = v / theta
    kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * kx + (1 - np.cos(theta)) * kx @ kx


def remap_bilinear(img: torch.Tensor, map_x: torch.Tensor,
                   map_y: torch.Tensor) -> torch.Tensor:
    """Bilinear remap: out[..., v, u] = img(map_y[..., v, u], map_x[..., v, u]).

    Replaces ``cv::remap`` in ``rectifyImagesLR`` (pinholeStereoCamera.cpp:
    106-119). ``img`` float32 [..., H, W] and maps float32 [..., H, W] with
    the same leading shape. The integer corner is ``floor``, cast to int32,
    then clamped to the image, and its right/lower neighbour is clamped
    from the clamped corner, exactly as the reference does; the weights are
    the map's distance from its floor, so a map outside the image blends
    the two border pixels the clamps pick.
    """
    h, w = img.shape[-2:]
    lead = img.shape[:-2]
    x0 = torch.floor(map_x)
    y0 = torch.floor(map_y)
    fx = map_x - x0
    fy = map_y - y0
    x0i = torch.clamp(x0.to(torch.int32), 0, w - 1).long()
    x1i = torch.clamp(x0i + 1, 0, w - 1)
    y0i = torch.clamp(y0.to(torch.int32), 0, h - 1).long()
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    flat = img.reshape(*lead, h * w)
    out_shape = map_x.shape

    def tap(yi, xi):
        return torch.gather(flat, -1, (yi * w + xi).reshape(*lead, -1)
                            ).reshape(out_shape)

    top = tap(y0i, x0i) * (1 - fx) + tap(y0i, x1i) * fx
    bot = tap(y1i, x0i) * (1 - fx) + tap(y1i, x1i) * fx
    return top * (1 - fy) + bot * fy


def rectify_pair(imgs: torch.Tensor, maps: RectifyMaps) -> torch.Tensor:
    """Rectify a stacked stereo pair [2, H, W] (float32, on its device) in
    one call."""
    dev = imgs.device
    mx = torch.as_tensor(np.stack([maps.map_x_l, maps.map_x_r]), device=dev)
    my = torch.as_tensor(np.stack([maps.map_y_l, maps.map_y_r]), device=dev)
    return remap_bilinear(imgs, mx, my)
