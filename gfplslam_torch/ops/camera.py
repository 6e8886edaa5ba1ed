"""Pinhole stereo camera: projection and back-projection.

Port of the device-side half of ``gfplslam_tpu/ops/camera.py``
(pinholeStereoCamera.cpp:133-170). Every function takes a leading batch of
any shape in place of the reference's per-point form + ``vmap``.
Rectification (``stereo_rectify``, ``remap_bilinear``) is not ported yet: the
VO path takes rectified images.
"""

from __future__ import annotations

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
