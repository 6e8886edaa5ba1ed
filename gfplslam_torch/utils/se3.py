"""SE(3) Lie-group math and covariance transport on torch tensors.

Port of ``gfplslam_tpu/utils/se3.py`` (the reference's Eigen helpers,
auxiliar.cpp:154-310). Every function takes a leading batch of any shape
(``[..., 6]`` twists, ``[..., 4, 4]`` transforms), which replaces the
reference's write-for-one + ``vmap`` form.

Convention: twists are ``[rho (translation), phi (rotation)]``.
"""

from __future__ import annotations

import torch

_EPS = 1e-9


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(-1)


def skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] skew-symmetric matrix."""
    z = torch.zeros_like(v[..., 0])
    x, y, w = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([
        torch.stack([z, -w, y], -1),
        torch.stack([w, z, -x], -1),
        torch.stack([-y, x, z], -1),
    ], -2)


def _sinc_coeffs(theta2: torch.Tensor):
    """Taylor-safe (A, B, C) = (sin t / t, (1-cos t)/t^2, (1 - A)/t^2)."""
    theta = torch.sqrt(theta2 + _EPS)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - a) / theta2)
    return a, b, c


def _skew_sq(phi: torch.Tensor) -> torch.Tensor:
    """K(phi)^2 = phi phi^T - |phi|^2 I, without a matmul."""
    theta2 = _dot(phi, phi)
    return (phi[..., :, None] * phi[..., None, :]
            - theta2[..., None, None] * _eye(3, phi))


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation: [..., 3] -> [..., 3, 3]."""
    a, b, _ = _sinc_coeffs(_dot(phi, phi))
    return (_eye(3, phi) + a[..., None, None] * skew(phi)
            + b[..., None, None] * _skew_sq(phi))


def so3_log(r: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation -> [..., 3] rotation vector (atan2 form, with the
    near-pi axis branch of the reference)."""
    tr = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    cos_t = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    w = 0.5 * torch.stack([r[..., 2, 1] - r[..., 1, 2],
                           r[..., 0, 2] - r[..., 2, 0],
                           r[..., 1, 0] - r[..., 0, 1]], -1)
    sin_t = torch.sqrt(_dot(w, w) + 1e-24)
    theta = torch.atan2(sin_t, cos_t)
    scale = torch.where(theta < 1e-6, 1.0 + theta * theta / 6.0,
                        theta / torch.clamp(sin_t, min=_EPS))
    generic = scale[..., None] * w
    rr = (r + _eye(3, r)) * 0.5
    diag = torch.clamp(torch.diagonal(rr, dim1=-2, dim2=-1), min=0.0)
    axis_sq = torch.sqrt(diag + _EPS)
    k = torch.argmax(diag, dim=-1)
    col = torch.take_along_dim(rr, k[..., None, None].expand(
        *k.shape, 3, 1), dim=-1)[..., 0]
    col = col / torch.clamp(torch.take_along_dim(
        axis_sq, k[..., None], dim=-1), min=_EPS)
    axis = col / torch.clamp(torch.linalg.vector_norm(col, dim=-1,
                                                      keepdim=True), min=_EPS)
    sign = torch.where(_dot(axis, w) < 0, -1.0, 1.0)
    near_pi = (theta * sign)[..., None] * axis
    return torch.where((theta > 3.1415)[..., None], near_pi, generic)


def left_jacobian_so3(phi: torch.Tensor) -> torch.Tensor:
    """V in exp([rho, phi]) = [R, V rho; 0 1]."""
    _, b, c = _sinc_coeffs(_dot(phi, phi))
    return (_eye(3, phi) + b[..., None, None] * skew(phi)
            + c[..., None, None] * _skew_sq(phi))


def _homogeneous(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    top = torch.cat([r, t[..., :, None]], -1)
    bot = torch.zeros_like(top[..., :1, :])
    bot[..., 0, 3] = 1.0
    return torch.cat([top, bot], -2)


def expmap_se3(x: torch.Tensor) -> torch.Tensor:
    """[..., 6] twist -> [..., 4, 4] transform."""
    rho, phi = x[..., :3], x[..., 3:]
    r = so3_exp(phi)
    t = (left_jacobian_so3(phi) @ rho[..., :, None])[..., 0]
    return _homogeneous(r, t)


def logmap_se3(t: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] transform -> [..., 6] twist."""
    phi = so3_log(t[..., :3, :3])
    v = left_jacobian_so3(phi)
    rho = torch.linalg.solve(v, t[..., :3, 3])
    return torch.cat([rho, phi], -1)


def inverse_se3(t: torch.Tensor) -> torch.Tensor:
    """Closed-form SE(3) inverse."""
    rt = t[..., :3, :3].transpose(-1, -2)
    p = t[..., :3, 3]
    return _homogeneous(rt, -(rt @ p[..., :, None])[..., 0])


def adjoint_se3(t: torch.Tensor) -> torch.Tensor:
    """[..., 6, 6] adjoint of T, ordering [rho, phi]."""
    r = t[..., :3, :3]
    top = torch.cat([r, skew(t[..., :3, 3]) @ r], -1)
    bot = torch.cat([torch.zeros_like(r), r], -1)
    return torch.cat([top, bot], -2)


def transport_cov_se3(t: torch.Tensor, cov: torch.Tensor) -> torch.Tensor:
    """Adj(T) cov Adj(T)^T."""
    adj = adjoint_se3(t)
    return adj @ cov @ adj.transpose(-1, -2)


def is_finite(x: torch.Tensor) -> torch.Tensor:
    """All-finite predicate, as a 0-d bool tensor (no host read)."""
    return torch.isfinite(x).all()
