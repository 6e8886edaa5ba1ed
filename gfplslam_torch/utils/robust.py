"""Robust statistics over masked arrays (port of
``gfplslam_tpu/utils/robust.py``; the reference's ``vector_stdv_mad``,
auxiliar.cpp:104-141). Every statistic takes an explicit validity mask and
reduces over the last axis, so it works on fixed-capacity padded arrays with
no host read."""

from __future__ import annotations

import torch

_MAD_SCALE = 1.4826  # consistency constant for normal data (auxiliar.cpp:115)


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of ``x[mask]`` over the last axis; 0 when nothing is valid.

    Sorts with invalid entries pushed to +inf and gathers the middle of the
    valid prefix."""
    size = x.shape[-1]
    n = mask.sum(-1)
    xs = torch.sort(torch.where(mask, x, torch.full_like(x, float("inf"))),
                    dim=-1).values
    lo = torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), 0, size - 1)
    hi = torch.clamp(torch.div(n, 2, rounding_mode="floor"), 0, size - 1)
    med = 0.5 * (torch.take_along_dim(xs, lo[..., None], -1)[..., 0]
                 + torch.take_along_dim(xs, hi[..., None], -1)[..., 0])
    return torch.where(n > 0, med, torch.zeros_like(med))


def masked_stdv_mad(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """1.4826 * median(|x - median(x)|) over valid entries."""
    med = masked_median(x, mask)
    return _MAD_SCALE * masked_median(torch.abs(x - med[..., None]), mask)


def masked_stdv_mad_nozero(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """MAD stdev with a 1e-6 floor (vector_stdv_mad_nozero)."""
    return torch.clamp(masked_stdv_mad(x, mask), min=1e-6)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim=None) -> torch.Tensor:
    xm = torch.where(mask, x, torch.zeros_like(x))
    if dim is None:
        return xm.sum() / torch.clamp(mask.sum(), min=1)
    return xm.sum(dim) / torch.clamp(mask.sum(dim), min=1)
