"""Masked parallel match selection: mutual-best, budgets, per-target dedup.

Port of ``gfplslam_tpu/ops/matching.py`` (the reference's
matcher post-processing, stereoFrameHandler.cpp:451-695). Ties resolve as in
the reference: ``argmin`` returns the first index and sorts are stable.
Indices are int64 (torch's index type).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gfplslam_torch.ops.hamming import BIG
from gfplslam_torch.utils.robust import masked_median, masked_stdv_mad_nozero

_INT32_MAX = 2 ** 31 - 1


class Matches(NamedTuple):
    """Per-row (query) match result over a [N, M] distance matrix."""
    idx: torch.Tensor    # [N] int64 best column per row
    dist: torch.Tensor   # [N] float32 best distance
    valid: torch.Tensor  # [N] bool


def best2(d: torch.Tensor):
    """Per-row best index, best dist, second-best dist of [N, M]."""
    dd = d.float()
    i1 = torch.argmin(dd, dim=1)
    d1 = torch.amin(dd, dim=1)
    cols = torch.arange(d.shape[1], device=d.device)
    masked = torch.where(cols[None, :] == i1[:, None],
                         torch.full_like(dd, float("inf")), dd)
    return i1, d1, torch.amin(masked, dim=1)


def mutual_best(d: torch.Tensor) -> Matches:
    """Row i matches col j iff argmin_j d[i, :] = j and argmin_i d[:, j] = i
    (best_lr_matches, stereoFrame.cpp:645-658)."""
    i1, d1, _ = best2(d)
    col_best = torch.argmin(d.float(), dim=0)
    ok = col_best[i1] == torch.arange(d.shape[0], device=d.device)
    ok &= d1 < float(BIG)
    return Matches(idx=i1, dist=d1, valid=ok)


def ratio_gate(m: Matches, d2: torch.Tensor, max_ratio: float) -> Matches:
    """Nearest/second-nearest ratio test (max_ratio_12_p, config.cpp:103)."""
    return m._replace(valid=m.valid & (m.dist < max_ratio * d2))


def mad_gate(m: Matches, rel_th: float) -> Matches:
    """Median + MAD relative distance gate, as the reference applies to line
    (and hybrid point) matches: keep d < median + k*mad
    (stereoFrameHandler.cpp:660-686 pattern)."""
    med = masked_median(m.dist, m.valid)
    mad = masked_stdv_mad_nozero(m.dist, m.valid)
    return m._replace(valid=m.valid & (m.dist < med + rel_th * mad))


def budget_gate(m: Matches, budget: int) -> Matches:
    """Keep the ``budget`` best matches, and only those within 1.2x the
    K-th best distance (stereoFrameHandler.cpp:658-660, 678-683)."""
    key = torch.where(m.valid, m.dist, torch.full_like(m.dist, float("inf")))
    order = torch.sort(key, stable=True).indices
    n = order.shape[0]
    rank = torch.empty_like(order).scatter_(
        0, order, torch.arange(n, device=order.device))
    k = min(budget, n)
    kth = key.index_select(0, order[k - 1:k])[0]
    dist_ok = torch.where(torch.isfinite(kth), m.dist <= 1.2 * kth,
                          torch.ones_like(m.valid))
    return m._replace(valid=m.valid & (rank < budget) & dist_ok)


def dedup_per_target(m: Matches, n_targets: int) -> Matches:
    """Among rows matched to the same column keep the lowest-distance row;
    exact ties go to the first row (stereoFrameHandler.cpp:551-599)."""
    key = torch.where(m.valid, m.dist, torch.full_like(m.dist, float("inf")))
    best_d = torch.full((n_targets,), float("inf"), device=key.device
                        ).scatter_reduce(0, m.idx, key, "amin")
    attains = m.valid & (key <= best_d[m.idx])
    rows = torch.arange(key.shape[0], device=key.device)
    first_row = torch.full((n_targets,), _INT32_MAX, dtype=torch.int64,
                           device=key.device).scatter_reduce(
        0, torch.where(attains, m.idx, torch.full_like(m.idx, n_targets - 1)),
        torch.where(attains, rows, torch.full_like(rows, _INT32_MAX)), "amin")
    return m._replace(valid=attains & (first_row[m.idx] == rows))
