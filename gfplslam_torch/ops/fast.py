"""FAST-9 corner score, non-maximum suppression and keypoint selection.

Port of ``gfplslam_tpu/ops/fast.py`` (the reference's per-cell FAST,
ORBextractor.cc:809-941, and quadtree distribution, :539-765). The score map
has two implementations of one function:

- :func:`fast_score_cuda`, the hand-written kernel ``csrc/fast_score.cu``
  (replaces the Pallas kernel ``gfplslam_tpu/ops/pallas/fast_pl.py::
  _fast_score_kernel``), for CUDA tensors;
- :func:`fast_score_map_torch`, the plain PyTorch version, for CPU tensors and
  as the kernel's reference.

:func:`fast_score_map` picks by the tensor's device only. Both are bit-exact
with ``fast_score_map_xla``: bf16 image, bf16 differences and margins (each
subtraction rounded), comparisons on the bf16 values, the same windowed
min/max, non-finite -> 0, negatives clamped, 3-px border zeroed.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from gfplslam_torch.ops import kernels

# Bresenham circle of radius 3, clockwise from (0,-3): (dx, dy) pairs.
FAST_CIRCLE = np.array([
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
], dtype=np.int32)

ARC_LEN = 9  # FAST-9


def _threshold_tensor(threshold, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(threshold, dtype=torch.float32,
                           device=device).reshape(1)


def fast_score_cuda(imgs: torch.Tensor, threshold) -> torch.Tensor:
    """[B, H, W] f32 CUDA images -> [B, H, W] f32 FAST-9 scores, one launch.

    ``threshold`` is a float or a one-element f32 tensor on the images'
    device. The kernel reads it from device memory, so the adaptive-FAST
    loop passes its on-device threshold with no host read and no rebuild.
    """
    kernels.require_cuda(imgs, "imgs", torch.float32, 3)
    thr = _threshold_tensor(threshold, imgs.device)
    b, h, w = imgs.shape
    out = torch.empty_like(imgs)
    if out.numel() == 0:
        return out
    lib = kernels.load()
    err = lib.gfpl_fast_score(imgs.data_ptr(), out.data_ptr(), b, h, w,
                              thr.data_ptr(), kernels.stream_ptr(imgs.device))
    kernels.check(err, "gfpl_fast_score")
    fast_score_cuda.launches += 1
    return out


fast_score_cuda.launches = 0


def fast_score_map_torch(imgs: torch.Tensor, threshold) -> torch.Tensor:
    """Plain PyTorch FAST-9 score map, [..., H, W] f32 -> [..., H, W] f32."""
    h, w = imgs.shape[-2], imgs.shape[-1]
    img16 = imgs.to(torch.bfloat16)
    t = _threshold_tensor(threshold, imgs.device).to(torch.bfloat16)[0]
    d = torch.stack([torch.roll(img16, (-int(dy), -int(dx)), dims=(-2, -1))
                     for dx, dy in FAST_CIRCLE]) - img16
    neg = torch.full_like(d, float("-inf"))
    db = torch.where(d > t, d - t, neg)            # bright margin
    dd = torch.where(d < -t, -d - t, neg)          # dark margin

    def arc_score(x):
        xx = torch.cat([x, x[:ARC_LEN - 1]], 0)    # circular extension
        m = xx
        for s in (1, 2, 4):
            m = torch.minimum(m[:-s], m[s:])       # covers 2s
        wmin = torch.minimum(m[:16], xx[ARC_LEN - 1:])  # covers 9
        return wmin.amax(0)

    score = torch.maximum(arc_score(db), arc_score(dd)).float()
    score = torch.where(torch.isfinite(score), score, torch.zeros_like(score))
    score = torch.clamp(score, min=0.0)
    yy = torch.arange(h, device=imgs.device)[:, None]
    xx = torch.arange(w, device=imgs.device)[None, :]
    valid = (yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3)
    return torch.where(valid, score, torch.zeros_like(score))


def fast_score_map(imgs: torch.Tensor, threshold) -> torch.Tensor:
    """Per-pixel FAST-9 corner score (0 where not a corner),
    [..., H, W] f32. CUDA tensors go through the kernel, CPU tensors through
    the plain version; any other device raises."""
    if imgs.is_cuda:
        shape = imgs.shape
        out = fast_score_cuda(imgs.reshape(-1, *shape[-2:]).contiguous(),
                              threshold)
        return out.reshape(shape)
    if imgs.device.type == "cpu":
        return fast_score_map_torch(imgs, threshold)
    raise ValueError(f"fast_score_map: unsupported device {imgs.device}")


def nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression over [..., H, W]; keeps strict local maxima
    (roll wrap lands only on the zeroed border)."""
    r = torch.maximum(score, torch.maximum(torch.roll(score, 1, -2),
                                           torch.roll(score, -1, -2)))
    mx = torch.maximum(r, torch.maximum(torch.roll(r, 1, -1),
                                        torch.roll(r, -1, -1)))
    return torch.where((score >= mx) & (score > 0), score,
                       torch.zeros_like(score))


class Keypoints(NamedTuple):
    """Padded keypoint set for one image level (or merged levels)."""
    xy: torch.Tensor      # [..., N, 2] float32, this level's pixel coords
    level: torch.Tensor   # [..., N] int32 pyramid octave
    score: torch.Tensor   # [..., N] float32 response
    valid: torch.Tensor   # [..., N] bool


def select_keypoints(score: torch.Tensor, n_out: int, cell: int = 32,
                     per_cell: int = 4, border: int = 19,
                     valid_h: Sequence[int] | None = None,
                     valid_w: Sequence[int] | None = None) -> Keypoints:
    """NMS + per-cell top-k + global top-k over a batch of score maps
    [B, H, W]. Returns exactly ``n_out`` padded keypoints per map.
    ``valid_h``/``valid_w`` (one int per map) bound the live region of
    zero-padded pyramid levels. Ties go to the lower index, as in
    ``jax.lax.top_k`` and ``jnp.argmax``."""
    bsz, h, w = score.shape
    dev = score.device
    vh = [h] * bsz if valid_h is None else list(valid_h)
    vw = [w] * bsz if valid_w is None else list(valid_w)
    s = nms3(score)
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    # per-map masks from python ints: no host-to-device copy per frame
    inside = torch.stack([(yy >= border) & (yy < hb - border)
                          & (xx >= border) & (xx < wb - border)
                          for hb, wb in zip(vh, vw)])
    s = torch.where(inside, s, torch.zeros_like(s))
    ph = -(-h // cell) * cell
    pw = -(-w // cell) * cell
    s = torch.nn.functional.pad(s, (0, pw - w, 0, ph - h))
    gh, gw = ph // cell, pw // cell
    cells = (s.reshape(bsz, gh, cell, gw, cell).permute(0, 1, 3, 2, 4)
             .reshape(bsz, gh * gw, cell * cell))
    # per-cell top-k as k rounds of (argmax, suppress)
    top_s_l, top_i_l = [], []
    work = cells
    cols = torch.arange(cells.shape[-1], device=dev)
    for _ in range(per_cell):
        i = torch.argmax(work, dim=-1)
        v = torch.amax(work, dim=-1)
        top_s_l.append(v)
        top_i_l.append(i)
        work = torch.where(cols == i[..., None],
                           torch.full_like(work, float("-inf")), work)
    top_s = torch.stack(top_s_l, -1)                  # [B, gh*gw, per_cell]
    top_i = torch.stack(top_i_l, -1)
    ci = torch.arange(gh * gw, device=dev)[:, None]
    cy = torch.div(ci, gw, rounding_mode="floor") * cell \
        + torch.div(top_i, cell, rounding_mode="floor")
    cx = (ci % gw) * cell + top_i % cell
    flat_s = top_s.reshape(bsz, -1)
    flat_y = cy.reshape(bsz, -1)
    flat_x = cx.reshape(bsz, -1)
    k = min(n_out, flat_s.shape[-1])
    sel_s, sel_i = torch.sort(flat_s, dim=-1, descending=True, stable=True)
    sel_s, sel_i = sel_s[:, :k], sel_i[:, :k]
    pad = n_out - k
    sx = torch.gather(flat_x, 1, sel_i)
    sy = torch.gather(flat_y, 1, sel_i)

    def parab(sm1, s0, sp1):
        denom = sm1 - 2.0 * s0 + sp1
        denom = torch.where(torch.abs(denom) < 1e-6,
                            torch.full_like(denom, 1e-6), denom)
        return torch.clamp(0.5 * (sm1 - sp1) / denom, -0.5, 0.5)

    sxc = torch.clamp(sx, 1, pw - 2)
    syc = torch.clamp(sy, 1, ph - 2)
    raw = torch.nn.functional.pad(score, (0, pw - w, 0, ph - h)).reshape(bsz, -1)

    def at(y, x):
        return torch.gather(raw, 1, y * pw + x)

    dx_off = parab(at(syc, sxc - 1), at(syc, sxc), at(syc, sxc + 1))
    dy_off = parab(at(syc - 1, sxc), at(syc, sxc), at(syc + 1, sxc))
    xy = torch.stack([sx.float() + dx_off, sy.float() + dy_off], -1)
    out_s = sel_s
    if pad > 0:
        xy = torch.nn.functional.pad(xy, (0, 0, 0, pad))
        out_s = torch.nn.functional.pad(out_s, (0, pad))
    return Keypoints(xy=xy,
                     level=torch.zeros(bsz, n_out, dtype=torch.int32, device=dev),
                     score=out_s, valid=out_s > 0)
