"""Line-segment detection as dense shift/run-length passes + a fragment merge.

Port of ``gfplslam_tpu/ops/lsd.py`` (the reference's LSD wrapper,
LSDDetector_custom.cpp:218-281). Same algorithm and constants, written over
a leading batch of images (``[B, H, W]``) in place of the reference's
``vmap`` over cameras:

1. Gaussian smooth + Sobel; support where |g| exceeds LSD's ``quant /
   sin(ang_th)``; 16 gradient-angle bins (8 orientations x 2 polarities).
2. Per bin: 3x3-dilated corridor and run lengths along the bin's lattice step
   by logarithmic doubling of rolls; run ends with 3x3 NMS.
3. Top-K run ends (index-encoded keys, so ties cannot reorder) -> fragments,
   refined by gradient-weighted perpendicular centroids + weighted PCA.
4. Collinear fragments merged by connected components over an [F, F]
   adjacency; length / width / density gates; top ``n_out`` by length.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from gfplslam_torch.ops.pyramid import gaussian_blur, sobel

F_SLOTS = 1024       # fragment capacity between extraction and merging
N_SAMPLES = 8        # refinement samples along each fragment
N_PERP = 5           # perpendicular taps per sample (offsets -2..2)

# Lattice step (dx, dy) whose direction best approximates line angle
# s * 22.5 deg (x right, y down); max mismatch 4.1 deg.
STEPS = np.array([
    (1, 0), (2, 1), (1, 1), (1, 2), (0, 1), (-1, 2), (-1, 1), (-2, 1),
], dtype=np.int32)
STEP_LEN = np.sqrt((STEPS ** 2).sum(axis=1)).astype(np.float32)
_KEY_SHIFT = 1 << 19  # fragment keys: quantized length << 19 | position


class LineSegments(NamedTuple):
    sp: torch.Tensor      # [B, N, 2] float32 start point (x, y)
    ep: torch.Tensor      # [B, N, 2] float32 end point (x, y)
    angle: torch.Tensor   # [B, N] float32 orientation in (-pi, pi]
    length: torch.Tensor  # [B, N] float32
    score: torch.Tensor   # [B, N] float32 response (avg gradient magnitude)
    valid: torch.Tensor   # [B, N] bool


def _roll2(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    return torch.roll(x, (dy, dx), dims=(-2, -1))


def _max3(x: torch.Tensor) -> torch.Tensor:
    """Separable 3x3 max via rolls over [..., H, W]."""
    r = torch.maximum(x, torch.maximum(_roll2(x, 1, 0), _roll2(x, -1, 0)))
    return torch.maximum(r, torch.maximum(_roll2(r, 0, 1), _roll2(r, 0, -1)))


def _dilate3(m: torch.Tensor) -> torch.Tensor:
    """3x3 binary dilation (staircase tolerance for oblique runs)."""
    r = m | _roll2(m, 1, 0) | _roll2(m, -1, 0)
    return r | _roll2(r, 0, 1) | _roll2(r, 0, -1)


def _position_code(h: int, w: int, device) -> torch.Tensor:
    return (torch.arange(h * w, dtype=torch.int32, device=device)
            .reshape(h, w) % _KEY_SHIFT)


def _length_key(length: torch.Tensor) -> torch.Tensor:
    return (torch.clamp(torch.round(length * 4.0), max=4000.0)
            .to(torch.int32) * _KEY_SHIFT)


def _run_ends(support: torch.Tensor, bin16: torch.Tensor, rounds: int):
    """Dense run-length doubling over the 16 orientation/polarity bins of
    [B, H, W] maps. Returns (best_len_px, best_bin): at each run-end pixel
    the longest run's pixel length and its bin; 0 elsewhere."""
    vals = []
    for k in range(16):
        cor = _dilate3(support & (bin16 == k))
        dx, dy = int(STEPS[(k + 4) % 8][0]), int(STEPS[(k + 4) % 8][1])
        ln = cor.to(torch.int16)            # runs <= 2^rounds fit int16
        for r in range(rounds):
            behind = _roll2(ln, (1 << r) * dy, (1 << r) * dx)
            ln = ln + torch.where(ln == (1 << r), behind, torch.zeros_like(ln))
        endmask = cor & ~_roll2(cor, -dy, -dx)
        vals.append(torch.where(endmask, ln.float() * float(STEP_LEN[(k + 4) % 8]),
                                torch.zeros_like(ln, dtype=torch.float32)))
    v = torch.stack(vals)                   # [16, B, H, W]
    best = v.amax(0)
    best_bin = torch.argmax(v, dim=0).to(torch.int32)
    # 3x3 NMS with positional tie-break: keep one end pixel per neighborhood
    enc = _length_key(best) + _position_code(*best.shape[-2:], best.device)
    best = torch.where((enc == _max3(enc)) & (best > 0), best,
                       torch.zeros_like(best))
    return best, best_bin


def _norm2(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(v[..., 0] ** 2 + v[..., 1] ** 2)


@lru_cache(maxsize=8)
def _sample_t(device: torch.device) -> torch.Tensor:
    """The reference's ``jnp.linspace(0, 1, N_SAMPLES)`` bit for bit
    (iota times the f32 step, last entry exactly 1)."""
    step = float(np.float32(1.0) / np.float32(N_SAMPLES - 1))
    t = torch.arange(N_SAMPLES, dtype=torch.float32, device=device) * step
    t[-1] = 1.0
    return t


def _refine_fragments(gx, gy, bin_ang, start, end, rho: float):
    """Sub-pixel refinement: gradient-weighted perpendicular centroids at
    N_SAMPLES points -> weighted PCA line fit, per fragment of [B, F].
    Returns (center, dir unit, sp, ep, width, density, wsum, dispersion)."""
    bsz, h, w = gx.shape
    dev = gx.device
    t = _sample_t(dev)[None, None, :, None]                  # [1, 1, S, 1]
    pos = start[:, :, None, :] + t * (end - start)[:, :, None, :]  # [B,F,S,2]
    seg = end - start
    seg_n = torch.clamp(_norm2(seg), min=1e-6)[..., None]
    dirc = seg / seg_n                                       # [B, F, 2]
    nrm = torch.stack([-dirc[..., 1], dirc[..., 0]], -1)
    offs = torch.arange(-(N_PERP // 2), N_PERP // 2 + 1, dtype=torch.float32,
                        device=dev)                          # [5]
    taps = (pos[:, :, :, None, :]
            + offs[:, None] * nrm[:, :, None, None, :])      # [B,F,S,5,2]
    xi = torch.clamp(torch.round(taps[..., 0]).long(), 0, w - 1)
    yi = torch.clamp(torch.round(taps[..., 1]).long(), 0, h - 1)
    flat = (yi * w + xi).reshape(bsz, -1)
    gxt = torch.gather(gx.reshape(bsz, -1), 1, flat).reshape(xi.shape)
    gyt = torch.gather(gy.reshape(bsz, -1), 1, flat).reshape(xi.shape)
    mag_tap = torch.sqrt(gxt ** 2 + gyt ** 2)
    ga_tap = torch.atan2(gyt, gxt)
    ba = bin_ang[:, :, None, None]
    pol = torch.clamp(torch.cos(ga_tap - ba), min=0.0)
    # noise floor: only support-strength taps carry weight
    wts = torch.clamp(mag_tap * pol * pol - 0.5 * rho, min=0.0)  # [B,F,S,5]
    wsum_s = wts.sum(-1)                                     # [B, F, S]
    safe = torch.clamp(wsum_s, min=1e-6)
    perp_off = (wts * offs).sum(-1) / safe
    pts = pos + perp_off[..., None] * nrm[:, :, None, :]     # [B, F, S, 2]
    # stroke width from the perpendicular second moment (W^2/12 for width W)
    var_perp = torch.clamp((wts * offs ** 2).sum(-1) / safe - perp_off ** 2,
                           min=0.0)
    width = torch.sqrt(12.0 * (var_perp * wsum_s).sum(-1)
                       / torch.clamp(wsum_s.sum(-1), min=1e-6))
    density = (wts.amax(-1) > rho).float().mean(-1)
    # orientation dispersion: a straight edge has near-constant gradient angle
    da = 2.0 * (ga_tap - ba)
    wall = wts.sum((-2, -1))
    rbar = torch.sqrt((wts * torch.cos(da)).sum((-2, -1)) ** 2
                      + (wts * torch.sin(da)).sum((-2, -1)) ** 2
                      ) / torch.clamp(wall, min=1e-6)
    dispersion = 1.0 - rbar
    # weighted PCA
    wsum = wsum_s.sum(-1)                                    # [B, F]
    wn = wsum_s / torch.clamp(wsum, min=1e-6)[..., None]
    c = (wn[..., None] * pts).sum(-2)                        # [B, F, 2]
    d = pts - c[:, :, None, :]
    sxx = (wn * d[..., 0] ** 2).sum(-1)
    sxy = (wn * d[..., 0] * d[..., 1]).sum(-1)
    syy = (wn * d[..., 1] ** 2).sum(-1)
    tr = sxx + syy
    disc = torch.sqrt(torch.clamp(tr * tr / 4 - (sxx * syy - sxy * sxy),
                                  min=0.0))
    lam1 = tr / 2 + disc
    # principal eigenvector; with sxy ~ 0 the axes are the eigenvectors
    off_diag = torch.abs(sxy) > 1e-9
    one, zero = torch.ones_like(sxx), torch.zeros_like(sxx)
    ex = torch.where(off_diag, lam1 - syy, torch.where(sxx >= syy, one, zero))
    ey = torch.where(off_diag, sxy, torch.where(sxx >= syy, zero, one))
    en = torch.clamp(torch.sqrt(ex * ex + ey * ey), min=1e-9)
    fit = torch.stack([ex / en, ey / en], -1)
    flip = (fit * dirc).sum(-1) < 0
    fit = torch.where(flip[..., None], -fit, fit)
    good = (wsum > 1e-3)[..., None]
    fit = torch.where(good, fit, dirc)
    c = torch.where(good, c, 0.5 * (start + end))
    t_sp = ((start - c) * fit).sum(-1)
    t_ep = ((end - c) * fit).sum(-1)
    sp = c + t_sp[..., None] * fit
    ep = c + t_ep[..., None] * fit
    return c, fit, sp, ep, width, density, wsum, dispersion


def _merge_collinear(c, dirv, sp, ep, length, support_px, width, wsum, valid,
                     max_gap: float = 4.0, max_perp: float = 2.0,
                     min_cos: float = float(np.cos(np.deg2rad(12.0)))):
    """Connected components over a dense fragment-collinearity adjacency
    ([B, F, F]); returns per-root merged segments (non-roots invalid)."""
    bsz, f = c.shape[:2]
    dev = c.device
    delta = c[:, None, :, :] - c[:, :, None, :]              # [B, F, F, 2]
    di = dirv[:, :, None, :]
    dots = torch.abs((di * dirv[:, None, :, :]).sum(-1))
    perp = torch.abs(di[..., 0] * delta[..., 1] - di[..., 1] * delta[..., 0])
    along = torch.abs((di * delta).sum(-1))
    gap = along - 0.5 * (length[:, :, None] + length[:, None, :])
    adj = ((dots > min_cos) & (perp < max_perp) & (gap < max_gap)
           & valid[:, :, None] & valid[:, None, :])
    adj = adj | torch.eye(f, dtype=torch.bool, device=dev)

    ar = torch.arange(f, device=dev)
    lab = torch.where(valid, ar, torch.full_like(ar, f - 1))
    for _ in range(6):
        neigh = torch.where(adj, lab[:, None, :],
                            torch.full_like(lab[:, None, :], f)).amin(-1)
        lab = torch.minimum(lab, neigh)
        lab = torch.gather(lab, 1, lab)
        lab = torch.gather(lab, 1, lab)

    lab2 = lab[..., None].expand(-1, -1, 2)
    dir_r = torch.gather(dirv, 1, lab2)
    c_r = torch.gather(c, 1, lab2)
    t_sp = ((sp - c_r) * dir_r).sum(-1)
    t_ep = ((ep - c_r) * dir_r).sum(-1)
    big = 1e9
    t_lo = torch.minimum(t_sp, t_ep)
    t_hi = torch.maximum(t_sp, t_ep)

    def seg_reduce(init, vals, fill, how):
        return torch.full((bsz, f), init, device=dev).scatter_reduce(
            1, lab, torch.where(valid, vals, torch.full_like(vals, fill)), how)

    tmin = seg_reduce(big, t_lo, big, "amin")
    tmax = seg_reduce(-big, t_hi, -big, "amax")
    sup = seg_reduce(0.0, support_px, 0.0, "sum")
    wtot = seg_reduce(0.0, wsum, 0.0, "sum")
    wid = seg_reduce(0.0, width, 0.0, "amax")

    is_root = valid & (lab == ar)
    mlen = torch.where(is_root, tmax - tmin, torch.zeros_like(tmax))
    msp = c + tmin[..., None] * dirv
    mep = c + tmax[..., None] * dirv
    return is_root, msp, mep, mlen, sup, wid, wtot


@lru_cache(maxsize=8)
def _tables(device: torch.device):
    centers = np.stack([np.cos(np.arange(16) * np.pi / 8),
                        np.sin(np.arange(16) * np.pi / 8)]).astype(np.float32)
    return (torch.from_numpy(centers).to(device),
            torch.from_numpy(STEPS.astype(np.float32)).to(device),
            torch.from_numpy(STEP_LEN).to(device))


def detect_lines(img: torch.Tensor, n_out: int = 512, rounds: int = 9,
                 ang_th_deg: float = 22.5, quant: float = 2.0,
                 min_rel_length: float = 0.025,
                 max_width: float = 3.0) -> LineSegments:
    """[B, H, W] float32 images -> padded LineSegments (level-0 coords)."""
    bsz, h, w = img.shape
    dev = img.device
    # fragment keys hold the pixel position in their low 19 bits
    if h * w >= _KEY_SHIFT:
        raise ValueError(
            f"detect_lines supports h*w < 2^19 = 524288 pixels, got "
            f"{h}x{w} = {h * w}; widen the fragment top-K key encoding "
            "(quantized length << 19 | position) for larger cameras")
    centers, steps_t, step_len_t = _tables(dev)
    gx, gy = sobel(gaussian_blur(img, sigma=0.8, radius=2))
    # Sobel has gain 8 vs the 2x2 LSD gradient
    gx = gx / 8.0
    gy = gy / 8.0
    rho = quant / np.sin(float(np.deg2rad(ang_th_deg)))

    # nearest of 16 sector centres == argmax of the dot with their unit
    # vectors; support compares squared magnitudes
    dots = torch.stack([gx, gy], -1).reshape(-1, 2) @ centers   # [BHW, 16]
    bin16 = torch.argmax(dots, dim=1).to(torch.int32).reshape(bsz, h, w)
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    support = (((gx * gx + gy * gy) > (rho * rho))
               & (yy > 1) & (yy < h - 2) & (xx > 1) & (xx < w - 2))

    best_len, best_bin = _run_ends(support, bin16, rounds)

    # fragment extraction: best end per 2x4 block, then top-K of the keys
    hp = -(-h // 2) * 2
    wp = -(-w // 4) * 4
    f = min(F_SLOTS, (hp // 2) * (wp // 4))
    enc_full = torch.where(best_len > 0,
                           _length_key(best_len) + _position_code(h, w, dev),
                           torch.zeros((), dtype=torch.int32, device=dev))
    enc_pad = torch.nn.functional.pad(enc_full, (0, wp - w, 0, hp - h))
    blocks = enc_pad.reshape(bsz, hp // 2, 2, wp // 4, 4).amax((2, 4))
    keys = torch.sort(blocks.reshape(bsz, -1), dim=-1, descending=True,
                      stable=True).values[:, :f]
    idx = (keys % _KEY_SHIFT).long()
    vals = torch.where(keys > 0, torch.gather(best_len.reshape(bsz, -1), 1, idx),
                       torch.zeros_like(keys, dtype=torch.float32))
    frag_ok = vals >= 3.0                       # minimum fragment extent (px)
    ex = (idx % w).float()
    ey = torch.div(idx, w, rounding_mode="floor").float()
    kbin = torch.gather(best_bin.reshape(bsz, -1), 1, idx).long()
    step = steps_t[(kbin + 4) % 8]                          # [B, F, 2]
    slen = step_len_t[(kbin + 4) % 8]
    nsteps = torch.clamp(torch.round(vals / slen), min=1.0)
    end = torch.stack([ex, ey], -1)
    start = end - (nsteps - 1.0)[..., None] * step

    bin_ang = kbin.float() * float(np.pi / 8)
    c, dirv, sp, ep, width, density, wsum, disp = _refine_fragments(
        gx, gy, bin_ang, start, end, rho)
    length = _norm2(ep - sp)
    frag_ok &= torch.isfinite(length) & (density > 0.4) & (disp < 0.25)

    is_root, msp, mep, mlen, sup, wid, wtot = _merge_collinear(
        c, dirv, sp, ep, length, vals, width, wsum, frag_ok)

    # gates mirroring the reference filters
    diag = float(np.hypot(h, w))
    ok = (is_root & (mlen >= min_rel_length * diag) & (wid <= max_width)
          & (torch.clamp(sup / torch.clamp(mlen, min=1.0), 0.0, 2.0) >= 0.6)
          & torch.isfinite(mlen))
    score = wtot / torch.clamp(mlen, min=1.0)
    order = torch.sort(torch.where(ok, -mlen, torch.full_like(mlen, float("inf"))),
                       dim=-1, stable=True).indices[:, :n_out]

    def g(a):
        out = torch.gather(a, 1, order)
        if n_out > order.shape[1]:
            out = torch.nn.functional.pad(out, (0, n_out - order.shape[1]))
        return out

    spx, spy = msp[..., 0], msp[..., 1]
    epx, epy = mep[..., 0], mep[..., 1]
    # canonical endpoint order: sp.x <= ep.x (ties: smaller y first)
    swap = (epx < spx) | ((epx == spx) & (epy < spy))
    spx2 = torch.where(swap, epx, spx)
    spy2 = torch.where(swap, epy, spy)
    epx2 = torch.where(swap, spx, epx)
    epy2 = torch.where(swap, spy, epy)
    angle = torch.atan2(epy2 - spy2, epx2 - spx2)
    return LineSegments(
        sp=torch.stack([g(spx2), g(spy2)], -1),
        ep=torch.stack([g(epx2), g(epy2)], -1),
        angle=g(angle), length=g(mlen), score=g(score), valid=g(ok))
