"""ORB orientation + 256-bit steered BRIEF descriptors.

Port of the main-path half of ``gfplslam_tpu/ops/orb.py`` (ORBextractor.cc:
77-142, 1043-1105): dense intensity-centroid moment maps, and the
rotation-binned BRIEF that samples one (39, 40) patch per keypoint at the
centre angle of one of 32 rotation bins. The reference samples through a
one-hot selector matmul; here the same in-patch offsets are gathered
directly, which gives the same values exactly (a one-hot product of bf16
values accumulated in f32 is the value itself).

Descriptors are [N, 8] int32: the bit patterns of the reference's uint32
words.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from gfplslam_torch.ops.orb_pattern import orb_pool_pairs
from gfplslam_torch.ops.pyramid import _band_matrix

PATCH_RADIUS = 15          # orientation window radius (HALF_PATCH_SIZE)
DESC_BITS = 256
DESC_WORDS = 8             # 256 bits / 32
PATCH_R = 19               # covers rotated pool offsets: |p| <= 13*sqrt(2)
N_ROT_BINS = 32

BRIEF_POOL, BRIEF_PAIRS = orb_pool_pairs()


@lru_cache(maxsize=32)
def _box_band(n: int, radius: int, device: torch.device) -> torch.Tensor:
    ones = tuple([1.0] * (2 * radius + 1))
    return torch.from_numpy(np.minimum(_band_matrix(n, ones), 1.0)).to(device)


def _box_filter(x: torch.Tensor, radius: int) -> torch.Tensor:
    """(2r+1)-square box sum over [..., H, W], zero outside the image. f32
    throughout: the moment inputs reach ~2e5 and the caller subtracts nearly
    equal box sums."""
    h, w = x.shape[-2], x.shape[-1]
    mv = _box_band(h, radius, x.device)
    mh = _box_band(w, radius, x.device)
    return torch.matmul(torch.matmul(mv, x), mh.T)


def ic_angle_maps(img: torch.Tensor, radius: int = PATCH_RADIUS
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense centred first moments (m10, m01) over a square window, for
    every pixel of [..., H, W]."""
    h, w = img.shape[-2], img.shape[-1]
    xr = torch.arange(w, dtype=img.dtype, device=img.device)[None, :]
    yr = torch.arange(h, dtype=img.dtype, device=img.device)[:, None]
    s = _box_filter(img, radius)
    sx = _box_filter(img * xr, radius)
    sy = _box_filter(img * yr, radius)
    return sx - xr * s, sy - yr * s


def _round_index(v: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    return torch.clamp(torch.round(v).long(), lo, hi)


def ic_angles_dense(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """[B, H, W] images + [B, N, 2] keypoints -> [B, N] angles (radians)."""
    bsz, h, w = img.shape
    m10, m01 = ic_angle_maps(img)
    xi = _round_index(xy[..., 0], 0, w - 1)
    yi = _round_index(xy[..., 1], 0, h - 1)
    flat = yi * w + xi
    return torch.atan2(torch.gather(m01.reshape(bsz, -1), 1, flat),
                       torch.gather(m10.reshape(bsz, -1), 1, flat))


def brief_patches(img_blur: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """[B, H, W] blurred images + [B, N, 2] keypoints -> [B, N, 39*40] bf16
    patches. Rows past the bottom and columns past the right edge repeat the
    edge, as the reference's edge padding does."""
    bsz, h, w = img_blur.shape
    r = PATCH_R
    side_y, side_x = 2 * r + 1, 2 * r + 2
    dev = img_blur.device
    xi = _round_index(xy[..., 0], r, w - 1 - r)
    yi = _round_index(xy[..., 1], r, h - 1 - r)
    rows = torch.clamp((yi - r)[..., None] + torch.arange(side_y, device=dev),
                       max=h - 1)                              # [B, N, 39]
    cols = torch.clamp((xi - r)[..., None] + torch.arange(side_x, device=dev),
                       max=w - 1)                              # [B, N, 40]
    idx = (rows[..., :, None] * w + cols[..., None, :]).reshape(bsz, -1)
    patches = torch.gather(img_blur.reshape(bsz, -1), 1, idx)
    return patches.reshape(bsz, xy.shape[1], side_y * side_x).to(torch.bfloat16)


@lru_cache(maxsize=8)
def _rotation_offsets(device: torch.device) -> torch.Tensor:
    """[32, P] flattened in-patch index of every pool offset rotated to each
    rotation-bin centre (the reference's selector columns)."""
    pool = np.asarray(BRIEF_POOL, np.float32)
    ang = (np.arange(N_ROT_BINS) + 0.5) * (2 * np.pi / N_ROT_BINS)
    ca, sa = np.cos(ang), np.sin(ang)
    rx = np.round(ca[:, None] * pool[None, :, 0]
                  - sa[:, None] * pool[None, :, 1]).astype(np.int64)
    ry = np.round(sa[:, None] * pool[None, :, 0]
                  + ca[:, None] * pool[None, :, 1]).astype(np.int64)
    idx = (ry + PATCH_R) * (2 * PATCH_R + 2) + (rx + PATCH_R)
    return torch.from_numpy(idx).to(device)


@lru_cache(maxsize=8)
def _pairs(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(BRIEF_PAIRS, np.int64)).to(device)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[..., 256] bool -> [..., 8] int32 (bit j of word k = bit 32k+j), the
    bit patterns of the reference's uint32 words."""
    words = bits.reshape(*bits.shape[:-1], DESC_WORDS, 32).long()
    shifts = torch.arange(32, device=bits.device)
    v = (words << shifts).sum(-1)
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def _remainder(a: torch.Tensor, b: float) -> torch.Tensor:
    """Floor-mod with the divisor's sign, as ``jnp.remainder`` computes it
    (fmod, then add the divisor where the signs differ)."""
    r = torch.fmod(a, b)
    return torch.where((r != 0) & ((r < 0) != (b < 0)), r + b, r)


def brief_from_patches(pf: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """[N, E] bf16 patches + [N] angles -> [N, 8] int32 descriptors."""
    two_pi = 2.0 * np.pi
    bin_f = torch.floor(_remainder(angles, two_pi) / (two_pi / N_ROT_BINS))
    # an out-of-range bin one-hot-encodes to zeros in the reference
    in_range = (bin_f >= 0) & (bin_f < N_ROT_BINS)
    bin_i = torch.clamp(bin_f, 0, N_ROT_BINS - 1).long()
    idx = _rotation_offsets(pf.device)[bin_i]                  # [N, P]
    vals = torch.gather(pf.float(), 1, idx)
    vals = torch.where(in_range[:, None], vals, torch.zeros_like(vals))
    pairs = _pairs(pf.device)
    bits = vals[:, pairs[:, 0]] < vals[:, pairs[:, 1]]
    return pack_bits(bits)
