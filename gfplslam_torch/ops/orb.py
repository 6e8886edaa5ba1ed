"""ORB orientation + 256-bit steered BRIEF descriptors.

Port of ``gfplslam_tpu/ops/orb.py`` (ORBextractor.cc: 77-142, 1043-1105).
The main path uses the dense intensity-centroid moment maps and the
rotation-binned BRIEF that samples one (39, 40) patch per keypoint at the
centre angle of one of 32 rotation bins. The reference samples through a
one-hot selector matmul; here the same in-patch offsets are gathered
directly, which gives the same values exactly (a one-hot product of bf16
values accumulated in f32 is the value itself). Off the main path: the
disc-patch orientation (``ic_angles``), the per-keypoint steered BRIEF
(``brief_descriptors``, ``brief_descriptors_patch``) and the generated
Gaussian sampling pool that ``set_pattern("random")`` selects for A/B runs
(``apps/ab_orb_pattern.py``).

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


def _disc_mask(radius: int) -> np.ndarray:
    y, x = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    return (x * x + y * y <= radius * radius).astype(np.float32)


_DISC = _disc_mask(PATCH_RADIUS)
_DISC_X = (_DISC * np.mgrid[-PATCH_RADIUS:PATCH_RADIUS + 1,
                            -PATCH_RADIUS:PATCH_RADIUS + 1][1]).astype(np.float32)
_DISC_Y = (_DISC * np.mgrid[-PATCH_RADIUS:PATCH_RADIUS + 1,
                            -PATCH_RADIUS:PATCH_RADIUS + 1][0]).astype(np.float32)


def make_brief_pattern(seed: int = 1234, n_bits: int = DESC_BITS,
                       radius: int = 13) -> np.ndarray:
    """[n_bits, 4] int32 (x1, y1, x2, y2) — BRIEF-II isotropic Gaussian pairs,
    sigma = patch_size/5, clipped to the sampling radius. Deterministic."""
    rng = np.random.default_rng(seed)
    sigma = (2 * radius + 1) / 5.0
    pts = rng.normal(scale=sigma, size=(n_bits, 4))
    return np.clip(np.round(pts), -radius, radius).astype(np.int32)


BRIEF_PATTERN = make_brief_pattern()


def make_brief_pool(seed: int = 1234, n_pool: int = DESC_BITS,
                    n_bits: int = DESC_BITS, radius: int = 13):
    """Sample-pool BRIEF: ``n_pool`` isotropic-Gaussian offsets plus
    ``n_bits`` comparison pairs drawn from the pool (each sample feeds ~2
    bits). Deterministic."""
    rng = np.random.default_rng(seed)
    sigma = (2 * radius + 1) / 5.0
    pool = np.clip(np.round(rng.normal(scale=sigma, size=(n_pool, 2))),
                   -radius, radius).astype(np.int32)
    pairs = set()
    out = []
    while len(out) < n_bits:
        i, j = rng.integers(0, n_pool, 2)
        key = (min(i, j), max(i, j))
        if i != j and key not in pairs and not np.array_equal(pool[i], pool[j]):
            pairs.add(key)
            out.append((i, j))
    return pool, np.asarray(out, np.int32)


RANDOM_POOL, RANDOM_PAIRS = make_brief_pool()
ORB_POOL, ORB_PAIRS = orb_pool_pairs()

# active pattern (learned ORB table by default; see set_pattern)
BRIEF_POOL, BRIEF_PAIRS = ORB_POOL, ORB_PAIRS


def set_pattern(kind: str = "orb") -> None:
    """Select the descriptor sampling pattern for every later call: "orb"
    (learned table, default) or "random" (generated Gaussian pool). Clears
    the per-device tables built from the previous pattern."""
    global BRIEF_POOL, BRIEF_PAIRS
    if kind == "orb":
        BRIEF_POOL, BRIEF_PAIRS = ORB_POOL, ORB_PAIRS
    elif kind == "random":
        BRIEF_POOL, BRIEF_PAIRS = RANDOM_POOL, RANDOM_PAIRS
    else:
        raise ValueError(f"unknown pattern {kind!r}")
    _rotation_offsets.cache_clear()
    _pairs.cache_clear()
    _pool.cache_clear()


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


@lru_cache(maxsize=8)
def _pool(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(BRIEF_POOL, np.float32)).to(device)


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


def brief_descriptors_mxu(img_blur: torch.Tensor, xy: torch.Tensor,
                          angles: torch.Tensor) -> torch.Tensor:
    """[H, W] + [N, 2] keypoints + [N] angles -> [N, 8] int32: the
    rotation-binned descriptor of one image (the main path's, unbatched)."""
    return brief_from_patches(brief_patches(img_blur[None], xy[None])[0], angles)


def ic_angles(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """[H, W] image + [N, 2] keypoints -> [N] intensity-centroid angles
    (IC_Angle, ORBextractor.cc:77-102): atan2(m01, m10) over the radius-15
    disc of a patch at the truncated keypoint position, borders clamped."""
    h, w = img.shape
    r = PATCH_RADIUS
    d = torch.arange(-r, r + 1, device=img.device)
    ys = torch.clamp(xy[:, 1].to(torch.int32)[:, None] + d, 0, h - 1)
    xs = torch.clamp(xy[:, 0].to(torch.int32)[:, None] + d, 0, w - 1)
    patch = img[ys[:, :, None], xs[:, None, :]]               # [N, 31, 31]
    disc_x = torch.from_numpy(_DISC_X).to(img.device)
    disc_y = torch.from_numpy(_DISC_Y).to(img.device)
    m10 = (patch * disc_x).sum((-2, -1))
    m01 = (patch * disc_y).sum((-2, -1))
    return torch.atan2(m01, m10)


def ic_angle_one(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Orientation of one keypoint [2] (see :func:`ic_angles`)."""
    return ic_angles(img, xy[None])[0]


def _steered_offsets(angles: torch.Tensor):
    """Pool offsets rotated by each angle and rounded: ([N, P], [N, P])."""
    pool = _pool(angles.device)
    ca, sa = torch.cos(angles)[:, None], torch.sin(angles)[:, None]
    rx = torch.round(ca * pool[:, 0] - sa * pool[:, 1])
    ry = torch.round(sa * pool[:, 0] + ca * pool[:, 1])
    return rx, ry


def _bits_of(vals: torch.Tensor) -> torch.Tensor:
    pairs = _pairs(vals.device)
    return pack_bits(vals[:, pairs[:, 0]] < vals[:, pairs[:, 1]])


def brief_descriptors(img_blur: torch.Tensor, xy: torch.Tensor,
                      angles: torch.Tensor) -> torch.Tensor:
    """[H, W] + [N, 2] keypoints + [N] angles -> [N, 8] int32 steered BRIEF
    (ORBextractor.cc:103-142 GET_VALUE): each pool offset rotated by the
    keypoint's angle and rounded, one image read per pool sample, each bit
    a comparison of two samples."""
    h, w = img_blur.shape
    rx, ry = _steered_offsets(angles)
    xi = torch.clamp((xy[:, 0:1] + rx).to(torch.int32), 0, w - 1)
    yi = torch.clamp((xy[:, 1:2] + ry).to(torch.int32), 0, h - 1)
    return _bits_of(img_blur[yi, xi])


def brief_descriptor_one(img_blur: torch.Tensor, xy: torch.Tensor,
                         angle: torch.Tensor) -> torch.Tensor:
    """Steered BRIEF of one keypoint [2] at ``angle`` -> [8] int32."""
    return brief_descriptors(img_blur, xy[None], angle[None])[0]


def brief_descriptors_patch(img_blur: torch.Tensor, xy: torch.Tensor,
                            angles: torch.Tensor) -> torch.Tensor:
    """[H, W] + [N, 2] + [N] -> [N, 8] int32: the steered BRIEF sampled
    inside one (2R+1)^2 patch per keypoint, its centre rounded and kept R
    pixels inside the image."""
    h, w = img_blur.shape
    xi = _round_index(xy[:, 0], PATCH_R, w - 1 - PATCH_R)
    yi = _round_index(xy[:, 1], PATCH_R, h - 1 - PATCH_R)
    rx, ry = _steered_offsets(angles)
    # every rotated offset lies inside the patch, so the patch's sample is
    # the image's
    return _bits_of(img_blur[yi[:, None] + ry.long(), xi[:, None] + rx.long()])
