"""Line Band Descriptor (LBD-style): banded gradient statistics per segment,
binarized to 256 bits.

Port of ``gfplslam_tpu/ops/lbd.py`` (binary_descriptor_custom.cpp:1026+).
A fixed grid of 12 samples along x 9 bands x 3 rows across each segment is
rotated per line and gathered from the Sobel gradient; per band, means and
stds of the four half-wave-rectified local gradient components give a
72-float descriptor, which 256 fixed pair comparisons turn into [8] int32
words (the bit patterns of the reference's uint32 words).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from gfplslam_torch.ops.orb import pack_bits
from gfplslam_torch.ops.pyramid import sobel

N_BANDS = 9
BAND_WIDTH = 3          # rows per band across the line
N_ALONG = 12            # samples along the line
FLOAT_DIM = N_BANDS * 8
DESC_WORDS = 8


def _make_pair_pattern(seed: int = 77, n_bits: int = 256) -> np.ndarray:
    """[n_bits, 2] index pairs into the 72-dim float descriptor."""
    rng = np.random.default_rng(seed)
    pairs = set()
    out = []
    while len(out) < n_bits:
        i, j = rng.integers(0, FLOAT_DIM, 2)
        if i != j and (i, j) not in pairs:
            pairs.add((i, j))
            out.append((i, j))
    return np.asarray(out, np.int32)


PAIR_PATTERN = _make_pair_pattern()


@lru_cache(maxsize=8)
def _pattern(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(PAIR_PATTERN.astype(np.int64)).to(device)


def lbd_float(gx: torch.Tensor, gy: torch.Tensor, sp: torch.Tensor,
              ep: torch.Tensor) -> torch.Tensor:
    """[B, H, W] gradients + [B, N, 2] endpoints -> [B, N, 72] float band
    descriptors."""
    bsz, h, w = gx.shape
    n = sp.shape[1]
    dev = gx.device
    d = ep - sp
    length = torch.clamp(torch.sqrt(d[..., 0] ** 2 + d[..., 1] ** 2), min=1e-6)
    dir_par = d / length[..., None]                           # [B, N, 2]
    dir_perp = torch.stack([-dir_par[..., 1], dir_par[..., 0]], -1)
    mid = 0.5 * (sp + ep)
    ts = (torch.arange(N_ALONG, dtype=torch.float32, device=dev) + 0.5
          ) / N_ALONG - 0.5                                   # [-0.5, 0.5)
    half_w = N_BANDS * BAND_WIDTH / 2.0
    vs = (torch.arange(N_BANDS * BAND_WIDTH, dtype=torch.float32, device=dev)
          - half_w + 0.5)                                     # perp offsets
    # sample grid [B, N, N_ALONG, rows, 2]
    pts = (mid[:, :, None, None, :]
           + ts[:, None, None] * length[:, :, None, None, None]
           * dir_par[:, :, None, None, :]
           + vs[:, None] * dir_perp[:, :, None, None, :])
    xi = torch.clamp(torch.round(pts[..., 0]).long(), 0, w - 1)
    yi = torch.clamp(torch.round(pts[..., 1]).long(), 0, h - 1)
    flat = (yi * w + xi).reshape(bsz, -1)
    gxs = torch.gather(gx.reshape(bsz, -1), 1, flat).reshape(xi.shape)
    gys = torch.gather(gy.reshape(bsz, -1), 1, flat).reshape(xi.shape)
    dp = dir_par[:, :, None, None, :]
    dq = dir_perp[:, :, None, None, :]
    g_par = gxs * dp[..., 0] + gys * dp[..., 1]
    g_perp = gxs * dq[..., 0] + gys * dq[..., 1]
    # [B, N, 4, N_ALONG, rows] rectified components
    comps = torch.stack([torch.clamp(g_perp, min=0.0),
                         torch.clamp(-g_perp, min=0.0),
                         torch.clamp(g_par, min=0.0),
                         torch.clamp(-g_par, min=0.0)], 2)
    bands = comps.reshape(bsz, n, 4, N_ALONG, N_BANDS, BAND_WIDTH)
    cnt = N_ALONG * BAND_WIDTH
    mean = bands.sum((3, 5), keepdim=True) / cnt
    std = torch.sqrt(((bands - mean) ** 2).sum((3, 5)) / cnt)
    feat = torch.cat([mean[:, :, :, 0, :, 0], std], 2)       # [B, N, 8, 9]
    feat = feat.transpose(-1, -2).reshape(bsz, n, FLOAT_DIM)
    nrm = torch.sqrt((feat * feat).sum(-1, keepdim=True))
    feat = feat / torch.clamp(nrm, min=1e-6)
    return torch.clamp(feat, max=0.4)


def binarize(feat: torch.Tensor) -> torch.Tensor:
    """[..., 72] float -> [..., 8] int32 via the fixed pair comparisons."""
    pat = _pattern(feat.device)
    return pack_bits(feat[..., pat[:, 0]] > feat[..., pat[:, 1]])


def lbd_descriptors(img: torch.Tensor, sp: torch.Tensor, ep: torch.Tensor
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, H, W] images + [B, N, 2] endpoints -> ([B, N, 8] int32 binary,
    [B, N, 72] float)."""
    gx, gy = sobel(img)
    feats = lbd_float(gx, gy, sp, ep)
    return binarize(feats), feats
