"""Image pyramid + separable filtering primitives.

Port of ``gfplslam_tpu/ops/pyramid.py`` (ORBextractor.cc:1107-1133,
binary_descriptor_custom.cpp:350-413): bilinear per-level resize, levels
zero-padded to a common shape, and the separable Gaussian / Sobel filters.
Every function takes leading batch dimensions (``[..., H, W]``).

The filters keep the reference's numbers exactly: each 1-D pass is a product
with an edge-replicating band matrix whose entries are rounded to bf16, the
input is rounded to bf16, products accumulate in f32, and the intermediate is
rounded to bf16 between the two passes. The products here run in f32 on the
bf16-rounded operands (TF32 is off, see the package ``__init__``), so every
partial sum of at most seven bf16 x bf16 products is exact in f32 for 8-bit
intensities and the result does not depend on the summation order.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Tuple

import numpy as np
import torch


def level_shapes(h: int, w: int, nlevels: int, scale: float) -> List[Tuple[int, int]]:
    """Static per-level (h, w); level i is scaled by scale^-i."""
    return [(int(round(h / scale ** i)), int(round(w / scale ** i)))
            for i in range(nlevels)]


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize [..., H, W] -> [..., out_h, out_w] (align-corners
    False), the reference's gather-and-blend order."""
    h, w = img.shape[-2], img.shape[-1]
    dev, dt = img.device, img.dtype
    ys = (torch.arange(out_h, dtype=dt, device=dev) + 0.5) * (h / out_h) - 0.5
    xs = (torch.arange(out_w, dtype=dt, device=dev) + 0.5) * (w / out_w) - 0.5
    y0 = torch.clamp(torch.floor(ys), 0, h - 1)
    x0 = torch.clamp(torch.floor(xs), 0, w - 1)
    fy = torch.clamp(ys - y0, 0.0, 1.0)
    fx = torch.clamp(xs - x0, 0.0, 1.0)
    y0i = y0.long()
    x0i = x0.long()
    y1i = torch.clamp(y0i + 1, 0, h - 1)
    x1i = torch.clamp(x0i + 1, 0, w - 1)
    r0 = img.index_select(-2, y0i)
    r1 = img.index_select(-2, y1i)
    top = r0.index_select(-1, x0i) * (1 - fx) + r0.index_select(-1, x1i) * fx
    bot = r1.index_select(-1, x0i) * (1 - fx) + r1.index_select(-1, x1i) * fx
    return top * (1 - fy)[:, None] + bot * fy[:, None]


def build_pyramid(img: torch.Tensor, nlevels: int, scale: float) -> List[torch.Tensor]:
    """[..., H, W] -> list of per-level images (level 0 = input)."""
    h, w = img.shape[-2], img.shape[-1]
    levels = [img]
    for (lh, lw) in level_shapes(h, w, nlevels, scale)[1:]:
        levels.append(resize_bilinear(levels[-1], lh, lw))
    return levels


def build_pyramid_padded(img: torch.Tensor, nlevels: int,
                         scale: float) -> torch.Tensor:
    """[..., H, W] -> [..., L, H, W]: each level at its true resolution,
    zero-padded to the level-0 shape."""
    h, w = img.shape[-2], img.shape[-1]
    levels = build_pyramid(img, nlevels, scale)
    out = [levels[0]] + [
        torch.nn.functional.pad(lv, (0, w - lv.shape[-1], 0, h - lv.shape[-2]))
        for lv in levels[1:]]
    return torch.stack(out, -3)


def gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


@lru_cache(maxsize=128)
def _band_matrix(n: int, kernel: tuple) -> np.ndarray:
    """[n, n] banded matrix applying a 1D edge-replicated convolution:
    vertical pass = M @ img, horizontal pass = img @ M.T."""
    k = np.asarray(kernel, np.float64)
    r = (len(k) - 1) // 2
    m = np.zeros((n, n), np.float32)
    rows = np.arange(n)
    for t, kv in enumerate(k):
        cols = np.clip(rows + t - r, 0, n - 1)
        np.add.at(m, (rows, cols), kv)
    return m


@lru_cache(maxsize=128)
def _band_bf16(n: int, kernel: tuple, device: torch.device) -> torch.Tensor:
    """The band matrix rounded to bf16, held as f32 on ``device``."""
    m = torch.from_numpy(_band_matrix(n, kernel))
    return m.to(torch.bfloat16).to(torch.float32).to(device)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _separable(img: torch.Tensor, kv: tuple, kh: tuple) -> torch.Tensor:
    """Separable 2D filter as two band-matrix products with the reference's
    bf16 cast points ([..., H, W] -> [..., H, W] f32)."""
    h, w = img.shape[-2], img.shape[-1]
    mv = _band_bf16(h, kv, img.device)
    mh = _band_bf16(w, kh, img.device)
    y = torch.matmul(mv, _bf16(img))
    return torch.matmul(_bf16(y), mh.T)


def gaussian_blur(img: torch.Tensor, sigma: float = 2.0,
                  radius: int = 3) -> torch.Tensor:
    """Separable Gaussian blur (the 7x7 sigma-2 blur before BRIEF sampling,
    ORBextractor.cc:1043-1048)."""
    k = tuple(float(x) for x in gaussian_kernel1d(sigma, radius))
    return _separable(img, k, k)


def sobel(img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """3x3 Sobel dx, dy with replicated borders: sobel_x = [1,2,1]^T (x)
    [-1,0,1] (cv::Sobel in binary_descriptor_custom.cpp:395-413)."""
    gx = _separable(img, (1.0, 2.0, 1.0), (1.0, 0.0, -1.0))
    gy = _separable(img, (1.0, 0.0, -1.0), (1.0, 2.0, 1.0))
    return gx, gy
