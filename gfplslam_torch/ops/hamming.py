"""Masked Hamming-distance matrices for 256-bit binary descriptors.

Port of ``gfplslam_tpu/ops/hamming.py`` (the reference's popcount matcher,
stereoFrame.h:185-201). Descriptors are [N, 8] int32, the bit patterns of the
reference's uint32 words. The distance matrix has two implementations of one
function:

- :func:`hamming_cuda`, the hand-written kernel ``csrc/hamming.cu`` (replaces
  the Pallas kernel ``gfplslam_tpu/ops/pallas/hamming_pl.py::
  _hamming_kernel``), for CUDA tensors;
- :func:`hamming_matrix_torch`, the plain PyTorch version, for CPU tensors and
  as the kernel's reference.

:func:`hamming_matrix` picks by device only. Rows and columns that the masks
mark invalid get ``BIG``.
"""

from __future__ import annotations

import torch

from gfplslam_torch.ops import kernels

BIG = 1 << 16  # > max possible distance (256)


def hamming_cuda(a: torch.Tensor, b: torch.Tensor,
                 valid_a: torch.Tensor | None = None,
                 valid_b: torch.Tensor | None = None) -> torch.Tensor:
    """[N, 8] x [M, 8] int32 CUDA descriptors -> [N, M] int32, one launch,
    any N and M. A ``None`` mask means every row (column) is valid."""
    kernels.require_cuda(a, "a", torch.int32, 2)
    kernels.require_cuda(b, "b", torch.int32, 2)
    if a.shape[1] != 8 or b.shape[1] != 8:
        raise ValueError(f"descriptors must be [*, 8], got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    n, m = a.shape[0], b.shape[0]
    ptrs = []
    for v, size, name in ((valid_a, n, "valid_a"), (valid_b, m, "valid_b")):
        if v is None:
            ptrs.append(None)
            continue
        kernels.require_cuda(v, name, torch.bool, 1)
        if v.shape[0] != size or v.device != a.device:
            raise ValueError(f"{name} must be [{size}] on {a.device}")
        ptrs.append(v.data_ptr())
    out = torch.empty((n, m), dtype=torch.int32, device=a.device)
    if n == 0 or m == 0:
        return out
    lib = kernels.load()
    err = lib.gfpl_hamming(a.data_ptr(), b.data_ptr(), ptrs[0], ptrs[1],
                           out.data_ptr(), n, m, kernels.stream_ptr(a.device))
    kernels.check(err, "gfpl_hamming")
    hamming_cuda.launches += 1
    return out


hamming_cuda.launches = 0


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of int64 values in [0, 2^32) (SWAR bit tricks: torch has no
    popcount op)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def hamming_matrix_torch(a: torch.Tensor, b: torch.Tensor,
                         valid_a: torch.Tensor | None = None,
                         valid_b: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch masked Hamming matrix, [N, 8] x [M, 8] int32 -> [N, M]
    int32."""
    a64 = a.long() & 0xFFFFFFFF
    b64 = b.long() & 0xFFFFFFFF
    d = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.int64,
                    device=a.device)
    for k in range(a.shape[1]):
        d += _popcount32(a64[:, None, k] ^ b64[None, :, k])
    d = d.to(torch.int32)
    if valid_a is not None:
        d = torch.where(valid_a[:, None], d, torch.full_like(d, BIG))
    if valid_b is not None:
        d = torch.where(valid_b[None, :], d, torch.full_like(d, BIG))
    return d


def hamming_matrix(a: torch.Tensor, b: torch.Tensor,
                   valid_a: torch.Tensor | None = None,
                   valid_b: torch.Tensor | None = None) -> torch.Tensor:
    """Masked Hamming distance matrix; invalid rows/cols get BIG. CUDA
    tensors go through the kernel, CPU tensors through the plain version;
    any other device raises."""
    if a.is_cuda:
        return hamming_cuda(*(None if t is None else t.contiguous()
                              for t in (a, b, valid_a, valid_b)))
    if a.device.type == "cpu":
        return hamming_matrix_torch(a, b, valid_a, valid_b)
    raise ValueError(f"hamming_matrix: unsupported device {a.device}")
