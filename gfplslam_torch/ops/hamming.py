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

:func:`hamming_matrix` picks by device only; :func:`hamming_matrices` forms
up to four matrices, in one kernel launch on the card. Rows and columns that
the masks mark invalid get ``BIG``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from gfplslam_torch.ops import kernels

BIG = 1 << 16  # > max possible distance (256)
MAX_PROBLEMS = 4  # matrices per launch (the kernel's problem table)

Problem = tuple  # (a, b, valid_a or None, valid_b or None)


def _check_count(problems: Sequence[Problem]) -> None:
    if not 1 <= len(problems) <= MAX_PROBLEMS:
        raise ValueError(f"1 to {MAX_PROBLEMS} problems per launch, got "
                         f"{len(problems)}")


def _checked(problems: Sequence[Problem]) -> list:
    """The wrapper's contract: 1 to 4 problems of [N, 8] and [M, 8] int32
    CUDA descriptors, bool masks of their lengths on the same card;
    descriptors that do not start on 16 bytes (the kernel's copy width) are
    copied."""
    _check_count(problems)
    out = []
    for a, b, valid_a, valid_b in problems:
        kernels.require_cuda(a, "a", torch.int32, 2)
        kernels.require_cuda(b, "b", torch.int32, 2)
        if a.shape[1] != 8 or b.shape[1] != 8:
            raise ValueError(f"descriptors must be [*, 8], got {tuple(a.shape)}, "
                             f"{tuple(b.shape)}")
        if b.device != a.device:
            raise ValueError(f"b must be on {a.device}")
        for v, size, name in ((valid_a, a.shape[0], "valid_a"),
                              (valid_b, b.shape[0], "valid_b")):
            if v is None:
                continue
            kernels.require_cuda(v, name, torch.bool, 1)
            if v.shape[0] != size or v.device != a.device:
                raise ValueError(f"{name} must be [{size}] on {a.device}")
        a, b = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (a, b))
        out.append((a, b, valid_a, valid_b))
    return out


def problem_table(problems: Sequence[Problem], outs: Sequence[torch.Tensor]):
    """The kernel's problem table, 7 int64 per problem: a, b, valid_a,
    valid_b (0 for ``None``), out, n, m."""
    table = (ctypes.c_int64 * (7 * len(problems)))()
    for i, ((a, b, va, vb), o) in enumerate(zip(problems, outs)):
        table[7 * i:7 * i + 7] = [
            a.data_ptr(), b.data_ptr(), 0 if va is None else va.data_ptr(),
            0 if vb is None else vb.data_ptr(), o.data_ptr(), a.shape[0],
            b.shape[0]]
    return table


def hamming_cuda_many(problems: Sequence[Problem]) -> list[torch.Tensor]:
    """Up to four masked Hamming matrices of CUDA descriptors, [N_i, 8] x
    [M_i, 8] int32 -> [N_i, M_i] int32, in one launch (none if every matrix
    is empty)."""
    problems = _checked(problems)
    dev = problems[0][0].device
    outs = [torch.empty((a.shape[0], b.shape[0]), dtype=torch.int32, device=dev)
            for a, b, _, _ in problems]
    if all(o.numel() == 0 for o in outs):
        return outs
    err = kernels.load().gfpl_hamming(len(problems), problem_table(problems, outs),
                                      kernels.stream_ptr(dev))
    kernels.check(err, "gfpl_hamming")
    hamming_cuda.launches += 1
    return outs


def hamming_cuda(a: torch.Tensor, b: torch.Tensor,
                 valid_a: torch.Tensor | None = None,
                 valid_b: torch.Tensor | None = None) -> torch.Tensor:
    """[N, 8] x [M, 8] int32 CUDA descriptors -> [N, M] int32, one launch,
    any N and M. A ``None`` mask means every row (column) is valid.
    ``launches`` counts the kernel's launches, a grouped one once."""
    return hamming_cuda_many([(a, b, valid_a, valid_b)])[0]


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


def hamming_matrices(problems: Sequence[Problem]) -> list[torch.Tensor]:
    """One masked Hamming matrix per ``(a, b, valid_a, valid_b)`` (1 to
    :data:`MAX_PROBLEMS` of them, all on one device). CUDA tensors go
    through one kernel launch for all of them, CPU tensors through the plain
    version one by one; any other device raises."""
    _check_count(problems)
    dev = problems[0][0].device
    if dev.type == "cuda":
        return hamming_cuda_many([tuple(None if t is None else t.contiguous()
                                        for t in p) for p in problems])
    if dev.type == "cpu":
        return [hamming_matrix_torch(*p) for p in problems]
    raise ValueError(f"hamming_matrices: unsupported device {dev}")


def hamming_matrix(a: torch.Tensor, b: torch.Tensor,
                   valid_a: torch.Tensor | None = None,
                   valid_b: torch.Tensor | None = None) -> torch.Tensor:
    """Masked Hamming distance matrix; invalid rows/cols get BIG. CUDA
    tensors go through the kernel, CPU tensors through the plain version;
    any other device raises."""
    return hamming_matrices([(a, b, valid_a, valid_b)])[0]
