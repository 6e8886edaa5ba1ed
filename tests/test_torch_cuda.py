"""The CUDA kernels against their plain PyTorch versions, on a CUDA card.

Marked ``gpu``: without a card every test here skips (a CUDA kernel has no
CPU mode; its arithmetic is held to the reference through the plain
versions in test_torch_fast.py and test_torch_hamming.py). On a machine with
a card and without JAX, run them with

    python -m pytest tests/test_torch_cuda.py -m gpu --noconftest -q

This file imports no JAX."""

import numpy as np
import pytest
import torch

from gfplslam_torch.ops import fast, hamming

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shape", [(1, 7, 7), (3, 37, 53), (2, 240, 376),
                                   (6, 200, 313)])
def test_fast_kernel_equals_plain(dev, shape):
    rng = np.random.default_rng(sum(shape))
    imgs = torch.as_tensor(rng.uniform(0, 255, shape).astype(np.float32), device=dev)
    for th in (10.0, 20.0, 35.0):
        before = fast.fast_score_cuda.launches
        out = fast.fast_score_cuda(imgs, torch.tensor([th], device=dev))
        assert fast.fast_score_cuda.launches == before + 1
        assert torch.equal(out, fast.fast_score_map_torch(imgs, th))


def test_fast_dispatch_launches_kernel(dev):
    imgs = torch.zeros(2, 40, 50, device=dev)
    before = fast.fast_score_cuda.launches
    fast.fast_score_map(imgs, 20.0)
    assert fast.fast_score_cuda.launches == before + 1


@pytest.mark.parametrize("n,m,masked", [(1024, 1024, True), (512, 512, True),
                                        (100, 60, True), (33, 1, False)])
def test_hamming_kernel_equals_plain(dev, n, m, masked):
    rng = np.random.default_rng(n + m)
    a = torch.as_tensor(rng.integers(-2**31, 2**31, (n, 8)), dtype=torch.int32,
                        device=dev)
    b = torch.as_tensor(rng.integers(-2**31, 2**31, (m, 8)), dtype=torch.int32,
                        device=dev)
    va = torch.as_tensor(rng.random(n) < 0.7, device=dev) if masked else None
    vb = torch.as_tensor(rng.random(m) < 0.7, device=dev) if masked else None
    before = hamming.hamming_cuda.launches
    out = hamming.hamming_matrix(a, b, va, vb)
    assert hamming.hamming_cuda.launches == before + 1
    assert torch.equal(out, hamming.hamming_matrix_torch(a, b, va, vb))


def test_kernels_refuse_wrong_inputs(dev):
    with pytest.raises(ValueError):
        fast.fast_score_cuda(torch.zeros(2, 8, 8, device=dev, dtype=torch.float64), 20.0)
    with pytest.raises(ValueError):
        hamming.hamming_cuda(torch.zeros(4, 8, dtype=torch.int32, device=dev),
                             torch.zeros(4, 4, dtype=torch.int32, device=dev))
