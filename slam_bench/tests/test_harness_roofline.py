"""The roofline byte counts, against hand-computed ones and against the
port's ``utils/kernel_bench.py`` arithmetic they were copied from."""

import pytest
import torch

from slam_bench import roofline


def test_fast_bytes_by_hand():
    # EuRoC level 0: both cameras, f32 in and out, the f32 threshold
    assert roofline.fast_bytes((2, 480, 752)) == 8 * 2 * 480 * 752 + 4 == 5_775_364
    # KITTI levels 1-3, padded to level 1's shape
    assert roofline.fast_bytes((6, 313, 1034)) == 8 * 6 * 313 * 1034 + 4


def test_hamming_bytes_by_hand():
    # a frame's stereo pair: points 1024 x 1024 and lines 512 x 512, both masked
    frame = [(1024, 1024, True, True), (512, 512, True, True)]
    points = 32 * 2048 + 4 * 1024 * 1024 + 2048
    lines = 32 * 1024 + 4 * 512 * 512 + 1024
    assert roofline.hamming_bytes(frame) == points + lines == 5_344_256
    # BoW: rows masked, the vocabulary not
    assert roofline.hamming_bytes([(1024, 4096, True, False)]) == (
        32 * 5120 + 4 * 1024 * 4096 + 1024)


def test_the_copies_equal_the_ports_arithmetic():
    from gfplslam_torch.utils import kernel_bench
    z = torch.zeros
    inputs = {"p": (z(1024, 8), z(1024, 8), z(1024), z(1024)),
              "l": (z(512, 8), z(512, 8), z(512), None)}
    ms = kernel_bench.hamming_bytes_ms(inputs)
    ours = roofline.hamming_bytes([(1024, 1024, True, True), (512, 512, True, False)])
    assert abs(ours / roofline.peak(roofline.DEFAULT_KIND, "hbm_bytes_per_s") * 1e3 - ms) < 1e-15
    assert roofline.peak(roofline.DEFAULT_KIND, "hbm_bytes_per_s") == kernel_bench.HBM_BYTES_PER_S


def test_share_is_none_without_device_time():
    assert roofline.share_pct(1e6, 0.0, roofline.DEFAULT_KIND) is None
    assert roofline.share_pct(3.35e6, 2e-6, roofline.DEFAULT_KIND) == pytest.approx(50.0)
