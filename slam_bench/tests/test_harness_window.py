"""The window arithmetic on synthetic timestamps: rates over the whole
window, the p90 over every frame, failed frames against attempted."""

import numpy as np
import pytest

from slam_bench import registry
from slam_bench.window import Sequence, lost_frames, percentile, rate


def _seq(lat, kf, frames=None, failed=0, traced=False):
    n = frames or len(lat)
    return Sequence(frames=n, tracked=n - 1, failed=failed, frame_poses=np.zeros((n, 4, 4)),
                    is_kf=kf, latency_s=lat, traced=traced)


class Run:
    def __init__(self, seqs, seconds):
        self.seqs, self.seconds = seqs, seconds


def test_rates_take_all_work_over_all_time():
    # two sequences of 10 and 10 frames in a 5 s window (the second ran past
    # the window's nominal end: it counts whole)
    run = Run([_seq([0.1] * 10, [True] + [False] * 9)] * 2, 5.0)
    assert registry.module("metrics", "slam_fps").read(run) == 20 / 5.0
    assert registry.module("metrics", "vo_fps").read(run) == 18 / 5.0
    assert rate(7, 2.0) == 3.5


def test_p90_over_every_frame_of_the_window():
    a = [0.01 * i for i in range(1, 51)]      # 10 .. 500 ms
    b = [0.01 * i for i in range(51, 101)]    # 510 .. 1000 ms
    run = Run([_seq(a, [False] * 50), _seq(b, [i % 10 == 0 for i in range(50)])], 10.0)
    got = registry.module("metrics", "frame_ms_p90").read(run)
    assert got == pytest.approx(np.percentile(np.arange(1, 101) * 10.0, 90))
    assert got == pytest.approx(901.0)
    assert percentile([1, 2, 3, 4], 50) == 2.5
    kf = registry.module("metrics", "kf_frame_ms.live").read(run)
    assert kf == pytest.approx(np.median([10.0 * (51 + i) for i in range(0, 50, 10)]))


def test_keyframe_latency_leaves_out_the_profiled_sequence():
    traced = _seq([5.0, 5.0], [True, True], traced=True)
    run = Run([traced, _seq([0.1, 0.3, 0.2], [True, False, True])], 10.0)
    assert registry.module("metrics", "kf_frame_ms.live").read(run) == pytest.approx(150.0)
    run.mapping_ms = [3.0, 1.0, 2.0]
    assert registry.module("metrics", "mapping_ms.slam").read(run) == 2.0


def test_failed_frames_against_attempted():
    # the track is lost at the 4th rejected frame in a row (max_loss 3) and
    # stays lost: frames 5..9 fail
    accepted = [True, False, True, False, False, False, False, True, True, True]
    assert lost_frames(accepted, 3) == 4
    assert lost_frames(accepted, 4) == 0
    assert lost_frames([False] * 5, 0) == 5


def test_a_metric_without_its_source_reads_nothing():
    run = Run([_seq([0.1], [True])], 1.0)
    run.trace, run.mapping_ms = None, None
    for name in ("device_idle.vo", "device_idle.slam", "device_ops_per_frame.vo",
                 "fast_roofline.vo", "hamming_roofline.vo", "mapping_ms.slam"):
        assert registry.module("metrics", name).read(run) is None
