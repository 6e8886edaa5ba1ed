"""The slice whole: the port's visual odometry on the synthetic worlds of
tests/test_vo_e2e.py, held to the same four gates as the reference
(ATE < 0.06 m with > 60% of frames accepted, still-camera drift < 0.02 m,
points-only ATE < 0.08 m, one TimeLog row per frame), compared with the
reference's trajectory on the same world, and its three drivers
(``VisualOdometry``, ``run_vo_scan``, ``init_scan_carry`` +
``run_vo_scan_chunk``) compared with each other."""

import dataclasses
import inspect
import os
import tempfile

import numpy as np
import pytest
import torch

from gfplslam_torch.config import (CameraParams, CapacityParams, Config,
                                   OrbParams, StvoParams)
from gfplslam_torch.io import synthetic
from gfplslam_torch.models.vo import (VisualOdometry, init_scan_carry,
                                      run_vo_scan, run_vo_scan_chunk)
from gfplslam_torch.utils.trajectory import ate_rmse

torch.set_num_threads(2)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def setup():
    cfg = Config(
        cap=CapacityParams(n_pt=256, n_ln=128, n_pt_match=128, n_ln_match=64),
        orb=OrbParams(nlevels=2),
        camera=CameraParams(width=376, height=240, fx=217.6, fy=217.6,
                            cx=183.7, cy=126.1, baseline=0.11),
    )
    world = synthetic.make_world(n_frames=8, n_points=300, n_lines=40, seed=4)
    frames = [synthetic.render_frame(world, i, noise=1.0) for i in range(8)]
    return cfg, world, frames


@pytest.fixture(scope="module")
def port_vo(setup):
    cfg, world, frames = setup
    vo = VisualOdometry(cfg, device=CPU)
    for i, (img_l, img_r) in enumerate(frames):
        vo.process(img_l, img_r, world.timestamps[i])
    return vo


def test_vo_tracks_synthetic_sequence(setup, port_vo):
    _, world, _ = setup
    assert not port_vo.lost
    acc = [r.accepted for r in port_vo.records[1:]]
    assert np.mean(acc) > 0.6, f"accepted {np.mean(acc)}"
    rmse = ate_rmse(port_vo.trajectory, world.poses)
    assert rmse < 0.06, f"ATE {rmse}"


def test_vo_still_camera(setup):
    cfg, _, _ = setup
    still = synthetic.make_world(n_frames=4, n_points=300, n_lines=40, seed=5,
                                 motion="still")
    vo = VisualOdometry(cfg, device=CPU)
    for i in range(4):
        img_l, img_r = synthetic.render_frame(still, i, noise=1.0)
        vo.process(img_l, img_r, still.timestamps[i])
    drift = np.linalg.norm(vo.trajectory[-1][:3, 3])
    assert drift < 0.02, f"still-camera drift {drift}"


def test_vo_timelog_rows(port_vo):
    rows = port_vo.timelog.rows
    assert len(rows) == 8
    assert rows[1].time_pt_extract > 0 and rows[1].num_pt_stereo > 0
    p = os.path.join(tempfile.mkdtemp(), "log.txt")
    port_vo.timelog.write(p)
    assert len(open(p).read().strip().splitlines()) == 9   # header + 8 rows


def test_vo_points_only_mode(setup):
    cfg, world, frames = setup
    cfg_pt = dataclasses.replace(cfg, stvo=StvoParams(has_lines=False))
    vo = VisualOdometry(cfg_pt, device=CPU)
    for i, (img_l, img_r) in enumerate(frames):
        vo.process(img_l, img_r, world.timestamps[i])
    assert not vo.lost
    assert all(r.n_ln == 0 for r in vo.records)
    assert int(vo.prev_frame.lines.valid.sum()) == 0
    rmse = ate_rmse(vo.trajectory, world.poses)
    assert rmse < 0.08, f"points-only ATE {rmse}"


def test_vo_agrees_with_reference_trajectory(setup, port_vo):
    """The reference's VisualOdometry on the same world and images.

    Tolerance: aligned ATE of one trajectory against the other < 0.08 m.
    Frame by frame the two agree to ~1e-4 while the pose solve converges
    (test_torch_tracker.py), but on frames where the fixed GN budget ends
    before convergence the last-ulp differences of f32 sums move the pose
    by centimetres, and the tracker state carries that forward. The
    reference differs from itself by the same order: its run_vo_scan and
    VisualOdometry drivers disagree by 0.046 m ATE (0.116 m at worst) on
    this world, measured on the CPU when this test was written."""
    from gfplslam_tpu import config as ref_config
    from gfplslam_tpu.models.vo import VisualOdometry as RefVO
    cfg, world, frames = setup
    ref_cfg = ref_config.Config(
        cap=ref_config.CapacityParams(**dataclasses.asdict(cfg.cap)),
        orb=ref_config.OrbParams(**dataclasses.asdict(cfg.orb)),
        camera=ref_config.CameraParams(**dataclasses.asdict(cfg.camera)))
    assert dataclasses.asdict(ref_cfg) == dataclasses.asdict(cfg)
    ref = RefVO(ref_cfg)
    for i, (img_l, img_r) in enumerate(frames):
        ref.process(img_l, img_r, world.timestamps[i])
    assert not ref.lost
    assert ate_rmse(ref.trajectory, world.poses) < 0.06
    between = ate_rmse(port_vo.trajectory, ref.trajectory)
    assert between < 0.08, f"port vs reference ATE {between}"
    assert [r.is_kf for r in port_vo.records[:3]] == [r.is_kf for r in ref.records[:3]]
    assert [r.n_pt for r in port_vo.records[:3]] == [r.n_pt for r in ref.records[:3]]


def test_run_vo_scan_matches_visual_odometry(setup, port_vo):
    """Same per-frame programs, composed on the device in f32 instead of on
    the host in f64: poses within 1e-4."""
    cfg, world, frames = setup
    imgs_l = np.stack([f[0] for f in frames])
    imgs_r = np.stack([f[1] for f in frames])
    poses, aux = run_vo_scan(cfg, imgs_l, imgs_r, world.timestamps, device=CPU)
    assert poses.shape == (8, 4, 4) and aux["accepted"].shape == (7,)
    np.testing.assert_allclose(poses.numpy(), port_vo.trajectory, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(aux["is_kf"].numpy(),
                                  [r.is_kf for r in port_vo.records[1:]])

    carry, frame0 = init_scan_carry(cfg, imgs_l[0], imgs_r[0],
                                    world.timestamps[0], device=CPU)
    chunks = []
    for lo, hi in ((1, 4), (4, 8)):
        carry, p, a, fr = run_vo_scan_chunk(cfg, carry, imgs_l[lo:hi],
                                            imgs_r[lo:hi], world.timestamps[lo:hi],
                                            device=CPU)
        assert fr.points.valid.shape[0] == hi - lo
        chunks.append(p)
    np.testing.assert_array_equal(torch.cat(chunks).numpy(), poses[1:].numpy())


@pytest.mark.parametrize("entry", [init_scan_carry, run_vo_scan_chunk,
                                   run_vo_scan, VisualOdometry])
def test_entry_points_run_on_the_card_by_default(entry):
    """Without ``device=`` every entry point targets the CUDA card; the CPU
    is taken only when the caller asks for it."""
    default = inspect.signature(entry).parameters["device"].default
    assert default == torch.device("cuda")
