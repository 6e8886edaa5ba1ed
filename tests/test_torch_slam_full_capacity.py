"""The port at full capacity against the reference:
``tests/test_slam_full_capacity_e2e.py`` (752x480, the default 1024-point
/ 512-line budgets, the textured loop world, frames written as PGM and
decoded by the native loader) through the port's ``SLAMSystem`` on the CPU
and the reference's on the same decoded frames.

Both must pass that test's gates (not lost, >= 8 keyframes, ATE < 0.10 m,
>= 1 loop closure), and the two all-frame trajectories agree to 0.08 m ATE
of one against the other (the VO parity tolerance of
``tests/test_torch_vo.py``). Slow tier: the reference's XLA compiles at
these shapes take more than an hour on the CPU."""

import os

import numpy as np
import pytest
import torch

from gfplslam_tpu.config import Config as RefConfig, SlamParams as RefSlamParams
from gfplslam_tpu.models.slam import SLAMSystem as RefSLAMSystem

from gfplslam_torch.io import native_loader, synthetic
from gfplslam_torch.models.slam import SLAMSystem
from gfplslam_torch.utils import convert
from gfplslam_torch.utils.trajectory import ate_rmse

N_FRAMES = 40
REF_CFG = RefConfig(slam=RefSlamParams(max_kf_num_frames=2, lc_kf_dist=6,
                                       lc_kf_max_dist=3, lc_nkf_closest=2))
CFG = convert.config_from_ref(REF_CFG)

pytestmark = pytest.mark.slow


def _write_pgm(path: str, img: np.ndarray) -> None:
    arr = np.clip(np.round(img), 0, 255).astype(np.uint8)
    h, w = arr.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode())
        f.write(arr.tobytes())


def _gates(slam, world) -> float:
    assert not slam.vo.lost
    assert len(slam.keyframe_trajectory) >= 8
    ate = ate_rmse(slam.all_frame_trajectory, world.poses)
    assert ate < 0.10, ate
    assert slam.n_loop_closures >= 1
    return ate


def test_full_capacity_file_backed_loop_matches_reference(tmp_path):
    if not native_loader.native_available():
        pytest.skip("native dataloader not built")
    world = synthetic.make_world(n_frames=N_FRAMES, n_points=900, n_lines=90,
                                 seed=21, motion="loop", cam=CFG.camera, textured=True)
    paths_l, paths_r, rendered = [], [], []
    for i in range(N_FRAMES):
        il, ir = synthetic.render_frame(world, i, noise=1.0)
        for side, img, paths in (("l", il, paths_l), ("r", ir, paths_r)):
            paths.append(os.path.join(tmp_path, f"{side}_{i:04d}.pgm"))
            _write_pgm(paths[-1], img)
        rendered.append((np.round(np.clip(il, 0, 255)), np.round(np.clip(ir, 0, 255))))
    frames = [None] * N_FRAMES
    with native_loader.StereoLoader(paths_l, paths_r, CFG.camera.width,
                                    CFG.camera.height) as loader:
        for k, il, ir in loader:
            frames[k] = (il, ir)
    for k in range(N_FRAMES):
        np.testing.assert_array_equal(frames[k][0], rendered[k][0])
        np.testing.assert_array_equal(frames[k][1], rendered[k][1])

    port = SLAMSystem(CFG, device=torch.device("cpu"))
    ref = RefSLAMSystem(REF_CFG)
    for slam in (port, ref):
        for i, (il, ir) in enumerate(frames):
            slam.process(il, ir, world.timestamps[i])
        slam.finish()
        _gates(slam, world)
    assert ate_rmse(port.all_frame_trajectory, ref.all_frame_trajectory) < 0.08
