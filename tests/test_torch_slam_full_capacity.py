"""The port at full capacity against the reference:
``tests/test_slam_full_capacity_e2e.py`` (752x480, the default 1024-point
/ 512-line budgets, the shipped 256-word vocabulary, the textured loop
world, frames written as PGM and decoded by the port's C++ loader).

Two halves. ``test_port_full_capacity_loop`` runs the port's
``SLAMSystem`` on the CPU and imports nothing of the JAX package: that
test's gates (not lost, >= 8 keyframes, ATE < 0.10 m, >= 1 loop closure,
the shipped vocabulary active), and its all-frame trajectory within 0.08 m
ATE (the VO parity tolerance of ``tests/test_torch_vo.py``) of the
reference's, recorded in ``tests/data/ref_full_capacity_loop_traj.npy``.
``test_reference_full_capacity_loop`` runs the reference on the same
decoded frames: the same gates, and the fixture still its trajectory.
``chip_smoke.py [full-capacity-loop]`` runs the port's half on the card.

The reference on the CPU ends at 0.1105 m, outside the ATE gate (its own
test, tests/test_slam_full_capacity_e2e.py, fails the same way). The port
passes on the CPU at any thread count: 0.07176 / 0.07482 / 0.07262 m at
1 / 6 / 8 threads, 0.054-0.057 m from the reference. Until its local BA
inverted each landmark block on its observed subspace
(``ba_core.landmark_inverses``; tests/test_torch_ba_observed_subspace.py),
the result depended on rounding: the reference's 1e8 stiffness along a
block's unobserved direction rounds its observed entries away in f32, and
at 8 threads one LM step sent a keyframe 2 km away (ATE 526.7 m).

Record the fixture again (a few minutes of the reference's XLA compiles
on the CPU)::

    JAX_PLATFORMS=cpu python -m tests.test_torch_slam_full_capacity

Slow tier: ``python -m pytest tests/test_torch_slam_full_capacity.py -m slow``.
"""

import os
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

from gfplslam_torch.config import Config, SlamParams
from gfplslam_torch.io import native_loader, synthetic
from gfplslam_torch.models import loop
from gfplslam_torch.models.slam import SLAMSystem
from gfplslam_torch.utils.trajectory import ate_rmse

N_FRAMES = 40
CFG = Config(slam=SlamParams(max_kf_num_frames=2, lc_kf_dist=6,
                             lc_kf_max_dist=3, lc_nkf_closest=2))
REF_TRAJ = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "ref_full_capacity_loop_traj.npy")
PARITY_ATE = 0.08

pytestmark = pytest.mark.slow


def _write_pgm(path: str, img: np.ndarray) -> None:
    arr = np.clip(np.round(img), 0, 255).astype(np.uint8)
    h, w = arr.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode())
        f.write(arr.tobytes())


def decoded_world(root: str):
    """The world, and its frames written as PGM under ``root`` and decoded
    by the port's loader, held equal to the rounded rendered frames."""
    world = synthetic.make_world(n_frames=N_FRAMES, n_points=900, n_lines=90,
                                 seed=21, motion="loop", cam=CFG.camera,
                                 textured=True)
    paths_l, paths_r, rendered = [], [], []
    for i in range(N_FRAMES):
        il, ir = synthetic.render_frame(world, i, noise=1.0)
        for side, img, paths in (("l", il, paths_l), ("r", ir, paths_r)):
            paths.append(os.path.join(root, f"{side}_{i:04d}.pgm"))
            _write_pgm(paths[-1], img)
        rendered.append((np.round(np.clip(il, 0, 255)),
                         np.round(np.clip(ir, 0, 255))))
    frames = [None] * N_FRAMES
    with native_loader.StereoLoader(paths_l, paths_r, CFG.camera.width,
                                    CFG.camera.height, n_threads=2,
                                    queue_depth=4) as loader:
        for k, il, ir in loader:
            frames[k] = (il, ir)
    for k in range(N_FRAMES):
        np.testing.assert_array_equal(frames[k][0], rendered[k][0])
        np.testing.assert_array_equal(frames[k][1], rendered[k][1])
    return world, frames


def _gates(slam, world) -> float:
    assert not slam.vo.lost
    assert len(slam.keyframe_trajectory) >= 8
    ate = ate_rmse(slam.all_frame_trajectory, world.poses)
    assert ate < 0.10, ate
    assert slam.n_loop_closures >= 1
    return ate


def _run(slam, world, frames):
    for i, (il, ir) in enumerate(frames):
        slam.process(il, ir, world.timestamps[i])
    slam.finish()


def test_port_full_capacity_loop(tmp_path):
    world, frames = decoded_world(str(tmp_path))
    t0 = time.perf_counter()
    port = SLAMSystem(CFG, device=torch.device("cpu"))
    loop.active_vocab(CFG.cap.vocab_k)
    assert loop.VOCAB_SOURCE.endswith("vocab_synth.npz"), loop.VOCAB_SOURCE
    _run(port, world, frames)
    ate = _gates(port, world)
    parity = ate_rmse(port.all_frame_trajectory, np.load(REF_TRAJ))
    print(f"port full capacity: {len(port.keyframe_trajectory)} keyframes, "
          f"{port.n_loop_closures} closures, ATE {ate:.5f} m, "
          f"{parity:.5f} m from the reference, "
          f"{time.perf_counter() - t0:.1f} s")
    assert parity < PARITY_ATE, parity


def _reference_run(frames, world):
    from gfplslam_tpu.config import Config as RefConfig, SlamParams as RefSlamParams
    from gfplslam_tpu.models.slam import SLAMSystem as RefSLAMSystem
    ref = RefSLAMSystem(RefConfig(slam=RefSlamParams(
        max_kf_num_frames=2, lc_kf_dist=6, lc_kf_max_dist=3, lc_nkf_closest=2)))
    _run(ref, world, frames)
    return ref


def test_reference_full_capacity_loop(tmp_path):
    world, frames = decoded_world(str(tmp_path))
    ref = _reference_run(frames, world)
    _gates(ref, world)
    assert ate_rmse(ref.all_frame_trajectory, np.load(REF_TRAJ)) < 0.01


if __name__ == "__main__":
    with tempfile.TemporaryDirectory() as root:
        world, frames = decoded_world(root)
        t0 = time.perf_counter()
        ref = _reference_run(frames, world)
    traj = np.asarray(ref.all_frame_trajectory, np.float64)
    os.makedirs(os.path.dirname(REF_TRAJ), exist_ok=True)
    np.save(REF_TRAJ, traj)
    print(f"wrote {REF_TRAJ}: {traj.shape}, {len(ref.keyframe_trajectory)} "
          f"keyframes, {ref.n_loop_closures} closures, ATE "
          f"{ate_rmse(traj, world.poses):.5f} m, "
          f"{time.perf_counter() - t0:.0f} s", file=sys.stderr)
    _gates(ref, world)
