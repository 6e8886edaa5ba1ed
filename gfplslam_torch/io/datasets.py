"""EuRoC / KITTI dataset loaders + timestamp pairing.

Parity with the reference's app-side dataset handling: EuRoC YAML camera
files with Kl/Kr/Dl/Dr/R/t (plslam_mod.cpp:72-145, config/euroc_params.yaml),
KITTI rectified intrinsics (config/kitti/kitti00-02.yaml), stereo pairing of
timestamped image directories within 3 ms (plslam_mod.cpp:220-246), and
ground-truth association files (config/asl/gt-ass).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from gfplslam_torch.config import CameraParams
from gfplslam_torch.ops.camera import RectifyMaps, stereo_rectify


@dataclass
class StereoSequence:
    paths_l: List[str]
    paths_r: List[str]
    timestamps: np.ndarray          # seconds
    cam: CameraParams               # rectified intrinsics
    maps: Optional[RectifyMaps]     # None if images are pre-rectified
    gt_poses: Optional[np.ndarray] = None   # [N, 4, 4] when available
    gt_timestamps: Optional[np.ndarray] = None


def _pair_by_timestamp(ts_l: np.ndarray, ts_r: np.ndarray,
                       tol: float = 0.003) -> List[Tuple[int, int]]:
    """Greedy nearest-timestamp pairing within ``tol`` seconds
    (plslam_mod.cpp:220-246 pairs within 3 ms)."""
    pairs = []
    j = 0
    for i, t in enumerate(ts_l):
        while j + 1 < len(ts_r) and abs(ts_r[j + 1] - t) <= abs(ts_r[j] - t):
            j += 1
        if j < len(ts_r) and abs(ts_r[j] - t) <= tol:
            pairs.append((i, j))
    return pairs


def load_euroc(seq_dir: str, calib: Optional[dict] = None) -> StereoSequence:
    """EuRoC ASL layout: mav0/cam{0,1}/data/<ns>.png + data.csv.
    ``calib``: dict with Kl, Kr, Dl, Dr, R, t (right->left) and image size;
    defaults to the standard EuRoC MAV calibration
    (config/euroc_params.yaml values)."""
    cam0 = os.path.join(seq_dir, "mav0", "cam0", "data")
    cam1 = os.path.join(seq_dir, "mav0", "cam1", "data")
    files_l = sorted(os.listdir(cam0))
    files_r = sorted(os.listdir(cam1))
    ts_l = np.array([int(os.path.splitext(f)[0]) for f in files_l]) * 1e-9
    ts_r = np.array([int(os.path.splitext(f)[0]) for f in files_r]) * 1e-9
    pairs = _pair_by_timestamp(ts_l, ts_r)

    if calib is None:
        # EuRoC MAV standard calibration (euroc_params.yaml:1-18)
        calib = dict(
            kl=np.array([[458.654, 0, 367.215], [0, 457.296, 248.375],
                         [0, 0, 1]]),
            kr=np.array([[457.587, 0, 379.999], [0, 456.134, 255.238],
                         [0, 0, 1]]),
            dl=np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05,
                         0.0]),
            dr=np.array([-0.28368365, 0.07451284, -0.00010473,
                         -3.55590700e-05, 0.0]),
            # cam1 -> cam0 extrinsics
            r=np.array([[0.999997, 0.002312, -0.000760],
                        [-0.002317, 0.999898, -0.014090],
                        [0.000728, 0.014091, 0.999900]]),
            t=np.array([0.110074, -0.000156, 0.000889]),
            width=752, height=480, equidistant=False)

    maps = stereo_rectify(calib["kl"], calib["dl"], calib["kr"], calib["dr"],
                          calib["r"], calib["t"], calib["width"],
                          calib["height"],
                          equidistant=calib.get("equidistant", False))
    gt_poses, gt_ts = _try_load_euroc_gt(seq_dir)
    return StereoSequence(
        paths_l=[os.path.join(cam0, files_l[i]) for i, _ in pairs],
        paths_r=[os.path.join(cam1, files_r[j]) for _, j in pairs],
        timestamps=np.array([ts_l[i] for i, _ in pairs]),
        cam=maps.cam, maps=maps, gt_poses=gt_poses, gt_timestamps=gt_ts)


def _try_load_euroc_gt(seq_dir: str):
    p = os.path.join(seq_dir, "mav0", "state_groundtruth_estimate0",
                     "data.csv")
    if not os.path.exists(p):
        return None, None
    rows = np.loadtxt(p, delimiter=",", skiprows=1, usecols=range(8))
    ts = rows[:, 0] * 1e-9
    poses = []
    for r in rows:
        qw, qx, qy, qz = r[4], r[5], r[6], r[7]
        rot = _quat_to_rot(qx, qy, qz, qw)
        t = np.eye(4)
        t[:3, :3] = rot
        t[:3, 3] = r[1:4]
        poses.append(t)
    return np.stack(poses), ts


def _quat_to_rot(qx, qy, qz, qw):
    return np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)],
    ])


# Per-sequence KITTI odometry calibrations (rectified pinhole; values from
# the reference's per-sequence YAMLs: config/kitti/kitti00-02.yaml,
# kitti03.yaml, kitti04-10.yaml — three distinct camera setups).
KITTI_CALIB = {
    **{s: CameraParams(width=1241, height=376, fx=718.856, fy=718.856,
                       cx=607.1928, cy=185.2157, baseline=0.537165719)
       for s in ("00", "01", "02")},
    "03": CameraParams(width=1242, height=375, fx=721.5377, fy=721.5377,
                       cx=609.5593, cy=172.854, baseline=0.537150588),
    **{s: CameraParams(width=1226, height=370, fx=707.0912, fy=707.0912,
                       cx=601.8873, cy=183.1104, baseline=0.537150653)
       for s in ("04", "05", "06", "07", "08", "09", "10")},
}


def kitti_camera(sequence: str) -> CameraParams:
    """Calibration for a KITTI odometry sequence id ('00'..'10'). Raises for
    unknown sequences instead of silently applying 00-02 intrinsics (the
    reference selects the matching YAML per sequence, Run_KITTI.py:8-52)."""
    seq = sequence.zfill(2)
    if seq not in KITTI_CALIB:
        raise ValueError(
            f"no KITTI calibration for sequence {sequence!r}; known: "
            f"{sorted(KITTI_CALIB)} — pass cam= explicitly for custom rigs")
    return KITTI_CALIB[seq]


def load_gazebo(seq_dir: str) -> StereoSequence:
    """Gazebo simulation layout (batch_script/Run_Gazebo.py +
    config/gazebo_params.yaml): cam0/data/ + cam1/data/ image folders, ideal
    pinhole rig (no distortion, identity rectification), 640x480,
    f=554.25626, c=(320, 240), baseline 0.1 m."""
    cam0 = os.path.join(seq_dir, "cam0", "data")
    cam1 = os.path.join(seq_dir, "cam1", "data")
    files_l = sorted(os.listdir(cam0))
    files_r = sorted(os.listdir(cam1))
    n = min(len(files_l), len(files_r))

    def _ts(files):
        try:
            return np.array([float(os.path.splitext(f)[0])
                             for f in files]) * 1e-9
        except ValueError:
            return np.arange(len(files)) * 0.05

    ts = _ts(files_l)[:n]
    cam = CameraParams(width=640, height=480, fx=554.25626, fy=554.25626,
                       cx=320.0, cy=240.0, baseline=0.1)
    return StereoSequence(
        paths_l=[os.path.join(cam0, f) for f in files_l[:n]],
        paths_r=[os.path.join(cam1, f) for f in files_r[:n]],
        timestamps=ts, cam=cam, maps=None,
        gt_poses=None, gt_timestamps=None)


def load_kitti(seq_dir: str, cam: Optional[CameraParams] = None
               ) -> StereoSequence:
    """KITTI odometry layout: image_0/ image_1/ (rectified grayscale),
    times.txt. Intrinsics are selected per sequence id (the trailing path
    component) from :data:`KITTI_CALIB`; pass ``cam=`` for custom rigs."""
    d0 = os.path.join(seq_dir, "image_0")
    d1 = os.path.join(seq_dir, "image_1")
    files = sorted(os.listdir(d0))
    times_path = os.path.join(seq_dir, "times.txt")
    if os.path.exists(times_path):
        ts = np.loadtxt(times_path)
    else:
        ts = np.arange(len(files)) * 0.1
    if cam is None:
        seq_name = os.path.basename(os.path.normpath(seq_dir))
        try:
            cam = kitti_camera(seq_name)
        except ValueError:
            # custom-named sequence directory: fall back to the 00-02 rig
            # with a warning instead of crashing (callers with real custom
            # rigs pass cam= explicitly)
            import warnings
            warnings.warn(
                f"KITTI sequence dir {seq_name!r} has no known calibration; "
                f"using the 00-02 rig — pass cam= for custom setups")
            cam = KITTI_CALIB["00"]
    gt_poses = None
    poses_path = os.path.join(seq_dir, "poses.txt")
    if os.path.exists(poses_path):
        raw = np.loadtxt(poses_path).reshape(-1, 3, 4)
        gt_poses = np.tile(np.eye(4), (len(raw), 1, 1))
        gt_poses[:, :3, :] = raw
    return StereoSequence(
        paths_l=[os.path.join(d0, f) for f in files],
        paths_r=[os.path.join(d1, f) for f in files],
        timestamps=ts[:len(files)], cam=cam, maps=None,
        gt_poses=gt_poses, gt_timestamps=ts[:len(files)])


def associate_gt(est_ts: np.ndarray, gt_ts: np.ndarray,
                 gt_poses: np.ndarray, tol: float = 0.02):
    """Associate estimate timestamps with GT rows (the role of the vendored
    associations.txt files, config/asl/gt-ass)."""
    out_idx = []
    keep = []
    for i, t in enumerate(est_ts):
        j = int(np.argmin(np.abs(gt_ts - t)))
        if abs(gt_ts[j] - t) <= tol:
            out_idx.append(j)
            keep.append(i)
    return np.asarray(keep), gt_poses[out_idx]
