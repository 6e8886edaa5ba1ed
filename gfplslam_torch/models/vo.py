"""Visual-odometry drivers: the sequential loop around the per-frame
front-end (``process_stereo_pair``) and tracker (``track_step``).

Port of ``gfplslam_tpu/models/vo.py`` (app/plstvo_mod.cpp:249-318,
stereoFrameHandler.cpp:83-151, 864-922). The reference's ``lax.scan`` is a
Python loop over frames here; the keyframe reset is selected with
``torch.where`` on every state leaf, so the scan paths read nothing back
from the device until the caller asks for the result. ``VisualOdometry``
is the interactive driver: one batched device-to-host read per frame.

Every entry point runs on the CUDA card unless the caller passes another
``device`` (the CPU tests pass ``torch.device("cpu")``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from gfplslam_torch.config import Config
from gfplslam_torch.models import tracker as trk
from gfplslam_torch.models.frame import StereoFrame, process_stereo_pair
from gfplslam_torch.utils.timing import StageTimer, TimeLog, TimeLogWriter

CUDA = torch.device("cuda")


def _as_device(x, device: torch.device, dtype=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=device)


def _stack_tree(items):
    """Stack a list of (nested) NamedTuples leaf by leaf along a new axis 0."""
    first = items[0]
    if isinstance(first, tuple):
        return type(first)(*(_stack_tree([it[k] for it in items])
                             for k in range(len(first))))
    return torch.stack(items)


def _scan_step(cfg: Config, carry, img_l, img_r, ts):
    """One frame of the scan: front-end, tracking, KF bookkeeping."""
    st, prev_frame, prev_ts, t_abs = carry
    frame = process_stereo_pair(img_l, img_r, cfg, st.fast_th)
    out = trk.track_step(cfg, st, prev_frame, frame,
                         torch.clamp(ts - prev_ts, min=1e-3))
    t_abs_new = t_abs @ out.state.dt_store
    # KF bookkeeping reset (currFrameIsKF) without touching t_abs
    st_kf = trk.mark_keyframe(out.state)
    st_next = trk.TrackerState(*(torch.where(out.need_kf, a, b)
                                 for a, b in zip(st_kf, out.state)))
    return (st_next, frame, ts, t_abs_new), out, t_abs_new


def init_scan_carry(cfg: Config, img_l, img_r, timestamp, *,
                    device: torch.device = CUDA):
    """Frame-0 carry for :func:`run_vo_scan_chunk`. Detection runs at the
    FAST floor threshold (the bootstrap analog of the reference's
    looser-gated extractInitialStereoFeatures, stereoFrame.cpp:148-336).
    Returns (carry, frame0)."""
    st0 = trk.initial_state(cfg, device)
    frame0 = process_stereo_pair(
        _as_device(img_l, device), _as_device(img_r, device), cfg,
        _as_device(float(cfg.tracking.fast_min_th), device, torch.float32))
    carry = (st0, frame0, _as_device(timestamp, device, torch.float32),
             torch.eye(4, device=device))
    return carry, frame0


def run_vo_scan_chunk(cfg: Config, carry, imgs_l, imgs_r, timestamps, *,
                      device: torch.device = CUDA):
    """One chunk of the whole-sequence scan, tracker carry in and out.

    Args: carry from :func:`init_scan_carry` or a previous chunk;
    imgs [T, H, W]; timestamps [T].
    Returns (carry', poses [T, 4, 4] absolute cam->world, aux dict of [T]
    tensors, frames: the per-frame StereoFrame with leading T axis)."""
    imgs_l = _as_device(imgs_l, device)
    imgs_r = _as_device(imgs_r, device)
    ts = _as_device(timestamps, device, torch.float32)
    poses, outs, frames = [], [], []
    for i in range(imgs_l.shape[0]):
        carry, out, pose = _scan_step(cfg, carry, imgs_l[i], imgs_r[i], ts[i])
        poses.append(pose)
        outs.append(out)
        frames.append(carry[1])
    aux = dict(accepted=torch.stack([o.pose.accepted for o in outs]),
               n_pt=torch.stack([o.n_inliers_pt for o in outs]),
               n_ln=torch.stack([o.n_inliers_ln for o in outs]),
               is_kf=torch.stack([o.need_kf for o in outs]),
               lost=torch.stack([o.track_lost for o in outs]))
    return carry, torch.stack(poses), aux, _stack_tree(frames)


def pack_chunk_aux(cfg: Config, poses: torch.Tensor, aux: dict) -> torch.Tensor:
    """[T, 21] float32: per-frame (is_kf, accepted, lost, n_pt, n_ln,
    flattened 4x4 pose) — the chunk's ONE device->host transfer."""
    t = poses.shape[0]
    return torch.cat([
        torch.stack([aux["is_kf"], aux["accepted"], aux["lost"], aux["n_pt"],
                     aux["n_ln"]], 1).to(torch.float32),
        poses.reshape(t, 16).to(torch.float32)], 1)


def run_vo_scan(cfg: Config, imgs_l, imgs_r, timestamps, *,
                device: torch.device = CUDA):
    """Whole-sequence visual odometry: every frame's front-end + tracker on
    ``device`` with no host read between frames.

    Args: imgs_l/imgs_r [T, H, W] (uint8 or float32, rectified),
    timestamps [T]. Returns (poses [T, 4, 4] absolute cam->world, aux dict of
    per-frame [T-1] diagnostics)."""
    imgs_l = _as_device(imgs_l, device)
    imgs_r = _as_device(imgs_r, device)
    ts = _as_device(timestamps, device, torch.float32)
    carry, _ = init_scan_carry(cfg, imgs_l[0], imgs_r[0], ts[0], device=device)
    poses, outs = [], []
    for i in range(1, imgs_l.shape[0]):
        carry, out, pose = _scan_step(cfg, carry, imgs_l[i], imgs_r[i], ts[i])
        poses.append(pose)
        outs.append(out)
    poses = torch.cat([torch.eye(4, device=device)[None], torch.stack(poses)])
    aux = dict(accepted=torch.stack([o.pose.accepted for o in outs]),
               n_pt=torch.stack([o.n_inliers_pt for o in outs]),
               n_ln=torch.stack([o.n_inliers_ln for o in outs]),
               is_kf=torch.stack([o.need_kf for o in outs]),
               err=torch.stack([o.pose.err for o in outs]))
    return poses, aux


@dataclass
class FrameRecord:
    timestamp: float
    t_cam_w: np.ndarray      # absolute cam->world (world = first KF frame)
    is_kf: bool
    n_pt: int
    n_ln: int
    accepted: bool
    base_kf: int = 0
    t_rel_base: np.ndarray = None


@dataclass
class VisualOdometry:
    """Host-driven VO: one :meth:`process` call per stereo pair."""
    cfg: Config
    device: torch.device = CUDA
    state: Optional[trk.TrackerState] = None
    prev_frame: Optional[StereoFrame] = None
    prev_time: float = 0.0
    t_base_w: np.ndarray = field(default_factory=lambda: np.eye(4))
    records: List[FrameRecord] = field(default_factory=list)
    timelog: TimeLogWriter = field(default_factory=TimeLogWriter)
    frame_idx: int = 0
    lost: bool = False
    kf_count: int = 0
    last_kf_rel: Optional[np.ndarray] = None

    def rebase(self, t_base_w: np.ndarray) -> None:
        """Re-base the tracker's absolute frame onto a corrected base-KF pose
        (the back-end feeds BA/PGO corrections forward so subsequent frames
        ride the optimized map, plslam_mod.cpp:471-477)."""
        self.t_base_w = np.asarray(t_base_w, np.float64).copy()

    def process(self, img_l: np.ndarray, img_r: np.ndarray,
                timestamp: float) -> FrameRecord:
        """One camera frame. Returns this frame's record."""
        dev = torch.device(self.device)
        timer = StageTimer()
        log = TimeLog()
        if self.state is None:
            self.state = trk.initial_state(self.cfg, dev)
        # frame 0 detects at the FAST floor
        th = (_as_device(float(self.cfg.tracking.fast_min_th), dev, torch.float32)
              if self.prev_frame is None else self.state.fast_th)
        frame = process_stereo_pair(_as_device(img_l, dev),
                                    _as_device(img_r, dev), self.cfg, th)
        log.time_pt_extract = timer.lap()

        if self.prev_frame is None:
            n_pt0, n_ln0 = torch.stack([frame.points.valid.sum(),
                                        frame.lines.valid.sum()]).tolist()
            log.num_pt_stereo, log.num_ln_stereo = int(n_pt0), int(n_ln0)
            self.prev_frame = frame
            self.prev_time = timestamp
            self.kf_count = 1
            self.last_kf_rel = np.eye(4)
            rec = FrameRecord(timestamp, self.t_base_w.copy(), True,
                              log.num_pt_stereo, log.num_ln_stereo, True,
                              base_kf=0, t_rel_base=np.eye(4))
            self.records.append(rec)
            self.timelog.append(log)
            self.frame_idx += 1
            return rec

        delta_t = max(timestamp - self.prev_time, 1e-3)
        out = trk.track_step(self.cfg, self.state, self.prev_frame, frame,
                             _as_device(delta_t, dev, torch.float32))
        log.time_pose_optim = timer.lap()
        # every host-visible scalar of the frame in ONE device->host read
        packed = torch.cat([
            torch.stack([frame.points.valid.sum(), frame.lines.valid.sum(),
                         out.n_inliers_pt, out.n_inliers_ln]).float(),
            torch.stack([out.need_kf, out.pose.accepted, out.track_lost]).float(),
            out.state.t_cam_w.reshape(-1).float()]).cpu().numpy()
        n_pt_st, n_ln_st, n_pt_x, n_ln_x = packed[:4]
        need_kf, accepted, lost = (bool(v) for v in packed[4:7] > 0.5)
        t_rel = packed[7:23].reshape(4, 4).astype(np.float64)
        log.num_pt_stereo = int(n_pt_st)
        log.num_ln_stereo = int(n_ln_st)
        log.num_pt_cross = int(n_pt_x)
        log.num_ln_cross = int(n_ln_x)
        log.time_track = log.time_pt_extract + log.time_pose_optim

        self.state = out.state
        if need_kf:
            self.last_kf_rel = t_rel.copy()
            self.t_base_w = self.t_base_w @ t_rel
            self.state = trk.mark_keyframe(out.state)
            t_abs = self.t_base_w.copy()
            base_kf = self.kf_count
            t_rel_base = np.eye(4)
            self.kf_count += 1
        else:
            t_abs = self.t_base_w @ t_rel
            base_kf = self.kf_count - 1
            t_rel_base = t_rel
        self.lost = self.lost or lost
        self.prev_frame = frame
        self.prev_time = timestamp
        rec = FrameRecord(timestamp, t_abs, need_kf, int(n_pt_x), int(n_ln_x),
                          accepted, base_kf=base_kf, t_rel_base=t_rel_base)
        self.records.append(rec)
        self.timelog.append(log)
        self.frame_idx += 1
        return rec

    @property
    def trajectory(self) -> np.ndarray:
        return np.stack([r.t_cam_w for r in self.records])

    @property
    def timestamps(self) -> np.ndarray:
        return np.asarray([r.timestamp for r in self.records])
