"""Timing-instrumented VO driver: the per-module TimeLog mode.

Port of ``gfplslam_tpu/models/timed_vo.py``. The reference stamps clock()
deltas around each front-end stage and logs 10 per-module times per frame
(stereoFrame.cpp:628-629, 765-766, stereoFrameHandler.cpp:140-145,
plslam_mod.cpp:494-513). ``VisualOdometry`` queues a whole frame on the
device with no host read, so its stage boundaries are never observed; this
driver runs the SAME ops in the same order as one call per reference stage
and synchronizes the device after each, giving real per-stage wall times at
the cost of the overlap between host dispatch and device work (use for
diagnosis, not throughput: ``run_slam --timing``). On the CPU every op is
synchronous, so no sync is needed there.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from gfplslam_torch.models import pose_opt
from gfplslam_torch.models import tracker as trk
from gfplslam_torch.models.frame import (StereoFrame, camera_features,
                                         describe_line_segments,
                                         detect_line_segments,
                                         detect_point_features, empty_lines,
                                         stereo_match_lines,
                                         stereo_match_points, take)
from gfplslam_torch.models.vo import VisualOdometry, _as_device
from gfplslam_torch.ops.pyramid import build_pyramid_padded
from gfplslam_torch.utils import se3
from gfplslam_torch.utils.timing import StageTimer, TimeLog


@dataclass
class TimedVO(VisualOdometry):
    """VisualOdometry with the front-end/tracking hooks split into one
    synchronized call per reference TimeLog stage. Numerically identical to
    the fused path (same ops, same order); only the syncs differ."""

    def _lap(self, timer: StageTimer) -> float:
        dev = torch.device(self.device)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return timer.lap()

    def _frontend(self, img_l, img_r, log: TimeLog, timer: StageTimer,
                  fast_th=None) -> StereoFrame:
        cfg = self.cfg
        dev = torch.device(self.device)
        th = self.state.fast_th if fast_th is None else fast_th
        imgs = torch.stack([_as_device(img_l, dev),
                            _as_device(img_r, dev)]).float()

        # pyramids + FAST + ORB for both cameras
        pyrs = build_pyramid_padded(imgs, cfg.orb.nlevels, cfg.orb.scale_factor)
        points = detect_point_features(pyrs, cfg, th)
        log.time_pt_extract = self._lap(timer)

        if cfg.stvo.has_lines:
            lines = detect_line_segments(imgs, cfg)
            log.time_ln_detect = self._lap(timer)
            ln_desc = describe_line_segments(imgs, lines.sp, lines.ep)
            log.time_ln_descri = self._lap(timer)
            feats = camera_features(cfg, points, lines, ln_desc)
        else:
            feats = camera_features(cfg, points)
        feat_l, feat_r = take(feats, 0), take(feats, 1)

        stereo_pts = stereo_match_points(cfg.camera, cfg, feat_l, feat_r,
                                         pyrs[0], pyrs[1])
        log.time_pt_stereo = self._lap(timer)

        if cfg.stvo.has_lines:
            stereo_lns = stereo_match_lines(cfg.camera, cfg, feat_l, feat_r)
            log.time_ln_stereo = self._lap(timer)
        else:
            stereo_lns = empty_lines(cfg, dev)
        return StereoFrame(points=stereo_pts, lines=stereo_lns, feat_l=feat_l)

    def _track(self, frame: StereoFrame, delta_t: float, log: TimeLog,
               timer: StageTimer) -> trk.TrackOutput:
        cfg = self.cfg
        dev = torch.device(self.device)
        dt_pred = se3.inverse_se3(self.state.dt_store)
        pts, pt_idx = trk.cross_match_points(cfg, self.prev_frame, frame, dt_pred)
        log.time_pt_cross = self._lap(timer)

        lns, ln_idx = trk.cross_match_lines(cfg, self.prev_frame, frame)
        log.time_ln_cross = self._lap(timer)

        matches = trk.CrossMatches(points=pts, lines=lns,
                                   pt_curr_idx=pt_idx, ln_curr_idx=ln_idx)
        if cfg.stvo.use_line_conf_cut and cfg.stvo.has_lines:
            opt_lines = trk.apply_linecut(cfg, self.prev_frame, matches, dt_pred)
            log.time_ln_cut = self._lap(timer)
        else:
            opt_lines = matches.lines

        res = pose_opt.optimize_pose(cfg.camera, dt_pred, matches.points,
                                     opt_lines, cfg.optimizer,
                                     _as_device(delta_t, dev, torch.float32))
        out = trk.finalize_track(cfg, self.state, matches, res)
        log.time_pose_optim = self._lap(timer)
        return out
