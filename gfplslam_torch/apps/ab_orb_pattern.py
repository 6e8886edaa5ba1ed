"""A/B: learned ORB pattern vs generated Gaussian pool.

Port of ``gfplslam_tpu/apps/ab_orb_pattern.py``. Measures, on textured
synthetic stereo pairs with exact ground truth (io/synthetic.py), for each
descriptor sampling pattern:

- stereo inlier rate: fraction of accepted stereo matches whose disparity is
  within 1 px of the ground-truth disparity of the nearest painted landmark;
- cross-frame match precision: fraction of accepted cross-frame matches that
  link observations of the same painted landmark.

The learned table is the reference's operating point
(src/ORBextractor.cc:150-406); the generated pool was the JAX package's
first placeholder. ``evaluate`` leaves the pattern it measured selected
(``ops/orb.py::set_pattern``), as the reference's does; ``run`` measures
"random" then "orb", so the default pattern is selected after it. Runs on
the CUDA card unless ``--device`` names another.

Usage: python -m gfplslam_torch.apps.ab_orb_pattern
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def _gt_assign(cam, world, pose, xy, max_px=2.5):
    """Nearest painted-landmark id per keypoint (or -1)."""
    t_cw = np.linalg.inv(pose)
    pc = world.points @ t_cw[:3, :3].T + t_cw[:3, 3]
    vis = pc[:, 2] > 0.3
    u = cam.fx * pc[:, 0] / np.maximum(pc[:, 2], 1e-6) + cam.cx
    v = cam.fy * pc[:, 1] / np.maximum(pc[:, 2], 1e-6) + cam.cy
    uv = np.stack([u, v], 1)
    d = np.linalg.norm(xy[:, None, :] - uv[None, :, :], axis=-1)
    d[:, ~vis] = 1e9
    best = np.argmin(d, axis=1)
    ok = d[np.arange(len(xy)), best] < max_px
    return np.where(ok, best, -1), pc


def evaluate(pattern: str, n_frames: int = 6, seed: int = 5, device="cuda"):
    import torch
    from gfplslam_torch.config import (CameraParams, CapacityParams, Config,
                                       OrbParams)
    from gfplslam_torch.io import synthetic
    from gfplslam_torch.models import tracker as trk
    from gfplslam_torch.models.frame import process_stereo_pair
    from gfplslam_torch.ops import orb as orb_ops

    orb_ops.set_pattern(pattern)
    dev = torch.device(device)

    cam = CameraParams(width=376, height=240, fx=217.6, fy=217.6,
                       cx=183.7, cy=126.1, baseline=0.11)
    cfg = Config(cap=CapacityParams(n_pt=256, n_ln=128),
                 orb=OrbParams(nlevels=2), camera=cam)
    world = synthetic.make_world(n_frames=n_frames, n_points=400, n_lines=30,
                                 seed=seed)

    st_in, st_tot = 0, 0     # stereo inliers / accepted stereo matches
    cf_in, cf_tot = 0, 0     # cross-frame correct / accepted
    prev = None
    prev_ids = None
    for i in range(n_frames):
        il, ir = synthetic.render_frame(world, i, noise=1.5)
        f = process_stereo_pair(torch.as_tensor(il, device=dev),
                                torch.as_tensor(ir, device=dev), cfg, 20.0)
        xy = f.points.xy.cpu().numpy()
        valid = f.points.valid.cpu().numpy()
        disp = f.points.disp.cpu().numpy()
        ids, pc = _gt_assign(cam, world, world.poses[i], xy)
        gt_disp = cam.fx * cam.baseline / np.maximum(pc[ids, 2], 1e-6)
        good = valid & (ids >= 0)
        st_tot += int(valid.sum())
        st_in += int((good & (np.abs(disp - gt_disp) < 1.0)).sum())

        if prev is not None:
            out = trk.track_step(cfg, trk.initial_state(cfg, dev), prev, f,
                                 torch.tensor(0.05, device=dev))
            pidx = out.matches.pt_curr_idx.cpu().numpy()
            mv = pidx >= 0
            same = (prev_ids >= 0) & mv & (
                prev_ids == np.where(mv, ids[np.clip(pidx, 0, len(ids) - 1)],
                                     -2))
            cf_tot += int(mv.sum())
            cf_in += int(same.sum())
        prev = f
        prev_ids = ids

    return {
        "pattern": pattern,
        "stereo_matches": st_tot,
        "stereo_inlier_rate": round(st_in / max(st_tot, 1), 4),
        "crossframe_matches": cf_tot,
        "crossframe_precision": round(cf_in / max(cf_tot, 1), 4),
    }


def run(argv=None) -> list:
    """Both patterns' reports, "random" first."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    args = ap.parse_args(argv)
    return [evaluate(p, n_frames=args.frames, device=args.device)
            for p in ("random", "orb")]


def main(argv=None) -> list:
    reports = run(argv)
    for r in reports:
        print(json.dumps(r))
    return reports


if __name__ == "__main__":
    main()
