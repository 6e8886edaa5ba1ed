"""Per-module assessment on a synthetic ground-truth sequence.

Port of ``gfplslam_tpu/apps/assess.py`` (the reference's offline analysis
notebooks simu/line_detect_assessment.py, line_match_assessment.py,
line_stereo_assessment.py, stereo_error_assessment.py,
project_error_assessment.py, timecost_assessment.py): render a synthetic
stereo sequence with known geometry and motion, run each front-end module,
and report per module:

- detect:  line detection recall / endpoint error vs the rendered segments
- match:   cross-frame point matching precision (ground truth by projected
           geometry)
- stereo:  triangulated point / line-endpoint depth error vs ground truth
- project: reprojection error of the matches under the estimated pose
- timing:  per-module TimeLog means from a ``run_slam`` ``<out>_Log.txt``

``run(argv)`` computes and returns (summary, per-module data); ``main``
also writes the reference's PNGs (``line_detect.png``,
``stereo_error.png``, ``match_project.png``; ``timing.png`` under
``--timelog``) and ``summary.json`` under ``-o``. Runs on the CUDA card
unless ``--device`` names another.

Usage:
  python -m gfplslam_torch.apps.assess --frames 6 -o out/assess
  python -m gfplslam_torch.apps.assess --timelog out_Log.txt -o out/assess
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def _parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("-o", "--out", default="gfpl_assess")
    ap.add_argument("--timelog", default=None,
                    help="summarize an existing <out>_Log.txt instead of running")
    ap.add_argument("--noise", type=float, default=1.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    return ap.parse_args(argv)


def _timelog(path: str):
    """Mean ms per time_* field of a ``_Log.txt``, and its rows."""
    from gfplslam_torch.utils.timing import FIELDS
    rows = np.atleast_2d(np.loadtxt(path))
    fields = [f for f in FIELDS if f.startswith("time")]
    return ({f: float(np.mean(rows[:, i]) * 1e3) for i, f in enumerate(fields)},
            dict(rows=rows, fields=fields))


def run(argv=None):
    """The assessment: (summary, data for the plots)."""
    args = _parse(argv)
    if args.timelog:
        timing, data = _timelog(args.timelog)
        return {"timing_ms": timing}, dict(data, out=args.out)

    import torch
    from gfplslam_torch.config import (CameraParams, CapacityParams, Config,
                                       OrbParams)
    from gfplslam_torch.io import synthetic
    from gfplslam_torch.models import frame as frame_mod
    from gfplslam_torch.models import tracker as trk

    dev = torch.device(args.device)
    cfg = Config(cap=CapacityParams(n_pt=512, n_ln=256),
                 orb=OrbParams(nlevels=2),
                 camera=CameraParams(width=376, height=240, fx=217.6,
                                     fy=217.6, cx=183.7, cy=126.1,
                                     baseline=0.11))
    cam = cfg.camera
    world = synthetic.make_world(n_frames=args.frames, n_points=250,
                                 n_lines=40, seed=5, cam=cam)

    frames = []
    for i in range(args.frames):
        il, ir = synthetic.render_frame(world, i, noise=args.noise)
        frames.append(frame_mod.process_stereo_pair(
            torch.as_tensor(il, device=dev), torch.as_tensor(ir, device=dev),
            cfg, 20.0))

    def cam_pts(t_wc, pts):
        t_cw = np.linalg.inv(t_wc)
        return (t_cw[:3, :3] @ pts.T).T + t_cw[:3, 3]

    def proj(p):
        return np.stack([cam.fx * p[:, 0] / p[:, 2] + cam.cx,
                         cam.fy * p[:, 1] / p[:, 2] + cam.cy], 1)

    def host(x):
        return x.cpu().numpy()

    # ---- detect: line recall + endpoint error vs rendered segments ----
    ep_errs, recalls = [], []
    for i, f in enumerate(frames):
        sp_gt = proj(cam_pts(world.poses[i], world.seg_start))
        ep_gt = proj(cam_pts(world.poses[i], world.seg_end))
        v = host(f.feat_l.ln_valid)
        sp = host(f.feat_l.ln_sp)[v]
        ep = host(f.feat_l.ln_ep)[v]
        z = cam_pts(world.poses[i], world.seg_start)[:, 2]
        vis = ((z > 0.5)
               & (sp_gt[:, 0] > 5) & (sp_gt[:, 0] < cam.width - 5)
               & (sp_gt[:, 1] > 5) & (sp_gt[:, 1] < cam.height - 5)
               & (ep_gt[:, 0] > 5) & (ep_gt[:, 0] < cam.width - 5)
               & (ep_gt[:, 1] > 5) & (ep_gt[:, 1] < cam.height - 5)
               & (np.linalg.norm(ep_gt - sp_gt, axis=1) > 18))
        hit = 0
        for g_s, g_e in zip(sp_gt[vis], ep_gt[vis]):
            if len(sp) == 0:
                continue
            d1 = np.linalg.norm(sp - g_s, axis=1) + np.linalg.norm(ep - g_e, axis=1)
            d2 = np.linalg.norm(sp - g_e, axis=1) + np.linalg.norm(ep - g_s, axis=1)
            d = np.minimum(d1, d2) / 2.0
            if d.min() < 8.0:
                hit += 1
                ep_errs.append(float(d.min()))
        recalls.append(hit / max(int(vis.sum()), 1))

    # ---- stereo: triangulated depth error vs ground truth ----
    pt_depth_err, ln_depth_err = [], []
    for i, f in enumerate(frames):
        gt_cam = cam_pts(world.poses[i], world.points)
        gt_uv = proj(gt_cam)
        v = host(f.points.valid)
        xy = host(f.points.xy)[v]
        p3 = host(f.points.p3d)[v]
        for u, p in zip(xy, p3):
            d = np.linalg.norm(gt_uv - u, axis=1)
            j = int(np.argmin(d))
            if d[j] < 2.0 and gt_cam[j, 2] > 0.3:
                pt_depth_err.append(float(abs(p[2] - gt_cam[j, 2])
                                          / gt_cam[j, 2]))
        gt_s = cam_pts(world.poses[i], world.seg_start)
        gt_suv = proj(gt_s)
        lv = host(f.lines.valid)
        lsp = host(f.lines.sp)[lv]
        lp3 = host(f.lines.sp3d)[lv]
        for u, p in zip(lsp, lp3):
            d = np.linalg.norm(gt_suv - u, axis=1)
            j = int(np.argmin(d))
            if d[j] < 4.0 and gt_s[j, 2] > 0.3:
                ln_depth_err.append(float(abs(p[2] - gt_s[j, 2])
                                          / gt_s[j, 2]))

    # ---- match + project: cross-frame matching correctness and
    # reprojection error under the estimated pose ----
    st = trk.initial_state(cfg, dev)
    match_prec, reproj_errs = [], []
    for i in range(1, args.frames):
        out = trk.track_step(cfg, st, frames[i - 1], frames[i],
                             torch.tensor(0.05, device=dev))
        st = out.state
        mm = out.matches
        # ground-truth flow: project prev-frame stereo 3D into current frame
        t_rel = np.linalg.inv(world.poses[i]) @ world.poses[i - 1]
        pv = host(mm.points.valid)
        p3_prev = host(mm.points.p3d)[pv]
        obs = host(mm.points.obs)[pv]
        pred = proj((t_rel[:3, :3] @ p3_prev.T).T + t_rel[:3, 3])
        good = np.linalg.norm(pred - obs, axis=1) < 3.0
        match_prec.append(float(good.mean()) if len(good) else 0.0)
        # reprojection error of inlier matches under the ESTIMATED pose
        est = host(out.pose.dt)
        pred_est = proj((est[:3, :3] @ p3_prev.T).T + est[:3, 3])
        reproj_errs.extend(
            np.linalg.norm(pred_est - obs, axis=1)[good].tolist())

    summary = dict(
        line_recall=float(np.mean(recalls)),
        line_endpoint_err_px=float(np.mean(ep_errs)) if ep_errs else None,
        pt_depth_relerr=float(np.median(pt_depth_err)) if pt_depth_err else None,
        ln_depth_relerr=float(np.median(ln_depth_err)) if ln_depth_err else None,
        match_precision=float(np.mean(match_prec)),
        reproj_err_px=float(np.median(reproj_errs)) if reproj_errs else None,
    )
    return summary, dict(out=args.out, ep_errs=ep_errs, recalls=recalls,
                         pt_depth_err=pt_depth_err, ln_depth_err=ln_depth_err,
                         match_prec=match_prec, reproj_errs=reproj_errs)


def plot(data) -> None:
    """The reference's figures for whichever mode ``run`` computed."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    def save(fig, name):
        fig.tight_layout()
        fig.savefig(os.path.join(data["out"], name), dpi=110)
        plt.close(fig)

    if "rows" in data:
        fig, ax = plt.subplots(figsize=(11, 5))
        for i, f in enumerate(data["fields"]):
            ax.plot(data["rows"][:, i] * 1e3, label=f)
        ax.set_xlabel("frame")
        ax.set_ylabel("ms")
        ax.legend(fontsize=7, ncol=2)
        ax.set_title("per-module time per frame (TimeLog)")
        save(fig, "timing.png")
        return

    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    axes[0].hist(data["ep_errs"], bins=24)
    axes[0].set_title("line endpoint error (px, matched GT)")
    axes[1].plot(data["recalls"], "o-")
    axes[1].set_ylim(0, 1.05)
    axes[1].set_title("line detection recall per frame")
    save(fig, "line_detect.png")

    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    axes[0].hist(data["pt_depth_err"], bins=24)
    axes[0].set_title("stereo point relative depth error")
    axes[1].hist(data["ln_depth_err"], bins=24)
    axes[1].set_title("stereo line-endpoint relative depth error")
    save(fig, "stereo_error.png")

    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    axes[0].plot(data["match_prec"], "o-")
    axes[0].set_ylim(0, 1.05)
    axes[0].set_title("cross-frame point match precision")
    axes[1].hist(data["reproj_errs"], bins=30)
    axes[1].set_title("reprojection error @ estimated pose (px)")
    save(fig, "match_project.png")


def main(argv=None):
    summary, data = run(argv)
    os.makedirs(data["out"], exist_ok=True)
    plot(data)
    if "rows" not in data:
        with open(os.path.join(data["out"], "summary.json"), "w") as f:
            json.dump(summary, f)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
