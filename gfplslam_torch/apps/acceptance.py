"""Acceptance matrix: BASELINE.json's configs x N seeds, one JSON table.

Port of ``gfplslam_tpu/apps/acceptance.py``: fps / ATE / keyframes /
closures per config and seed, so regressions between versions are caught
mechanically. Configs mirror BASELINE.json "configs":

1. points-only frame-to-frame odometry (pose-only)          [EuRoC 752x480]
2. points+lines with good-line-cutting, pose-only           [EuRoC 752x480]
3. full local BA sliding window, LC off                     [KITTI 1241x376]
4. full SLAM: BA + BoW loop closure + PGO (firing)          [EuRoC circuit]
5. distributed BA scaling: ``apps/bench_dist_ba.py`` in a subprocess,
   one rank per card with two or more cards, else 8 gloo ranks on the CPU
   (the reference's fallback to its virtual CPU mesh).

Runs on the CUDA card unless ``--device`` names another; every timed run
ends in a device synchronize.

Usage: python -m gfplslam_torch.apps.acceptance -o ACCEPT_torch.json --seeds 3
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time


def _u8(imgs):
    import numpy as np
    return np.clip(np.round(np.asarray(imgs)), 0, 255).astype(np.uint8)


def _render(world, n, synthetic):
    import numpy as np
    fr = [synthetic.render_frame(world, i, noise=1.0) for i in range(n)]
    return (_u8(np.stack([f[0] for f in fr])),
            _u8(np.stack([f[1] for f in fr])))


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def vo_config(cfg, seeds, motion, n, reps, device):
    """Configs 1-2: whole-sequence VO scan, fps + ATE per seed."""
    import numpy as np
    import torch
    from gfplslam_torch.io import synthetic
    from gfplslam_torch.models.vo import run_vo_scan
    from gfplslam_torch.utils.trajectory import ate_rmse

    rows = []
    for seed in seeds:
        world = synthetic.make_world(n_frames=n, n_points=900, n_lines=90,
                                     seed=seed, motion=motion,
                                     cam=cfg.camera, textured=True)
        il, ir = _render(world, n, synthetic)
        il = torch.as_tensor(il, device=device)
        ir = torch.as_tensor(ir, device=device)
        ts = torch.as_tensor(world.timestamps.astype(np.float32), device=device)
        poses, _ = run_vo_scan(cfg, il, ir, ts, device=device)
        _sync(device)
        samples = []
        for _ in range(reps):
            t0 = time.perf_counter()
            poses, _ = run_vo_scan(cfg, il, ir, ts, device=device)
            _sync(device)
            samples.append((n - 1) / (time.perf_counter() - t0))
        rows.append({
            "seed": seed,
            "fps": round(statistics.median(samples), 2),
            "ate_rmse": round(float(ate_rmse(poses.cpu().numpy(),
                                             world.poses)), 4)})
    return rows


def slam_config(cfg, seeds, motion, n, chunk, lc, reps, device):
    """Configs 3-4: streaming full-SLAM driver, fps/ATE/KFs/closures."""
    import numpy as np
    from gfplslam_torch.io import synthetic
    from gfplslam_torch.models.slam import SLAMSystem
    from gfplslam_torch.utils.trajectory import ate_rmse

    rows = []
    for seed in seeds:
        world = synthetic.make_world(n_frames=n, n_points=900, n_lines=90,
                                     seed=seed, motion=motion,
                                     cam=cfg.camera, textured=True)
        il, ir = _render(world, n, synthetic)
        ts = np.asarray(world.timestamps)

        def run():
            s = SLAMSystem(cfg, device=device, run_loop_closure=lc)
            t0 = time.perf_counter()
            s.run_sequence(il, ir, ts, chunk=chunk)
            s.finish()
            _sync(device)
            return s, time.perf_counter() - t0

        run()  # warm-up (allocator, first-use kernel build)
        samples, slam = [], None
        for _ in range(reps):
            slam, dt = run()
            samples.append(n / dt)
        rows.append({
            "seed": seed,
            "fps": round(statistics.median(samples), 2),
            "ate_rmse": round(float(ate_rmse(slam.all_frame_trajectory,
                                             world.poses)), 4),
            "keyframes": len(slam.keyframe_trajectory),
            "loop_closures": slam.n_loop_closures,
            "track_lost": bool(slam.vo.lost)})
    return rows


def dist_ba_config(seeds, device, kfs=16, points=8064, lines=1008, iters=8,
                   reps=3):
    """Config 5: landmark-sharded distributed BA scaling (a subprocess;
    same protocol as DIST_BA_r0N.json). The problem size defaults are the
    reference's."""
    import torch
    ranks_on = ("cuda" if device.type == "cuda" and torch.cuda.device_count() >= 2
                else "cpu")
    rows = []
    for seed in seeds[:1]:  # one problem, median-of-reps inside the app
        out = subprocess.run(
            [sys.executable, "-m", "gfplslam_torch.apps.bench_dist_ba",
             "--kfs", str(kfs), "--points", str(points), "--lines", str(lines),
             "--iters", str(iters), "--reps", str(reps), "--seed", str(seed),
             "--device", ranks_on],
            capture_output=True, text=True, timeout=3600)
        line = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
        if not line:
            rows.append({"seed": seed, "error": out.stderr[-400:]})
            continue
        data = json.loads(line[-1])
        rows.append({"seed": seed, "device": ranks_on,
                     "ms_per_iter": data["ms_per_iter"],
                     "scaling_efficiency": data["scaling_efficiency"]})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("-o", "--out", default="ACCEPT_torch.json")
    ap.add_argument("--skip-dist", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    args = ap.parse_args(argv)
    seeds = [3, 11, 19][:args.seeds]

    from dataclasses import replace

    import torch
    from gfplslam_torch.config import (CameraParams, Config, SlamParams,
                                       StvoParams)
    device = torch.device(args.device)
    euroc = CameraParams()
    kitti = CameraParams(width=1241, height=376, fx=718.856, fy=718.856,
                         cx=607.1928, cy=185.2157, baseline=0.537165719)
    cfg_pl = Config(camera=euroc)
    cfg_pt = replace(cfg_pl, stvo=StvoParams(has_lines=False,
                                             use_line_conf_cut=False))
    cfg_kitti = Config(camera=kitti)
    # LC gates scaled to the 121-frame circuit loop period (see bench.py)
    cfg_slam = Config(camera=euroc,
                      slam=SlamParams(lc_kf_dist=12, lc_kf_max_dist=6))

    results = {"seeds": seeds, "reps": args.reps, "device": str(device),
               "configs": {}}
    t_all = time.perf_counter()
    results["configs"]["1_points_only_vo"] = vo_config(
        cfg_pt, seeds, "forward", 48, args.reps, device)
    results["configs"]["2_pl_linecut_vo"] = vo_config(
        cfg_pl, seeds, "forward", 48, args.reps, device)
    results["configs"]["3_kitti_local_ba"] = slam_config(
        cfg_kitti, seeds, "forward", 61, 20, False, args.reps, device)
    results["configs"]["4_full_slam_lc"] = slam_config(
        cfg_slam, seeds, "circuit", 121, 24, True, args.reps, device)
    if not args.skip_dist:
        results["configs"]["5_dist_ba"] = dist_ba_config(seeds, device)
    results["wall_s"] = round(time.perf_counter() - t_all, 1)

    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results, indent=1))
    return results


if __name__ == "__main__":
    main()
