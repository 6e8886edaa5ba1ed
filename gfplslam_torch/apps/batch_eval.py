"""Batch evaluation runner: N sequences x R repeats -> ATE table.

Port of ``gfplslam_tpu/apps/batch_eval.py`` (batch_script/Run_EuRoC.py:8-49,
Run_KITTI.py:8-52: per-sequence repeated ``plslam_mod`` invocations
collecting trajectory files). Sequences run in-process: synthetic ones
through ``run_vo_scan`` (each run queued whole on the device, one read at
the end), dataset ones through ``apps/run_slam.py``. Runs on the CUDA card
unless ``--device`` names another.

Usage:
  python -m gfplslam_torch.apps.batch_eval --synthetic --sequences 4 \
      --frames 20 --repeats 2 -o out/batch
  python -m gfplslam_torch.apps.batch_eval --euroc-root DIR/euroc \
      --sequences MH_01_easy MH_02_easy -o out/batch
  python -m gfplslam_torch.apps.batch_eval --kitti-root DIR/sequences \
      --sequences 00 03 05 -o out/batch
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def run_synthetic(args):
    import torch
    from gfplslam_torch.config import (CameraParams, CapacityParams, Config,
                                       OrbParams)
    from gfplslam_torch.io import synthetic
    from gfplslam_torch.models.vo import run_vo_scan
    from gfplslam_torch.utils.trajectory import ate_rmse, write_tum

    device = torch.device(args.device)
    cam = CameraParams(width=376, height=240, fx=217.6, fy=217.6,
                       cx=183.7, cy=126.1, baseline=0.11)
    cfg = Config(camera=cam,
                 cap=CapacityParams(n_pt=512, n_ln=256),
                 orb=OrbParams(nlevels=2))
    results = []
    for seq in range(args.sequences):
        world = synthetic.make_world(n_frames=args.frames, seed=100 + seq,
                                     cam=cam)
        frames = [synthetic.render_frame(world, i)
                  for i in range(args.frames)]
        imgs_l = torch.as_tensor(np.stack([f[0] for f in frames]), device=device)
        imgs_r = torch.as_tensor(np.stack([f[1] for f in frames]), device=device)
        ts = torch.as_tensor(world.timestamps.astype(np.float32), device=device)
        for rep in range(args.repeats):
            t0 = time.perf_counter()
            poses, aux = run_vo_scan(cfg, imgs_l, imgs_r, ts, device=device)
            est = poses.cpu().numpy()  # waits for the run
            wall = time.perf_counter() - t0
            rmse = float(ate_rmse(est, world.poses))
            row = dict(sequence=f"synthetic_{seq}", repeat=rep,
                       frames=args.frames,
                       fps=round((args.frames - 1) / wall, 2),
                       ate_rmse=round(rmse, 4),
                       accepted=float(aux["accepted"].float().mean()))
            results.append(row)
            print(json.dumps(row))
            if rep == 0:
                write_tum(os.path.join(
                    args.out, f"synthetic_{seq}_Trajectory.txt"),
                    world.timestamps, est)
    return results


def run_dataset(args):
    """EuRoC, KITTI or Gazebo batches (Run_EuRoC.py / Run_KITTI.py roles).
    KITTI sequences pick their per-sequence calibration inside load_kitti
    (io/datasets.py KITTI_CALIB — 3 distinct camera setups over 00-10)."""
    from gfplslam_torch.apps.run_slam import main as run_one
    results = []
    root = args.euroc_root or args.kitti_root or args.gazebo_root
    flag = ("--euroc" if args.euroc_root
            else "--gazebo" if args.gazebo_root else "--kitti")
    for seq in args.sequences:
        seq_dir = os.path.join(root, seq)
        for rep in range(args.repeats):
            out = os.path.join(args.out, f"{seq}_r{rep}")
            summary = run_one([flag, seq_dir, "-o", out, "--device", args.device]
                              + (["--frames", str(args.frames)]
                                 if args.frames else []))
            summary.update(sequence=seq, repeat=rep)
            results.append(summary)
            print(json.dumps(summary))
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--euroc-root")
    ap.add_argument("--kitti-root",
                    help="KITTI odometry root; sequences are ids 00..10 "
                         "(Run_KITTI.py:8-52 covers 00-10 x 3 calibrations)")
    ap.add_argument("--gazebo-root",
                    help="Gazebo simulation root (Run_Gazebo.py role): each "
                         "sequence dir holds cam0/data + cam1/data with the "
                         "gazebo_params.yaml ideal-pinhole rig")
    ap.add_argument("--sequences", nargs="*", default=2)
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("-o", "--out", default="gfpl_batch")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    ap.add_argument("--multihost", action="store_true",
                    help="join the default process group from the torchrun "
                         "(or the reference's coordinator) variables first")
    args = ap.parse_args(argv)
    if args.multihost:
        from gfplslam_torch.parallel.multihost import ensure_multihost
        ensure_multihost(device=args.device)
    os.makedirs(args.out, exist_ok=True)
    if args.synthetic:
        if isinstance(args.sequences, list):
            args.sequences = int(args.sequences[0]) if args.sequences else 2
        results = run_synthetic(args)
    else:
        if not (args.euroc_root or args.kitti_root or args.gazebo_root):
            ap.error("need --synthetic, --euroc-root, --kitti-root, "
                     "or --gazebo-root")
        results = run_dataset(args)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
