"""Batch evaluation runner: N sequences x R repeats -> ATE table.

Port of ``gfplslam_tpu/apps/batch_eval.py`` (batch_script/Run_EuRoC.py:8-49,
Run_KITTI.py:8-52: per-sequence repeated ``plslam_mod`` invocations
collecting trajectory files). Sequences run in-process: synthetic ones
through ``run_vo_scan`` (each run queued whole on the device, one read at
the end), dataset ones through ``apps/run_slam.py``. Runs on the CUDA card
unless ``--device`` names another.

``--slam`` runs synthetic jobs as full-SLAM sessions through
``parallel/batch.py::run_slam_batch`` (the reference's batch scripts run
full SLAM; ``run_vo_scan`` is the default, as the reference's app has it).
``--ranks N`` runs the jobs (sequences x repeats) as N ranks sharing the
device, this process rank 0 and N - 1 spawned peers, each rank a
contiguous block of jobs (``parallel/batch.py::block``; the jobs must split
evenly).

Usage:
  python -m gfplslam_torch.apps.batch_eval --synthetic --sequences 4 \
      --frames 20 --repeats 2 -o out/batch
  python -m gfplslam_torch.apps.batch_eval --euroc-root DIR/euroc \
      --sequences MH_01_easy MH_02_easy -o out/batch
  python -m gfplslam_torch.apps.batch_eval --kitti-root DIR/sequences \
      --sequences 00 03 05 -o out/batch
  python -m gfplslam_torch.apps.batch_eval --synthetic --slam --sequences 2 \
      --repeats 2 --ranks 4 -o out/batch
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np


def _synthetic_config():
    from gfplslam_torch.config import (CameraParams, CapacityParams, Config,
                                       OrbParams)
    cam = CameraParams(width=376, height=240, fx=217.6, fy=217.6,
                       cx=183.7, cy=126.1, baseline=0.11)
    return Config(camera=cam, cap=CapacityParams(n_pt=512, n_ln=256),
                  orb=OrbParams(nlevels=2))


def _synthetic_world(args, cfg, seq: int):
    """Sequence ``seq``'s world and its (left, right) uint8 frames."""
    from gfplslam_torch.io import synthetic
    world = synthetic.make_world(n_frames=args.frames, seed=100 + seq,
                                 cam=cfg.camera)
    frames = [synthetic.render_frame(world, i) for i in range(args.frames)]
    return world, np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames])


def _jobs(args, sequences) -> list:
    return [(seq, rep) for seq in sequences for rep in range(args.repeats)]


def _over_ranks(args, worker, wargs: tuple, run0):
    """``run0(group)`` as rank 0 of ``args.ranks`` ranks sharing the device,
    the others spawned to run ``worker(*wargs)`` once (``run0(None)``
    alone for one rank). Returns (rank 0's result, the others' results)."""
    if args.ranks == 1:
        return run0(None), []
    import torch.distributed as dist
    from gfplslam_torch.parallel import multihost
    peers = multihost.spawn_peers(worker, args.ranks, *wargs, device=args.device)
    with peers.round():
        out = run0(dist.group.WORLD)
    return out, peers.close()


def synthetic_vo_jobs(args, jobs: list, ranked: bool) -> list:
    """``run_vo_scan`` on each synthetic job ``(sequence, repeat)`` in turn:
    on this rank's block of them when ``ranked`` (a member of the default
    group), all of them otherwise. One row per job."""
    import torch
    import torch.distributed as dist
    from gfplslam_torch.models.vo import run_vo_scan
    from gfplslam_torch.parallel.batch import block
    from gfplslam_torch.utils.trajectory import ate_rmse, write_tum

    device = torch.device(args.device)
    cfg = _synthetic_config()
    lo, hi = block(len(jobs), dist.group.WORLD if ranked else None)
    worlds = {}
    results = []
    for seq, rep in jobs[lo:hi]:
        if seq not in worlds:
            world, left, right = _synthetic_world(args, cfg, seq)
            worlds[seq] = (world, torch.as_tensor(left, device=device),
                           torch.as_tensor(right, device=device),
                           torch.as_tensor(world.timestamps.astype(np.float32),
                                           device=device))
        world, imgs_l, imgs_r, ts = worlds[seq]
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


def synthetic_slam(args, jobs: list) -> list:
    """``--slam``: every synthetic job a full-SLAM session, the batch
    through ``run_slam_batch`` over the ranks; one row per job."""
    import torch
    from gfplslam_torch.parallel import workers
    from gfplslam_torch.parallel.batch import run_slam_batch
    from gfplslam_torch.utils.trajectory import ate_rmse, write_tum

    cfg = _synthetic_config()
    worlds = {seq: _synthetic_world(args, cfg, seq) for seq in sorted({s for s, _ in jobs})}
    imgs_l = np.stack([worlds[seq][1] for seq, _ in jobs])
    imgs_r = np.stack([worlds[seq][2] for seq, _ in jobs])
    ts = np.stack([worlds[seq][0].timestamps for seq, _ in jobs])
    t0 = time.perf_counter()
    out, _ = _over_ranks(
        args, workers.slam_batch, (cfg, imgs_l, imgs_r, ts, args.device),
        lambda group: run_slam_batch(cfg, imgs_l, imgs_r, ts, group,
                                     device=torch.device(args.device)))
    wall = time.perf_counter() - t0
    results = []
    for j, (seq, rep) in enumerate(jobs):
        world = worlds[seq][0]
        est = out.frame_poses[j].numpy()
        row = dict(sequence=f"synthetic_{seq}", repeat=rep, rank=j * args.ranks // len(jobs),
                   frames=args.frames, keyframes=int(out.n_kf[j]),
                   loop_closures=int(out.n_loop_closures[j]), lost=bool(out.lost[j]),
                   ate_rmse=round(float(ate_rmse(est, world.poses)), 4),
                   accepted=float(out.accepted[j].float().mean()),
                   batch_fps=round(len(jobs) * args.frames / wall, 2))
        results.append(row)
        print(json.dumps(row))
        if rep == 0:
            write_tum(os.path.join(args.out, f"synthetic_{seq}_Trajectory.txt"),
                      world.timestamps, est)
    return results


def dataset_jobs(args, jobs: list, ranked: bool) -> list:
    """``run_slam`` on each dataset job ``(sequence, repeat)`` in turn (the
    Run_EuRoC.py / Run_KITTI.py roles): on this rank's block of them when
    ``ranked`` (a member of the default group), all of them otherwise.
    KITTI sequences pick their per-sequence calibration inside load_kitti
    (io/datasets.py KITTI_CALIB — 3 distinct camera setups over 00-10).
    Returns the run summaries."""
    import torch.distributed as dist
    from gfplslam_torch.apps.run_slam import main as run_one
    from gfplslam_torch.parallel.batch import block
    lo, hi = block(len(jobs), dist.group.WORLD if ranked else None)
    root = args.euroc_root or args.kitti_root or args.gazebo_root
    flag = ("--euroc" if args.euroc_root
            else "--gazebo" if args.gazebo_root else "--kitti")
    results = []
    for seq, rep in jobs[lo:hi]:
        out = os.path.join(args.out, f"{seq}_r{rep}")
        summary = run_one([flag, os.path.join(root, seq), "-o", out,
                           "--device", args.device]
                          + (["--frames", str(args.frames)] if args.frames else []))
        summary.update(sequence=seq, repeat=rep)
        results.append(summary)
        print(json.dumps(summary))
    return results


def each_rank(args, worker, jobs: list) -> list:
    """``worker(args, jobs, ranked)`` on every rank, each on its block of
    the jobs; every rank's rows, in job order."""
    mine, theirs = _over_ranks(args, worker, (args, jobs, True),
                               lambda group: worker(args, jobs, group is not None))
    return mine + [row for rows in theirs for row in rows]


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
    ap.add_argument("--slam", action="store_true",
                    help="synthetic jobs as full-SLAM sessions through "
                         "run_slam_batch (default: VO through run_vo_scan)")
    ap.add_argument("--ranks", type=int, default=1,
                    help="run the jobs as this many ranks sharing the device: "
                         "this process and spawned peers (default: 1)")
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
        jobs = _jobs(args, range(args.sequences))
        results = (synthetic_slam(args, jobs) if args.slam
                   else each_rank(args, synthetic_vo_jobs, jobs))
    else:
        if not (args.euroc_root or args.kitti_root or args.gazebo_root):
            ap.error("need --synthetic, --euroc-root, --kitti-root, "
                     "or --gazebo-root")
        results = each_rank(args, dataset_jobs, _jobs(args, args.sequences))
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(results, f, indent=1)
    return results


if __name__ == "__main__":
    main()
