"""Distributed-BA scaling benchmark over a process group.

Port of ``gfplslam_tpu/apps/bench_dist_ba.py``: the landmark-sharded Schur
solver (``parallel/dist_ba.py``) at 1, 2, 4, ... ranks on a synthetic BA
problem (BASELINE config 5: keyframe/map-block partitioned distributed
BA), reporting ms per LM iteration and scaling efficiency. The reference
runs one controller over a device mesh; here ``--ranks N`` processes are
started on this machine (``parallel/multihost.py::launch``) and the sub-
groups of the first 1, 2, 4, ... ranks solve in turn. On the CPU (the
default there: 8 gloo ranks of one thread each) this is the reference's
virtual-mesh protocol; on CUDA one rank per card by default. Ranks that
share a card (more ranks than cards) run over gloo: a correctness run, not
a scaling measurement.

Usage: python -m gfplslam_torch.apps.bench_dist_ba --kfs 16 --points 4096
       python -m gfplslam_torch.apps.bench_dist_ba --device cpu --ranks 8
"""

from __future__ import annotations

import argparse
import json
import statistics

import numpy as np
import torch


def make_problem(n_kf: int, n_pt: int, n_ln: int, cam, seed: int = 0,
                 device: torch.device | str = "cpu"):
    """Keyframes on a line observing every landmark, observations with
    0.5 px noise; the reference's arrays exactly for the same seed."""
    from gfplslam_torch.models.ba import BAProblem

    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-4, 4, n_pt), rng.uniform(-2, 2, n_pt),
                    rng.uniform(3, 14, n_pt)], 1).astype(np.float32)
    lsp = np.stack([rng.uniform(-4, 4, n_ln), rng.uniform(-2, 2, n_ln),
                    rng.uniform(3, 14, n_ln)], 1).astype(np.float32)
    lep = lsp + rng.normal(0, 0.6, (n_ln, 3)).astype(np.float32)
    lep[:, 2] = np.abs(lep[:, 2]) + 3
    poses = np.tile(np.eye(4, dtype=np.float32)[None], (n_kf, 1, 1))
    for i in range(n_kf):
        poses[i][0, 3] = 0.08 * i
        poses[i][2, 3] = 0.02 * i

    def proj(t_wc, x):
        t_cw = np.linalg.inv(t_wc)
        pc = (t_cw[:3, :3] @ x.T).T + t_cw[:3, 3]
        return np.stack([cam.fx * pc[:, 0] / pc[:, 2] + cam.cx,
                         cam.fy * pc[:, 1] / pc[:, 2] + cam.cy], 1)

    po_kf = np.repeat(np.arange(n_kf), n_pt).astype(np.int32)
    po_lm = np.tile(np.arange(n_pt), n_kf).astype(np.int32)
    po_uv = np.concatenate([proj(poses[k], pts) for k in range(n_kf)]
                           ).astype(np.float32)
    po_uv += rng.normal(0, 0.5, po_uv.shape).astype(np.float32)
    lo_kf = np.repeat(np.arange(n_kf), n_ln).astype(np.int32)
    lo_lm = np.tile(np.arange(n_ln), n_kf).astype(np.int32)
    lo_le = []
    for k in range(n_kf):
        s2 = proj(poses[k], lsp)
        e2 = proj(poses[k], lep)
        le = np.cross(np.concatenate([s2, np.ones((n_ln, 1))], 1),
                      np.concatenate([e2, np.ones((n_ln, 1))], 1))
        le /= np.linalg.norm(le[:, :2], axis=1, keepdims=True)
        lo_le.append(le.astype(np.float32))
    lo_le = np.concatenate(lo_le)

    def t(x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=device)

    return BAProblem(
        kf_pose=t(poses),
        kf_free=t([False] + [True] * (n_kf - 1)),
        kf_valid=t(np.ones(n_kf, bool)),
        pt_pos=t(pts), pt_valid=t(np.ones(n_pt, bool)),
        ln_sp=t(lsp), ln_ep=t(lep), ln_valid=t(np.ones(n_ln, bool)),
        po_kf=t(po_kf), po_lm=t(po_lm), po_uv=t(po_uv),
        po_sigma2=t(np.ones(len(po_kf)), torch.float32),
        po_valid=t(np.ones(len(po_kf), bool)),
        lo_kf=t(lo_kf), lo_lm=t(lo_lm), lo_le=t(lo_le),
        lo_sigma2=t(np.ones(len(lo_kf)), torch.float32),
        lo_valid=t(np.ones(len(lo_kf), bool)))


def bench_rank(problems, kfs, iters, reps, seed, device):
    """One rank's part: for each problem, each sub-group of the first
    1, 2, 4, ... ranks solves it ``reps`` times after one warm-up.
    Returns {(points, lines): {ranks: median ms per LM iteration}} (rank
    0's clock; the solve ends in an ``all_gather``, so it waits for the
    group's last rank)."""
    import torch.distributed as dist

    from gfplslam_torch.config import CameraParams
    from gfplslam_torch.parallel import dist_ba, workers

    cam = CameraParams()
    world, rank = dist.get_world_size(), dist.get_rank()
    sizes = [d for d in (1, 2, 4, 8, 16) if d <= world]
    all_runs = {}
    for n_pt, n_ln in problems:
        prob = make_problem(kfs, n_pt, n_ln, cam, seed=seed)
        results = {}
        for nd in sizes:
            group = dist_ba.make_mesh(nd)
            if rank < nd:
                sharded = dist_ba.shard_problem_by_landmark(prob, nd)
                _, ms = workers.sharded_ba(cam, sharded, device, iters,
                                           reps=reps, group=group)
                results[nd] = statistics.median(ms)
                if rank == 0:
                    print(f"[{n_pt}pt/{n_ln}ln] {nd} rank(s): "
                          f"{results[nd]:.2f} ms/iter (median of {reps})",
                          flush=True)
            dist.barrier()
        all_runs[(n_pt, n_ln)] = results
    return all_runs


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--kfs", type=int, default=16)
    ap.add_argument("--points", type=int, default=4096)
    ap.add_argument("--lines", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sweep", action="store_true",
                    help="also measure at 0.5x and 2x landmark counts "
                         "(scaling claims need more than one problem size)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the ranks run (default: cuda)")
    ap.add_argument("--ranks", type=int, default=0,
                    help="ranks to start (default: 8 on the CPU, one per "
                         "card on CUDA)")
    args = ap.parse_args(argv)

    from gfplslam_torch.parallel import multihost

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is visible; pass --device cpu")
    n_ranks = args.ranks or (8 if args.device == "cpu"
                             else torch.cuda.device_count())
    # landmark counts divisible by every group size (shard_problem pads
    # otherwise, which would bias the comparison)
    mults = [1.0] if not args.sweep else [0.5, 1.0, 2.0]
    problems = [(int(args.points * m) // 16 * 16,
                 int(args.lines * m) // 16 * 16) for m in mults]
    all_runs = multihost.launch(bench_rank, n_ranks, problems, args.kfs,
                                args.iters, args.reps, args.seed, args.device,
                                device=args.device)[0]

    # headline = the primary (1.0x) problem
    results = all_runs[problems[len(problems) // 2 if args.sweep else 0]]
    base = results[1]
    out = {
        "metric": "dist_ba_ms_per_iter",
        "problem": dict(kfs=args.kfs, points=args.points, lines=args.lines,
                        obs=int(args.kfs * (args.points + args.lines))),
        "reps": args.reps, "seed": args.seed, "aggregation": "median",
        "device": args.device, "ranks": n_ranks,
        "backend": multihost.backend_for(args.device, n_ranks),
        "ms_per_iter": {str(k): round(v, 3) for k, v in results.items()},
        "scaling_efficiency": {
            str(k): round(base / (v * k), 3) for k, v in results.items()},
    }
    if args.sweep:
        out["sweep"] = [
            {"points": p, "lines": l,
             "ms_per_iter": {str(k): round(v, 3) for k, v in r.items()},
             "scaling_efficiency": {
                 str(k): round(r[1] / (v * k), 3) for k, v in r.items()}}
            for (p, l), r in all_runs.items()]
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
