"""Monte-Carlo point-vs-line loss landscape on synthetic geometry.

Port of ``gfplslam_tpu/apps/simulate_pl_loss.py`` (the reference's
src/simulate_pl_loss.cpp:9-390 and simu/simu_point_line_loss.py): random
3D points and lines with a known relative pose; a perturbation swept along
each twist axis (the reference's ii=-20..20 grid around the true pose,
:156-178) gives the mean point-to-point and point-to-line loss curves, so
the shape and conditioning of the two residual families can be compared.
Each round's 6 x (2*grid+1) perturbed poses are one batched evaluation
here; the curves are the reference's.

``run(argv)`` computes and returns (summary, curves); ``main`` also writes
``pl_loss_landscape.png`` and ``summary.json`` under ``-o``. Runs on the
CUDA card unless ``--device`` names another.

Usage: python -m gfplslam_torch.apps.simulate_pl_loss -n 100 -o out/pl_loss
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def _parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", "--rounds", type=int, default=100)
    ap.add_argument("-o", "--out", default="gfpl_pl_loss")
    ap.add_argument("--points", type=int, default=32)
    ap.add_argument("--lines", type=int, default=16)
    ap.add_argument("--grid", type=int, default=20,
                    help="perturbation grid half-width (reference uses 20)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    return ap.parse_args(argv)


def run(argv=None):
    """The Monte-Carlo rounds: (summary, {"ticks", "p2p", "p2l"})."""
    args = _parse(argv)

    import torch
    from gfplslam_torch.config import CameraParams
    from gfplslam_torch.models import pose_opt
    from gfplslam_torch.utils import se3

    dev = torch.device(args.device)

    def t(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    # camera matching simulate_pl_loss.cpp:19-42 (640x480, f=525, b=0.12)
    cam = CameraParams(width=640, height=480, fx=525.0, fy=525.0,
                       cx=319.5, cy=239.5, baseline=0.12)
    rng = np.random.default_rng(11)
    n_pt, n_ln = args.points, args.lines
    # twist-axis perturbation grid: +-0.1 m / +-0.1 rad over 2*grid+1 steps
    ticks = np.linspace(-0.1, 0.1, 2 * args.grid + 1).astype(np.float32)
    # every (axis, tick) perturbation twist, axis-major: [6 * len(ticks), 6]
    deltas = np.zeros((6, len(ticks), 6), np.float32)
    for ax in range(6):
        deltas[ax, :, ax] = ticks
    exp_deltas = se3.expmap_se3(t(deltas.reshape(-1, 6)))

    def proj_np(p):
        return np.stack([cam.fx * p[:, 0] / p[:, 2] + cam.cx,
                         cam.fy * p[:, 1] / p[:, 2] + cam.cy], 1)

    def losses(dt, pts, lns):
        _, rp, _ = pose_opt._point_terms(cam, dt, pts, 1e-7)
        _, rl, _ = pose_opt._line_terms(cam, dt, lns, 1e-7)
        return torch.stack([torch.where(pts.valid, rp * rp, 0.0).mean(),
                            torch.where(lns.valid, rl * rl, 0.0).mean()])

    batched = torch.func.vmap(losses, in_dims=(0, None, None))
    curves = np.zeros((6, len(ticks), 2))
    for _ in range(args.rounds):
        p3d = np.stack([rng.uniform(-2, 2, n_pt), rng.uniform(-1.5, 1.5, n_pt),
                        rng.uniform(2, 8, n_pt)], 1).astype(np.float32)
        sp = np.stack([rng.uniform(-2, 2, n_ln), rng.uniform(-1.5, 1.5, n_ln),
                       rng.uniform(2, 8, n_ln)], 1).astype(np.float32)
        ep = sp + rng.normal(0, 1.0, (n_ln, 3)).astype(np.float32)
        ep[:, 2] = np.abs(ep[:, 2]) + 2
        # ground-truth relative pose: small random motion
        tw = np.concatenate([rng.normal(0, 0.05, 3),
                             rng.normal(0, 0.02, 3)]).astype(np.float32)
        t_gt_dev = se3.expmap_se3(t(tw))
        t_gt = t_gt_dev.cpu().numpy()
        pc = (t_gt[:3, :3] @ p3d.T).T + t_gt[:3, 3]
        obs = proj_np(pc).astype(np.float32)
        spc = (t_gt[:3, :3] @ sp.T).T + t_gt[:3, 3]
        epc = (t_gt[:3, :3] @ ep.T).T + t_gt[:3, 3]
        s2, e2 = proj_np(spc), proj_np(epc)
        le = np.cross(np.concatenate([s2, np.ones((n_ln, 1))], 1),
                      np.concatenate([e2, np.ones((n_ln, 1))], 1))
        le /= np.linalg.norm(le[:, :2], axis=1, keepdims=True)

        pts = pose_opt.PointMatches(p3d=t(p3d), obs=t(obs), sigma2=t(np.ones(n_pt)),
                                    valid=torch.ones(n_pt, dtype=torch.bool, device=dev))
        lns = pose_opt.LineMatches(sp3d=t(sp), ep3d=t(ep), le_obs=t(le.astype(np.float32)),
                                   sigma2=t(np.ones(n_ln)),
                                   valid=torch.ones(n_ln, dtype=torch.bool, device=dev))
        # one device->host read per round
        curves += batched(t_gt_dev @ exp_deltas, pts, lns).cpu().numpy(
            ).astype(np.float64).reshape(curves.shape)

    curves /= args.rounds
    curves_p2p, curves_p2l = curves[..., 0], curves[..., 1]
    # sanity metrics: both losses minimized at the true pose (tick 0), and
    # curvature (conditioning) of the line loss along each axis
    mid = len(ticks) // 2
    min_at_zero_p = int(np.sum(np.argmin(curves_p2p, axis=1) == mid))
    min_at_zero_l = int(np.sum(np.argmin(curves_p2l, axis=1) == mid))
    curv_ratio = float(np.mean(
        (curves_p2l[:, mid + 2] - curves_p2l[:, mid])
        / np.maximum(curves_p2p[:, mid + 2] - curves_p2p[:, mid], 1e-9)))
    summary = dict(rounds=args.rounds, axes_min_at_true_pose_p2p=min_at_zero_p,
                   axes_min_at_true_pose_p2l=min_at_zero_l,
                   line_vs_point_curvature_ratio=curv_ratio)
    return summary, dict(out=args.out, ticks=ticks, p2p=curves_p2p, p2l=curves_p2l)


def plot(data) -> None:
    """``pl_loss_landscape.png``: both mean loss curves per twist axis."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    names = ["tx", "ty", "tz", "wx", "wy", "wz"]
    fig, axes = plt.subplots(2, 3, figsize=(13, 7))
    for ax_i, name in enumerate(names):
        a = axes[ax_i // 3][ax_i % 3]
        a.plot(data["ticks"], data["p2p"][ax_i], label="point p2p")
        a.plot(data["ticks"], data["p2l"][ax_i], label="line p2l")
        a.set_title(f"mean loss vs {name} perturbation")
        a.set_yscale("log")
        if ax_i == 0:
            a.legend()
    fig.tight_layout()
    fig.savefig(os.path.join(data["out"], "pl_loss_landscape.png"), dpi=110)
    plt.close(fig)


def main(argv=None):
    summary, data = run(argv)
    os.makedirs(data["out"], exist_ok=True)
    plot(data)
    with open(os.path.join(data["out"], "summary.json"), "w") as f:
        json.dump(summary, f)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
