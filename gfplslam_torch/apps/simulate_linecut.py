"""Monte-Carlo validation of the line-cut objective on synthetic geometry.

Port of ``gfplslam_tpu/apps/simulate_linecut.py`` (the reference's
src/simulate_line_cut.cpp:11-60 and simu/simu_line_vol_assessment.py):
random lines with known geometry, the cut solver run on each round, and the
log-volume landscape of line 0 over the whole (r0, r1) grid with the other
lines at the solver's cut. Checks the property the reference relies on
(stereoFrameHandler.cpp:1472-75: the pose covariance is convex in the cut
ratio): the greedy solver lands within tolerance of the exhaustive-grid
optimum. The grid is one batched evaluation per round here; the values are
the reference's cell by cell.

``run(argv)`` computes and returns (summary, landscape data); ``main``
also writes ``linecut_landscape.png`` and ``summary.json`` under ``-o``.
Runs on the CUDA card unless ``--device`` names another.

Usage: python -m gfplslam_torch.apps.simulate_linecut -n 200 -o out/linecut
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def _parse(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", "--rounds", type=int, default=200)
    ap.add_argument("-o", "--out", default="gfpl_linecut")
    ap.add_argument("--lines", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    return ap.parse_args(argv)


def run(argv=None):
    """The Monte-Carlo rounds: (summary, {"landscape", "gaps", "rounds"})."""
    args = _parse(argv)

    import torch
    from gfplslam_torch.config import CameraParams
    from gfplslam_torch.models import linecut
    from gfplslam_torch.models.pose_opt import LineMatches, PointMatches

    dev = torch.device(args.device)

    def t(x, dtype=torch.float32):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    # camera matching simulate_line_cut.cpp:14-38 (640x480, f=525, b=0.12)
    cam = CameraParams(width=640, height=480, fx=525.0, fy=525.0,
                       cx=320.0, cy=240.0, baseline=0.12)
    rng = np.random.default_rng(7)
    m = args.lines

    gaps = []
    landscape_sum = None
    grid = np.arange(0.0, 1.0001, 0.05)
    g0, g1 = np.meshgrid(grid, grid, indexing="ij")
    r0g, r1g = t(g0), t(g1)
    outside = g0 + g1 > 1.0
    eye4 = torch.eye(4, device=dev)
    pts = PointMatches(p3d=torch.ones(4, 3, device=dev),
                       obs=torch.zeros(4, 2, device=dev),
                       sigma2=torch.ones(4, device=dev),
                       valid=torch.zeros(4, dtype=torch.bool, device=dev))

    for round_i in range(args.rounds):
        sp = np.stack([rng.uniform(-2, 2, m), rng.uniform(-1.5, 1.5, m),
                       rng.uniform(2, 8, m)], 1).astype(np.float32)
        ep = sp + rng.normal(0, 1.0, (m, 3)).astype(np.float32)
        ep[:, 2] = np.abs(ep[:, 2]) + 2

        def proj(p):
            return np.stack([cam.fx * p[:, 0] / p[:, 2] + cam.cx,
                             cam.fy * p[:, 1] / p[:, 2] + cam.cy], 1)
        s2, e2 = proj(sp), proj(ep)
        le = np.cross(np.concatenate([s2, np.ones((m, 1))], 1),
                      np.concatenate([e2, np.ones((m, 1))], 1))
        le /= np.linalg.norm(le[:, :2], axis=1, keepdims=True)
        lns = LineMatches(sp3d=t(sp), ep3d=t(ep), le_obs=t(le.astype(np.float32)),
                          sigma2=torch.ones(m, device=dev),
                          valid=torch.ones(m, dtype=torch.bool, device=dev))
        scale = rng.uniform(0.1, 2.0, m).astype(np.float32)
        cov_s = t(np.einsum("m,ij->mij", 0.01 * scale, np.eye(3)).astype(np.float32))
        cov_e = t(np.einsum("m,ij->mij", 1.0 * scale, np.eye(3)).astype(np.float32))

        cut = linecut.cut_lines(cam, eye4, lns, cov_s, cov_e, pts, max_steps=20)
        # exhaustive landscape for line 0 (others at the greedy solution)
        rest = cut.info_sum - cut.info[0]
        info = linecut.pose_info_line(cam, eye4, lns.sp3d[0], lns.ep3d[0], cov_s[0],
                                      cov_e[0], lns.le_obs[0], r0g, r1g)
        own = linecut._logdet_pd(rest + cut.info[0])
        # one device->host read per round
        vals = torch.cat([linecut._logdet_pd(rest + info).reshape(-1),
                          own[None]]).cpu().numpy()
        own = float(vals[-1])
        vals = vals[:-1].reshape(g0.shape)
        vals[outside] = np.nan
        gaps.append(np.nanmax(vals) - own)
        rel = np.nan_to_num(vals - np.nanmax(vals))
        landscape_sum = rel if landscape_sum is None else landscape_sum + rel
        if round_i >= 20 and round_i % 50 == 0:
            print(f"round {round_i}: mean optimality gap {np.mean(gaps):.4f}")

    summary = dict(rounds=args.rounds,
                   mean_gap=float(np.mean(gaps)),
                   p95_gap=float(np.percentile(gaps, 95)))
    return summary, dict(out=args.out, rounds=args.rounds, gaps=gaps,
                         landscape=landscape_sum / args.rounds)


def plot(data) -> None:
    """``linecut_landscape.png``: the mean landscape and the gap histogram."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, axes = plt.subplots(1, 2, figsize=(11, 4.5))
    im = axes[0].imshow(data["landscape"], origin="lower",
                        extent=[0, 1, 0, 1], aspect="auto")
    axes[0].set_xlabel("r1")
    axes[0].set_ylabel("r0")
    axes[0].set_title("mean logdet landscape (rel. to max)")
    fig.colorbar(im, ax=axes[0])
    axes[1].hist(data["gaps"], bins=30)
    axes[1].set_xlabel("grid-optimum minus greedy (line 0)")
    axes[1].set_title("optimality gap")
    fig.tight_layout()
    fig.savefig(os.path.join(data["out"], "linecut_landscape.png"), dpi=110)
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
