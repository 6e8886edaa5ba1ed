"""Detection/matching smoke tool on an image folder or synthetic frames.

Port of ``gfplslam_tpu/apps/match_demo.py`` (src/test_line_matching.cpp:
7-64: line detection + matching over a monocular image folder). Headless:
consecutive frames are matched (points + lines, mutual best Hamming
distance) and annotated side-by-side canvases are written as PNGs with
matplotlib, beside a ``summary.json``. Runs on the CUDA card unless
``--device`` names another.

Usage:
  python -m gfplslam_torch.apps.match_demo --synthetic -n 4 -o out/demo
  python -m gfplslam_torch.apps.match_demo --dir DIR/imgs -o out/demo
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def _load_dir(path: str, n: int):
    from gfplslam_torch.io.native_loader import decode_image as imread_gray
    names = sorted(os.listdir(path))
    names = [f for f in names
             if f.lower().endswith((".png", ".jpg", ".jpeg", ".pgm"))]
    if n:
        names = names[:n]
    return [imread_gray(os.path.join(path, f)) for f in names]


def detect(img: np.ndarray, cfg, fast_th, device):
    """One camera's features (``detect_camera_features`` on a batch of one)."""
    import torch
    from gfplslam_torch.models import frame as frame_mod
    from gfplslam_torch.ops.pyramid import build_pyramid_padded
    imgs = torch.as_tensor(np.asarray(img, np.float32), device=device)[None]
    pyr = build_pyramid_padded(imgs, cfg.orb.nlevels, cfg.orb.scale_factor)
    return frame_mod.take(
        frame_mod.detect_camera_features(imgs, cfg, fast_th, pyr), 0)


def match_pair(fa, fb):
    """Mutual-best point and line matches between two cameras' features."""
    from gfplslam_torch.ops import matching as match_ops
    from gfplslam_torch.ops.hamming import hamming_matrix
    dp = hamming_matrix(fa.pt_desc, fb.pt_desc, fa.pt_valid, fb.pt_valid)
    mp = match_ops.mutual_best(dp.float())
    dl = hamming_matrix(fa.ln_desc, fb.ln_desc, fa.ln_valid, fb.ln_valid)
    ml = match_ops.mutual_best(dl.float())
    return mp, ml


def main(argv=None):
    ap = argparse.ArgumentParser()
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--synthetic", action="store_true")
    src.add_argument("--dir", metavar="DIR")
    ap.add_argument("-n", "--frames", type=int, default=4)
    ap.add_argument("-o", "--out", default="gfpl_match_demo")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    import torch
    from gfplslam_torch.config import (CameraParams, CapacityParams, Config,
                                       OrbParams)
    from gfplslam_torch.io import synthetic

    device = torch.device(args.device)
    if args.synthetic:
        world = synthetic.make_world(n_frames=args.frames, n_points=250,
                                     n_lines=40, seed=9)
        imgs = [synthetic.render_frame(world, i, noise=1.0)[0]
                for i in range(args.frames)]
        cam = world.cam
    else:
        imgs = _load_dir(args.dir, args.frames)
        h, w = imgs[0].shape
        cam = CameraParams(width=w, height=h, fx=0.9 * w, fy=0.9 * w,
                           cx=w / 2.0, cy=h / 2.0, baseline=0.11)

    cfg = Config(cap=CapacityParams(n_pt=512, n_ln=256),
                 orb=OrbParams(nlevels=2), camera=cam)
    fth = torch.tensor(20.0, device=device)
    feats = [detect(im, cfg, fth, device) for im in imgs]

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    stats = []
    for i in range(1, len(imgs)):
        fa, fb = feats[i - 1], feats[i]
        mp, ml = match_pair(fa, fb)

        h, w = imgs[i].shape
        canvas = np.concatenate([imgs[i - 1], imgs[i]], axis=1)
        fig, ax = plt.subplots(figsize=(12, 5))
        ax.imshow(canvas, cmap="gray")
        pv = mp.valid.cpu().numpy()
        pidx = mp.idx.cpu().numpy()
        xa = fa.pt_xy.cpu().numpy()[pv]
        xb = fb.pt_xy.cpu().numpy()[pidx[pv]]
        for a, b in zip(xa[:120], xb[:120]):
            ax.plot([a[0], b[0] + w], [a[1], b[1]], "-", lw=0.5, alpha=0.6)
        lv = ml.valid.cpu().numpy()
        lidx = ml.idx.cpu().numpy()
        sa = fa.ln_sp.cpu().numpy()[lv]
        ea = fa.ln_ep.cpu().numpy()[lv]
        sb = fb.ln_sp.cpu().numpy()[lidx[lv]]
        eb = fb.ln_ep.cpu().numpy()[lidx[lv]]
        for s, e in zip(sa, ea):
            ax.plot([s[0], e[0]], [s[1], e[1]], "r-", lw=1.2)
        for s, e in zip(sb, eb):
            ax.plot([s[0] + w, e[0] + w], [s[1], e[1]], "r-", lw=1.2)
        ax.set_axis_off()
        fig.tight_layout()
        fig.savefig(os.path.join(args.out, f"match_{i:03d}.png"), dpi=110)
        plt.close(fig)
        stats.append(dict(frame=i, pt_matches=int(pv.sum()),
                          ln_matches=int(lv.sum())))

    summary = dict(pairs=len(stats),
                   mean_pt=float(np.mean([s["pt_matches"] for s in stats])),
                   mean_ln=float(np.mean([s["ln_matches"] for s in stats])))
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(dict(summary=summary, frames=stats), f)
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
