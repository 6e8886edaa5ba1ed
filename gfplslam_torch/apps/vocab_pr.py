"""Retrieval precision/recall for the place-recognition vocabulary.

Port of ``gfplslam_tpu/apps/vocab_pr.py``: a multi-lap textured circuit
world (every lap re-passes the same places) is scored frame against frame
through the real scoring path (``insert_kf_bow``'s conf matrix: tf-idf +
L1 + the count/dispersion-weighted dual combination), ground-truth revisit
labels come from GT poses, and the score threshold is swept into a PR
curve. Runs on the CUDA card unless ``--device`` names another.

Usage:
  python -m gfplslam_torch.apps.vocab_pr --frames 241 --laps 3 \
      -o VOCAB_PR_torch.json [--compare 256]
Writes per-vocabulary PR curves + average precision to the JSON.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def build_score_matrix(vocab_k: int, frames, cfg_base, device="cuda"):
    """Run every frame through insert_kf_bow at the given vocabulary size;
    return the [N, N] conf-score matrix (upper triangle meaningful)."""
    from dataclasses import replace

    import torch
    from gfplslam_torch.models import loop as loop_ops

    device = torch.device(device)
    n = len(frames)
    cfg = replace(cfg_base, cap=replace(cfg_base.cap, vocab_k=vocab_k,
                                        n_kf_max=n))
    ls = loop_ops.empty_loop_state(cfg, device)
    for i, f in enumerate(frames):
        ls = loop_ops.insert_kf_bow(
            cfg, ls, torch.tensor(i, dtype=torch.int32, device=device), f)
    return ls.conf.cpu().numpy()


def revisit_labels(poses: np.ndarray, min_sep: int = 30,
                   pos_dist: float = 0.6, pos_deg: float = 12.0,
                   neg_dist: float = 1.5):
    """GT labels per (i, j<i-min_sep) pair: 1 = same place (revisit),
    0 = different place; pairs in the distance margin between pos and neg
    are excluded (ambiguous)."""
    n = len(poses)
    t = poses[:, :3, 3]
    labels = {}
    for i in range(n):
        for j in range(0, i - min_sep):
            d = np.linalg.norm(t[i] - t[j])
            r = poses[i][:3, :3].T @ poses[j][:3, :3]
            ang = np.degrees(np.arccos(np.clip((np.trace(r) - 1) / 2, -1, 1)))
            if d < pos_dist and ang < pos_deg:
                labels[(i, j)] = 1
            elif d > neg_dist:
                labels[(i, j)] = 0
    return labels


def pr_curve(scores: np.ndarray, labels: dict):
    """Precision/recall over the score threshold sweep + average precision."""
    pairs = sorted(labels.items(), key=lambda kv: -scores[kv[0][0], kv[0][1]])
    n_pos = sum(v for _, v in pairs)
    if n_pos == 0:
        return [], [], 0.0
    prec, rec, tp = [], [], 0
    ap = 0.0
    prev_r = 0.0
    for rank, ((i, j), y) in enumerate(pairs, 1):
        tp += y
        p = tp / rank
        r = tp / n_pos
        prec.append(p)
        rec.append(r)
        ap += p * (r - prev_r)
        prev_r = r
    return prec, rec, ap


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=241)
    ap.add_argument("--laps", type=int, default=3)
    ap.add_argument("--stride", type=int, default=1)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--words", type=int, default=4096)
    ap.add_argument("--compare", type=int, nargs="*", default=[256])
    ap.add_argument("-o", "--out", default="VOCAB_PR_torch.json")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
    args = ap.parse_args(argv)

    import torch
    from gfplslam_torch.config import CameraParams, Config
    from gfplslam_torch.io import synthetic
    from gfplslam_torch.models import loop as loop_ops
    from gfplslam_torch.models.frame import process_stereo_pair

    device = torch.device(args.device)
    cam = CameraParams()
    cfg = Config(camera=cam)
    world = synthetic.make_world(
        n_frames=args.frames, n_points=900, n_lines=90, seed=args.seed,
        motion="circuit", cam=cam, textured=True, laps=args.laps)
    idx = list(range(0, args.frames, args.stride))
    print(f"rendering {len(idx)} frames ({args.laps}-lap circuit)...")
    th = torch.tensor(20.0, device=device)
    frames = []
    for i in idx:
        il, ir = synthetic.render_frame(world, i, noise=1.0)
        frames.append(process_stereo_pair(
            torch.as_tensor(np.clip(np.round(il), 0, 255).astype(np.uint8),
                            device=device),
            torch.as_tensor(np.clip(np.round(ir), 0, 255).astype(np.uint8),
                            device=device),
            cfg, th))
    poses = world.poses[idx]
    labels = revisit_labels(poses)
    n_pos = sum(labels.values())
    print(f"{len(labels)} labeled pairs, {n_pos} true revisits")

    out = {"frames": len(idx), "laps": args.laps,
           "n_pairs": len(labels), "n_revisit": n_pos, "curves": {}}
    trained = loop_ops.trained_sizes()
    for k in [args.words] + list(args.compare):
        scores = build_score_matrix(k, frames, cfg, device)
        prec, rec, ap_v = pr_curve(scores, labels)
        name = f"trained_{k}" if k in trained else f"random_{k}"
        # decimate the curve for the JSON (keep every ~1% of recall)
        keep = np.unique(np.linspace(0, len(prec) - 1, 101).astype(int))
        out["curves"][name] = {
            "average_precision": round(float(ap_v), 4),
            "precision": [round(float(prec[i]), 4) for i in keep],
            "recall": [round(float(rec[i]), 4) for i in keep],
            "p_at_r50": round(float(max(
                (p for p, r in zip(prec, rec) if r >= 0.5), default=0.0)), 4),
        }
        print(f"vocab {name}: AP={ap_v:.4f}")
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print("wrote", args.out)
    return out


if __name__ == "__main__":
    main()
