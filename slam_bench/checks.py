"""The numbers that decide ``correct``: what the window's timed path
produced, against the plain reference (``reference.py``), each number held
to its limit in ``limits/<workload>.json``.

- ``frame_ate_m``: the worst sequence's ATE of every frame's pose against
  the world's ground truth. In the SLAM cells every frame's pose is the
  tracker's relative pose re-based onto its keyframe's pose after the local
  BA, the loop-closure decisions and the pose-graph correction.
- ``ba_cost_ratio``: over every local BA of the window's first sequence,
  the sum of the BA objective at each BA's result over its sum at the
  BAs' inputs, both worked out by the reference from the problem each BA
  was given (the problem is the program's state: the
  reference follows it, and the map it was built from is judged through
  the poses). The solver accepts only steps that lower the objective, so a
  BA that moves its window reads below 1 and one that returns its input
  reads 1.
- ``pose_graph_ratio``: over every pose-graph solve of the window's first
  sequence, the sum of the pose graph's objective at the solve's result
  over its sum at the poses the solve was given, both worked out by the
  reference from the solve's edges (the edges are the program's state,
  followed as the BA's problem is). A solve that moves its keyframes
  reads below 1, one that returns its input reads 1.
- ``loops_missed``: sequences of the window that closed no loop, where the
  world returns to its start (listed only for such traffic).
- ``fast_l0_px``: pixels whose level-0 FAST-9 score, as the kernel wrote
  it, differs from the reference's on the benchmark's own frame (both
  cameras, the frames drawn from the seed, the threshold the program
  passed). Exact: the scores are sums of integers in bf16.
- ``hamming_entries``: entries of the drawn Hamming launches that differ
  from the reference's distances of the descriptors the launch was given
  (the descriptors are the program's: the reference judges the kernel, and
  the stage before it is judged through the poses).

A number whose sample is empty reads ``inf``: nothing drawn, nothing shown.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_bench import reference


def frame_ate_m(run) -> float:
    return max(reference.ate_m(s.frame_poses, run.world.poses) for s in run.seqs)


def ba_cost_ratio(run) -> float:
    if not run.ba.kept:
        return float("inf")
    cam = run.cell.config["camera"]
    before = sum(reference.ba_cost(cam, prob, prob) for _, (prob, _) in run.ba.kept)
    after = sum(reference.ba_cost(cam, prob, res) for _, (prob, res) in run.ba.kept)
    return after / before if before > 0 else float("inf")


def pose_graph_ratio(run) -> float:
    if not run.pgo.kept:
        return float("inf")
    before = sum(reference.pose_graph_cost(x, edges) for _, (x, edges, _) in run.pgo.kept)
    after = sum(reference.pose_graph_cost(y, edges) for _, (_, edges, y) in run.pgo.kept)
    return after / before if before > 0 else float("inf")


def loops_missed(run) -> float:
    return float(sum(1 for s in run.seqs if not s.closures))


def fast_l0_px(run) -> float:
    if not run.kernels.fast_kept:
        return float("inf")
    bad = 0
    for j, th, out in run.kernels.fast_kept:
        frames = torch.as_tensor(np.stack([run.world.left[j], run.world.right[j]]),
                                 device=out.device)
        ref = reference.fast9_scores(frames, float(th.reshape(-1)[0]))
        bad += int((out.reshape(ref.shape) != ref).sum())
    return float(bad)


def hamming_entries(run) -> float:
    if not run.kernels.ham_kept:
        return float("inf")
    bad = 0
    for _, problems in run.kernels.ham_kept:
        for a, b, va, vb, out in problems:
            bad += int((out != reference.hamming(a, b, va, vb)).sum())
    return float(bad)


NUMBERS = {f.__name__: f for f in (frame_ate_m, ba_cost_ratio, pose_graph_ratio,
                                   loops_missed, fast_l0_px, hamming_entries)}


def drawn(run) -> str:
    """What the sample held, for the log."""
    return (f"FAST level-0 frames {sorted(j for j, _, _ in run.kernels.fast_kept)}, "
            f"Hamming launches {sorted(i for i, _ in run.kernels.ham_kept)} "
            f"({sum(len(p) for _, p in run.kernels.ham_kept)} matrices, "
            f"{sum(int(o.numel()) for _, p in run.kernels.ham_kept for *_, o in p)} entries), "
            f"local BAs {sorted(i for i, _ in run.ba.kept)}, "
            f"pose-graph solves {len(run.pgo.kept)}")


def readings(run) -> list[str]:
    """Log lines, read whether or not a limit holds them: each sequence's
    ATE, its keyframes' ATE (not compared: a tracker that stops moving
    leaves one keyframe, whose ATE is 0) and its closures, and each local
    BA's and pose-graph solve's objective before and after."""
    lines = []
    for i, s in enumerate(run.seqs):
        kf = ("" if s.kf_poses is None else
              f", keyframe ATE {reference.ate_m(s.kf_poses, run.world.poses[s.kf_frames]):.6f} m"
              f" ({len(s.kf_poses)} keyframes), closures {s.closures}")
        lines.append(f"sequence {i}: ATE "
                     f"{reference.ate_m(s.frame_poses, run.world.poses):.6f} m{kf}")
    cam = run.cell.config["camera"]
    for i, (prob, res) in run.ba.kept:
        lines.append(f"local BA {i}: objective {reference.ba_cost(cam, prob, prob):.6f} "
                     f"-> {reference.ba_cost(cam, prob, res):.6f}")
    for i, (x, edges, y) in run.pgo.kept:
        lines.append(f"pose graph {i}: objective {reference.pose_graph_cost(x, edges):.6g} "
                     f"-> {reference.pose_graph_cost(y, edges):.6g}")
    return lines


def compare(run, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    got = {}
    for name, limit in limits.items():
        value = NUMBERS[name](run)
        got[name] = {"value": value, "limit": limit}
    ok = all(np.isfinite(v["value"]) and v["value"] <= v["limit"] for v in got.values())
    return ok, got
