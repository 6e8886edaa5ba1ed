#!/usr/bin/env python3
"""Where one keyframe of the PyTorch port's SLAM back-end spends its time on
a CUDA card.

    python3 profile_torch_slam.py [--keyframes 6] [--out build/profile_torch_slam]

Runs the full-SLAM world of ``chip_smoke.py`` (``bench.py``'s 121-frame
752x480 textured circuit, default Config with ``lc_kf_dist=12,
lc_kf_max_dist=6``, uint8) through ``SLAMSystem.run_sequence`` with loop
closure, recording the inputs of every fifth keyframe's ``mapping_step``.
On the first ``--keyframes`` of them:

1. times each stage of ``mapping_step``, in its order, with a synchronize
   after each (median ms over the keyframes): association and insertion
   (``add_keyframe``), the BA window (``build_local_ba_problem``), the local
   BA (``solve_ba``), its write-back (``apply_ba_result`` and
   ``apply_ba_outliers``), culling, the BoW insertion, the loop candidates
   and the speculative ``verify_loop``;
2. traces one ``mapping_step`` and one ``solve_ba`` with ``torch.profiler``
   and prints their wall time, device ops, device busy time and idle share
   (ops per LM iteration for the BA), and the peak device memory of one
   ``mapping_step``. The step's Chrome trace goes to
   ``<out>/trace.json.gz`` and its table to ``<out>/key_averages.txt``.

Needs a CUDA card; exits 1 without one. Imports no JAX.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def record_keyframes(cfg, imgs_l, imgs_r, timestamps, dev, every: int, count: int):
    """Run the sequence with loop closure; return up to ``count`` recorded
    ``(map, loop_state, frame, t_rel)`` inputs of every ``every``-th
    keyframe's ``mapping_step``."""
    from gfplslam_torch.models import mapping
    from gfplslam_torch.models.slam import SLAMSystem

    step = mapping.mapping_step
    recorded, seen = [], [0]

    def recording_step(cfg_, m, ls, frame, t_rel, **kw):
        seen[0] += 1
        if seen[0] % every == 0 and len(recorded) < count:
            recorded.append((m, ls, frame, t_rel))
        return step(cfg_, m, ls, frame, t_rel, **kw)

    mapping.mapping_step = recording_step
    try:
        slam = SLAMSystem(cfg, device=dev)
        slam.run_sequence(imgs_l, imgs_r, timestamps, chunk=24)
        slam.finish()
    finally:
        mapping.mapping_step = step
    return recorded


def stage_ms(cfg, m, ls, frame, t_rel) -> dict:
    """One keyframe's ``mapping_step`` (loop closure on, no KF culling),
    stage by stage in its order, each ended by a synchronize: name -> ms."""
    import torch
    from gfplslam_torch.models import ba, loop, map as map_ops

    out = {}

    def timed(name, fn, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn(*args, **kw)
        torch.cuda.synchronize()
        out[name] = 1e3 * (time.perf_counter() - t0)
        return result

    s = cfg.slam
    m, _ = timed("association + insertion", map_ops.add_keyframe, cfg, m, frame, t_rel)
    prob, w_ids, p_ids, l_ids, po_src, lo_src = timed(
        "BA window", map_ops.build_local_ba_problem, cfg, m)
    res = timed("local BA", ba.solve_ba, cfg.camera, prob, lambda0=s.lambda_lba_lm,
                lambda_k=s.lambda_lba_k, max_iters=s.max_iters_lba)
    m = timed("BA write-back", lambda: map_ops.apply_ba_outliers(
        cfg, map_ops.apply_ba_result(cfg, m, res, w_ids, p_ids, l_ids), res,
        po_src, lo_src))
    m = timed("culling", map_ops.remove_bad_landmarks, cfg, m)
    kf_idx = m.n_kf - 1
    ls = timed("BoW insertion", loop.insert_kf_bow, cfg, ls, kf_idx, frame)
    cand = timed("loop candidates", loop.look_for_loop_candidates, cfg, ls,
                 m.full_graph, kf_idx)
    timed("loop verification", loop.verify_loop, cfg, ls, torch.clamp(cand, min=0),
          kf_idx)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--keyframes", type=int, default=6)
    ap.add_argument("--out", default=str(HERE / "build" / "profile_torch_slam"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_slam: needs a CUDA card", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(HERE))
    from torch.profiler import ProfilerActivity, profile

    from gfplslam_torch.config import CameraParams, Config, SlamParams
    from gfplslam_torch.io import synthetic
    from gfplslam_torch.models import ba, map as map_ops, mapping
    from gfplslam_torch.ops.hamming import hamming_cuda
    from gfplslam_torch.utils.kernel_bench import u8
    from profile_torch_vo import device_summary, save_trace

    dev = torch.device("cuda", 0)
    cfg = Config(camera=CameraParams(), slam=SlamParams(lc_kf_dist=12, lc_kf_max_dist=6))
    n = 121
    world = synthetic.make_world(n_frames=n, n_points=900, n_lines=90, seed=11,
                                 motion="circuit", cam=cfg.camera, textured=True)
    frames = [synthetic.render_frame(world, i, noise=1.0) for i in range(n)]
    imgs_l = u8(np.stack([f[0] for f in frames]))
    imgs_r = u8(np.stack([f[1] for f in frames]))
    recorded = record_keyframes(cfg, imgs_l, imgs_r, world.timestamps, dev,
                                every=5, count=args.keyframes)
    print(f"[record] {len(recorded)} keyframes' mapping_step inputs, keyframe "
          f"indices {[int(r[0].n_kf) for r in recorded]}")

    # 1. stage times, synchronized (the first keyframe twice: a warm-up)
    stage_ms(cfg, *recorded[0])
    times = [stage_ms(cfg, *r) for r in recorded]
    total = [sum(t.values()) for t in times]
    print(f"[stages] mapping_step, median over {len(times)} keyframes: total "
          f"{statistics.median(total):.3f} ms")
    for name in times[0]:
        med = statistics.median(t[name] for t in times)
        print(f"[stages] {name}: {med:.3f} ms "
              f"({100 * med / statistics.median(total):.1f}%)")

    # 2. one mapping_step and one local BA, traced
    m, ls, frame, t_rel = recorded[-1]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    hamming_cuda.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mapping.mapping_step(cfg, m, ls, frame, t_rel)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    n_ops, busy, span = device_summary(prof)
    print(f"[trace] mapping_step: wall {1e3 * wall:.3f} ms; {n_ops} device ops; "
          f"device busy {busy / 1e3:.3f} ms of a {span / 1e3:.3f} ms device span; "
          f"idle share {1 - busy / max(span, 1e-9):.3f}; Hamming launches "
          f"{hamming_cuda.launches}; peak device memory above the inputs "
          f"{peak / 2**20:.1f} MiB")
    m2, _ = map_ops.add_keyframe(cfg, m, frame, t_rel)
    prob = map_ops.build_local_ba_problem(cfg, m2)[0]
    s = cfg.slam
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_ba:
        t0 = time.perf_counter()
        res = ba.solve_ba(cfg.camera, prob, lambda0=s.lambda_lba_lm,
                          lambda_k=s.lambda_lba_k, max_iters=s.max_iters_lba)
        torch.cuda.synchronize()
        wall_ba = time.perf_counter() - t0
    n_ba, busy_ba, span_ba = device_summary(prof_ba)
    print(f"[trace] local BA ({s.max_iters_lba} LM iterations run, {int(res.iters)} "
          f"until convergence; window {prob.kf_pose.shape[0]} KFs, "
          f"{prob.pt_pos.shape[0]} points, {prob.ln_sp.shape[0]} lines, "
          f"{prob.po_kf.shape[0]} + {prob.lo_kf.shape[0]} observations): wall "
          f"{1e3 * wall_ba:.3f} ms; {n_ba} device ops = "
          f"{n_ba / s.max_iters_lba:.0f} per iteration; device busy "
          f"{busy_ba / 1e3:.3f} ms; idle share {1 - busy_ba / max(span_ba, 1e-9):.3f}")
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=25)
    print(table)
    save_trace(prof, Path(args.out), table)


if __name__ == "__main__":
    main()
