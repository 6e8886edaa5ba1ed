#!/usr/bin/env python3
"""Where one full-width VO frame of the PyTorch port spends its time on a
CUDA card.

    python3 profile_torch_vo.py [--frames 16] [--out build/profile_torch_vo]

Renders the 752x480 EuRoC-style world of ``chip_smoke.py`` and, with the
default Config:

1. times the front-end (``process_stereo_pair``) and the tracker
   (``track_step``) per frame with a synchronize after each (median ms);
2. traces ``run_vo_scan`` with ``torch.profiler`` and prints the device
   time by kernel, the number of kernel launches per frame, and the share of
   the traced wall time in which the device ran no kernel (idle share), and
   the two hand-written kernels' device time per frame and per launch.
   The Chrome trace goes to ``<out>/trace.json.gz`` and the table to
   ``<out>/key_averages.txt``.

Needs a CUDA card; exits 1 without one. Imports no JAX.
"""

from __future__ import annotations

import argparse
import gzip
import shutil
import statistics
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


def device_summary(prof) -> tuple[int, float, float]:
    """(device ops, busy us, span us) of a ``torch.profiler`` trace: the
    device's kernels, the union of their intervals, and the time from the
    first kernel's start to the last one's end."""
    import torch
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    covered, cur_s, cur_e = 0.0, None, None
    for s, e in busy:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                covered += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        covered += cur_e - cur_s
    span = (busy[-1][1] - busy[0][0]) if busy else 0.0
    return len(kernels), covered, span


def save_trace(prof, out: Path, table: str) -> None:
    """The Chrome trace to ``out/trace.json.gz``, the table to
    ``out/key_averages.txt``."""
    out.mkdir(parents=True, exist_ok=True)
    trace = out / "trace.json"
    prof.export_chrome_trace(str(trace))
    with open(trace, "rb") as src, gzip.open(f"{trace}.gz", "wb") as dst:
        shutil.copyfileobj(src, dst)
    trace.unlink()
    (out / "key_averages.txt").write_text(table)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--out", default=str(HERE / "build" / "profile_torch_vo"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_vo: needs a CUDA card", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(HERE))
    from torch.profiler import ProfilerActivity, profile

    from gfplslam_torch.config import CameraParams, Config
    from gfplslam_torch.io import synthetic
    from gfplslam_torch.models import tracker as trk
    from gfplslam_torch.models.frame import process_stereo_pair
    from gfplslam_torch.models.vo import run_vo_scan

    dev = torch.device("cuda", 0)
    cfg = Config(camera=CameraParams())
    n = args.frames
    world = synthetic.make_world(n_frames=n, n_points=900, n_lines=90, seed=3,
                                 cam=cfg.camera)
    frames = [synthetic.render_frame(world, i, noise=1.5) for i in range(n)]
    u8 = [np.clip(np.round(np.stack([f[k] for f in frames])), 0, 255).astype(np.uint8)
          for k in (0, 1)]
    imgs_l, imgs_r = (torch.as_tensor(a, device=dev) for a in u8)
    ts = torch.as_tensor(world.timestamps.astype(np.float32), device=dev)
    run_vo_scan(cfg, imgs_l, imgs_r, ts, device=dev)        # warm-up
    torch.cuda.synchronize()

    # 1. per-stage wall time, synchronized
    st = trk.initial_state(cfg, dev)
    prev = process_stereo_pair(imgs_l[0], imgs_r[0], cfg, st.fast_th)
    fe_ms, tr_ms = [], []
    for i in range(1, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cur = process_stereo_pair(imgs_l[i], imgs_r[i], cfg, st.fast_th)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = trk.track_step(cfg, st, prev, cur, ts[i] - ts[i - 1])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        fe_ms.append(1e3 * (t1 - t0))
        tr_ms.append(1e3 * (t2 - t1))
        st, prev = out.state, cur
    print(f"[stages] front-end {statistics.median(fe_ms):.3f} ms, tracker "
          f"{statistics.median(tr_ms):.3f} ms (median over {n - 1} frames)")

    # 2. profiler trace of the scan
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_vo_scan(cfg, imgs_l, imgs_r, ts, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n_ops, covered, span = device_summary(prof)
    print(f"[trace] run_vo_scan {n} frames: wall {wall * 1e3:.1f} ms "
          f"({wall * 1e3 / n:.2f} ms/frame); {n_ops} device ops = "
          f"{n_ops / n:.0f} per frame; device busy {covered / 1e3:.1f} ms "
          f"of a {span / 1e3:.1f} ms device span; idle share "
          f"{1 - covered / max(span, 1e-9):.3f}")
    averages = prof.key_averages()
    for kernel in ("fast_score_kernel", "hamming_kernel"):
        hits = [e for e in averages if kernel in e.key]
        us = sum(getattr(e, "device_time_total", 0) or e.cuda_time_total
                 for e in hits)
        count = sum(e.count for e in hits)
        print(f"[trace] {kernel}: {count} launches, device {us / n:.2f} us per "
              f"frame, {us / max(count, 1):.2f} us per launch")
    table = averages.table(sort_by="cuda_time_total", row_limit=25)
    print(table)
    save_trace(prof, Path(args.out), table)


if __name__ == "__main__":
    main()
