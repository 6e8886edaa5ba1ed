#!/usr/bin/env python3
"""Drive the PyTorch port's stereo VO and SLAM paths once on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (sm_90a),
PyTorch built for CUDA and the CUDA toolkit (``nvcc``); it needs no JAX and
no network. Phases, each reported on its own lines:

1. device: CUDA must be available (otherwise exit 1 with no result); prints
   the card's name and ``nvidia-smi`` name and power limit;
2. build: compiles the kernels under ``gfplslam_torch/csrc`` into
   ``build/gfplslam_torch/`` (one ``nvcc`` per source, in parallel) and
   prints the seconds it took and each kernel's ``ptxas`` report;
3. kernels: the FAST-9 and Hamming kernels against their plain PyTorch
   versions on the card, bit-exact (``torch.equal``) at the main-path inputs
   (the VO's shapes, and the six shapes one SLAM keyframe gives the Hamming
   kernel, with the masks its callers pass) and at the edge cases a redesign
   can break; then, at the main-path shapes, each kernel's device time
   (launches captured in a CUDA graph over buffers that exceed the L2 cache,
   replayed between two events) per VO frame and, for Hamming, per
   keyframe, its wrapper's host time per call, the plain version's device
   time, and the bound (the larger of bytes over the HBM rate and
   operations over the issue rate), all by
   ``gfplslam_torch/utils/kernel_bench.py``;
4. small VO: the 376x240 world of ``tests/test_vo_e2e.py`` through
   ``VisualOdometry`` (gates: not lost, accepted > 0.6, ATE < 0.06 m);
5. full-width VO: the 752x480 EuRoC operating point with the default Config
   through ``run_vo_scan`` (one warm-up, median of 3 timed runs; gates: not
   lost, accepted > 0.6, ATE < 5% of the path), with both kernels' launch
   counts of the first timed run checked against the design (2 FAST launches
   per frame, 2 Hamming calls on the first frame and 4 on every tracked
   frame); the record's launches per frame come from those counts;
6. small SLAM: the 376x240 world and Config of ``tests/test_slam_e2e.py``
   (10 frames, seed 11) through the per-frame ``SLAMSystem.process`` (gates:
   not lost, >= 2 keyframes, keyframe ATE < 0.08 m);
7. full SLAM: ``bench.py``'s full-SLAM run (EuRoC 752x480, default Config
   with ``lc_kf_dist=12, lc_kf_max_dist=6``, the 121-frame textured circuit,
   uint8, ``run_sequence(chunk=24)`` then ``finish()``), once with loop
   closure and once without: frames/s (host clock around work that ends in
   ``torch.cuda.synchronize()``), keyframes, closures, fused landmarks, ATE,
   and both kernels' launches against the count the keyframes and closures
   imply; then, on six keyframes' recorded inputs, the median time of one
   ``mapping_step`` and of its local BA (ms per LM iteration, iterations
   until convergence). Gates: not lost, >= 1 closure, ATE with loop closure
   below ATE without, launch counts as designed. The record's ``launches``
   are this phase's loop-closure run.

Any failure raises, so the script exits non-zero before the last line. The
line before the last holds the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
# 7.3 and 19.9 are not bf16 values: the threshold's own rounding counts
THRESHOLDS = (7.3, 10.0, 19.9, 20.0, 35.0)


def _fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def phase_device():
    import torch
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false; this script runs only on a "
              "CUDA card")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name} count {torch.cuda.device_count()}")
    print(f"[device] nvidia-smi: {smi}")
    return torch.device("cuda", 0), name


def phase_build():
    from gfplslam_torch.ops import kernels
    t0 = time.perf_counter()
    kernels.load()
    secs = time.perf_counter() - t0
    nvcc = (f"{kernels.build_seconds:.2f} s" if kernels.build_seconds is not None
            else "cached")
    print(f"[build] {len(kernels.KERNELS)} libraries under "
          f"{kernels.BUILD_ROOT.relative_to(HERE)} ready in {secs:.2f} s "
          f"(nvcc {nvcc})")
    for source, report in kernels.ptxas_report().items():
        for line in report.splitlines():
            if "Used" in line or "stack frame" in line:
                print(f"[build] {source}: {line.strip()}")


def _check_fast(label, imgs, need_corner):
    """Kernel == plain at every threshold; returns the max abs difference."""
    import torch
    from gfplslam_torch.ops.fast import fast_score_cuda, fast_score_map_torch
    err = 0.0
    for th in THRESHOLDS:
        out = fast_score_cuda(imgs, th)
        ref = fast_score_map_torch(imgs, th)
        torch.cuda.synchronize()
        err = max(err, float((out - ref).abs().max()))
        if not torch.equal(out, ref):
            _fail(f"FAST kernel != plain at {label} t={th}: "
                  f"{int((out != ref).sum())} pixels differ, max {err}")
        if need_corner and float(ref.max()) <= 0:
            _fail(f"FAST plain version found no corner at {label} t={th}")
    print(f"[kernels] FAST {label}: exact at t={THRESHOLDS}")
    return err


def _check_hamming(label, a, b, va, vb, expect=None):
    """Kernel == plain (and == ``expect`` where given); returns max abs diff."""
    import torch
    from gfplslam_torch.ops.hamming import hamming_cuda, hamming_matrix_torch
    out = hamming_cuda(a, b, va, vb)
    ref = hamming_matrix_torch(a, b, va, vb)
    torch.cuda.synchronize()
    err = int((out - ref).abs().max()) if out.numel() else 0
    if not torch.equal(out, ref):
        _fail(f"Hamming kernel != plain at {label}: "
              f"{int((out != ref).sum())} entries differ")
    if expect is not None and not bool((ref == expect).all()):
        _fail(f"Hamming plain version != {expect} at {label}")
    print(f"[kernels] Hamming {label}: exact")
    return err


def phase_kernels(dev):
    """Kernel vs plain version on the card, exact, then times and bounds at
    the main-path shapes. Returns the kernels' JSON records (launches are
    filled in by the full-width phase)."""
    import torch
    from gfplslam_torch.ops import kernels
    from gfplslam_torch.ops.fast import fast_score_cuda, fast_score_map_torch
    from gfplslam_torch.ops.hamming import hamming_cuda, hamming_matrix_torch
    from gfplslam_torch.utils import kernel_bench as kb

    rng = np.random.default_rng(2024)
    main_fast = kb.fast_main_inputs(dev)
    fast_err = 0.0
    for label, imgs in main_fast.items():
        fast_err = max(fast_err, _check_fast(f"EuRoC pyramid {label}", imgs, True))
    fast_cases = {
        "uniform uint8 [2,480,752]": rng.integers(0, 256, (2, 480, 752)),
        "uniform uint8 [6,400,627]": rng.integers(0, 256, (6, 400, 627)),
        "uniform float [1,7,7]": rng.uniform(0, 255, (1, 7, 7)),
        "uniform float [3,37,53]": rng.uniform(0, 255, (3, 37, 53)),
        "uniform float [2,481,753]": rng.uniform(0, 255, (2, 481, 753)),
    }
    for label, arr in fast_cases.items():
        imgs = torch.as_tensor(np.asarray(arr, np.float32), device=dev)
        fast_err = max(fast_err, _check_fast(label, imgs, min(arr.shape[1:]) > 32))
    # a contiguous view 4 bytes into its storage: rows of 752 px would take
    # the 16-byte loads if only the width were checked
    flat = torch.as_tensor(rng.uniform(0, 255, 2 * 480 * 752 + 1).astype(np.float32),
                           device=dev)
    fast_err = max(fast_err, _check_fast("offset view [2,480,752]",
                                         flat[1:].view(2, 480, 752), True))

    def desc(n):
        return torch.as_tensor(rng.integers(-2**31, 2**31, (n, 8)),
                               dtype=torch.int32, device=dev)

    def mask(n):
        return torch.as_tensor(rng.random(n) < 0.8, device=dev)

    ham_err = 0
    for n in kb.HAMMING_SHAPES:
        ham_err = max(ham_err, _check_hamming(f"{n}x{n} masks both",
                                              desc(n), desc(n), mask(n), mask(n)))
    # every pair of edge sizes, the four maskings spread as a Latin square
    sides = ("both", "a only", "b only", "none")
    sizes = (1, 7, 1023, 1025)
    for i, n in enumerate(sizes):
        for j, m in enumerate(sizes):
            side = sides[(i + j) % 4]
            va = mask(n) if side in ("both", "a only") else None
            vb = mask(m) if side in ("both", "b only") else None
            ham_err = max(ham_err, _check_hamming(f"{n}x{m} masks {side}",
                                                  desc(n), desc(m), va, vb))
    zeros = torch.zeros(7, 8, dtype=torch.int32, device=dev)
    ones = torch.full((1025, 8), -1, dtype=torch.int32, device=dev)
    ham_err = max(ham_err, _check_hamming("7x1025 all-zero vs all-ones",
                                          zeros, ones, None, None, expect=256))
    # the SLAM back-end's shapes, one keyframe's worth, masked as called
    main_kf = kb.hamming_keyframe_inputs(dev, rng)
    for label, args in main_kf.items():
        a, b, _, vb = args
        ham_err = max(ham_err, _check_hamming(
            f"{label} {a.shape[0]}x{b.shape[0]} masks {'both' if vb is not None else 'rows'}",
            *args))

    # device times at the shapes one full-width frame gives each kernel
    lib = kernels.load()
    thr = torch.tensor([kb.MAIN_THRESHOLD], device=dev)
    fast_ms = kb.fast_device_ms(lib, main_fast, thr)
    fast_host = statistics.median(kb.host_ms(lambda: fast_score_cuda(x, thr))
                                  for x in main_fast.values())
    plain_fast_ms = sum(kb.graph_ms([lambda: fast_score_map_torch(x, thr)] * 10)
                        for x in main_fast.values())
    fast_bound_ms, fast_by = kb.fast_bound(main_fast)
    main_ham = kb.hamming_main_inputs(dev, rng)
    ham_ms = kb.hamming_device_ms(lib, main_ham)
    ham_host = statistics.median(kb.host_ms(lambda: hamming_cuda(*args))
                                 for args in main_ham.values())
    plain_ham_ms = 2 * sum(kb.graph_ms([lambda: hamming_matrix_torch(*args)] * 10)
                           for args in main_ham.values())
    ham_bound_ms, ham_by = kb.hamming_bound(main_ham)
    kf_ms = kb.hamming_launches_ms(lib, main_kf)
    kf_bound_ms = kb.hamming_bytes_ms(main_kf)
    kf_plain_ms = sum(kb.graph_ms([lambda: hamming_matrix_torch(*args)] * 3)
                      for args in main_kf.values())
    print(f"[kernels] Hamming per SLAM keyframe (6 launches: "
          f"{', '.join(f'{a.shape[0]}x{b.shape[0]}' for a, b, _, _ in main_kf.values())}): "
          f"device {1e3 * kf_ms:.3f} us, bytes bound {1e3 * kf_bound_ms:.3f} us, "
          f"share of bound {kf_bound_ms / kf_ms:.3f}; plain {kf_plain_ms:.5f} ms")
    for name, dev_ms, bound_ms, by, plain_ms, host in (
            ("FAST", fast_ms, fast_bound_ms, fast_by, plain_fast_ms, fast_host),
            ("Hamming", ham_ms, ham_bound_ms, ham_by, plain_ham_ms, ham_host)):
        print(f"[kernels] {name} per full-width frame: device {dev_ms:.5f} ms, "
              f"bound {bound_ms:.5f} ms ({by}), share of bound "
              f"{bound_ms / dev_ms:.3f}; plain {plain_ms:.5f} ms; wrapper host "
              f"{host:.5f} ms per call")
    return [
        {"name": "fast9_score", "route": "cuda",
         "source": "gfplslam_torch/csrc/fast_score.cu",
         "replaces": "gfplslam_tpu/ops/pallas/fast_pl.py:41",
         "max_abs_err": fast_err, "ms": fast_ms, "host_ms": fast_host,
         "plain_ms": plain_fast_ms, "bound_ms": fast_bound_ms,
         "bound_by": fast_by, "library_ms": None},
        {"name": "hamming_matrix", "route": "cuda",
         "source": "gfplslam_torch/csrc/hamming.cu",
         "replaces": "gfplslam_tpu/ops/pallas/hamming_pl.py:28",
         "max_abs_err": float(ham_err), "ms": ham_ms, "host_ms": ham_host,
         "plain_ms": plain_ham_ms, "bound_ms": ham_bound_ms,
         "bound_by": ham_by, "library_ms": None, "ms_per_keyframe": kf_ms,
         "plain_ms_per_keyframe": kf_plain_ms,
         "bound_ms_per_keyframe": kf_bound_ms},
    ]


def _lost(accepted: np.ndarray, max_loss: int) -> bool:
    """Track lost: more than ``max_loss`` consecutive rejected frames."""
    run = 0
    for ok in accepted:
        run = 0 if ok else run + 1
        if run > max_loss:
            return True
    return False


def phase_small_vo(dev):
    from gfplslam_torch.config import (CameraParams, CapacityParams, Config,
                                       OrbParams)
    from gfplslam_torch.io import synthetic
    from gfplslam_torch.models.vo import VisualOdometry
    from gfplslam_torch.utils.trajectory import ate_rmse

    cfg = Config(
        cap=CapacityParams(n_pt=256, n_ln=128, n_pt_match=128, n_ln_match=64),
        orb=OrbParams(nlevels=2),
        camera=CameraParams(width=376, height=240, fx=217.6, fy=217.6,
                            cx=183.7, cy=126.1, baseline=0.11))
    world = synthetic.make_world(n_frames=8, n_points=300, n_lines=40, seed=4)
    vo = VisualOdometry(cfg, device=dev)
    for i in range(len(world.poses)):
        img_l, img_r = synthetic.render_frame(world, i, noise=1.0)
        vo.process(img_l, img_r, world.timestamps[i])
    acc = float(np.mean([r.accepted for r in vo.records[1:]]))
    ate = ate_rmse(vo.trajectory, world.poses)
    print(f"[small-vo] 376x240 x8: lost {vo.lost}, accepted {acc:.3f}, "
          f"ATE {ate:.5f} m")
    if vo.lost or not acc > 0.6 or not ate < 0.06:
        _fail("small VO gate failed (need not lost, accepted > 0.6, ATE < 0.06)")


def _reset_counts():
    from gfplslam_torch.ops.fast import fast_score_cuda
    from gfplslam_torch.ops.hamming import hamming_cuda
    fast_score_cuda.launches = 0
    hamming_cuda.launches = 0


def _counts() -> dict:
    from gfplslam_torch.ops.fast import fast_score_cuda
    from gfplslam_torch.ops.hamming import hamming_cuda
    return {"fast9_score": fast_score_cuda.launches,
            "hamming_matrix": hamming_cuda.launches}


def phase_full_vo(dev, records):
    import torch
    from gfplslam_torch.config import CameraParams, Config
    from gfplslam_torch.io import synthetic
    from gfplslam_torch.models.vo import run_vo_scan
    from gfplslam_torch.utils.kernel_bench import u8
    from gfplslam_torch.utils.trajectory import ate_rmse

    cfg = Config(camera=CameraParams())
    n = 48
    world = synthetic.make_world(n_frames=n, n_points=900, n_lines=90, seed=3,
                                 cam=cfg.camera)
    frames = [synthetic.render_frame(world, i, noise=1.5) for i in range(n)]

    imgs_l = torch.as_tensor(u8(np.stack([f[0] for f in frames])), device=dev)
    imgs_r = torch.as_tensor(u8(np.stack([f[1] for f in frames])), device=dev)
    ts = torch.as_tensor(world.timestamps.astype(np.float32), device=dev)

    t0 = time.perf_counter()
    run_vo_scan(cfg, imgs_l, imgs_r, ts, device=dev)
    torch.cuda.synchronize()
    print(f"[full-vo] warm-up run {time.perf_counter() - t0:.2f} s")

    samples = []
    for rep in range(3):
        if rep == 0:
            _reset_counts()
        t0 = time.perf_counter()
        poses, aux = run_vo_scan(cfg, imgs_l, imgs_r, ts, device=dev)
        torch.cuda.synchronize()
        samples.append(time.perf_counter() - t0)
        if rep == 0:
            launches = _counts()
    expected = {"fast9_score": 2 * n, "hamming_matrix": 4 * n - 2}
    print(f"[full-vo] launches in one run: {launches} (expected {expected})")
    if launches != expected:
        _fail(f"kernel launch counts {launches} != expected {expected}")
    # per frame, from this run's counts: FAST on every frame; Hamming on
    # every tracked frame, after the first frame's two stereo calls
    per_frame = {"fast9_score": launches["fast9_score"] / n,
                 "hamming_matrix": (launches["hamming_matrix"] - 2) / (n - 1)}
    for r in records:
        r["launches_by_path"] = {"full_vo": launches[r["name"]]}
        r["launches_per_frame"] = per_frame[r["name"]]

    elapsed = statistics.median(samples)
    fps = (n - 1) / elapsed
    print(f"[full-vo] 752x480 x{n}, default Config: runs "
          f"{[round(s, 4) for s in samples]} s; median {elapsed:.4f} s = "
          f"{fps:.3f} frames/s = {1000.0 / fps:.3f} ms/frame")

    poses = poses.cpu().numpy().astype(np.float64)
    if poses.shape != (n, 4, 4) or not np.isfinite(poses).all():
        _fail(f"poses not finite of shape ({n}, 4, 4): {poses.shape}")
    accepted = aux["accepted"].cpu().numpy()
    acc = float(accepted.mean())
    lost = _lost(accepted, cfg.slam.max_num_frame_loss)
    ate = ate_rmse(poses, world.poses)
    path = float(np.linalg.norm(np.diff(world.poses[:, :3, 3], axis=0),
                                axis=1).sum())
    print(f"[full-vo] lost {lost}, accepted {acc:.3f}, keyframes "
          f"{int(aux['is_kf'].sum())}, ATE {ate:.5f} m of path {path:.4f} m "
          f"({100 * ate / path:.3f}%)")
    if lost or not acc > 0.6 or not ate < 0.05 * path:
        _fail("full-width VO gate failed (need not lost, accepted > 0.6, "
              "ATE < 5% of path)")


def phase_small_slam(dev, records):
    from gfplslam_torch.config import (CameraParams, CapacityParams, Config,
                                       OrbParams)
    from gfplslam_torch.io import synthetic
    from gfplslam_torch.models.slam import SLAMSystem
    from gfplslam_torch.utils.trajectory import ate_rmse

    cfg = Config(
        cap=CapacityParams(n_pt=256, n_ln=128, n_kf_window=4, n_kf_max=32,
                           n_map_pt=2048, n_map_ln=512, n_obs_pt=1024,
                           n_obs_ln=256, vocab_k=128),
        orb=OrbParams(nlevels=2),
        camera=CameraParams(width=376, height=240, fx=217.6, fy=217.6,
                            cx=183.7, cy=126.1, baseline=0.11))
    world = synthetic.make_world(n_frames=10, n_points=300, n_lines=40, seed=11)
    frames = [synthetic.render_frame(world, i, noise=1.0) for i in range(10)]
    slam = SLAMSystem(cfg, device=dev)
    _reset_counts()
    for i, (img_l, img_r) in enumerate(frames):
        slam.process(img_l, img_r, world.timestamps[i])
    slam.finish()
    launches = _counts()
    n_kf = int(slam.map.n_kf)
    kf_ate = ate_rmse(slam.keyframe_trajectory, world.poses[slam.kf_frame_ids])
    vo_ate = ate_rmse(slam.vo.trajectory, world.poses)
    print(f"[small-slam] 376x240 x10: lost {slam.vo.lost}, keyframes {n_kf}, "
          f"keyframe ATE {kf_ate:.5f} m, VO ATE {vo_ate:.5f} m, landmarks "
          f"{int(slam.map.pt_valid.sum())}, launches {launches}")
    for r in records:
        r["launches_by_path"]["small_slam"] = launches[r["name"]]
    if slam.vo.lost or n_kf < 2 or not kf_ate < 0.08 or min(launches.values()) < 1:
        _fail("small SLAM gate failed (need not lost, >= 2 keyframes, keyframe "
              "ATE < 0.08 m, both kernels launched)")


def _time_recorded_keyframes(cfg, calls, mapping_step):
    """Median ms of one mapping_step and of its local BA on recorded
    keyframe inputs, and the BA's iterations until convergence."""
    import torch
    from gfplslam_torch.models import ba, map as map_ops

    step_ms, ba_ms, iters = [], [], []
    for m, ls, frame, t_rel, kw in calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mapping_step(cfg, m, ls, frame, t_rel, **kw)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        m2, _ = map_ops.add_keyframe(cfg, m, frame, t_rel)
        prob = map_ops.build_local_ba_problem(cfg, m2)[0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = ba.solve_ba(cfg.camera, prob, lambda0=cfg.slam.lambda_lba_lm,
                          lambda_k=cfg.slam.lambda_lba_k,
                          max_iters=cfg.slam.max_iters_lba)
        torch.cuda.synchronize()
        ba_ms.append(1e3 * (time.perf_counter() - t0))
        iters.append(int(res.iters))
    return step_ms, ba_ms, iters


def phase_full_slam(dev, records):
    import torch
    from gfplslam_torch.config import CameraParams, Config, SlamParams
    from gfplslam_torch.io import synthetic
    from gfplslam_torch.models import mapping
    from gfplslam_torch.models.slam import SLAMSystem
    from gfplslam_torch.utils.kernel_bench import u8
    from gfplslam_torch.utils.trajectory import ate_rmse

    cfg = Config(camera=CameraParams(),
                 slam=SlamParams(lc_kf_dist=12, lc_kf_max_dist=6))
    n, chunk = 121, 24
    world = synthetic.make_world(n_frames=n, n_points=900, n_lines=90, seed=11,
                                 motion="circuit", cam=cfg.camera, textured=True)
    frames = [synthetic.render_frame(world, i, noise=1.0) for i in range(n)]
    imgs_l = u8(np.stack([f[0] for f in frames]))
    imgs_r = u8(np.stack([f[1] for f in frames]))

    # record six keyframes' mapping inputs (references only: no host read)
    step = mapping.mapping_step
    recorded, seen = [], [0]

    def recording_step(cfg_, m, ls, frame, t_rel, **kw):
        seen[0] += 1
        if seen[0] % 5 == 0 and len(recorded) < 6:
            recorded.append((m, ls, frame, t_rel, kw))
        return step(cfg_, m, ls, frame, t_rel, **kw)

    out = {}
    for lc in (True, False):
        slam = SLAMSystem(cfg, device=dev, run_loop_closure=lc)
        mapping.mapping_step = recording_step if lc else step
        try:
            torch.cuda.synchronize()
            _reset_counts()
            t0 = time.perf_counter()
            slam.run_sequence(imgs_l, imgs_r, world.timestamps, chunk=chunk)
            slam.finish()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = _counts()
        finally:
            mapping.mapping_step = step
        n_kf = int(slam.map.n_kf)
        ate = ate_rmse(slam.all_frame_trajectory, world.poses)
        closures = slam.n_loop_closures
        expected = {"fast9_score": 2 * n,
                    "hamming_matrix": (2 + 4 * (n - 1) + 2 + (6 if lc else 4) * (n_kf - 1)
                                       + 2 * closures)}
        tag = "lc" if lc else "no-lc"
        print(f"[full-slam] {tag}: 752x480 x{n}, chunk {chunk}: {secs:.3f} s = "
              f"{n / secs:.3f} frames/s; lost {slam.vo.lost}, keyframes {n_kf}, "
              f"loop closures {closures}, fused landmarks {slam.n_fused_landmarks}, "
              f"ATE {ate:.5f} m; counters {slam.counters}")
        print(f"[full-slam] {tag}: launches {launches} (expected {expected}: "
              f"FAST 2 per frame; Hamming 2 + 4 per tracked frame, 2 at KF0, "
              f"{6 if lc else 4} per later keyframe, 2 per closure)")
        if slam.vo.lost or launches != expected:
            _fail(f"full SLAM ({tag}) lost or launch counts {launches} != {expected}")
        out[lc] = dict(ate=ate, closures=closures, launches=launches)
    for r in records:
        r["launches"] = out[True]["launches"][r["name"]]
        r["launches_by_path"]["full_slam_lc"] = out[True]["launches"][r["name"]]
        r["launches_by_path"]["full_slam_no_lc"] = out[False]["launches"][r["name"]]

    step_ms, ba_ms, iters = _time_recorded_keyframes(cfg, recorded, step)
    per_iter = statistics.median(ba_ms) / cfg.slam.max_iters_lba
    print(f"[full-slam] mapping_step on {len(recorded)} recorded keyframes: median "
          f"{statistics.median(step_ms):.3f} ms ({[round(t, 3) for t in step_ms]}); "
          f"local BA median {statistics.median(ba_ms):.3f} ms for "
          f"{cfg.slam.max_iters_lba} LM iterations run = {per_iter:.4f} ms per "
          f"iteration; iterations until convergence {iters}")
    print("[full-slam] accuracy reference only (the JAX package's BENCH_r05 "
          "record, a TPU run): ATE 0.1205 m with loop closure, 0.2299 m "
          "without, 1 closure, 39 keyframes")
    print(f"[full-slam] ATE with loop closure {out[True]['ate']:.5f} m, without "
          f"{out[False]['ate']:.5f} m")
    if out[True]["closures"] < 1 or not out[True]["ate"] < out[False]["ate"]:
        _fail("full SLAM gate failed (need >= 1 loop closure and ATE with loop "
              "closure below ATE without)")


def main() -> None:
    if not (HERE / "gfplslam_torch" / "__init__.py").is_file():
        _fail(f"no gfplslam_torch package beside {Path(__file__).name}; run "
              "it from the root of a checkout")
    sys.path.insert(0, str(HERE))
    dev, name = phase_device()
    import torch
    phase_build()
    records = phase_kernels(dev)
    phase_small_vo(dev)
    phase_full_vo(dev, records)
    phase_small_slam(dev, records)
    phase_full_slam(dev, records)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
