#!/usr/bin/env python3
"""Drive the PyTorch port's VO, SLAM, multi-process and analysis paths once
on one CUDA card.

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
   ``gfplslam_torch/utils/kernel_bench.py``; FAST's record keeps these
   EuRoC times under ``euroc`` once phase 10 puts the KITTI frame's there;
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
   below ATE without, launch counts as designed;
8. full-capacity loop: the port's half of the slow tier
   (``tests/test_torch_slam_full_capacity.py``): 752x480, the default
   1024-point / 512-line budgets and the shipped 256-word vocabulary, the
   40-frame textured loop world (seed 21) written as binary PGM under
   ``build/chip_smoke/full_capacity/`` and decoded by the native loader
   (equal to the rendered bytes), per-frame ``SLAMSystem.process`` then
   ``finish()``: frames/s, keyframes, closures, ATE. Gates: not lost, >= 8
   keyframes, ATE < 0.10 m, >= 1 closure, the active vocabulary read from
   ``vocab_synth.npz``, the trajectory within 0.08 m ATE of the reference's
   (``tests/data/ref_full_capacity_loop_traj.npy``), launches as the
   keyframes and closures imply;
9. ba-window: the local-BA problem the reference hands to ``solve_ba`` at
   keyframe 13 of phase 8's world (``tests/data/full_capacity_kf13_window.npz``,
   with the reference's f64 solution of it) solved on the card: the
   reduced camera system at the first LM iteration's lambda, eigenvalues in
   f64, smallest >= -1e-4 x largest; every keyframe position within 1e-2 m
   of the f64 solution and the final error within 5e-3 of it; ms per LM
   iteration (the BA reaches neither kernel: both counts stay 0);
10. KITTI run_slam: acceptance config 3's world (KITTI 00 rig, 1241x376, 61
   frames, forward motion, textured) written as a KITTI sequence of binary
   PGM files under ``build/chip_smoke/kitti/00/`` and run through
   ``apps/run_slam.py --kitti DIR --chunk 20`` (default Config and
   capacities, loop closure and async mapping on). Gates: not lost, >= 2
   keyframes, ATE below 5% of the path, the three output files parse back
   with one row per frame (keyframe rows for the keyframe file), launches
   as the keyframes and closures imply (the record's ``launches``); then
   ``SLAMSystem.save`` / ``load`` into a fresh system with every
   map/loop/tracker field equal; then the FAST kernel exact at every
   threshold on frame 0's pyramid ([2,376,1241] and levels 1-3 batched),
   and its device time, bound, plain time and host time there (the
   record's);
11. timed VO: ``run_slam --synthetic --timing --vo-only --frames 8``
   (``TimedVO``) against ``VisualOdometry`` on the same frames: equal
   trajectories, every ``time_*`` field > 0 on every tracked frame; then
   ``run_slam --kitti DIR --timing --vo-only -n 20`` on phase 10's
   sequence: the median ms of each stage at KITTI width;
12. vocab: the Hamming kernel exact at ``train_vocab``'s [8192, 4096] and
   [1000, 4096], its device time per assignment block, and ``kmajority``
   (20,000 descriptors, k = 4096, 5 iterations) on the card equal to the CPU;
13. rectify: a two-frame EuRoC tree of raw PGM frames through ``load_euroc``
   and the native C++ loader, and ``rectify_pair`` on the card, each within
   1e-3 of ``rectify_pair`` on the CPU;
14. dist-ba: acceptance config 5's problem (16 keyframes, 8064 points,
   1008 lines) solved densely and by ``solve_ba_sharded`` over one NCCL
   rank and over four gloo ranks sharing the card (ranks started by
   ``parallel/multihost.py::launch``): poses within 5e-3 of the dense
   solve, the same result on every rank, ms per LM iteration of each (a
   correctness run: one card shows no scaling); then
   ``SLAMSystem.finish(run_global_ba=True)`` over four ranks on
   tests/test_dist.py's 80-keyframe map against the dense finish;
15. batch-vo: ``run_vo_batch`` on 4 EuRoC worlds (752x480, default Config,
   24 frames each) with no group and over four gloo ranks: per sequence the
   integer outputs equal, poses within 0.08 m of each other, ATE < 5% of
   the path, launches as the frames imply;
16. analysis-apps: ``assess``, ``ab_orb_pattern``, ``simulate_linecut`` and
   ``simulate_pl_loss`` through their ``run`` at the reference's defaults,
   against the JAX package's numbers where it has them, with the kernels'
   launches of the first two.

Any failure raises, so the script exits non-zero before the last line and
names the failing phase on stderr. The line before the last holds the
kernels' JSON record; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from functools import partial
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
KITTI_DIR = HERE / "build" / "chip_smoke" / "kitti" / "00"
# 7.3 and 19.9 are not bf16 values: the threshold's own rounding counts
THRESHOLDS = (7.3, 10.0, 19.9, 20.0, 35.0)
# the JAX package's analysis apps at their defaults, on a CPU
# (python -m gfplslam_tpu.apps.simulate_linecut / simulate_pl_loss)
REF_LINECUT = {"mean_gap": 0.09549892693758011, "p95_gap": 0.5074923038482666}
REF_PL_CURVATURE = 0.8244671302638089


def _fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def _render_all(worlds, n: int, noise: float) -> list:
    """Frames 0..n-1 of each synthetic world, rendered on the host's cores in
    one process pool (each frame's noise is seeded by its index, so the
    frames equal a loop's). One list of frames per world."""
    from gfplslam_torch.io import synthetic
    workers = min(8, os.cpu_count() or 1, n * len(worlds))
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        frames = list(ex.map(partial(synthetic.render_frame, noise=noise),
                             [w for w in worlds for _ in range(n)],
                             [i for _ in worlds for i in range(n)]))
    return [frames[k * n:(k + 1) * n] for k in range(len(worlds))]


def _render(world, n: int, noise: float) -> list:
    return _render_all([world], n, noise)[0]


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
    fast = _fast_times(main_fast)
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
    library = _hamming_library(lib, main_ham, main_kf)
    _print_times("FAST per EuRoC frame", fast)
    _print_times("Hamming per full-width frame", dict(
        ms=ham_ms, bound_ms=ham_bound_ms, bound_by=ham_by, plain_ms=plain_ham_ms,
        host_ms=ham_host))
    return [
        # the EuRoC frame's times until the KITTI phase puts its own here
        dict({"name": "fast9_score", "route": "cuda",
              "source": "gfplslam_torch/csrc/fast_score.cu",
              "replaces": "gfplslam_tpu/ops/pallas/fast_pl.py:41",
              "max_abs_err": fast_err, "library_ms": None}, **fast),
        {"name": "hamming_matrix", "route": "cuda",
         "source": "gfplslam_torch/csrc/hamming.cu",
         "replaces": "gfplslam_tpu/ops/pallas/hamming_pl.py:28",
         # capacity-bound: a frame's shapes are the same at every width
         "frame_shapes": [f"{n}x{n}" for n in kb.HAMMING_SHAPES] * 2,
         "max_abs_err": float(ham_err), "ms": ham_ms, "host_ms": ham_host,
         "plain_ms": plain_ham_ms, "bound_ms": ham_bound_ms,
         "bound_by": ham_by, "library_ms": library["frame_ms"],
         "library_call": library["call"], "ms_per_keyframe": kf_ms,
         "plain_ms_per_keyframe": kf_plain_ms,
         "bound_ms_per_keyframe": kf_bound_ms,
         "library_ms_per_keyframe": library["keyframe_ms"],
         "library_ms_by_shape": library["by_shape"]},
    ]


def _fast_times(inputs: dict) -> dict:
    """One frame's FAST launches at MAIN_THRESHOLD: device time, bound,
    plain version's device time, wrapper host time per call."""
    import torch
    from gfplslam_torch.ops import kernels
    from gfplslam_torch.ops.fast import fast_score_cuda, fast_score_map_torch
    from gfplslam_torch.utils import kernel_bench as kb
    x0 = next(iter(inputs.values()))
    thr = torch.tensor([kb.MAIN_THRESHOLD], device=x0.device)
    bound_ms, by = kb.fast_bound(inputs)
    return {"frame_shapes": [list(x.shape) for x in inputs.values()],
            "ms": kb.fast_device_ms(kernels.load(), inputs, thr),
            "host_ms": statistics.median(kb.host_ms(lambda: fast_score_cuda(x, thr))
                                         for x in inputs.values()),
            "plain_ms": sum(kb.graph_ms([lambda: fast_score_map_torch(x, thr)] * 10)
                            for x in inputs.values()),
            "bound_ms": bound_ms, "bound_by": by}


def _print_times(label: str, t: dict) -> None:
    print(f"[kernels] {label}: device {t['ms']:.5f} ms, bound "
          f"{t['bound_ms']:.5f} ms ({t['bound_by']}), share of bound "
          f"{t['bound_ms'] / t['ms']:.3f}; plain {t['plain_ms']:.5f} ms; wrapper "
          f"host {t['host_ms']:.5f} ms per call")


def _hamming_library(lib, main_ham, main_kf) -> dict:
    """The single PyTorch calls that compute the Hamming kernel's function
    (``kernel_bench.HAMMING_LIBRARY``: unpack, the call, one ``torch.where``
    for the masks), each held equal to the kernel at the frame's and the
    keyframe's shapes, then timed there beside the kernel, shape by shape.
    Returns the faster call's times."""
    import torch
    from gfplslam_torch.ops.hamming import hamming_cuda
    from gfplslam_torch.utils import kernel_bench as kb
    shapes = {f"frame {n}x{n}": args for n, args in main_ham.items()}
    shapes.update({f"keyframe {label}": args for label, args in main_kf.items()})
    for label, args in shapes.items():
        want = hamming_cuda(*args)
        for call, fn in kb.HAMMING_LIBRARY.items():
            if not torch.equal(fn(*args), want):
                _fail(f"{call} != the Hamming kernel at {label}")
    print(f"[kernels] Hamming library calls {list(kb.HAMMING_LIBRARY)}: equal "
          f"to the kernel (torch.equal) at {len(shapes)} shapes")
    times = {}
    by_shape = {}
    for label, args in shapes.items():
        kernel = kb.hamming_launches_ms(lib, {label: args})
        row = {call: kb.library_ms(fn, {label: args})
               for call, fn in kb.HAMMING_LIBRARY.items()}
        by_shape[label] = dict(row, kernel=kernel)
        print(f"[kernels] Hamming {label}: kernel {kernel:.5f} ms; " + "; ".join(
            f"{call} {ms:.5f} ms ({ms / kernel:.2f}x the kernel)"
            for call, ms in row.items()))
        for call, ms in row.items():
            times.setdefault(call, {"frame": 0.0, "keyframe": 0.0})
            # the frame's four matrices are its two shapes twice
            if label.startswith("frame"):
                times[call]["frame"] += 2 * ms
            else:
                times[call]["keyframe"] += ms
    best = min(times, key=lambda c: times[c]["frame"] + times[c]["keyframe"])
    for call, t in times.items():
        print(f"[kernels] Hamming library {call}: {t['frame']:.5f} ms per frame, "
              f"{t['keyframe']:.5f} ms per keyframe")
    return {"call": best, "frame_ms": times[best]["frame"],
            "keyframe_ms": times[best]["keyframe"], "by_shape": by_shape}


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
    frames = _render(world, n, noise=1.5)

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
    frames = _render(world, n, noise=1.0)
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


def phase_full_capacity_loop(dev, name, records, n: int = 40):
    """The port's half of the slow tier (tests/test_torch_slam_full_capacity.py)
    on the card: 752x480, the default 1024-point / 512-line budgets and the
    shipped 256-word vocabulary, the textured loop world written as PGM and
    decoded by the native loader, per-frame ``SLAMSystem.process`` then
    ``finish()``, held to that test's gates and to the reference's
    trajectory recorded in tests/data/ref_full_capacity_loop_traj.npy."""
    import torch
    from gfplslam_torch.config import Config, SlamParams
    from gfplslam_torch.io import native_loader, synthetic
    from gfplslam_torch.models import loop
    from gfplslam_torch.models.slam import SLAMSystem
    from gfplslam_torch.utils.kernel_bench import u8
    from gfplslam_torch.utils.trajectory import ate_rmse

    cfg = Config(slam=SlamParams(max_kf_num_frames=2, lc_kf_dist=6,
                                 lc_kf_max_dist=3, lc_nkf_closest=2))
    world = synthetic.make_world(n_frames=n, n_points=900, n_lines=90, seed=21,
                                 motion="loop", cam=cfg.camera, textured=True)
    rendered = [(u8(l), u8(r)) for l, r in _render(world, n, noise=1.0)]
    root = HERE / "build" / "chip_smoke" / "full_capacity"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    paths = ([str(root / f"l_{i:04d}.pgm") for i in range(n)],
             [str(root / f"r_{i:04d}.pgm") for i in range(n)])
    for i, pair in enumerate(rendered):
        for side in (0, 1):
            _write_pgm(Path(paths[side][i]), pair[side])
    frames = [None] * n
    with native_loader.StereoLoader(*paths, cfg.camera.width, cfg.camera.height,
                                    n_threads=2, queue_depth=4) as loader:
        for k, il, ir in loader:
            frames[k] = (il, ir)
    for k in range(n):
        for side in (0, 1):
            if not np.array_equal(frames[k][side], rendered[k][side]):
                _fail(f"full-capacity frame {k} decodes unlike the rendered frame")

    slam = SLAMSystem(cfg, device=dev)
    source = loop.VOCAB_SOURCE
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    for i, (il, ir) in enumerate(frames):
        slam.process(il, ir, world.timestamps[i])
    slam.finish()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _counts()
    n_kf = len(slam.keyframe_trajectory)
    closures = slam.n_loop_closures
    ate = ate_rmse(slam.all_frame_trajectory, world.poses)
    ref = np.load(HERE / "tests" / "data" / "ref_full_capacity_loop_traj.npy")
    parity = ate_rmse(slam.all_frame_trajectory, ref)
    expected = {"fast9_score": 2 * n,
                "hamming_matrix": 2 + 4 * (n - 1) + 2 + 6 * (n_kf - 1) + 2 * closures}
    print(f"[full-capacity-loop] 752x480 x{n}, 1024 pt / 512 ln, vocab "
          f"{Path(source).name}, per-frame process: {secs:.3f} s = {n / secs:.3f} "
          f"frames/s; lost {slam.vo.lost}, keyframes {n_kf}, loop closures "
          f"{closures}, fused landmarks {slam.n_fused_landmarks}, ATE {ate:.5f} m, "
          f"{parity:.5f} m from the reference's trajectory; device {name} ({_smi()})")
    print(f"[full-capacity-loop] launches {launches} (expected {expected})")
    for r in records:
        r["launches_by_path"]["full_capacity_loop"] = launches[r["name"]]
    if not source.endswith("vocab_synth.npz"):
        _fail(f"full-capacity vocabulary is {source}, not the shipped vocab_synth.npz")
    if slam.vo.lost or n_kf < 8 or not ate < 0.10 or closures < 1:
        _fail("full-capacity gate failed (need not lost, >= 8 keyframes, "
              "ATE < 0.10 m, >= 1 loop closure)")
    if not parity < 0.08:
        _fail(f"full-capacity trajectory {parity} m from the reference's (need < 0.08)")
    if launches != expected:
        _fail(f"full-capacity launch counts {launches} != {expected}")


def phase_ba_window(dev, name, reps: int = 3):
    """The full-capacity world's keyframe-13 local-BA window on the card,
    held to the reference's f64 solution stored beside it
    (tests/test_torch_ba_observed_subspace.py records both and holds the
    CPU to the same gates)."""
    import torch
    from gfplslam_torch.config import CameraParams, Config
    from gfplslam_torch.models import ba, ba_core
    from gfplslam_torch.utils import se3

    z = np.load(HERE / "tests" / "data" / "full_capacity_kf13_window.npz")
    cam = CameraParams(**{f: type(getattr(CameraParams, f))(z[f"cam_{f}"])
                          for f in CameraParams.__dataclass_fields__})
    prob = ba.BAProblem(*(torch.from_numpy(z[f]).to(dev) for f in ba.BAProblem._fields))
    slam = Config().slam
    _reset_counts()
    bk = ba_core.build_blocks(cam, prob, ba_core.make_selectors(prob),
                              ba._point_residuals, ba._line_residuals,
                              se3.inverse_se3(prob.kf_pose), prob.pt_pos,
                              prob.ln_sp, prob.ln_ep)
    lam = torch.tensor(slam.lambda_lba_lm, device=dev)
    s, _ = ba_core.schur_reduce(bk, *ba_core.landmark_inverses(bk, lam))
    eig = torch.linalg.eigvalsh(0.5 * (s + s.T).double()).cpu().numpy()
    res, ms = _sync_ms(lambda: ba.solve_ba(
        cam, prob, lambda0=slam.lambda_lba_lm, lambda_k=slam.lambda_lba_k,
        max_iters=slam.max_iters_lba), reps)
    launches = _counts()
    valid = z["kf_valid"]
    dpos = float(np.linalg.norm(res.kf_pose.cpu().numpy()[valid, :3, 3]
                                - z["f64_kf_pose"][valid, :3, 3], axis=-1).max())
    derr = abs(float(res.err) - float(z["f64_err"]))
    per_iter = statistics.median(ms) / slam.max_iters_lba
    print(f"[ba-window] keyframe-13 window ({int(valid.sum())} KF, "
          f"{int(z['pt_valid'].sum())} pt, {int(z['ln_valid'].sum())} ln, "
          f"{int(z['po_valid'].sum())} + {int(z['lo_valid'].sum())} observations): "
          f"S eigenvalues smallest {eig[0]:.6g}, largest {eig[-1]:.6g}, ratio "
          f"{eig[0] / eig[-1]:.3e}; err {float(res.err):.6f} (f64 reference "
          f"{float(z['f64_err']):.6f}, {derr:.3e} off) in {int(res.iters)} iterations "
          f"(f64: {int(z['f64_iters'])}); largest keyframe deviation {dpos:.3e} m; "
          f"{per_iter:.4f} ms per LM iteration ({slam.max_iters_lba} run, median of "
          f"{reps}); launches {launches}; device {name} ({_smi()})")
    if not eig[0] >= -1e-4 * eig[-1]:
        _fail(f"BA window: reduced camera system indefinite ({eig[0]} vs {eig[-1]})")
    if not (dpos <= 1e-2 and derr <= 5e-3):
        _fail(f"BA window: keyframes {dpos} m, error {derr} from the f64 solution "
              "(need <= 1e-2 m and <= 5e-3)")
    if any(launches.values()):
        _fail(f"BA window launched a kernel: {launches}")


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def _write_pgm(path: Path, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        f.write(np.ascontiguousarray(img, np.uint8).tobytes())


def _write_kitti_sequence(root: Path, world) -> np.ndarray:
    """A KITTI odometry directory: image_0/ and image_1/ as binary PGM (the
    native loader decodes P5 on any build; PNG needs libpng's headers),
    times.txt and poses.txt (3x4 rows). Returns frame 0 (uint8 [2, H, W])."""
    from gfplslam_torch.utils.kernel_bench import u8
    shutil.rmtree(root, ignore_errors=True)
    for cam in ("image_0", "image_1"):
        (root / cam).mkdir(parents=True)
    pairs = [u8(np.stack(f)) for f in _render(world, len(world.poses), noise=1.0)]
    for i, (img_l, img_r) in enumerate(pairs):
        _write_pgm(root / "image_0" / f"{i:06d}.pgm", img_l)
        _write_pgm(root / "image_1" / f"{i:06d}.pgm", img_r)
    np.savetxt(root / "times.txt", world.timestamps, fmt="%.6f")
    np.savetxt(root / "poses.txt", world.poses[:, :3, :].reshape(-1, 12), fmt="%.9f")
    return pairs[0]


def _equal_states(a, b, label: str) -> int:
    import torch
    for name, x, y in zip(a._fields, a, b):
        if x.dtype != y.dtype or not torch.equal(x, y):
            _fail(f"checkpoint round trip: {label}.{name} differs")
    return len(a._fields)


def phase_kitti_run_slam(dev, name, records, n: int = 61):
    """Acceptance config 3's world at KITTI 00's width through the user's
    entry point: PGM files on disk -> native loader -> apps/run_slam.py
    (default Config and capacities, loop closure and async mapping on,
    --chunk 20), then a checkpoint round trip of the system it ran, and the
    FAST kernel at the shapes this width gives it (frame 0's pyramid):
    exact at every threshold, then timed, into the kernel's record."""
    import torch
    from gfplslam_torch.apps import run_slam
    from gfplslam_torch.config import Config
    from gfplslam_torch.io import synthetic
    from gfplslam_torch.io.datasets import KITTI_CALIB, load_kitti
    from gfplslam_torch.models.slam import SLAMSystem
    from gfplslam_torch.utils import kernel_bench as kb
    from gfplslam_torch.utils.timing import FIELDS
    from gfplslam_torch.utils.trajectory import read_tum

    cam = KITTI_CALIB["00"]
    world = synthetic.make_world(n, n_points=900, n_lines=90, seed=3,
                                 motion="forward", cam=cam, textured=True)
    out = HERE / "build" / "chip_smoke"
    t0 = time.perf_counter()
    pair0 = _write_kitti_sequence(KITTI_DIR, world)
    print(f"[kitti-run-slam] wrote {n} PGM pairs {cam.width}x{cam.height} to "
          f"{KITTI_DIR.relative_to(HERE)} in {time.perf_counter() - t0:.2f} s")
    prefix = str(out / "kitti_00")
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    summary, engine = run_slam.run(["--kitti", str(KITTI_DIR), "-o", prefix,
                                    "--chunk", "20"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _counts()
    frames, n_kf = summary["frames"], summary["keyframes"]
    closures = summary["loop_closures"]
    print(f"[kitti-run-slam] summary {json.dumps(summary)}")
    print(f"[kitti-run-slam] {cam.width}x{cam.height} x{frames}, chunk 20, "
          f"device {name} ({_smi()}): {secs:.4f} s = {frames / secs:.4f} frames/s "
          f"(host clock, native loader and outputs included)")
    path = float(np.linalg.norm(np.diff(world.poses[:, :3, 3], axis=0), axis=1).sum())
    expected = {"fast9_score": 2 * frames,
                "hamming_matrix": 2 + 4 * (frames - 1) + 2 + 6 * (n_kf - 1)
                + 2 * closures}
    print(f"[kitti-run-slam] ATE {summary.get('ate_rmse')} m of path {path:.4f} m; "
          f"launches {launches} (expected {expected})")
    if summary["lost"] or n_kf < 2 or frames != n:
        _fail(f"KITTI run lost, < 2 keyframes or short: {summary}")
    if not summary.get("ate_rmse", np.inf) < 0.05 * path:
        _fail(f"KITTI run ATE {summary.get('ate_rmse')} not below 5% of {path}")
    if launches != expected:
        _fail(f"KITTI run launch counts {launches} != {expected}")
    ts_all, _ = read_tum(prefix + "_AllFrameTrajectory.txt")
    ts_kf, _ = read_tum(prefix + "_KeyFrameTrajectory.txt")
    # the chunked driver times no stage, so its log is the reference's: the
    # header and no row
    with open(prefix + "_Log.txt") as f:
        log = f.read().splitlines()
    gt_ts = load_kitti(str(KITTI_DIR)).timestamps
    if (len(ts_all) != frames or len(ts_kf) != n_kf or log != ["# " + " ".join(FIELDS)]
            or not np.allclose(ts_all, gt_ts[:frames], atol=1e-6)):
        _fail(f"KITTI outputs: {len(ts_all)} frame rows, {len(ts_kf)} keyframe rows, "
              f"log of {len(log)} lines; want {frames}, {n_kf}, the header alone")
    for r in records:
        # this slice's main path: the user's entry point at KITTI width
        r["launches"] = launches[r["name"]]
        r["launches_by_path"]["kitti_run_slam"] = launches[r["name"]]

    ckpt = str(out / "kitti_00_slam.npz")
    engine.save(ckpt)
    fresh = SLAMSystem(engine.cfg, device=dev)
    fresh.load(ckpt)
    fields = (_equal_states(fresh.map, engine.map, "map")
              + _equal_states(fresh.loop_state, engine.loop_state, "loop")
              + _equal_states(fresh.vo.state, engine._scan_carry[0], "tracker"))
    print(f"[kitti-run-slam] checkpoint {Path(ckpt).relative_to(HERE)} "
          f"({Path(ckpt).stat().st_size} bytes): {fields} map/loop/tracker fields "
          f"equal after save + load into a fresh system; n_kf {fresh._n_kf_host}")

    # the FAST kernel at this path's shapes: its record's times are this
    # frame's, beside this run's launches (the EuRoC frame's stay as "euroc")
    kitti_fast = kb.fast_pyramid_inputs(pair0, Config(camera=cam), dev)
    err = max(_check_fast(f"KITTI frame 0 {label}", x, True)
              for label, x in kitti_fast.items())
    times = _fast_times(kitti_fast)
    _print_times(f"FAST per KITTI frame {times['frame_shapes']}", times)
    fast = next(r for r in records if r["name"] == "fast9_score")
    fast["euroc"] = {k: fast[k] for k in times}
    fast.update(times, max_abs_err=max(fast["max_abs_err"], err),
                exact_at_kitti_shapes=times["frame_shapes"])


def phase_timed_vo(dev, name, records, n_kitti: int = 20):
    """``run_slam --synthetic --timing --vo-only --frames 8`` (TimedVO, one
    synchronized call per reference stage) against VisualOdometry on the
    same frames: trajectories equal, every stage timed. Then the same mode
    on the first ``n_kitti`` frames of the KITTI sequence: where a frame's
    time goes at 1241x376."""
    from gfplslam_torch.apps import run_slam
    from gfplslam_torch.io import synthetic
    from gfplslam_torch.models.vo import VisualOdometry
    from gfplslam_torch.utils.timing import FIELDS

    times = [f for f in FIELDS if f.startswith("time")]

    def stage_ms(timed):
        rows = timed.timelog.rows[1:]
        if not all(getattr(r, f) > 0 for r in rows for f in times):
            _fail("a time_* field of a tracked frame is not > 0")
        # time_track is the frame's total: the sum of the other nine
        return {f: round(1e3 * statistics.median(getattr(r, f) for r in rows), 4)
                for f in times}

    out = HERE / "build" / "chip_smoke"
    _reset_counts()
    _, timed = run_slam.run(["--synthetic", "--timing", "--vo-only", "--frames", "8",
                             "-o", str(out / "timed_vo")])
    launches = _counts()
    world = synthetic.make_world(n_frames=8, seed=0)
    plain = VisualOdometry(timed.cfg, device=dev)
    for i in range(8):
        plain.process(*synthetic.render_frame(world, i), world.timestamps[i])
    if not np.array_equal(timed.trajectory, plain.trajectory):
        _fail("TimedVO trajectory != VisualOdometry's on the same frames: max "
              f"{np.abs(timed.trajectory - plain.trajectory).max()}")
    if min(launches.values()) < 1:
        _fail(f"timed VO launched a kernel no time: {launches}")
    for r in records:
        r["launches_by_path"]["timed_vo"] = launches[r["name"]]
    med = stage_ms(timed)
    print(f"[timed-vo] {timed.cfg.camera.width}x{timed.cfg.camera.height} x8, "
          f"default capacities: trajectory equal to VisualOdometry's; median ms "
          f"per tracked frame {med['time_track']}, by stage {json.dumps(med)}; launches "
          f"{launches}; device {name} ({_smi()})")

    summary, timed = run_slam.run(["--kitti", str(KITTI_DIR), "--timing", "--vo-only",
                                   "-n", str(n_kitti), "-o", str(out / "timed_kitti")])
    if summary["lost"] or summary["frames"] != n_kitti:
        _fail(f"timed KITTI VO lost or short: {summary}")
    med = stage_ms(timed)
    print(f"[timed-vo] KITTI {timed.cfg.camera.width}x{timed.cfg.camera.height} "
          f"x{n_kitti}, default Config, native loader: median ms per tracked "
          f"frame {med['time_track']}, by stage {json.dumps(med)}; device {name} ({_smi()})")


def phase_vocab(dev, name, records, n_desc: int = 20000):
    """``train_vocab``'s shapes: the Hamming kernel exact at [8192, 4096] and
    [1000, 4096] unmasked, and k-majority on the card equal to the CPU."""
    import torch
    from gfplslam_torch.apps import train_vocab
    from gfplslam_torch.ops import kernels
    from gfplslam_torch.ops.hamming import hamming_cuda, hamming_matrix
    from gfplslam_torch.utils import kernel_bench as kb

    rng = np.random.default_rng(7)
    words = torch.as_tensor(rng.integers(-2**31, 2**31, (4096, 8)),
                            dtype=torch.int32, device=dev)
    blocks = {}
    for n in (8192, 1000):
        blocks[n] = torch.as_tensor(rng.integers(-2**31, 2**31, (n, 8)),
                                    dtype=torch.int32, device=dev)
        _check_hamming(f"train_vocab {n}x4096 unmasked", blocks[n], words, None, None)
    for r in records:
        if r["name"] == "hamming_matrix":
            r["exact_at_train_vocab_shapes"] = ["8192x4096", "1000x4096"]
    lib = kernels.load()
    block = {8192: (blocks[8192], words, None, None)}
    kern = kb.hamming_launches_ms(lib, block)
    step = kb.graph_ms([lambda: torch.argmin(hamming_matrix(blocks[8192], words),
                                             dim=1)] * 10)
    bound = kb.hamming_bytes_ms(block)
    print(f"[vocab] one assignment block 8192x4096: Hamming kernel {kern:.5f} ms "
          f"(bytes bound {bound:.5f} ms, share {bound / kern:.3f}), with the "
          f"argmin {step:.5f} ms; device {name} ({_smi()})")

    desc = rng.integers(0, 2**32, size=(n_desc, 8), dtype=np.uint32)
    _reset_counts()
    t0 = time.perf_counter()
    got = train_vocab.kmajority(desc, 4096, iters=5, device=dev)
    secs = time.perf_counter() - t0
    launches = _counts()
    t0 = time.perf_counter()
    want = train_vocab.kmajority(desc, 4096, iters=5, device="cpu")
    cpu_secs = time.perf_counter() - t0
    if not np.array_equal(got, want):
        _fail(f"k-majority on the card != on the CPU: "
              f"{int((got != want).any(1).sum())} of 4096 centers differ")
    per_iter = -(-n_desc // train_vocab.ASSIGN_BLOCK)
    if launches["hamming_matrix"] % per_iter or not launches["hamming_matrix"]:
        _fail(f"k-majority Hamming launches {launches} not a multiple of {per_iter}")
    for r in records:
        r["launches_by_path"]["vocab_kmajority"] = launches[r["name"]]
    print(f"[vocab] k-majority N={n_desc} k=4096, at most 5 iterations "
          f"({launches['hamming_matrix'] // per_iter} run before the centers "
          f"settled): centers equal to the CPU run; card {secs:.3f} s, CPU "
          f"{cpu_secs:.3f} s (host clocks); Hamming launches "
          f"{launches['hamming_matrix']} ({per_iter} per iteration)")


def phase_rectify(dev):
    """A two-frame EuRoC tree of raw PGM frames through ``load_euroc`` (the
    EuRoC calibration's rectification maps) and the native loader, each
    frame also rectified by ``rectify_pair`` on the card and on the CPU."""
    import torch
    from gfplslam_torch.io import native_loader
    from gfplslam_torch.io.datasets import load_euroc
    from gfplslam_torch.ops.camera import rectify_pair
    root = HERE / "build" / "chip_smoke" / "euroc"
    shutil.rmtree(root, ignore_errors=True)
    raw = np.random.default_rng(11).integers(0, 256, (2, 2, 480, 752)).astype(np.uint8)
    for c in range(2):
        data = root / "mav0" / f"cam{c}" / "data"
        data.mkdir(parents=True)
        for i in range(len(raw)):
            _write_pgm(data / f"{1403636579763555584 + 50_000_000 * i}.pgm", raw[i, c])
    seq = load_euroc(str(root))
    maps = seq.maps
    err_card = err_loader = 0.0
    with native_loader.StereoLoader(
            seq.paths_l, seq.paths_r, maps.cam.width, maps.cam.height,
            maps=(maps.map_x_l, maps.map_y_l, maps.map_x_r, maps.map_y_r)) as loader:
        done = 0
        for k, img_l, img_r in loader:
            imgs = torch.as_tensor(raw[k], dtype=torch.float32)
            want = rectify_pair(imgs, maps)
            got = rectify_pair(imgs.to(dev), maps).cpu()
            err_card = max(err_card, float((got - want).abs().max()))
            err_loader = max(err_loader, float(
                (torch.as_tensor(np.stack([img_l, img_r])) - got).abs().max()))
            done += 1
    print(f"[rectify] EuRoC calibration, {done} raw PGM pairs 752x480: rectify_pair on "
          f"the card vs the CPU max abs difference {err_card}; the native loader "
          f"(formats {sorted(native_loader.formats())}) vs the card {err_loader} "
          f"(limit 1e-3 on 0-255 images)")
    if done != len(raw) or not (err_card <= 1e-3 and err_loader <= 1e-3):
        _fail(f"rectification: {done} frames, card vs CPU {err_card}, "
              f"loader vs card {err_loader}")


def _sync_ms(fn, reps: int):
    """fn() once to warm up, then the ms of each of ``reps`` calls (host
    clock around work that ends in a device synchronize); fn's last result."""
    import torch
    out = fn()
    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return out, ms


def _same_on_every_rank(results, label: str) -> None:
    import torch

    def equal(a, b):
        if torch.is_tensor(a):
            return a.dtype == b.dtype and torch.equal(a, b)
        if isinstance(a, (tuple, list)):
            return len(a) == len(b) and all(equal(x, y) for x, y in zip(a, b))
        if isinstance(a, dict):
            return a.keys() == b.keys() and all(equal(a[k], b[k]) for k in a)
        return True   # timings and counts are each rank's own
    if not all(equal(results[0], r) for r in results[1:]):
        _fail(f"{label}: the ranks returned different results")


def _fabricated_map(cfg, dev, n_kf: int = 80, n_pt: int = 96, seed: int = 7):
    """tests/test_dist.py's >64-keyframe map (poses on a noisy line, point
    landmarks seen from many keyframes), built from the same numpy draws."""
    import torch
    from gfplslam_torch.models import map as map_ops

    rng = np.random.default_rng(seed)
    cam = cfg.camera
    poses = []
    for _ in range(n_kf):
        t = np.eye(4, dtype=np.float32)
        t[2, 3] = 0.05 * len(poses) + rng.normal(0, 2e-3)
        t[0, 3] = rng.normal(0, 2e-3)
        poses.append(t)
    poses = np.stack(poses)
    pts = np.stack([rng.uniform(-2, 2, n_pt), rng.uniform(-1.5, 1.5, n_pt),
                    rng.uniform(6, 20, n_pt)], 1).astype(np.float32)
    po_kf, po_lm, po_uv = [], [], []
    for ki in range(n_kf):
        t_cw = np.linalg.inv(poses[ki])
        pc = pts @ t_cw[:3, :3].T + t_cw[:3, 3]
        u = cam.fx * pc[:, 0] / pc[:, 2] + cam.cx
        v = cam.fy * pc[:, 1] / pc[:, 2] + cam.cy
        vis = (pc[:, 2] > 0.5) & (u > 0) & (u < cam.width) & (v > 0) & (v < cam.height)
        for pi in np.nonzero(vis)[0][:24]:
            po_kf.append(ki)
            po_lm.append(pi)
            po_uv.append([u[pi] + rng.normal(0, 0.3), v[pi] + rng.normal(0, 0.3)])
    m = map_ops.empty_map(cfg, dev)

    def put(x, vals):
        x = x.clone()
        vals = torch.as_tensor(np.asarray(vals), dtype=x.dtype, device=dev)
        x[:len(vals)] = vals
        return x
    n_obs = len(po_kf)
    return m._replace(
        kf_pose=put(m.kf_pose, poses), kf_valid=put(m.kf_valid, [True] * n_kf),
        n_kf=m.n_kf.new_tensor(n_kf), pt_pos=put(m.pt_pos, pts),
        pt_valid=put(m.pt_valid, [True] * n_pt), pt_obs_n=put(m.pt_obs_n, [n_kf] * n_pt),
        po_kf=put(m.po_kf, po_kf), po_lm=put(m.po_lm, po_lm),
        po_uv=put(m.po_uv, np.asarray(po_uv, np.float32)),
        po_valid=put(m.po_valid, [True] * n_obs))


def phase_dist_ba(dev, name):
    """Acceptance config 5's problem (16 keyframes, 8064 points, 1008
    lines, ``bench_dist_ba.make_problem`` seed 0) on the card: the dense
    ``solve_ba`` against ``solve_ba_sharded`` over one NCCL rank and over
    four gloo ranks sharing the card, 8 LM iterations (``tol=0``), poses
    within tests/test_dist.py's 5e-3 and equal on every rank; ms per LM
    iteration of each. Then ``SLAMSystem.finish(run_global_ba=True)`` over
    four ranks on tests/test_dist.py's 80-keyframe map against the dense
    finish."""
    import torch
    from gfplslam_torch.apps import bench_dist_ba
    from gfplslam_torch.config import (CameraParams, CapacityParams, Config,
                                       OrbParams)
    from gfplslam_torch.models import ba
    from gfplslam_torch.models.slam import SLAMSystem
    from gfplslam_torch.parallel import dist_ba, multihost, workers

    cam = CameraParams()
    iters, reps = 8, 3
    prob = bench_dist_ba.make_problem(16, 8064, 1008, cam, seed=0)
    prob_dev = type(prob)(*(x.to(dev) for x in prob))
    dense, ms = _sync_ms(lambda: ba.solve_ba(cam, prob_dev, max_iters=iters, tol=0.0),
                         reps)
    dense_pose = dense.kf_pose.cpu()
    print(f"[dist-ba] 16 KF / 8064 pt / 1008 ln ({int(prob.po_valid.sum())} + "
          f"{int(prob.lo_valid.sum())} observations), {iters} LM iterations: dense "
          f"solve_ba {statistics.median(ms) / iters:.4f} ms per iteration (median of "
          f"{reps}), err {float(dense.err):.6f}; device {name} ({_smi()})")
    for n in (1, 4):
        backend = multihost.backend_for("cuda", n)
        t0 = time.perf_counter()
        out = multihost.launch(workers.sharded_ba, n, cam,
                               dist_ba.shard_problem_by_landmark(prob, n), "cuda",
                               iters, 0.0, reps, device="cuda")
        wall = time.perf_counter() - t0
        _same_on_every_rank([r[0] for r in out], f"sharded BA over {n} {backend} ranks")
        res, rank_ms = out[0]
        d_pose = float((res.kf_pose - dense_pose).abs().max())
        d_err = abs(float(res.err) - float(dense.err))
        print(f"[dist-ba] solve_ba_sharded over {n} {backend} rank(s) on one card: "
              f"{statistics.median(rank_ms):.4f} ms per iteration (rank 0, median of "
              f"{reps}); poses vs dense max {d_pose:.3e}, err {float(res.err):.6f} "
              f"(vs dense {d_err:.3e}); {wall:.1f} s with the ranks' start; "
              f"a correctness run, not a scaling measurement")
        if not (torch.allclose(res.kf_pose, dense_pose, rtol=5e-3, atol=5e-3)
                and d_err < 5e-3 and int(res.iters) == iters):
            _fail(f"sharded BA over {n} ranks disagrees with the dense solve: poses "
                  f"{d_pose}, err {d_err}, iterations {int(res.iters)}")

    cfg = Config(cap=CapacityParams(n_pt=256, n_ln=128, n_kf_window=4, n_kf_max=96,
                                    n_map_pt=128, n_map_ln=64, n_obs_pt=128,
                                    n_obs_ln=64),
                 orb=OrbParams(nlevels=2),
                 camera=CameraParams(width=376, height=240, fx=217.6, fy=217.6,
                                     cx=183.7, cy=126.1, baseline=0.11))
    m = _fabricated_map(cfg, dev)
    slam = SLAMSystem(cfg, device=dev)
    slam.map, slam._n_kf_host = m, int(m.n_kf)
    slam.finish(run_global_ba=True)
    dense = type(m)(*(x.cpu() for x in slam.map))
    out = multihost.launch(workers.finish_global_ba, 4, cfg,
                           type(m)(*(x.cpu() for x in m)), "cuda", device="cuda")
    _same_on_every_rank(out, "finish over 4 ranks")
    got = out[0]
    d_pose = float((got.kf_pose - dense.kf_pose).abs().max())
    ints = [f for f, x in zip(got._fields, got) if not x.is_floating_point()]
    same_ints = all(torch.equal(getattr(got, f), getattr(dense, f)) for f in ints)
    print(f"[dist-ba] finish(run_global_ba=True) on the 80-KF map over 4 gloo ranks: "
          f"maps equal on every rank; keyframe poses vs the dense finish max "
          f"{d_pose:.3e}; {len(ints)} integer fields equal {same_ints}")
    if not (torch.allclose(got.kf_pose, dense.kf_pose, rtol=1e-3, atol=5e-4)
            and same_ints):
        _fail("sharded finish disagrees with the dense finish")


def phase_batch_vo(dev, name, records, n_seq: int = 4, n: int = 24):
    """``run_vo_batch`` at full width: 4 EuRoC worlds (752x480, bench.py's
    world with seed 3 + s, noise 1.5), default Config, 24 frames each, with
    no group and over four gloo ranks sharing the card. Per sequence: the
    integer outputs equal, poses within 0.08 m aligned ATE of each other,
    each ATE < 5% of its path; launches as the frames imply."""
    import torch
    from gfplslam_torch.config import CameraParams, Config
    from gfplslam_torch.io import synthetic
    from gfplslam_torch.parallel import multihost, workers
    from gfplslam_torch.parallel.batch import run_vo_batch
    from gfplslam_torch.utils.kernel_bench import u8
    from gfplslam_torch.utils.trajectory import ate_rmse

    cfg = Config(camera=CameraParams())
    worlds = [synthetic.make_world(n_frames=n, n_points=900, n_lines=90, seed=3 + s,
                                   cam=cfg.camera) for s in range(n_seq)]
    t0 = time.perf_counter()
    rendered = _render_all(worlds, n, noise=1.5)
    il = u8(np.stack([[f[0] for f in frames] for frames in rendered]))
    ir = u8(np.stack([[f[1] for f in frames] for frames in rendered]))
    ts = np.stack([w.timestamps.astype(np.float32) for w in worlds])
    print(f"[batch-vo] rendered {n_seq} x {n} frames 752x480 in "
          f"{time.perf_counter() - t0:.1f} s")
    expected = {"fast9_score": n_seq * 2 * n, "hamming_matrix": n_seq * (4 * n - 2)}

    run_vo_batch(cfg, il[:1, :2], ir[:1, :2], ts[:1, :2], device=dev)  # warm-up
    torch.cuda.synchronize()
    _reset_counts()
    t0 = time.perf_counter()
    poses, aux = run_vo_batch(cfg, il, ir, ts, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = _counts()
    poses, aux = poses.cpu(), {k: v.cpu() for k, v in aux.items()}
    print(f"[batch-vo] no group: {n_seq} x {n} frames in {secs:.3f} s = "
          f"{n_seq * (n - 1) / secs:.3f} tracked frames/s; launches {launches} "
          f"(expected {expected}); device {name} ({_smi()})")
    if launches != expected:
        _fail(f"batch VO launch counts {launches} != {expected}")

    out = multihost.launch(workers.vo_batch, n_seq, cfg, il, ir, ts, "cuda",
                           device="cuda")
    _same_on_every_rank([r[:2] for r in out], "batch VO over 4 ranks")
    r_poses, r_aux = out[0][:2]
    rank_launches = {k: sum(r[2][k] for r in out) for k in expected}
    print(f"[batch-vo] over {n_seq} gloo ranks on one card: slowest rank "
          f"{max(r[3] for r in out):.3f} s; launches summed over the ranks "
          f"{rank_launches}")
    if rank_launches != expected:
        _fail(f"batch VO over ranks launch counts {rank_launches} != {expected}")
    for s, w in enumerate(worlds):
        path = float(np.linalg.norm(np.diff(w.poses[:, :3, 3], axis=0), axis=1).sum())
        ate = ate_rmse(poses[s].numpy().astype(np.float64), w.poses)
        between = ate_rmse(r_poses[s].numpy().astype(np.float64),
                           poses[s].numpy().astype(np.float64))
        same = all(torch.equal(r_aux[k][s], aux[k][s])
                   for k in ("accepted", "n_pt", "n_ln", "is_kf"))
        print(f"[batch-vo] sequence {s} (seed {3 + s}): ATE {ate:.5f} m of path "
              f"{path:.4f} m ({100 * ate / path:.3f}%), ranks vs no group "
              f"{between:.2e} m, integer outputs equal {same}, accepted "
              f"{float(aux['accepted'][s].float().mean()):.3f}")
        if not (same and between < 0.08 and ate < 0.05 * path):
            _fail(f"batch VO sequence {s}: integers equal {same}, between {between}, "
                  f"ATE {ate} of {path}")
    for r in records:
        r["launches_by_path"]["batch_vo"] = launches[r["name"]]
        r["launches_by_path"]["batch_vo_4_ranks"] = rank_launches[r["name"]]


def phase_analysis_apps(dev, name, records):
    """The analysis apps through their ``run`` at the reference's
    defaults: reports finite and each app's own check (``simulate_linecut``:
    the greedy cut within reach of the grid optimum; ``simulate_pl_loss``:
    both losses smallest at the true pose on every axis), and the kernels'
    launches for ``assess`` and ``ab_orb_pattern``."""
    from gfplslam_torch.apps import (ab_orb_pattern, assess, simulate_linecut,
                                     simulate_pl_loss)

    def finite(report):
        vals = [v for v in report.values() if isinstance(v, (int, float))]
        return all(np.isfinite(vals))

    t0 = time.perf_counter()
    _reset_counts()
    summary, _ = assess.run([])
    launches = _counts()
    want = {"fast9_score": 2 * 6, "hamming_matrix": 2 * 6 + 2 * 5}
    print(f"[analysis-apps] assess (6 frames, 376x240): {json.dumps(summary)}; "
          f"launches {launches} (expected {want})")
    if not finite(summary) or launches != want or not 0 < summary["match_precision"] <= 1:
        _fail(f"assess: {summary}, launches {launches}")
    for r in records:
        r["launches_by_path"]["assess"] = launches[r["name"]]

    _reset_counts()
    reports = ab_orb_pattern.run([])
    launches = _counts()
    want = {k: 2 * v for k, v in want.items()}
    print(f"[analysis-apps] ab_orb_pattern: {json.dumps(reports)}; launches "
          f"{launches} (expected {want})")
    if (launches != want or [r["pattern"] for r in reports] != ["random", "orb"]
            or not all(r["stereo_matches"] > 0 and r["crossframe_matches"] > 0
                       for r in reports)):
        _fail(f"ab_orb_pattern: {reports}, launches {launches}")
    for r in records:
        r["launches_by_path"]["ab_orb_pattern"] = launches[r["name"]]

    summary, data = simulate_linecut.run([])
    print(f"[analysis-apps] simulate_linecut (200 rounds): {json.dumps(summary)}, "
          f"smallest gap {min(data['gaps']):.3e}; the JAX package's {REF_LINECUT}")
    # the greedy cut is a point of the grid, so no gap is negative
    if (not finite(summary) or min(data["gaps"]) < -1e-3
            or abs(summary["mean_gap"] - REF_LINECUT["mean_gap"]) > 1e-3):
        _fail(f"simulate_linecut: {summary}, smallest gap {min(data['gaps'])}")
    summary, _ = simulate_pl_loss.run([])
    print(f"[analysis-apps] simulate_pl_loss (100 rounds, grid 20): {json.dumps(summary)}; "
          f"the JAX package's curvature ratio {REF_PL_CURVATURE}")
    ratio = summary["line_vs_point_curvature_ratio"]
    if (not finite(summary) or summary["axes_min_at_true_pose_p2p"] != 6
            or summary["axes_min_at_true_pose_p2l"] != 6
            or abs(ratio - REF_PL_CURVATURE) > 1e-3 * REF_PL_CURVATURE):
        _fail(f"simulate_pl_loss: {summary}")
    print(f"[analysis-apps] the four apps in {time.perf_counter() - t0:.1f} s; "
          f"device {name} ({_smi()})")


def _run(phase: str, fn, *args):
    """Run one phase; on any failure name it on stderr, then let it end the
    script (the exit code stays non-zero)."""
    try:
        return fn(*args)
    except BaseException:
        print(f"chip_smoke: phase [{phase}] failed", file=sys.stderr)
        raise


def main() -> None:
    if not (HERE / "gfplslam_torch" / "__init__.py").is_file():
        _fail(f"no gfplslam_torch package beside {Path(__file__).name}; run "
              "it from the root of a checkout")
    sys.path.insert(0, str(HERE))
    t0 = time.perf_counter()
    dev, name = _run("device", phase_device)
    import torch
    _run("build", phase_build)
    records = _run("kernels", phase_kernels, dev)
    _run("small-vo", phase_small_vo, dev)
    _run("full-vo", phase_full_vo, dev, records)
    _run("small-slam", phase_small_slam, dev, records)
    _run("full-slam", phase_full_slam, dev, records)
    _run("full-capacity-loop", phase_full_capacity_loop, dev, name, records)
    _run("ba-window", phase_ba_window, dev, name)
    _run("kitti-run-slam", phase_kitti_run_slam, dev, name, records)
    _run("timed-vo", phase_timed_vo, dev, name, records)
    _run("vocab", phase_vocab, dev, name, records)
    _run("rectify", phase_rectify, dev)
    _run("dist-ba", phase_dist_ba, dev, name)
    _run("batch-vo", phase_batch_vo, dev, name, records)
    _run("analysis-apps", phase_analysis_apps, dev, name, records)
    print(f"[total] every phase passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
