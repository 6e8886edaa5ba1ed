#!/usr/bin/env python3
"""Drive the PyTorch port's stereo VO path once on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (sm_90a),
PyTorch built for CUDA and the CUDA toolkit (``nvcc``); it needs no JAX and
no network. Phases, each reported on its own lines:

1. device: CUDA must be available (otherwise exit 1 with no result); prints
   the card's name and ``nvidia-smi`` name and power limit;
2. build: compiles the kernels under ``gfplslam_torch/csrc`` into
   ``build/gfplslam_torch/`` and prints the seconds it took;
3. kernels: the FAST-9 and Hamming kernels against their plain PyTorch
   versions on the card, bit-exact (``torch.equal``) at the main-path shapes,
   and each one's time beside the plain version's (CUDA events, median);
4. small VO: the 376x240 world of ``tests/test_vo_e2e.py`` through
   ``VisualOdometry`` (gates: not lost, accepted > 0.6, ATE < 0.06 m);
5. full-width VO: the 752x480 EuRoC operating point with the default Config
   through ``run_vo_scan`` (one warm-up, median of 3 timed runs; gates: not
   lost, accepted > 0.6, ATE < 5% of the path), with both kernels' launch
   counts checked against the design (2 FAST launches per frame, 2 Hamming
   calls on the first frame and 4 on every tracked frame).

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
THRESHOLDS = (10.0, 20.0, 35.0)


def _fail(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of one call of ``fn``, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
    print(f"[build] {kernels.library_path().relative_to(HERE)} ready in "
          f"{secs:.2f} s (nvcc {kernels.build_seconds if kernels.build_seconds is not None else 'cached'})")


def phase_kernels(dev):
    """Kernel vs plain version on the card, exact; times at main-path
    shapes. Returns the kernels' JSON records (without launches)."""
    import torch
    from gfplslam_torch.config import CameraParams
    from gfplslam_torch.io import synthetic
    from gfplslam_torch.ops.fast import fast_score_cuda, fast_score_map_torch
    from gfplslam_torch.ops.hamming import hamming_cuda, hamming_matrix_torch

    rng = np.random.default_rng(2024)
    fast_err = 0.0
    fast_inputs = {
        "level0 [2,480,752]": rng.integers(0, 256, (2, 480, 752)),
        "levels1-3 [6,400,627]": rng.integers(0, 256, (6, 400, 627)),
    }
    world = synthetic.make_world(n_frames=2, n_points=900, n_lines=90, seed=3,
                                 cam=CameraParams())
    fast_inputs["rendered EuRoC pair [2,480,752]"] = np.stack(
        synthetic.render_frame(world, 0, noise=1.5))
    for label, arr in fast_inputs.items():
        imgs = torch.as_tensor(np.asarray(arr, np.float32), device=dev)
        for th in THRESHOLDS:
            out = fast_score_cuda(imgs, th)
            ref = fast_score_map_torch(imgs, th)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            fast_err = max(fast_err, err)
            if not torch.equal(out, ref):
                _fail(f"FAST kernel != plain at {label} t={th}: "
                      f"{int((out != ref).sum())} pixels differ, max {err}")
            if float(ref.max()) <= 0:
                _fail(f"FAST plain version found no corner at {label} t={th}")
        print(f"[kernels] FAST {label}: exact at t={THRESHOLDS}")

    ham_err = 0
    ham_cases = [(1024, 1024, True), (512, 512, True), (100, 60, True),
                 (100, 60, False)]
    for n, m, masked in ham_cases:
        a = torch.as_tensor(rng.integers(-2**31, 2**31, (n, 8)), dtype=torch.int32,
                            device=dev)
        b = torch.as_tensor(rng.integers(-2**31, 2**31, (m, 8)), dtype=torch.int32,
                            device=dev)
        va = torch.as_tensor(rng.random(n) < 0.8, device=dev) if masked else None
        vb = torch.as_tensor(rng.random(m) < 0.8, device=dev) if masked else None
        out = hamming_cuda(a, b, va, vb)
        ref = hamming_matrix_torch(a, b, va, vb)
        torch.cuda.synchronize()
        err = int((out - ref).abs().max())
        ham_err = max(ham_err, err)
        if not torch.equal(out, ref):
            _fail(f"Hamming kernel != plain at {n}x{m} masked={masked}: "
                  f"{int((out != ref).sum())} entries differ")
        print(f"[kernels] Hamming {n}x{m} masked={masked}: exact")

    # times at the shapes one full-width frame gives each kernel
    fast_shapes = [torch.as_tensor(np.asarray(fast_inputs[k], np.float32), device=dev)
                   for k in ("level0 [2,480,752]", "levels1-3 [6,400,627]")]
    thr = torch.tensor([20.0], device=dev)
    fast_ms = plain_fast_ms = 0.0
    for imgs in fast_shapes:
        k_ms = cuda_ms(lambda: fast_score_cuda(imgs, thr))
        p_ms = cuda_ms(lambda: fast_score_map_torch(imgs, thr))
        print(f"[kernels] FAST {list(imgs.shape)}: kernel {k_ms:.4f} ms, "
              f"plain {p_ms:.4f} ms")
        fast_ms += k_ms
        plain_fast_ms += p_ms
    ham_ms = plain_ham_ms = 0.0
    for n in (1024, 512, 1024, 512):   # stereo pts, stereo lines, cross pts, cross lines
        a = torch.as_tensor(rng.integers(-2**31, 2**31, (n, 8)), dtype=torch.int32,
                            device=dev)
        v = torch.ones(n, dtype=torch.bool, device=dev)
        k_ms = cuda_ms(lambda: hamming_cuda(a, a, v, v))
        p_ms = cuda_ms(lambda: hamming_matrix_torch(a, a, v, v))
        print(f"[kernels] Hamming {n}x{n}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
        ham_ms += k_ms
        plain_ham_ms += p_ms
    print(f"[kernels] per full-width frame: FAST kernel {fast_ms:.4f} ms vs plain "
          f"{plain_fast_ms:.4f} ms; Hamming kernel {ham_ms:.4f} ms vs plain "
          f"{plain_ham_ms:.4f} ms")
    return [
        {"name": "fast9_score", "route": "cuda",
         "source": "gfplslam_torch/csrc/fast_score.cu",
         "replaces": "gfplslam_tpu/ops/pallas/fast_pl.py:41",
         "max_abs_err": fast_err, "ms": fast_ms, "plain_ms": plain_fast_ms},
        {"name": "hamming_matrix", "route": "cuda",
         "source": "gfplslam_torch/csrc/hamming.cu",
         "replaces": "gfplslam_tpu/ops/pallas/hamming_pl.py:28",
         "max_abs_err": float(ham_err), "ms": ham_ms, "plain_ms": plain_ham_ms},
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


def phase_full_vo(dev, records):
    import torch
    from gfplslam_torch.config import CameraParams, Config
    from gfplslam_torch.io import synthetic
    from gfplslam_torch.models.vo import run_vo_scan
    from gfplslam_torch.ops.fast import fast_score_cuda
    from gfplslam_torch.ops.hamming import hamming_cuda
    from gfplslam_torch.utils.trajectory import ate_rmse

    cfg = Config(camera=CameraParams())
    n = 48
    world = synthetic.make_world(n_frames=n, n_points=900, n_lines=90, seed=3,
                                 cam=cfg.camera)
    frames = [synthetic.render_frame(world, i, noise=1.5) for i in range(n)]

    def u8(imgs):  # the uint8 camera-byte contract of bench.py
        return np.clip(np.round(np.asarray(imgs)), 0, 255).astype(np.uint8)

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
            fast_score_cuda.launches = 0
            hamming_cuda.launches = 0
        t0 = time.perf_counter()
        poses, aux = run_vo_scan(cfg, imgs_l, imgs_r, ts, device=dev)
        torch.cuda.synchronize()
        samples.append(time.perf_counter() - t0)
        if rep == 0:
            launches = {"fast9_score": fast_score_cuda.launches,
                        "hamming_matrix": hamming_cuda.launches}
    expected = {"fast9_score": 2 * n, "hamming_matrix": 4 * n - 2}
    print(f"[full-vo] launches in one run: {launches} (expected {expected})")
    if launches != expected:
        _fail(f"kernel launch counts {launches} != expected {expected}")
    for r in records:
        r["launches"] = launches[r["name"]]

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
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
