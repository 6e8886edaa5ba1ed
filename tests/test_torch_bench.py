"""The port's benchmark, ``gfplslam_torch/apps/bench.py``, against the root
``bench.py`` it stands for: the same worlds to the byte, the same keys in
its last line (plus ``device`` and ``samples``), a small CPU run end to end
with its gates, the BA's ms per iteration over the iterations the port
executes, and no silent CPU fallback.

The root ``bench.py`` is read as source (``ast``), never imported: importing
it runs nothing, but its ``main`` is the JAX engine's.

``PYTHONPATH=. JAX_PLATFORMS=cpu python -m tests.test_torch_bench`` records
the reference's trajectory on bench.py's KITTI world
(``tests/data/bench_kitti_reference_poses.npy``, ~1 min), which the bench's
full preset holds the port to there."""

import ast
import json
import multiprocessing
import os
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from gfplslam_tpu.config import CameraParams as RefCameraParams
from gfplslam_tpu.config import Config as RefConfig
from gfplslam_tpu.config import SlamParams as RefSlamParams
from gfplslam_tpu.io import synthetic as ref_synthetic

from gfplslam_torch.apps import bench, bench_dist_ba
from gfplslam_torch.models import ba_core
from gfplslam_torch.utils import convert
from gfplslam_torch.utils.trajectory import ate_rmse

REPO = Path(__file__).resolve().parents[1]
BENCH_PY = REPO / "bench.py"
CPU = torch.device("cpu")
FIRST = 3   # frames of each world compared
KITTI_REFERENCE = bench.REFERENCE_DIR / bench.FULL.kitti_reference
# the reference's ATE on that world when its trajectory was recorded
KITTI_REFERENCE_ATE = 0.05899
KITTI_CAM = RefCameraParams(width=1241, height=376, fx=718.856, fy=718.856,
                            cx=607.1928, cy=185.2157, baseline=0.537165719)


def _u8(imgs):
    """bench.py's ``_u8``."""
    return np.clip(np.round(np.asarray(imgs)), 0, 255).astype(np.uint8)


def _reference_worlds():
    """What bench.py feeds the reference, built as bench.py builds it:
    (world, noise, timestamps as handed to the engine) by section."""
    cam = RefCameraParams()
    euroc = ref_synthetic.make_world(n_frames=48, n_points=900, n_lines=90,
                                     seed=3, cam=cam)
    circuit = ref_synthetic.make_world(n_frames=121, n_points=900, n_lines=90,
                                       seed=11, motion="circuit", cam=cam,
                                       textured=True)
    kitti = ref_synthetic.make_world(n_frames=16, n_points=900, n_lines=90,
                                     seed=7, cam=KITTI_CAM, motion="forward")
    return {"vo": (euroc, 1.5, euroc.timestamps.astype(np.float32)),
            "slam": (circuit, 1.0, np.asarray(circuit.timestamps)),
            "kitti": (kitti, 1.5, kitti.timestamps.astype(np.float32))}


def _bench_py_result_keys():
    """The keys of the dict bench.py prints, and of its ``compile_s``."""
    tree = ast.parse(BENCH_PY.read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "dumps"):
            d = node.args[0]
            keys = {k.value: v for k, v in zip(d.keys, d.values)}
            return keys, {k.value for k in keys["compile_s"].keys}
    raise AssertionError("no json.dumps call in bench.py")


def test_worlds_are_bench_pys():
    """The first frames of the three worlds, byte for byte, their
    timestamps (values and dtype) and ground truth, and the two Configs."""
    ref = _reference_worlds()
    jobs = [(w, i, noise) for w, noise, _ in ref.values() for i in range(FIRST)]
    # the reference's frames render while the port's pool renders its own
    with ProcessPoolExecutor(3, mp_context=multiprocessing.get_context("spawn")) as ex:
        pending = ex.map(ref_synthetic.render_frame, *zip(*jobs))
        port = bench.world_arrays(bench.FULL, frames=FIRST)
        frames = list(pending)
    for k, (name, (world, _, ts)) in enumerate(ref.items()):
        got = port[name]
        pairs = frames[k * FIRST:(k + 1) * FIRST]
        for side in (0, 1):
            want = _u8(np.stack([p[side] for p in pairs]))
            assert got[side].dtype == np.uint8 and got[side].shape == want.shape
            np.testing.assert_array_equal(got[side], want, err_msg=f"{name} side {side}")
        assert got.ts.dtype == ts.dtype, name
        np.testing.assert_array_equal(got.ts, ts[:FIRST], err_msg=name)
        np.testing.assert_array_equal(got.poses, world.poses[:FIRST], err_msg=name)
    assert bench.FULL.cfg == convert.config_from_ref(RefConfig(
        camera=RefCameraParams(), slam=RefSlamParams(lc_kf_dist=12, lc_kf_max_dist=6)))
    assert bench.FULL.kitti_cfg == convert.config_from_ref(RefConfig(camera=KITTI_CAM))


@pytest.fixture(scope="module")
def small_run():
    """``python -m gfplslam_torch.apps.bench --device cpu --small --reps 1``
    from the repo root, on two CPU threads as the other port tests use:
    with one thread per core, a loaded machine stalls its OpenMP regions
    (over 200 s beside six busy processes, 65 s on two threads)."""
    return subprocess.run(
        [sys.executable, "-m", "gfplslam_torch.apps.bench", "--device", "cpu",
         "--small", "--reps", "1"], cwd=REPO, capture_output=True, text=True,
        env=dict(os.environ, OMP_NUM_THREADS="2"), timeout=600)


def test_small_cpu_run_passes_its_gates(small_run):
    assert small_run.returncode == 0, small_run.stdout + small_run.stderr
    lines = small_run.stdout.strip().splitlines()
    out = json.loads(lines[-1])
    assert out["metric"] == "euroc_stereo_vo_frames_per_s_per_chip"
    assert out["unit"] == "frames/s" and out["device"] == {"name": "cpu",
                                                          "power_limit": None}
    for key in ("value", "full_slam_fps", "slam_per_frame_fps", "kf_mapping_ms",
                "ba_ms_per_iter", "kitti_vo_fps"):
        assert np.isfinite(out[key]) and out[key] > 0, key
    assert out["n_loop_closures"] >= 1
    assert out["ate_rmse"] < out["ate_rmse_no_lc"]
    assert out["slam_keyframes"] >= 2 and out["kf_interval_frames"] >= 1.0
    assert out["compile_s"]["kernels_build"] is None
    assert all(len(v) == 1 for v in out["samples"].values())
    # every section counted its launches against the design: none on the CPU
    counted = [ln for ln in lines if ": launches " in ln]
    assert len(counted) == 6
    assert all(ln.endswith('{"fast9_score": 0, "hamming_matrix": 0}') for ln in counted)
    assert all(ln.count('{"fast9_score": 0, "hamming_matrix": 0}') == 2 for ln in counted)


def test_last_line_has_bench_pys_keys(small_run):
    keys, compile_keys = _bench_py_result_keys()
    out = json.loads(small_run.stdout.strip().splitlines()[-1])
    assert set(out) == set(keys) | {"device", "samples"}
    assert set(out["compile_s"]) == compile_keys | {"kernels_build"}
    assert out["metric"] == keys["metric"].value


def test_ba_divides_by_the_iterations_executed(monkeypatch):
    """On a tiny problem whose LM converges after 19 iterations, each solve
    of ``max_iters=30`` runs 30 iterations (one Schur reduction each) and the
    time per iteration is the solve's over 30, not over the converged
    count."""
    from gfplslam_torch.config import CameraParams
    cam = CameraParams()
    prob = bench_dist_ba.make_problem(3, 48, 8, cam, seed=1)
    reductions = []
    schur_reduce = ba_core.schur_reduce

    def counting(*a, **kw):
        reductions.append(1)
        return schur_reduce(*a, **kw)

    monkeypatch.setattr(ba_core, "schur_reduce", counting)
    monkeypatch.setattr(bench, "_timed", lambda device, fn: (fn(), 0.6))
    out = bench.time_ba(cam, prob, CPU, reps=2, max_iters=30)
    assert len(reductions) == 3 * 30          # warm-up + 2 solves
    assert 1 <= out["converged_iters"] < 30
    assert out["iters"] == 30
    assert out["ms_per_iter"] == [0.6 / 30 * 1e3] * 2


def test_no_card_raises_naming_the_cpu_option(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        bench.main([])


def test_imports_neither_jax_nor_the_reference():
    tree = ast.parse((REPO / "gfplslam_torch" / "apps" / "bench.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert names and not [m for m in names
                          if m.split(".")[0] in ("jax", "jaxlib", "gfplslam_tpu", "bench")]


def test_kitti_reference_trajectory_is_this_worlds():
    """The recorded reference trajectory belongs to bench.py's KITTI world:
    one pose per frame, frame 0 at the origin, and the reference's ATE
    against that world's ground truth as recorded (9.8% of its path)."""
    world = _reference_worlds()["kitti"][0]
    traj = np.load(KITTI_REFERENCE)
    assert traj.shape == world.poses.shape and np.isfinite(traj).all()
    np.testing.assert_allclose(traj[0], np.eye(4), atol=1e-6)
    assert ate_rmse(traj, world.poses) == pytest.approx(KITTI_REFERENCE_ATE, abs=5e-5)


def record_reference():
    """The reference's ``run_vo_scan`` on bench.py's KITTI world, as bench.py
    calls it, saved as the trajectory the port's full bench is held to."""
    import jax.numpy as jnp

    from gfplslam_tpu.models.vo import run_vo_scan
    world, noise, ts = _reference_worlds()["kitti"]
    n = len(world.poses)
    with ProcessPoolExecutor(8, mp_context=multiprocessing.get_context("spawn")) as ex:
        frames = list(ex.map(ref_synthetic.render_frame, [world] * n, range(n),
                             [noise] * n))
    t0 = time.perf_counter()
    poses, aux = run_vo_scan(RefConfig(camera=KITTI_CAM),
                             *(jnp.asarray(_u8(np.stack([f[k] for f in frames])))
                               for k in (0, 1)), jnp.asarray(ts))
    traj = np.asarray(poses, np.float64)
    np.save(KITTI_REFERENCE, traj)
    print(f"wrote {KITTI_REFERENCE}: {traj.shape}, accepted "
          f"{float(np.asarray(aux['accepted']).mean()):.3f}, keyframes "
          f"{int(np.asarray(aux['is_kf']).sum())}, ATE {ate_rmse(traj, world.poses):.5f} m, "
          f"{time.perf_counter() - t0:.0f} s", file=sys.stderr)


if __name__ == "__main__":
    record_reference()
