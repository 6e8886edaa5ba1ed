"""The port's other entry points: the timed VO driver, the streaming
``run_slam --chunk`` and ``--vo-only --timing`` modes, ``batch_eval``, and
``acceptance``'s configurations against the reference's.

``TimedVO`` runs the ops of ``VisualOdometry`` in the same order, so its
trajectory must be equal, not close."""

import dataclasses
import json

import numpy as np
import torch

from gfplslam_tpu.apps import acceptance as ref_acceptance
from gfplslam_tpu.apps import run_slam as ref_run_slam

from gfplslam_torch.apps import acceptance, batch_eval, run_slam
from gfplslam_torch.config import (CameraParams, CapacityParams, Config,
                                   OrbParams)
from gfplslam_torch.io import synthetic
from gfplslam_torch.models.timed_vo import TimedVO
from gfplslam_torch.models.vo import VisualOdometry
from gfplslam_torch.utils import convert
from gfplslam_torch.utils.timing import FIELDS
from gfplslam_torch.utils.trajectory import read_tum

torch.set_num_threads(2)
CPU = torch.device("cpu")
SMALL = Config(cap=CapacityParams(n_pt=256, n_ln=128), orb=OrbParams(nlevels=2),
               camera=CameraParams(width=376, height=240, fx=217.6, fy=217.6,
                                   cx=183.7, cy=126.1, baseline=0.11))


def test_timed_vo_equals_vo():
    world = synthetic.make_world(n_frames=6, n_points=300, n_lines=40, seed=4)
    frames = [synthetic.render_frame(world, i, noise=1.0) for i in range(6)]
    runs = []
    for cls in (VisualOdometry, TimedVO):
        vo = cls(SMALL, device=CPU)
        for i, (il, ir) in enumerate(frames):
            vo.process(il, ir, world.timestamps[i])
        runs.append(vo)
    plain, timed = runs
    np.testing.assert_array_equal(timed.trajectory, plain.trajectory)
    assert [r.is_kf for r in timed.records] == [r.is_kf for r in plain.records]
    for a, b in zip(timed.timelog.rows, plain.timelog.rows):
        assert [getattr(a, f) for f in FIELDS if f.startswith("num")] == \
            [getattr(b, f) for f in FIELDS if f.startswith("num")]
    for row in timed.timelog.rows[1:]:
        assert all(getattr(row, f) > 0 for f in FIELDS if f.startswith("time"))


def _log(path):
    """(header fields, rows) of a ``_Log.txt``."""
    with open(path) as f:
        head = f.readline().split()[1:]
        return head, [ln.split() for ln in f if ln.strip()]


def test_run_slam_chunk_driver(tmp_path):
    """The streaming chunk driver, with a short last chunk: one row per
    frame done in each trajectory file, and the log the reference's
    ``run_slam --chunk`` writes on the same world: its header and, as the
    reference's chunked driver times no stage, no row."""
    out = str(tmp_path / "chunk")
    args = ["--synthetic", "--small", "--frames", "7", "--chunk", "4"]
    got, engine = run_slam.run(args + ["--device", "cpu", "-o", out])
    assert got["frames"] == 7 and not got["lost"] and got["keyframes"] >= 2
    assert got["ate_rmse"] < 0.08
    ts, _ = read_tum(out + "_AllFrameTrajectory.txt")
    kts, _ = read_tum(out + "_KeyFrameTrajectory.txt")
    assert len(ts) == 7 and len(kts) == got["keyframes"]
    ref_out = str(tmp_path / "ref")
    want = ref_run_slam.main(args + ["-o", ref_out])
    assert want["frames"] == got["frames"]
    head, rows = _log(out + "_Log.txt")
    ref_head, ref_rows = _log(ref_out + "_Log.txt")
    assert head == ref_head == list(FIELDS)
    assert np.asarray(rows, float).reshape(-1, len(head)).shape == \
        np.asarray(ref_rows, float).reshape(-1, len(ref_head)).shape
    assert rows == ref_rows


def test_run_slam_vo_only_timing(tmp_path):
    """VO-only with the per-stage TimeLog: every time_* field of every
    tracked frame is filled."""
    out = str(tmp_path / "vo")
    got = run_slam.main(["--synthetic", "--small", "--frames", "6", "--vo-only",
                         "--timing", "--device", "cpu", "-o", out])
    assert not got["lost"] and got["frames"] == 6 and "loop_closures" not in got
    rows = np.loadtxt(out + "_Log.txt", ndmin=2)
    assert rows.shape == (6, len(FIELDS))
    times = [i for i, f in enumerate(FIELDS) if f.startswith("time")]
    assert (rows[1:, times] > 0).all()
    ts, traj = read_tum(out + "_AllFrameTrajectory.txt")
    kts, _ = read_tum(out + "_KeyFrameTrajectory.txt")
    assert len(ts) == 6 and len(kts) == got["keyframes"] >= 1


def test_batch_eval_synthetic(tmp_path):
    rows = batch_eval.main(["--synthetic", "--sequences", "1", "--frames", "4",
                            "--device", "cpu", "-o", str(tmp_path)])
    assert len(rows) == 1 and rows[0]["frames"] == 4
    assert np.isfinite(rows[0]["ate_rmse"]) and rows[0]["accepted"] > 0.6
    ts, traj = read_tum(str(tmp_path / "synthetic_0_Trajectory.txt"))
    assert traj.shape == (4, 4, 4)
    with open(tmp_path / "summary.json") as f:
        assert json.load(f) == rows


def _captured_configs(mod, monkeypatch, argv):
    """Run ``mod.main`` with its config runners replaced by recorders: the
    (kind, positional arguments) of each call, the device left out."""
    calls = []
    monkeypatch.setattr(mod, "vo_config",
                        lambda *a: calls.append(("vo", a[:5])) or [])
    monkeypatch.setattr(mod, "slam_config",
                        lambda *a: calls.append(("slam", a[:7])) or [])
    monkeypatch.setattr(mod, "dist_ba_config",
                        lambda *a: calls.append(("dist", a[:1])) or [])
    return calls, mod.main(argv)


def test_acceptance_configs_equal(tmp_path, monkeypatch):
    """The five configurations run with the reference's arguments; config
    5 (``dist_ba_config``) with the same seeds."""
    got, res = _captured_configs(acceptance, monkeypatch,
                                 ["-o", str(tmp_path / "p.json"), "--device", "cpu"])
    want, _ = _captured_configs(ref_acceptance, monkeypatch,
                                ["-o", str(tmp_path / "r.json")])
    assert len(got) == len(want) == 5
    for (kind, (cfg, *args)), (ref_kind, (ref_cfg, *ref_args)) in zip(got[:4], want[:4]):
        assert kind == ref_kind and args == ref_args
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            convert.config_from_ref(ref_cfg))
    assert got[4] == want[4] == ("dist", ([3, 11, 19],))
    assert "5_dist_ba" in res["configs"]


def test_acceptance_dist_ba_config_runs():
    """Config 5 at a small size: ``bench_dist_ba`` in a subprocess over 8
    gloo ranks on the CPU (no card here), the reference's row keys."""
    rows = acceptance.dist_ba_config([3], torch.device("cpu"), kfs=3, points=64,
                                     lines=16, iters=2, reps=1)
    assert len(rows) == 1 and "error" not in rows[0], rows
    assert rows[0]["device"] == "cpu"
    assert set(rows[0]["ms_per_iter"]) == {"1", "2", "4", "8"}
    assert rows[0]["scaling_efficiency"]["1"] == 1.0
