"""``apps/run_slam.py``, the port's main entry point, against the
reference's, and its other modes in the port alone.

The same arguments (``--synthetic --small --frames 8``) go to both
``main`` functions, the port's with ``--device cpu``. Keyframes and the
lost flag must be equal; the all-frame trajectories agree to 0.08 m ATE
of one against the other (ROADMAP C: the pose GN stops before
convergence, so last-ulp differences move poses by centimetres; the
reference's own two VO drivers differ by 0.046 m)."""

import json
import os

import numpy as np
import torch

from gfplslam_tpu.apps import run_slam as ref_run_slam

from gfplslam_torch.apps import run_slam
from gfplslam_torch.utils.timing import FIELDS
from gfplslam_torch.utils.trajectory import ate_rmse, read_tum

torch.set_num_threads(2)
ARGS = ["--synthetic", "--small", "--frames", "8"]
OUTPUTS = ("_AllFrameTrajectory.txt", "_KeyFrameTrajectory.txt", "_Log.txt")


def _log_rows(path):
    with open(path) as f:
        head = f.readline().split()[1:]
        rows = [dict(zip(head, map(float, ln.split()))) for ln in f if ln.strip()]
    assert head == list(FIELDS)
    return rows


def test_run_slam_matches_reference(tmp_path, capsys):
    got = run_slam.main(ARGS + ["--device", "cpu", "-o", str(tmp_path / "port")])
    want = ref_run_slam.main(ARGS + ["-o", str(tmp_path / "ref")])
    for key in ("frames", "keyframes", "lost", "loop_closures", "counters"):
        assert got[key] == want[key], key
    for suffix in OUTPUTS:
        assert os.path.isfile(tmp_path / f"port{suffix}")
    ts_p, traj_p = read_tum(str(tmp_path / "port_AllFrameTrajectory.txt"))
    ts_r, traj_r = read_tum(str(tmp_path / "ref_AllFrameTrajectory.txt"))
    np.testing.assert_array_equal(ts_p, ts_r)
    assert ate_rmse(traj_p, traj_r) < 0.08
    kts_p, _ = read_tum(str(tmp_path / "port_KeyFrameTrajectory.txt"))
    kts_r, _ = read_tum(str(tmp_path / "ref_KeyFrameTrajectory.txt"))
    np.testing.assert_array_equal(kts_p, kts_r)
    assert len(_log_rows(tmp_path / "port_Log.txt")) == got["frames"]
    assert got["ate_rmse"] < 0.08
    # the summary line is the last line printed, as JSON
    last = capsys.readouterr().out.strip().splitlines()
    assert json.loads(last[0]) == got and json.loads(last[-1]) == want


def test_run_slam_multihost_is_refused(tmp_path, monkeypatch):
    """``--multihost`` is no longer refused (the name dates from when it
    raised): with no coordinator in the environment it joins no group and
    runs on this process."""
    import torch.distributed as dist
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                 "JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
                 "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    got = run_slam.main(ARGS + ["--multihost", "--device", "cpu", "--vo-only",
                                "-o", str(tmp_path / "x")])
    assert got["frames"] == 8 and not got["lost"]
    assert not dist.is_initialized()
