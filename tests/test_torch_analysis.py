"""The analysis apps (``simulate_linecut``, ``simulate_pl_loss``,
``assess``, ``ab_orb_pattern``) against the reference's at small sizes
(the functions they need: ``tests/test_torch_analysis_ops.py``).

Tolerances as each test states. Running ``ab_orb_pattern`` selects a
pattern in both packages (the reference's ``evaluate`` leaves it set), so
a fixture restores "orb" in both after every test and clears the
reference's compiled programs.
"""

import json

import numpy as np
import pytest
import torch

import jax

from gfplslam_tpu.apps import ab_orb_pattern as ref_ab
from gfplslam_tpu.apps import assess as ref_assess
from gfplslam_tpu.apps import simulate_linecut as ref_sim_linecut
from gfplslam_tpu.apps import simulate_pl_loss as ref_sim_pl_loss
from gfplslam_tpu.ops import orb as ref_orb

from gfplslam_torch.apps import ab_orb_pattern, assess, simulate_linecut, simulate_pl_loss
from gfplslam_torch.ops import orb
from gfplslam_torch.utils.timing import FIELDS, TimeLog, TimeLogWriter

torch.set_num_threads(2)
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def orb_pattern_restored():
    yield
    orb.set_pattern("orb")
    ref_orb.set_pattern("orb")
    jax.clear_caches()


def test_simulate_linecut_matches_reference(tmp_path):
    """``-n 10``: the same cuts (the log-det objective is reproducible,
    ROADMAP C), so the gaps agree to 1e-3 of the log-det scale; the port's
    ``main`` writes the landscape and summary."""
    got = simulate_linecut.main(["-n", "10", "-o", str(tmp_path / "port")] + CPU)
    want = ref_sim_linecut.main(["-n", "10", "-o", str(tmp_path / "ref")])
    assert got["rounds"] == want["rounds"] == 10
    for k in ("mean_gap", "p95_gap"):
        assert np.isfinite(got[k]) and abs(got[k] - want[k]) < 1e-3, (k, got, want)
    assert got["mean_gap"] > -1e-4
    assert (tmp_path / "port" / "linecut_landscape.png").is_file()
    assert json.loads((tmp_path / "port" / "summary.json").read_text()) == got


def test_simulate_pl_loss_matches_reference(tmp_path):
    """``-n 5 --grid 5``: both losses minimized at the true pose on the same
    axes, the curvature ratio within 1e-3 relative."""
    got = simulate_pl_loss.main(["-n", "5", "--grid", "5",
                                 "-o", str(tmp_path / "port")] + CPU)
    want = ref_sim_pl_loss.main(["-n", "5", "--grid", "5", "-o", str(tmp_path / "ref")])
    for k in ("rounds", "axes_min_at_true_pose_p2p", "axes_min_at_true_pose_p2l"):
        assert got[k] == want[k], k
    assert got["axes_min_at_true_pose_p2p"] == got["axes_min_at_true_pose_p2l"] == 6
    r, w = got["line_vs_point_curvature_ratio"], want["line_vs_point_curvature_ratio"]
    assert abs(r - w) < 1e-3 * abs(w)
    assert (tmp_path / "port" / "pl_loss_landscape.png").is_file()


def test_assess_matches_reference(tmp_path):
    """``--frames 3``: the front-end and tracker run as the reference's
    (stages held exactly by the frame and tracker tests), so the line and
    match statistics are equal and the endpoint and depth errors agree to
    1e-4 relative. The reprojection error is taken at the estimated pose,
    which the pose GN leaves millimetres apart (ROADMAP C): within 0.01 px
    (measured: 0.7056 against 0.7037)."""
    got = assess.main(["--frames", "3", "-o", str(tmp_path / "port")] + CPU)
    want = ref_assess.main(["--frames", "3", "-o", str(tmp_path / "ref")])
    assert got.keys() == want.keys()
    for k in ("line_recall", "match_precision"):
        assert got[k] == pytest.approx(want[k], abs=1e-9), k
    for k in ("line_endpoint_err_px", "pt_depth_relerr", "ln_depth_relerr"):
        assert got[k] == pytest.approx(want[k], rel=1e-4, abs=1e-6), k
    assert abs(got["reproj_err_px"] - want["reproj_err_px"]) < 0.01
    for name in ("line_detect.png", "stereo_error.png", "match_project.png"):
        assert (tmp_path / "port" / name).is_file()


def test_assess_timelog(tmp_path):
    """``--timelog`` on a written ``_Log.txt``: the same per-field means."""
    log = TimeLogWriter()
    rng = np.random.default_rng(6)
    for _ in range(5):
        log.append(TimeLog(**{f: (float(rng.uniform(1e-3, 5e-2)) if f.startswith("time")
                                  else int(rng.integers(0, 200))) for f in FIELDS}))
    path = str(tmp_path / "run_Log.txt")
    log.write(path)
    got = assess.main(["--timelog", path, "-o", str(tmp_path / "port")])
    want = ref_assess.main(["--timelog", path, "-o", str(tmp_path / "ref")])
    assert got.keys() == want.keys() == {"timing_ms"}
    for k, v in want["timing_ms"].items():
        assert got["timing_ms"][k] == pytest.approx(v, rel=1e-12)
    assert (tmp_path / "port" / "timing.png").is_file()


@pytest.mark.parametrize("pattern", ["random", "orb"])
def test_ab_orb_pattern_matches_reference(pattern):
    """3 frames per pattern: equal match counts and rates."""
    got = ab_orb_pattern.evaluate(pattern, n_frames=3, device="cpu")
    want = ref_ab.evaluate(pattern, n_frames=3)
    assert got == want
    assert got["stereo_matches"] > 0 and got["crossframe_matches"] > 0


def test_ab_orb_pattern_run_selects_orb_last(capsys):
    """``main`` reports both patterns, "random" first, and leaves the
    default pattern selected."""
    reports = ab_orb_pattern.main(["--frames", "2"] + CPU)
    assert [r["pattern"] for r in reports] == ["random", "orb"]
    assert orb.BRIEF_POOL is orb.ORB_POOL
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(ln) for ln in lines[-2:]] == reports
