"""The comparison that decides ``correct`` fails the control and every
planted fault: a whole run on the CPU at a small size (the harness's look
for a card skipped), with the timed path broken underneath."""

import pytest
import torch

from slam_bench import plants
from slam_bench.run import run_cell
from slam_bench.tests.conftest import SMALL_LOOP, small_cell

# the small VO world (6 frames forward, 0.2 m): sound runs read an ATE of
# about 0.013 m, the frozen tracker about 0.07 m
LIMITS = {"frame_ate_m": 0.035, "fast_l0_px": 0, "hamming_entries": 0}
SEED = 2 ** 31 + 29


@pytest.fixture(scope="module")
def cell():
    return small_cell("euroc-vo-replay", 6, LIMITS)


def test_sound_run_is_correct(cell):
    _, numbers, result = run_cell(cell, SEED, 0.0, False, torch.device("cpu"))
    assert result["correct"], numbers
    assert list(result)[-1] == "checks"
    assert result["attempted"] == 6 and result["failed"] == 0


@pytest.mark.parametrize("plant,caught", [("control", "fast_l0_px"),
                                          ("frozen", "frame_ate_m"),
                                          ("half", "fast_l0_px"),
                                          ("altered", "hamming_entries")])
def test_control_and_faults_are_not_correct(cell, plant, caught):
    assert plant in plants.NAMES
    _, numbers, result = run_cell(cell, SEED, 0.0, False, torch.device("cpu"), plant=plant)
    assert not result["correct"]
    assert numbers[caught]["value"] > numbers[caught]["limit"], numbers


def test_a_traced_run_reads_the_same_numbers(cell):
    _, numbers, result = run_cell(cell, SEED, 0.0, True, torch.device("cpu"))
    assert result["correct"] and "window_s" in result["device"]
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("workload", ["kitti-live-frames", "euroc-slam-loop"])
def test_the_slam_cells(workload):
    limits = {"frame_ate_m": 1.0, "fast_l0_px": 0, "hamming_entries": 0}
    cell = small_cell(workload, 5, limits)
    _, numbers, result = run_cell(cell, SEED, 0.0, False, torch.device("cpu"))
    assert result["correct"], numbers
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    _, numbers, result = run_cell(cell, SEED, 0.0, False, torch.device("cpu"),
                                  plant="altered")
    assert not result["correct"] and numbers["hamming_entries"]["value"] > 0


# the port's small bench world that closes a loop (18 frames, seed 21): sound
# runs read an ATE of about 0.147 m, a BA objective ratio of about 0.91 and
# a pose-graph objective ratio of about 0.12; with the local BA frozen the
# first ratio reads 1, without the pose-graph solve the second reads 1
LOOP_LIMITS = {"frame_ate_m": 0.18, "ba_cost_ratio": 0.97, "pose_graph_ratio": 0.5,
               "loops_missed": 0, "fast_l0_px": 0, "hamming_entries": 0}


@pytest.fixture(scope="module")
def loop_cell():
    return small_cell("euroc-slam-loop", 18, LOOP_LIMITS, slam=SMALL_LOOP, chunk=8)


@pytest.mark.parametrize("plant,caught", [(None, None),
                                          ("ba_frozen", "ba_cost_ratio"),
                                          ("no_closure", "loops_missed"),
                                          ("no_pose_graph", "pose_graph_ratio")])
def test_the_back_end_faults_are_not_correct(loop_cell, plant, caught):
    assert plant is None or plant in plants.NAMES
    _, numbers, result = run_cell(loop_cell, 21, 0.0, False, torch.device("cpu"), plant=plant)
    assert result["correct"] == (plant is None), numbers
    if caught:
        assert numbers[caught]["value"] > numbers[caught]["limit"], numbers
