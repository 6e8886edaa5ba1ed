"""The cells ``euroc-batch4-slam-loop`` and ``kitti-vo-replay``: they
resolve, the batch driver is taken up by name, the batch readers read a
multi-rank span table, a traced window of each prints its per-layer
metrics, and the batch cell holds every rank to the session it was seen to
run: a program that runs rank 0's session alone and copies it into the
other ranks' places is not ``correct``.

The batch cell runs here on two gloo ranks on the CPU, at the small rig
and budgets of ``conftest.py``."""

import dataclasses
import json
import shutil

import pytest
import torch

from slam_bench import peers, program_trace, registry
from slam_bench.run import run_cell
from slam_bench.tests.conftest import SMALL_LOOP, small_cell

trace = pytest.importorskip("gfplslam_torch.utils.trace")
SEED = 2 ** 31 + 41
BATCH = "euroc-batch4-slam-loop"
# the small loop world of test_harness_faults.py (18 frames, seed 21), whose
# sound sessions close the loop
LOOP_LIMITS = {"frame_ate_m": 0.18, "ba_cost_ratio": 0.97, "pose_graph_ratio": 0.5,
               "loops_missed": 0, "fast_l0_px": 0, "hamming_entries": 0}


@pytest.mark.parametrize("workload,config,driver", [
    (BATCH, "euroc-batch4", "slam_batch"),
    ("kitti-vo-replay", "kitti-stereo", "vo_scan")])
def test_the_added_cells_resolve(bench, workload, config, driver):
    """The batch cell keeps euroc-stereo's rig, budgets and cuts and
    slam-loop's world and limits; the KITTI replay keeps the live cell's
    world but its timestamps."""
    cell = registry.load_cell(workload, bench)
    assert cell.config["name"] == config and cell.traffic["driver"] == driver
    assert cell.chips == 1
    if config == "euroc-batch4":
        euroc = registry.data("configs", "euroc-stereo")
        for key in ("camera", "engine", "budgets", "reduced"):
            assert cell.config[key] == euroc[key], key
        assert cell.config["sessions"] == cell.traffic["ranks"] == 4
        assert cell.traffic["world"] == registry.data("traffic", "slam-loop")["world"]
        assert cell.limits == registry.data("limits", "euroc-slam-loop")
        assert [m["name"] for m in cell.per_layer] == [
            "device_idle.slam", "mapping_ms.slam", "ba_iter_ms.slam", "ba_idle_iters.slam",
            "batch_session_ms.batch", "batch_gather_pct.batch"]
    else:
        live = registry.data("traffic", "live-forward-frames")["world"]
        assert cell.traffic["world"] == dict(live, ts_dtype="float32")
        assert {m["name"] for m in cell.end_to_end} == {"vo_fps", "setup_s"}


def test_the_batch_driver_is_taken_up_without_an_edit(tmp_path, bench):
    """A traffic file that names ``slam_batch`` resolves to its module,
    found by name, in a copy of the harness's files."""
    root = tmp_path / "slam_bench"
    for kind in registry.KINDS:
        shutil.copytree(registry.HERE / kind, root / kind)
    (root / "traffic" / "batch2-slam-loop.json").write_text(json.dumps(
        dict(registry.data("traffic", "batch4-slam-loop"), ranks=2)))
    (root / "limits" / "euroc-batch2-slam-loop.json").write_text(json.dumps(
        registry.data("limits", BATCH)))
    added = dict(bench, workloads=bench["workloads"] + [
        {"name": "euroc-batch2-slam-loop", "config": "euroc-batch4",
         "traffic": "batch2-slam-loop", "chips": 1, "why": "a test"}])
    cell = registry.load_cell("euroc-batch2-slam-loop", added, root)
    assert cell.traffic["ranks"] == 2
    driver = registry.module("drivers", cell.traffic["driver"], root)
    assert callable(driver.prepare) and callable(driver.sequence)


def _span(name, t0, t1, parent, kind="span", rank=0):
    return trace.Span(name, kind, int(t0 * 1e6), int(t1 * 1e6), parent, None, rank)


def _batch_snapshot():
    """One round of three ranks, times in ms: rank 0 two sessions (100 and
    140 ms) then a 10 ms gather, rank 1 one session of 200 ms and a 50 ms
    gather, rank 2 one of 230 ms and a 20 ms gather; a span inside a
    session, as the engine's are."""
    s = [_span("batch.sequence", 0, 100, -1),                         # 0
         _span("slam.process_scanned", 10, 20, 0),                    # 1
         _span("batch.sequence", 100, 240, -1),                       # 2
         _span("batch.gather", 240, 250, -1, "wait"),                 # 3
         _span("batch.sequence", 5, 205, -1, rank=1),                 # 4
         _span("batch.gather", 205, 255, -1, "wait", rank=1),         # 5
         _span("batch.sequence", 2, 232, -1, rank=2),                 # 6
         _span("batch.gather", 232, 252, -1, "wait", rank=2)]         # 7
    c = {"batch.sessions": 4, "batch.frames": 160}
    return trace.Snapshot(spans=s, counters=c, series={k: [v] for k, v in c.items()})


def _one_rank_snapshot():
    s = [_span("slam.process_scanned", 0, 10, -1)]
    return trace.Snapshot(spans=s, counters={}, series={})


def test_the_batch_readers_on_a_hand_made_multi_rank_snapshot(monkeypatch):
    """The median session over every rank's (100, 140, 200, 230 ms); the
    gathers (10 + 50 + 20 ms) over the ranks' rounds (250 + 250 + 250 ms)."""
    monkeypatch.setattr(program_trace, "snapshot", _batch_snapshot)
    session = registry.module("metrics", "batch_session_ms.batch")
    gather = registry.module("metrics", "batch_gather_pct.batch")
    assert session.read(None) == pytest.approx(170.0)
    assert gather.read(None) == pytest.approx(100.0 * 80 / 750)
    monkeypatch.setattr(program_trace, "snapshot", _one_rank_snapshot)
    assert session.read(None) is None and gather.read(None) is None
    monkeypatch.setattr(program_trace, "snapshot", lambda: None)
    assert session.read(None) is None and gather.read(None) is None


def _two_ranks(cell):
    """The cell on two ranks, one CPU thread each."""
    return dataclasses.replace(cell, traffic=dict(cell.traffic, ranks=2))


@pytest.mark.parametrize("workload,n,slam,metrics", [
    (BATCH, 9, SMALL_LOOP, ["batch_session_ms.batch", "batch_gather_pct.batch",
                            "ba_iter_ms.slam", "ba_idle_iters.slam", "mapping_ms.slam"]),
    ("kitti-vo-replay", 6, None, ["frontend_ms.vo", "track_ms.vo",
                                  "pose_opt_idle_iters.vo"])])
def test_a_traced_window_of_an_added_cell_prints_its_metrics(workload, n, slam, metrics):
    cell = small_cell(workload, n, slam=slam)
    if workload == BATCH:
        cell = _two_ranks(cell)
    assert {m["name"] for m in cell.per_layer} >= set(metrics)
    trace.reset()
    try:
        _, _, result = run_cell(cell, SEED, 0.0, True, torch.device("cpu"))
    finally:
        trace.reset()
    for name in metrics:
        assert name in result["metrics"], (name, sorted(result["metrics"]))
        assert result["metrics"][name]["value"] >= 0


# --- each rank held to the session it ran -------------------------------

_ORIGINAL: dict = {}


def _copied(cfg, imgs_l, imgs_r, timestamps, group=None, *, chunk=24, device=None):
    """The fault: rank 0 runs the batch's first sequence alone, and every
    rank returns it in every sequence's place; the other ranks run none."""
    import torch.distributed as dist

    from gfplslam_torch.parallel.batch import SlamBatch
    one = [_ORIGINAL["run"](cfg, imgs_l[:1], imgs_r[:1], timestamps[:1], chunk=chunk,
                            device=device) if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(one, src=0)
    return SlamBatch(*(x.expand(len(imgs_l), *x.shape[1:]).clone() for x in one[0]))


def _install_copy():
    from gfplslam_torch.parallel import batch
    _ORIGINAL.setdefault("run", batch.run_slam_batch)
    batch.run_slam_batch = _copied


def copying_peer(*args):
    """A peer whose program has the fault."""
    _install_copy()
    return peers.peer(*args)


@pytest.mark.parametrize("fault", [None, "copied"])
def test_each_rank_is_held_to_the_session_it_ran(monkeypatch, fault):
    from gfplslam_torch.parallel import batch
    cell = _two_ranks(small_cell(BATCH, 18, LOOP_LIMITS, slam=SMALL_LOOP, chunk=8))
    if fault:
        _ORIGINAL["run"] = batch.run_slam_batch
        monkeypatch.setattr(batch, "run_slam_batch", _copied)
        monkeypatch.setattr(peers, "peer", copying_peer)
    run, numbers, result = run_cell(cell, 21, 0.0, False, torch.device("cpu"))
    assert len(run.seqs) == 2 and result["attempted"] == 36
    if not fault:
        assert result["correct"], numbers
        # the peer's kernels and solves were judged beside rank 0's
        assert len(run.kernels.fast_kept) == 2 * 3
        assert len({id(p) for _, (p, _) in run.ba.kept}) == len(run.ba.kept) > 2
        return
    assert not result["correct"]
    assert numbers["frame_ate_m"]["value"] == float("inf"), numbers
    assert numbers["loops_missed"]["value"] == 1, numbers
