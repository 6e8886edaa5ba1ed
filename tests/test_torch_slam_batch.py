"""Full SLAM over a batch of sequences split over ranks
(``parallel/batch.py::run_slam_batch``), the caller as rank 0 of a group
of spawned peers (``parallel/multihost.py::spawn_peers``), the tracer's
``batch.*`` spans brought to rank 0, and ``batch_eval --ranks``.

Two 12-frame textured loop worlds at the small rig and budgets of the
benchmark's CPU tests run as the benchmark's batch cell runs them: this
process is rank 0 of a gloo group with a spawned peer, one sequence each,
over three rounds of which the second is traced (under a profiler). Every
returned field of every round, and of the peer's last round, must equal,
bit for bit, what each sequence gives run alone through ``SLAMSystem``.
Every process runs one CPU thread, since the thread count changes the
order of the CPU's sums. The lone path holds to the JAX package through
the SLAM parity tests (``test_torch_slam.py``, ``test_torch_slam_loop.py``).

The test marked ``gpu`` does the same on a card with four ranks; on a
machine with a card and without JAX, run it with

    python -m pytest tests/test_torch_slam_batch.py -m gpu --noconftest -q
"""

import contextlib
import json
import operator
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from gfplslam_torch.apps import batch_eval
from gfplslam_torch.config import CameraParams, load_config
from gfplslam_torch.io import synthetic
from gfplslam_torch.models.slam import SLAMSystem
from gfplslam_torch.parallel import multihost, workers
from gfplslam_torch.parallel.batch import SlamBatch, run_slam_batch
from gfplslam_torch.utils import trace

CPU = torch.device("cpu")
N_FRAMES = 12
SEEDS = (5, 6)
SHORT = 4       # frames of the batch run with no group
CAM = dict(width=376, height=240, fx=217.6, fy=217.6, cx=183.7, cy=126.1,
           baseline=0.11)
# the benchmark harness's small budgets, loop-closure distances cut to a
# 12-frame loop's five keyframes
CFG = load_config({
    "cap": {"n_pt": 256, "n_ln": 128, "n_kf_window": 4, "n_kf_max": 32,
            "n_map_pt": 2048, "n_map_ln": 512, "n_obs_pt": 1024,
            "n_obs_ln": 256, "vocab_k": 128},
    "orb": {"nlevels": 2},
    "slam": {"max_kf_num_frames": 2, "max_iters_lba": 10, "lc_kf_dist": 2,
             "lc_kf_max_dist": 1, "lc_nkf_closest": 1},
}).replace(camera=CameraParams(**CAM))


def _alone(imgs_l, imgs_r, ts, device=CPU) -> dict:
    """One sequence through its own SLAMSystem: the fields of SlamBatch."""
    s = SLAMSystem(CFG, device=device)
    s.run_sequence(imgs_l, imgs_r, ts, chunk=24)
    s.finish()
    kf = s.keyframe_trajectory
    return dict(frame_poses=s.all_frame_trajectory, kf_poses=kf, n_kf=len(kf),
                kf_frames=s.kf_frame_ids[:len(kf)],
                accepted=[r.accepted for r in s.vo.records],
                is_kf=[r.is_kf for r in s.vo.records],
                n_loop_closures=s.n_loop_closures, lost=s.vo.lost)


# as the batch cell runs them: warm-up, traced, untraced
ROUNDS = (False, True, False)


def _worlds(seeds):
    il, ir, ts = [], [], []
    for seed in seeds:
        w = synthetic.make_world(n_frames=N_FRAMES, n_points=300, n_lines=40, seed=seed,
                                 motion="loop", textured=True)
        fr = [synthetic.render_frame(w, i, noise=1.0) for i in range(N_FRAMES)]
        il.append(np.stack([f[0] for f in fr]))
        ir.append(np.stack([f[1] for f in fr]))
        ts.append(w.timestamps)
    return np.stack(il), np.stack(ir), np.stack(ts)


def _rounds(il, ir, ts, n_ranks: int, device: torch.device):
    """``ROUNDS`` with this process as rank 0 of ``n_ranks`` ranks, the
    others spawned peers running ``workers.slam_batch``: rank 0's result of
    each round, its tracer's snapshot of the traced round, and the peers'
    results of the last round."""
    peers = multihost.spawn_peers(workers.slam_batch, n_ranks, CFG, il, ir, ts,
                                  device.type, 24, device=device.type)
    outs, snap = [], None
    for traced in ROUNDS:
        with peers.round(), (trace.profile_spans(device) if traced
                             else contextlib.nullcontext()):
            outs.append(run_slam_batch(CFG, il, ir, ts, dist.group.WORLD, device=device))
        if traced:
            snap = trace.snapshot()
            trace.reset()
    return outs, snap, peers.close()


@pytest.fixture(scope="module")
def batch():
    il, ir, ts = _worlds(SEEDS)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        alone = [_alone(il[s], ir[s], ts[s]) for s in range(len(SEEDS))]
        short = _alone(il[0, :SHORT], ir[0, :SHORT], ts[0, :SHORT])
        lone = run_slam_batch(CFG, il[:1, :SHORT], ir[:1, :SHORT], ts[:1, :SHORT],
                              device=CPU)
        rounds, snap, theirs = _rounds(il, ir, ts, 2, CPU)
    finally:
        torch.set_num_threads(threads)
    return dict(frames=(il, ir, ts), alone=alone, short=short, lone=lone,
                rounds=rounds, snap=snap, theirs=theirs)


def _equal(got: SlamBatch, s: int, want: dict, field: str) -> None:
    n = int(got.n_kf[s])
    value = got._asdict()[field][s]
    if field in ("kf_poses", "kf_frames"):
        pad = value[n:]
        assert (pad == (0 if field == "kf_poses" else -1)).all(), field
        value = value[:n]
    expect = torch.as_tensor(np.asarray(want[field]))
    assert value.dtype == expect.dtype, (field, value.dtype, expect.dtype)
    assert torch.equal(value, expect), field


def _every_rank_equals_each_sequence_alone(outs, alone, field):
    for out in outs:
        assert out.frame_poses.shape == (len(alone), N_FRAMES, 4, 4)
        assert out.kf_poses.shape[1] == int(out.n_kf.max())
        for s, want in enumerate(alone):
            _equal(out, s, want, field)


@pytest.mark.parametrize("field", SlamBatch._fields)
def test_every_rank_equals_each_sequence_alone(batch, field):
    """Rank 0 in each round, untraced and traced, and the peer in the last
    return the whole batch, in sequence order, each field bit-equal to the
    sequence's own SLAMSystem run."""
    assert len(batch["rounds"]) == len(ROUNDS) and len(batch["theirs"]) == 1
    outs = batch["rounds"] + batch["theirs"]
    _every_rank_equals_each_sequence_alone(outs, batch["alone"], field)


@pytest.mark.gpu
def test_on_the_card_every_round_equals_a_lone_session():
    """Four ranks sharing the card, over the same three rounds, each
    sequence twice; every field of every round bit-equal to a lone
    session on the card, the tracker's graphs replayed from the first
    round on."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    il, ir, ts = _worlds(SEEDS + SEEDS)
    alone = [_alone(il[s], ir[s], ts[s], dev) for s in range(len(il))]
    rounds, snap, theirs = _rounds(il, ir, ts, 4, dev)
    assert len(theirs) == 3 and {s.rank for s in snap.spans} == {0, 1, 2, 3}
    for field in SlamBatch._fields:
        _every_rank_equals_each_sequence_alone(rounds + theirs, alone, field)


@pytest.mark.parametrize("field", SlamBatch._fields)
def test_without_a_group_each_sequence_runs_alone(batch, field):
    """The lone path, on the first frames of the first sequence."""
    _equal(batch["lone"], 0, batch["short"], field)


def test_batch_spans_and_counters_reach_rank_0(batch, tmp_path):
    """Rank 0's snapshot of the traced round holds each rank's session and
    gather, tagged with the rank, and each rank's counts; the Chrome trace
    puts each rank's spans on a process track of its own."""
    snap = batch["snap"]
    for rank in (0, 1):
        mine = [s for s in snap.spans if s.rank == rank]
        assert [s.name for s in mine if s.name.startswith("batch.")] == [
            "batch.sequence", "batch.gather"]
        gather = next(s for s in mine if s.name == "batch.gather")
        assert gather.kind == "wait" and gather.parent == -1
        # the session's engine spans nest inside it, on the same rank
        seq = snap.spans.index(next(s for s in mine if s.name == "batch.sequence"))
        inner = [s for s in snap.spans if s.name == "slam.finish" and s.rank == rank]
        assert len(inner) == 1 and snap.ancestor(snap.spans.index(inner[0]),
                                                 "batch.sequence") == seq
    assert snap.series["batch.sessions"] == [1, 1]
    assert snap.series["batch.frames"] == [N_FRAMES, N_FRAMES]
    assert snap.counters["batch.sessions"] == 2
    assert snap.counters["batch.frames"] == 2 * N_FRAMES
    path = tmp_path / "batch.trace.json"
    trace.export_chrome(str(path), snap)
    events = json.loads(path.read_text())["traceEvents"]
    assert {(e["pid"], e["name"]) for e in events if e["name"].startswith("batch.")} == {
        (r, n) for r in (0, 1) for n in ("batch.sequence", "batch.gather")}


def test_sequences_that_do_not_split_evenly_raise(batch):
    il, ir, ts = batch["frames"]
    with pytest.raises(Exception, match="do not split evenly over 2 ranks"):
        multihost.launch(workers.slam_batch, 2, CFG, il[:1], ir[:1], ts[:1], "cpu",
                         device="cpu")


@pytest.mark.parametrize("when", ["in a round", "before joining"])
def test_a_failing_peer_raises_on_rank_0(monkeypatch, when):
    """A peer that raises ends the group, and rank 0 raises with its error
    at once, never waiting in a collective for it; afterwards this process
    is in no group."""
    t0 = time.monotonic()
    if when == "in a round":
        peers = multihost.spawn_peers(operator.truediv, 2, 1, 0, device="cpu")
        with pytest.raises(RuntimeError, match="ZeroDivisionError"):
            with peers.round():
                dist.barrier()
    else:
        # the peer cannot bind a card (this torch has no CUDA), rank 0 is told it can
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        with pytest.raises(RuntimeError, match="failed before joining"):
            multihost.spawn_peers(operator.add, 2, 1, 2, device="cuda")
    assert not dist.is_initialized()
    assert time.monotonic() - t0 < 60, "rank 0 waited for a peer that had failed"


def test_peers_run_once_per_round_and_return_their_last_result():
    """The peer sums its own tensor into every round's all_reduce, in
    place: 1 + 1, then 1 + 2."""
    peers = multihost.spawn_peers(dist.all_reduce, 2, torch.ones(1), device="cpu")
    for want in (2, 3):
        with peers.round():
            x = torch.ones(1)
            dist.all_reduce(x)
            assert x.item() == want
    assert peers.close() == [None]
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="ended already"):
        peers.close()


@pytest.mark.parametrize("slam", [True, False])
def test_batch_eval_splits_the_jobs_over_ranks(tmp_path, slam):
    """``--ranks 2``: each rank one repeat, as full SLAM with ``--slam``
    and as VO without."""
    rows = batch_eval.main(["--synthetic", "--sequences", "1", "--repeats", "2",
                            "--frames", "3", "--ranks", "2", "--device", "cpu",
                            "-o", str(tmp_path)] + (["--slam"] if slam else []))
    assert [r["repeat"] for r in rows] == [0, 1]
    for r in rows:
        assert r["frames"] == 3 and np.isfinite(r["ate_rmse"])
    if slam:
        assert [r["rank"] for r in rows] == [0, 1]
        for r in rows:
            assert r["keyframes"] >= 1 and not r["lost"] and r["accepted"] > 0.6
    else:
        assert all("fps" in r for r in rows)
    assert (tmp_path / "synthetic_0_Trajectory.txt").is_file()
    with open(tmp_path / "summary.json") as f:
        assert json.load(f) == rows
