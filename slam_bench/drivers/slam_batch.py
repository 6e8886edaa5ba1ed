"""``parallel/batch.py::run_slam_batch`` over ranks that share the card:
GF-PL-SLAM's batch evaluation (``batch_script/Run_EuRoC.py``: each
sequence N times through full SLAM) with the N repeats run together, one
per rank.

The harness's process is rank 0. At set-up the other
``traffic["ranks"] - 1`` ranks are spawned (``multihost.spawn_peers``) into
``slam_bench/peers.py::peer`` and join one gloo group with it. One round is one
``run_slam_batch`` call with one sequence per rank, every rank the window's
world, each session a fresh engine through ``run_sequence(chunk)`` and
``finish()``; rounds run back to back. The peers end when the run drops
its state.

Each rank's own work is witnessed in its own process. Every rank runs the
harness's taps (``taps.KernelTap``, the local-BA and pose-graph taps) and a
tap on ``SLAMSystem.finish`` that reads each engine the rank finished as
``drivers/_slam.py`` reads one. Rank 0 tells the peers each round which
FAST frames and Hamming launches run.py drew and whether the round keeps
its samples; after the round each peer sends rank 0 its launch counts, its
kept samples and its engines' readings. The peers' samples join rank 0's
taps, so ``fast_l0_px``, ``hamming_entries``, ``ba_cost_ratio`` and
``pose_graph_ratio`` judge every rank's kernels and solves.

``sequence(run)`` returns rank 0's sequence and appends the other ranks'
to ``run.seqs``, so ``frame_ate_m`` and ``loops_missed`` judge every
session and ``slam_fps`` counts every rank's frames. Each session is
first held to the one its rank was seen to run: the program's answer for
session ``s`` must equal, field for field, the one engine that rank ``s``
finished in the round, and that rank's FAST tap must have counted one
level-0 launch per frame. A session that fails this shows nothing: its
frame poses read NaN, so ``frame_ate_m`` reads inf, as ``checks.py`` reads
an empty sample, and it counts as closing no loop. ``run.py`` calls
``sequence`` once as its warm-up before the window, and the warm-up's
other sequences are not kept. Every sequence of a round carries the
round's seconds.

What rank 0's trace cannot see: the other processes' kernels. The
profiler of a traced round runs in rank 0's process and records its
device work alone, so a device reading of this cell (``device_idle.slam``)
and its peak memory are rank 0's process. The other ranks run that round
under profilers of their own, so that every rank pays the profiler's
cost, and send their spans and counters to rank 0's tracer, which the
``batch_*.batch`` and ``ba_*.slam`` readers read.

The traced round's other sequences are appended with the next round's, so
a traced window holds at least one untraced round, as ``run.py`` means:
``mapping_ms.slam`` reads rank 0's mapping steps there.
"""

import contextlib
import sys
import time
import types

import numpy as np

from slam_bench import peers as peer_rank
from slam_bench.window import Sequence, lost_frames

def prepare(run):
    # imported here, before any rank is spawned: a program without it
    # fails at once, with nothing left running
    from gfplslam_torch.parallel.batch import run_slam_batch  # noqa: F401
    from gfplslam_torch.parallel import multihost
    n = int(run.traffic["ranks"])
    w = run.world
    batch = tuple(np.ascontiguousarray(np.broadcast_to(x, (n,) + x.shape))
                  for x in (w.left, w.right, w.ts))
    run.state.update(batch=batch, rounds=0, held=[])
    if n > 1:
        run.state["peers"] = multihost.spawn_peers(
            peer_rank.peer, n, run.cfg, *batch, run.device.type, int(run.traffic["chunk"]),
            device=run.device)


def _sequence(run, out, s: int, seconds: float) -> Sequence:
    """Session ``s`` of the round's results, as ``drivers/_slam.py`` reads
    one engine."""
    frames = out.frame_poses[s].numpy().astype(np.float64)
    n_kf = int(out.n_kf[s])
    failed = lost_frames(out.accepted[s].tolist(), run.cfg.slam.max_num_frame_loss)
    return Sequence(frames=len(frames), tracked=len(frames) - 1,
                    failed=max(failed, int(out.lost[s])), frame_poses=frames,
                    is_kf=out.is_kf[s].tolist(),
                    kf_poses=out.kf_poses[s, :n_kf].numpy().astype(np.float64),
                    kf_frames=out.kf_frames[s, :n_kf].tolist(),
                    closures=int(out.n_loop_closures[s]), seconds=seconds)


def _fields(s: Sequence) -> tuple:
    return (s.frames, s.failed, s.closures, [bool(x) for x in s.is_kf],
            [int(x) for x in s.kf_frames])


def unheld(answer: Sequence, seen: dict) -> str | None:
    """Why the program's ``answer`` for a session is not the session its
    rank was ``seen`` to run, or None where it is."""
    if len(seen["sessions"]) != 1:
        return f"its rank finished {len(seen['sessions'])} engines in the round, not 1"
    if seen["fast_l0"] != answer.frames:
        return (f"its rank launched level-0 FAST {seen['fast_l0']} times for "
                f"{answer.frames} frames")
    own = seen["sessions"][0]
    if _fields(own) != _fields(answer):
        return "its frame count, lost frames, closures or keyframes differ from its rank's engine"
    for name in ("frame_poses", "kf_poses"):
        if not np.array_equal(getattr(own, name), getattr(answer, name)):
            return f"its {name} differ from its rank's engine"
    return None


def sequence(run):
    import torch.distributed as dist

    from gfplslam_torch.parallel import batch
    peers, k = run.state.get("peers"), run.kernels
    sample = (k.capture, set(k.fast_pick), set(k.ham_pick))
    engines = peer_rank.EngineTap(run.cfg)
    t0 = time.perf_counter()
    with peers.round() if peers else contextlib.nullcontext():
        if peers:
            dist.broadcast_object_list([sample], src=0)
        try:
            out = batch.run_slam_batch(run.cfg, *run.state["batch"],
                                       dist.group.WORLD if peers else None,
                                       chunk=int(run.traffic["chunk"]), device=run.device)
        finally:
            engines.close()
        seconds = time.perf_counter() - t0
        seen = [dict(fast_l0=k.fast_l0, sessions=engines.readings())]
        if peers:
            got = [None] * peers.n_ranks
            dist.gather_object(None, got, dst=0)
            seen += got[1:]
    seqs = [_sequence(run, out, s, seconds) for s in range(len(out.n_kf))]
    if len(seen) != len(seqs):
        raise RuntimeError(f"{len(seqs)} sessions from {len(seen)} ranks")
    for s, (seq, own) in enumerate(zip(seqs, seen)):
        why = unheld(seq, own)
        if why:
            print(f"[slam_bench] session {s} of round {run.state['rounds']} is not the "
                  f"one rank {s} ran: {why}; it shows nothing", file=sys.stderr, flush=True)
            seq.frame_poses = np.full_like(seq.frame_poses, np.nan)
            seq.closures = 0
    for own in seen[1:]:
        if "fast_kept" in own:
            k.fast_kept += own["fast_kept"]
            k.ham_kept += own["ham_kept"]
            run.ba.kept += own["ba_kept"]
            run.pgo.kept += own["pgo_kept"]
    rounds = run.state["rounds"]
    run.state["rounds"] += 1
    if rounds:
        # run.py records launch shapes in its traced sequence alone
        if k.shapes is not None:
            run.state["held"] = seqs[1:]
        else:
            run.seqs.extend(run.state["held"] + seqs[1:])
            run.state["held"] = []
    return seqs[0]
