"""Share, in %, of the traced round's rank time lost to the slowest rank:
100 x the ms of the ``batch.gather`` waits summed over the ranks, over
each rank's round (its first ``batch.sequence`` start to its
``batch.gather`` end) summed over the ranks. None where the program
records no gather."""

from slam_bench import program_trace


def read(run):
    snap = program_trace.snapshot()
    if snap is None:
        return None
    rounds, gathers = {}, []
    for s in snap.spans:
        if s.name not in ("batch.sequence", "batch.gather"):
            continue
        rank = getattr(s, "rank", 0)
        lo, hi = rounds.get(rank, (s.start_ns, s.end_ns))
        rounds[rank] = (min(lo, s.start_ns), max(hi, s.end_ns))
        if s.name == "batch.gather":
            gathers.append(s.ms)
    round_ms = sum(hi - lo for lo, hi in rounds.values()) * 1e-6
    if not gathers or not round_ms:
        return None
    return 100.0 * sum(gathers) / round_ms
