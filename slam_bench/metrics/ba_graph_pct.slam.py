"""Share, in %, of the bundle adjustments' dispatched LM iterations in the
traced sequence (counter ``ba.iters_dispatched``) that ran as a CUDA
graph's replay (counter ``ba.graph_replays``). None where the program has
no such counter."""

from slam_bench.program_trace import snapshot


def read(run):
    snap = snapshot()
    if snap is None:
        return None
    from gfplslam_torch.utils import trace
    if "ba.graph_replays" not in trace.COUNTERS:
        return None
    sent = snap.counters.get("ba.iters_dispatched", 0)
    if not sent:
        return None
    return 100.0 * snap.counters.get("ba.graph_replays", 0) / sent
