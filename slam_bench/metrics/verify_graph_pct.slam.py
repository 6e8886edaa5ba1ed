"""Share, in %, of the traced sequence's loop verifications (its
``loop.verify`` spans) whose matching and pose solve ran as a CUDA graph's
replay (counter ``verify.graph_replays``). None where the program has no
such counter."""

from slam_bench.program_trace import snapshot


def read(run):
    snap = snapshot()
    if snap is None:
        return None
    from gfplslam_torch.utils import trace
    if "verify.graph_replays" not in trace.COUNTERS:
        return None
    verifications = len(snap.ms("loop.verify"))
    if not verifications:
        return None
    return 100.0 * snap.counters.get("verify.graph_replays", 0) / verifications
