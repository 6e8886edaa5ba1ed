"""Share, in %, of the traced sequence's tracked frames (its ``vo.track``
spans) whose tracker step ran as a CUDA graph's replay (counter
``track.graph_replays``). None where the program has no such counter."""

from slam_bench.program_trace import snapshot


def read(run):
    snap = snapshot()
    if snap is None:
        return None
    from gfplslam_torch.utils import trace
    if "track.graph_replays" not in trace.COUNTERS:
        return None
    frames = len(snap.ms("vo.track"))
    if not frames:
        return None
    return 100.0 * snap.counters.get("track.graph_replays", 0) / frames
