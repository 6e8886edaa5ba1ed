"""``models.slam.SLAMSystem.run_sequence`` then ``finish()``: the
streaming chunk driver used for offline evaluation, a fresh engine per
sequence. The engine takes the host's uint8 frames and uploads them
itself, double-buffered, as a replay from host memory does."""

import time

from slam_bench.drivers._slam import result


def prepare(run):
    pass


def sequence(run):
    from gfplslam_torch.models.slam import SLAMSystem
    w = run.world
    t0 = time.perf_counter()
    s = SLAMSystem(run.cfg, device=run.device)
    s.run_sequence(w.left, w.right, w.ts, chunk=int(run.traffic["chunk"]))
    s.finish()
    return result(run, s, t0)
