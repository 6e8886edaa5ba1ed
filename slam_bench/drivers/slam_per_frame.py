"""One ``SLAMSystem.process`` call per frame, the frames handed over from
host memory as a camera driver hands them (uint8 pairs), with
asynchronous mapping and loop closure on, then ``finish()``; a fresh
engine per sequence. The per-frame path of ``apps/run_slam.py`` at its
default ``--chunk 0``, without the file loader.

Each frame's latency runs from handing the pair to ``process`` to its
return, which holds the frame's pose on the host.
"""

import time

from slam_bench.drivers._slam import result


def prepare(run):
    pass


def sequence(run):
    from gfplslam_torch.models.slam import SLAMSystem
    w = run.world
    lat = []
    t0 = time.perf_counter()
    s = SLAMSystem(run.cfg, device=run.device)
    for i in range(len(w.left)):
        t = time.perf_counter()
        s.process(w.left[i], w.right[i], float(w.ts[i]))
        lat.append(time.perf_counter() - t)
    s.finish()
    return result(run, s, t0, latency_s=lat)
