"""What a peer rank of the batch driver (``drivers/slam_batch.py``) runs
in its own process, and the tap that reads the engines a process finished.
It is a module of its own, imported by name, because a spawned rank finds
its entry by name and the harness loads drivers from their files.

Each round a peer takes rank 0's sample of the round (whether it keeps its
samples, the FAST frames and Hamming launches drawn), runs the program's
``run_slam_batch`` over the default group under the harness's taps, and
sends rank 0 what its process was seen to do.
"""

import time
import types

from slam_bench import taps
from slam_bench.drivers._slam import result

_PEER: dict = {}        # a peer process's taps, made at its first round


class EngineTap(taps.Patch):
    """``SLAMSystem.finish`` wrapped for one round: the engines this
    process finished, read after the round by :meth:`readings` as
    ``drivers/_slam.py`` reads one."""

    def __init__(self, cfg):
        super().__init__()
        from gfplslam_torch.models.slam import SLAMSystem
        self.engines: list = []
        self._reader = types.SimpleNamespace(cfg=cfg)
        orig = SLAMSystem.finish
        tap = self

        def finish(engine, *args, **kw):
            res = orig(engine, *args, **kw)
            tap.engines.append(engine)
            return res

        self.patch(SLAMSystem, "finish", finish)

    def readings(self) -> list:
        """Each engine's reading, once the round has ended."""
        out = [result(self._reader, e, time.perf_counter()) for e in self.engines]
        self.engines = []
        return out


def _cpu(x):
    """``x`` with every tensor in it copied to the host."""
    if hasattr(x, "detach"):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_cpu(v) for v in x)
    return x


def _witness(kernels, ba, pgo, engines, keep: bool) -> dict:
    """What this process was seen to do in the round: its launch and call
    counts, its engines' readings and, when ``keep``, its kept samples on
    the host (which then leave its taps)."""
    seen = dict(fast_l0=kernels.fast_l0, ham=kernels.ham, ba=ba.calls, pgo=pgo.calls,
                sessions=engines.readings())
    if keep:
        seen.update(fast_kept=_cpu(kernels.fast_kept), ham_kept=_cpu(kernels.ham_kept),
                    ba_kept=_cpu(ba.kept), pgo_kept=_cpu(pgo.kept))
        kernels.fast_kept, kernels.ham_kept, ba.kept, pgo.kept = [], [], [], []
    return seen


def peer(cfg, imgs_l, imgs_r, timestamps, device_type: str, chunk: int):
    """One round on a peer rank: rank 0's sample of the round, the
    program's ``run_slam_batch`` over the default group, and what this
    process was seen to do, sent to rank 0."""
    import torch
    import torch.distributed as dist

    from gfplslam_torch.parallel import batch
    if not _PEER:
        _PEER.update(kernels=taps.KernelTap((cfg.camera.height, cfg.camera.width)),
                     ba=taps.local_ba_tap(), pgo=taps.pose_graph_tap())
    kernels, ba, pgo = _PEER["kernels"], _PEER["ba"], _PEER["pgo"]
    got = [None]
    dist.broadcast_object_list(got, src=0)
    capture, kernels.fast_pick, kernels.ham_pick = got[0]
    kernels.begin_sequence(capture=capture)
    ba.begin_sequence(capture=capture)
    pgo.begin_sequence(capture=capture)
    engines = EngineTap(cfg)
    try:
        batch.run_slam_batch(cfg, imgs_l, imgs_r, timestamps, dist.group.WORLD,
                             chunk=chunk, device=torch.device(device_type))
    finally:
        engines.close()
    dist.gather_object(_witness(kernels, ba, pgo, engines, capture), None, dst=0)
