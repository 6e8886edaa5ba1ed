"""The control and the planted faults that the comparison deciding
``correct`` has to catch. The benchmark's own runs install none of them:
``python -m slam_bench.control`` and the tests do.

- ``control``: the reference's FAST-9 put in the place of the program's
  FAST kernel and computed in the nearest precision below the one the
  configuration states for it (float8 e4m3 where it states bf16).
- ``frozen``: the tracker's step returns its state unchanged.
- ``half``: the FAST launch scores only the first half of its batch (one
  camera of a stereo pair) and leaves the rest at 0.
- ``altered``: every Hamming launch adds 1 to the first entry of each
  matrix it produces.
- ``ba_frozen``: the local BA returns the poses and landmarks it was
  given (``models.ba.solve_ba``, through which the mapping step runs it).
- ``no_closure``: the SLAM system drops every verified loop instead of
  closing it (``SLAMSystem._close_loop`` clears its constraints and
  returns).
- ``no_pose_graph``: the loop is closed, but the pose-graph solve returns
  the keyframe poses it was given (``models.loop.optimize_pose_graph``).

(The cells run on one chip: there is no exchange between chips to leave
out.)
"""

from __future__ import annotations

import torch

from slam_bench import reference
from slam_bench.taps import Patch

NAMES = ("control", "frozen", "half", "altered", "ba_frozen", "no_closure",
         "no_pose_graph")


def install(name: str) -> Patch:
    """Install plant ``name``; ``close()`` on the result takes it out."""
    from gfplslam_torch.models import ba, loop, slam, tracker
    from gfplslam_torch.ops import fast, hamming
    p = Patch()
    if name == "control":
        def fp8_fast(imgs, threshold):
            thr = float(torch.as_tensor(threshold).reshape(-1)[0])
            return reference.fast9_scores(imgs, thr, torch.float8_e4m3fn)
        fp8_fast.launches = fast.fast_score_cuda.launches
        p.patch(fast, "fast_score_cuda", fp8_fast)
        p.patch(fast, "fast_score_map_torch", fp8_fast)
    elif name == "frozen":
        orig = tracker.track_step

        def frozen(cfg, state, *args, **kw):
            return orig(cfg, state, *args, **kw)._replace(state=state)
        p.patch(tracker, "track_step", frozen)
    elif name == "half":
        def halved(orig):
            def f(imgs, threshold):
                out = orig(imgs, threshold)
                out[(out.shape[0] + 1) // 2:] = 0
                return out
            return f
        w = halved(fast.fast_score_cuda)
        w.launches = fast.fast_score_cuda.launches
        p.patch(fast, "fast_score_cuda", w)
        p.patch(fast, "fast_score_map_torch", halved(fast.fast_score_map_torch))
    elif name == "altered":
        def bump(outs):
            for o in outs:
                if o.numel():
                    o.view(-1)[0] += 1
            return outs
        orig_many, orig_plain = hamming.hamming_cuda_many, hamming.hamming_matrix_torch
        p.patch(hamming, "hamming_cuda_many", lambda problems: bump(orig_many(problems)))
        p.patch(hamming, "hamming_matrix_torch",
                lambda a, b, va=None, vb=None: bump([orig_plain(a, b, va, vb)])[0])
    elif name == "ba_frozen":
        orig_ba = ba.solve_ba

        def frozen_ba(cam, prob, *args, **kw):
            return orig_ba(cam, prob, *args, **kw)._replace(
                kf_pose=prob.kf_pose, pt_pos=prob.pt_pos, ln_sp=prob.ln_sp,
                ln_ep=prob.ln_ep)
        p.patch(ba, "solve_ba", frozen_ba)
    elif name == "no_closure":
        def dropped(self):
            self.lc_pending = []
            self.lc_status = slam.LC_IDLE
        p.patch(slam.SLAMSystem, "_close_loop", dropped)
    elif name == "no_pose_graph":
        p.patch(loop, "optimize_pose_graph", lambda kf_pose, *args, **kw: kf_pose)
    else:
        raise ValueError(f"no plant {name!r}; there are {NAMES}")
    return p
