"""Taps on the program's module attributes: what the benchmark reads from
the program besides its results.

- :class:`KernelTap` wraps the two kernels' entries, ``ops.fast.
  fast_score_cuda`` and ``ops.hamming.hamming_cuda_many`` (on a CPU, in
  the tests, their plain versions ``fast_score_map_torch`` and
  ``hamming_matrix_torch``, which the program calls in their place). It
  counts launches per sequence, keeps a copy of the outputs (and of the
  Hamming inputs) of the launches drawn for the correctness check, and,
  in a traced sequence, the shapes of every launch for the rooflines.
  Outside the drawn launches a call costs one Python call and a counter.
- :class:`CallTap` wraps ``models.ba.solve_ba``, through which the
  mapping step runs the local BA (``mapping.py`` calls
  ``ba_ops.solve_ba``), and ``models.loop.optimize_pose_graph``, through
  which a loop closure solves the pose graph (``slam.py`` calls
  ``loop_ops.optimize_pose_graph``). It counts calls per sequence and keeps
  a copy of the inputs and the result of every call in the window's first
  sequence, for the correctness check.
- :class:`MappingTap` wraps ``models.mapping.mapping_step_chunk``, the
  attribute through which ``models/slam.py`` calls the mapping step in
  the chunk driver, and times each call on the host clock (the step only
  queues work, so this is the host's dispatch of the step, with whatever
  waits on the device inside it; no synchronise is added). Installed in
  traced runs, after the profiled sequence.

Every tap puts the original attribute back on :meth:`close`.
"""

from __future__ import annotations

import time

import torch


class Patch:
    """Module attributes replaced by wrappers, put back by :meth:`close`
    in the reverse order."""

    def __init__(self):
        self._undo = []

    def patch(self, obj, name, wrapper):
        orig = getattr(obj, name)
        self._undo.append((obj, name, orig))
        setattr(obj, name, wrapper)
        return orig

    def close(self):
        while self._undo:
            obj, name, orig = self._undo.pop()
            setattr(obj, name, orig)


class KernelTap(Patch):
    def __init__(self, frame_hw: tuple):
        super().__init__()
        from gfplslam_torch.ops import fast, hamming
        self.frame_hw = tuple(frame_hw)
        self.fast_l0 = 0            # level-0 FAST launches this sequence (= frame index)
        self.ham = 0                # Hamming launches this sequence
        self.fast_pick: set = set()  # frame indices whose level-0 scores are kept
        self.ham_pick: set = set()   # launch indices whose matrices are kept
        self.capture = False
        self.shapes = None          # list while recording shapes
        self.fast_kept: list = []   # (frame, threshold tensor, scores)
        self.ham_kept: list = []    # (launch, [(a, b, va, vb, out)])
        tap = self

        def fast_entry(orig):
            def wrapped(imgs, threshold):
                out = orig(imgs, threshold)
                tap._fast(imgs, threshold, out)
                return out
            return wrapped

        def ham_many(orig):
            def wrapped(problems):
                outs = orig(problems)
                tap._ham(problems, outs)
                return outs
            return wrapped

        def ham_plain(orig):
            def wrapped(a, b, valid_a=None, valid_b=None):
                out = orig(a, b, valid_a, valid_b)
                tap._ham([(a, b, valid_a, valid_b)], [out])
                return out
            return wrapped

        # fast_score_cuda counts its launches on the attribute it is named
        # by: keep that counter on the wrapper
        w = fast_entry(fast.fast_score_cuda)
        w.launches = fast.fast_score_cuda.launches
        self.patch(fast, "fast_score_cuda", w)
        self.patch(fast, "fast_score_map_torch", fast_entry(fast.fast_score_map_torch))
        self.patch(hamming, "hamming_cuda_many", ham_many(hamming.hamming_cuda_many))
        self.patch(hamming, "hamming_matrix_torch", ham_plain(hamming.hamming_matrix_torch))

    def begin_sequence(self, capture: bool = False, shapes: bool = False):
        self.fast_l0 = self.ham = 0
        self.capture = capture
        self.shapes = [] if shapes else None

    def _fast(self, imgs, threshold, out):
        if self.shapes is not None and imgs.is_cuda:
            self.shapes.append(("fast", tuple(imgs.shape)))
        if tuple(imgs.shape[-2:]) != self.frame_hw:
            return
        if self.capture and self.fast_l0 in self.fast_pick:
            th = torch.as_tensor(threshold, dtype=torch.float32).clone()
            self.fast_kept.append((self.fast_l0, th, out.clone()))
        self.fast_l0 += 1

    def _ham(self, problems, outs):
        if self.shapes is not None and problems[0][0].is_cuda:
            self.shapes.append(("hamming", [(a.shape[0], b.shape[0], va is not None,
                                             vb is not None) for a, b, va, vb in problems]))
        if self.capture and self.ham in self.ham_pick:
            self.ham_kept.append((self.ham, [
                tuple(None if t is None else t.clone() for t in (a, b, va, vb)) + (o.clone(),)
                for (a, b, va, vb), o in zip(problems, outs)]))
        self.ham += 1

    def close(self):
        from gfplslam_torch.ops import fast
        launches = fast.fast_score_cuda.launches
        super().close()
        fast.fast_score_cuda.launches = launches


class CallTap(Patch):
    """Wraps ``obj.<name>``: counts its calls per sequence and, in the
    capture sequence, keeps ``keep(args, kwargs, result)`` of every call."""

    def __init__(self, obj, name: str, keep):
        super().__init__()
        self.calls = 0
        self.capture = False
        self.kept: list = []        # (call index, what keep() returned)
        orig = getattr(obj, name)
        tap = self

        def wrapped(*args, **kw):
            res = orig(*args, **kw)
            if tap.capture:
                tap.kept.append((tap.calls, keep(args, kw, res)))
            tap.calls += 1
            return res

        self.patch(obj, name, wrapped)

    def begin_sequence(self, capture: bool = False):
        self.calls = 0
        self.capture = capture


def _copy(fields: dict) -> dict:
    return {k: v.clone() for k, v in fields.items() if torch.is_tensor(v)}


def local_ba_tap() -> CallTap:
    """``models.ba.solve_ba(cam, prob, ...)``: keeps the problem's fields and
    the result's poses and landmarks."""
    from gfplslam_torch.models import ba

    def keep(args, kw, res):
        return _copy(args[1]._asdict()), _copy(
            {k: getattr(res, k) for k in ("kf_pose", "pt_pos", "ln_sp", "ln_ep")})
    return CallTap(ba, "solve_ba", keep)


def pose_graph_tap() -> CallTap:
    """``models.loop.optimize_pose_graph(kf_pose, kf_valid, edges, ...)``:
    keeps the poses it was given, its edges and the poses it returned."""
    from gfplslam_torch.models import loop

    def keep(args, kw, res):
        return args[0].clone(), _copy(args[2]._asdict()), res.clone()
    return CallTap(loop, "optimize_pose_graph", keep)


class MappingTap(Patch):
    def __init__(self):
        super().__init__()
        from gfplslam_torch.models import mapping
        self.ms: list = []          # each call's host ms
        orig = mapping.mapping_step_chunk
        tap = self

        def wrapped(*args, **kw):
            t0 = time.perf_counter()
            res = orig(*args, **kw)
            tap.ms.append(1e3 * (time.perf_counter() - t0))
            return res

        self.patch(mapping, "mapping_step_chunk", wrapped)
