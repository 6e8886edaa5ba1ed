"""The local BA's landmark inverses on their observed subspace
(``gfplslam_torch/models/ba_core.py::landmark_inverses``).

The reference holds a landmark block's unobserved directions with a 1e8
stiffness, ``inv(A + 1e8 (I - P))``; the port inverts on the observed
subspace, ``P inv(P A P + s (I - P)) P``, the limit of that form as the
stiffness grows. In f32 the reference's form rounds the observed entries
away, so the port is held here to the reference's math in f64
(``jax.enable_x64``): its projectors and damping at infinite stiffness for
the inverses, its ``solve_ba`` for the window's solution.

- Random point and line blocks with one or two cut directions, none
  axis-aligned, every eigenvalue at least a factor of 10 from the gate, at
  lambda 1e-3 and 10: median per-block relative error <= 1e-3, every block
  <= 5e-2, and the step along each cut direction <= 1e-6 of the inverse's
  norm. The limit, not the reference's 1e8 form, is the truth: in f64 that
  form is itself up to 1.1e-3 (median) from its limit at lambda 10.
- The full-capacity loop world's keyframe-13 window
  (``tests/data/full_capacity_kf13_window.npz``: the problem the
  reference's ``mapping_step`` hands to ``solve_ba`` at its keyframe 13,
  the camera, and the reference's f64 solution): its own point blocks'
  inverses to the same gates, and its reduced camera system at the first
  LM iteration's lambda positive semi-definite to 1e-4 of its largest
  eigenvalue.
- The port's ``solve_ba`` of that window at 1 and at 8 CPU threads: every
  keyframe position within 1e-2 m of the f64 solution, the final error
  within 5e-3 of it. With the 1e8 stiffness the port missed both at every
  thread count on this window (0.14 m, 0.10-0.12), but did not reproduce
  the full run's 8-thread blow-up (a keyframe 2 km away).

``reference_ba_in_f64`` runs the reference's ``solve_ba`` (and so its
``mapping_step``) in f64 for the parity tests of the BA's floats in
``tests/test_torch_slam.py`` and ``test_torch_slam_loop.py``.

Record the fixture again (the reference's full-capacity run on the CPU,
about two minutes, then its f32 and f64 solves of the window)::

    JAX_PLATFORMS=cpu python -m tests.test_torch_ba_observed_subspace
"""

import contextlib
import os
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gfplslam_tpu.models import ba_core as ref_core

from gfplslam_torch.config import CameraParams, Config
from gfplslam_torch.models import ba, ba_core, map as map_ops
from gfplslam_torch.utils import se3

WINDOW = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                      "full_capacity_kf13_window.npz")
WINDOW_KF = 13
LAM0 = Config().slam.lambda_lba_lm


@contextlib.contextmanager
def reference_ba_in_f64():
    """Under ``jax.enable_x64``, the reference's ``models/ba.py::solve_ba``
    (and so its ``mapping_step``'s local BA) solving in f64: the problem's
    floats cast up, the result's cast back to f32. The rest of the
    reference runs as it is. The parity tests of the BA's floats hold the
    port to this run, not to the reference's f32 solve (module docstring)."""
    from gfplslam_tpu.models import ba as ref_ba

    solve = ref_ba.solve_ba

    def cast(tree, dtype):
        return tree._replace(**{f: x.astype(dtype) for f, x in tree._asdict().items()
                                if jnp.issubdtype(x.dtype, jnp.floating)})

    def solve_f64(cam, prob, **kw):
        return cast(solve(cam, cast(prob, jnp.float64), **kw), jnp.float32)

    ref_ba.solve_ba = solve_f64
    try:
        with jax.enable_x64(True):
            yield
    finally:
        ref_ba.solve_ba = solve


def _cut_blocks(rng, n: int) -> np.ndarray:
    """[n, 3, 3] symmetric blocks (f64) along random rotations, with one or
    two eigenvalues in 1e-6..1e-3 (below the gate) and the others in
    5e2..5e3 and 5e3..5e4 (the gate is 1e-3 of the largest, 5..50)."""
    q, r = np.linalg.qr(rng.normal(0, 1, (n, 3, 3)))
    two = rng.random(n) < 0.5
    spec = np.stack([rng.uniform(1e-6, 1e-3, n),
                     np.where(two, rng.uniform(1e-6, 1e-3, n), rng.uniform(5e2, 5e3, n)),
                     rng.uniform(5e3, 5e4, n)], 1)
    return np.einsum("nij,nj,nkj->nik", q, spec, q)


def _blocks(n_p: int, n_l: int, seed: int):
    """Point blocks and line blocks, block-diagonal over the two endpoints
    as the BA's line Jacobians make them, f64."""
    rng = np.random.default_rng(seed)
    hpp = _cut_blocks(rng, n_p)
    hll = np.zeros((n_l, 6, 6))
    hll[:, :3, :3], hll[:, 3:, 3:] = _cut_blocks(rng, n_l), _cut_blocks(rng, n_l)
    return hpp, hll


def _bk(hpp, hll, to):
    p, l = hpp.shape[0], hll.shape[0]
    return dict(hcc=to(np.zeros((1, 6, 6))), bc=to(np.zeros((1, 6))), hpp=to(hpp),
                bp=to(np.zeros((p, 3))), hcl_p=to(np.zeros((p, 1, 6, 3))), hll=to(hll),
                bl=to(np.zeros((l, 6))), hcl_l=to(np.zeros((l, 1, 6, 6))),
                pt_act=np.ones(p, bool), ln_act=np.ones(l, bool),
                err_sum=to(np.zeros(())), err_cnt=to(np.zeros(())))


def _limit_f64(hpp, hll, lam):
    """The reference's inverses in the limit of infinite stiffness, in f64:
    its own projectors (``_keep_projector3`` under x64) and damping,
    P (P A P + I - P)^-1 P. Also the reference's ``landmark_inverses`` in
    f64 and its projectors, for the checks that this is its math."""
    with jax.enable_x64(True):
        bk64 = ref_core.BABlocks(**{k: jnp.asarray(v) for k, v in _bk(
            hpp, hll, lambda x: x).items()})
        ref = [np.asarray(x) for x in ref_core.landmark_inverses(bk64, lam)]
        proj = [np.asarray(ref_core._keep_projector3(jnp.asarray(h)))
                for h in (hpp, hll[:, :3, :3], hll[:, 3:, 3:])]
    assert ref[0].dtype == proj[0].dtype == np.float64
    proj_l = np.zeros_like(hll)
    proj_l[:, :3, :3], proj_l[:, 3:, 3:] = proj[1], proj[2]
    limit = []
    for h, p in ((hpp, proj[0]), (hll, proj_l)):
        d = h.shape[-1]
        diag = np.maximum(np.diagonal(h, axis1=1, axis2=2), 1e-6)
        a = h + lam * diag[:, :, None] * np.eye(d)
        limit.append(p @ np.linalg.inv(p @ a @ p + np.eye(d) - p) @ p)
    return limit, ref, proj[0]


def _block_rel(got, want):
    """Per block: the largest entry difference over the block's largest entry."""
    return np.abs(got - want).max((1, 2)) / np.abs(want).max((1, 2))


@pytest.mark.parametrize("lam", [1e-3, 10.0])
def test_landmark_inverses_with_cut_directions(lam):
    """The port's f32 inverses (512 point, 256 line blocks) against the
    reference's formula in f64 at infinite stiffness: per-block relative
    error median <= 1e-3 and worst <= 5e-2 (measured <= 2.5e-7 and 2.2e-4;
    with the 1e8 stiffness in f32, up to 9.0e-3 and 8.3). The reference's
    own ``landmark_inverses`` in f64 is within 1e-2 of that limit on every
    block (its 1e8 is finite: 9.2e-4 worst at lambda 1e-3, 5.6e-3 at 10).
    The port's projector is within 1e-4 of the reference's f64 one (its f32
    input and eigenvectors: 5.7e-5), and the step along every direction it
    cuts is <= 1e-6 of the inverse's norm (measured 5.5e-8)."""
    hpp, hll = _blocks(512, 256, seed=3)
    bk = ba_core.BABlocks(**{k: torch.as_tensor(v) for k, v in _bk(
        hpp, hll, lambda x: x.astype(np.float32)).items()})
    got = [x.numpy().astype(np.float64)
           for x in ba_core.landmark_inverses(bk, torch.tensor(lam))]
    limit, ref, proj_ref = _limit_f64(hpp, hll, lam)
    for g, w, r in zip(got, limit, ref):
        rel = _block_rel(g, w)
        assert np.median(rel) <= 1e-3 and rel.max() <= 5e-2, (np.median(rel), rel.max())
        assert _block_rel(r, w).max() <= 1e-2
    proj = ba_core._keep_projector3(bk.hpp).numpy().astype(np.float64)
    assert np.abs(proj - proj_ref).max() <= 1e-4
    w, v = np.linalg.eigh(proj)
    cut = np.where((w < 0.5)[:, None, :], v, 0.0)       # columns: cut directions
    step = np.linalg.norm(got[0] @ cut, axis=1)
    assert (step <= 1e-6 * np.linalg.norm(got[0], axis=(1, 2))[:, None]).all(), step.max()


def _window():
    z = np.load(WINDOW)
    cam = CameraParams(**{f: type(getattr(CameraParams, f))(z[f"cam_{f}"])
                          for f in CameraParams.__dataclass_fields__})
    prob = ba.BAProblem(*(torch.from_numpy(z[f]) for f in ba.BAProblem._fields))
    return cam, prob, {k[4:]: z[k] for k in z.files if k.startswith("f64_")}


def _window_blocks():
    cam, prob, _ = _window()
    return ba_core.build_blocks(cam, prob, ba_core.make_selectors(prob),
                                ba._point_residuals, ba._line_residuals,
                                se3.inverse_se3(prob.kf_pose), prob.pt_pos,
                                prob.ln_sp, prob.ln_ep)


def test_window_landmark_inverses():
    """The keyframe-13 window's own point blocks (2043 of its 2048 with a
    cut direction) at the first LM iteration's lambda, against the
    reference's formula in f64 at infinite stiffness on the same f32
    blocks: per-block relative error median <= 1e-3 and worst <= 5e-2 over
    the blocks with an observed direction (measured 1.1e-7 and 2.9e-6;
    with the 1e8 stiffness in f32, 8.9e-2 and 1083)."""
    bk = _window_blocks()
    got = ba_core.landmark_inverses(bk, torch.tensor(LAM0))[0].numpy().astype(np.float64)
    limit = _limit_f64(bk.hpp.numpy().astype(np.float64),
                       bk.hll.numpy().astype(np.float64), LAM0)[0][0]
    seen = bk.pt_act.numpy() & (np.abs(limit).max((1, 2)) > 0)
    rel = _block_rel(got[seen], limit[seen])
    assert seen.sum() > 2000
    assert np.median(rel) <= 1e-3 and rel.max() <= 5e-2, (np.median(rel), rel.max())


def test_window_schur_system_is_positive_semidefinite():
    """The reduced camera system of the keyframe-13 window at the first LM
    iteration's lambda, from the port's f32 blocks, eigenvalues in f64:
    the smallest >= -1e-4 x the largest (measured 0 and 2.72e7; with the
    1e8 stiffness in f32, -2.97e8 and 6.51e7)."""
    bk = _window_blocks()
    s, _ = ba_core.schur_reduce(bk, *ba_core.landmark_inverses(bk, torch.tensor(LAM0)))
    s = s.numpy().astype(np.float64)
    w = np.linalg.eigvalsh(0.5 * (s + s.T))
    assert w[0] >= -1e-4 * w[-1], (w[0], w[-1], w[0] / w[-1])


@pytest.mark.parametrize("threads", [1, 8])
def test_window_solve_at_any_thread_count(threads):
    """The port's solve of the keyframe-13 window against the reference's
    f64 solve: every valid keyframe's position within 1e-2 m, the final
    error within 5e-3 (measured: 1.7e-5 m and 1e-6 at 1 thread, 1.5e-3 m
    and 5.6e-4 at 8; with the 1e8 stiffness in f32, 0.14 m and 0.10-0.12
    at 1, 6 and 8 threads)."""
    cam, prob, ref = _window()
    slam = Config().slam
    old = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        res = ba.solve_ba(cam, prob, lambda0=slam.lambda_lba_lm,
                          lambda_k=slam.lambda_lba_k, max_iters=slam.max_iters_lba)
    finally:
        torch.set_num_threads(old)
    valid = prob.kf_valid.numpy()
    dpos = np.linalg.norm(res.kf_pose.numpy()[valid, :3, 3]
                          - ref["kf_pose"][valid, :3, 3], axis=-1)
    derr = abs(float(res.err) - float(ref["err"]))
    assert dpos.max() <= 1e-2 and derr <= 5e-3, (dpos.max(), derr, float(res.err))


@pytest.mark.parametrize("obs", [[0, 5, 5, 5, 5], [2, 0, 4, 5, 5], [3, 5, 5, 5, 5],
                                 [0, 0, 0, 0, 5]])
def test_gauge_anchors_on_an_observed_keyframe(obs):
    """``map._anchor_gauge``: every window KF up to the oldest one with 3
    point observations is frozen; a window whose oldest KF has them keeps
    the reference's gauge (``test_torch_map.py`` holds that problem
    exactly); with no such KF, the oldest one stays the gauge. Four window
    slots, one frozen out-of-window slot (the last count)."""
    kw = 4
    po_kf = torch.cat([torch.full((n,), k) for k, n in enumerate(obs)]).to(torch.int32)
    pad = 32 - po_kf.shape[0]
    z = torch.zeros
    prob = ba.BAProblem(
        kf_pose=torch.eye(4).repeat(5, 1, 1),
        kf_free=torch.tensor([False, True, True, True, False]),
        kf_valid=torch.ones(5, dtype=torch.bool), pt_pos=z(8, 3),
        pt_valid=torch.ones(8, dtype=torch.bool), ln_sp=z(2, 3), ln_ep=z(2, 3),
        ln_valid=z(2, dtype=torch.bool),
        po_kf=torch.cat([po_kf, torch.full((pad,), 7, dtype=torch.int32)]),
        po_lm=z(32, dtype=torch.int32), po_uv=z(32, 2), po_sigma2=z(32),
        po_valid=torch.arange(32) < po_kf.shape[0], lo_kf=z(4, dtype=torch.int32),
        lo_lm=z(4, dtype=torch.int32), lo_le=z(4, 3), lo_sigma2=z(4),
        lo_valid=z(4, dtype=torch.bool))
    gauge = next((k for k in range(kw) if obs[k] >= map_ops.GAUGE_MIN_OBS), 0)
    want = [k > gauge for k in range(kw)] + [False]
    assert map_ops._anchor_gauge(prob, kw).tolist() == want


def _record():
    """The reference's full-capacity run on the CPU with its keyframe-13
    local-BA problem captured, then the reference's f64 solve of it."""
    from gfplslam_tpu.models import ba as ref_ba, map as ref_map, mapping as ref_mapping
    from test_torch_slam_full_capacity import _reference_run, decoded_world

    captured = {}
    step = ref_mapping.mapping_step

    window = jax.jit(lambda m, frame, t_rel, cfg: ref_map.build_local_ba_problem(
        cfg, ref_map.add_keyframe(cfg, m, frame, t_rel)[0])[0], static_argnums=3)

    def call(cfg, m, ls, frame, t_rel, **kw):
        if int(m.n_kf) == WINDOW_KF and "prob" not in captured:
            captured["cfg"] = cfg
            captured["prob"] = jax.tree.map(np.asarray, window(m, frame, t_rel, cfg))
        return step(cfg, m, ls, frame, t_rel, **kw)

    ref_mapping.mapping_step = call
    try:
        with tempfile.TemporaryDirectory() as root:
            world, frames = decoded_world(root)
            t0 = time.perf_counter()
            _reference_run(frames, world)
    finally:
        ref_mapping.mapping_step = step
    cfg, prob = captured["cfg"], captured["prob"]
    print(f"reference run {time.perf_counter() - t0:.0f} s; window K "
          f"{int(prob.kf_valid.sum())}/{prob.kf_pose.shape[0]}, points "
          f"{int(prob.pt_valid.sum())}/{prob.pt_pos.shape[0]}, lines "
          f"{int(prob.ln_valid.sum())}/{prob.ln_sp.shape[0]}, observations "
          f"{int(prob.po_valid.sum())} + {int(prob.lo_valid.sum())}", file=sys.stderr)
    lm = dict(lambda0=cfg.slam.lambda_lba_lm, lambda_k=cfg.slam.lambda_lba_k,
              max_iters=cfg.slam.max_iters_lba)
    f32 = ref_ba.solve_ba(cfg.camera, jax.tree.map(jnp.asarray, prob), **lm)
    with jax.enable_x64(True):
        prob64 = jax.tree.map(lambda x: jnp.asarray(
            x.astype(np.float64) if x.dtype == np.float32 else x), prob)
        res = jax.tree.map(np.asarray, ref_ba.solve_ba(cfg.camera, prob64, **lm))
    assert res.kf_pose.dtype == np.float64
    print(f"reference solve: f32 err {float(f32.err):.6f} in {int(f32.iters)} "
          f"iterations, f64 err {float(res.err):.6f} in {int(res.iters)}",
          file=sys.stderr)
    out = {f: getattr(prob, f) for f in prob._fields}
    out.update({f"cam_{f}": np.asarray(getattr(cfg.camera, f))
                for f in cfg.camera.__dataclass_fields__})
    out.update({f"f64_{f}": getattr(res, f)
                for f in ("kf_pose", "pt_pos", "ln_sp", "ln_ep", "err", "iters")})
    os.makedirs(os.path.dirname(WINDOW), exist_ok=True)
    np.savez_compressed(WINDOW, **out)
    print(f"wrote {WINDOW}: {os.path.getsize(WINDOW)} bytes", file=sys.stderr)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    _record()
