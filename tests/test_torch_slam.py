"""The slice whole: the port's ``SLAMSystem`` (models/slam.py) and the
per-keyframe ``mapping_step`` (models/mapping.py) on the synthetic worlds
and configuration of tests/test_slam_e2e.py, held to the same gates as the
reference, and against the reference where the comparison is meaningful.

- Every test of tests/test_slam_e2e.py, on the port: per-frame driver,
  mapping disabled, chunk driver vs per-frame, epoch timestamps (1e-5),
  uint8 ``run_sequence`` vs ``process_chunk`` (1e-5).
- The 10-frame world's trajectories against the reference's: aligned ATE
  < 0.08 m (the VO parity tolerance; the two VOs differ by amplified last-ulp
  differences, see tests/test_torch_vo.py, and here pick 5 and 4
  keyframes).
- ``mapping_step`` on the reference's own map, loop state, frame and
  motion: with local BA off, every output exact (association, culling, BoW,
  candidates, verification flag); with BA on, against the reference's
  ``mapping_step`` with its local BA solved in f64 (under
  ``jax.enable_x64``; its f32 solve rounds low-parallax landmarks' blocks
  away, tests/test_torch_ba.py): the same iteration count, everything but
  the BA's own floats exact, the window's poses within 2e-2 and the final
  robust error within 5% (measured: 8.4e-6 and 6e-4%; against the
  reference's f32 solve, 2.5e-2 and 24%, 11 iterations against 20)."""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfplslam_tpu.config import CameraParams, CapacityParams, Config, OrbParams
from gfplslam_tpu.io import synthetic
from gfplslam_tpu.models import mapping as ref_mapping
from gfplslam_tpu.models.slam import SLAMSystem as RefSLAM

from gfplslam_torch.models import loop, map as map_ops, mapping
from gfplslam_torch.models.slam import SLAMSystem
from gfplslam_torch.utils import convert
from gfplslam_torch.utils.trajectory import ate_rmse

from test_torch_ba_observed_subspace import reference_ba_in_f64

torch.set_num_threads(2)
CPU = torch.device("cpu")

CFG_REF = Config(
    cap=CapacityParams(n_pt=256, n_ln=128, n_kf_window=4, n_kf_max=32,
                       n_map_pt=2048, n_map_ln=512,
                       n_obs_pt=1024, n_obs_ln=256, vocab_k=128),
    orb=OrbParams(nlevels=2),
    camera=CameraParams(width=376, height=240, fx=217.6, fy=217.6,
                        cx=183.7, cy=126.1, baseline=0.11))
CFG = convert.config_from_ref(CFG_REF)


def _frames(n, seed=11):
    world = synthetic.make_world(n_frames=n, n_points=300, n_lines=40, seed=seed)
    return world, [synthetic.render_frame(world, i, noise=1.0) for i in range(n)]


def _u8(x):
    return np.clip(np.round(np.stack(x)), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def ten():
    """The 10-frame world through both per-frame drivers."""
    world, frames = _frames(10)
    port = SLAMSystem(CFG, device=CPU)
    ref = RefSLAM(CFG_REF)
    for i, (il, ir) in enumerate(frames):
        port.process(il, ir, world.timestamps[i])
        ref.process(il, ir, world.timestamps[i])
    port.finish()
    ref.finish()
    return world, port, ref


def test_slam_full_pipeline(ten):
    """tests/test_slam_e2e.py::test_slam_full_pipeline's gates."""
    world, slam, _ = ten
    assert not slam.vo.lost
    assert int(slam.map.n_kf) >= 2
    assert int(slam.map.pt_valid.sum()) > 100
    assert int(slam.map.po_valid.sum()) > 150
    assert np.all(np.isfinite(slam.keyframe_trajectory))
    assert ate_rmse(slam.vo.trajectory, world.poses) < 0.08


def test_keyframe_trajectory_agrees_with_reference(ten):
    """Each port keyframe against the reference's (map-corrected) pose of
    the same frame, and the two all-frame trajectories: aligned ATE
    < 0.08 m. The keyframe sets may differ by one (the VO's keyframe
    decision sits on an entropy threshold that the amplified differences
    can cross)."""
    _, port, ref = ten
    kp = port.keyframe_trajectory
    assert len(kp) >= 2 and abs(len(kp) - len(ref.keyframe_trajectory)) <= 1
    ref_all = ref.all_frame_trajectory
    assert ate_rmse(kp, ref_all[port.kf_frame_ids]) < 0.08
    assert ate_rmse(port.all_frame_trajectory, ref_all) < 0.08


def test_slam_vo_only_parity():
    world, frames = _frames(5, seed=12)
    slam = SLAMSystem(CFG, device=CPU, run_local_ba=False, run_loop_closure=False)
    for i, (il, ir) in enumerate(frames):
        slam.process(il, ir, world.timestamps[i])
    assert len(slam.vo.records) == 5
    assert int(slam.map.n_kf) >= 1


def test_chunk_driver_matches_per_frame():
    n = 24
    world, frames = _frames(n)
    per = SLAMSystem(CFG, device=CPU)
    for i, (il, ir) in enumerate(frames):
        per.process(il, ir, world.timestamps[i])
    per.finish()
    chunked = SLAMSystem(CFG, device=CPU)
    for s in range(0, n, 8):
        chunked.process_chunk(np.stack([f[0] for f in frames[s:s + 8]]),
                              np.stack([f[1] for f in frames[s:s + 8]]),
                              world.timestamps[s:s + 8])
    chunked.finish()
    assert not chunked.vo.lost
    assert len(chunked.vo.records) == n
    ate_per = ate_rmse(per.all_frame_trajectory, world.poses)
    ate_chunk = ate_rmse(chunked.all_frame_trajectory, world.poses)
    assert ate_chunk < max(2.0 * ate_per, 0.05), (ate_chunk, ate_per)
    n_kf_per = len(per.keyframe_trajectory)
    assert abs(n_kf_per - len(chunked.keyframe_trajectory)) <= max(3, n_kf_per // 3)


def test_chunk_driver_epoch_timestamps():
    n = 16
    world, frames = _frames(n)
    il = np.stack([f[0] for f in frames])
    ir = np.stack([f[1] for f in frames])
    runs = []
    for base in (0.0, 1.403715273262e9):
        s = SLAMSystem(CFG, device=CPU)
        for st in range(0, n, 8):
            s.process_chunk(il[st:st + 8], ir[st:st + 8],
                            world.timestamps[st:st + 8] + base)
        s.finish()
        assert not s.vo.lost
        runs.append(s.all_frame_trajectory)
    np.testing.assert_allclose(runs[1], runs[0], atol=1e-5)
    assert np.linalg.norm(runs[1][-1][:3, 3]) > 1e-3


def test_run_sequence_uint8_matches_chunk_driver():
    n = 17
    world, frames = _frames(n)
    il = _u8([f[0] for f in frames])
    ir = _u8([f[1] for f in frames])
    a = SLAMSystem(CFG, device=CPU)
    a.run_sequence(il, ir, world.timestamps, chunk=8)
    a.finish()
    b = SLAMSystem(CFG, device=CPU)
    b.process_chunk(il[:9], ir[:9], world.timestamps[:9])
    b.process_chunk(il[9:], ir[9:], world.timestamps[9:])
    b.finish()
    assert not a.vo.lost and len(a.vo.records) == n
    np.testing.assert_allclose(a.all_frame_trajectory, b.all_frame_trajectory, atol=1e-5)
    assert ate_rmse(a.all_frame_trajectory, world.poses) < 0.08


@pytest.fixture(scope="module")
def upstream():
    """The reference's map and loop state after its second keyframe, the
    frame of its third and the motion between them, recorded from a
    reference run of the 10-frame world."""
    world, frames = _frames(10)
    ref = RefSLAM(CFG_REF, async_mapping=False)
    states = {}
    orig = ref_mapping.mapping_step

    def spy(cfg, m, ls, frame, t_rel, **kw):
        states.setdefault(int(m.n_kf), (m, ls, frame, t_rel, kw))
        return orig(cfg, m, ls, frame, t_rel, **kw)
    ref_mapping.mapping_step = spy
    try:
        for i, (il, ir) in enumerate(frames):
            ref.process(il, ir, world.timestamps[i])
    finally:
        ref_mapping.mapping_step = orig
    assert 2 in states
    return jax.tree.map(np.asarray, states[2][:4])


def _assert_exact(got, want, skip=(), what=""):
    got = convert.to_numpy(got)
    for name, g, w in zip(got._fields, got, want):
        if isinstance(w, tuple):
            _assert_exact(g, w, skip, f"{what}.{name}")
        elif name not in skip:
            w = np.asarray(w)
            if w.dtype.kind == "f":
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=f"{what}.{name}")
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"{what}.{name}")


@pytest.mark.parametrize("run_ba", [False, True])
def test_mapping_step_on_reference_upstream(upstream, run_ba):
    m, ls, frame, t_rel = upstream
    with reference_ba_in_f64():
        want = jax.tree.map(np.asarray, ref_mapping.mapping_step(
            CFG_REF, *jax.tree.map(jnp.asarray, (m, ls, frame, t_rel)), run_ba=run_ba))
    got = mapping.mapping_step(CFG, *(convert.to_torch(x, CPU) for x in (m, ls, frame)),
                               torch.from_numpy(np.array(t_rel)), run_ba=run_ba)
    assert int(got.n_pt_matched) == int(want.n_pt_matched) > 20
    assert int(got.n_ln_matched) == int(want.n_ln_matched)
    assert int(got.cand) == int(want.cand)
    assert bool(got.verification.accepted) == bool(want.verification.accepted)
    if not run_ba:
        _assert_exact(got.map, want.map, what="map")
        _assert_exact(got.loop_state, want.loop_state, what="loop")
        return
    assert int(got.ba_iters) == int(want.ba_iters)
    # the BA's own floats (and the obs it marks from them) are compared with
    # a tolerance; every other leaf is exact
    ba_floats = ("kf_pose", "pt_pos", "ln_sp", "ln_ep")
    _assert_exact(got.map, want.map, skip=ba_floats + ("po_valid", "pt_obs_n", "full_graph"),
                  what="map")
    _assert_exact(got.loop_state, want.loop_state, what="loop")
    assert np.abs(got.map.kf_pose.numpy() - want.map.kf_pose).max() < 2e-2
    np.testing.assert_allclose(float(got.ba_err), float(want.ba_err), rtol=5e-2)
    agree = (got.map.po_valid.numpy() == want.map.po_valid).mean()
    assert agree > 0.99, agree


@pytest.mark.parametrize("entry", ["SLAMSystem", "empty_map", "empty_loop_state"])
def test_back_end_defaults_to_the_card(entry):
    fn = {"SLAMSystem": SLAMSystem, "empty_map": map_ops.empty_map,
          "empty_loop_state": loop.empty_loop_state}[entry]
    default = inspect.signature(fn).parameters["device"].default
    assert default == torch.device("cuda")


def test_slam_system_places_state_on_its_device():
    slam = SLAMSystem(CFG, device=CPU)
    assert slam.vo.device == CPU
    assert slam.map.kf_pose.device == CPU and slam.loop_state.conf.device == CPU
    assert dataclasses.fields(SLAMSystem)[1].name == "device"
