"""Checkpoints: the port and the reference read and write one npz layout.

The state is ``tests/test_global_ba_ckpt.py``'s small system (6 frames of
seed 21 at 376x240, local BA on, loop closure off) run by the port. A file
the reference's ``SLAMSystem.save`` writes from that state loads into the
port's ``SLAMSystem.load`` with every map / loop / tracker field equal, and
the other way round; descriptor words travel as the reference's uint32."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfplslam_tpu import config as ref_config
from gfplslam_tpu.io import synthetic as ref_synthetic
from gfplslam_tpu.models.slam import SLAMSystem as RefSLAM

from gfplslam_torch.models.slam import SLAMSystem
from gfplslam_torch.utils import convert

torch.set_num_threads(2)
CPU = torch.device("cpu")
STATES = (("map", "map"), ("loop", "loop_state"))


def _ref_cfg():
    return ref_config.Config(
        cap=ref_config.CapacityParams(n_pt=256, n_ln=128, n_kf_window=4,
                                      n_kf_max=16, n_map_pt=2048, n_map_ln=512,
                                      n_obs_pt=1024, n_obs_ln=256, vocab_k=64),
        orb=ref_config.OrbParams(nlevels=2),
        camera=ref_config.CameraParams(width=376, height=240, fx=217.6, fy=217.6,
                                       cx=183.7, cy=126.1, baseline=0.11))


@pytest.fixture(scope="module")
def port_system():
    cfg = convert.config_from_ref(_ref_cfg())
    world = ref_synthetic.make_world(n_frames=6, n_points=300, n_lines=40, seed=21)
    slam = SLAMSystem(cfg, device=CPU, run_loop_closure=False)
    for i in range(6):
        il, ir = ref_synthetic.render_frame(world, i, noise=1.0)
        slam.process(il, ir, world.timestamps[i])
    assert int(slam.map.n_kf) >= 2
    return slam


def _port_states(slam):
    """name -> NamedTuple of numpy leaves (descriptors as uint32)."""
    return {"map": convert.to_numpy(slam.map),
            "loop": convert.to_numpy(slam.loop_state),
            "tracker": convert.to_numpy(slam.vo.state)}


def _ref_states(slam):
    def np_tree(t):
        return type(t)(*(np.asarray(x) for x in t))
    return {"map": np_tree(slam.map), "loop": np_tree(slam.loop_state),
            "tracker": np_tree(slam.vo.state)}


def _assert_states_equal(got: dict, want: dict):
    for key in want:
        assert got[key]._fields == want[key]._fields
        for name, a, b in zip(want[key]._fields, got[key], want[key]):
            assert a.dtype == b.dtype, f"{key}.{name}: {a.dtype} != {b.dtype}"
            np.testing.assert_array_equal(a, b, err_msg=f"{key}.{name}")


def _ref_system_holding(states: dict) -> RefSLAM:
    ref = RefSLAM(_ref_cfg(), run_loop_closure=False)
    ref.map = type(ref.map)(*(jnp.asarray(x) for x in states["map"]))
    ref.loop_state = type(ref.loop_state)(*(jnp.asarray(x) for x in states["loop"]))
    from gfplslam_tpu.models import tracker as ref_trk
    ref.vo.state = ref_trk.TrackerState(*(jnp.asarray(x) for x in states["tracker"]))
    return ref


def test_reference_file_loads_in_port(port_system, tmp_path):
    states = _port_states(port_system)
    path = str(tmp_path / "ref.npz")
    _ref_system_holding(states).save(path)
    got = SLAMSystem(port_system.cfg, device=CPU)
    got.load(path)
    _assert_states_equal(_port_states(got), states)
    assert got._n_kf_host == int(port_system.map.n_kf)


def test_port_file_loads_in_reference(port_system, tmp_path):
    path = str(tmp_path / "port.npz")
    port_system.save(path)
    ref = RefSLAM(_ref_cfg(), run_loop_closure=False)
    ref.load(path)
    _assert_states_equal(_ref_states(ref), _port_states(port_system))
    assert ref._n_kf_host == int(port_system.map.n_kf)


def test_file_layout_is_the_reference(port_system, tmp_path):
    """Same keys, dtypes and shapes in both packages' files."""
    states = _port_states(port_system)
    _ref_system_holding(states).save(str(tmp_path / "ref.npz"))
    port_system.save(str(tmp_path / "port.npz"))
    with np.load(tmp_path / "ref.npz") as r, np.load(tmp_path / "port.npz") as p:
        assert sorted(r.files) == sorted(p.files)
        assert {k.split(".")[0] for k in p.files} == {"map", "loop", "tracker"}
        for k in r.files:
            assert (r[k].dtype, r[k].shape) == (p[k].dtype, p[k].shape), k
        assert p["map.pt_desc"].dtype == np.uint32


def test_port_round_trip(port_system, tmp_path):
    path = str(tmp_path / "rt.npz")
    port_system.save(path)
    got = SLAMSystem(port_system.cfg, device=CPU)
    got.load(path)
    for (_, attr) in STATES:
        for name, a, b in zip(getattr(got, attr)._fields, getattr(got, attr),
                              getattr(port_system, attr)):
            assert a.dtype == b.dtype and torch.equal(a, b), name
    for a, b in zip(got.vo.state, port_system.vo.state):
        assert torch.equal(a, b)
    assert got._n_kf_host == int(got.map.n_kf)


def test_streaming_checkpoint_holds_the_scan_state(tmp_path):
    """After the chunk driver the live tracker state is the scan carry's."""
    cfg = dataclasses.replace(convert.config_from_ref(_ref_cfg()))
    world = ref_synthetic.make_world(n_frames=3, n_points=300, n_lines=40, seed=21)
    frames = [ref_synthetic.render_frame(world, i, noise=1.0) for i in range(3)]
    slam = SLAMSystem(cfg, device=CPU, run_loop_closure=False)
    slam.run_sequence(np.stack([f[0] for f in frames]),
                      np.stack([f[1] for f in frames]), world.timestamps, chunk=2)
    slam.finish()
    path = str(tmp_path / "stream.npz")
    slam.save(path)
    got = SLAMSystem(cfg, device=CPU)
    got.load(path)
    for a, b in zip(got.vo.state, slam._scan_carry[0]):
        assert torch.equal(a, b)
    assert torch.equal(got.map.kf_pose, slam.map.kf_pose)
