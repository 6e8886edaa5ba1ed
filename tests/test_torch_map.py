"""The map back-end (models/map.py) against the reference, stage by stage
on the reference's own upstream maps, at the capacities of tests/test_map.py
(376x240, n_pt=256, a 2048-point pool, 32 keyframes).

Held exactly: every integer, index, bool and descriptor leaf of the map
after each stage (associations, slot allocation, observation rings,
covisibility, medoid descriptors, the BA window and its slot maps, the
culled and fused masks), and the float leaves that are copies or gathers.
Floats the port computes (landmark positions ``R x + t``) within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfplslam_tpu.config import CameraParams, CapacityParams, Config, OrbParams
from gfplslam_tpu.io import synthetic
from gfplslam_tpu.models import ba as ref_ba
from gfplslam_tpu.models import frame as ref_frame
from gfplslam_tpu.models import map as ref_map

from gfplslam_torch.models import map as map_ops
from gfplslam_torch.utils import convert

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def assert_same(got, want, float_tol=0.0, what=""):
    """Port NamedTuple == reference NamedTuple: exact for integer, bool and
    descriptor leaves, within ``float_tol`` for float leaves."""
    got = convert.to_numpy(got)
    for name, g, w in zip(got._fields, got, want):
        if isinstance(w, tuple):
            assert_same(g, w, float_tol, f"{what}.{name}")
            continue
        w = np.asarray(w)
        assert g.shape == w.shape, (what, name, g.shape, w.shape)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=0, atol=float_tol,
                                       err_msg=f"{what}.{name}")
        else:
            np.testing.assert_array_equal(g, w.astype(g.dtype) if w.dtype != bool
                                          else w, err_msg=f"{what}.{name}")


@pytest.fixture(scope="module")
def case():
    cfg_ref = Config(
        cap=CapacityParams(n_pt=256, n_ln=128, n_kf_window=4, n_kf_max=32,
                           n_map_pt=2048, n_map_ln=512,
                           n_obs_pt=1024, n_obs_ln=256),
        orb=OrbParams(nlevels=2),
        camera=CameraParams(width=376, height=240, fx=217.6, fy=217.6,
                            cx=183.7, cy=126.1, baseline=0.11))
    world = synthetic.make_world(n_frames=4, n_points=250, n_lines=40, seed=6)
    frames = []
    for i in range(4):
        il, ir = synthetic.render_frame(world, i, noise=1.0)
        frames.append(ref_frame.process_stereo_pair(
            jnp.asarray(il), jnp.asarray(ir), cfg_ref, jnp.asarray(20.0)))
    maps = [ref_map.initialize_map(cfg_ref, ref_map.empty_map(cfg_ref), frames[0])]
    matches, t_rels = [], []
    for i in (1, 2, 3):
        t_rel = (np.linalg.inv(world.poses[i - 1]) @ world.poses[i]).astype(np.float32)
        m, match = ref_map.add_keyframe(cfg_ref, maps[-1], frames[i], jnp.asarray(t_rel))
        maps.append(m)
        matches.append(_np(match))
        t_rels.append(t_rel)
    return dict(cfg_ref=cfg_ref, cfg=convert.config_from_ref(cfg_ref),
                frames=[_np(f) for f in frames], maps=[_np(m) for m in maps],
                matches=matches, t_rels=t_rels)


def _port(x):
    return convert.to_torch(x, CPU)


@pytest.mark.parametrize("op", ["set", "add", "max", "or"])
def test_scatters_follow_the_reference(op):
    """Duplicate, negative and out-of-range indices: ``set_rows`` keeps the
    last write and wraps negatives as XLA's CPU scatter does, the others
    sum / take the max, and an index past the end is dropped."""
    rng = np.random.default_rng(3)
    idx = np.concatenate([rng.integers(-3, 12, 40), [9, 9, 10, -1, 0, 0]]).astype(np.int32)
    base = rng.integers(-50, 50, (10, 2)).astype(np.int32)
    vals = rng.integers(-100, 100, (len(idx), 2)).astype(np.int32)
    x = jnp.asarray(base)
    if op == "set":
        want = x.at[idx].set(vals, mode="drop")
        got = map_ops.set_rows(torch.from_numpy(base), torch.from_numpy(idx),
                               torch.from_numpy(vals))
    elif op == "add":
        want = x.at[idx].add(vals, mode="drop")
        got = map_ops.add_rows(torch.from_numpy(base), torch.from_numpy(idx),
                               torch.from_numpy(vals))
    elif op == "max":
        want = x[:, 0].at[idx].max(vals[:, 0], mode="drop")
        got = map_ops.max_rows(torch.from_numpy(base[:, 0].copy()),
                               torch.from_numpy(idx), torch.from_numpy(vals[:, 0].copy()))
    else:
        flag = vals[:, 0] > 0
        want = jnp.zeros(10, bool).at[idx].max(flag, mode="drop")
        got = map_ops.or_rows(torch.zeros(10, dtype=torch.bool), torch.from_numpy(idx),
                              torch.from_numpy(flag))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_alloc_slots_exact():
    rng = np.random.default_rng(4)
    for n_free_frac, n_want in ((0.5, 40), (0.05, 40), (1.0, 64)):
        free = rng.random(64) < n_free_frac
        want = rng.random(n_want) < 0.6
        np.testing.assert_array_equal(
            map_ops._alloc_slots(torch.from_numpy(free), torch.from_numpy(want)).numpy(),
            np.asarray(ref_map._alloc_slots(jnp.asarray(free), jnp.asarray(want))))


def test_empty_and_initialize_map(case):
    cfg = case["cfg"]
    assert_same(map_ops.empty_map(cfg, CPU), _np(ref_map.empty_map(case["cfg_ref"])))
    m = map_ops.initialize_map(cfg, map_ops.empty_map(cfg, CPU), _port(case["frames"][0]))
    assert_same(m, case["maps"][0], 1e-5, "init")


@pytest.mark.parametrize("kf", [1, 2, 3])
def test_add_keyframe_on_reference_map(case, kf):
    """Association (the Hamming matrices against the point and line pools,
    projection and line-distance gates, per-target dedup), landmark
    creation, observation append, covisibility and the medoid refresh."""
    m, match = map_ops.add_keyframe(case["cfg"], _port(case["maps"][kf - 1]),
                                    _port(case["frames"][kf]),
                                    torch.from_numpy(case["t_rels"][kf - 1]))
    want = case["matches"][kf - 1]
    assert int(want.n_pt_matched) > 20
    np.testing.assert_array_equal(match.pt_lm_idx.numpy(), want.pt_lm_idx)
    np.testing.assert_array_equal(match.ln_lm_idx.numpy(), want.ln_lm_idx)
    assert int(match.n_pt_matched) == int(want.n_pt_matched)
    assert int(match.n_ln_matched) == int(want.n_ln_matched)
    assert_same(m, case["maps"][kf], 1e-5, f"kf{kf}")


def test_local_masks_exact(case):
    m_ref = case["maps"][3]
    m = _port(m_ref)
    for kf in (0, 2, 3):
        np.testing.assert_array_equal(
            map_ops.local_kf_mask(case["cfg"], m, torch.tensor(kf)).numpy(),
            np.asarray(ref_map.local_kf_mask(case["cfg_ref"], m_ref, jnp.asarray(kf))))
        for got, want in zip(
                map_ops.local_landmark_masks(case["cfg"], m, torch.tensor(kf)),
                ref_map.local_landmark_masks(case["cfg_ref"], m_ref, jnp.asarray(kf))):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("global_ba", [False, True])
def test_build_local_ba_problem_exact(case, global_ba):
    """The window, its slot maps (whose padded slots write index 0 after the
    real ones: the last write wins), frozen KFs and the observation ranking:
    every output equal."""
    m_ref = case["maps"][3]
    got = map_ops.build_local_ba_problem(case["cfg"], _port(m_ref), global_ba=global_ba)
    want = _np(ref_map.build_local_ba_problem(case["cfg_ref"], m_ref, global_ba=global_ba))
    assert_same(got[0], want[0], 0.0, "prob")
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy(), w)
    assert int(np.asarray(want[0].po_valid).sum()) > 50


def test_apply_ba_result_and_outliers_exact(case):
    """Write-back and outlier deletion from the reference's own BA result
    (with three observations forced out)."""
    cfg_ref, m_ref = case["cfg_ref"], case["maps"][3]
    prob, w_ids, p_ids, l_ids, po_src, lo_src = ref_map.build_local_ba_problem(cfg_ref, m_ref)
    res = ref_ba.solve_ba(cfg_ref.camera, prob, max_iters=5)
    res = res._replace(po_inlier=res.po_inlier.at[jnp.asarray([0, 5, 9])].set(False))
    m2_ref = ref_map.apply_ba_result(cfg_ref, m_ref, res, w_ids, p_ids, l_ids)
    m3_ref = _np(ref_map.apply_ba_outliers(cfg_ref, m2_ref, res, po_src, lo_src))
    res_t = _port(_np(res))
    m2 = map_ops.apply_ba_result(case["cfg"], _port(m_ref), res_t,
                                 *(torch.from_numpy(np.array(x)) for x in (w_ids, p_ids, l_ids)))
    assert_same(m2, _np(m2_ref), 0.0, "result")
    m3 = map_ops.apply_ba_outliers(case["cfg"], m2, res_t,
                                   torch.from_numpy(np.array(po_src)),
                                   torch.from_numpy(np.array(lo_src)))
    assert_same(m3, m3_ref, 0.0, "outliers")
    assert int(m3.po_valid.sum()) < int(m2.po_valid.sum())


def test_remove_bad_landmarks_exact(case):
    m_ref = ref_map.initialize_map(case["cfg_ref"], ref_map.empty_map(case["cfg_ref"]),
                                   jax.tree.map(jnp.asarray, case["frames"][0]))
    m_ref = m_ref._replace(n_kf=jnp.asarray(21, jnp.int32))
    want = _np(ref_map.remove_bad_landmarks(case["cfg_ref"], m_ref))
    got = map_ops.remove_bad_landmarks(case["cfg"], _port(_np(m_ref)))
    assert_same(got, want)
    assert int(got.pt_valid.sum()) == 0 and int(got.po_valid.sum()) == 0
    m3 = case["maps"][3]
    assert_same(map_ops.remove_bad_landmarks(case["cfg"], _port(m3)),
                _np(ref_map.remove_bad_landmarks(case["cfg_ref"], m3)))


def _redundant_state(cfg_ref):
    """tests/test_map.py::test_remove_redundant_kfs's map: 8 KFs all seeing
    the same 20 landmarks."""
    m = ref_map.empty_map(cfg_ref)
    n_kf, n_lm = 8, 20
    n_obs = n_kf * n_lm
    return m._replace(
        n_kf=jnp.asarray(n_kf, jnp.int32),
        kf_valid=m.kf_valid.at[:n_kf].set(True),
        pt_valid=m.pt_valid.at[:n_lm].set(True),
        pt_obs_n=m.pt_obs_n.at[:n_lm].set(n_kf),
        po_kf=m.po_kf.at[:n_obs].set(jnp.asarray(np.repeat(np.arange(n_kf), n_lm))),
        po_lm=m.po_lm.at[:n_obs].set(jnp.asarray(np.tile(np.arange(n_lm), n_kf))),
        po_valid=m.po_valid.at[:n_obs].set(True),
        full_graph=m.full_graph.at[:n_kf, :n_kf].set(n_lm))


def test_remove_redundant_kfs_exact(case):
    m_ref = _redundant_state(case["cfg_ref"])
    want, n_want = ref_map.remove_redundant_kfs(case["cfg_ref"], m_ref)
    got, n_got = map_ops.remove_redundant_kfs(case["cfg"], _port(_np(m_ref)))
    assert_same(got, _np(want))
    assert int(n_got) == int(n_want) == 1
    # and on a real map, where nothing is redundant yet
    m3 = case["maps"][3]
    got3, n3 = map_ops.remove_redundant_kfs(case["cfg"], _port(m3))
    assert_same(got3, _np(ref_map.remove_redundant_kfs(case["cfg_ref"], m3)[0]))


def _fuse_state(cfg_ref):
    """tests/test_map.py::test_fuse_loop_landmarks's map: 6 landmarks seen
    at KF2 duplicated (5 cm away, same descriptors) at KF10."""
    m = ref_map.empty_map(cfg_ref)
    rng = np.random.default_rng(5)
    n_dup = 6
    desc = rng.integers(0, 2**32, size=(n_dup, 8), dtype=np.uint32)
    pos = rng.uniform(-2, 2, (n_dup, 3)).astype(np.float32)
    return m._replace(
        n_kf=jnp.asarray(11, jnp.int32),
        kf_valid=m.kf_valid.at[:11].set(True),
        pt_desc=m.pt_desc.at[:n_dup].set(desc).at[10:10 + n_dup].set(desc),
        pt_pos=m.pt_pos.at[:n_dup].set(pos).at[10:10 + n_dup].set(pos + 0.05),
        pt_valid=m.pt_valid.at[:n_dup].set(True).at[10:10 + n_dup].set(True),
        pt_last_kf=m.pt_last_kf.at[:n_dup].set(2).at[10:10 + n_dup].set(10),
        pt_obs_n=m.pt_obs_n.at[:n_dup].set(3).at[10:10 + n_dup].set(1),
        po_kf=m.po_kf.at[:n_dup].set(2).at[n_dup:2 * n_dup].set(10),
        po_lm=m.po_lm.at[:n_dup].set(jnp.arange(n_dup))
                      .at[n_dup:2 * n_dup].set(jnp.arange(n_dup) + 10),
        po_valid=m.po_valid.at[:2 * n_dup].set(True))


def test_fuse_loop_landmarks_exact(case):
    """The Hamming kernel's fusion call (256x256 compacted sides), mutual
    best, merge bookkeeping and covisibility increments; plus the reference
    test's own gates."""
    for m_ref, kf_prev, kf_curr in ((_fuse_state(case["cfg_ref"]), 2, 10),
                                    (jax.tree.map(jnp.asarray, case["maps"][3]), 0, 3)):
        want, n_want, over_want = ref_map.fuse_loop_landmarks(
            case["cfg_ref"], m_ref, jnp.asarray(kf_prev), jnp.asarray(kf_curr))
        got, n_got, over_got = map_ops.fuse_loop_landmarks(
            case["cfg"], _port(_np(m_ref)), torch.tensor(kf_prev), torch.tensor(kf_curr))
        assert_same(got, _np(want))
        assert int(n_got) == int(n_want) and int(over_got) == int(over_want)
    # the reference test's gates, on the synthetic duplicates
    got, n_fused, _ = map_ops.fuse_loop_landmarks(
        case["cfg"], _port(_np(_fuse_state(case["cfg_ref"]))), torch.tensor(2),
        torch.tensor(10))
    assert int(n_fused) == 6
    assert not got.pt_valid[10:16].any() and got.pt_valid[:6].all()
    assert (got.pt_obs_n[:6] == 4).all()
    assert sorted(got.po_lm[6:12].tolist()) == list(range(6))
    fg = got.full_graph.numpy()
    assert fg[2, 10] + fg[10, 2] >= 6


def test_line_association_descriptor_cap(case):
    """A collinear line with inverted descriptor bits does not associate
    (tests/test_map.py's gate, on the port)."""
    m = _port(case["maps"][0])
    f = _port(case["frames"][0])
    eye = torch.eye(4)
    match = map_ops._match_frame_to_map(case["cfg"], m, f, eye, m.pt_valid, m.ln_valid)
    assert int(match.n_ln_matched) > 0
    bad = f._replace(lines=f.lines._replace(desc=~f.lines.desc))
    match2 = map_ops._match_frame_to_map(case["cfg"], m, bad, eye, m.pt_valid, m.ln_valid)
    assert int(match2.n_ln_matched) == 0
