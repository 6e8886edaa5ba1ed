"""Loop closure (models/loop.py) against the reference: BoW histograms and
the conf-matrix row, loop candidates, geometric verification, pose-graph
edges and optimization, rigid landmark correction. Inputs are the
reference's own frames and loop states, at the sizes of tests/test_loop.py
(376x240, n_pt=256, 32 keyframes, 128 words).

Held exactly: BoW histograms, document frequencies, feature counts, the
feature snapshots, loop candidates, ``verify_loop``'s ``accepted`` flag (and, where
accepted, its inlier count), and the pose-graph edge indices and validity. Floats: the
conf-matrix row and dispersions 1e-5; an accepted relative pose 1e-4
and its robust error 1e-3 relative (a converging f32 GN over MAD-gated
inliers); edge measurements 1e-6; the optimized pose graph
1e-4 relative; rigid correction 1e-5."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfplslam_tpu.config import CameraParams, CapacityParams, Config, OrbParams, SlamParams
from gfplslam_tpu.io import synthetic
from gfplslam_tpu.models import frame as ref_frame
from gfplslam_tpu.models import loop as ref_loop
from gfplslam_tpu.utils import se3 as ref_se3

from gfplslam_torch.models import loop as loop_ops
from gfplslam_torch.utils import convert

from test_loop import _synthetic_pair_state

torch.set_num_threads(2)
CPU = torch.device("cpu")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(x):
    return convert.to_torch(x, CPU)


def _t(x):
    return torch.from_numpy(np.array(x))


def _cfg(vocab_k=128):
    return Config(
        cap=CapacityParams(n_pt=256, n_ln=128, n_kf_max=32, vocab_k=vocab_k),
        orb=OrbParams(nlevels=2),
        camera=CameraParams(width=376, height=240, fx=217.6, fy=217.6,
                            cx=183.7, cy=126.1, baseline=0.11),
        slam=SlamParams(lc_kf_dist=4, lc_kf_max_dist=3, lc_nkf_closest=1))


def _frames(cfg, n, seed=8, revisit=None):
    """tests/test_loop.py's make_frames: a world whose last pose may
    revisit an earlier one."""
    world = synthetic.make_world(n_frames=n, n_points=250, n_lines=40, seed=seed)
    if revisit is not None:
        world.poses[-1] = world.poses[revisit].copy()
    return [_np(ref_frame.process_stereo_pair(
        *map(jnp.asarray, synthetic.render_frame(world, i, noise=1.0)), cfg,
        jnp.asarray(20.0))) for i in range(n)]


@pytest.fixture(scope="module")
def revisit():
    """Eight keyframes, the last at KF1's pose, inserted by the reference;
    ``states[i]`` is the loop state before KF i."""
    cfg = _cfg()
    frames = _frames(cfg, 8, revisit=1)
    states = [ref_loop.empty_loop_state(cfg)]
    for i, f in enumerate(frames):
        states.append(ref_loop.insert_kf_bow(cfg, states[-1], jnp.asarray(i),
                                             jax.tree.map(jnp.asarray, f)))
    return dict(cfg_ref=cfg, cfg=convert.config_from_ref(cfg), frames=frames,
                states=[_np(s) for s in states])


def assert_loop_state(got, want, tol=1e-5):
    got = convert.to_numpy(got)
    for name, g, w in zip(got._fields, got, want):
        if w.dtype.kind == "f" and name in ("conf", "std_pt", "std_ln"):
            np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_bow_vector_exact(revisit):
    """The Hamming kernel's vocabulary calls (points and lines) and the
    nearest-word histogram."""
    vp, vl = ref_loop.active_vocab(128)
    pvp, pvl = (_t(np.ascontiguousarray(v).view(np.int32))
                for v in loop_ops.active_vocab(128))
    for f in revisit["frames"][:3]:
        for desc, valid, v, pv in ((f.points.desc, f.points.valid, vp, pvp),
                                   (f.lines.desc, f.lines.valid, vl, pvl)):
            want = np.asarray(ref_loop.bow_vector(jnp.asarray(desc), jnp.asarray(valid), v))
            got = loop_ops.bow_vector(_t(np.array(desc).view(np.int32)),
                                      _t(valid), pv)
            np.testing.assert_array_equal(got.numpy(), want)
            assert want.sum() == valid.sum() > 0


@pytest.mark.parametrize("vocab_k", [128, 64])
def test_insert_kf_bow_on_reference_states(revisit, vocab_k):
    """Each insertion on the reference's previous state. 128 words: the
    shipped codebook with frozen idf; 64: random anchors, online idf."""
    if vocab_k == 128:
        cfg_ref, cfg, states = revisit["cfg_ref"], revisit["cfg"], revisit["states"]
    else:
        cfg_ref = dataclasses.replace(revisit["cfg_ref"], cap=dataclasses.replace(
            revisit["cfg_ref"].cap, vocab_k=vocab_k))
        cfg = convert.config_from_ref(cfg_ref)
        states = [ref_loop.empty_loop_state(cfg_ref)]
        for i, f in enumerate(revisit["frames"]):
            states.append(ref_loop.insert_kf_bow(cfg_ref, states[-1], jnp.asarray(i),
                                                 jax.tree.map(jnp.asarray, f)))
        states = [_np(s) for s in states]
    assert (ref_loop.active_idf(vocab_k) is not None) == (vocab_k == 128)
    for i, f in enumerate(revisit["frames"]):
        got = loop_ops.insert_kf_bow(cfg, _port(states[i]), torch.tensor(i), _port(f))
        assert_loop_state(got, states[i + 1])
    assert states[-1].conf[7, :7].max() > 0


def test_loop_state_from_empty(revisit):
    assert_loop_state(loop_ops.empty_loop_state(revisit["cfg"], CPU),
                      _np(ref_loop.empty_loop_state(revisit["cfg_ref"])), 0.0)


def test_look_for_loop_candidates_exact(revisit):
    """Every KF of the revisit state, and random conf matrices with random
    covisibility, at several thresholds."""
    rng = np.random.default_rng(9)
    cases = [(revisit["cfg_ref"], revisit["states"][-1].conf,
              np.zeros((32, 32), np.int32), range(8))]
    for lc_kf_max_dist, closest in ((3, 1), (2, 2), (5, 4)):
        cfg_ref = dataclasses.replace(revisit["cfg_ref"], slam=SlamParams(
            lc_kf_dist=4, lc_kf_max_dist=lc_kf_max_dist, lc_nkf_closest=closest))
        conf = rng.uniform(0, 1, (32, 32)).astype(np.float32)
        conf = np.triu(conf, 1) + np.triu(conf, 1).T
        fg = rng.integers(0, 60, (32, 32)).astype(np.int32)
        cases.append((cfg_ref, conf, fg, range(0, 32, 3)))
    n_found = 0
    for cfg_ref, conf, fg, kfs in cases:
        cfg = convert.config_from_ref(cfg_ref)
        ls_ref = ref_loop.empty_loop_state(cfg_ref)._replace(conf=jnp.asarray(conf))
        ls = loop_ops.empty_loop_state(cfg, CPU)._replace(conf=_t(conf))
        for kf in kfs:
            want = int(ref_loop.look_for_loop_candidates(
                cfg_ref, ls_ref, jnp.asarray(fg), jnp.asarray(kf)))
            assert int(loop_ops.look_for_loop_candidates(
                cfg, ls, _t(fg), torch.tensor(kf))) == want, (kf, want)
            n_found += want >= 0
    assert n_found > 3


def _verify_both(cfg_ref, ls_ref, prev, curr):
    want = _np(ref_loop.verify_loop(cfg_ref, jax.tree.map(jnp.asarray, ls_ref),
                                    jnp.asarray(prev), jnp.asarray(curr)))
    got = loop_ops.verify_loop(convert.config_from_ref(cfg_ref), _port(ls_ref),
                               torch.tensor(prev), torch.tensor(curr))
    assert bool(got.accepted) == bool(want.accepted)
    if want.accepted:
        # a rejected pair's GN may wander anywhere; an accepted one converged
        assert int(got.n_inliers) == int(want.n_inliers)
        np.testing.assert_allclose(got.t_rel.numpy(), want.t_rel, rtol=0, atol=1e-4)
        np.testing.assert_allclose(float(got.err), float(want.err), rtol=1e-3)
    return bool(want.accepted)


def test_verify_loop_revisit_and_unrelated(revisit):
    """The Hamming kernel's two snapshot calls, mutual best, the robust GN
    from identity and the five gates: the revisit (KF7 at KF1's pose) is
    accepted, unrelated pairs are rejected, as by the reference."""
    ls = revisit["states"][-1]
    assert _verify_both(revisit["cfg_ref"], ls, 1, 7)
    _verify_both(revisit["cfg_ref"], ls, 0, 7)   # whichever way it goes
    cfg = revisit["cfg_ref"]
    fa = _frames(cfg, 2, seed=8)
    fb = _frames(cfg, 2, seed=99)
    ls2 = ref_loop.empty_loop_state(cfg)
    ls2 = ref_loop.insert_kf_bow(cfg, ls2, jnp.asarray(0), jax.tree.map(jnp.asarray, fa[0]))
    ls2 = ref_loop.insert_kf_bow(cfg, ls2, jnp.asarray(1), jax.tree.map(jnp.asarray, fb[0]))
    assert not _verify_both(cfg, _np(ls2), 0, 1)


@pytest.mark.parametrize("inlier_frac,accept", [(0.4, True), (0.05, False)])
def test_verify_loop_outliers(revisit, inlier_frac, accept):
    """tests/test_loop.py's high-outlier states: 60% wrong matches are
    stripped and accepted, 95% are rejected."""
    rng = np.random.default_rng(3 if accept else 4)
    true_t = np.eye(4, dtype=np.float32)
    true_t[:3, 3] = [0.25, -0.1, 0.3]
    if accept:
        c, s = np.cos(0.06), np.sin(0.06)
        true_t[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    ls = _np(_synthetic_pair_state(revisit["cfg_ref"], rng, true_t, inlier_frac))
    assert _verify_both(revisit["cfg_ref"], ls, 0, 1) == accept


def _drift_chain(k):
    """tests/test_loop.py::test_pose_graph_closes_drift's chain."""
    poses = [np.eye(4, dtype=np.float32)]
    for _ in range(1, k):
        t = np.eye(4, dtype=np.float32)
        t[0, 3] = 0.2
        t[1, 3] = 0.02
        poses.append(poses[-1] @ t)
    return np.stack(poses)


def _random_graph(rng, k):
    tw = rng.normal(0, 0.05, (k, 6)).astype(np.float32)
    tw[:, 2] += 0.3 * np.arange(k)
    poses = np.asarray(jax.vmap(ref_se3.expmap_se3)(jnp.asarray(tw)))
    valid = rng.random(k) < 0.85
    valid[0] = True
    fg = np.tril(rng.integers(0, 200, (k, k)), -1).astype(np.int32)
    return poses, valid, fg


@pytest.mark.parametrize("which", ["drift", "random"])
def test_build_edges_exact(which):
    rng = np.random.default_rng(12)
    if which == "drift":
        k = 8
        poses, valid, fg = _drift_chain(k), np.ones(k, bool), np.zeros((k, k), np.int32)
        lc_i, lc_j, lc_valid, max_edges = [0], [k - 1], None, 16
        lc_t = np.eye(4, dtype=np.float32)[None]
        lc_t[0, 0, 3] = 1.4
    else:
        k = 24
        poses, valid, fg = _random_graph(rng, k)
        lc_i, lc_j = [1, 2, 0, 0], [20, 22, 0, 0]
        lc_valid = [True, True, False, False]
        lc_t = np.stack([np.eye(4, dtype=np.float32)] * 4)
        lc_t[:2, :3, 3] = rng.normal(0, 0.1, (2, 3))
        max_edges = 4 * k
    want = _np(ref_loop.build_edges(
        jnp.asarray(poses), jnp.asarray(valid), jnp.asarray(fg), 100,
        jnp.asarray(lc_i, jnp.int32), jnp.asarray(lc_j, jnp.int32), jnp.asarray(lc_t),
        max_edges=max_edges, lc_valid=None if lc_valid is None else jnp.asarray(lc_valid)))
    got = loop_ops.build_edges(
        _t(poses), _t(valid), _t(fg), 100,
        lc_i, lc_j, _t(lc_t), max_edges=max_edges, lc_valid=lc_valid)
    np.testing.assert_array_equal(got.i.numpy(), want.i)
    np.testing.assert_array_equal(got.j.numpy(), want.j)
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    np.testing.assert_allclose(got.t_ij.numpy(), want.t_ij, rtol=0, atol=1e-6)
    if which == "random":
        assert want.valid[k - 1:-4].sum() > 5   # covisibility edges selected


@pytest.mark.parametrize("which", ["drift", "random"])
def test_optimize_pose_graph(which):
    """The reference's drift-closing problem (and its gates) and a random
    24-KF graph with holes and soft loop edges: 1e-4 relative."""
    rng = np.random.default_rng(13)
    if which == "drift":
        k = 8
        poses, valid, fg = _drift_chain(k), np.ones(k, bool), np.zeros((k, k), np.int32)
        lc = (np.asarray([0]), np.asarray([k - 1]), np.eye(4, dtype=np.float32)[None])
        lc[2][0, 0, 3] = 1.4
        iters, max_edges = 30, 16
    else:
        k = 24
        poses, valid, fg = _random_graph(rng, k)
        lc_t = np.stack([np.eye(4, dtype=np.float32)] * 2)
        lc_t[:, :3, 3] = rng.normal(0, 0.1, (2, 3))
        lc = (np.asarray([1, 2]), np.asarray([20, 22]), lc_t)
        iters, max_edges = 50, 4 * k
    fixed = np.zeros(k, bool)
    fixed[0] = True
    e_ref = ref_loop.build_edges(jnp.asarray(poses), jnp.asarray(valid), jnp.asarray(fg),
                                 100, *(jnp.asarray(x) for x in lc), max_edges=max_edges)
    want = np.asarray(ref_loop.optimize_pose_graph(
        jnp.asarray(poses), jnp.asarray(valid), e_ref, jnp.asarray(fixed), iters=iters))
    e = loop_ops.build_edges(_t(poses), _t(valid),
                             _t(fg), 100, *(_t(x) for x in lc),
                             max_edges=max_edges)
    got = loop_ops.optimize_pose_graph(_t(poses), _t(valid),
                                       e, _t(fixed), iters=iters).numpy()
    assert np.abs(got - want).max() < 1e-4 * max(np.abs(want).max(), 1.0)
    assert np.abs(got - poses).max() > 1e-3          # it did move
    if which == "drift":
        assert abs(got[-1, 0, 3] - 1.4) < 0.03 and abs(got[-1, 1, 3]) < 0.05
        np.testing.assert_allclose(got[0], np.eye(4), atol=1e-5)


def test_rigid_correct_landmarks():
    rng = np.random.default_rng(14)
    k, n = 6, 50
    kf_old, _, _ = _random_graph(rng, k)
    kf_new, _, _ = _random_graph(rng, k)
    lm = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    lm_kf = rng.integers(0, k, n).astype(np.int32)
    ok = rng.random(n) < 0.7
    want = np.asarray(ref_loop.rigid_correct_landmarks(
        *(jnp.asarray(x) for x in (kf_old, kf_new, lm, lm_kf, ok))))
    got = loop_ops.rigid_correct_landmarks(
        *(_t(x) for x in (kf_old, kf_new, lm, lm_kf, ok))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[~ok], lm[~ok])


def test_topk_snapshot_exact():
    """Best score first with stable ties, and the zero-padded branch."""
    rng = np.random.default_rng(5)
    score = np.round(rng.uniform(0, 20, 64)).astype(np.float32)   # many ties
    valid = rng.uniform(0, 1, 64) < 0.8
    payload = np.arange(64, dtype=np.float32)[:, None]
    for n in (64, 8):
        want = ref_loop._topk_snapshot(jnp.asarray(valid[:n]), jnp.asarray(score[:n]), 16,
                                       jnp.asarray(payload[:n]))
        got = loop_ops._topk_snapshot(_t(valid[:n]),
                                      _t(score[:n]), 16,
                                      _t(payload[:n]))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
