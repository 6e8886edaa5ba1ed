"""The landmark-sharded BA (``parallel/dist_ba.py``) over 4 gloo ranks on
the CPU, against the port's dense solve and the reference's sharded solver
on its 4-device virtual mesh: the four tests of ``tests/test_dist.py``,
``shard_problem_by_landmark`` exactly, ``SLAMSystem.finish``'s sharded
route, and ``apps/bench_dist_ba.py``.

One group of 4 spawned ranks (``multihost.launch``) runs every sharded
solve of this file; each rank returns its full result, and the ranks must
agree exactly.

Tolerances are ``tests/test_dist.py``'s: poses rtol/atol 5e-3 on the
4-keyframe window (``tol=0``, the full iteration budget), rtol 1e-3 /
atol 1e-4 on the >64-keyframe global BA. The final mean robust error of
the 4-keyframe window is compared against the dense solve's spread, not
its one value: reordering the observations of the dense problem (the same
problem, its sums in another order) moves the port's dense error between
0.030 and 0.057, and the reference's between 0.031 and 0.055 (its 2-device
sharded solve: 0.039 against its dense 0.049). A few low-parallax
landmarks with 1e8 stiffness along their cut direction decide it
(ROADMAP C). So the sharded error must lie within 5e-3 of the span of the
dense errors over the identity and four fixed permutations.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from gfplslam_tpu.apps import bench_dist_ba as ref_bench
from gfplslam_tpu.config import (CameraParams as RefCamera, CapacityParams as RefCap,
                                 Config as RefConfig, OrbParams as RefOrb)
from gfplslam_tpu.models import map as ref_map
from gfplslam_tpu.parallel import dist_ba as ref_dist

from gfplslam_torch.apps import bench_dist_ba
from gfplslam_torch.config import CameraParams
from gfplslam_torch.models import ba
from gfplslam_torch.models.slam import SLAMSystem
from gfplslam_torch.parallel import dist_ba, multihost, workers
from gfplslam_torch.utils import convert

from test_ba import build_problem
from test_dist import _fabricate_map

torch.set_num_threads(2)
CPU = torch.device("cpu")
N = 4
PERMUTATIONS = 4
REF_GLOBAL_CFG = RefConfig(
    cap=RefCap(n_pt=256, n_ln=128, n_kf_window=4, n_kf_max=96, n_map_pt=128,
               n_map_ln=64, n_obs_pt=128, n_obs_ln=64),
    orb=RefOrb(nlevels=2),
    camera=RefCamera(width=376, height=240, fx=217.6, fy=217.6, cx=183.7,
                     cy=126.1, baseline=0.11))
GLOBAL_CFG = convert.config_from_ref(REF_GLOBAL_CFG)


def _cam(ref_cam) -> CameraParams:
    return CameraParams(**dataclasses.asdict(ref_cam))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _window(k=4, p=64, l=16):
    """``tests/test_dist.py``'s window: rng seed 0, as its ``rng`` fixture."""
    cam_ref, gt, _, prob_ref = build_problem(np.random.default_rng(0), k=k, p=p, l=l)
    return cam_ref, gt, prob_ref, convert.to_torch(_np(prob_ref), CPU)


@pytest.fixture(scope="module")
def case():
    cam_ref, gt, prob_ref, prob = _window()
    m_ref = _fabricate_map(REF_GLOBAL_CFG, n_kf=80, n_pt=96)
    gprob_ref = ref_map.build_local_ba_problem(REF_GLOBAL_CFG, m_ref, global_ba=True)[0]
    gprob = convert.to_torch(_np(gprob_ref), CPU)
    cam = _cam(cam_ref)
    jobs = [(workers.sharded_ba, (cam, dist_ba.shard_problem_by_landmark(prob, N),
                                  "cpu", 10, 0.0)),
            (workers.sharded_ba, (cam, dist_ba.shard_problem_by_landmark(prob, N),
                                  "cpu", 15)),
            (workers.sharded_ba, (GLOBAL_CFG.camera,
                                  dist_ba.shard_problem_by_landmark(gprob, N),
                                  "cpu", 6)),
            (workers.finish_global_ba, (GLOBAL_CFG, convert.to_torch(_np(m_ref), CPU),
                                        "cpu"))]
    ranks = multihost.launch(workers.run_jobs, N, jobs, device="cpu")
    return dict(cam_ref=cam_ref, cam=cam, gt=gt, prob_ref=prob_ref, prob=prob,
                m_ref=m_ref, gprob_ref=gprob_ref, gprob=gprob, ranks=ranks,
                mesh=ref_dist.make_mesh(N))


def _equal(a, b) -> bool:
    if torch.is_tensor(a):
        return a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def test_ranks_return_equal_results(case):
    """Every rank returns the same full result of every job."""
    for other in case["ranks"][1:]:
        assert _equal(case["ranks"][0], other)


def test_sharded_matches_single_device(case):
    """test_dist.py's first test: the sharded solve (4 ranks) against the
    dense one and against the reference's sharded solve on its 4-device
    mesh, both at ``tol=0`` and 10 iterations."""
    res_dist = case["ranks"][0][0][0]
    res_single = ba.solve_ba(case["cam"], case["prob"], max_iters=10, tol=0.0)
    ref_sharded = ref_dist.shard_problem_by_landmark(case["prob_ref"], N)
    ref_dist_res = ref_dist.solve_ba_sharded(case["cam_ref"], ref_sharded, case["mesh"],
                                             max_iters=10, tol=0.0)
    np.testing.assert_allclose(res_dist.kf_pose.numpy(), res_single.kf_pose.numpy(),
                               rtol=5e-3, atol=5e-3)
    np.testing.assert_allclose(res_dist.kf_pose.numpy(), np.asarray(ref_dist_res.kf_pose),
                               rtol=5e-3, atol=5e-3)
    assert int(res_dist.iters) == int(ref_dist_res.iters) == 10
    prob = case["prob"]
    errs = [float(res_single.err)]
    for seed in range(PERMUTATIONS):
        perm = torch.as_tensor(np.random.default_rng(seed).permutation(prob.po_kf.shape[0]))
        shuffled = prob._replace(**{f: getattr(prob, f)[perm] for f in (
            "po_kf", "po_lm", "po_uv", "po_sigma2", "po_valid")})
        errs.append(float(ba.solve_ba(case["cam"], shuffled, max_iters=10,
                                      tol=0.0).err))
    lo, hi = min(errs) - 5e-3, max(errs) + 5e-3
    assert lo < float(res_dist.err) < hi, (float(res_dist.err), errs)
    assert lo < float(ref_dist_res.err) < hi, (float(ref_dist_res.err), errs)


def test_sharded_recovers_poses(case):
    """test_dist.py's second test: every keyframe within 5e-3 (twist norm)
    of the ground truth after 15 iterations."""
    from gfplslam_torch.utils import se3
    est = case["ranks"][0][1][0].kf_pose.numpy()
    for i, gt in enumerate(case["gt"]):
        rel = np.linalg.inv(gt) @ est[i]
        d = se3.logmap_se3(torch.as_tensor(rel.astype(np.float32))).numpy()
        assert np.linalg.norm(d) < 5e-3, (i, d)


@pytest.mark.parametrize("which", ["window_k3", "window_k4", "global_80kf"])
def test_shard_partition_exact(case, which):
    """test_dist.py's third test, plus every output of
    ``shard_problem_by_landmark`` (permutations included) equal to the
    reference's, dtypes too."""
    if which == "global_80kf":
        prob_ref, prob = case["gprob_ref"], case["gprob"]
    else:
        _, _, prob_ref, prob = _window(k=3, p=32, l=8) if which == "window_k3" else \
            (None, None, case["prob_ref"], case["prob"])
    got = dist_ba.shard_problem_by_landmark(prob, N, return_perm=True)
    want = ref_dist.shard_problem_by_landmark(prob_ref, N, return_perm=True)
    for name, a, b in zip(list(got[0]._fields) + ["po_perm", "lo_perm"],
                          list(got[0]) + list(got[1:]), list(want[0]) + list(want[1:])):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    sharded = got[0]
    assert int(sharded.po_valid.sum()) == int(prob.po_valid.sum())
    po_lm = sharded.po_lm[sharded.po_valid].numpy()
    per_obs = sharded.po_kf.shape[0] // N
    block = sharded.pt_pos.shape[0] // N
    pos = np.nonzero(sharded.po_valid.numpy())[0]
    assert np.all(po_lm // block == pos // per_obs)


def test_global_ba_sharded_matches_dense_over_64_kfs(case):
    """test_dist.py's fourth test: the 80-keyframe global BA, sharded over
    4 ranks, against the dense solve and the reference's sharded solve."""
    prob = case["gprob"]
    assert int(prob.kf_valid.sum()) == 80
    res_dist = case["ranks"][0][2][0]
    res_single = ba.solve_ba(GLOBAL_CFG.camera, prob, max_iters=6)
    np.testing.assert_allclose(res_dist.kf_pose.numpy(), res_single.kf_pose.numpy(),
                               rtol=1e-3, atol=1e-4)
    ref_res = ref_dist.solve_ba_sharded(
        REF_GLOBAL_CFG.camera, ref_dist.shard_problem_by_landmark(case["gprob_ref"], N),
        case["mesh"], max_iters=6)
    np.testing.assert_allclose(res_dist.kf_pose.numpy(), np.asarray(ref_res.kf_pose),
                               rtol=1e-3, atol=1e-4)


def test_finish_sharded_route(case):
    """``SLAMSystem.finish(run_global_ba=True)`` on every rank of a 4-rank
    group takes the sharded route; its map agrees with the dense finish
    (no group) and the integer fields are equal. Poses rtol 1e-3, atol
    5e-4: the finish runs ``max_iters_lba`` (20) iterations, not the 6 of
    the test above, and the two summation orders drift further apart
    (measured: 1.06e-4 at most, on translations of up to 4 m)."""
    slam = SLAMSystem(GLOBAL_CFG, device=CPU)
    slam.map = convert.to_torch(_np(case["m_ref"]), CPU)
    slam._n_kf_host = int(slam.map.n_kf)
    slam.finish(run_global_ba=True)
    dense = slam.map
    got = case["ranks"][0][3]
    np.testing.assert_allclose(got.kf_pose.numpy(), dense.kf_pose.numpy(),
                               rtol=1e-3, atol=5e-4)
    for name, a, b in zip(got._fields, got, dense):
        if a.dtype in (torch.bool, torch.int32, torch.int64):
            assert torch.equal(a, b), name
    # the global BA moved the fabricated poses
    assert not torch.equal(got.kf_pose, slam.map.kf_pose.new_tensor(
        np.asarray(case["m_ref"].kf_pose)))


def test_chip_smoke_map_is_the_reference_fixture(case):
    """``chip_smoke.py``'s 80-keyframe map (built without JAX) equals
    ``tests/test_dist.py``'s fixture field by field."""
    import chip_smoke
    got = chip_smoke._fabricated_map(GLOBAL_CFG, CPU)
    want = convert.to_torch(_np(case["m_ref"]), CPU)
    for name, a, b in zip(got._fields, got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_make_problem_exact():
    """``bench_dist_ba.make_problem`` at acceptance config 5's size equals
    the reference's arrays, dtypes included."""
    got = bench_dist_ba.make_problem(16, 8064, 1008, CameraParams(), seed=0)
    want = ref_bench.make_problem(16, 8064, 1008, RefCamera(), seed=0)
    for name, a, b in zip(got._fields, got, want):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


def test_bench_dist_ba_reports(capsys):
    """``bench_dist_ba --device cpu --ranks 2``: the reference's JSON keys,
    one timing per group size, finite."""
    out = bench_dist_ba.main(["--device", "cpu", "--ranks", "2", "--kfs", "3",
                              "--points", "64", "--lines", "16", "--iters", "2",
                              "--reps", "1"])
    assert {"metric", "problem", "reps", "seed", "aggregation", "ms_per_iter",
            "scaling_efficiency"} <= set(out)
    assert set(out["ms_per_iter"]) == {"1", "2"} and out["scaling_efficiency"]["1"] == 1.0
    assert all(np.isfinite(v) and v > 0 for v in out["ms_per_iter"].values())
    assert out["backend"] == "gloo"
