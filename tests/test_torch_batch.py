"""Multi-sequence batch VO (``parallel/batch.py::run_vo_batch``) against
the reference's on its 4-device virtual mesh: ``tests/test_batch_parallel.py``'s
4 sequences of 4 frames at 188x120, run by the port with no group (the
sequences in turn on one device) and split over 4 gloo ranks on the CPU.

The port over 4 ranks and with no group run the same ops on the same data,
so their outputs are equal. Against the reference, per sequence: the
keyframe and acceptance flags equal on every frame, the inlier counts on
the first two tracked frames (``tests/test_torch_vo.py`` holds the first
three records so), poses within 0.08 m aligned ATE of the reference's
trajectory (that file's VO parity tolerance), and each within the
reference test's own 0.2 m ATE gate against the ground truth. Later
inlier counts follow the pose GN, which stops before convergence: on
sequence 3's last frame the reference itself counts 14 point inliers on
its mesh and 11 unsharded or in ``run_vo_scan`` alone.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gfplslam_tpu.config import (CameraParams as RefCamera, CapacityParams as RefCap,
                                 Config as RefConfig, OrbParams as RefOrb)
from gfplslam_tpu.io import synthetic as ref_synthetic
from gfplslam_tpu.parallel import dist_ba as ref_dist
from gfplslam_tpu.parallel.batch import run_vo_batch as ref_run_vo_batch

from gfplslam_torch.io import synthetic
from gfplslam_torch.parallel import multihost, workers
from gfplslam_torch.parallel.batch import run_vo_batch
from gfplslam_torch.utils import convert
from gfplslam_torch.utils.trajectory import ate_rmse

torch.set_num_threads(2)
CPU = torch.device("cpu")
N_SEQ, N_FRAMES = 4, 4
REF_CFG = RefConfig(cap=RefCap(n_pt=128, n_ln=64), orb=RefOrb(nlevels=1),
                    camera=RefCamera(width=188, height=120, fx=108.8, fy=108.8,
                                     cx=91.8, cy=63.0, baseline=0.11))
CFG = convert.config_from_ref(REF_CFG)
FLAG_KEYS = ("accepted", "is_kf")
COUNT_KEYS = ("n_pt", "n_ln")


@pytest.fixture(scope="module")
def batch():
    worlds = [synthetic.make_world(n_frames=N_FRAMES, seed=40 + s, cam=CFG.camera,
                                   n_points=150, n_lines=20) for s in range(N_SEQ)]
    il, ir, ts = [], [], []
    for w in worlds:
        fr = [synthetic.render_frame(w, i) for i in range(N_FRAMES)]
        il.append(np.stack([f[0] for f in fr]))
        ir.append(np.stack([f[1] for f in fr]))
        ts.append(w.timestamps.astype(np.float32))
    il, ir, ts = np.stack(il), np.stack(ir), np.stack(ts)
    # the port's synthetic module is a copy: the reference's frames are these
    assert np.array_equal(il[0, 0], ref_synthetic.render_frame(
        ref_synthetic.make_world(n_frames=N_FRAMES, seed=40, cam=REF_CFG.camera,
                                 n_points=150, n_lines=20), 0)[0])
    ref_poses, ref_aux = ref_run_vo_batch(REF_CFG, jnp.asarray(il), jnp.asarray(ir),
                                          jnp.asarray(ts),
                                          mesh=ref_dist.make_mesh(4, axis="seq"))
    single = run_vo_batch(CFG, il, ir, ts, device=CPU)
    ranks = multihost.launch(workers.vo_batch, 4, CFG, il, ir, ts, "cpu")
    return dict(worlds=worlds, ref=(np.asarray(ref_poses), jax.tree.map(np.asarray, ref_aux)),
                single=single, ranks=ranks)


def test_shapes_and_ground_truth(batch):
    """test_batch_parallel.py's gates on the port's batch."""
    poses, aux = batch["single"]
    assert poses.shape == (N_SEQ, N_FRAMES, 4, 4)
    assert all(v.shape == (N_SEQ, N_FRAMES - 1) for v in aux.values())
    p = poses.numpy()
    assert np.all(np.isfinite(p))
    for s in range(N_SEQ):
        assert ate_rmse(p[s], batch["worlds"][s].poses) < 0.2


def test_ranks_equal_no_group(batch):
    """Every rank returns the whole batch, equal to the run with no group."""
    poses, aux = batch["single"]
    for r_poses, r_aux, _, _ in batch["ranks"]:
        assert torch.equal(r_poses, poses)
        assert r_aux.keys() == aux.keys()
        for k in aux:
            assert r_aux[k].dtype == aux[k].dtype and torch.equal(r_aux[k], aux[k]), k


@pytest.mark.parametrize("seq", range(N_SEQ))
def test_matches_reference_batch(batch, seq):
    ref_poses, ref_aux = batch["ref"]
    poses, aux = batch["ranks"][0][:2]
    for k in FLAG_KEYS:
        np.testing.assert_array_equal(aux[k][seq].numpy(), ref_aux[k][seq], err_msg=k)
    for k in COUNT_KEYS:
        np.testing.assert_array_equal(aux[k][seq, :2].numpy(), ref_aux[k][seq, :2],
                                      err_msg=k)
    assert ate_rmse(poses[seq].numpy().astype(np.float64),
                    ref_poses[seq].astype(np.float64)) < 0.08
