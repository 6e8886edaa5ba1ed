"""SE(3), robust statistics and camera projection: the port against the
reference on the same random inputs (made with numpy from a seed).

Tolerances: rtol 1e-5 / atol 1e-6 for f32 closed forms — both sides run the
same formulas in f32, but transcendental functions (sin, cos, atan2, sqrt
of sums) and 3x3 products round differently in the two libraries by a few
ulp. Robust statistics select and average the same elements, so they are
held exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfplslam_tpu.config import CameraParams as RefCam
from gfplslam_tpu.ops import camera as ref_camera
from gfplslam_tpu.utils import robust as ref_robust
from gfplslam_tpu.utils import se3 as ref_se3

from gfplslam_torch.config import CameraParams
from gfplslam_torch.ops import camera
from gfplslam_torch.utils import robust, se3

torch.set_num_threads(2)
RTOL, ATOL = 1e-5, 1e-6


def _twists(seed, n=64, scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 6)).astype(np.float32) * scale
    x[:4] *= 1e-5                       # small-angle (Taylor) branch
    return x


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("scale", [0.3, 1.5])
def test_expmap_inverse_adjoint(scale):
    x = _twists(0, scale=scale)
    t_ref = jax.vmap(ref_se3.expmap_se3)(jnp.asarray(x))
    t = se3.expmap_se3(torch.from_numpy(x))
    _close(t, t_ref)
    tn = np.array(t_ref)
    _close(se3.inverse_se3(torch.from_numpy(tn)),
           jax.vmap(ref_se3.inverse_se3)(t_ref))
    _close(se3.adjoint_se3(torch.from_numpy(tn)),
           jax.vmap(ref_se3.adjoint_se3)(t_ref))


def test_logmap_roundtrip_matches_reference():
    x = _twists(1, scale=0.8)
    t_ref = jax.vmap(ref_se3.expmap_se3)(jnp.asarray(x))
    got = se3.logmap_se3(torch.from_numpy(np.array(t_ref)))
    _close(got, jax.vmap(ref_se3.logmap_se3)(t_ref), rtol=1e-4, atol=1e-5)
    _close(got, x, rtol=1e-4, atol=1e-5)


def test_so3_log_near_pi_branch():
    axis = np.array([0.2, -0.5, 0.84], np.float32)
    axis /= np.linalg.norm(axis)
    phi = (axis * np.float32(3.14155)).astype(np.float32)
    r = ref_se3.so3_exp(jnp.asarray(phi))
    _close(se3.so3_log(torch.from_numpy(np.array(r))), ref_se3.so3_log(r),
           rtol=1e-4, atol=1e-4)


def test_transport_cov_and_is_finite():
    rng = np.random.default_rng(2)
    t = np.array(jax.vmap(ref_se3.expmap_se3)(jnp.asarray(_twists(2))))
    a = rng.normal(size=(64, 6, 6)).astype(np.float32)
    cov = a @ np.swapaxes(a, 1, 2)
    want = jax.vmap(ref_se3.transport_cov_se3)(jnp.asarray(t), jnp.asarray(cov))
    got = se3.transport_cov_se3(torch.from_numpy(t), torch.from_numpy(cov))
    _close(got, want, rtol=1e-4, atol=1e-4)
    assert bool(se3.is_finite(torch.from_numpy(t)))
    t[3, 0, 0] = np.nan
    assert not bool(se3.is_finite(torch.from_numpy(t)))
    assert bool(ref_se3.is_finite(jnp.asarray(t))) is False


@pytest.mark.parametrize("n_valid", [0, 1, 2, 7, 64])
def test_masked_median_and_mad_exact(n_valid):
    rng = np.random.default_rng(n_valid)
    x = rng.normal(size=64).astype(np.float32)
    x[::5] = x[1::5][:len(x[::5])]            # ties
    mask = np.zeros(64, bool)
    mask[rng.permutation(64)[:n_valid]] = True
    for fn, ref_fn in ((robust.masked_median, ref_robust.masked_median),
                       (robust.masked_stdv_mad, ref_robust.masked_stdv_mad),
                       (robust.masked_stdv_mad_nozero,
                        ref_robust.masked_stdv_mad_nozero)):
        got = fn(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
        want = np.asarray(ref_fn(jnp.asarray(x), jnp.asarray(mask)))
        np.testing.assert_array_equal(got, want)
    got = robust.masked_mean(torch.from_numpy(x), torch.from_numpy(mask))
    _close(got, ref_robust.masked_mean(jnp.asarray(x), jnp.asarray(mask)))


def test_masked_median_batched_rows():
    rng = np.random.default_rng(9)
    x = rng.normal(size=(5, 33)).astype(np.float32)
    mask = rng.random((5, 33)) < 0.6
    got = robust.masked_median(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    want = np.stack([np.asarray(ref_robust.masked_median(jnp.asarray(x[i]),
                                                         jnp.asarray(mask[i])))
                     for i in range(5)])
    np.testing.assert_array_equal(got, want)


def test_camera_project_backproject():
    cam = CameraParams()
    ref_cam = RefCam()
    rng = np.random.default_rng(4)
    p = np.stack([rng.uniform(-3, 3, 200), rng.uniform(-2, 2, 200),
                  rng.uniform(0.5, 30, 200)], 1).astype(np.float32)
    _close(camera.project_batch(cam, torch.from_numpy(p)),
           ref_camera.project_batch(ref_cam, jnp.asarray(p)))
    uv = rng.uniform(0, 700, (200, 2)).astype(np.float32)
    disp = rng.uniform(0.5, 60, 200).astype(np.float32)
    disp[:3] = 0.0                                 # guarded division
    _close(camera.back_project_batch(cam, torch.from_numpy(uv),
                                     torch.from_numpy(disp)),
           ref_camera.back_project_batch(ref_cam, jnp.asarray(uv),
                                         jnp.asarray(disp)), rtol=1e-5, atol=1e-3)
    z = p[:, 2]
    _close(camera.get_disparity(cam, torch.from_numpy(z)),
           ref_camera.get_disparity(ref_cam, jnp.asarray(z)))
