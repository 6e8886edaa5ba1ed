"""The functions the analysis apps need, against the reference's: the
per-line cut information (``models/linecut.py``), the off-path ORB
functions and sampling patterns (``ops/orb.py``), the matching gates, the
SE(3) helpers and ``lbd_float_one``.

Tolerances: pattern tables and descriptors exact; the line-cut information
and log-dets 1e-4 relative (f32 sums of fx^2-scale products in another
order); each other test states its own. Tests that select the "random"
pattern restore "orb" in both packages afterwards and clear the
reference's compiled programs.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gfplslam_tpu.models import linecut as ref_linecut
from gfplslam_tpu.ops import lbd as ref_lbd
from gfplslam_tpu.ops import matching as ref_matching
from gfplslam_tpu.ops import orb as ref_orb
from gfplslam_tpu.ops import pyramid as ref_pyramid
from gfplslam_tpu.utils import se3 as ref_se3

from gfplslam_torch.config import CameraParams
from gfplslam_torch.models import linecut
from gfplslam_torch.ops import lbd, matching, orb
from gfplslam_torch.utils import se3

from test_linecut import make_lines

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def orb_pattern_restored():
    yield
    orb.set_pattern("orb")
    ref_orb.set_pattern("orb")
    jax.clear_caches()


def _t(x):
    return torch.from_numpy(np.array(x))


def _rel(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ---------------------------------------------------------------- linecut

@pytest.fixture(scope="module")
def lines():
    cam_ref, lns, cov_s, cov_e = make_lines(np.random.default_rng(0), noisy_end=True)
    cam = CameraParams(**dataclasses.asdict(cam_ref))
    dt = np.eye(4, dtype=np.float32)
    dt[:3, 3] = [0.05, -0.02, 0.1]
    return dict(cam_ref=cam_ref, cam=cam, dt=dt, lns=jax.tree.map(np.asarray, lns),
                cov_s=np.asarray(cov_s), cov_e=np.asarray(cov_e))


@pytest.mark.parametrize("ratios", [(0.0, 0.0), (0.25, 0.4), (0.5, 0.5), (0.0, 0.95)])
def test_line_info_factors_and_pose_info(lines, ratios):
    """``line_info_factors`` and ``pose_info_line`` of every line, one at a
    time as the reference computes them."""
    lns, r0, r1 = lines["lns"], *ratios
    for i in range(len(lns.sp3d)):
        args = (lines["dt"], lns.sp3d[i], lns.ep3d[i], lines["cov_s"][i],
                lines["cov_e"][i], lns.le_obs[i])
        j_ref, d_ref = ref_linecut.line_info_factors(
            lines["cam_ref"], *map(jnp.asarray, args), jnp.asarray(r0), jnp.asarray(r1))
        j, d = linecut.line_info_factors(lines["cam"], *map(_t, args),
                                         torch.tensor(r0), torch.tensor(r1))
        assert _rel(j, j_ref) < 1e-4 and _rel(d, d_ref) < 1e-4
        info_ref = ref_linecut.pose_info_line(
            lines["cam_ref"], *map(jnp.asarray, args), jnp.asarray(r0), jnp.asarray(r1))
        info = linecut.pose_info_line(lines["cam"], *map(_t, args),
                                      torch.tensor(r0), torch.tensor(r1))
        assert info.shape == (6, 6) and _rel(info, info_ref) < 1e-4


def test_pose_info_line_batched_grid(lines):
    """A grid of ratios in one call equals the per-ratio calls."""
    lns = lines["lns"]
    args = tuple(map(_t, (lines["dt"], lns.sp3d[0], lns.ep3d[0], lines["cov_s"][0],
                          lines["cov_e"][0], lns.le_obs[0])))
    g = torch.arange(0, 1.0001, 0.25)
    r0, r1 = torch.meshgrid(g, g, indexing="ij")
    grid = linecut.pose_info_line(lines["cam"], *args, r0, r1)
    for a in range(len(g)):
        for b in range(len(g)):
            one = linecut.pose_info_line(lines["cam"], *args, r0[a, b], r1[a, b])
            assert _rel(grid[a, b], one) < 1e-5


def test_proj_and_residual_jacobians(lines):
    rng = np.random.default_rng(3)
    p = np.stack([rng.uniform(-2, 2, 16), rng.uniform(-1, 1, 16),
                  rng.uniform(0.5, 9, 16)], 1).astype(np.float32)
    l = rng.normal(size=(16, 2)).astype(np.float32)
    for i in range(16):
        assert _rel(linecut._proj_jac(lines["cam"], _t(p[i])),
                    ref_linecut._proj_jac(lines["cam_ref"], jnp.asarray(p[i]))) < 1e-6
        assert _rel(linecut._residual_jac(lines["cam"], _t(p[i]), _t(l[i, 0]), _t(l[i, 1])),
                    ref_linecut._residual_jac(lines["cam_ref"], jnp.asarray(p[i]),
                                              jnp.asarray(l[i, 0]),
                                              jnp.asarray(l[i, 1]))) < 1e-6


def test_logdet_and_min_eig():
    """On PD matrices, an indefinite one (-inf) and a NaN one (-inf)."""
    rng = np.random.default_rng(4)
    mats = []
    for scale in (1.0, 1e3, 1e6):
        a = rng.normal(size=(6, 6)).astype(np.float32)
        mats.append((a @ a.T + 0.1 * np.eye(6)).astype(np.float32) * scale)
    mats.append(np.diag([1, 2, 3, -4, 5, 6]).astype(np.float32))
    mats.append(np.full((6, 6), np.nan, np.float32))
    for m in mats:
        want = float(ref_linecut._logdet_pd(jnp.asarray(m)))
        got = float(linecut._logdet_pd(_t(m)))
        if np.isfinite(want):
            assert abs(got - want) < 1e-4 * max(1.0, abs(want))
        else:
            assert got == want
    for m in mats[:4]:
        want = float(ref_linecut._min_eig(jnp.asarray(m)))
        assert abs(float(linecut._min_eig(_t(m))) - want) < 1e-4 * np.abs(m).max()
    batch = torch.stack([_t(m) for m in mats])
    assert torch.equal(linecut._logdet_pd(batch),
                       torch.stack([linecut._logdet_pd(_t(m)) for m in mats]))


# -------------------------------------------------------------------- orb

def test_pattern_tables_exact():
    np.testing.assert_array_equal(orb.make_brief_pattern(), ref_orb.make_brief_pattern())
    np.testing.assert_array_equal(orb.BRIEF_PATTERN, ref_orb.BRIEF_PATTERN)
    for seed in (1234, 7):
        pool, pairs = orb.make_brief_pool(seed=seed)
        ref_pool, ref_pairs = ref_orb.make_brief_pool(seed=seed)
        np.testing.assert_array_equal(pool, ref_pool)
        np.testing.assert_array_equal(pairs, ref_pairs)
        assert pool.dtype == ref_pool.dtype and pairs.dtype == ref_pairs.dtype
    for name in ("RANDOM_POOL", "RANDOM_PAIRS", "ORB_POOL", "ORB_PAIRS"):
        np.testing.assert_array_equal(getattr(orb, name), getattr(ref_orb, name))
    with pytest.raises(ValueError):
        orb.set_pattern("nope")


@pytest.fixture(scope="module")
def keypoints():
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 255, size=(96, 128)).astype(np.float32)
    blur = np.asarray(ref_pyramid.gaussian_blur(jnp.asarray(img), 2.0, 3))
    # interior, border-clamped, fractional and exactly-half positions
    xy = np.concatenate([rng.uniform(20, 100, (24, 2)),
                         [[0.0, 0.0], [127.0, 95.0], [3.5, 90.25], [64.5, 47.5]]]
                        ).astype(np.float32)
    return img, blur, xy


def test_ic_angles(keypoints):
    """Within 1e-4 rad: the moments are 961-term f32 sums of values up to
    255 x 15, added in another order (measured: 2.7e-5 rad at most)."""
    img, _, xy = keypoints
    want = np.asarray(ref_orb.ic_angles(jnp.asarray(img), jnp.asarray(xy)))
    got = orb.ic_angles(_t(img), _t(xy)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert abs(float(orb.ic_angle_one(_t(img), _t(xy[0]))) - want[0]) < 1e-4


@pytest.mark.parametrize("pattern", ["orb", "random"])
@pytest.mark.parametrize("fn", ["brief_descriptors", "brief_descriptors_patch",
                                "brief_descriptors_mxu"])
def test_brief_descriptors_exact(keypoints, pattern, fn):
    """Each descriptor form equal to the reference's on the same keypoints
    and angles, under either pattern (``set_pattern`` clears the tables the
    port built for the other)."""
    _, blur, xy = keypoints
    orb.set_pattern(pattern)
    ref_orb.set_pattern(pattern)
    jax.clear_caches()
    angles = np.asarray(ref_orb.ic_angles(jnp.asarray(blur), jnp.asarray(xy)))
    want = np.asarray(getattr(ref_orb, fn)(jnp.asarray(blur), jnp.asarray(xy),
                                           jnp.asarray(angles)))
    got = getattr(orb, fn)(_t(blur), _t(xy), _t(angles)).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    if fn == "brief_descriptors":
        one = orb.brief_descriptor_one(_t(blur), _t(xy[3]), _t(angles[3]))
        np.testing.assert_array_equal(one.numpy().view(np.uint32), want[3])


# --------------------------------------------------- matching, se3, lbd

def test_ratio_gate():
    """tests/test_matching.py::test_ratio_gate's input."""
    d = [[1.0, 10.0], [9.0, 10.0]]
    i1, d1, d2 = matching.best2(torch.tensor(d))
    g = matching.ratio_gate(matching.Matches(i1, d1, torch.ones(2, dtype=torch.bool)),
                            d2, 0.9)
    ri1, rd1, rd2 = ref_matching.best2(jnp.asarray(d))
    want = ref_matching.ratio_gate(ref_matching.Matches(ri1, rd1, jnp.ones(2, bool)),
                                   rd2, 0.9)
    np.testing.assert_array_equal(g.valid.numpy(), np.asarray(want.valid))
    assert g.valid.tolist() == [True, False]


def test_mad_gate():
    """tests/test_matching.py::test_mad_gate's input (its ``rng`` fixture)."""
    base = np.random.default_rng(0).normal(10, 1, size=62).astype(np.float32)
    dist = np.concatenate([base, [200.0, 250.0]]).astype(np.float32)
    g = matching.mad_gate(matching.Matches(torch.zeros(64, dtype=torch.int64), _t(dist),
                                           torch.ones(64, dtype=torch.bool)), 5.0)
    want = ref_matching.mad_gate(ref_matching.Matches(
        jnp.zeros(64, jnp.int32), jnp.asarray(dist), jnp.ones(64, bool)), 5.0)
    np.testing.assert_array_equal(g.valid.numpy(), np.asarray(want.valid))
    assert not g.valid[62] and not g.valid[63] and int(g.valid[:62].sum()) > 55


def test_quaternions():
    """tests/test_se3.py::test_quaternion_roundtrip's rotations (its ``rng``
    fixture), plus matrices that take each of Shepperd's four branches."""
    from scipy.spatial.transform import Rotation
    phis = np.random.default_rng(0).normal(size=(32, 3)).astype(np.float32)
    rs = Rotation.from_rotvec(phis).as_matrix().astype(np.float32)
    rs = np.concatenate([rs, Rotation.from_rotvec(
        np.pi * np.eye(3) * 0.999).as_matrix().astype(np.float32)])
    q = se3.to_quaternion(_t(rs))
    for i, r in enumerate(rs):
        want = np.asarray(ref_se3.to_quaternion(jnp.asarray(r)))
        np.testing.assert_allclose(q[i].numpy(), want, rtol=0, atol=1e-6)
        np.testing.assert_allclose(
            se3.quaternion_to_rotation(q[i]).numpy(),
            np.asarray(ref_se3.quaternion_to_rotation(jnp.asarray(want))), rtol=0, atol=1e-6)
    np.testing.assert_allclose(se3.quaternion_to_rotation(q).numpy(), rs, atol=1e-5)


def test_reverse_and_transform_point():
    rng = np.random.default_rng(1)
    x = rng.normal(size=6).astype(np.float32)
    np.testing.assert_array_equal(se3.reverse_twist(_t(x)).numpy(),
                                  np.asarray(ref_se3.reverse_twist(jnp.asarray(x))))
    t = np.asarray(ref_se3.expmap_se3(jnp.asarray(x)))
    np.testing.assert_array_equal(se3.reverse_se3(_t(t)).numpy(),
                                  np.asarray(ref_se3.reverse_se3(jnp.asarray(t))))
    p = rng.normal(size=3).astype(np.float32)
    np.testing.assert_allclose(se3.transform_point(_t(t), _t(p)).numpy(),
                               np.asarray(ref_se3.transform_point(jnp.asarray(t),
                                                                  jnp.asarray(p))),
                               rtol=0, atol=1e-6)


def test_lbd_float_one():
    rng = np.random.default_rng(2)
    g2 = rng.normal(0, 30, size=(64, 80, 2)).astype(np.float32)
    for sp, ep in (([10.0, 10.0], [50.0, 12.0]), ([5.0, 50.0], [60.0, 45.0]),
                   ([70.0, 3.0], [12.5, 60.5])):
        sp, ep = np.float32(sp), np.float32(ep)
        want = np.asarray(ref_lbd.lbd_float_one(jnp.asarray(g2), jnp.asarray(sp),
                                                jnp.asarray(ep)))
        got = lbd.lbd_float_one(_t(g2), _t(sp), _t(ep)).numpy()
        assert got.shape == (72,)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
