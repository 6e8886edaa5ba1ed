"""The stereo front-end (models/frame.py): each stage of the port run on the
reference's own upstream outputs, and the whole stage from the images, at
376x240 with the small capacities of tests/test_frame.py.

Held exactly: keypoints, levels, scores, BRIEF descriptors, validity masks
and stereo match decisions (all integer or bf16-exact arithmetic upstream of
them). Floats: IC angles within 1e-3 rad (f32 box sums in another order);
disparities within 2e-3 px and 3D points within rtol 1e-4 (f32 SAD sums and
parabola fits); line geometry as in test_torch_lines.py; covariances within
rtol 1e-4. LBD bits: at most 2 per descriptor (see test_torch_lines.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfplslam_tpu.config import CameraParams, CapacityParams, Config, OrbParams
from gfplslam_tpu.io import synthetic as ref_synthetic
from gfplslam_tpu.models import frame as ref_frame
from gfplslam_tpu.ops import pyramid as ref_pyramid

from gfplslam_torch.models import frame
from gfplslam_torch.utils import convert

torch.set_num_threads(2)
CPU = torch.device("cpu")
TH = 20.0


@pytest.fixture(scope="module")
def case():
    cfg_ref = Config(
        cap=CapacityParams(n_pt=256, n_ln=128, n_pt_match=128, n_ln_match=64),
        orb=OrbParams(nlevels=2),
        camera=CameraParams(width=376, height=240, fx=217.6, fy=217.6,
                            cx=183.7, cy=126.1, baseline=0.11))
    world = ref_synthetic.make_world(n_frames=3, n_points=250, n_lines=40, seed=2)
    img_l, img_r = ref_synthetic.render_frame(world, 0, noise=1.0)
    imgs = jnp.asarray(np.stack([img_l, img_r]))

    @jax.jit
    def upstream(imgs):
        pyrs = jax.vmap(lambda im: ref_pyramid.build_pyramid_padded(
            im, cfg_ref.orb.nlevels, cfg_ref.orb.scale_factor))(imgs)
        feats = jax.vmap(lambda im, py: ref_frame.detect_camera_features(
            im, cfg_ref, jnp.asarray(TH), py))(imgs, pyrs)
        return pyrs, feats

    pyrs, feats = jax.tree.map(np.array, upstream(imgs))
    whole = jax.tree.map(np.array, ref_frame.process_stereo_pair(
        imgs[0], imgs[1], cfg_ref, jnp.asarray(TH)))
    return dict(cfg_ref=cfg_ref, cfg=convert.config_from_ref(cfg_ref),
                world=world, img_l=img_l, img_r=img_r, pyrs=pyrs,
                feats=feats, whole=whole)


def _feat(feats, i):
    return convert.to_torch(type(feats)(*(x[i] for x in feats)), CPU)


def _bit_diff(a, b):
    return np.unpackbits(np.ascontiguousarray(a ^ b).view(np.uint8), axis=-1).sum(-1)


def _check_points_exact(got, want):
    for name in ("pt_xy", "pt_level", "pt_desc", "pt_score", "pt_valid"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), name)


def test_detect_camera_features_matches_reference(case):
    imgs = torch.from_numpy(np.stack([case["img_l"], case["img_r"]]))
    pyrs = frame.build_pyramid_padded(imgs, 2, 1.2)
    # inside one fused program XLA contracts the bilinear blend into FMAs,
    # so the reference's own levels move by an ulp against its op-by-op
    # form (which test_torch_orb_pyramid.py holds exactly)
    np.testing.assert_allclose(pyrs.numpy(), case["pyrs"], rtol=1e-5, atol=1e-3)
    got = convert.to_numpy(frame.detect_camera_features(imgs, case["cfg"], TH, pyrs))
    want = case["feats"]
    _check_points_exact(got, want)
    np.testing.assert_allclose(got.pt_angle, want.pt_angle, rtol=0, atol=1e-3)
    v = want.ln_valid
    np.testing.assert_array_equal(got.ln_valid, v)
    assert v.sum(1).min() >= 3
    np.testing.assert_allclose(got.ln_sp[v], want.ln_sp[v], rtol=0, atol=1e-2)
    np.testing.assert_allclose(got.ln_ep[v], want.ln_ep[v], rtol=0, atol=1e-2)
    assert _bit_diff(got.ln_desc[v], want.ln_desc[v]).max() <= 2


def test_stereo_match_points_on_reference_features(case):
    cfg, cfg_ref = case["cfg"], case["cfg_ref"]
    feats, pyrs = case["feats"], case["pyrs"]
    want = jax.tree.map(np.asarray, ref_frame.stereo_match_points(
        cfg_ref.camera, cfg_ref,
        jax.tree.map(lambda x: jnp.asarray(x[0]), feats),
        jax.tree.map(lambda x: jnp.asarray(x[1]), feats),
        jnp.asarray(pyrs[0]), jnp.asarray(pyrs[1])))
    got = convert.to_numpy(frame.stereo_match_points(
        cfg.camera, cfg, _feat(feats, 0), _feat(feats, 1),
        torch.from_numpy(pyrs[0]), torch.from_numpy(pyrs[1])))
    np.testing.assert_array_equal(got.valid, want.valid)
    assert want.valid.sum() > 30
    v = want.valid
    np.testing.assert_allclose(got.disp[v], want.disp[v], rtol=0, atol=2e-3)
    np.testing.assert_allclose(got.p3d[v], want.p3d[v], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.sigma2, want.sigma2)


def test_stereo_match_lines_on_reference_features(case):
    cfg, cfg_ref, feats = case["cfg"], case["cfg_ref"], case["feats"]
    want = jax.tree.map(np.asarray, ref_frame.stereo_match_lines(
        cfg_ref.camera, cfg_ref,
        jax.tree.map(lambda x: jnp.asarray(x[0]), feats),
        jax.tree.map(lambda x: jnp.asarray(x[1]), feats)))
    got = convert.to_numpy(frame.stereo_match_lines(
        cfg.camera, cfg, _feat(feats, 0), _feat(feats, 1)))
    np.testing.assert_array_equal(got.valid, want.valid)
    v = want.valid
    assert v.sum() >= 3
    for name in ("sdisp", "edisp", "sp3d", "ep3d", "le", "cov_sp3d", "cov_ep3d"):
        np.testing.assert_allclose(getattr(got, name)[v], getattr(want, name)[v],
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(got.desc, want.desc)


def test_estimate_line_uncertainty_on_reference_lines(case):
    cfg, cfg_ref = case["cfg"], case["cfg_ref"]
    lines = case["whole"].lines
    want = ref_frame.estimate_line_uncertainty(
        cfg_ref.camera, cfg_ref, jax.tree.map(jnp.asarray, lines))
    got = frame.estimate_line_uncertainty(cfg.camera, cfg,
                                          convert.to_torch(lines, CPU))
    v = lines.valid
    for g, w in ((got.cov_sp3d, want.cov_sp3d), (got.cov_ep3d, want.cov_ep3d)):
        np.testing.assert_allclose(g.numpy()[v], np.asarray(w)[v], rtol=1e-4, atol=1e-7)


def test_process_stereo_pair_whole_stage(case):
    got = convert.to_numpy(frame.process_stereo_pair(
        torch.from_numpy(case["img_l"]), torch.from_numpy(case["img_r"]),
        case["cfg"], TH))
    want = case["whole"]
    _check_points_exact(got.feat_l, want.feat_l)
    for name in ("xy", "desc", "level", "valid"):
        np.testing.assert_array_equal(getattr(got.points, name),
                                      getattr(want.points, name), name)
    v = want.points.valid
    np.testing.assert_allclose(got.points.disp[v], want.points.disp[v], rtol=0,
                               atol=2e-3)
    np.testing.assert_array_equal(got.lines.valid, want.lines.valid)
    vl = want.lines.valid
    np.testing.assert_allclose(got.lines.sp3d[vl], want.lines.sp3d[vl],
                               rtol=1e-3, atol=1e-3)
    assert _bit_diff(got.lines.desc[vl], want.lines.desc[vl]).max() <= 2


def test_port_frame_meets_reference_accuracy_gates(case):
    """tests/test_frame.py's triangulation gate, on the port's frame."""
    cfg, world = case["cfg"], case["world"]
    sf = frame.process_stereo_pair(torch.from_numpy(case["img_l"]),
                                   torch.from_numpy(case["img_r"]), cfg, TH)
    cam = cfg.camera
    v = sf.points.valid.numpy()
    assert v.sum() > 30
    t_wc = world.poses[0]
    gt_cam = (world.points - t_wc[:3, 3]) @ t_wc[:3, :3]
    gt_cam = gt_cam[gt_cam[:, 2] > 0.3]
    gt_uv = np.stack([cam.fx * gt_cam[:, 0] / gt_cam[:, 2] + cam.cx,
                      cam.fy * gt_cam[:, 1] / gt_cam[:, 2] + cam.cy], 1)
    gt_disp = cam.fx * cam.baseline / gt_cam[:, 2]
    xy = sf.points.xy.numpy()[v]
    disp = sf.points.disp.numpy()[v]
    d_img = np.linalg.norm(xy[:, None, :] - gt_uv[None], axis=-1)
    nn = np.argmin(d_img, 1)
    matched = d_img[np.arange(len(xy)), nn] < 3.0
    assert matched.mean() > 0.7
    derr = np.abs(disp[matched] - gt_disp[nn[matched]])
    assert (derr < np.maximum(1.5, 0.2 * gt_disp[nn[matched]])).mean() > 0.75
    n_ln = int(sf.lines.valid.sum())
    assert n_ln >= 3
    z = sf.lines.sp3d.numpy()[sf.lines.valid.numpy()][:, 2]
    assert np.all(z > 0.1) and np.all(z < 100.0)
