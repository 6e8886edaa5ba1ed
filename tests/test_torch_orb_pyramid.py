"""Pyramid, separable filters, IC angles and steered BRIEF: the port
against the reference.

- resize / pyramid: the same f32 gather-and-blend order, held exactly;
- blur and Sobel: both sides round input, band matrix and intermediate to
  bf16 and accumulate bf16 x bf16 products in f32, which is exact for 8-bit
  intensities, so they are held exactly on uint8 images; on the float
  intensities of pyramid levels a partial sum can round, so there the bound
  is one bf16 step of the intermediate pass (2^-8 relative) times the
  second pass's gain;
- IC moment maps are f32 box sums of values up to ~2e5 whose summation
  order differs: rtol 1e-5 of the largest sum; angles within 1e-3 rad;
- BRIEF is held exactly on the reference's own blurred image, keypoints
  and angles (the port gathers the in-patch offsets the reference selects
  by a one-hot product)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfplslam_tpu.ops import orb as ref_orb
from gfplslam_tpu.ops import pyramid as ref_pyramid
from gfplslam_tpu.ops.fast import fast_score_map_xla, select_keypoints as ref_select

from gfplslam_torch.ops import orb, pyramid

torch.set_num_threads(2)


def _img(seed, shape=(240, 376)):
    return np.random.default_rng(seed).integers(0, 256, shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_level_shapes_equal():
    for h, w in ((480, 752), (240, 376), (376, 1241)):
        assert pyramid.level_shapes(h, w, 4, 1.2) == ref_pyramid.level_shapes(h, w, 4, 1.2)


def test_pyramid_padded_exact():
    img = _img(0)
    ref = np.asarray(ref_pyramid.build_pyramid_padded(jnp.asarray(img), 4, 1.2))
    got = pyramid.build_pyramid_padded(_t(img)[None], 4, 1.2)[0].numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("fn", ["blur", "sobel", "lsd_blur"])
def test_filters_exact_on_uint8(fn):
    img = _img(1)
    if fn == "blur":
        pairs = [(pyramid.gaussian_blur(_t(img)), ref_pyramid.gaussian_blur(jnp.asarray(img)))]
    elif fn == "lsd_blur":
        pairs = [(pyramid.gaussian_blur(_t(img), sigma=0.8, radius=2),
                  ref_pyramid.gaussian_blur(jnp.asarray(img), sigma=0.8, radius=2))]
    else:
        pairs = list(zip(pyramid.sobel(_t(img)), ref_pyramid.sobel(jnp.asarray(img))))
    for got, want in pairs:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_filters_on_float_levels_within_one_bf16_step():
    lv = np.asarray(ref_pyramid.build_pyramid_padded(jnp.asarray(_img(2)), 4, 1.2))[2]
    got = pyramid.gaussian_blur(_t(lv)).numpy()
    want = np.asarray(ref_pyramid.gaussian_blur(jnp.asarray(lv)))
    np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=1e-3)
    for g, w in zip(pyramid.sobel(_t(lv)), ref_pyramid.sobel(jnp.asarray(lv))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2 ** -8, atol=2.0)


def test_ic_angle_maps_and_angles():
    blur = np.asarray(ref_pyramid.gaussian_blur(jnp.asarray(_img(3))))
    m10, m01 = orb.ic_angle_maps(_t(blur))
    r10, r01 = ref_orb.ic_angle_maps(jnp.asarray(blur))
    for g, w in ((m10, r10), (m01, r01)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())
    rng = np.random.default_rng(3)
    xy = rng.uniform(20, 220, (200, 2)).astype(np.float32)
    got = orb.ic_angles_dense(_t(blur)[None], _t(xy)[None])[0].numpy()
    want = np.asarray(ref_orb.ic_angles_dense(jnp.asarray(blur), jnp.asarray(xy)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def _ref_keypoints(img, n=256):
    s = fast_score_map_xla(jnp.asarray(img), jnp.asarray(15.0))
    return ref_select(s, n_out=n, cell=32, per_cell=4, border=19)


def test_brief_patches_exact():
    img = _img(4)
    blur = ref_pyramid.gaussian_blur(jnp.asarray(img))
    kp = _ref_keypoints(img)
    ref = np.asarray(ref_orb.brief_patches(blur, kp.xy).astype(jnp.float32))
    # keypoints at the image corners exercise the clamped / edge-padded rows
    xy = np.array(kp.xy)
    xy[:4] = [[0, 0], [375, 239], [374.6, 0.4], [3, 238]]
    ref_edge = np.asarray(ref_orb.brief_patches(blur, jnp.asarray(xy)).astype(jnp.float32))
    got = orb.brief_patches(_t(blur)[None], _t(xy)[None])[0]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), ref_edge)
    np.testing.assert_array_equal(got.float().numpy()[4:], ref[4:])


def test_brief_descriptors_exact_on_reference_patches_and_angles():
    img = _img(5)
    blur = ref_pyramid.gaussian_blur(jnp.asarray(img))
    kp = _ref_keypoints(img)
    pf = ref_orb.brief_patches(blur, kp.xy)
    ang = np.array(ref_orb.ic_angles_dense(blur, kp.xy))
    # angles on and around the bin edges, including a tiny negative angle
    # whose f32 remainder rounds to 2*pi (an out-of-range bin)
    ang[:6] = [0.0, -1e-8, np.pi, -np.pi, 2 * np.pi / 32, 6.2831855]
    want = np.asarray(ref_orb.brief_from_patches(pf, jnp.asarray(ang)))
    got = orb.brief_from_patches(
        torch.from_numpy(np.array(pf.astype(jnp.float32))).to(torch.bfloat16),
        _t(ang)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got.view(np.uint32), want)
