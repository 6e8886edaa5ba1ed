"""LSD line detection and LBD descriptors: the port against the reference
on rendered synthetic frames (the scenes of tests/test_lines.py).

- detect_lines: the validity mask and count are held exactly; endpoints of
  valid segments within 1e-2 px, angles within 1e-3 rad and lengths within
  1e-2 px. Gradients and run lengths are exact (bf16-exact filters, integer
  run counting); what differs is the f32 summation order of the weighted
  PCA fit, the scatter-add over merged fragments and the two libraries'
  atan2/cos/sin, all at the 1e-5 relative level;
- binarize: exact on the reference's own float features;
- the full lbd_descriptors from the image: float features within 1e-5 and
  at most 2 differing bits per 256-bit descriptor (a feature pair within a
  few ulp of each other can flip), 0.1% of all bits overall."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfplslam_tpu.io import synthetic as ref_synthetic
from gfplslam_tpu.ops import lbd as ref_lbd
from gfplslam_tpu.ops import lsd as ref_lsd

from gfplslam_torch.ops import lbd, lsd

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def frames():
    world = ref_synthetic.make_world(n_frames=2, n_points=150, n_lines=40, seed=8)
    return [ref_synthetic.render_frame(world, i, noise=1.0) for i in range(2)]


@pytest.fixture(scope="module")
def ref_lines(frames):
    imgs = jnp.asarray(np.stack([frames[0][0], frames[1][1]]))
    return jax.tree.map(np.asarray, jax.vmap(
        lambda im: ref_lsd.detect_lines(im, n_out=128))(imgs)), imgs


def _bits(x):
    return np.unpackbits(np.ascontiguousarray(x).view(np.uint8), axis=-1).sum(-1)


def test_detect_lines_matches_reference(ref_lines):
    ref, imgs = ref_lines
    got = lsd.detect_lines(torch.from_numpy(np.array(imgs)), n_out=128)
    v = ref.valid
    np.testing.assert_array_equal(got.valid.numpy(), v)
    assert v.sum(1).min() >= 5
    np.testing.assert_allclose(got.sp.numpy()[v], ref.sp[v], rtol=0, atol=1e-2)
    np.testing.assert_allclose(got.ep.numpy()[v], ref.ep[v], rtol=0, atol=1e-2)
    np.testing.assert_allclose(got.angle.numpy()[v], ref.angle[v], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.length.numpy()[v], ref.length[v], rtol=0, atol=1e-2)


def test_detect_lines_size_guard():
    with pytest.raises(ValueError, match="2\\^19"):
        lsd.detect_lines(torch.zeros(1, 720, 1280))


def test_run_ends_exact():
    rng = np.random.default_rng(0)
    support = rng.random((2, 60, 90)) < 0.3
    bin16 = rng.integers(0, 16, (2, 60, 90)).astype(np.int32)
    got = lsd._run_ends(torch.from_numpy(support), torch.from_numpy(bin16), 5)
    for b in range(2):
        want = ref_lsd._run_ends(jnp.asarray(support[b]), jnp.asarray(bin16[b]), 5)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))


def test_binarize_exact_on_reference_features():
    rng = np.random.default_rng(1)
    feats = rng.random((64, ref_lbd.FLOAT_DIM)).astype(np.float32)
    feats[:, ::7] = feats[:, 1::7][:, :feats[:, ::7].shape[1]]   # equal pairs
    want = np.asarray(jax.vmap(ref_lbd.binarize)(jnp.asarray(feats)))
    got = lbd.binarize(torch.from_numpy(feats)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want)


def test_lbd_descriptors_from_image(frames, ref_lines):
    ref, _ = ref_lines
    img = frames[0][0]
    v = ref.valid[0]
    sp, ep = np.array(ref.sp[0]), np.array(ref.ep[0])
    want_bin, want_f = ref_lbd.lbd_descriptors(jnp.asarray(img), jnp.asarray(sp),
                                               jnp.asarray(ep))
    got_bin, got_f = lbd.lbd_descriptors(torch.from_numpy(img)[None],
                                         torch.from_numpy(sp)[None],
                                         torch.from_numpy(ep)[None])
    np.testing.assert_allclose(got_f[0].numpy()[v], np.asarray(want_f)[v],
                               rtol=0, atol=1e-5)
    diff = _bits(got_bin[0].numpy().view(np.uint32)[v] ^ np.asarray(want_bin)[v])
    assert diff.max() <= 2 and diff.sum() <= 0.001 * 256 * v.sum(), diff
