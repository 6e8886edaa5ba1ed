"""FAST-9 score map, NMS and keypoint selection: the port's plain PyTorch
path (what a CPU tensor takes) against the reference, bit for bit.

The score map mirrors tests/test_pallas.py's FAST cases (three image shapes,
a batch of level images at two thresholds); the reference side is
``fast_score_map_xla``, the formulation its Pallas kernel is held to.
Keypoint selection runs on the reference's own score maps."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfplslam_tpu.ops import fast as ref_fast

from gfplslam_torch.ops import fast

torch.set_num_threads(2)


def _score_ref(img, th):
    return np.array(ref_fast.fast_score_map_xla(jnp.asarray(img), jnp.asarray(th)))


@pytest.mark.parametrize("shape", [(480, 752), (240, 376), (376, 1241)])
def test_fast_score_exact_uint8_images(shape):
    rng = np.random.default_rng(11)
    img = rng.integers(0, 256, size=shape).astype(np.float32)
    ref = _score_ref(img, 20.0)
    got = fast.fast_score_map(torch.from_numpy(img), 20.0).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (ref > 0).sum() > 1000


@pytest.mark.parametrize("th", [10.0, 35.0])
def test_fast_score_batched_levels_tensor_threshold(th):
    """frame.py's pattern: one batch of padded level images, threshold as an
    on-device tensor (the adaptive-FAST scalar)."""
    rng = np.random.default_rng(12)
    imgs = rng.integers(0, 256, size=(3, 120, 190)).astype(np.float32)
    got = fast.fast_score_map(torch.from_numpy(imgs), torch.tensor(th)).numpy()
    ref = np.stack([_score_ref(imgs[i], th) for i in range(3)])
    np.testing.assert_array_equal(got, ref)


def test_fast_score_exact_on_float_images_with_padding():
    """Non-integer intensities (pyramid levels) exercise every bf16 rounding;
    the zero-padded region is scored as given."""
    rng = np.random.default_rng(13)
    img = rng.uniform(0, 255, size=(100, 160)).astype(np.float32)
    img = (img + np.roll(img, 1, 0)) * np.float32(0.5)
    img[80:, :] = 0.0
    img[:, 130:] = 0.0
    for th in (10.0, 20.0):
        np.testing.assert_array_equal(
            fast.fast_score_map_torch(torch.from_numpy(img), th).numpy(),
            _score_ref(img, th))


def test_nms3_exact():
    rng = np.random.default_rng(3)
    s = _score_ref(rng.integers(0, 256, (90, 130)).astype(np.float32), 15.0)
    np.testing.assert_array_equal(fast.nms3(torch.from_numpy(s)).numpy(),
                                  np.asarray(ref_fast.nms3(jnp.asarray(s))))


def test_select_keypoints_exact_with_ties_and_valid_region():
    """bf16-quantized scores tie often: the port must keep the reference's
    lower-index-first order in both the per-cell argmax and the top-k."""
    rng = np.random.default_rng(5)
    levels = [(240, 376), (200, 313)]
    maps, kps = [], []
    for vh, vw in levels:
        img = np.zeros((240, 376), np.float32)
        img[:vh, :vw] = rng.integers(0, 256, (vh, vw))
        s = _score_ref(img, 20.0)
        maps.append(s)
        kps.append(ref_fast.select_keypoints(
            jnp.asarray(s), n_out=300, cell=32, per_cell=4, border=19,
            valid_h=jnp.asarray(vh), valid_w=jnp.asarray(vw)))
    got = fast.select_keypoints(torch.from_numpy(np.stack(maps)), n_out=300,
                                cell=32, per_cell=4, border=19,
                                valid_h=[l[0] for l in levels],
                                valid_w=[l[1] for l in levels])
    for b, kp in enumerate(kps):
        np.testing.assert_array_equal(got.xy[b].numpy(), np.asarray(kp.xy))
        np.testing.assert_array_equal(got.score[b].numpy(), np.asarray(kp.score))
        np.testing.assert_array_equal(got.valid[b].numpy(), np.asarray(kp.valid))
    # ties really occur in these maps
    flat = maps[0][maps[0] > 0]
    assert len(np.unique(flat)) < len(flat) // 4


def test_select_keypoints_pads_when_cells_run_out():
    rng = np.random.default_rng(6)
    s = _score_ref(rng.integers(0, 256, (64, 96)).astype(np.float32), 20.0)
    kp = ref_fast.select_keypoints(jnp.asarray(s), n_out=64, cell=32,
                                   per_cell=4, border=5)
    got = fast.select_keypoints(torch.from_numpy(s)[None], n_out=64, cell=32,
                                per_cell=4, border=5)
    np.testing.assert_array_equal(got.xy[0].numpy(), np.asarray(kp.xy))
    np.testing.assert_array_equal(got.valid[0].numpy(), np.asarray(kp.valid))


def test_dispatch_by_device_only():
    img = torch.zeros(2, 16, 16)
    # a CPU tensor takes the plain version, with no kernel build
    assert torch.equal(fast.fast_score_map(img, 20.0),
                       fast.fast_score_map_torch(img, 20.0))
    with pytest.raises(ValueError):
        fast.fast_score_map(img.to("meta"), 20.0)
    # the kernel wrapper refuses anything but a CUDA tensor
    with pytest.raises(ValueError):
        fast.fast_score_cuda(img, 20.0)


def _kernel_formulation(imgs: torch.Tensor, th: float) -> torch.Tensor:
    """The arithmetic of ``csrc/fast_score.cu`` in PyTorch bf16: a pixel with
    no two neighbouring compass taps both bright or both dark scores 0; the
    window trees run on the differences and the margins come after them;
    each pair of neighbouring 9-windows (2i, 2i+1) shares its 8 middle
    taps."""
    img16 = imgs.to(torch.bfloat16)
    t = torch.tensor(th).to(torch.bfloat16)
    d = [torch.roll(img16, (-int(dy), -int(dx)), (-2, -1)) - img16
         for dx, dy in fast.FAST_CIRCLE]
    mn, mx = torch.minimum, torch.maximum
    lo = [mn(d[2 * i + 1], d[(2 * i + 2) % 16]) for i in range(8)]
    hi = [mx(d[2 * i + 1], d[(2 * i + 2) % 16]) for i in range(8)]
    for s in (1, 2):                           # 8-tap min / max from tap 2i+1
        lo = [mn(lo[i], lo[(i + s) % 8]) for i in range(8)]
        hi = [mx(hi[i], hi[(i + s) % 8]) for i in range(8)]
    bright = lo[0].new_full(lo[0].shape, float("-inf"))
    dark = lo[0].new_full(lo[0].shape, float("inf"))
    for i in range(8):
        bright = mx(bright, mn(lo[i], mx(d[2 * i], d[(2 * i + 9) % 16])))
        dark = mn(dark, mx(hi[i], mn(d[2 * i], d[(2 * i + 9) % 16])))
    dark = -dark
    zero = torch.zeros_like(bright)
    score = mx(torch.where(bright > t, bright - t, zero),
               torch.where(dark > t, dark - t, zero)).float()
    compass = [d[k] for k in (0, 4, 8, 12)]
    live = torch.zeros(score.shape, dtype=torch.bool)
    for i in range(4):
        a, b = compass[i], compass[(i + 1) % 4]
        live |= ((a > t) & (b > t)) | ((a < -t) & (b < -t))
    score = torch.where(live, score, torch.zeros_like(score))
    h, w = imgs.shape[-2:]
    yy = torch.arange(h)[:, None]
    xx = torch.arange(w)[None, :]
    inner = (yy >= 3) & (yy < h - 3) & (xx >= 3) & (xx < w - 3)
    return torch.where(inner, score, torch.zeros_like(score))


@pytest.mark.parametrize("th", [7.3, 10.0, 19.9, 35.0])
def test_kernel_formulation_equals_plain_version(th):
    """The identities the CUDA kernel rests on, bit for bit on the CPU: any
    9-arc holds two neighbouring compass taps, so the compass test drops no
    corner; bf16 rounding is monotone, so the margin min of the best
    all-bright window is bf16(max_w min_k d_k - t); the shared-middle pairing
    of windows gives the same max of mins. Integer, non-integer and
    zero-padded images, and thresholds bf16 cannot represent (7.3, 19.9)."""
    rng = np.random.default_rng(14)
    ints = rng.integers(0, 256, (2, 60, 90)).astype(np.float32)
    floats = rng.uniform(0, 255, (2, 60, 90)).astype(np.float32)
    floats = (floats + np.roll(floats, 1, -1)) * np.float32(0.5)
    floats[1, 45:, :] = 0.0
    for arr in (ints, floats):
        imgs = torch.from_numpy(arr)
        ref = fast.fast_score_map_torch(imgs, th)
        assert (ref > 0).sum() > 50
        assert torch.equal(_kernel_formulation(imgs, th), ref)
