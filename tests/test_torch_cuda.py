"""The CUDA kernels against their plain PyTorch versions, on a CUDA card.

Marked ``gpu``: without a card every test here skips (a CUDA kernel has no
CPU mode; its arithmetic is held to the reference through the plain
versions in test_torch_fast.py and test_torch_hamming.py). On a machine with
a card and without JAX, run them with

    python -m pytest tests/test_torch_cuda.py -m gpu --noconftest -q

This file imports no JAX."""

import numpy as np
import pytest
import torch

from gfplslam_torch.config import CameraParams, Config
from gfplslam_torch.io import synthetic
from gfplslam_torch.ops import fast, hamming
from gfplslam_torch.ops.pyramid import build_pyramid_padded, level_shapes
from gfplslam_torch.utils.kernel_bench import HAMMING_KEYFRAME, HAMMING_LIBRARY

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


# 7.3 and 19.9 are not bf16 values: the threshold's own rounding counts
THRESHOLDS = (7.3, 10.0, 19.9, 20.0, 35.0)


@pytest.mark.parametrize("shape,offset", [
    ((1, 7, 7), 0), ((3, 37, 53), 0), ((2, 240, 376), 0), ((6, 200, 313), 0),
    ((2, 481, 753), 0),
    # contiguous views that start 4 / 12 bytes into their storage, at widths
    # that would otherwise take the 16-byte loads and stores
    ((2, 480, 752), 1), ((1, 40, 64), 3)])
def test_fast_kernel_equals_plain(dev, shape, offset):
    rng = np.random.default_rng(sum(shape))
    flat = rng.uniform(0, 255, offset + int(np.prod(shape))).astype(np.float32)
    imgs = torch.as_tensor(flat, device=dev)[offset:].view(shape)
    for th in THRESHOLDS:
        before = fast.fast_score_cuda.launches
        out = fast.fast_score_cuda(imgs, torch.tensor([th], device=dev))
        assert fast.fast_score_cuda.launches == before + 1
        assert torch.equal(out, fast.fast_score_map_torch(imgs, th))


@pytest.mark.parametrize("levels", ["level 0", "levels 1-3"])
def test_fast_kernel_equals_plain_on_pyramid(dev, levels):
    """The main path's inputs: a rendered 752x480 pair's padded pyramid,
    batched as frame.py batches it (non-integer intensities from level 1)."""
    cfg = Config(camera=CameraParams())
    world = synthetic.make_world(n_frames=1, n_points=900, n_lines=90, seed=3,
                                 cam=cfg.camera)
    pair = np.stack(synthetic.render_frame(world, 0, noise=1.5))
    imgs = torch.as_tensor(np.clip(np.round(pair), 0, 255).astype(np.float32),
                           device=dev)
    nlv, scale = cfg.orb.nlevels, cfg.orb.scale_factor
    pyr = build_pyramid_padded(imgs, nlv, scale)
    h1, w1 = level_shapes(480, 752, nlv, scale)[1]
    x = (pyr[:, 0] if levels == "level 0"
         else pyr[:, 1:, :h1, :w1].reshape(-1, h1, w1)).contiguous()
    for th in THRESHOLDS:
        ref = fast.fast_score_map_torch(x, th)
        assert float(ref.max()) > 0
        assert torch.equal(fast.fast_score_cuda(x, th), ref)


def test_fast_dispatch_launches_kernel(dev):
    imgs = torch.zeros(2, 40, 50, device=dev)
    before = fast.fast_score_cuda.launches
    fast.fast_score_map(imgs, 20.0)
    assert fast.fast_score_cuda.launches == before + 1


_EDGE = (1, 7, 1023, 1025)


@pytest.mark.parametrize("n,m,masks,fill", [
    (1024, 1024, "both", None), (512, 512, "both", None),
    (100, 60, "both", None), (33, 1, "none", None),
    *[(n, m, masks, None) for n in _EDGE for m in _EDGE
      for masks in ("both", "a", "b", "none")],
    # all-zero against all-ones descriptors: every distance is 256
    (7, 1025, "none", 256)])
def test_hamming_kernel_equals_plain(dev, n, m, masks, fill):
    rng = np.random.default_rng(n + m)
    if fill is None:
        a = torch.as_tensor(rng.integers(-2**31, 2**31, (n, 8)),
                            dtype=torch.int32, device=dev)
        b = torch.as_tensor(rng.integers(-2**31, 2**31, (m, 8)),
                            dtype=torch.int32, device=dev)
    else:
        a = torch.zeros(n, 8, dtype=torch.int32, device=dev)
        b = torch.full((m, 8), -1, dtype=torch.int32, device=dev)
    va = (torch.as_tensor(rng.random(n) < 0.7, device=dev)
          if masks in ("both", "a") else None)
    vb = (torch.as_tensor(rng.random(m) < 0.7, device=dev)
          if masks in ("both", "b") else None)
    before = hamming.hamming_cuda.launches
    out = hamming.hamming_matrix(a, b, va, vb)
    assert hamming.hamming_cuda.launches == before + 1
    assert torch.equal(out, hamming.hamming_matrix_torch(a, b, va, vb))
    if fill is not None:
        assert bool((out == fill).all())


def test_kernels_refuse_wrong_inputs(dev):
    with pytest.raises(ValueError):
        fast.fast_score_cuda(torch.zeros(2, 8, 8, device=dev, dtype=torch.float64), 20.0)
    with pytest.raises(ValueError):
        hamming.hamming_cuda(torch.zeros(4, 8, dtype=torch.int32, device=dev),
                             torch.zeros(4, 4, dtype=torch.int32, device=dev))


@pytest.mark.parametrize("label,n,m,masks", HAMMING_KEYFRAME)
def test_hamming_kernel_at_back_end_shapes(dev, label, n, m, masks):
    """One SLAM keyframe's six Hamming shapes (map pools, vocabularies,
    snapshot verification), masked as the callers mask them: bit-exact."""
    rng = np.random.default_rng(n * 7 + m)
    a = torch.as_tensor(rng.integers(-2**31, 2**31, (n, 8)), dtype=torch.int32, device=dev)
    b = torch.as_tensor(rng.integers(-2**31, 2**31, (m, 8)), dtype=torch.int32, device=dev)
    va = torch.as_tensor(rng.random(n) < 0.8, device=dev)
    vb = torch.as_tensor(rng.random(m) < 0.8, device=dev) if masks == "both" else None
    before = hamming.hamming_cuda.launches
    out = hamming.hamming_matrix(a, b, va, vb)
    assert hamming.hamming_cuda.launches == before + 1
    assert torch.equal(out, hamming.hamming_matrix_torch(a, b, va, vb))


@pytest.mark.parametrize("n", [8192, 1000])
def test_hamming_kernel_at_train_vocab_shapes(dev, n):
    """``train_vocab``'s assignment block against a 4096-word codebook,
    unmasked as it calls the kernel: bit-exact, and each single PyTorch call
    of ``kernel_bench.HAMMING_LIBRARY`` equal to it."""
    rng = np.random.default_rng(n)
    a = torch.as_tensor(rng.integers(-2**31, 2**31, (n, 8)), dtype=torch.int32, device=dev)
    b = torch.as_tensor(rng.integers(-2**31, 2**31, (4096, 8)), dtype=torch.int32, device=dev)
    before = hamming.hamming_cuda.launches
    out = hamming.hamming_matrix(a, b)
    assert hamming.hamming_cuda.launches == before + 1
    assert torch.equal(out, hamming.hamming_matrix_torch(a, b))
    for call, fn in HAMMING_LIBRARY.items():
        assert torch.equal(fn(a, b), out), call


def test_kmajority_card_equals_cpu(dev):
    """k-majority (Hamming assignment + one-hot fp32 vote) gives the same
    centers on the card as on the CPU."""
    from gfplslam_torch.apps import train_vocab
    rng = np.random.default_rng(5)
    desc = rng.integers(0, 2**32, size=(3000, 8), dtype=np.uint32)
    before = hamming.hamming_cuda.launches
    got = train_vocab.kmajority(desc, 64, iters=5, device=dev)
    assert hamming.hamming_cuda.launches > before
    np.testing.assert_array_equal(got, train_vocab.kmajority(desc, 64, iters=5,
                                                             device="cpu"))


def _euroc_maps():
    from gfplslam_torch.ops.camera import stereo_rectify
    kl = np.array([[458.654, 0, 367.215], [0, 457.296, 248.375], [0, 0, 1]])
    kr = np.array([[457.587, 0, 379.999], [0, 456.134, 255.238], [0, 0, 1]])
    dl = np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0])
    dr = np.array([-0.28368365, 0.07451284, -0.00010473, -3.55590700e-05, 0.0])
    r = np.array([[0.999997, 0.002312, -0.000760], [-0.002317, 0.999898, -0.014090],
                  [0.000728, 0.014091, 0.999900]])
    return stereo_rectify(kl, dl, kr, dr, r, np.array([0.110074, -0.000156, 0.000889]),
                          752, 480)


def test_rectify_pair_card_against_cpu(dev):
    """EuRoC's rectification maps applied on the card: within 1e-3 of the
    CPU on 0-255 images (the same gathers and weights; only FMA contraction
    may differ)."""
    from gfplslam_torch.ops.camera import rectify_pair
    maps = _euroc_maps()
    raw = torch.as_tensor(np.random.default_rng(3).integers(0, 256, (2, 480, 752)),
                          dtype=torch.float32)
    got = rectify_pair(raw.to(dev), maps)
    assert got.device.type == "cuda"
    assert float((got.cpu() - rectify_pair(raw, maps)).abs().max()) <= 1e-3


def test_native_loader_on_card_machine(dev, tmp_path):
    """The C++ loader builds on the card's machine, decodes binary PGM
    exactly, and its rectified frames lie within 1e-3 of ``rectify_pair``
    on the card."""
    from gfplslam_torch.io import native_loader
    from gfplslam_torch.ops.camera import rectify_pair
    rng = np.random.default_rng(9)
    imgs = rng.integers(0, 256, (2, 480, 752)).astype(np.uint8)
    paths = []
    for side, img in zip("lr", imgs):
        paths.append(str(tmp_path / f"{side}.pgm"))
        with open(paths[-1], "wb") as f:
            f.write(b"P5\n752 480\n255\n" + img.tobytes())
        np.testing.assert_array_equal(native_loader.decode_image(paths[-1]), img)
    maps = _euroc_maps()
    with native_loader.StereoLoader(paths[:1], paths[1:], 752, 480,
                                    maps=(maps.map_x_l, maps.map_y_l,
                                          maps.map_x_r, maps.map_y_r)) as loader:
        (k, left, right), = list(loader)
    want = rectify_pair(torch.as_tensor(imgs, dtype=torch.float32, device=dev), maps)
    assert k == 0
    assert float((torch.as_tensor(np.stack([left, right])) - want.cpu()).abs().max()) <= 1e-3


def _to(tree, device):
    if isinstance(tree, tuple):
        return type(tree)(*(_to(x, device) for x in tree))
    return tree.to(device)


@pytest.mark.parametrize("run_ba", [False, True])
def test_mapping_step_card_against_cpu(dev, run_ba):
    """One mapping_step on the card against the same step of the CPU port,
    on a map built on the CPU from the 376x240 world of
    tests/test_slam_e2e.py. Without local BA every integer, bool and
    descriptor leaf is equal and floats agree within 1e-4 (a rejected
    speculative verification's pose, error and inliers excepted); with it, the
    leaves the BA does not touch are equal, the window poses agree within
    2e-2 (see tests/test_torch_ba.py) and the BA error within 5%."""
    from gfplslam_torch.config import CapacityParams, OrbParams
    from gfplslam_torch.models import mapping
    from gfplslam_torch.models.slam import SLAMSystem
    cpu = torch.device("cpu")
    cfg = Config(cap=CapacityParams(n_pt=256, n_ln=128, n_kf_window=4, n_kf_max=32,
                                    n_map_pt=2048, n_map_ln=512, n_obs_pt=1024,
                                    n_obs_ln=256, vocab_k=128),
                 orb=OrbParams(nlevels=2),
                 camera=CameraParams(width=376, height=240, fx=217.6, fy=217.6,
                                     cx=183.7, cy=126.1, baseline=0.11))
    world = synthetic.make_world(n_frames=10, n_points=300, n_lines=40, seed=11)
    slam = SLAMSystem(cfg, device=cpu, async_mapping=False)
    calls = []
    step = mapping.mapping_step

    def record(cfg_, m, ls, frame, t_rel, **kw):
        calls.append((m, ls, frame, t_rel))
        return step(cfg_, m, ls, frame, t_rel, **kw)
    mapping.mapping_step = record
    try:
        for i in range(10):
            slam.process(*synthetic.render_frame(world, i, noise=1.0), world.timestamps[i])
    finally:
        mapping.mapping_step = step
    m, ls, frame, t_rel = calls[-1]
    want = step(cfg, m, ls, frame, t_rel, run_ba=run_ba)
    got = _to(step(cfg, *(_to(x, dev) for x in (m, ls, frame, t_rel)), run_ba=run_ba), cpu)
    ba_leaves = ("kf_pose", "pt_pos", "ln_sp", "ln_ep", "po_valid", "pt_obs_n",
                 "full_graph", "ba_err", "ba_iters")
    # a speculative verification that is rejected may end anywhere
    skip = () if bool(want.verification.accepted) else ("t_rel", "err", "n_inliers")

    def check(g, w, name=""):
        if isinstance(w, tuple):
            for field, gg, ww in zip(w._fields, g, w):
                check(gg, ww, field)
        elif (run_ba and name in ba_leaves) or name in skip:
            return
        elif w.dtype.is_floating_point:
            assert torch.allclose(g, w, rtol=0, atol=1e-4), name
        else:
            assert torch.equal(g, w), name
    check(got, want)
    if run_ba:
        assert (got.map.kf_pose - want.map.kf_pose).abs().max() < 2e-2
        assert abs(float(got.ba_err) - float(want.ba_err)) < 0.05 * float(want.ba_err)
