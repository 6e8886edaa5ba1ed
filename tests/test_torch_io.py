"""The port's I/O layer against the reference: rectification
(``ops/camera.py``), dataset loaders (``io/datasets.py``), the native C++
loader (``io/native_loader.py``) and the copied ``utils/viz.py``.

The rectification maps and the loaders are host numpy code copied with
imports changed, so their outputs must be equal; ``remap_bilinear`` and
``rectify_pair`` are torch gathers held to 1e-4 of the reference's jitted
gather on 0-255 images (FMA contraction inside XLA moves the last ulp)."""

import dataclasses
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gfplslam_tpu.io import datasets as ref_datasets
from gfplslam_tpu.io import native_loader as ref_native
from gfplslam_tpu.ops import camera as ref_camera

from gfplslam_torch.io import datasets, native_loader
from gfplslam_torch.ops import camera

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")

# the EuRoC MAV calibration of load_euroc (radial-tangential), and a
# fisheye rig on the equidistant model with a rotated, offset baseline
EUROC = dict(
    kl=np.array([[458.654, 0, 367.215], [0, 457.296, 248.375], [0, 0, 1]]),
    kr=np.array([[457.587, 0, 379.999], [0, 456.134, 255.238], [0, 0, 1]]),
    dl=np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0]),
    dr=np.array([-0.28368365, 0.07451284, -0.00010473, -3.55590700e-05, 0.0]),
    r=np.array([[0.999997, 0.002312, -0.000760],
                [-0.002317, 0.999898, -0.014090],
                [0.000728, 0.014091, 0.999900]]),
    t=np.array([0.110074, -0.000156, 0.000889]),
    width=752, height=480, equidistant=False)
FISHEYE = dict(
    kl=np.array([[190.98, 0, 254.93], [0, 190.97, 256.90], [0, 0, 1]]),
    kr=np.array([[190.44, 0, 252.59], [0, 190.43, 254.91], [0, 0, 1]]),
    dl=np.array([0.0034, 0.0008, -0.0015, 0.0002]),
    dr=np.array([0.0034, 0.0007, -0.0013, 0.0002]),
    r=np.array([[0.99999, -0.00389, 0.00200],
                [0.00389, 0.99999, 0.00103],
                [-0.00200, -0.00102, 0.99999]]),
    t=np.array([0.1010, -0.0019, -0.0010]),
    width=512, height=512, equidistant=True)


def _rectify(mod, c):
    return mod.stereo_rectify(c["kl"], c["dl"], c["kr"], c["dr"], c["r"], c["t"],
                              c["width"], c["height"], equidistant=c["equidistant"])


@pytest.mark.parametrize("calib", [EUROC, FISHEYE], ids=["radtan", "equidistant"])
def test_stereo_rectify_equal(calib):
    got, ref = _rectify(camera, calib), _rectify(ref_camera, calib)
    for a, b in zip(got[:4], ref[:4]):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert dataclasses.asdict(got.cam) == dataclasses.asdict(ref.cam)


def _random_maps(rng, h, w, lead=()):
    # a third of the samples fall outside the image, below 0 included
    mx = rng.uniform(-0.5 * w, 1.5 * w, (*lead, h, w)).astype(np.float32)
    my = rng.uniform(-0.5 * h, 1.5 * h, (*lead, h, w)).astype(np.float32)
    return mx, my


def test_remap_bilinear_matches_reference(rng):
    img = rng.uniform(0, 255, (37, 53)).astype(np.float32)
    mx, my = _random_maps(rng, 37, 53)
    mx[0, :4] = [-1.0, -0.25, 52.0, 52.75]   # integer and fractional edges
    my[0, :4] = [-1.0, 36.0, -0.5, 36.5]
    got = camera.remap_bilinear(*(torch.from_numpy(x) for x in (img, mx, my)))
    ref = np.asarray(ref_camera.remap_bilinear(jnp.asarray(img), jnp.asarray(mx),
                                               jnp.asarray(my)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)


def test_rectify_pair_matches_reference(rng):
    imgs = rng.uniform(0, 255, (2, 40, 56)).astype(np.float32)
    mx, my = _random_maps(rng, 40, 56, (2,))
    maps = camera.RectifyMaps(mx[0], my[0], mx[1], my[1], cam=None)
    got = camera.rectify_pair(torch.from_numpy(imgs), maps)
    ref = np.asarray(ref_camera.rectify_pair(
        jnp.asarray(imgs), ref_camera.RectifyMaps(*maps)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4)
    # both cameras in one call equal each camera alone
    for i in range(2):
        one = camera.remap_bilinear(torch.from_numpy(imgs[i]),
                                    torch.from_numpy(mx[i]), torch.from_numpy(my[i]))
        assert torch.equal(got[i], one)


def _write_pgm(path, img):
    with open(path, "wb") as f:
        f.write(b"P5\n%d %d\n255\n" % (img.shape[1], img.shape[0]))
        f.write(np.ascontiguousarray(img, np.uint8).tobytes())


@pytest.fixture
def euroc_tree(tmp_path, rng):
    """A 752x480 EuRoC ASL tree: epoch-ns PGM names, one right frame 2 ms
    off, one left frame with no right partner, and a GT csv."""
    cam0 = tmp_path / "mav0" / "cam0" / "data"
    cam1 = tmp_path / "mav0" / "cam1" / "data"
    gt = tmp_path / "mav0" / "state_groundtruth_estimate0"
    for d in (cam0, cam1, gt):
        d.mkdir(parents=True)
    base = 1403715273262140000
    ns_l = [base + k * 50_000_000 for k in range(4)]
    ns_r = [ns_l[0], ns_l[1] + 2_000_000, ns_l[2]]   # frame 3 unmatched
    for ns in ns_l:
        _write_pgm(cam0 / f"{ns}.pgm", rng.integers(0, 256, (480, 752)))
    for ns in ns_r:
        _write_pgm(cam1 / f"{ns}.pgm", rng.integers(0, 256, (480, 752)))
    rows = ["#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z"]
    for k in range(6):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        rows.append(",".join([str(base + k * 25_000_000)]
                             + [f"{v:.9f}" for v in (*rng.normal(size=3), *q)]))
    (gt / "data.csv").write_text("\n".join(rows) + "\n")
    return str(tmp_path)


def _seq_equal(a, b):
    assert a.paths_l == b.paths_l and a.paths_r == b.paths_r
    assert a.timestamps.dtype == b.timestamps.dtype == np.float64
    np.testing.assert_array_equal(a.timestamps, b.timestamps)
    assert dataclasses.asdict(a.cam) == dataclasses.asdict(b.cam)
    assert (a.maps is None) == (b.maps is None)
    if a.maps is not None:
        for x, y in zip(a.maps[:4], b.maps[:4]):
            np.testing.assert_array_equal(x, y)
    for x, y in ((a.gt_poses, b.gt_poses), (a.gt_timestamps, b.gt_timestamps)):
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_array_equal(x, y)


def test_load_euroc_equal(euroc_tree):
    got = datasets.load_euroc(euroc_tree)
    _seq_equal(got, ref_datasets.load_euroc(euroc_tree))
    assert len(got.paths_l) == 3 and got.timestamps[0] > 1e9


def _kitti_tree(root, name, rng, n=3, with_meta=True):
    seq = root / name
    for cam in ("image_0", "image_1"):
        (seq / cam).mkdir(parents=True)
        for i in range(n):
            (seq / cam / f"{i:06d}.pgm").write_bytes(b"x")
    if with_meta:
        np.savetxt(seq / "times.txt", np.arange(n) * 0.1036 + 0.25)
        np.savetxt(seq / "poses.txt", rng.normal(size=(n, 12)))
    return str(seq)


@pytest.mark.parametrize("name,with_meta", [("00", True), ("05", True),
                                            ("my_rig", False)])
def test_load_kitti_equal(tmp_path, rng, name, with_meta):
    seq = _kitti_tree(tmp_path, name, rng, with_meta=with_meta)
    with warnings.catch_warnings(record=True) as w_got:
        warnings.simplefilter("always")
        got = datasets.load_kitti(seq)
    with warnings.catch_warnings(record=True) as w_ref:
        warnings.simplefilter("always")
        ref = ref_datasets.load_kitti(seq)
    _seq_equal(got, ref)
    assert [str(w.message) for w in w_got] == [str(w.message) for w in w_ref]


def test_kitti_camera_equal():
    for seq in ("0", "00", "03", "7", "10"):
        assert dataclasses.asdict(datasets.kitti_camera(seq)) == \
            dataclasses.asdict(ref_datasets.kitti_camera(seq))
    with pytest.raises(ValueError) as got:
        datasets.kitti_camera("11")
    with pytest.raises(ValueError) as ref:
        ref_datasets.kitti_camera("11")
    assert str(got.value) == str(ref.value)


def test_load_gazebo_equal(tmp_path):
    for cam, n in (("cam0", 4), ("cam1", 3)):
        d = tmp_path / cam / "data"
        d.mkdir(parents=True)
        for i in range(n):
            (d / f"{int(1e9 * 0.05 * i):019d}.pgm").write_bytes(b"x")
    _seq_equal(datasets.load_gazebo(str(tmp_path)),
               ref_datasets.load_gazebo(str(tmp_path)))


def test_pairing_and_associate_gt_equal(rng):
    ts_l = np.sort(rng.uniform(0, 2, 40))
    ts_r = np.sort(np.concatenate([ts_l[::2] + rng.uniform(-0.004, 0.004, 20),
                                   rng.uniform(0, 2, 5)]))
    assert datasets._pair_by_timestamp(ts_l, ts_r) == \
        ref_datasets._pair_by_timestamp(ts_l, ts_r)
    gt_ts = np.sort(rng.uniform(-0.1, 2.1, 60))
    gt = rng.normal(size=(60, 4, 4))
    keep, gtp = datasets.associate_gt(ts_l, gt_ts, gt)
    keep_r, gtp_r = ref_datasets.associate_gt(ts_l, gt_ts, gt)
    np.testing.assert_array_equal(keep, keep_r)
    np.testing.assert_array_equal(gtp, gtp_r)


def _ref_native():
    if not ref_native.native_available():
        pytest.skip("the reference's native loader is not built here")
    return ref_native


def test_native_decode_equal(tmp_path, rng):
    ref = _ref_native()
    img = rng.integers(0, 256, (31, 45)).astype(np.uint8)
    p = str(tmp_path / "a.pgm")
    _write_pgm(p, img)
    got = native_loader.decode_image(p)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, img.astype(np.float32))
    np.testing.assert_array_equal(got, ref.decode_image(p))
    if "png" in native_loader.formats():
        cv2 = pytest.importorskip("cv2")
        q = str(tmp_path / "a.png")
        cv2.imwrite(q, img)
        np.testing.assert_array_equal(native_loader.decode_image(q),
                                      ref.decode_image(q))


def test_native_png_without_libpng_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(native_loader, "formats", lambda: {"pgm"})
    with pytest.raises(RuntimeError, match="no png decoder"):
        native_loader.decode_image(str(tmp_path / "a.png"))


def test_native_stereo_loader_equal(euroc_tree):
    ref = _ref_native()
    seq = datasets.load_euroc(euroc_tree)
    m = seq.maps
    maps = (m.map_x_l, m.map_y_l, m.map_x_r, m.map_y_r)
    args = (seq.paths_l, seq.paths_r, seq.cam.width, seq.cam.height)
    with native_loader.StereoLoader(*args, maps=maps, n_threads=3) as loader:
        got = list(loader)
    want = list(ref.StereoLoader(*args, maps=maps, n_threads=3))
    assert [k for k, _, _ in got] == [0, 1, 2] == [k for k, _, _ in want]
    for (_, gl, gr), (_, wl, wr) in zip(got, want):
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_array_equal(gr, wr)
    # the device remap of the decoded pair agrees with the C++ remap
    raw = np.stack([native_loader.decode_image(seq.paths_l[1]),
                    native_loader.decode_image(seq.paths_r[1])])
    rect = camera.rectify_pair(torch.from_numpy(raw), m).numpy()
    np.testing.assert_allclose(rect, np.stack(got[1][1:]), rtol=0, atol=1e-3)


def test_native_stereo_loader_crops_without_maps(tmp_path, rng):
    imgs = [rng.integers(0, 256, (20, 30)) for _ in range(2)]
    paths = []
    for i, img in enumerate(imgs):
        paths.append(str(tmp_path / f"{i}.pgm"))
        _write_pgm(paths[-1], img)
    with native_loader.StereoLoader(paths[:1], paths[1:], 32, 16) as loader:
        (k, left, right), = list(loader)
    want = np.zeros((16, 32), np.float32)
    want[:, :30] = imgs[0][:16]
    np.testing.assert_array_equal(left, want)


def test_viz_is_a_byte_copy():
    a, b = (open(os.path.join(REPO, pkg, "utils", "viz.py"), "rb").read()
            for pkg in ("gfplslam_tpu", "gfplslam_torch"))
    assert a == b


def test_datasets_is_a_copy_with_imports_changed():
    a, b = (open(os.path.join(REPO, pkg, "io", "datasets.py")).read()
            for pkg in ("gfplslam_tpu", "gfplslam_torch"))
    assert a.replace("gfplslam_tpu.", "gfplslam_torch.") == b
