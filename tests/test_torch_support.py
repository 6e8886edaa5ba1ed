"""The port's support layer against the reference: copied numpy-only modules,
constant tables, the state converters, and the no-JAX import contract."""

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from gfplslam_tpu import config as ref_config
from gfplslam_tpu.io import synthetic as ref_synthetic
from gfplslam_tpu.ops import fast as ref_fast
from gfplslam_tpu.ops import lbd as ref_lbd
from gfplslam_tpu.ops import lsd as ref_lsd
from gfplslam_tpu.ops import orb as ref_orb
from gfplslam_tpu.ops import orb_pattern as ref_orb_pattern
from gfplslam_tpu.utils import timing as ref_timing
from gfplslam_tpu.utils import trajectory as ref_trajectory

from gfplslam_torch import config
from gfplslam_torch.io import synthetic
from gfplslam_torch.ops import fast, lbd, lsd, orb, orb_pattern
from gfplslam_torch.utils import convert, timing, trajectory

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_config_defaults_equal():
    assert dataclasses.asdict(config.Config()) == dataclasses.asdict(ref_config.Config())
    assert dataclasses.asdict(config.KITTI_00_CAMERA) == dataclasses.asdict(
        ref_config.KITTI_00_CAMERA)


def test_config_from_ref_keeps_every_value():
    ref = ref_config.load_config({"orb": {"nlevels": 2, "fast_th": 17},
                                  "cap": {"n_pt": 256}})
    port = convert.config_from_ref(ref)
    assert isinstance(port, config.Config)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


@pytest.mark.parametrize("name", ["ORB_PATTERN", "pool", "pairs", "lbd_pairs",
                                  "fast_circle", "lsd_steps", "lsd_step_len"])
def test_constant_tables_equal(name):
    pool, pairs = orb_pattern.orb_pool_pairs()
    ref_pool, ref_pairs = ref_orb_pattern.orb_pool_pairs()
    got, want = {
        "ORB_PATTERN": (orb_pattern.ORB_PATTERN, ref_orb_pattern.ORB_PATTERN),
        "pool": (pool, ref_pool),
        "pairs": (pairs, ref_pairs),
        "lbd_pairs": (lbd.PAIR_PATTERN, ref_lbd.PAIR_PATTERN),
        "fast_circle": (fast.FAST_CIRCLE, ref_fast.FAST_CIRCLE),
        "lsd_steps": (lsd.STEPS, ref_lsd.STEPS),
        "lsd_step_len": (lsd.STEP_LEN, ref_lsd.STEP_LEN),
    }[name]
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_brief_pool_is_the_reference_active_pattern():
    np.testing.assert_array_equal(orb.BRIEF_POOL, ref_orb.BRIEF_POOL)
    np.testing.assert_array_equal(orb.BRIEF_PAIRS, ref_orb.BRIEF_PAIRS)


@pytest.mark.parametrize("kwargs", [
    dict(n_frames=3, n_points=120, n_lines=15, seed=2),
    dict(n_frames=3, n_points=80, n_lines=10, seed=5, motion="still"),
    dict(n_frames=3, n_points=60, n_lines=8, seed=11, motion="circuit",
         textured=True),
])
def test_render_frame_byte_identical(kwargs):
    w_port = synthetic.make_world(**kwargs)
    w_ref = ref_synthetic.make_world(**kwargs)
    np.testing.assert_array_equal(w_port.poses, w_ref.poses)
    np.testing.assert_array_equal(w_port.points, w_ref.points)
    for i in range(kwargs["n_frames"]):
        for a, b in zip(synthetic.render_frame(w_port, i, noise=1.0),
                        ref_synthetic.render_frame(w_ref, i, noise=1.0)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_trajectory_and_timing_copies_agree(tmp_path):
    rng = np.random.default_rng(0)
    world = synthetic.make_world(n_frames=12, n_points=10, n_lines=2, seed=1)
    est = world.poses.copy()
    est[:, :3, 3] += rng.normal(0, 0.01, (12, 3))
    assert trajectory.ate_rmse(est, world.poses) == ref_trajectory.ate_rmse(
        est, world.poses)
    p1, p2 = tmp_path / "a.txt", tmp_path / "b.txt"
    trajectory.write_tum(str(p1), world.timestamps, est)
    ref_trajectory.write_tum(str(p2), world.timestamps, est)
    assert p1.read_text() == p2.read_text()
    assert timing.FIELDS == ref_timing.FIELDS
    row = dict(time_track=0.5, num_pt_stereo=7)
    assert timing.TimeLog(**row).row() == ref_timing.TimeLog(**row).row()


def test_convert_descriptor_words_by_bit_view():
    from gfplslam_tpu.models.pose_opt import PointMatches as RefPM
    from gfplslam_torch.models.frame import StereoPoints
    rng = np.random.default_rng(3)
    desc = rng.integers(0, 2 ** 32, (5, 8), dtype=np.uint32)
    ref = StereoPoints(xy=np.zeros((5, 2), np.float32), disp=np.ones(5, np.float32),
                       p3d=np.zeros((5, 3), np.float32), desc=desc,
                       level=np.arange(5, dtype=np.int32),
                       sigma2=np.ones(5, np.float32), valid=np.ones(5, bool))
    t = convert.to_torch(ref, torch.device("cpu"))
    assert t.desc.dtype == torch.int32
    np.testing.assert_array_equal(t.desc.numpy().view(np.uint32), desc)
    back = convert.to_numpy(t)
    assert back.desc.dtype == np.uint32
    np.testing.assert_array_equal(back.desc, desc)
    # classes are matched by name across the packages
    pm = convert.to_torch(RefPM(p3d=np.zeros((2, 3), np.float32),
                                obs=np.zeros((2, 2), np.float32),
                                sigma2=np.ones(2, np.float32),
                                valid=np.array([True, False])), torch.device("cpu"))
    assert type(pm).__module__ == "gfplslam_torch.models.pose_opt"


@pytest.mark.parametrize("module", ["gfplslam_torch.models.vo",
                                    "gfplslam_torch.utils.convert",
                                    "gfplslam_torch.models.ba_core",
                                    "gfplslam_torch.models.ba",
                                    "gfplslam_torch.models.map",
                                    "gfplslam_torch.models.loop",
                                    "gfplslam_torch.models.mapping",
                                    "gfplslam_torch.models.slam"])
def test_port_imports_no_jax(module):
    code = (f"import sys, {module}; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'jaxlib', 'gfplslam_tpu'))); "
            "assert not bad, bad; print('clean')")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_port_sources_never_import_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|gfplslam_tpu)\b", re.M)
    files = [os.path.join(REPO, f) for f in ("chip_smoke.py", "profile_torch_vo.py",
                                             "profile_torch_kernels.py",
                                             "profile_torch_slam.py")]
    for root, _, names in os.walk(os.path.join(REPO, "gfplslam_torch")):
        files += [os.path.join(root, f) for f in names if f.endswith(".py")]
    for f in files:
        assert not pat.search(open(f).read()), f


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a CUDA card, and alone in a directory, chip_smoke exits
    non-zero and prints no result line."""
    import shutil
    lone = tmp_path / "lone"
    lone.mkdir()
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), lone / "chip_smoke.py")
    for cwd, script in ((REPO, os.path.join(REPO, "chip_smoke.py")),
                        (str(lone), str(lone / "chip_smoke.py"))):
        out = subprocess.run([sys.executable, script], capture_output=True,
                             text=True, cwd=cwd, timeout=120,
                             env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


@pytest.mark.parametrize("name", ["vocab_synth.npz", "vocab_synth_128.npz",
                                  "vocab_synth4096.npz"])
def test_vocabulary_files_are_byte_copies(name):
    """The port reads its own copies of the reference's trained codebooks."""
    import hashlib
    digest = [hashlib.sha256(open(os.path.join(REPO, pkg, "data", name), "rb").read()
                             ).hexdigest() for pkg in ("gfplslam_tpu", "gfplslam_torch")]
    assert digest[0] == digest[1]


@pytest.mark.parametrize("vocab_k", [128, 256, 4096, 64])
def test_loaded_vocabularies_and_idf_equal(vocab_k):
    """Words and frozen idf at every shipped size, and the random-anchor
    fallback (64 words, no idf), equal to the reference's."""
    from gfplslam_tpu.models import loop as ref_loop
    from gfplslam_torch.models import loop
    for got, want in zip(loop.active_vocab(vocab_k), ref_loop.active_vocab(vocab_k)):
        assert got.dtype == want.dtype == np.uint32
        np.testing.assert_array_equal(got, want)
    got, want = loop.active_idf(vocab_k), ref_loop.active_idf(vocab_k)
    assert (got is None) == (want is None) == (vocab_k == 64)
    if want is not None:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert loop.trained_sizes() == sorted(ref_loop._TRAINED)
    assert loop.vocab_source().endswith("gfplslam_torch/data/vocab_synth.npz")
    assert loop.DATA_DIR == os.path.join(REPO, "gfplslam_torch", "data")


@pytest.mark.parametrize("with_df", [True, False])
def test_load_vocab_installs_a_codebook(tmp_path, monkeypatch, with_df):
    """``load_vocab`` of a codebook file gives the reference's words and idf
    at its word count, and the device copy is their int32 bit view."""
    from gfplslam_tpu.models import loop as ref_loop
    from gfplslam_torch.models import loop
    monkeypatch.setattr(loop, "_VOCAB", loop._Vocabularies())
    monkeypatch.setattr(ref_loop, "_TRAINED", dict(ref_loop._TRAINED))
    monkeypatch.setattr(ref_loop, "VOCAB_SOURCE", ref_loop.VOCAB_SOURCE)
    rng = np.random.default_rng(5)
    arrays = dict(vocab_p=rng.integers(0, 2 ** 32, (32, 8), dtype=np.uint32),
                  vocab_l=rng.integers(0, 2 ** 32, (32, 8), dtype=np.uint32))
    if with_df:
        arrays.update(df_p=rng.integers(0, 50, 32).astype(np.float32),
                      df_l=rng.integers(0, 50, 32).astype(np.float32),
                      n_docs=np.float32(60))
    path = str(tmp_path / "codebook.npz")
    np.savez(path, **arrays)
    loop.load_vocab(path)
    ref_loop.load_vocab(path)
    for got, want in zip(loop.active_vocab(32), ref_loop.active_vocab(32)):
        np.testing.assert_array_equal(got, want)
    got, want = loop.active_idf(32), ref_loop.active_idf(32)
    assert (got is None) == (want is None) == (not with_df)
    if with_df:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert loop.vocab_source() == "set_vocab()"
    vp, vl, _ = loop._device_vocab(32, torch.device("cpu"))
    assert torch.equal(vp, torch.from_numpy(arrays["vocab_p"].view(np.int32)))
    assert torch.equal(vl, torch.from_numpy(arrays["vocab_l"].view(np.int32)))


@pytest.mark.parametrize("state", ["MapState", "LoopState"])
def test_convert_round_trips_back_end_state(state):
    """Reference map / loop state -> port -> numpy, every leaf equal; the
    descriptor rings and snapshots by bit view."""
    from gfplslam_tpu import config as rc
    from gfplslam_tpu.models import loop as ref_loop
    from gfplslam_tpu.models import map as ref_map
    cfg = rc.Config(cap=rc.CapacityParams(n_kf_max=8, n_map_pt=64, n_map_ln=32,
                                          n_obs_pt=16, n_obs_ln=8, vocab_k=16))
    rng = np.random.default_rng(8)
    ref = (ref_map.empty_map(cfg) if state == "MapState"
           else ref_loop.empty_loop_state(cfg))
    leaves = {}
    for name, v in zip(ref._fields, ref):
        v = np.asarray(v)
        if v.dtype == np.uint32:
            v = rng.integers(0, 2 ** 32, v.shape, dtype=np.uint32)
        elif v.dtype == bool:
            v = rng.random(v.shape) < 0.5
        elif v.dtype.kind == "i":
            v = rng.integers(-5, 500, v.shape).astype(v.dtype)
        else:
            v = rng.normal(0, 1, v.shape).astype(v.dtype)
        leaves[name] = v
    ref = type(ref)(**leaves)
    port = convert.to_torch(ref, torch.device("cpu"))
    assert type(port).__module__.startswith("gfplslam_torch.models.")
    back = convert.to_numpy(port)
    for name, g, w in zip(ref._fields, back, ref):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    desc = "pt_desc_hist" if state == "MapState" else "pt_desc"
    assert getattr(port, desc).dtype == torch.int32
