"""The port's place-recognition and matching tools against the reference:
``train_vocab`` (bit packing, k-majority, document frequencies, its CLI),
``match_demo`` and ``vocab_pr``.

Integer outputs (vocabulary words, document frequencies, match counts,
revisit labels) must be equal; ``vocab_pr``'s float scores come from the
same tf-idf arithmetic and are held to 1e-5, its PR curve exactly on one
score matrix."""

import dataclasses
import json
import os

import numpy as np
import torch

from gfplslam_tpu import config as ref_config
from gfplslam_tpu.apps import match_demo as ref_match_demo
from gfplslam_tpu.apps import train_vocab as ref_train_vocab
from gfplslam_tpu.apps import vocab_pr as ref_vocab_pr
from gfplslam_tpu.models import frame as ref_frame

from gfplslam_torch.apps import match_demo, train_vocab, vocab_pr
from gfplslam_torch.config import (CameraParams, CapacityParams, Config,
                                   OrbParams)
from gfplslam_torch.io import synthetic
from gfplslam_torch.models.frame import process_stereo_pair
from gfplslam_torch.utils import convert

torch.set_num_threads(2)
CPU = torch.device("cpu")
SMALL = Config(cap=CapacityParams(n_pt=256, n_ln=128), orb=OrbParams(nlevels=2),
               camera=CameraParams(width=376, height=240, fx=217.6, fy=217.6,
                                   cx=183.7, cy=126.1, baseline=0.11))


def _clustered_descriptors(rng, n, k):
    """n uint32 descriptors around k random centers, ~10% of bits flipped."""
    centers = rng.integers(0, 2 ** 32, size=(k, 8), dtype=np.uint32)
    bits = ref_train_vocab.unpack_bits(centers[rng.integers(0, k, n)])
    flip = rng.random(bits.shape) < 0.1
    return ref_train_vocab.pack_bits(bits ^ flip)


def test_pack_bits_equal(rng):
    desc = rng.integers(0, 2 ** 32, size=(50, 8), dtype=np.uint32)
    bits = train_vocab.unpack_bits(desc)
    np.testing.assert_array_equal(bits, ref_train_vocab.unpack_bits(desc))
    np.testing.assert_array_equal(train_vocab.pack_bits(bits), desc)
    np.testing.assert_array_equal(train_vocab.pack_bits(bits),
                                  ref_train_vocab.pack_bits(bits))


def test_kmajority_and_document_frequencies_equal(rng):
    desc = _clustered_descriptors(rng, 3000, 48)
    got = train_vocab.kmajority(desc, 64, iters=5, device=CPU)
    want = ref_train_vocab.kmajority(desc, 64, iters=5)
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    docs = np.array_split(desc, 12) + [desc[:0]]
    np.testing.assert_array_equal(
        train_vocab.document_frequencies(got, docs, device=CPU),
        ref_train_vocab.document_frequencies(want, docs))


def test_train_vocab_main(tmp_path):
    out = str(tmp_path / "v.npz")
    train_vocab.main(["--synthetic", "--frames", "2", "--words", "16",
                      "-o", out, "--device", "cpu"])
    with np.load(out) as v:
        assert v["vocab_p"].shape == v["vocab_l"].shape == (16, 8)
        assert v["vocab_p"].dtype == np.uint32
        assert int(v["n_docs"]) == 7 and 0 < v["df_p"].max() <= 7


def test_match_demo_equal(tmp_path):
    got = match_demo.main(["--synthetic", "-n", "2", "--device", "cpu",
                           "-o", str(tmp_path / "port")])
    want = ref_match_demo.main(["--synthetic", "-n", "2",
                                "-o", str(tmp_path / "ref")])
    assert got == want and got["mean_pt"] > 0
    for side in ("port", "ref"):
        with open(tmp_path / side / "summary.json") as f:
            assert json.load(f)["summary"] == got
    assert os.path.getsize(tmp_path / "port" / "match_001.png") > 1000


def _ref_frame_of(port_frame):
    """A port StereoFrame as the reference's NamedTuples of numpy leaves."""
    f = convert.to_numpy(port_frame)
    return ref_frame.StereoFrame(
        points=ref_frame.StereoPoints(*f.points),
        lines=ref_frame.StereoLines(*f.lines),
        feat_l=ref_frame.CameraFeatures(*f.feat_l))


def test_vocab_pr_equal():
    world = synthetic.make_world(n_frames=6, n_points=300, n_lines=40, seed=11,
                                 motion="circuit", textured=True, laps=2)
    th = torch.tensor(20.0)
    frames = [process_stereo_pair(*(torch.as_tensor(x) for x in
                                    synthetic.render_frame(world, i, noise=1.0)),
                                  SMALL, th) for i in range(6)]
    ref_frames = [_ref_frame_of(f) for f in frames]
    ref_cfg = ref_config.load_config(dataclasses.asdict(SMALL))
    labels = vocab_pr.revisit_labels(world.poses, min_sep=2, pos_dist=1.0,
                                     pos_deg=30.0, neg_dist=1.5)
    assert labels == ref_vocab_pr.revisit_labels(world.poses, min_sep=2,
                                                 pos_dist=1.0, pos_deg=30.0,
                                                 neg_dist=1.5)
    assert 0 < sum(labels.values()) < len(labels)
    for k in (128, 64):   # a trained codebook, and random anchors
        got = vocab_pr.build_score_matrix(k, frames, SMALL, CPU)
        want = ref_vocab_pr.build_score_matrix(k, ref_frames, ref_cfg)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        assert vocab_pr.pr_curve(want, labels) == ref_vocab_pr.pr_curve(want, labels)
