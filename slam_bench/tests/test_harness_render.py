"""The generator's frames equal the port's renderer's, byte for byte: hashes
recorded from ``io/synthetic.py`` at the small rig and fixed seeds."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

from slam_bench import synth

HASHES = json.loads((Path(__file__).parent / "render_hashes.json").read_text())["frames"]


@pytest.mark.parametrize("case", HASHES, ids=lambda c: f"{c['motion']}-{c['seed']}-{c['frame']}")
def test_frames_match_the_recorded_hashes(case):
    w = synth.make_world(case["n_frames"], 900, 90, case["seed"], motion=case["motion"],
                         textured=case["textured"])
    left, right = synth.render_frame(w, case["frame"], noise=case["noise"])
    assert hashlib.sha256(left.tobytes() + right.tobytes()).hexdigest() == case["sha256"]


def test_the_pool_renders_what_a_loop_renders():
    spec = {"n_frames": 6, "n_points": 900, "n_lines": 90, "motion": "forward",
            "textured": False, "noise": 1.5, "ts_dtype": "float32"}
    pooled = synth.render_world(spec, synth.SMALL_CAMERA, 5, workers=2)
    w = synth.make_world(6, 900, 90, 5)
    for i in range(6):
        left, right = synth.render_frame(w, i, noise=1.5)
        assert np.array_equal(pooled.left[i], synth.u8(left))
        assert np.array_equal(pooled.right[i], synth.u8(right))
    assert pooled.ts.dtype == np.float32 and np.array_equal(pooled.poses, w.poses)


def test_box_offset_moves_only_the_boxes():
    w = synth.make_world(8, 900, 90, 7, motion="forward", textured=True)
    moved = synth.make_world(8, 900, 90, 7, motion="forward", textured=True, box_offset=3.0)
    for name in ("points", "seg_start", "seg_end", "poses", "timestamps"):
        assert np.array_equal(getattr(w, name), getattr(moved, name)), name
    shift = moved.boxes - w.boxes
    assert np.allclose(shift[..., 2], 3.0) and not shift[..., :2].any()
