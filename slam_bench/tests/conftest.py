"""Fixtures of the harness tests: a cell cut to a size a CPU test can hold,
and the card, decided inside a fixture."""

import json

import pytest

from slam_bench import registry

# the synthetic worlds' own 376x240 rig and reduced budgets (the port's
# bench --small capacities): the tests' size, never a benchmark cell's
SMALL_CAMERA = {"width": 376, "height": 240, "fx": 217.6, "fy": 217.6,
                "cx": 183.7, "cy": 126.1, "baseline": 0.11}
SMALL_ENGINE = {"cap": {"n_pt": 256, "n_ln": 128, "n_kf_window": 4, "n_kf_max": 32,
                        "n_map_pt": 2048, "n_map_ln": 512, "n_obs_pt": 1024,
                        "n_obs_ln": 256, "vocab_k": 128},
                "orb": {"nlevels": 2},
                "slam": {"max_kf_num_frames": 2, "max_iters_lba": 10}}


# the loop-closure distances of the port's small bench preset, scaled to
# the 8 keyframes of its 18-frame loop world
SMALL_LOOP = {"lc_kf_dist": 3, "lc_kf_max_dist": 2, "lc_nkf_closest": 1}


def small_cell(workload: str, n_frames: int, limits: dict | None = None,
               slam: dict | None = None, chunk: int = 4) -> registry.Cell:
    """``workload`` from BENCHMARK.json at the small rig and budgets with
    ``n_frames`` frames; ``limits`` replaces the numbers' limits, ``slam``
    adds settings of the engine's ``slam`` section."""
    cell = registry.load_cell(workload)
    traffic = dict(cell.traffic, world=dict(cell.traffic["world"], n_frames=n_frames))
    if "chunk" in traffic:
        traffic["chunk"] = chunk
    engine = dict(SMALL_ENGINE, slam=dict(SMALL_ENGINE["slam"], **(slam or {})))
    config = dict(cell.config, camera=SMALL_CAMERA, engine=engine)
    return registry.Cell(cell.name, cell.chips, config, traffic,
                         limits if limits is not None else cell.limits,
                         cell.end_to_end, cell.per_layer)


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="session")
def bench() -> dict:
    return json.loads(registry.BENCHMARK.read_text())
