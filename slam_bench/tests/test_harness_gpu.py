"""On the card: the control (the reference's FAST-9 in float8 in the
kernel's place) is not correct at the VO cell's own size, and a sound run
of the same seed is. Skips without a card."""

import pytest

from slam_bench import registry
from slam_bench.run import run_cell


@pytest.mark.gpu
@pytest.mark.parametrize("plant", [None, "control"])
def test_control_on_the_card(cuda_device, plant):
    cell = registry.load_cell("euroc-vo-replay")
    _, numbers, result = run_cell(cell, 4000000007, 0.0, False, cuda_device, plant=plant)
    assert result["correct"] == (plant is None), numbers
