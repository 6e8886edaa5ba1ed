"""A run on a machine with no card exits non-zero and prints no result;
so does one from a directory that holds only the benchmark."""

import os
import shutil
import subprocess
import sys

from slam_bench import registry

ROOT = registry.HERE.parent


def _run(cwd):
    return subprocess.run(
        [sys.executable, "-m", "slam_bench.run", "--workload", "euroc-vo-replay",
         "--seed", "3000000019", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_no_card_no_result():
    out = _run(ROOT)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
    assert "needs 1 CUDA card" in out.stderr


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(registry.HERE, tmp_path / "slam_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and '"correct"' not in out.stdout
