"""CPU tests of the benchmark harness (``python -m pytest slam_bench/tests``);
tests marked ``gpu`` skip without a CUDA card."""
