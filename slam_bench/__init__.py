"""The benchmark of the port (``gfplslam_torch``) on one NVIDIA H100.

    python3 -m slam_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>
    python3 -m slam_bench.control --workload <cell> --plant <name> --seeds a,b,c
    python3 -m pytest slam_bench/tests            # CPU; -m gpu on a card

``BENCHMARK.json`` at the root of the checkout names the cells; every
configuration, traffic mix, driver, limit set and metric is a file of its
own here, found by name (``registry.py``). Nothing here imports JAX or the
JAX package; the reference (``reference.py``) imports nothing of the
program either.
"""
