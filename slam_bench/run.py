"""Run one cell of the benchmark once and print its result.

    python3 -m slam_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``) names a deployment (``configs/``) and a
traffic mix (``traffic/``: the world, the driver, its settings). Set-up
renders the world from the seed, prepares the driver's inputs, builds or
finds the kernels, and drives one whole sequence as warm-up. The window
then replays whole sequences back to back, each through a fresh engine,
until ``--seconds`` have passed, and closes at the end of the sequence in
progress; every frame and every ``finish()`` in it counts. With
``--trace 1`` the first sequence of the window runs under the profiler
(which slows the host by about a third) and at least one untraced
sequence follows it; the host-clock per-layer metrics (each mapping
step's time, the keyframe frames' latency) are read from the untraced
sequences only, and the per-layer metrics are printed in place of the
end-to-end ones.

A rendered world is kept under ``build/slam_bench/worlds/``, named by a
hash of its spec, its camera, its seed and the generator's source, and
read from there by a later run of the same world.

After the window the numbers in ``limits/<cell>.json`` are compared with
the plain reference (``checks.py``). Standard error ends with each number
beside its limit; the last line of standard output is the result's JSON
object. Exits 2 without enough CUDA cards, and 3 if JAX or the JAX
package was loaded into this process.
"""

from __future__ import annotations

import argparse
import faulthandler
import gc
import hashlib
import json
import os
import sys
import time
from dataclasses import dataclass, field

_T_IMPORT = time.perf_counter()


def _process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


PROCESS_T0 = _T_IMPORT - _process_age_s()   # process start on the perf clock

from slam_bench import registry  # noqa: E402

CACHE = registry.HERE.parent / "build" / "slam_bench"
JAX_NAMES = {"jax", "jaxlib", "flax", "gfplslam_tpu"}


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port builds its own kernels under ``build/`` there already)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)


def log(*parts) -> None:
    print("[slam_bench]", *parts, file=sys.stderr, flush=True)


@dataclass
class Run:
    """Everything one run holds; drivers, checks and metric readers read it."""
    cell: registry.Cell
    seed: int
    device: object
    cfg: object = None
    world: object = None
    traffic: dict = None
    kind: str = "cpu"
    state: dict = field(default_factory=dict)   # the driver's prepared inputs
    kernels: object = None                       # taps.KernelTap
    ba: object = None                            # taps.CallTap on the local BA
    pgo: object = None                           # taps.CallTap on the pose graph
    seqs: list = field(default_factory=list)     # the window's sequences
    seconds: float = 0.0                         # the window's length
    setup_s: float = 0.0
    trace: object = None                         # trace.TraceSummary
    traced_seq: object = None
    kernel_shapes: list = field(default_factory=list)
    mapping_ms: list = None


def engine_config(config: dict):
    """The program's Config for a configuration file: its overrides of the
    engine's defaults and its camera."""
    from gfplslam_torch.config import CameraParams, load_config
    return load_config(config.get("engine", {})).replace(
        camera=CameraParams(**config["camera"]))


def load_world(spec: dict, cam, seed: int):
    """The world ``spec`` at ``cam`` and ``seed``: read from the cache of
    rendered worlds, or rendered and written there. Returns (the world,
    whether it was read)."""
    import numpy as np

    from slam_bench import synth
    key = hashlib.sha256(json.dumps([spec, list(cam), seed], sort_keys=True).encode()
                         + (registry.HERE / "synth.py").read_bytes()).hexdigest()[:32]
    path = CACHE / "worlds" / f"{key}.npz"
    if path.is_file():
        with np.load(path) as z:
            return synth.World(*(z[k] for k in synth.World._fields)), True
    world = synth.render_world(spec, cam, seed)
    path.parent.mkdir(parents=True, exist_ok=True)
    part = path.with_name(f"{key}.{os.getpid()}.part.npz")
    np.savez(part, **world._asdict())
    os.replace(part, path)
    return world, False


def _draw(rng, n: int, k: int) -> set:
    return set(int(i) for i in rng.choice(n, size=min(k, n), replace=False)) if n else set()


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: registry.Cell, seed: int, seconds: float, traced: bool,
             device, plant: str | None = None) -> tuple[Run, dict, dict]:
    """One run of ``cell``: set-up, window, comparison, metrics. Returns
    (the run, the numbers compared with their limits, the result object).
    ``plant`` installs a control or a fault of ``plants.py`` (never in the
    benchmark's own runs)."""
    import numpy as np
    import torch

    from slam_bench import checks, synth, taps, trace
    run = Run(cell=cell, seed=seed, device=device, traffic=cell.traffic)
    run.kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    cam = synth.Camera(**cell.config["camera"])
    world_seed = seed % 2 ** 64
    monitor = planted = mapping = None
    try:
        t = time.perf_counter()
        run.world, hit = load_world(cell.traffic["world"], cam, world_seed)
        parts = {"render_s": time.perf_counter() - t}
        log(f"world of {len(run.world.left)} frames "
            f"{'read from the cache' if hit else 'rendered and cached'} "
            f"in {parts['render_s']:.3f} s")
        t = time.perf_counter()
        run.cfg = engine_config(cell.config)
        driver = registry.module("drivers", cell.traffic["driver"])
        driver.prepare(run)
        parts["prepare_s"] = time.perf_counter() - t
        log(f"driver {cell.traffic['driver']} prepared in {parts['prepare_s']:.3f} s")
        t = time.perf_counter()
        if device.type == "cuda":
            from gfplslam_torch.ops import kernels
            kernels.load()
            how = ("nvcc" if kernels.build_seconds is not None else "cache hit")
        else:
            how = "nothing to build on the CPU"
        parts["kernels_s"] = time.perf_counter() - t
        log(f"kernels: {how} in {parts['kernels_s']:.3f} s")
        if plant:
            from slam_bench import plants
            planted = plants.install(plant)
            log(f"PLANT {plant} installed: this run is a control or a fault")
        run.kernels = taps.KernelTap((cam.height, cam.width))
        run.ba, run.pgo = taps.local_ba_tap(), taps.pose_graph_tap()
        t = time.perf_counter()
        run.kernels.begin_sequence()
        run.ba.begin_sequence()
        run.pgo.begin_sequence()
        warm = driver.sequence(run)
        _sync(device)
        parts["warmup_s"] = time.perf_counter() - t
        sample = cell.traffic["check_sample"]
        rng = np.random.default_rng([world_seed, 0x5EED])
        run.kernels.fast_pick = _draw(rng, warm.frames, sample["fast_frames"])
        run.kernels.ham_pick = _draw(rng, run.kernels.ham, sample["hamming_launches"])
        run.setup_s = time.perf_counter() - PROCESS_T0
        log(f"cell {cell.name}, seed {seed}, {run.kind}; set-up {run.setup_s:.3f} s: "
            + ", ".join(f"{k} {v:.3f}" for k, v in parts.items())
            + f" (kernels: {how}); warm-up sequence {warm.frames} frames, "
            f"{run.kernels.ham} Hamming launches, {run.ba.calls} local BAs")

        if device.type == "cuda":
            from slam_bench.smi import ClockMonitor
            monitor = ClockMonitor(device.index or 0)
        prof = None
        t0 = time.perf_counter()
        while True:
            first = not run.seqs
            run.kernels.begin_sequence(capture=first, shapes=traced and first)
            run.ba.begin_sequence(capture=first)
            run.pgo.begin_sequence(capture=first)
            if traced and first:
                seq, prof = trace.profiled(lambda: driver.sequence(run), device)
                seq.traced = True
                run.traced_seq, run.kernel_shapes = seq, run.kernels.shapes
                # the host-clock per-layer metrics: untraced sequences only
                mapping = taps.MappingTap()
            else:
                seq = driver.sequence(run)
                _sync(device)
            run.seqs.append(seq)
            # a traced window ends with at least one untraced sequence
            if time.perf_counter() - t0 >= seconds and (not traced or len(run.seqs) > 1):
                break
        run.seconds = time.perf_counter() - t0
        t1 = time.perf_counter()
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        if monitor is not None:
            log(f"window: {monitor.between(t0, t1)}")
            monitor.close()
            monitor = None
        for i, s in enumerate(run.seqs):
            log(f"sequence {i}: {s.frames} frames in {s.seconds:.4f} s, {sum(s.is_kf)} "
                f"keyframes, closures {s.closures}, failed {s.failed}")
        log(f"window {run.seconds:.4f} s, {len(run.seqs)} sequences, "
            f"{sum(s.frames for s in run.seqs)} frames")
        lat = [1e3 * x for s in run.seqs for x in (s.latency_s or [])]
        if lat:
            log(f"frame latency: {len(lat)} frames, median {np.median(lat):.4f} ms, "
                f"p90 {np.percentile(lat, 90):.4f} ms")
        if mapping is not None:
            run.mapping_ms = mapping.ms
        if prof is not None:
            t = time.perf_counter()
            run.trace = trace.summarize(prof)
            del prof
            log(f"trace of sequence 0: {run.trace.n_ops} device ops, busy "
                f"{run.trace.busy_s:.6f} s of {run.trace.window_s:.6f} s; read in "
                f"{time.perf_counter() - t:.1f} s")
        run.state.clear()
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

        t = time.perf_counter()
        ok, numbers = checks.compare(run, cell.limits)
        log(f"compared in {time.perf_counter() - t:.2f} s: {checks.drawn(run)}")
        for line in checks.readings(run):
            log(line)

        metrics = {}
        for m in (cell.per_layer if traced else cell.end_to_end):
            value = registry.module("metrics", m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev = {"platform": "gpu" if device.type == "cuda" else device.type,
               "kind": run.kind, "count": 1, "memory_peak_bytes": int(peak)}
        result = {"correct": bool(ok), "attempted": sum(s.frames for s in run.seqs),
                  "failed": sum(s.failed for s in run.seqs), "metrics": metrics,
                  "device": dev}
        if traced and run.trace is not None:
            dev["busy_s"] = run.trace.busy_s
            dev["window_s"] = run.trace.window_s
            result["breakdown"] = run.trace.breakdown()
        result["checks"] = numbers
        return run, numbers, result
    finally:
        for held in (monitor, mapping, run.pgo, run.ba, run.kernels, planted):
            if held is not None:
                held.close()


def jax_modules() -> set:
    return {name.split(".")[0] for name in list(sys.modules)} & JAX_NAMES


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    # a run that overstays prints where every thread is, and goes on
    faulthandler.dump_traceback_later(300)
    cell = registry.load_cell(args.workload)
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"slam_bench: cell {cell.name} needs {cell.chips} CUDA card(s); "
              f"this machine has {n}", file=sys.stderr)
        return 2
    run, numbers, result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                                    torch.device("cuda", 0))
    faulthandler.cancel_dump_traceback_later()
    found = jax_modules()
    if found:
        print(f"slam_bench: the process loaded {sorted(found)}; no result",
              file=sys.stderr)
        return 3
    for name, v in numbers.items():
        print(f"[slam_bench] check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
