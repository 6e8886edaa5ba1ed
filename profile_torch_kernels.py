#!/usr/bin/env python3
"""Device time of the port's hand-written kernels on one CUDA card, beside
those of another checkout.

    python3 profile_torch_kernels.py [--baseline DIR] [--rounds 2] [--out FILE]

Builds the kernels of this checkout and, with ``--baseline``, the kernels
under ``DIR/gfplslam_torch/csrc`` (for example a ``git archive`` of the
parent commit unpacked under ``build/``); a baseline Hamming library with
the earlier one-matrix entry point (``gfpl_hamming(a, b, valid_a, valid_b,
out, n, m, stream)``, a CUDA-core design) is bound as such. Checks the baseline library
bit-exact against the plain PyTorch versions at the main-path inputs (this
checkout's kernels are checked by ``chip_smoke.py``), measures the card's
popcount issue rates (binary tensor cores and ``__popc``), then times with
``gfplslam_torch/utils/kernel_bench.py`` (CUDA graph over buffers that
exceed the L2 cache), in turns (baseline, this, this, baseline), once per
round:

- FAST per full-width EuRoC frame;
- Hamming per tracked frame (this checkout: the stereo and the cross-frame
  pair, one launch each; the one-matrix API: four launches), per SLAM keyframe (the
  six back-end shapes, one launch each) and per ``train_vocab`` block
  ([8192, 4096], one launch).

Prints each library's ``ptxas`` report, the rates, each time with its
bytes and operations bounds and share of bound, the floors (``Tensor.copy_``
of FAST's bytes, ``Tensor.fill_`` of the frame's Hamming matrices, an empty
launch), and writes the same as JSON to ``FILE`` (default
``build/profile_torch_kernels.json``). Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
_P, _I = ctypes.c_void_p, ctypes.c_int


def _one_matrix_hamming(csrc: Path):
    """The one-matrix entry point of a baseline checkout's library, or None
    where that library has the problem-table API."""
    from gfplslam_torch.ops import kernels
    lib = ctypes.CDLL(str(kernels.build(csrc)["hamming.cu"]))
    if hasattr(lib, "gfpl_hamming_rate"):
        return None
    fn = lib.gfpl_hamming
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _P]
    fn.restype = _I
    return fn


def _one_matrix_launch_list(fn, a, b, va, vb):
    """Raw launches of the one-matrix entry point over rotating output
    buffers."""
    import torch
    from gfplslam_torch.ops import kernels
    from gfplslam_torch.utils import kernel_bench as kb
    n, m = a.shape[0], b.shape[0]
    copies, count = kb.rotation(4.0 * n * m)
    outs = [torch.empty((n, m), dtype=torch.int32, device=a.device)
            for _ in range(copies)]
    pa, pb = (None if v is None else v.data_ptr() for v in (va, vb))

    def launch(out):
        kernels.check(fn(a.data_ptr(), b.data_ptr(), pa, pb, out.data_ptr(), n, m,
                         kernels.stream_ptr(a.device)), "gfpl_hamming")
    return [functools.partial(launch, outs[i % copies]) for i in range(count)]


class Hamming:
    """Device time of one library's Hamming work per frame, keyframe and
    block: through the problem-table API, or the one-matrix entry point
    ``one``."""

    def __init__(self, lib, one=None):
        self.lib, self.one = lib, one

    def launch_list(self, problems: list) -> list:
        """One launch for all of ``problems`` (the one-matrix API: one)."""
        from gfplslam_torch.utils import kernel_bench as kb
        if self.one is not None:
            (a, b, va, vb), = problems
            return _one_matrix_launch_list(self.one, a, b, va, vb)
        return kb.hamming_launch_list(self.lib, problems)

    def times(self, sets: dict) -> dict:
        from gfplslam_torch.utils import kernel_bench as kb
        frame = list(sets["frame"].values())
        frame_ms = (sum(kb.graph_ms(self.launch_list([p])) for p in frame)
                    if self.one is not None else kb.graph_ms(self.launch_list(frame)))
        return {"frame": 2 * frame_ms} | {
            where: sum(kb.graph_ms(self.launch_list([p])) for p in sets[where].values())
            for where in ("keyframe", "block")}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, default=None)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", type=Path,
                    default=HERE / "build" / "profile_torch_kernels.json")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_kernels: needs a CUDA card", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, str(HERE))
    from gfplslam_torch.ops import kernels
    from gfplslam_torch.ops.fast import fast_score_map_torch
    from gfplslam_torch.ops.hamming import hamming_matrix_torch
    from gfplslam_torch.utils import kernel_bench as kb

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[device] {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    csrcs = {"this": kernels.CSRC}
    if args.baseline is not None:
        csrcs["baseline"] = args.baseline.resolve() / "gfplslam_torch" / "csrc"
    libs = {}
    for label, csrc in csrcs.items():
        if label == "this":
            libs[label] = kernels.load(csrc)
        else:  # FAST's entry point has not changed
            fast_lib = ctypes.CDLL(str(kernels.build(csrc)["fast_score.cu"]))
            fast_lib.gfpl_fast_score.argtypes = list(
                kernels.KERNELS["fast_score.cu"]["gfpl_fast_score"])
            fast_lib.gfpl_fast_score.restype = _I
            libs[label] = fast_lib
        for source, report in kernels.ptxas_report(csrc).items():
            for line in report.splitlines():
                if "Used" in line or "stack frame" in line:
                    print(f"[ptxas] {label} {source}: {line.strip()}")

    rng = np.random.default_rng(2024)
    main_fast = kb.fast_main_inputs(dev)
    sets = {"frame": kb.hamming_main_inputs(dev, rng),
            "keyframe": kb.hamming_keyframe_inputs(dev, rng),
            "block": kb.hamming_block_inputs(dev, rng)}
    thr = torch.tensor([kb.MAIN_THRESHOLD], device=dev)
    designs = {"this": Hamming(libs["this"])}
    if "baseline" in libs:
        lib = libs["baseline"]
        one = _one_matrix_hamming(csrcs["baseline"])
        designs["baseline"] = Hamming(
            kernels.load(csrcs["baseline"]) if one is None else None, one)
        for x in main_fast.values():
            out = torch.empty_like(x)
            kernels.check(lib.gfpl_fast_score(
                x.data_ptr(), out.data_ptr(), *x.shape, thr.data_ptr(),
                kernels.stream_ptr(dev)), "gfpl_fast_score")
            if not torch.equal(out, fast_score_map_torch(x, thr)):
                sys.exit(f"baseline FAST != plain at {list(x.shape)}")
        for group in sets.values():
            for problem in group.values():
                launch = designs["baseline"].launch_list([problem])[0]
                launch()
                out = launch.args[-1]
                out = out[0] if isinstance(out, list) else out
                if not torch.equal(out, hamming_matrix_torch(*problem)):
                    sys.exit(f"baseline Hamming != plain at "
                             f"{problem[0].shape[0]}x{problem[1].shape[0]}")
        print("[exact] baseline: FAST and Hamming == plain at the frame's, "
              "keyframe's and block's inputs")

    rates = kb.hamming_rates(libs["this"], dev)
    print(f"[rates] binary tensor cores: {rates['bmma_per_s']:.6e} m16n8k256 "
          f".and.popc products/s = {kb.ENTRIES_PER_BMMA * rates['bmma_per_s']:.6e} "
          f"256-bit entries/s; CUDA cores: {rates['popc_per_s']:.6e} __popc/s = "
          f"{rates['popc_per_s'] / 8:.6e} entries/s at 8 per entry; device "
          f"{torch.cuda.get_device_name(0)} ({smi})")

    order = (["baseline", "this", "this", "baseline"] if "baseline" in designs
             else ["this", "this"])
    samples = {n: {"frame": [], "keyframe": [], "block": []} for n in designs}
    fast_samples = {"baseline": [], "this": []}
    for rnd in range(args.rounds):
        for name in order:
            t = designs[name].times(sets)
            for k, v in t.items():
                samples[name][k].append(v)
            f_ms = kb.fast_device_ms(libs[name], main_fast, thr)
            fast_samples[name].append(f_ms)
            print(f"[turn] round {rnd} {name}: Hamming {t['frame']:.5f} ms per "
                  f"frame, {t['keyframe']:.5f} per keyframe, {t['block']:.5f} per "
                  f"block; FAST {f_ms:.5f} ms per frame")
    floors = measure_floors(dev, main_fast, sets["frame"])
    bounds = {"frame": kb.hamming_bound(sets["frame"], rates, repeat=2),
              "keyframe": kb.hamming_bound(sets["keyframe"], rates),
              "block": kb.hamming_bound(sets["block"], rates)}
    summary = {}
    for name, per in samples.items():
        for where, times in per.items():
            med = statistics.median(times)
            b = bounds[where]
            summary[f"{name} hamming per {where}"] = dict(
                b, device_ms=med, samples=times, share_of_bound=b["bound_ms"] / med)
            print(f"[summary] {name} Hamming per {where}: device {med:.5f} ms "
                  f"(median of {len(times)}), bytes {b['bytes_ms']:.5f} ms, "
                  f"operations {b['ops_ms']:.5f} ms, share of bound "
                  f"{b['bound_ms'] / med:.3f} ({b['bound_by']})")
    fast_bound_ms, fast_by = kb.fast_bound(main_fast)
    for label, times in fast_samples.items():
        if times:
            med = statistics.median(times)
            summary[f"{label} fast9_score per frame"] = {
                "device_ms": med, "samples": times, "bound_ms": fast_bound_ms,
                "bound_by": fast_by, "share_of_bound": fast_bound_ms / med}
            print(f"[summary] {label} FAST per frame: device {med:.5f} ms, bound "
                  f"{fast_bound_ms:.5f} ms ({fast_by}), share "
                  f"{fast_bound_ms / med:.3f}")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"device": torch.cuda.get_device_name(0),
                                    "nvidia_smi": smi, "rates": rates,
                                    "kernels": summary, "floors": floors}, indent=1))


def measure_floors(dev, main_fast: dict, main_ham: dict) -> dict:
    """What the card's own kernels take for each kernel's unavoidable part,
    timed like the kernels (CUDA graph over rotating buffers): one
    ``Tensor.copy_`` per FAST launch (the same bytes read and written), one
    ``Tensor.fill_`` per matrix of a tracked frame (the same four matrices
    written), and a one-element ``zero_`` (a launch that does nothing)."""
    import torch
    from gfplslam_torch.ops.hamming import BIG
    from gfplslam_torch.utils import kernel_bench as kb

    def rotate(make, bytes_per_launch):
        copies, n = kb.rotation(bytes_per_launch)
        bufs = [make() for _ in range(copies)]
        return [functools.partial(*bufs[i % copies]) for i in range(n)]

    fast_ms = sum(kb.graph_ms(rotate(
        lambda: (torch.Tensor.copy_, torch.empty_like(x), x.clone()),
        8.0 * x.numel())) for x in main_fast.values())
    ham_ms = 2 * sum(kb.graph_ms(rotate(
        lambda: (torch.Tensor.fill_, torch.empty((n, n), dtype=torch.int32,
                                                 device=dev), BIG),
        4.0 * n * n)) for n in main_ham)
    tiny = torch.zeros(1, device=dev)
    launch_ms = kb.graph_ms([tiny.zero_] * 200)
    print(f"[floor] FAST bytes by Tensor.copy_: {fast_ms:.5f} ms per frame (2 "
          f"launches); Hamming matrices by Tensor.fill_: {ham_ms:.5f} ms per "
          f"frame (4 launches); empty launch: {launch_ms:.5f} ms")
    return {"fast_copy_ms": fast_ms, "hamming_fill_ms": ham_ms,
            "empty_launch_ms": launch_ms}


if __name__ == "__main__":
    main()
