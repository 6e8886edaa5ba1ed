#!/usr/bin/env python3
"""Device time of the port's hand-written kernels on one CUDA card, beside
those of another checkout.

    python3 profile_torch_kernels.py [--baseline DIR] [--rounds 2] [--out FILE]

Builds the kernels of this checkout and, with ``--baseline``, the kernels
under ``DIR/gfplslam_torch/csrc`` (for example a ``git archive`` of the
parent commit unpacked under ``build/``). Checks the baseline library
bit-exact against the plain PyTorch versions at the main-path inputs (this
checkout's kernels are checked by ``chip_smoke.py``), then times one
full-width frame's launches of each kernel with
``gfplslam_torch/utils/kernel_bench.py`` (CUDA graph over buffers that
exceed the L2 cache) in turns: baseline, this, this, baseline, once per
round. Prints each library's ``ptxas`` report, the
device time per frame of each kernel with its bound and share of bound, and
writes the same as JSON to ``FILE`` (default
``build/profile_torch_kernels.json``). Needs a CUDA card; imports no JAX.
"""

from __future__ import annotations

import argparse
import functools
import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent


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
    from gfplslam_torch.utils import kernel_bench as kb
    from gfplslam_torch.ops.fast import fast_score_map_torch
    from gfplslam_torch.ops.hamming import hamming_matrix_torch

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
        libs[label] = kernels.load(csrc)
        for source, report in kernels.ptxas_report(csrc).items():
            for line in report.splitlines():
                if "Used" in line or "stack frame" in line:
                    print(f"[ptxas] {label} {source}: {line.strip()}")

    main_fast = kb.fast_main_inputs(dev)
    main_ham = kb.hamming_main_inputs(dev, np.random.default_rng(2024))
    thr = torch.tensor([kb.MAIN_THRESHOLD], device=dev)
    if "baseline" in libs:
        lib = libs["baseline"]
        for x in main_fast.values():
            out = torch.empty_like(x)
            kernels.check(lib.gfpl_fast_score(
                x.data_ptr(), out.data_ptr(), *x.shape, thr.data_ptr(),
                kernels.stream_ptr(dev)), "gfpl_fast_score")
            if not torch.equal(out, fast_score_map_torch(x, thr)):
                sys.exit(f"baseline FAST != plain at {list(x.shape)}")
        for a, b, va, vb in main_ham.values():
            out = torch.empty((a.shape[0], b.shape[0]), dtype=torch.int32,
                              device=dev)
            kernels.check(lib.gfpl_hamming(
                a.data_ptr(), b.data_ptr(), va.data_ptr(), vb.data_ptr(),
                out.data_ptr(), a.shape[0], b.shape[0], kernels.stream_ptr(dev)),
                "gfpl_hamming")
            if not torch.equal(out, hamming_matrix_torch(a, b, va, vb)):
                sys.exit(f"baseline Hamming != plain at {a.shape[0]}")
        print("[exact] baseline: both kernels == plain at the main-path inputs")

    order = (["baseline", "this", "this", "baseline"] if "baseline" in libs
             else ["this", "this"])
    samples = {label: {"fast9_score": [], "hamming_matrix": []} for label in libs}
    for rnd in range(args.rounds):
        for label in order:
            f_ms = kb.fast_device_ms(libs[label], main_fast, thr)
            h_ms = kb.hamming_device_ms(libs[label], main_ham)
            samples[label]["fast9_score"].append(f_ms)
            samples[label]["hamming_matrix"].append(h_ms)
            print(f"[turn] round {rnd} {label}: FAST {f_ms:.5f} ms, Hamming "
                  f"{h_ms:.5f} ms per frame")
    floors = measure_floors(dev, main_fast, main_ham)
    bounds = {"fast9_score": kb.fast_bound(main_fast),
              "hamming_matrix": kb.hamming_bound(main_ham)}
    summary = {}
    for label, kern in samples.items():
        for name, times in kern.items():
            med = statistics.median(times)
            bound_ms, by = bounds[name]
            summary[f"{label} {name}"] = {"device_ms": med, "samples": times,
                                          "bound_ms": bound_ms, "bound_by": by,
                                          "share_of_bound": bound_ms / med}
            print(f"[summary] {label} {name}: device {med:.5f} ms per frame "
                  f"(median of {len(times)}), bound {bound_ms:.5f} ms ({by}), "
                  f"share {bound_ms / med:.3f}")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"device": torch.cuda.get_device_name(0),
                                    "nvidia_smi": smi, "kernels": summary,
                                    "floors": floors}, indent=1))


def measure_floors(dev, main_fast: dict, main_ham: dict) -> dict:
    """What the card's own kernels take for each kernel's unavoidable part,
    timed like the kernels (CUDA graph over rotating buffers): one
    ``Tensor.copy_`` per FAST launch (the same bytes read and written), one
    ``Tensor.fill_`` per Hamming launch (the same matrix written), and a
    one-element ``zero_`` (a launch that does nothing)."""
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
