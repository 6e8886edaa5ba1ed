"""The card's name, power limit, SM clock and power draw from
``nvidia-smi``: a copy of the port's ``apps/bench.py`` ``device_info`` and
``ClockMonitor`` (a background ``nvidia-smi`` sampling every 500 ms,
each sample stamped on the host clock)."""

from __future__ import annotations

import subprocess
import threading
import time

import numpy as np


def device_info(index: int = 0) -> dict:
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={index}"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip()
    name, limit = (x.strip() for x in smi.rsplit(",", 1))
    return {"name": name, "power_limit": limit}


class ClockMonitor:
    """SM clock (MHz) and power drawn (W) every 500 ms while open."""

    def __init__(self, index: int = 0):
        self.samples: list[tuple[float, float, float]] = []
        self._proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "500", f"--id={index}"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self) -> None:
        for line in self._proc.stdout:
            try:
                sm, watts = (float(x) for x in line.split(","))
            except ValueError:
                continue
            self.samples.append((time.perf_counter(), sm, watts))

    def between(self, t0: float, t1: float) -> str:
        got = [(sm, w) for t, sm, w in list(self.samples) if t0 <= t <= t1]
        if not got:
            return "no nvidia-smi sample"
        sm, w = np.asarray(got).T
        return (f"{len(got)} nvidia-smi samples: SM clock median {np.median(sm):.0f} "
                f"MHz (min {sm.min():.0f}, max {sm.max():.0f}), power median "
                f"{np.median(w):.2f} W (max {w.max():.2f})")

    def close(self) -> None:
        if self._proc is not None:
            self._proc.terminate()
            self._proc.wait(timeout=30)
            self._reader.join(timeout=30)
            self._proc = None
