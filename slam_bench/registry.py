"""Finds everything a cell is made of by name, from files alone.

``BENCHMARK.json`` (at the root of the checkout) names the cells, their
configuration and traffic, and the metrics. Each name resolves to a file
under this folder, so a later change adds a configuration, a traffic mix,
a driver, a limit set or a metric by adding a file and an entry, and edits
nothing that is here:

- ``configs/<config>.json``: the deployment (camera, overrides of the
  engine's defaults, source, ``reduced``, ``assumed``);
- ``traffic/<traffic>.json``: the world, the driver and its settings;
- ``drivers/<driver>.py``: ``prepare(run)`` and ``sequence(run)``;
- ``limits/<workload>.json``: the numbers ``correct`` compares, each with
  its limit;
- ``metrics/<metric>.py``: ``read(run)``, the value or ``None``.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent
BENCHMARK = HERE.parent / "BENCHMARK.json"
KINDS = {"configs": ".json", "traffic": ".json", "limits": ".json",
         "drivers": ".py", "metrics": ".py"}


def names(kind: str, root: Path = HERE) -> list[str]:
    """The names of every file of ``kind`` under ``root``."""
    suffix = KINDS[kind]
    return sorted(p.name[:-len(suffix)] for p in (root / kind).glob(f"*{suffix}")
                  if not p.name.startswith("_"))


def path(kind: str, name: str, root: Path = HERE) -> Path:
    p = root / kind / f"{name}{KINDS[kind]}"
    if not p.is_file():
        raise FileNotFoundError(f"no {kind[:-1] if kind != 'traffic' else kind} "
                                f"named {name!r} (looked for {p})")
    return p


def data(kind: str, name: str, root: Path = HERE) -> dict:
    return json.loads(path(kind, name, root).read_text())


def module(kind: str, name: str, root: Path = HERE) -> ModuleType:
    """A driver or a metric reader, loaded from its file (its name may hold
    dots, so it is loaded by path and not imported as a package member)."""
    p = path(kind, name, root)
    spec = importlib.util.spec_from_file_location(f"slam_bench.{kind}.{name}", p)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass(frozen=True)
class Cell:
    """One entry of ``workloads`` with everything it names resolved."""
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: tuple   # the BENCHMARK.json entries this cell reports
    per_layer: tuple


def _reported(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def load_cell(workload: str, bench: dict | None = None, root: Path = HERE) -> Cell:
    """The cell named ``workload`` in ``bench`` (default: BENCHMARK.json)."""
    bench = bench if bench is not None else json.loads(BENCHMARK.read_text())
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise KeyError(f"no workload {workload!r}; BENCHMARK.json has "
                       f"{sorted(by_name)}")
    w = by_name[workload]
    return Cell(name=workload, chips=int(w["chips"]),
                config=data("configs", w["config"], root),
                traffic=data("traffic", w["traffic"], root),
                limits=data("limits", workload, root),
                end_to_end=tuple(m for m in bench["end_to_end"] if _reported(m, workload)),
                per_layer=tuple(m for m in bench["per_layer"] if _reported(m, workload)))
