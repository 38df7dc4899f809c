"""Finding a cell's parts by name, and what every run reports.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix. The
harness finds, under the benchmark's folder:

- ``configs/<config>.json`` (the file that ``BENCHMARK.json`` names): the
  front end's settings, the port's entries and the precision;
- ``traffic/<mix>.json``: the mix's parameters, whose ``loop`` names the
  general loop in ``loops/<loop>.py`` that runs it;
- ``limits/<cell>.json``: the limit of each number the check compares;
- ``metrics/<metric>.py``: one reader per metric, ``read(ctx)``, which
  returns a number or None;

and, by the configuration's name, its plain reference in
``reference/<config>.py`` and its least-work counts in ``work/<config>.py``.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path

from .work import counts

BASE = Path(__file__).resolve().parent
#: top-level module names that no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "nnaudio_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    config_name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @property
    def loop(self) -> str:
        return self.traffic["loop"]


def _applies(metric: dict, cell: str, reported: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves") in reported if "moves" in metric else True


def find_cell(bench: dict, name: str, root: Path, base: Path = BASE) -> Cell:
    """The cell ``name`` of ``bench`` with its files read; ``root`` is the
    checkout that ``BENCHMARK.json``'s paths are relative to."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _applies(m, name, reported)]
    return Cell(name=name, config_name=w["config"], chips=w["chips"], config=config,
                traffic=load_json(base / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(base / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=layer)


def loop_class(cell: Cell):
    return importlib.import_module(f"{__package__}.loops.{cell.loop}").Loop


def reference(cell: Cell):
    return importlib.import_module(f"{__package__}.reference.{cell.config_name}")


def work(cell: Cell):
    return importlib.import_module(f"{__package__}.work.{cell.config_name}")


def reader(metric: str, base: Path = BASE):
    """``metrics/<metric>.py``'s ``read``."""
    path = base / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"{__package__}.metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


@dataclass
class Context:
    """What a metric's reader reads: the cell, the window's counts, the
    traced stretch (None in a run without one) and the cell's least-work
    counts."""
    cell: Cell
    window: dict
    trace: object
    work: object

    @property
    def settings(self) -> dict:
        return {**self.cell.config["settings"], **self.cell.config.get("train", {})}

    def least_seconds(self, part: str, shapes) -> float | None:
        """The least time of ``part`` over calls of the counted shapes."""
        total = 0.0
        for shape, n in shapes.items():
            w = self.work.least(part, self.cell.loop, shape, self.settings)
            if w is None:
                return None
            total += n * counts.least_seconds(*w)
        return total


def forbidden_modules(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (by default those now
    loaded), each compared whole."""
    return sorted({m.split(".")[0] for m in (sys.modules if modules is None else modules)}
                  & set(FORBIDDEN))
