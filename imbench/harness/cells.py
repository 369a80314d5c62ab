"""A cell by its name: its entry in ``BENCHMARK.json`` and the files of its
own that the harness finds by name, so that a later cell, configuration,
traffic mix or metric is a new file and never an edit:

* ``configs/<config>.json``: the graph, the diffusion model and J;
* ``traffic/<traffic>.json``: the job mix, read by the generator of its
  ``kind`` (``traffic/<kind>.py``);
* ``workloads/<cell>.json``: what the comparison with the reference holds
  the cell's jobs to (the sweep counts it compares, each number's limit);
* ``metrics/<metric>.py``: the reader of a metric.
"""
from __future__ import annotations

import dataclasses
import importlib
import json
from pathlib import Path
from typing import List

#: the benchmark's folder; its data files are found under ``data_dir``, which
#: the tests point elsewhere
HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    end_to_end: List[dict]
    per_layer: List[dict]

    def generator(self):
        """The traffic kind's module (``traffic/<kind>.py``)."""
        return importlib.import_module(f"imbench.traffic.{self.traffic['kind']}")


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return _read(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(bench: dict, name: str, data_dir: Path = HERE) -> Cell:
    """The cell ``name`` of ``bench``; raises ``KeyError`` for an unknown one."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are "
                       f"{[w['name'] for w in bench['workloads']]}")
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name) and m["moves"] in moved]
    return Cell(name=name, chips=int(entry["chips"]),
                config=_read(data_dir / "configs" / f"{entry['config']}.json"),
                traffic=_read(data_dir / "traffic" / f"{entry['traffic']}.json"),
                check=_read(data_dir / "workloads" / f"{name}.json")["check"],
                end_to_end=e2e, per_layer=per_layer)


def metric_reader(name: str):
    """The ``read(window)`` function of metric ``name``."""
    return importlib.import_module(f"imbench.metrics.{name}").read
