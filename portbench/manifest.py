"""Finds everything a run needs by the names in ``BENCHMARK.json``.

- a cell: its entry under ``workloads`` and ``portbench/workloads/<cell>.json``
  (its configuration, traffic mix, ``why``, check settings and limits);
- a configuration: the ``file`` its entry under ``configs`` names;
- a traffic mix: ``portbench/traffic/<mix>.json``, whose ``kind`` names the
  code that draws and drives it, ``portbench/traffic/<kind>.py``;
- a per-layer metric: its reader, ``portbench/metrics/<metric>.py``.

So a later change adds a cell, configuration, mix, kind or metric by adding
files and entries, and edits none.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
from types import ModuleType
from typing import Callable, Dict, List

ROOT = pathlib.Path(__file__).resolve().parent.parent
BENCH = "portbench"


def load(root: pathlib.Path = ROOT) -> Dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _one(entries: List[Dict], name: str, what: str) -> Dict:
    hits = [e for e in entries if e["name"] == name]
    if len(hits) != 1:
        raise KeyError(f"BENCHMARK.json has no single {what} {name!r}")
    return hits[0]


def cell(root: pathlib.Path, bench: Dict, name: str) -> Dict:
    """Everything one cell is: its manifest entry, its own file, its
    configuration and its traffic mix."""
    entry = _one(bench["workloads"], name, "workload")
    spec = json.loads((root / BENCH / "workloads" / f"{name}.json")
                      .read_text())
    for key in ("config", "traffic"):
        if spec[key] != entry[key]:
            raise ValueError(f"{name}: {key} is {entry[key]!r} in "
                             f"BENCHMARK.json but {spec[key]!r} in its file")
    cfg_entry = _one(bench["configs"], entry["config"], "config")
    config = json.loads((root / cfg_entry["file"]).read_text())
    mix = json.loads((root / BENCH / "traffic" / f"{entry['traffic']}.json")
                     .read_text())
    return {"name": name, "chips": entry["chips"], "entry": entry,
            "spec": spec, "config": config, "mix": mix}


def _load_file(path: pathlib.Path, label: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(label, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kind_module(root: pathlib.Path, kind: str) -> ModuleType:
    """The code of a traffic kind: a module with a ``Run`` class."""
    return _load_file(root / BENCH / "traffic" / f"{kind}.py",
                      f"portbench_kind_{kind}")


def reader(root: pathlib.Path, metric: str) -> Callable:
    """A per-layer metric's reader: ``read(ctx) -> float | None``."""
    label = "portbench_metric_" + metric.replace(".", "_").replace("-", "_")
    return _load_file(root / BENCH / "metrics" / f"{metric}.py",
                      label).read


def metrics_of(bench: Dict, cell_name: str, section: str) -> List[Dict]:
    """The metrics of ``section`` ("end_to_end" or "per_layer") that
    ``cell_name`` reports: those that list it, and those that list no
    cells."""
    return [m for m in bench[section]
            if "workloads" not in m or cell_name in m["workloads"]]
