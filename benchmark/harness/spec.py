"""Everything a run needs, found by name: ``BENCHMARK.json`` at the root of
the checkout names the cell's configuration and traffic mix, its
end-to-end and per-layer metrics; the files are

- ``benchmark/configs/<config>.json`` (the file ``BENCHMARK.json`` gives),
- ``benchmark/traffic/<traffic>.json``,
- ``benchmark/workloads/<cell>.json`` (mode, batch, sample, limits),
- ``benchmark/metrics/<metric>.py`` (one reader a per-layer metric).

A later cell, mix, configuration or metric is a new file and a new entry
in ``BENCHMARK.json``; nothing here names one.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
REPO = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    params: dict
    chips: int
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)

    @property
    def mode(self) -> str:
        return self.params["mode"]


def _load(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str, end_to_end: Optional[List[str]] = None) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads`` key
    lists, or without one every cell (a per-layer metric: every cell that
    reports the end-to-end metric it moves)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return end_to_end is None or metric["moves"] in end_to_end


def load_cell(name: str, bench: Optional[dict] = None, root: Path = REPO) -> Cell:
    bench = bench if bench is not None else _load(root / "BENCHMARK.json")
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: {sorted(by_name)}")
    w = by_name[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = _load(root / cfg_entry["file"])
    traffic = _load(root / "benchmark" / "traffic" / f"{w['traffic']}.json")
    params = _load(root / "benchmark" / "workloads" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if reports(m, name)]
    e2e_names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if reports(m, name, e2e_names)]
    return Cell(name, config, traffic, params, int(w["chips"]), e2e, per_layer)


def metric_reader_path(metric: str, root: Path = REPO) -> Path:
    return root / "benchmark" / "metrics" / f"{metric}.py"


def load_readers(names: List[str], root: Path = REPO) -> Dict[str, object]:
    """``name → read(run)`` from each metric's own file."""
    import importlib.util

    readers = {}
    for name in names:
        path = metric_reader_path(name, root)
        spec = importlib.util.spec_from_file_location(f"bench_metric_{len(readers)}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        readers[name] = module.read
    return readers
