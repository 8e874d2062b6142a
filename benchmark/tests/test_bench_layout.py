"""BENCHMARK.json against the benchmark's contract, and the harness finding
a new configuration, mix, cell and metric by name, as new files only."""

import json
import re
import shutil

import pytest

from conftest import BENCH, REPO, TINY_TRAFFIC, load_json
from harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return load_json(REPO / "BENCHMARK.json")


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "benchmark/run.py"]
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    assert len(json.dumps(bench)) <= 64 * 1024


def test_names_units_and_sources(bench):
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


def test_every_cell_has_its_files_and_metrics(bench):
    used = set()
    for w in bench["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        cell = spec.load_cell(w["name"], bench)
        used.add(w["config"])
        e2e = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer, w["name"]
        for m in cell.per_layer:
            assert m["moves"] in e2e
            assert spec.metric_reader_path(m["name"]).exists()
        assert cell.mode in ("score", "train")
        assert sum(k["count"] for k in cell.traffic["kinds"]) >= 16  # the pool's batches
    assert used == {c["name"] for c in bench["configs"]}
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files)) and all(f.startswith("benchmark/") for f in files)


def test_no_file_is_left_unused(bench):
    """Every workload, traffic and metric file belongs to an entry of
    BENCHMARK.json: a cell left out takes its files with it."""
    cells = {w["name"] for w in bench["workloads"]}
    mixes = {w["traffic"] for w in bench["workloads"]}
    metrics = {m["name"] for m in bench["per_layer"]}
    assert {p.stem for p in (BENCH / "workloads").glob("*.json")} == cells
    assert {p.stem for p in (BENCH / "traffic").glob("*.json")} == mixes
    assert {p.name[:-3] for p in (BENCH / "metrics").glob("*.py")} == metrics


def test_a_new_cell_is_new_files_only(tmp_path, bench):
    """A configuration, a mix, a cell and a per-layer metric added as new
    files and new entries are found by name; no file of the harness
    changes."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    new = json.loads(json.dumps(bench))
    cfg = load_json(BENCH / "configs" / "conformer_flagship.json")
    cfg["task"]["n_blocks"] = 16
    (root / "benchmark" / "configs" / "conformer_deeper.json").write_text(json.dumps(cfg))
    (root / "benchmark" / "traffic" / "short.json").write_text(json.dumps(TINY_TRAFFIC))
    (root / "benchmark" / "workloads" / "conformer_deeper.score_short.json").write_text(
        json.dumps({"mode": "score", "batch": 16, "sample_per_kind": 1,
                    "limits": {"lp_err": 1.0}}))
    (root / "benchmark" / "metrics" / "batches.score.py").write_text(
        "def read(run):\n    return float(run.window.batches)\n")
    new["configs"].append({"name": "conformer_deeper", "source": "x",
                           "file": "benchmark/configs/conformer_deeper.json",
                           "reduced": [], "why": "x"})
    new["workloads"].append({"name": "conformer_deeper.score_short", "chips": 1, "why": "x",
                             "config": "conformer_deeper", "traffic": "short"})
    new["per_layer"].append({"name": "batches.score", "unit": "1", "better": "higher",
                             "source": "host_clock", "layer": "task", "moves": "score_utt_per_s",
                             "workloads": ["conformer_deeper.score_short"]})
    for m in new["end_to_end"]:
        if m["name"].startswith("score_"):
            m["workloads"].append("conformer_deeper.score_short")
    (root / "BENCHMARK.json").write_text(json.dumps(new))

    cell = spec.load_cell("conformer_deeper.score_short", root=root)
    assert cell.config["task"]["n_blocks"] == 16
    assert len(cell.traffic["kinds"]) == 2
    assert cell.params["batch"] == 16
    assert [m["name"] for m in cell.per_layer] == ["batches.score"]
    read = spec.load_readers(["batches.score"], root=root)["batches.score"]

    class Run:
        class window:
            batches = 7
    assert read(Run) == 7.0
