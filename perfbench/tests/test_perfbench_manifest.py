"""The benchmark's manifest and its files, found by name (CPU only)."""

import importlib
import json
import re
import shutil
from pathlib import Path

import pytest

from perfbench import harness

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def _cells_of(metric):
    return metric.get("workloads", [w["name"] for w in MAN["workloads"]])


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= MAN["run_seconds"] <= 51
    assert all(not p.startswith("/") and ".." not in p for p in MAN["paths"])
    assert len(json.dumps(MAN)) < 64 * 1024


@pytest.mark.parametrize("entry", MAN["configs"] + MAN["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_and_texts(entry):
    assert NAME.match(entry["name"])
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200
            assert "\n" not in entry[key] and "\t" not in entry[key]
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert set(_cells_of(metric)) <= {w["name"] for w in MAN["workloads"]}
    if metric in MAN["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
    reader = importlib.import_module(f"perfbench.metrics.{metric['name']}")
    assert callable(reader.read)
    if metric["name"].endswith("_roofline"):
        assert metric["unit"] == "%"


def test_names_unique():
    for group in (MAN["configs"], MAN["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


@pytest.mark.parametrize("metric", MAN["per_layer"], ids=lambda m: m["name"])
def test_moves_is_reported_where_listed(metric):
    """The end-to-end metric a per-layer metric moves exists in every cell
    that lists the per-layer metric."""
    moved = next(m for m in MAN["end_to_end"] if m["name"] == metric["moves"])
    assert set(_cells_of(metric)) <= set(_cells_of(moved))


@pytest.mark.parametrize("cell", MAN["workloads"], ids=lambda w: w["name"])
def test_every_cell_is_whole(cell):
    """Each cell's files are found by name, and it reports ``setup_s``, one
    more end-to-end metric and one per-layer metric."""
    loaded = harness.load_cell(cell["name"])
    names = {m["name"] for m in loaded["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert loaded["per_layer"]
    assert cell["chips"] in (1, 4)
    assert set(loaded["limits"]) >= {"loss1_gap", "delta1_gap", "deltaR_gap"}
    conf = next(c for c in MAN["configs"] if c["name"] == cell["config"])
    assert conf["file"].startswith(tuple(p + "/" for p in MAN["paths"]))


def test_configs_used_and_files_distinct():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))


def test_a_new_cell_is_found_by_name(tmp_path):
    """A traffic mix, its cell and its limits added as new files and
    entries are found with no edit to the harness."""
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    man = json.loads(json.dumps(MAN))
    base = man["workloads"][0]
    new = dict(base, name=base["config"] + ".u99.test", traffic="u99.test")
    man["workloads"].append(new)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    traffic = json.loads((ROOT / "perfbench" / "traffic" /
                          f"{base['traffic']}.json").read_text())
    traffic["cohort"] = 99
    (tmp_path / "perfbench" / "traffic" / "u99.test.json").write_text(
        json.dumps(traffic))
    (tmp_path / "perfbench" / "limits" / f"{new['name']}.json").write_text(
        json.dumps({"loss1_gap": 1, "delta1_gap": 1, "deltaR_gap": 1}))
    cell = harness.load_cell(new["name"], root=tmp_path)
    assert cell["traffic"]["cohort"] == 99
    assert cell["workload"]["name"] == new["name"]
    assert {m["name"] for m in cell["end_to_end"]} >= {"setup_s"}
