"""BENCHMARK.json against the benchmark's rules: keys, names, units,
bounds, the run length's budget, and that every name finds its files."""

import json
import re

import pytest

from perfbench import drivers, harness

M = harness.load_manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def text_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(M["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in M["paths"])
    assert len(M["command"]) <= 32 and all(text_ok(w) for w in M["command"])
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M).encode()) <= 64 * 1024


def test_budget_fits_every_later_cell():
    """2 + 14 x 24 runs of run_seconds + 60, 2 x 90 a cell to compile and
    1,200 spare within 43,200 seconds."""
    cells = 24
    total = ((2 + 14 * cells) * (M["run_seconds"] + 60) + cells * 180
             + 1200)
    assert total <= 43200


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
])
def test_entries(section, keys):
    entries = M[section]
    assert 1 <= len(entries) <= 24
    names = [e["name"] for e in entries]
    assert len(set(names)) == len(names)
    for e in entries:
        assert set(e) == keys
        assert NAME.match(e["name"]) and text_ok(e["why"])


def test_configs_are_used_and_their_files_hold_them():
    used = {w["config"] for w in M["workloads"]}
    files = set()
    for c in M["configs"]:
        assert c["name"] in used
        assert text_ok(c["source"]) and c["source"].startswith("https://")
        assert c["file"].startswith(M["paths"][0] + "/")
        assert c["file"] not in files
        files.add(c["file"])
        body = json.loads((harness.ROOT / c["file"]).read_text())
        assert body["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        widths = re.compile(r"(_dim|_rank|hidden|intermediate|heads?)$")
        assert not any(widths.search(k) for k in c["reduced"])
        assert all(NAME.match(k) for k in c["reduced"])


def test_cells():
    pairs = {(w["config"], w["traffic"]) for w in M["workloads"]}
    assert len(pairs) == len(M["workloads"])
    fours = sum(w["chips"] == 4 for w in M["workloads"])
    assert fours <= max(1, len(M["workloads"]) // 4)
    for w in M["workloads"]:
        assert w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])


def test_metrics():
    names = [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(set(names)) == len(names)
    assert 1 <= len(M["end_to_end"]) <= 16
    assert 1 <= len(M["per_layer"]) <= 128
    e2e = {m["name"]: m for m in M["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and text_ok(m["layer"])
        assert m["moves"] in e2e
        if m["name"].split(".")[0].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in M["end_to_end"] + M["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")


def test_one_layer_one_name():
    """Metrics of one layer give it letter for letter: one name a
    module path."""
    by_module = {}
    for m in M["per_layer"]:
        key = m["layer"].split()[0]
        by_module.setdefault(key, set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_module.values())


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_every_cell_reports_enough(cell):
    """setup_s, one more end-to-end metric and one per-layer metric, each
    per-layer metric beside the end-to-end metric it moves, and a driver
    that keeps the drivers' contract (perfbench/drivers/__init__.py)."""
    c = harness.Cell(M, cell)
    e2e = {m["name"] for m in c.end_to_end()}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = c.per_layer()
    assert layers
    assert all(m["moves"] in e2e for m in layers)
    for m in layers:
        harness.metric_reader(m["name"])
    assert drivers.missing(c.driver()) == []
    assert set(c.limits) and all(v >= 0 for v in c.limits.values())


def test_mfu_beside_the_rooflines():
    """Where a kernel's roofline moves a metric, a step's mfu moves it
    too."""
    for m in M["per_layer"]:
        if "_roofline" in m["name"]:
            assert any("mfu" in o["name"] and o["moves"] == m["moves"]
                       for o in M["per_layer"])


def test_files_under_paths_are_named_from_names():
    for path in (harness.BENCH).rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(harness.ROOT).as_posix()
        assert PATH.match(rel), rel
