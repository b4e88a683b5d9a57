"""A cell and a metric are found by name, and a later one can be added as
new files and manifest entries alone."""

import json
import shutil

import pytest

from perfbench import harness


def test_cell_finds_its_parts():
    cell = harness.Cell(harness.load_manifest(), "n5000-serve-c4")
    assert cell.config["particles"] == 5000
    assert cell.traffic["driver"] == "closed_loop"
    assert cell.driver().__name__ == "perfbench.drivers.closed_loop"
    assert "pos_gap" in cell.limits
    names = {m["name"] for m in cell.per_layer()}
    assert "dispatch_fill.largen" in names and "mfu.train" not in names


def test_unknown_names_refused():
    m = harness.load_manifest()
    with pytest.raises(harness.BenchError):
        harness.Cell(m, "no-such-cell")
    with pytest.raises(harness.BenchError):
        harness.metric_reader("no_such.metric")


def test_missing_manifest(tmp_path):
    with pytest.raises(harness.BenchError):
        harness.load_manifest(tmp_path / "BENCHMARK.json")


def test_a_cell_added_as_new_files_only(tmp_path):
    """In a copy: a new traffic mix, its cell's limits and a new metric's
    reader, and the manifest's new entries; no file already there edited."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = harness.load_manifest()
    before = {p.relative_to(root): p.read_bytes()
              for p in (root / "perfbench").rglob("*") if p.is_file()}
    mix = json.loads((root / "perfbench/workloads/serve_open_394.json")
                     .read_text())
    mix.update(rate_per_s=2.0, n_steps=100)
    (root / "perfbench/workloads/serve_open_100.json").write_text(
        json.dumps(mix))
    (root / "perfbench/cells/n200-serve-open100.json").write_text(
        json.dumps({"limits": {"pos_gap": 1e-4}}))
    (root / "perfbench/metrics/answered.serve100.py").write_text(
        "def read(reading):\n    return 42.0\n")
    manifest["workloads"].append(
        {"name": "n200-serve-open100", "config": "gnn-h256-l6-k40-n200",
         "traffic": "serve_open_100", "chips": 1, "why": "shorter horizons"})
    manifest["end_to_end"].append(
        {"name": "rollout_p90_ms", "unit": "ms", "better": "lower",
         "bound": 0.25, "source": "host_clock",
         "workloads": ["n200-serve-open100"]})
    manifest["per_layer"].append(
        {"name": "answered.serve100", "unit": "%", "better": "higher",
         "source": "program_counter", "layer": "serve.py MicroBatcher",
         "moves": "rollout_p90_ms", "workloads": ["n200-serve-open100"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))

    cell = harness.Cell(harness.load_manifest(root / "BENCHMARK.json"),
                        "n200-serve-open100", root=root)
    assert cell.traffic["n_steps"] == 100
    assert cell.limits == {"pos_gap": 1e-4}
    assert [m["name"] for m in cell.end_to_end()] == ["setup_s",
                                                       "rollout_p90_ms"]
    assert [m["name"] for m in cell.per_layer()] == ["answered.serve100"]
    assert harness.metric_reader("answered.serve100", root=root)(None) == 42
    after = {p.relative_to(root): p.read_bytes()
             for p in (root / "perfbench").rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())


def test_forbidden_modules_by_whole_top_level_name():
    assert harness.forbidden_loaded({"jax.numpy": 1, "os": 1}) == [
        "jax.numpy"]
    assert harness.forbidden_loaded({"nbody_gnn_hpc_tpu": 1}) == [
        "nbody_gnn_hpc_tpu"]
    assert harness.forbidden_loaded({"nbody_gnn_hpc_torch.ops": 1,
                                     "jaxtyping": 1, "flaxen": 1}) == []
