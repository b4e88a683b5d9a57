"""A cell and a metric are found by name, and a later one can be added as
new files and manifest entries alone."""

import copy
import json
import os
import shutil
import subprocess
import sys

import pytest

from perfbench import harness, tracing


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


# A training driver under a name of its own, built from train_loop's
# functions, that records the calls that reach it.
SECOND_DRIVER = '''"""A second training driver, reusing train_loop's functions."""

from perfbench.drivers import train_loop
from perfbench.drivers.train_loop import Feed, compare, release, window  # noqa

CALLS = []


def setup(cell, seed, device, fault=None):
    CALLS.append("setup")
    return train_loop.setup(cell, seed, device, fault=fault)


def reference_readings(state, prec):
    CALLS.append("reference_readings:" + prec)
    return train_loop.reference_readings(state, prec)


def check(state):
    prec = state["cell"].config["model_config"]["dtype"]
    if state["device"].type != "cuda":
        prec = "float32"
    return compare(state["program"], reference_readings(state, prec))
'''

# Run in the copy: the new cell at tiny sizes through run.measure, then
# control.py's training readings, then a trace holding the new kernel.
SECOND_RUN = '''
import argparse, contextlib, io, json
import torch
torch.set_num_threads(2)
from perfbench import control, drivers, tracing
from perfbench.tests.tiny import measure, tiny_train
cell = tiny_train("n200-train-second")
drv = cell.driver()
out = {"driver": drv.__name__, "missing": drivers.missing(drv)}
rc, res, err = measure(cell, seconds=1.0)
out.update(rc=rc, correct=res and res["correct"], err=err[-2000:],
           metrics=sorted(res["metrics"]) if res else None,
           calls=list(drv.CALLS))
drv.CALLS.clear()
args = argparse.Namespace(seeds=[5], control_seeds=[5], fault_seeds=[5],
                          faults=["frozen"])
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    control.train_readings(cell, args, torch.device("cpu"))
out["control"] = [json.loads(l)["kind"] for l in buf.getvalue().splitlines()]
out["control_calls"] = list(drv.CALLS)
trace = tracing.Trace(lambda: {})
trace.device_ops = [
    ("void second_edge_kernel<__nv_bfloat16>(__nv_bfloat16 const*)", 0, 10),
    ("void second_edge_sum_kernel(float*)", 10, 15),
    ("void fused_edge_fwd_kernel<8, 5, float>(float const*)", 15, 16)]
trace.counted = {"second_edge_fwd_bf16": 1, "fused_edge_fwd": 1}
out["complete"] = trace.complete()
out["kernel_ns"] = round(trace.kernel_seconds("second_edge") * 1e9)
print(json.dumps(out))
'''


def _second_training_cell(root, manifest):
    """The new files and manifest entries of a training cell with a driver
    of its own, in the checkout ``root``."""
    bench = root / "perfbench"
    (bench / "drivers/second_train.py").write_text(SECOND_DRIVER)
    mix = json.loads((bench / "workloads/train_bf16_b24.json").read_text())
    mix.update(driver="second_train", batch_size=8)
    (bench / "workloads/train_second_b8.json").write_text(json.dumps(mix))
    (bench / "cells/n200-train-second.json").write_bytes(
        (bench / "cells/n200-train-bf16-b24.json").read_bytes())
    (bench / "kernels/second_edge.json").write_text(json.dumps(
        {"counters": {"second_edge_fwd_bf16": {"bf16": True}},
         "pattern": "second_edge_kernel",
         "time": ["second_edge_kernel", "second_edge_sum_kernel"]}))
    (bench / "metrics/launches_per_step.second.py").write_text(
        "from perfbench import readers\n\n\ndef read(reading):\n"
        "    return readers.launches_per_step(\n"
        "        reading, reading.record.get(\"traced_steps\", 0))\n")
    cell = "n200-train-second"
    manifest["workloads"].append(
        {"name": cell, "config": "gnn-h256-l6-k40-n200",
         "traffic": "train_second_b8", "chips": 1,
         "why": "a training step driven by a driver of its own"})
    manifest["per_layer"].append(
        {"name": "launches_per_step.second", "unit": "launches/step",
         "better": "lower", "source": "device_trace",
         "layer": "train/steps.py host loop",
         "moves": "train_samples_per_s", "workloads": [cell]})
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    e2e["train_samples_per_s"]["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest, indent=2))


def test_a_training_cell_with_a_driver_of_its_own_added_as_new_files_only(
        tmp_path):
    """In a copy of the checkout: a training driver under a new module
    name, its traffic mix, limits, a kernel file, a metric's reader and the
    manifest's new entries.  The contract check (the manifest's tests, run
    in the copy) takes the cell; a tiny run of it is correct; control.py's
    training readings go through its driver; its kernel joins the trace's
    table; no file already there changed a byte."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "nbody_gnn_hpc_torch").symlink_to(
        harness.ROOT / "nbody_gnn_hpc_torch")
    before = {p.relative_to(root): p.read_bytes()
              for p in (root / "perfbench").rglob("*") if p.is_file()}
    manifest = harness.load_manifest()
    _second_training_cell(root, copy.deepcopy(manifest))

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    tests = subprocess.run(
        [sys.executable, "-m", "pytest", "-v", "-p", "no:cacheprovider",
         "perfbench/tests/test_perfbench_manifest.py"],
        cwd=root, capture_output=True, text=True, timeout=300, env=env)
    assert tests.returncode == 0, tests.stdout[-3000:]
    assert "test_every_cell_reports_enough[n200-train-second] PASSED" in \
        tests.stdout, tests.stdout[-3000:]
    proc = subprocess.run([sys.executable, "-c", SECOND_RUN], cwd=root,
                          capture_output=True, text=True, timeout=600,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])

    assert out["driver"] == "perfbench.drivers.second_train"
    assert out["missing"] == []
    assert out["rc"] == 0 and out["correct"] is True, out["err"]
    assert out["metrics"] == ["setup_s", "train_samples_per_s"]
    assert out["calls"] == ["setup", "reference_readings:float32"]
    assert out["control"] == ["program", "control", "fault:frozen"]
    assert out["control_calls"] == ["setup", "reference_readings:bfloat16",
                                    "reference_readings:int8", "setup"]
    assert out["complete"] == [True, {"second_edge_fwd_bf16": [1, 1],
                                      "fused_edge_fwd": [1, 1]}]
    assert out["kernel_ns"] == 15

    after = {p.relative_to(root): p.read_bytes()
             for p in (root / "perfbench").rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())
    # The manifest's only edit to an entry already there: the new cell's
    # name appended to train_samples_per_s's workloads.
    grown = harness.load_manifest(root / "BENCHMARK.json")
    for key in ("workloads", "per_layer"):
        assert grown[key][:len(manifest[key])] == manifest[key]
    e2e = {m["name"]: m for m in grown["end_to_end"]}
    assert e2e["train_samples_per_s"]["workloads"].pop() == \
        "n200-train-second"
    assert grown["end_to_end"] == manifest["end_to_end"]


# The kernel table as the three kernel files of kernels 1, 2 and 7 give it.
TODAYS_COUNTED = {
    "fused_edge_fwd": (r"fused_edge_fwd_kernel", False),
    "fused_edge_fwd_bf16": (r"fused_edge_fwd_kernel", True),
    "fused_edge_bwd": (r"fused_edge_bwd_source_kernel", False),
    "fused_edge_bwd_bf16": (r"fused_edge_bwd_source_kernel", True),
    "fused_full_fwd": (r"fused_full_fwd_kernel", False),
    "fused_full_fwd_bf16": (r"fused_full_fwd_kernel", True),
}
TODAYS_KERNEL_TIME = {
    "edge_fwd": (r"fused_edge_fwd_kernel",),
    "edge_bwd": (r"fused_edge_bwd_source_kernel",
                 r"fused_edge_bwd_target_kernel", r"reduce_rows_kernel"),
}


def test_kernel_tables_hold_todays_kernels_without_a_new_file():
    assert tracing.COUNTED == TODAYS_COUNTED
    assert tracing.KERNEL_TIME == TODAYS_KERNEL_TIME
    assert tracing.kernel_tables() == (TODAYS_COUNTED, TODAYS_KERNEL_TIME)


def test_a_kernel_file_joins_the_tables_and_a_counter_is_declared_once(
        tmp_path):
    shutil.copytree(tracing.KERNELS, tmp_path / "kernels")
    (tmp_path / "kernels/new.json").write_text(json.dumps(
        {"counters": {"new_fwd": {"bf16": False}}, "pattern": "new_kernel"}))
    counted, kernel_time = tracing.kernel_tables(tmp_path / "kernels")
    assert counted == dict(TODAYS_COUNTED, new_fwd=("new_kernel", False))
    assert kernel_time == TODAYS_KERNEL_TIME
    (tmp_path / "kernels/twice.json").write_text(json.dumps(
        {"counters": {"fused_edge_fwd": {"bf16": False}},
         "pattern": "other_kernel"}))
    with pytest.raises(ValueError, match="fused_edge_fwd"):
        tracing.kernel_tables(tmp_path / "kernels")
