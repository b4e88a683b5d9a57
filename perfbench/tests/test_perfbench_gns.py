"""The GNS training cell, ``gns-n5000-train-bf16-b2``: its parts found by
name and held to the drivers' contract, a tiny run of it on the CPU (sound
and with each fault), ``control.py``'s readings through its driver, its
kernel in the trace's table and its metrics' readers; and the cell came
as new files and manifest entries alone."""

import argparse
import contextlib
import io
import json
import shutil
import weakref
from types import SimpleNamespace

import torch

from perfbench import control, drivers, harness, tracing, workcount_gns
from perfbench.tests.test_perfbench_discovery import (TODAYS_COUNTED,
                                                      TODAYS_KERNEL_TIME)
from perfbench.tests.tiny import measure

CELL = "gns-n5000-train-bf16-b2"
CONFIG = "gns-l128-mp10-k40-n5000"
METRICS = ("mfu.gns", "edge_sum_roofline.gns")
# The training cells' metrics that read the trace alone, whatever the model.
SHARED = ("launches_per_step.train", "idle_share.train")
FILES = ("configs/gns-l128-mp10-k40-n5000.json",
         "workloads/train_gns_bf16_b2.json",
         "cells/gns-n5000-train-bf16-b2.json", "drivers/gns_train.py",
         "reference/gns.py", "workcount_gns.py", "kernels/edge_sum.json",
         "metrics/mfu.gns.py", "metrics/edge_sum_roofline.gns.py")


def tiny_gns():
    cell = harness.Cell(harness.load_manifest(), CELL)
    cell.config["model_config"].update(latent_size=16, mlp_hidden_size=16,
                                       num_message_passing_steps=2)
    cell.config.update(particles=30, k_neighbors=6, train_samples=64)
    cell.traffic.update(warmup_steps=1, trace_at_s=0.3, trace_s=0.3)
    return cell


def test_the_cell_finds_its_parts_and_keeps_the_contract():
    cell = harness.Cell(harness.load_manifest(), CELL)
    assert cell.config["model_config"]["architecture"] == "gns"
    assert cell.config["reduced"] == []
    drv = cell.driver()
    assert drv.__name__ == "perfbench.drivers.gns_train"
    assert drivers.is_training(drv) and drivers.missing(drv) == []
    assert [m["name"] for m in cell.end_to_end()] == [
        "train_samples_per_s", "setup_s"]
    assert sorted(m["name"] for m in cell.per_layer()) == sorted(
        METRICS + SHARED)
    for name in METRICS:
        harness.metric_reader(name)
    assert set(cell.limits) == {"first_loss_gap", "loss_gap", "grad_gap",
                                "change_gap"}


def test_a_tiny_run_is_correct_and_each_fault_is_not():
    cell = tiny_gns()
    rc, res, err = measure(cell, seconds=1.0)
    assert rc == 0 and res["correct"], err[-2000:]
    assert sorted(res["metrics"]) == ["setup_s", "train_samples_per_s"]
    for fault in ("frozen", "half_batch"):
        rc, res, err = measure(cell, seconds=0.3, fault=fault)
        assert rc == 0 and not res["correct"], (fault, res["compared"])
    rc, res, err = measure(cell, seconds=1.0, trace=1)
    assert rc == 0 and res["correct"], err[-2000:]
    # the CPU trace holds no device work: the roofline reads nothing
    assert sorted(res["metrics"]) == ["mfu.gns"]
    assert 0 < res["metrics"]["mfu.gns"]["value"] < 100


def test_the_window_says_how_the_step_ran():
    cell = tiny_gns()
    drv = cell.driver()
    state = drv.setup(cell, 5, torch.device("cpu"))
    record = drv.window(state, 0.2)
    # off the card every step runs eagerly
    assert record["eager_steps"] == record["steps"] + 3 + 1
    assert record["captures"] == record["graph_replays"] == 0
    step = weakref.ref(state["step"])
    drv.release(state)
    assert "step" not in state and "model" not in state
    # collected, and with it (on the card) its graph's memory pool
    assert step() is None


def test_control_readings_go_through_the_gns_driver():
    cell = tiny_gns()
    args = argparse.Namespace(seeds=[5], control_seeds=[5], fault_seeds=[5],
                              faults=["frozen"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        control.train_readings(cell, args, torch.device("cpu"))
    rows = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert [r["kind"] for r in rows] == ["program", "control",
                                         "fault:frozen"]
    # a frozen optimizer changes no parameter
    assert rows[2]["change_gap"] == 1.0


def test_edge_sum_joins_the_trace_table_and_its_roofline_reads_it():
    assert tracing.COUNTED["edge_sum"] == ("receiver_sum_kernel", False)
    trace = tracing.Trace(lambda: {})
    trace.device_ops = [
        ("(anonymous namespace)::receiver_sum_kernel(float const*)",
         0, 600_000),
        ("(anonymous namespace)::receiver_sum_kernel(float const*)",
         600_000, 1_200_000),
        ("void fused_edge_fwd_kernel<8, 5, float>(float const*)", 0, 1)]
    trace.counted = {"edge_sum": 2, "fused_edge_fwd": 1}
    ok, table = trace.complete()
    assert ok and table == {"edge_sum": (2, 2), "fused_edge_fwd": (1, 1)}
    assert abs(trace.kernel_seconds("edge_sum") - 1.2e-3) < 1e-12
    cell = harness.Cell(harness.load_manifest(), CELL)
    reading = SimpleNamespace(cell=cell, trace=trace,
                              record={"traced_steps": 1})
    got = harness.metric_reader("edge_sum_roofline.gns")(reading)
    one = workcount_gns.receiver_sum_s(2, 5000, 200_000, 128)
    assert abs(got - 100.0 * 2 * one / 1.2e-3) < 1e-9
    # a launch counted but not seen: no reading
    trace.counted["edge_sum"] = 3
    assert harness.metric_reader("edge_sum_roofline.gns")(reading) is None


def test_mfu_reads_the_published_work():
    cell = harness.Cell(harness.load_manifest(), CELL)
    work = workcount_gns.train_step_work(2, 5000, 40, 128, 128, 2, 10, 6,
                                         1_588_998, "bfloat16")
    # the bf16 products: per edge and step 2 x (128 x 128) x 3 forward,
    # three times that with the backward, over 400,000 edges and 10 steps
    edge_products = 3 * 10 * 400_000 * 2 * 128 * 128 * 3
    assert edge_products < work.mm_bf16 < 1.2 * edge_products
    reading = SimpleNamespace(cell=cell, state={"n_params": 1_588_998},
                              record={"steps": 100, "window_s": 10.0})
    got = harness.metric_reader("mfu.gns")(reading)
    assert abs(got - 100.0 * 100 * work.least_s() / 10.0) < 1e-9


def test_the_kernel_tables_are_todays_and_the_receiver_sum(tmp_path):
    """The kernel table is the one of kernels 1, 2 and 7 and
    ``kernels/edge_sum.json``'s entry; without that one file it is the
    table that ``test_perfbench_discovery``'s two kernel-table tests pin
    (they hold it to the files of kernels 1, 2 and 7 alone, so that file
    is the only thing they fail on)."""
    counted, kernel_time = tracing.kernel_tables()
    assert counted == dict(TODAYS_COUNTED,
                           edge_sum=("receiver_sum_kernel", False))
    assert kernel_time == dict(TODAYS_KERNEL_TIME,
                               edge_sum=("receiver_sum_kernel",))
    shutil.copytree(tracing.KERNELS, tmp_path / "kernels")
    (tmp_path / "kernels/edge_sum.json").unlink()
    assert tracing.kernel_tables(tmp_path / "kernels") == (
        TODAYS_COUNTED, TODAYS_KERNEL_TIME)


def test_the_cell_came_as_entries_at_the_ends_of_their_lists():
    """Its configuration, cell and metrics are the last entries of their
    lists, and each list of cells that names it names it last: the
    end-to-end metric it reports and the two training metrics that read
    the trace alone."""
    manifest = harness.load_manifest()
    assert manifest["configs"][-1]["name"] == CONFIG
    assert manifest["workloads"][-1]["name"] == CELL
    assert tuple(m["name"] for m in manifest["per_layer"][-2:]) == METRICS
    naming = [m for m in manifest["end_to_end"] + manifest["per_layer"]
              if CELL in m.get("workloads", [])]
    assert all(m["workloads"][-1] == CELL for m in naming)
    assert sorted(m["name"] for m in naming) == sorted(
        ("train_samples_per_s",) + SHARED + METRICS)
