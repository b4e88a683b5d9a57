"""Tiny cells for the CPU: the manifest's cells with their sizes cut so
that a whole run (set-up, window, comparison) takes seconds."""

import argparse
import copy
import io

import torch

from perfbench import harness, run

SEED = 2 ** 31 + 12345  # larger than 32 signed bits hold


def tiny_train(name="n200-train-bf16-b24"):
    cell = harness.Cell(harness.load_manifest(), name)
    cell.config["model_config"].update(hidden_dim=32, n_layers=2)
    cell.config.update(particles=30, k_neighbors=6, train_samples=64)
    cell.traffic.update(batch_size=4, warmup_steps=1, trace_at_s=0.3,
                        trace_s=0.3)
    return cell


def tiny_serve(name="n5000-serve-c4", **traffic):
    cell = harness.Cell(harness.load_manifest(), name)
    cell.config.update(particles=60)
    cell.traffic.update(dict(n_steps=3, trace_at_s=0.5, trace_s=0.5,
                             wait_s=30, check_sample=4, reference_batch=2),
                        **traffic)
    return cell


def tiny_open(**traffic):
    """The closed-loop cell with the open-loop mix (perfbench/workloads/
    serve_open_394.json) in its place, reporting ``rollout_p90_ms``."""
    cell = tiny_serve()
    cell.name = "n200-serve-open"
    cell.traffic = harness.read_json(harness.BENCH / "workloads"
                                     / "serve_open_394.json")
    cell.traffic.update(dict(n_steps=3, trace_at_s=0.5, trace_s=0.5,
                             wait_s=30, check_sample=4, reference_batch=2,
                             rate_per_s=4.0), **traffic)
    cell.manifest = copy.deepcopy(cell.manifest)
    cell.manifest["end_to_end"].append(
        {"name": "rollout_p90_ms", "unit": "ms", "better": "lower",
         "bound": 0.25, "source": "host_clock",
         "workloads": ["n200-serve-open"]})
    return cell


def measure(cell, seconds=2.0, trace=0, fault=None, seed=SEED):
    """(exit code, the result line as a dict or None, stderr) of a run on
    the CPU, the look for a device skipped."""
    import json

    args = argparse.Namespace(workload=cell.name, seed=seed,
                              seconds=seconds, trace=trace)
    out, err = io.StringIO(), io.StringIO()
    rc = run.measure(cell, args, torch.device("cpu"), out, err, fault=fault)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
