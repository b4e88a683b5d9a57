"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

From the root of a checkout.  The cell's parts are found by name
(:mod:`perfbench.harness`).  Set-up (imports, kernel builds, data, weights,
warm-up) is timed as ``setup_s``; then the window runs for ``--seconds``;
then the peak device memory is read, the program's state freed, and what
the timed path produced is compared with the plain reference.  With
``--trace 1`` a span of the window is traced and the cell's per-layer
metrics are reported instead of its end-to-end ones.

The last line of standard output is one JSON object; the numbers compared,
each beside its limit, are the last lines of standard error.  Exits with 3,
printing no result, without the CUDA devices the cell asks for, and with 4
if a JAX module was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Kernel and compile caches inside the checkout, at fixed paths.
CACHE = ROOT / "build" / "perfbench_cache"
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def judged(numbers: dict, limits: dict) -> list:
    """[(name, value, limit)] of every number that has a limit."""
    return [(k, float(numbers[k]), float(limits[k])) for k in limits]


def device_info(chips: int) -> dict:
    import torch

    peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak)}


def per_layer_metrics(cell, reading) -> dict:
    from perfbench.harness import metric_reader

    out = {}
    for m in cell.per_layer():
        value = metric_reader(m["name"])(reading)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


class Reading:
    """What a per-layer metric's reader gets: the cell, the window's
    record and the trace of its span."""

    def __init__(self, cell, state, record, trace):
        self.cell, self.state, self.record, self.trace = \
            cell, state, record, trace


def run(args, stdout=sys.stdout, stderr=sys.stderr, fault=None) -> int:
    from perfbench import harness

    try:
        manifest = harness.load_manifest()
        cell = harness.Cell(manifest, args.workload)
    except (harness.BenchError, KeyError, ValueError) as e:
        print(f"perfbench: {e}", file=stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"perfbench: cell {cell.name} needs {cell.chips} CUDA "
              f"device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count() is "
              f"{torch.cuda.device_count()}", file=stderr)
        return 3
    return measure(cell, args, torch.device("cuda", 0), stdout, stderr,
                   fault)


def measure(cell, args, device, stdout, stderr, fault=None) -> int:
    """The run after the look for a device: set-up, window, comparison,
    result.  The CPU tests call it with ``device`` the CPU."""
    import torch

    from perfbench import harness
    from perfbench.tracing import Trace

    driver = cell.driver()
    t_setup = time.perf_counter()
    state = driver.setup(cell, args.seed, device, fault=fault)
    setup_s = time.perf_counter() - T_START
    print("setup stages: " + json.dumps(dict(
        imports=t_setup - T_START, **state.get("setup_stages", {}))),
        file=stderr)
    trace = None
    if args.trace:
        from nbody_gnn_hpc_torch.ops import launch_counts

        trace = Trace(launch_counts)
    record = driver.window(state, args.seconds, trace)
    dev = device_info(cell.chips) if device.type == "cuda" else {
        "platform": "cpu", "kind": "cpu", "count": 0,
        "memory_peak_bytes": 0}
    reading = Reading(cell, state, record, trace)
    if args.trace:
        metrics = per_layer_metrics(cell, reading)
        dev["busy_s"] = trace.busy_s()
        dev["window_s"] = trace.window_s
    else:
        values = dict(record, setup_s=setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end()}
    driver.release(state)
    numbers = driver.check(state)
    compared = judged(numbers, cell.limits)
    correct = all(v <= lim for _, v, lim in compared)
    found = harness.forbidden_loaded()
    if found:
        print(f"perfbench: JAX modules loaded: {', '.join(found)}",
              file=stderr)
        return 4
    result = {"correct": correct, "attempted": record["attempted"],
              "failed": record["failed"], "metrics": metrics, "device": dev}
    if trace is not None:
        result["breakdown"] = trace.breakdown()
        complete, table = trace.complete()
        print(f"trace complete: {complete} {json.dumps(table)}",
              file=stderr)
    result["compared"] = {name: {"value": v, "limit": lim}
                          for name, v, lim in compared}
    extra = {k: v for k, v in numbers.items() if k not in cell.limits}
    if extra:
        print("comparison detail: " + json.dumps(extra, default=str),
              file=stderr)
    for name, v, lim in compared:
        print(f"{name} {v!r} limit {lim!r}", file=stderr)
    stderr.flush()
    print(json.dumps(result), file=stdout)
    stdout.flush()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return 0


def main(argv=None) -> int:
    return run(parse(argv))


if __name__ == "__main__":
    sys.exit(main())
