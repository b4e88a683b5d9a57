"""The benchmark's manifest and how a cell finds its parts by name.

``BENCHMARK.json`` (the repo root) names the cells; a cell's configuration
is the file its ``configs`` entry names, its traffic mix is
``perfbench/workloads/<traffic>.json`` (whose ``driver`` key names the
module under ``perfbench/drivers/`` that runs it), its limits are
``perfbench/cells/<cell>.json`` and each per-layer metric is read by
``perfbench/metrics/<metric>.py``.  Adding a cell or a metric is adding
files and manifest entries.

A training cell of another architecture than ``NBodyGNN`` is added so,
every part a new file or a new manifest entry:

1. its configuration, ``perfbench/configs/<config>.json``, whose
   ``model_config`` has an ``architecture`` key, and its ``configs`` entry;
2. its driver, ``perfbench/drivers/<driver>.py``, to the contract of
   :mod:`perfbench.drivers` (``reference_readings`` and ``compare`` make
   it a training driver); it may import ``Feed``, ``window``, ``release``
   and ``compare`` from :mod:`perfbench.drivers.train_loop`;
3. its plain-PyTorch reference under ``perfbench/reference/``, which
   imports nothing of the program;
4. its work counts (operations and bytes from the shapes alone), a module
   of their own beside :mod:`perfbench.workcount`;
5. its traffic mix, ``perfbench/workloads/<traffic>.json``, naming the
   driver, and its limits, ``perfbench/cells/<cell>.json``, set from the
   readings of ``perfbench/control.py``;
6. its per-layer metrics' readers, ``perfbench/metrics/<metric>.py``, and
   their ``per_layer`` entries listing the cell;
7. each new hand-written kernel's file, ``perfbench/kernels/<kernel>.json``
   (:mod:`perfbench.tracing`);
8. the cell's ``workloads`` entry, and its name appended to the
   ``workloads`` list of ``train_samples_per_s``.
"""

import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
MANIFEST = ROOT / "BENCHMARK.json"
# Whole top-level module names that no process of the benchmark may hold.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "nbody_gnn_hpc_tpu")


class BenchError(RuntimeError):
    """The benchmark cannot run this cell here."""


def load_manifest(path: Path = MANIFEST) -> dict:
    if not path.is_file():
        raise BenchError(f"no {path.name} at {path.parent}")
    return json.loads(path.read_text())


def _by_name(entries: List[dict], name: str, what: str) -> dict:
    for entry in entries:
        if entry["name"] == name:
            return entry
    raise BenchError(f"BENCHMARK.json has no {what} named {name!r}")


def read_json(path: Path) -> dict:
    if not path.is_file():
        raise BenchError(f"missing {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


class Cell:
    """One entry of ``workloads`` with everything found by its names."""

    def __init__(self, manifest: dict, name: str, root: Path = ROOT):
        self.manifest = manifest
        self.root = root
        self.workload = _by_name(manifest["workloads"], name, "workload")
        self.name = name
        self.chips = int(self.workload["chips"])
        cfg_entry = _by_name(manifest["configs"], self.workload["config"],
                             "config")
        self.config = read_json(root / cfg_entry["file"])
        bench = root / "perfbench"
        self.traffic = read_json(bench / "workloads"
                                 / f"{self.workload['traffic']}.json")
        self.limits = read_json(bench / "cells" / f"{name}.json")["limits"]
        self.run_seconds = int(manifest["run_seconds"])

    def end_to_end(self) -> List[dict]:
        """The end-to-end metrics this cell reports, ``setup_s`` among
        them."""
        return [m for m in self.manifest["end_to_end"]
                if "workloads" not in m or self.name in m["workloads"]]

    def per_layer(self) -> List[dict]:
        """The per-layer metrics read in this cell's traced run: those that
        list it, and those without a list whose end-to-end metric the cell
        reports."""
        mine = {m["name"] for m in self.end_to_end()}
        return [m for m in self.manifest["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in mine)]

    def driver(self):
        return importlib.import_module(
            f"perfbench.drivers.{self.traffic['driver']}")


def metric_reader(name: str, root: Path = ROOT):
    """The ``read(reading)`` function of ``perfbench/metrics/<name>.py``."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    if not path.is_file():
        raise BenchError(f"no reader for per-layer metric {name!r} "
                         f"({path.relative_to(root)})")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_loaded(modules: Optional[Dict[str, object]] = None
                     ) -> List[str]:
    """Modules in ``sys.modules`` whose top-level name (the part before the
    first dot, compared whole) is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({m for m in names
                   if m.split(".")[0] in FORBIDDEN_MODULES})


def percentile(values: List[float], q: float) -> float:
    """The ``q`` percentile (0-100) by linear interpolation between order
    statistics (numpy's default)."""
    s = sorted(values)
    if not s:
        raise ValueError("no values")
    pos = (len(s) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def stage_seconds(marks) -> dict:
    """{stage: seconds} from [(stage, time at its end)], the first mark
    the start."""
    return {name: t - marks[i][1] for i, (name, t) in enumerate(marks[1:])}
