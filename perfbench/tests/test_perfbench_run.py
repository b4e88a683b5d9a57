"""Whole runs: the command without a card, a checkout without the program,
and tiny cells on the CPU with the look for a card skipped, sound and
with each fault a cell can have planted in the program."""

import ast
import os
import shutil
import subprocess
import sys

import pytest

from perfbench import harness
from perfbench.tests.tiny import measure, tiny_open, tiny_serve, tiny_train

RUN = [sys.executable, "perfbench/run.py", "--workload",
       "n200-train-bf16-b24", "--seed", str(2 ** 31 + 7), "--seconds", "1",
       "--trace", "0"]


def _env():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return env


def test_refuses_without_a_card():
    proc = subprocess.run(RUN, cwd=harness.ROOT, capture_output=True,
                          text=True, timeout=120, env=_env())
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_refuses_in_a_checkout_of_only_the_benchmark(tmp_path):
    shutil.copytree(harness.BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.MANIFEST, tmp_path / "BENCHMARK.json")
    proc = subprocess.run(RUN, cwd=tmp_path, capture_output=True, text=True,
                          timeout=120, env=_env())
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_no_jax_in_the_benchmark_or_the_program():
    """A process that imports every module of the benchmark and runs a
    tiny cell holds no module whose top-level name is forbidden."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import perfbench\n"
        "for m in pkgutil.walk_packages(perfbench.__path__, 'perfbench.'):\n"
        "    importlib.import_module(m.name)\n"
        "from perfbench.tests.tiny import measure, tiny_train\n"
        "rc, res, _ = measure(tiny_train(), seconds=0.5)\n"
        "assert rc == 0 and res['correct']\n"
        "from perfbench import harness\n"
        "print(harness.forbidden_loaded())\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                          capture_output=True, text=True, timeout=300,
                          env=_env())
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_no_source_imports_jax():
    for path in harness.BENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for name in names:
                assert name.split(".")[0] not in harness.FORBIDDEN_MODULES, \
                    (path, name)


def test_train_cell_runs_and_is_correct():
    rc, res, err = measure(tiny_train(), seconds=1.0)
    assert rc == 0 and res["correct"], err[-2000:]
    assert set(res["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "compared"
    assert err.strip().splitlines()[-1].startswith("change_gap ")


def test_train_cell_traced():
    rc, res, err = measure(tiny_train(), seconds=1.0, trace=1)
    assert rc == 0 and res["correct"], err[-2000:]
    assert "mfu.train" in res["metrics"]
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("fault", ["frozen", "half_batch"])
def test_train_fault_is_not_correct(fault):
    rc, res, err = measure(tiny_train(), seconds=0.5, fault=fault)
    assert rc == 0 and res["correct"] is False, err[-2000:]


def test_closed_loop_cell_runs_and_is_correct():
    rc, res, err = measure(tiny_serve(), seconds=2.0)
    assert rc == 0 and res["correct"], err[-2000:]
    assert set(res["metrics"]) == {"rollout_particle_steps_per_s",
                                   "setup_s"}
    assert res["attempted"] > 0


def test_open_loop_runs_and_is_correct():
    rc, res, err = measure(tiny_open(), seconds=2.0)
    assert rc == 0 and res["correct"], err[-2000:]
    assert set(res["metrics"]) == {"rollout_p90_ms", "setup_s"}
    assert res["attempted"] == 8


@pytest.mark.parametrize("fault", ["altered", "half_batch"])
def test_serve_fault_is_not_correct(fault):
    """A burst that the micro-batcher takes as one dispatch of several
    systems."""
    cell = tiny_open(rate_per_s=16.0, check_sample=8)
    rc, res, err = measure(cell, seconds=0.5, fault=fault)
    assert rc == 0 and res["correct"] is False, err[-2000:]
