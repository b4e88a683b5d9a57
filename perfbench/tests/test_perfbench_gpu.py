"""On the card, at the cells' own sizes: the controls (the reference in the
program's place at the precision below the configuration's) come out not
correct, the program comes out correct, and the traced span holds every
kernel the program launched in it.

    python -m pytest -m gpu perfbench/tests/test_perfbench_gpu.py
"""

import pytest
import torch

from perfbench import harness
from perfbench.control import CONTROL_PREC

pytestmark = pytest.mark.gpu
SEED = 3_000_000_019


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the port's kernels have no CPU "
                    "mode)")
    return torch.device("cuda")


def _cell(name):
    return harness.Cell(harness.load_manifest(), name)


def _fails(numbers, limits):
    return any(numbers[k] > v for k, v in limits.items())


def test_train_control_is_not_correct(cuda):
    from perfbench.drivers import train_loop as drv

    cell = _cell("n200-train-bf16-b24")
    state = drv.setup(cell, SEED, cuda)
    drv.release(state)
    prec = cell.config["model_config"]["dtype"]
    ref = drv.reference_readings(state, prec)
    assert not _fails(drv.compare(state["program"], ref), cell.limits)
    low = drv.reference_readings(state, CONTROL_PREC[prec])
    assert _fails(drv.compare(low, ref), cell.limits)


def test_serve_control_is_not_correct(cuda):
    from perfbench.drivers import closed_loop, serving

    cell = _cell("n5000-serve-c4")
    state = serving.setup(cell, SEED, cuda)
    try:
        closed_loop.window(state, 6.0)
    finally:
        serving.release(state)
    ref = serving.reference_outputs(state, "float32")
    assert not _fails(serving.rollout_gaps(state, ref), cell.limits)
    low = serving.reference_outputs(state, CONTROL_PREC["float32"])
    for rec in state["records"]:
        if rec.index in low:
            rec.positions, rec.velocities = low[rec.index]
    assert _fails(serving.rollout_gaps(state, ref), cell.limits)


@pytest.mark.parametrize("name", ["n200-train-bf16-b24", "n5000-serve-c4"])
def test_trace_is_complete(cuda, name):
    from nbody_gnn_hpc_torch.ops import launch_counts
    from perfbench.tracing import Trace

    cell = _cell(name)
    cell.traffic.update(trace_at_s=1.0, trace_s=1.0)
    driver = cell.driver()
    state = driver.setup(cell, SEED, cuda)
    trace = Trace(launch_counts)
    try:
        driver.window(state, 3.0, trace)
    finally:
        driver.release(state)
    ok, table = trace.complete()
    assert table and ok, table
    assert 0 < trace.busy_s() <= trace.window_s
