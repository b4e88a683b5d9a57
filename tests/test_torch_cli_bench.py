"""The port's large-N step benchmark
(nbody_gnn_hpc_torch/benchmark_bh_temp.py) on the CPU, held to
``scripts/benchmark_bh_temp.py``: its lines, and the state its rounds
advance, against the JAX package's ``rollout_steps`` from the same
``NBodySimulator`` seed (float32 in both frameworks with other summation
orders: rtol 1e-4 / atol 1e-5 of each field's scale, as
tests/test_torch_simulator.py holds trajectories).
"""

import re

import numpy as np
import pytest

from nbody_gnn_hpc_torch import benchmark_bh_temp
from nbody_gnn_hpc_torch.ops import LAUNCH_LINE
from nbody_gnn_hpc_torch.sim import NBodySimulator, rollout_steps
from nbody_gnn_hpc_tpu import sim as jsim
from nbody_gnn_hpc_tpu.sim.integrator import rollout_steps as jax_rollout


def test_benchmark_prints_the_scripts_lines(capsys):
    assert benchmark_bh_temp.main(["--device", "cpu", "-n", "64",
                                   "--steps", "2"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == ("Benchmarking blocked all-pairs (BH-equivalent "
                        "regime) with N=64 on cpu...")
    assert re.fullmatch(r"Initialization: \d+\.\d\ds", lines[1])
    assert re.fullmatch(r"Warmup step: \d+\.\d\ds", lines[3])
    rounds = [float(m.group(1)) for m in (
        re.fullmatch(r"Round \d \(50 steps\): (\d+\.\d+) ms/step", line)
        for line in lines) if m]
    assert len(rounds) == 2 and min(rounds) > 0
    avg = re.fullmatch(r"Average step time: (\d+\.\d+)s \((\d+\.\d\d) "
                       r"Gpairs/s\)", lines[-2])
    assert avg is not None
    assert float(avg.group(1)) == pytest.approx(np.mean(rounds) / 1e3,
                                                abs=1e-6)
    assert lines[-1].startswith(LAUNCH_LINE)


@pytest.mark.parametrize("n,steps", [(64, 3), (300, 3), (2085, 1)])
def test_benchmark_state_matches_jax(n, steps):
    """Steps from the benchmark's simulator (use_barnes_hut, the default
    unit box, masses and dt) equal the JAX package's.  N=2,085 takes the
    large-N force (the blocked form on the CPU); there, in the unit box,
    close pairs amplify the two frameworks' summation orders past the
    tolerance within three steps, so that case holds one."""
    sim = NBodySimulator(n_particles=n, use_barnes_hut=True, seed=11,
                         device="cpu")
    want = jax_rollout(jsim.NBodySimulator(n_particles=n,
                                           use_barnes_hut=True,
                                           seed=11).state, sim.dt, steps)
    got = rollout_steps(sim.state, sim.dt, steps)
    for field in ("positions", "velocities", "accelerations"):
        w = np.asarray(getattr(want, field))
        np.testing.assert_allclose(getattr(got, field).numpy(), w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(),
                                   err_msg=field)
    assert int(got.step) == int(want.step) == steps
