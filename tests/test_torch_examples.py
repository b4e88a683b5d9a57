"""The port's demo commands (nbody_gnn_hpc_torch/examples) run end to end
at tiny sizes on the CPU, as tests/test_examples.py runs the JAX package's
examples/demo_*.py."""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent


def _run(name, *flags):
    proc = subprocess.run(
        [sys.executable, "-m", f"nbody_gnn_hpc_torch.examples.{name}",
         "--device", "cpu", *flags], cwd=REPO, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-1500:]
    assert proc.stdout.splitlines()[-1].startswith("Kernel launches: ")
    return proc.stdout


def test_solar_system_demo(tmp_path):
    out = _run("demo_solar_system", "--days", "30", "-o", str(tmp_path))
    drift = float(re.search(r"energy drift over 30 days: (\S+)", out)
                  .group(1))
    assert 0 <= drift < 1e-4
    # 30 days in: Earth ~30/365 of an orbit from (1, 0) AU.
    end = re.search(r"end: \((\S+), (\S+)\) AU", out).groups()
    angle = 2 * np.pi * 30 / 365.25
    np.testing.assert_allclose([float(v) for v in end],
                               [np.cos(angle), np.sin(angle)], atol=0.02)
    pytest.importorskip("matplotlib")
    assert (tmp_path / "solar_system.png").stat().st_size > 0


def test_galaxy_collision_demo(tmp_path):
    out = _run("demo_galaxy_collision", "--per-galaxy", "15", "--steps",
               "5", "-o", str(tmp_path), "--gif")
    assert "Integrating 30 particles for 5 steps" in out
    pytest.importorskip("matplotlib")
    for name in ("galaxy_collision.png", "galaxy_distribution.png",
                 "galaxy_collision.gif"):
        assert (tmp_path / name).stat().st_size > 0, name


def test_galaxy_demo_scene_equals_the_jax_demos():
    """The same seed gives the JAX demo's scene: np.random.seed(0), then
    ``create_galaxy_collision``."""
    from nbody_gnn_hpc_torch.sim import NBodySimulator
    from nbody_gnn_hpc_tpu.sim import NBodySimulator as JaxSimulator

    np.random.seed(0)
    want = JaxSimulator.create_galaxy_collision(n_per_galaxy=15)
    np.random.seed(0)
    got = NBodySimulator.create_galaxy_collision(n_per_galaxy=15,
                                                 device="cpu")
    np.testing.assert_allclose(got.positions, np.asarray(want.positions),
                               rtol=1e-6)
    np.testing.assert_allclose(got.velocities, np.asarray(want.velocities),
                               rtol=1e-6)
