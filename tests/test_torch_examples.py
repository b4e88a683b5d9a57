"""The port's demo commands (nbody_gnn_hpc_torch/examples) run end to end
at tiny sizes on the CPU, as tests/test_examples.py runs the JAX package's
examples/demo_*.py."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent


def _run(name, *flags, env=None):
    proc = subprocess.run(
        [sys.executable, "-m", f"nbody_gnn_hpc_torch.examples.{name}",
         "--device", "cpu", *flags], cwd=REPO, capture_output=True,
        text=True, timeout=300, env=env)
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


def test_serving_demo():
    """At the JAX test's size and strings (tests/test_examples.py)."""
    out = _run("demo_serving", "--clients", "3", "--particles", "16",
               "--k-neighbors", "4", "--steps", "4")
    assert "Concurrent wall clock" in out
    assert out.count("client ") == 3
    assert "final-only: state (16, 3)" in out
    assert "streamed: 5 frames" in out
    assert "/simulate: exact-physics final state (16, 3), finite=True" in out
    assert 'nbody_requests_total{endpoint="/rollout",status="200"} 7' in out


@pytest.mark.parametrize("ranks", ["0", "4"])
def test_parallel_demo(ranks):
    """At the JAX test's size and strings; ``--virtual-devices 4`` spawns
    four gloo ranks, 0 is a world of one in the process."""
    out = _run("demo_parallel", "--virtual-devices", ranks, "--particles",
               "12", "--sims", "8", "--steps", "20")
    assert "equals unsharded" in out
    assert "== 1-device" in out
    world = int(ranks) or 1
    assert (f"{2 * world} concurrent rollouts across {world} device-pinned "
            f"replicas") in out


@pytest.mark.parametrize("fmt", ["h5", "npz"])
def test_surrogate_demo(fmt, tmp_path):
    """A tiny run in either trajectory format; its work directory goes to
    the temporary directory it is given."""
    if fmt == "h5":
        pytest.importorskip("h5py")
    out = _run("demo_surrogate", "--sims", "3", "--particles", "8",
               "--steps", "20", "--epochs", "1", "--trajectory-format", fmt,
               env={**os.environ, "TMPDIR": str(tmp_path)})
    workdir = Path(re.search(r"workdir: (\S+)", out).group(1))
    assert workdir.parent == tmp_path
    assert sorted(p.name for p in (workdir / "checkpoints").iterdir()) == [
        f"sim_{i:04d}_trajectory.{fmt}" for i in range(3)]
    assert ((workdir / "train.h5").exists()
            and (workdir / "val.h5").exists()) == (fmt == "h5")
    assert (workdir / "models" / "best_model.pt").exists()
    assert "Rollout vs HPC over 14 steps:" in out
    for label in ("mean", "final"):
        rmse = float(re.search(rf"{label} position RMSE: (\S+)", out)
                     .group(1))
        assert np.isfinite(rmse) and rmse >= 0


@pytest.mark.parametrize("fmt", ["h5", "npz"])
def test_surrogate_demo_data_equals_the_jax_demos(fmt, tmp_path):
    """The demo's ensemble and datasets against the JAX demo's steps
    (examples/demo_surrogate.py) for the same seeds: float32 trajectories
    with other summation orders, rtol 1e-4 / atol 1e-5 of scale, as
    tests/test_torch_simulator.py holds them; the windows cut from them
    likewise; the masses and sample counts exactly."""
    from nbody_gnn_hpc_torch.examples import demo_surrogate
    from nbody_gnn_hpc_tpu.io import CheckpointManager as JaxManager
    from nbody_gnn_hpc_tpu.io import create_training_dataset
    from nbody_gnn_hpc_tpu.parallel import simulate_ensemble
    from nbody_gnn_hpc_tpu.parallel import trajectory_slice
    from nbody_gnn_hpc_tpu.sim import shared_masses
    from nbody_gnn_hpc_tpu.train import GNNDataset

    sims, n, steps = 3, 8, 20
    masses, traj = demo_surrogate.simulate(range(42, 42 + sims), n, steps,
                                           "cpu")
    got = demo_surrogate.store_and_split(traj, masses, tmp_path / "port",
                                         fmt)

    want_masses = shared_masses(n, seed=42)
    np.testing.assert_array_equal(masses, want_masses)
    jtraj = simulate_ensemble(seeds=[42 + i for i in range(sims)],
                              n_particles=n, n_steps=steps, box_size=10.0,
                              dt=0.001, shared_masses=want_masses)
    for field in ("positions", "velocities"):
        w = np.asarray(getattr(jtraj, field))
        np.testing.assert_allclose(getattr(traj, field).numpy(), w,
                                   rtol=1e-4, atol=1e-5 * np.abs(w).max())
    manager = JaxManager(str(tmp_path / "jax" / "checkpoints"))
    trajs = []
    for i in range(sims):
        manager.save_trajectory(trajectory_slice(jtraj, i), f"sim_{i:04d}")
        trajs.append(manager.load_trajectory(f"sim_{i:04d}"))
    for part, name in ((trajs[:2], "train.h5"), (trajs[2:], "val.h5")):
        create_training_dataset(part, str(tmp_path / "jax" / name),
                                sequence_length=5, masses=want_masses)
    ds_train = GNNDataset(str(tmp_path / "jax" / "train.h5"), k_neighbors=6)
    want = (ds_train, GNNDataset(
        str(tmp_path / "jax" / "val.h5"), k_neighbors=6,
        external_norm_stats=ds_train.get_normalization_stats()))
    for g, w in zip(got, want):
        assert g.n_samples == w.n_samples
        np.testing.assert_array_equal(g.get_masses_tensor(),
                                      w.get_masses_tensor())
        for field in ("last_states", "targets", "state_mean", "state_std"):
            ref = np.asarray(getattr(w, field))
            np.testing.assert_allclose(getattr(g, field), ref, rtol=1e-4,
                                       atol=1e-5 * np.abs(ref).max(),
                                       err_msg=field)
        np.testing.assert_array_equal(np.asarray(g.edge_index),
                                      np.asarray(w.edge_index))
