"""The port's simulator surface (``nbody_gnn_hpc_torch/sim/simulator.py``,
the ``sim`` aliases, ``ops.aggregate_to_targets``) against the JAX
package's, case for case with ``tests/test_simulator.py``, on the CPU.

Initial conditions come from the same NumPy draws, so they are compared
bit for bit.  Trajectories are float32 in both frameworks with other
summation orders: 20 steps agree to rtol 1e-4 / atol 1e-5 of each field's
scale.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_gnn_hpc_torch.ops import aggregate_to_targets
from nbody_gnn_hpc_torch.sim import (NBodySimulator, accelerations_f64,
                                     compute_accelerations_direct,
                                     compute_total_energy,
                                     measure_numpy_baseline,
                                     run_parallel_simulations, shared_masses,
                                     trajectory_to_states)
from nbody_gnn_hpc_tpu import sim as jsim
from nbody_gnn_hpc_tpu.ops import edges as jedges

CPU = dict(device="cpu")


def _close(got, want, rel=1e-4, floor=1e-5, msg=""):
    """rtol ``rel`` and atol ``floor`` of the field's scale."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rel,
                               atol=floor * np.abs(want).max(), err_msg=msg)


def test_initial_conditions_match_jax():
    """The same MT19937 draws (positions, velocities, masses in order,
    nbody.py:174-181) give the same float32 arrays."""
    a = NBodySimulator(n_particles=50, box_size=10.0, seed=43, **CPU)
    b = jsim.NBodySimulator(n_particles=50, box_size=10.0, seed=43)
    for field in ("positions", "velocities", "masses"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    _close(a.accelerations, b.accelerations, 1e-5, 1e-6)
    assert a.positions.dtype == np.float32


def test_shared_masses_seed42_stream():
    np.testing.assert_array_equal(shared_masses(200, seed=42),
                                  jsim.shared_masses(200, seed=42))


def test_get_set_state_roundtrip():
    sim = NBodySimulator(n_particles=10, box_size=5.0, seed=1, **CPU)
    sim.run(3, verbose=False)
    state = sim.get_state()
    assert set(state) == {"positions", "velocities", "accelerations",
                          "masses", "time", "step"}
    assert state["step"] == 3
    sim2 = NBodySimulator(n_particles=10, box_size=5.0, seed=2, **CPU)
    sim2.set_state(state)
    np.testing.assert_array_equal(sim2.positions, state["positions"])
    assert sim2.step_count == 3
    assert sim2.time == pytest.approx(sim.time)


def test_run_returns_states_and_history():
    sim = NBodySimulator(n_particles=8, box_size=5.0, seed=3, **CPU)
    states = sim.run(10, save_interval=2, verbose=False)
    assert len(states) == 6  # initial + 5 saves
    assert sim.history is states
    assert states[-1]["step"] == 10
    want = jsim.NBodySimulator(n_particles=8, box_size=5.0, seed=3).run(
        10, save_interval=2, verbose=False)
    assert [s["step"] for s in states] == [s["step"] for s in want]
    for got, ref in zip(states, want):
        _close(got["positions"], ref["positions"])
        assert got["time"] == pytest.approx(ref["time"], rel=1e-6)


def test_run_equals_steps():
    """``run(n)`` and n calls of ``step`` reach the same state."""
    a = NBodySimulator(n_particles=8, box_size=5.0, seed=7, **CPU)
    b = NBodySimulator(n_particles=8, box_size=5.0, seed=7, **CPU)
    for _ in range(5):
        a.step()
    b.run(5, verbose=False)
    np.testing.assert_array_equal(a.positions, b.positions)
    np.testing.assert_array_equal(a.velocities, b.velocities)
    assert a.step_count == b.step_count == 5


def test_trajectory_matches_jax():
    """20 KDK steps of the same system, every saved field."""
    a = NBodySimulator(n_particles=24, box_size=10.0, seed=11, **CPU)
    b = jsim.NBodySimulator(n_particles=24, box_size=10.0, seed=11)
    got, want = a.run_trajectory(20), b.run_trajectory(20)
    for field in ("positions", "velocities", "accelerations"):
        _close(getattr(got, field).numpy(), getattr(want, field), msg=field)
    _close(got.times.numpy(), want.times)
    np.testing.assert_array_equal(got.steps.numpy(), np.asarray(want.steps))
    _close(a.positions, b.positions)


def test_verbose_run_prints_the_reference_progress(capsys):
    """About ten energy lines at whole save intervals, as the JAX run
    prints them; the saved states are those of the quiet run."""
    a = NBodySimulator(n_particles=12, box_size=5.0, seed=5, **CPU)
    states = a.run(25, save_interval=2, verbose=True)
    got = capsys.readouterr().out.splitlines()
    jsim.NBodySimulator(n_particles=12, box_size=5.0, seed=5).run(
        25, save_interval=2, verbose=True)
    want = capsys.readouterr().out.splitlines()
    assert [g.split(",")[0] for g in got] == [w.split(",")[0] for w in want]
    quiet = NBodySimulator(n_particles=12, box_size=5.0, seed=5, **CPU).run(
        25, save_interval=2, verbose=False)
    assert len(states) == len(quiet) == 13
    for s, q in zip(states, quiet):
        np.testing.assert_array_equal(s["positions"], q["positions"])


def test_mass_override_and_recompute():
    """Datagen overrides masses after the constructor and recomputes the
    accelerations (generate_data.py:46-47)."""
    sim = NBodySimulator(n_particles=20, box_size=10.0, seed=5, **CPU)
    ref = jsim.NBodySimulator(n_particles=20, box_size=10.0, seed=5)
    m = shared_masses(20, seed=42)
    before = sim.accelerations.copy()
    sim.masses = m
    sim.accelerations = sim._compute_accelerations()
    ref.masses = m
    ref.recompute_accelerations()
    assert not np.allclose(sim.accelerations, before)
    np.testing.assert_array_equal(sim.masses, m)
    _close(sim.accelerations, ref.accelerations, 1e-5, 1e-6)


def test_solar_system_factory():
    sim = NBodySimulator.create_solar_system(**CPU)
    ref = jsim.NBodySimulator.create_solar_system()
    assert sim.n_particles == 9 and sim.positions.shape == (9, 3)
    assert sim.positions[0, 0] == 0.0
    assert sim.masses[0] == np.float32(1.989e30)
    np.testing.assert_allclose(sim.positions[3, 0], 1.496e11, rtol=1e-5)
    for field in ("positions", "velocities", "masses"):
        np.testing.assert_array_equal(getattr(sim, field),
                                      getattr(ref, field))
    # Against the float64 oracle, not the JAX array: Neptune's pull from
    # the Sun passes through 1/r^3 ~ 1e-38, below float32's normal range,
    # which the JAX CPU backend flushes to zero (it reads -1.5e-8 m/s^2
    # where the oracle and the port read -6.58e-6).
    oracle = accelerations_f64(sim.positions.astype(np.float64),
                               sim.masses.astype(np.float64))
    np.testing.assert_allclose(sim.accelerations, oracle, rtol=1e-5,
                               atol=1e-9)
    _close(sim.run_trajectory(20).positions.numpy(),
           ref.run_trajectory(20).positions)


def test_galaxy_collision_factory():
    """The global-RNG draws of the constructor and the disks, in the
    reference's order, give the JAX scene exactly."""
    np.random.seed(0)
    sim = NBodySimulator.create_galaxy_collision(n_per_galaxy=50, **CPU)
    np.random.seed(0)
    ref = jsim.NBodySimulator.create_galaxy_collision(n_per_galaxy=50)
    assert sim.n_particles == 100
    assert np.all(sim.velocities[:50, 0] > 0)
    assert np.all(sim.velocities[50:, 0] == -2.0)
    for field in ("positions", "velocities", "masses"):
        np.testing.assert_array_equal(getattr(sim, field),
                                      getattr(ref, field))
    _close(sim.accelerations, ref.accelerations, 1e-5, 1e-6)


def test_galaxy_collision_energy_grows_as_in_the_reference():
    """At N=2,200 (the symmetric large-N force) the scene's softening 1e-9
    at dt 0.01 leaves close encounters unresolved: over 50 steps the total
    energy changes sign and grows several times over in the JAX simulator,
    and the port's follows it (the same start, the end within a factor
    2)."""
    np.random.seed(2026)
    sim = NBodySimulator.create_galaxy_collision(n_per_galaxy=1100, **CPU)
    np.random.seed(2026)
    ref = jsim.NBodySimulator.create_galaxy_collision(n_per_galaxy=1100)
    (_, _, e0), (_, _, w0) = sim.get_energy(), ref.get_energy()
    np.testing.assert_allclose(e0, w0, rtol=1e-5)
    sim.run_trajectory(50)
    ref.run_trajectory(50)
    e1, w1 = sim.get_energy()[2], ref.get_energy()[2]
    print(f"galaxy N=2,200 x 50 steps: total energy, port {e0:.6e} -> "
          f"{e1:.6e}, JAX {w0:.6e} -> {w1:.6e}")
    assert e0 < 0 < w1 and abs(w1 - w0) > abs(w0)
    assert 0.5 <= e1 / w1 <= 2.0, (e0, e1, w1)


def test_energy_diagnostic_signs():
    sim = NBodySimulator(n_particles=16, box_size=10.0, seed=11, **CPU)
    ke, pe, te = sim.get_energy()
    assert ke > 0 and pe < 0
    np.testing.assert_allclose(te, ke + pe, rtol=1e-6)
    want = jsim.NBodySimulator(n_particles=16, box_size=10.0,
                               seed=11).get_energy()
    np.testing.assert_allclose((ke, pe, te), want, rtol=1e-5)


@pytest.mark.parametrize("theta,warns", [(0.5, False), (0.3, True)])
def test_theta_warning(theta, warns):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        NBodySimulator(n_particles=5, use_barnes_hut=True, theta=theta,
                       **CPU)
    msgs = [str(w.message) for w in caught if w.category is UserWarning]
    assert bool(msgs) == warns
    if warns:
        assert "exact all-pairs" in msgs[0]
        assert "nbody_gnn_hpc_torch/sim/forces.py" in msgs[0]


def _configs(device=True):
    """Two groups of same-parameter configs, interleaved, and two
    stragglers, each the only one of its parameters."""
    dev = {"device": "cpu"} if device else {}
    group_a = [{"init": {"n_particles": 12, "box_size": 5.0, "seed": s,
                         **dev}, "run": {"n_steps": 6, "save_interval": 2}}
               for s in (1, 2, 3)]
    group_b = [{"init": {"n_particles": 9, "box_size": 4.0, "dt": 2e-3,
                         "seed": s, **dev}, "run": {"n_steps": 5}}
               for s in (7, 8)]
    odd = [{"init": {"n_particles": 7, "seed": 4, **dev},
            "run": {"n_steps": 3}},
           {"init": {"n_particles": 12, "box_size": 5.0, "seed": 9, **dev},
            "run": {"n_steps": 4, "save_interval": 3}}]
    return [group_a[0], group_b[0], odd[0], group_a[1], group_b[1],
            group_a[2], odd[1]]


def test_run_parallel_simulations_matches_jax():
    got = run_parallel_simulations(_configs())
    want = jsim.run_parallel_simulations(_configs(device=False))
    assert len(got) == len(want) == 7
    for i, (g, w) in enumerate(zip(got, want)):
        assert [s["step"] for s in g] == [s["step"] for s in w], i
        for sg, sw in zip(g, w):
            for field in ("positions", "velocities", "accelerations"):
                _close(sg[field], sw[field], msg=f"config {i} {field}")
            np.testing.assert_array_equal(sg["masses"], sw["masses"])


def test_run_parallel_simulations_groups_into_one_ensemble(monkeypatch):
    """Each group of two or more runs as one batch through the ensemble
    force, its first accelerations included; stragglers run alone."""
    from nbody_gnn_hpc_torch.parallel import datagen

    batches = []
    real = datagen.ensemble_force

    def spy(device, n):
        force = real(device, n)

        def counted(pos, masses, softening):
            batches.append(tuple(pos.shape))
            return force(pos, masses, softening)
        return counted

    monkeypatch.setattr(datagen, "ensemble_force", spy)
    run_parallel_simulations(_configs())
    assert batches.count((3, 12, 3)) == 1 + 6
    assert batches.count((2, 9, 3)) == 1 + 5
    assert len(batches) == 13


def test_trajectory_to_states_keys_and_types():
    sim = NBodySimulator(n_particles=6, box_size=3.0, seed=2, **CPU)
    states = trajectory_to_states(sim.run_trajectory(4, save_interval=2))
    want = jsim.trajectory_to_states(jsim.NBodySimulator(
        n_particles=6, box_size=3.0, seed=2).run_trajectory(4,
                                                            save_interval=2))
    assert len(states) == len(want) == 3
    for s, w in zip(states, want):
        assert set(s) == set(w)
        assert type(s["time"]) is float and type(s["step"]) is int
        assert s["step"] == w["step"]
        assert s["positions"].dtype == w["positions"].dtype


def test_reference_named_aliases_match_jax():
    rng = np.random.RandomState(3)
    pos = (rng.rand(30, 3) - 0.5) * 10
    vel = rng.randn(30, 3)
    m = rng.uniform(1e10, 1e12, 30)
    acc = compute_accelerations_direct(pos, m, **CPU)
    assert isinstance(acc, np.ndarray)
    _close(acc, jsim.compute_accelerations_direct(pos, m), 1e-5, 1e-6)
    as_tensor = compute_accelerations_direct(
        torch.tensor(pos, dtype=torch.float32),
        torch.tensor(m, dtype=torch.float32))
    assert torch.is_tensor(as_tensor)
    np.testing.assert_array_equal(as_tensor.numpy(), acc)
    got = compute_total_energy(pos, vel, m, **CPU)
    assert all(type(x) is float for x in got)
    np.testing.assert_allclose(got, jsim.compute_total_energy(pos, vel, m),
                               rtol=1e-5)


def test_aggregate_to_targets_matches_jax():
    rng = np.random.RandomState(4)
    ei = np.stack([rng.randint(0, 11, 40), rng.randint(0, 11, 40)])
    msg = rng.randn(40, 5).astype(np.float32)
    got = aggregate_to_targets(torch.from_numpy(msg), torch.from_numpy(ei),
                               11)
    want = jedges.aggregate_to_targets(jnp.asarray(msg), jnp.asarray(ei), 11)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_measure_numpy_baseline_is_a_host_rate():
    rate = measure_numpy_baseline(n_particles=16, n_steps=3, repeats=1)
    assert np.isfinite(rate) and rate > 0
