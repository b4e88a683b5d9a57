"""Port simulator (nbody_gnn_hpc_torch/sim) against the JAX package's.

Tolerances are at f32 summation-order scale: the JAX padding test
(test_forces.py) measured reorderings of up to ~4e-6 relative, so the
force comparisons allow 2e-5 of the acceleration scale.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_gnn_hpc_torch.sim import (accelerations, blocked_accelerations,
                                     make_state, pairwise_accelerations,
                                     random_initial_conditions,
                                     rollout_steps, run_trajectory,
                                     shared_masses)
from nbody_gnn_hpc_torch.sim import forces as port_forces
from nbody_gnn_hpc_tpu.sim import forces as jforces
from nbody_gnn_hpc_tpu.sim import initial_conditions as jic
from nbody_gnn_hpc_tpu.sim.integrator import \
    run_trajectory as jax_run_trajectory
from nbody_gnn_hpc_tpu.sim.state import make_state as jax_make_state


def _system(n, seed):
    pos, vel, masses = random_initial_conditions(n, box_size=10.0, seed=seed)
    return (pos.astype(np.float32), vel.astype(np.float32),
            masses.astype(np.float32))


def _close(got, want, scale_tol=2e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=scale_tol * np.abs(want).max())


def test_initial_conditions_equal_jax_package():
    for a, b in zip(random_initial_conditions(50, 10.0, seed=9999),
                    jic.random_initial_conditions(50, 10.0, seed=9999)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(shared_masses(200), jic.shared_masses(200))


@pytest.mark.parametrize("n", [32, 77])
def test_pairwise_matches_jax(n):
    pos, _, masses = _system(n, seed=n)
    want = jforces.pairwise_accelerations(jnp.asarray(pos),
                                          jnp.asarray(masses))
    got = pairwise_accelerations(torch.from_numpy(pos),
                                 torch.from_numpy(masses))
    _close(got, want)


def test_blocked_matches_jax_and_pairwise():
    pos, _, masses = _system(45, seed=1)
    want = jforces.blocked_accelerations(jnp.asarray(pos),
                                         jnp.asarray(masses), block=16)
    t_pos, t_m = torch.from_numpy(pos), torch.from_numpy(masses)
    got = blocked_accelerations(t_pos, t_m, block=16)  # odd N, ragged block
    _close(got, want)
    _close(got, pairwise_accelerations(t_pos, t_m))


def test_batched_pairwise_equals_per_system():
    pos = torch.from_numpy(np.random.RandomState(2).rand(3, 20, 3)
                           .astype(np.float32))
    m = torch.full((3, 20), 1e11)
    got = pairwise_accelerations(pos, m)
    for b in range(3):
        torch.testing.assert_close(got[b], pairwise_accelerations(pos[b], m[b]))


def test_coincident_heavy_pair_stays_finite():
    """The d2 > 0 mask: at solar-scale masses G*m/soft^3 overflows f32 and
    inf * 0 would be NaN."""
    pos = torch.tensor([[0.0, 0, 0], [0.0, 0, 0], [1.0, 0, 0]])
    m = torch.tensor([2e30, 2e30, 1.0])
    acc = pairwise_accelerations(pos, m)
    assert torch.isfinite(acc).all()
    assert acc[0, 0] > 0 and acc[2, 0] < 0


def test_dispatch(monkeypatch):
    pos, _, masses = _system(40, seed=3)
    t_pos, t_m = torch.from_numpy(pos), torch.from_numpy(masses)
    torch.testing.assert_close(accelerations(t_pos, t_m),
                               pairwise_accelerations(t_pos, t_m))
    monkeypatch.setattr(port_forces, "PALLAS_MIN_N", 16)  # large-N branch
    _close(accelerations(t_pos, t_m), pairwise_accelerations(t_pos, t_m))
    _close(accelerations(t_pos[None].expand(2, -1, -1), t_m[None]
                         .expand(2, -1))[1], pairwise_accelerations(t_pos, t_m))
    # A device tensor above the cutoff goes to the symmetric CUDA kernel's
    # wrapper, one system at a time; there is no plain fallback, so on a
    # device that is not a card the wrapper refuses.
    with pytest.raises(ValueError, match="cuda or cpu"):
        accelerations(t_pos.to("meta"), t_m.to("meta"))
    calls = []
    monkeypatch.setattr(
        port_forces, "accelerations_symmetric",
        lambda p, m, s: calls.append(tuple(p.shape)) or torch.zeros_like(p))
    accelerations(t_pos.to("meta"), t_m.to("meta"))
    out = accelerations(torch.empty(3, 40, 3, device="meta"),
                        torch.empty(3, 40, device="meta"))
    assert calls == [(40, 3)] * 4 and out.shape == (3, 40, 3)
    accelerations(t_pos, t_m)  # CPU tensors keep the blocked form
    assert len(calls) == 4


@pytest.mark.parametrize("n_steps,save_interval", [(7, 3), (6, 2), (5, 1)])
def test_run_trajectory_matches_jax(n_steps, save_interval):
    pos, vel, masses = _system(16, seed=4)
    jstate = jax_make_state(pos, vel, masses)
    jstate = jstate._replace(accelerations=jforces.accelerations(
        jstate.positions, jstate.masses))
    want = jax_run_trajectory(jstate, 0.001, n_steps,
                              save_interval=save_interval)
    state = make_state(pos, vel, masses, device="cpu")
    state = state._replace(accelerations=accelerations(state.positions,
                                                       state.masses))
    got = run_trajectory(state, 0.001, n_steps, save_interval=save_interval)
    n_saves = 1 + n_steps // save_interval
    assert got.n_steps == n_saves and got.positions.shape == (n_saves, 16, 3)
    np.testing.assert_array_equal(got.steps.numpy(), np.asarray(want.steps))
    np.testing.assert_allclose(got.times.numpy(), np.asarray(want.times),
                               rtol=1e-6)
    for field in ("positions", "velocities", "accelerations"):
        _close(getattr(got, field), getattr(want, field))
    # the unsaved tail is integrated into .final
    assert int(got.final.step) == int(want.final.step) == n_steps
    _close(got.final.positions, want.final.positions)


def test_rollout_steps_equals_trajectory_final():
    pos, vel, masses = _system(20, seed=5)
    state = make_state(pos, vel, masses, device="cpu")
    state = state._replace(accelerations=accelerations(state.positions,
                                                       state.masses))
    final = rollout_steps(state, 0.001, 7)
    traj = run_trajectory(state, 0.001, 7, save_interval=3)
    assert torch.equal(final.positions, traj.final.positions)
    assert torch.equal(final.velocities, traj.final.velocities)
    assert int(final.step) == 7
    d = final.to_dict()
    assert d["step"] == 7 and d["positions"].shape == (20, 3)


def test_batched_state_has_per_system_clock():
    pos = np.zeros((4, 5, 3), np.float32)
    state = make_state(pos, pos, np.ones((4, 5)), time=0.5, device="cpu")
    assert state.time.shape == (4,) and state.step.shape == (4,)
    assert state.n_particles == 5
