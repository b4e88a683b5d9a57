"""The reference's stateful simulator surface over the port's functional
core (port of ``nbody_gnn_hpc_tpu/sim/simulator.py``).

``NBodySimulator`` keeps the reference's constructor, its
``step`` / ``run`` / ``get_state`` / ``set_state`` / ``get_energy`` surface
and its factory scenes (``src/hpc/nbody.py:133-337``), so reference callers
port unchanged.  The state is a :class:`SimState` on the device; forces go
through :func:`~nbody_gnn_hpc_torch.sim.forces.accelerations`, so on the
card a system of N >= ``PALLAS_MIN_N`` (2,048) steps through the symmetric
force kernel (kernel 6) and a smaller one through the broadcast form.
``run`` integrates on the device with no host sync between steps; with
``verbose`` it stops about ten times to read the energy back and print it,
as the reference prints.

``use_barnes_hut`` / ``theta`` are kept for the interface: the port, like
the JAX package, replaces the octree by exact all-pairs forces.
"""

import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from nbody_gnn_hpc_torch.device import SOFTENING
from nbody_gnn_hpc_torch.sim.energy import total_energy
from nbody_gnn_hpc_torch.sim.forces import accelerations
from nbody_gnn_hpc_torch.sim.initial_conditions import \
    random_initial_conditions
from nbody_gnn_hpc_torch.sim.integrator import (Trajectory, leapfrog_step,
                                                run_trajectory,
                                                run_trajectory_batch)
from nbody_gnn_hpc_torch.sim.state import SimState, make_state


def _host(t: torch.Tensor) -> np.ndarray:
    """A NumPy copy of ``t`` (never a view of a CPU tensor)."""
    return t.detach().cpu().numpy().copy()


class NBodySimulator:
    """N-body gravitational simulator (reference surface: ``nbody.py:133``).

    ``device``: cuda unless the CPU is asked for.  Differences from the
    reference are those of the JAX package: the state lives on the device
    in float32 by default, and Barnes-Hut is replaced by exact all-pairs
    forces (the flag is kept).
    """

    def __init__(self,
                 n_particles: int = 1000,
                 box_size: float = 1.0,
                 mass_range: Tuple[float, float] = (1e10, 1e12),
                 dt: float = 1e-3,
                 softening: float = SOFTENING,
                 use_barnes_hut: bool = False,
                 theta: float = 0.5,
                 seed: Optional[int] = None,
                 dtype=torch.float32,
                 device=None):
        self.n_particles = n_particles
        self.box_size = box_size
        self.dt = dt
        self.softening = softening
        self.use_barnes_hut = use_barnes_hut  # kept; forces are exact
        self.theta = theta                    # kept; unused (see below)
        if use_barnes_hut and theta != 0.5:
            # The reference's large-N path is a theta-controlled octree
            # approximation (barnes_hut.py:367-431); here it is exact
            # all-pairs, the theta -> 0 limit, so a theta changes nothing.
            warnings.warn(
                f"theta={theta} has no effect: the PyTorch port computes "
                "exact all-pairs forces in the Barnes-Hut regime "
                "(equivalent to theta=0, strictly more accurate). See "
                "nbody_gnn_hpc_torch/sim/forces.py.",
                UserWarning, stacklevel=2)
        self.seed = seed
        self.dtype = dtype

        positions, velocities, masses = random_initial_conditions(
            n_particles, box_size=box_size, mass_range=mass_range, seed=seed)
        self.state = make_state(positions, velocities, masses, device=device,
                                dtype=dtype)
        self.device = self.state.positions.device
        self.recompute_accelerations()
        self.history = []

    # -- array attributes (the reference's, nbody.py:179-184) ----------------

    def _as_field(self, value) -> torch.Tensor:
        return torch.as_tensor(np.asarray(value), dtype=self.dtype,
                               device=self.device)

    @property
    def positions(self) -> np.ndarray:
        return _host(self.state.positions)

    @positions.setter
    def positions(self, value) -> None:
        self.state = self.state._replace(positions=self._as_field(value))

    @property
    def velocities(self) -> np.ndarray:
        return _host(self.state.velocities)

    @velocities.setter
    def velocities(self, value) -> None:
        self.state = self.state._replace(velocities=self._as_field(value))

    @property
    def accelerations(self) -> np.ndarray:
        return _host(self.state.accelerations)

    @accelerations.setter
    def accelerations(self, value) -> None:
        self.state = self.state._replace(accelerations=self._as_field(value))

    @property
    def masses(self) -> np.ndarray:
        return _host(self.state.masses)

    @masses.setter
    def masses(self, value) -> None:
        """Mass override, as datagen and evaluation install shared masses
        (``generate_data.py:46``, ``evaluate.py:91``); callers then call
        :meth:`recompute_accelerations` (or assign ``accelerations``)."""
        self.state = self.state._replace(masses=self._as_field(value))

    @property
    def time(self) -> float:
        return float(self.state.time)

    @property
    def step_count(self) -> int:
        return int(self.state.step)

    # -- dynamics -----------------------------------------------------------

    @torch.inference_mode()
    def _compute_accelerations(self) -> np.ndarray:
        """Accelerations of the current positions and masses, on the host
        (``nbody.py:193-200``; callers use it after a mass override)."""
        return _host(accelerations(self.state.positions, self.state.masses,
                                   self.softening))

    @torch.inference_mode()
    def recompute_accelerations(self) -> None:
        self.state = self.state._replace(accelerations=accelerations(
            self.state.positions, self.state.masses, self.softening))

    @torch.inference_mode()
    def step(self) -> None:
        """One KDK leapfrog step (``nbody.py:202-218``)."""
        self.state = leapfrog_step(self.state, self.dt,
                                   softening=self.softening)

    def run(self, n_steps: int, save_interval: int = 1,
            verbose: bool = True) -> list:
        """Run ``n_steps``; returns the saved states as the reference's
        dicts and keeps them in ``history`` (``nbody.py:220-248``).  With
        ``verbose`` the energy is printed about every n_steps/10 steps, as
        the reference prints it (``nbody.py:243-245``)."""
        states = trajectory_to_states(self.run_trajectory(
            n_steps, save_interval=save_interval, verbose=verbose))
        self.history = states
        return states

    def run_trajectory(self, n_steps: int, save_interval: int = 1,
                       verbose: bool = False) -> Trajectory:
        """The run as one stacked :class:`Trajectory` of device tensors (no
        per-state host dicts); the simulator ends at the last step."""
        if not verbose:
            traj = run_trajectory(self.state, self.dt, n_steps,
                                  save_interval=save_interval,
                                  softening=self.softening)
            self._advance_to(traj)
            return traj

        # Chunks that are whole save intervals, so the saves fall at steps
        # k * save_interval across chunk boundaries (nbody.py:240); the last
        # chunk takes what remains, its partial interval integrated and not
        # saved.  Each chunk ends in one readback: the energy printed.
        base = max(save_interval,
                   (max(1, n_steps // 10) // save_interval) * save_interval)
        chunks = []
        done = 0
        while done < n_steps:
            todo = min(base, n_steps - done)
            traj = run_trajectory(self.state, self.dt, todo,
                                  save_interval=save_interval,
                                  softening=self.softening)
            self._advance_to(traj)
            done += todo
            energy = self.get_energy()
            print(f"Step {done}/{n_steps}, Time: {self.time:.4f}, "
                  f"Energy: {energy[2]:.6e}")
            chunks.append(traj)

        def joined(field):
            parts = [getattr(c, field) for c in chunks]
            return torch.cat([parts[0]] + [p[1:] for p in parts[1:]])

        return Trajectory(
            positions=joined("positions"), velocities=joined("velocities"),
            accelerations=joined("accelerations"), masses=chunks[0].masses,
            times=joined("times"), steps=joined("steps"),
            final=chunks[-1].final)

    def _advance_to(self, traj: Trajectory) -> None:
        # ``final`` includes the trailing partial save interval, integrated
        # but not saved (the reference advances every step, nbody.py:237-241).
        self.state = traj.final

    # -- state I/O (nbody.py:250-273) ---------------------------------------

    def get_state(self) -> dict:
        return self.state.to_dict()

    def set_state(self, state: dict) -> None:
        self.state = make_state(
            state["positions"], state["velocities"], state["masses"],
            accelerations=state["accelerations"],
            time=state.get("time", 0.0), step=state.get("step", 0),
            device=self.device, dtype=self.dtype)

    @torch.inference_mode()
    def get_energy(self) -> Tuple[float, float, float]:
        ke, pe, te = total_energy(self.state.positions, self.state.velocities,
                                  self.state.masses, self.softening)
        return float(ke), float(pe), float(te)

    # -- factory scenes (nbody.py:275-337) ----------------------------------

    @classmethod
    def create_solar_system(cls, scale: float = 1.0,
                            device=None) -> "NBodySimulator":
        """Sun and 8 planets on the x-axis with tangential velocities
        (``nbody.py:275-303``): masses in kg, distances AU -> m, speeds
        km/s -> m/s."""
        sim = cls(n_particles=9, box_size=50.0, dt=0.01, device=device)
        bodies = [
            ("Sun", 1.0, 0.0, 0.0),
            ("Mercury", 1.66e-7, 0.39, 47.87),
            ("Venus", 2.45e-6, 0.72, 35.02),
            ("Earth", 3.00e-6, 1.0, 29.78),
            ("Mars", 3.23e-7, 1.52, 24.07),
            ("Jupiter", 9.55e-4, 5.2, 13.07),
            ("Saturn", 2.86e-4, 9.58, 9.69),
            ("Uranus", 4.37e-5, 19.22, 6.81),
            ("Neptune", 5.15e-5, 30.05, 5.43),
        ]
        masses = np.array([b[1] for b in bodies]) * 1.989e30 * scale
        positions = np.zeros((9, 3))
        velocities = np.zeros((9, 3))
        for i, (_, _, dist, vel) in enumerate(bodies):
            positions[i, 0] = dist * 1.496e11 * scale
            velocities[i, 1] = vel * 1000.0 * scale
        sim.positions = positions
        sim.velocities = velocities
        sim.masses = masses
        sim.recompute_accelerations()
        return sim

    @classmethod
    def create_galaxy_collision(cls, n_per_galaxy: int = 500,
                                device=None) -> "NBodySimulator":
        """Two exponential disks on a collision course (``nbody.py:305-337``)
        with the reference's draws from NumPy's global RNG (unseeded).  At
        ``n_per_galaxy`` >= 1,024 (N >= 2,048) its forces run on the
        symmetric kernel on the card."""
        n_total = 2 * n_per_galaxy
        sim = cls(n_particles=n_total, box_size=100.0, dt=0.01,
                  device=device)

        positions = sim.positions
        velocities = sim.velocities

        theta1 = np.random.rand(n_per_galaxy) * 2 * np.pi
        r1 = np.random.exponential(5.0, n_per_galaxy)
        positions[:n_per_galaxy, 0] = -20 + r1 * np.cos(theta1)
        positions[:n_per_galaxy, 1] = r1 * np.sin(theta1)
        positions[:n_per_galaxy, 2] = np.random.randn(n_per_galaxy) * 0.5

        theta2 = np.random.rand(n_per_galaxy) * 2 * np.pi
        r2 = np.random.exponential(5.0, n_per_galaxy)
        positions[n_per_galaxy:, 0] = 20 + r2 * np.cos(theta2)
        positions[n_per_galaxy:, 1] = r2 * np.sin(theta2)
        positions[n_per_galaxy:, 2] = np.random.randn(n_per_galaxy) * 0.5

        velocities[:n_per_galaxy, 0] = 2.0
        velocities[n_per_galaxy:, 0] = -2.0

        # Circular rotation within galaxy 1 only, as the reference has it
        # (nbody.py:330-334).
        r = np.sqrt(positions[:n_per_galaxy, 0] ** 2
                    + positions[:n_per_galaxy, 1] ** 2)
        nz = r > 0
        velocities[:n_per_galaxy, 0][nz] += \
            -positions[:n_per_galaxy, 1][nz] / r[nz] * 0.5
        velocities[:n_per_galaxy, 1][nz] += \
            positions[:n_per_galaxy, 0][nz] / r[nz] * 0.5

        sim.positions = positions
        sim.velocities = velocities
        sim.recompute_accelerations()
        return sim


def run_parallel_simulations(configs: list, n_workers: int = None) -> list:
    """Run several simulations and return their state histories, in input
    order (reference surface ``nbody.py:340-362``, whose ``mp.Pool`` version
    cannot run, SURVEY §2 #25).

    Each config is ``{"init": NBodySimulator kwargs, "run": run kwargs}``.
    Configs that differ only in ``seed`` form a group; a group of two or
    more with ``n_steps`` and N <= ``SMALL_MAX_N`` runs as one ensemble, as
    :func:`~nbody_gnn_hpc_torch.parallel.simulate_ensemble` runs one: the
    stacked systems, their first accelerations included, step through
    :func:`~nbody_gnn_hpc_torch.parallel.datagen.ensemble_force` (kernel 4
    on the card).  Every other config runs alone.  ``n_workers`` is kept
    for the signature; no host workers are used.
    """
    del n_workers
    from nbody_gnn_hpc_torch.ops.pairwise import SMALL_MAX_N
    from nbody_gnn_hpc_torch.parallel.datagen import (ensemble_force,
                                                      trajectory_slice)

    results: list = [None] * len(configs)
    # Group by everything except the seed; an unhashable value keeps its
    # config out of every group.
    groups: dict = {}
    singles: list = []
    for idx, config in enumerate(configs):
        init = dict(config.get("init", {}))
        run_kw = dict(config.get("run", {}))
        run_kw.pop("verbose", None)
        init.pop("seed", None)
        try:
            key = (tuple(sorted(init.items())), tuple(sorted(run_kw.items())))
            hash(key)
        except TypeError:
            singles.append(idx)
            continue
        groups.setdefault(key, []).append(idx)

    for key, idxs in groups.items():
        run_kw = dict(key[1])
        n_particles = dict(key[0]).get("n_particles", 1000)
        if (len(idxs) < 2 or "n_steps" not in run_kw
                or n_particles > SMALL_MAX_N):
            singles.extend(idxs)
            continue
        sims = [NBodySimulator(**configs[i].get("init", {})) for i in idxs]
        state = SimState(*(torch.stack(fields) for fields in
                           zip(*(s.state for s in sims))))
        first = sims[0]
        force = ensemble_force(first.device, n_particles)
        with torch.inference_mode():
            state = state._replace(accelerations=force(
                state.positions, state.masses, first.softening))
        traj = run_trajectory_batch(state, first.dt, run_kw["n_steps"],
                                    run_kw.get("save_interval", 1),
                                    first.softening, accel_fn=force)
        for slot, i in enumerate(idxs):
            results[i] = trajectory_to_states(trajectory_slice(traj, slot))

    for idx in singles:
        config = configs[idx]
        sim = NBodySimulator(**config.get("init", {}))
        results[idx] = sim.run(**{"verbose": False, **config.get("run", {})})
    return results


def trajectory_to_states(traj: Trajectory) -> list:
    """A stacked :class:`Trajectory` as the reference's list of state dicts
    (``nbody.py:232-248``), one readback a field."""
    positions = _host(traj.positions)
    velocities = _host(traj.velocities)
    accelerations_ = _host(traj.accelerations)
    masses = _host(traj.masses)
    times = _host(traj.times)
    steps = _host(traj.steps)
    return [
        {
            "positions": positions[t],
            "velocities": velocities[t],
            "accelerations": accelerations_[t],
            "masses": masses,
            "time": float(times[t]),
            "step": int(steps[t]),
        }
        for t in range(positions.shape[0])
    ]
