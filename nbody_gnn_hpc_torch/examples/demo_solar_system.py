"""Demo: the built-in solar-system scene (port of
``examples/demo_solar_system.py``; reference ``nbody.py:275-303``).

    python -m nbody_gnn_hpc_torch.examples.demo_solar_system \\
        [--days 365] [-o ./results/demo]
    ... --device cpu   # the CPU, asked for

Integrates the 9 bodies for one Earth year of simulated time (a day a
step), prints the relative energy drift and Earth's start and end, and
plots the trajectories where matplotlib imports.  The kernel launches are
printed last (none: 9 bodies take the plain force form).
"""

import argparse
import sys
from pathlib import Path


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--days", type=float, default=365.0)
    parser.add_argument("-o", "--output-dir", default="./results/demo")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' only when "
                             "asked for)")
    args = parser.parse_args(argv)

    from nbody_gnn_hpc_torch.ops import launch_line
    from nbody_gnn_hpc_torch.sim import NBodySimulator
    from nbody_gnn_hpc_torch.utils import compute_energy_error

    sim = NBodySimulator.create_solar_system(device=args.device)
    # One day per step (dt in seconds; the scene's units are SI).
    sim.dt = 86400.0
    n_steps = int(args.days)

    print(f"Integrating solar system for {n_steps} days...")
    traj = sim.run_trajectory(n_steps)
    pos = traj.positions.cpu().numpy()
    vel = traj.velocities.cpu().numpy()
    masses = traj.masses.cpu().numpy()

    _, max_err = compute_energy_error(pos, vel, masses)
    print(f"Relative energy drift over {n_steps} days: {max_err:.3e}")

    # Earth should complete ~days/365 of an orbit.
    earth = pos[:, 3] / 1.496e11  # AU
    print(f"Earth start: ({earth[0, 0]:.3f}, {earth[0, 1]:.3f}) AU, "
          f"end: ({earth[-1, 0]:.3f}, {earth[-1, 1]:.3f}) AU")

    try:
        from nbody_gnn_hpc_torch.utils import Visualizer

        viz = Visualizer(args.output_dir)
    except ImportError as e:
        print(f"(plotting skipped: {e})")
    else:
        viz.plot_trajectory_3d(pos, title="Solar System (1 year)",
                               save_name="solar_system.png", show=False)
        print(f"Plot: {Path(args.output_dir) / 'solar_system.png'}")
    print(launch_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
