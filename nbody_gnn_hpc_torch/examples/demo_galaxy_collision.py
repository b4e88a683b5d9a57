"""Demo: two colliding galaxies (port of ``examples/demo_galaxy_collision.py``;
reference ``nbody.py:305-337``).

    python -m nbody_gnn_hpc_torch.examples.demo_galaxy_collision \\
        [--per-galaxy 500] [--steps 300] [-o ./results/demo] [--gif]
    ... --device cpu   # the CPU, asked for

The scene draws from NumPy's global RNG, seeded 0 as the JAX demo seeds
it.  Below 1,024 particles a galaxy (N < 2,048) the forces take the plain
broadcast form on any device; from there on the card's symmetric force
kernel.  The plots need matplotlib (left out, and said so, without it).
The kernel launches are printed last.
"""

import argparse
import sys
from pathlib import Path

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--per-galaxy", type=int, default=500)
    parser.add_argument("--steps", type=int, default=300)
    parser.add_argument("-o", "--output-dir", default="./results/demo")
    parser.add_argument("--gif", action="store_true",
                        help="Also render an animation GIF")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' only when "
                             "asked for)")
    args = parser.parse_args(argv)

    from nbody_gnn_hpc_torch.ops import launch_line
    from nbody_gnn_hpc_torch.sim import NBodySimulator

    np.random.seed(0)
    sim = NBodySimulator.create_galaxy_collision(n_per_galaxy=args.per_galaxy,
                                                 device=args.device)
    print(f"Integrating {sim.n_particles} particles for {args.steps} "
          f"steps...")
    pos = sim.run_trajectory(args.steps).positions.cpu().numpy()

    try:
        from nbody_gnn_hpc_torch.utils import Visualizer

        viz = Visualizer(args.output_dir)
    except ImportError as e:
        print(f"(plotting skipped: {e})")
    else:
        viz.plot_trajectory_3d(pos, title="Galaxy Collision",
                               save_name="galaxy_collision.png", show=False)
        viz.plot_particle_distribution(
            pos, title="Final Distribution",
            save_name="galaxy_distribution.png", show=False)
        if args.gif:
            viz.create_animation(pos[::5], save_name="galaxy_collision.gif")
        print(f"Plots in {Path(args.output_dir)}")
    print(launch_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
