"""Large-N step benchmark, the reference's Barnes-Hut regime (port of
``scripts/benchmark_bh_temp.py``; reference ``scripts/benchmark_bh_temp.py``).

    python -m nbody_gnn_hpc_torch.benchmark_bh_temp [-n 5000] [--steps 5]
    ... --device cpu   # the CPU, asked for

The JAX script's lines: the initialization time, one warm-up step, then
``--steps`` rounds of 50 chained KDK steps of ``NBodySimulator(n,
use_barnes_hut=True)`` through ``rollout_steps``, each round's time a step
and the average with its pair rate (N^2 pairs a step).  The octree is
replaced by exact all-pairs forces: from ``PALLAS_MIN_N`` = 2,048 particles
on, every force evaluation on the card is one launch of the symmetric force
kernel (``sim/forces.py``).  Each timed region ends in
``torch.cuda.synchronize``.  The kernel launches are printed last.
"""

import argparse
import sys
import time

CHUNK = 50  # chained steps a timed round


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Benchmark large-N step")
    parser.add_argument("-n", "--particles", type=int, default=5000)
    parser.add_argument("--steps", type=int, default=5)
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' only when "
                             "asked for)")
    args = parser.parse_args(argv)

    import torch

    from nbody_gnn_hpc_torch.device import resolve_device
    from nbody_gnn_hpc_torch.ops import launch_line
    from nbody_gnn_hpc_torch.sim import NBodySimulator, rollout_steps

    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    print(f"Benchmarking blocked all-pairs (BH-equivalent regime) with "
          f"N={args.particles} on {name}...")

    t0 = time.perf_counter()
    sim = NBodySimulator(n_particles=args.particles, use_barnes_hut=True,
                         device=dev)
    sync()
    print(f"Initialization: {time.perf_counter() - t0:.2f}s")

    print("Warming up (building the kernels)...")
    t_warm = time.perf_counter()
    state = rollout_steps(sim.state, sim.dt, 1)
    sync()
    print(f"Warmup step: {time.perf_counter() - t_warm:.2f}s")

    state = rollout_steps(state, sim.dt, CHUNK)  # one untimed round
    sync()

    times = []
    print("Measuring...")
    for i in range(args.steps):
        start = time.perf_counter()
        state = rollout_steps(state, sim.dt, CHUNK)
        sync()
        dt = (time.perf_counter() - start) / CHUNK
        times.append(dt)
        print(f"Round {i + 1} ({CHUNK} steps): {dt * 1000:.5f} ms/step")

    avg_step = sum(times) / len(times)
    print(f"Average step time: {avg_step:.8f}s "
          f"({args.particles ** 2 / avg_step / 1e9:.2f} Gpairs/s)")
    print(launch_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
