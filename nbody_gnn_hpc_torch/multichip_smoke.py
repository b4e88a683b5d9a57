"""One-command multi-device readiness check (port of
``scripts/multichip_smoke.py``).

    torchrun --nproc-per-node K -m nbody_gnn_hpc_torch.multichip_smoke
    python -m nbody_gnn_hpc_torch.multichip_smoke --world-size K [--device cpu]
    python -m nbody_gnn_hpc_torch.multichip_smoke          # a world of one

Runs, over the ranks of a process group (torchrun's; or K ranks spawned on
this host, one a GPU with NCCL, or gloo ranks with ``--device cpu``; or
this process alone):

  1. the three DP certification stages (``gspmd`` step == 1-rank step with
     noise and dropout on; ``shard_map`` step == plain step; sharded
     ensemble == unsharded), :func:`~nbody_gnn_hpc_torch.parallel.smoke.
     certify_multichip`;
  2. with 4+ ranks in pairs, the 2-D (dcn, data) hybrid mesh, an emulated
     2-host layout, reproducing the 1-rank results;
  3. a replica pool of one replica a rank's device, concurrent rollouts, every
     answer equal to the single service's;
  4. a DP scaling table at 1, 2, 4, ... ranks (``--skip-scaling`` skips it).

Without a GPU and without ``--device cpu`` it raises.  It writes nothing
outside a temporary directory.
"""

import argparse
import sys
import tempfile
import time

SPAWN_TIMEOUT_S = 1800.0  # seconds the spawned ranks may take

def build_parser():
    parser = argparse.ArgumentParser(
        description="Multi-device readiness smoke (data parallel)")
    parser.add_argument("--world-size", type=int, default=None,
                        help="spawn this many ranks on this host (without "
                             "torchrun; default: a world of one)")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' only when "
                             "asked for, gloo ranks)")
    parser.add_argument("--reps", type=int, default=3,
                        help="timed reps per scaling-table cell")
    parser.add_argument("--skip-scaling", action="store_true",
                        help="skip the scaling-table stage")
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch
    import torch.distributed as dist

    from nbody_gnn_hpc_torch.device import resolve_device
    from nbody_gnn_hpc_torch.parallel.mesh import (init_data_parallel,
                                                   run_local_world)
    from nbody_gnn_hpc_torch.parallel.smoke import (rank_stages,
                                                    replica_pool_exercise)

    dev = resolve_device(args.device)  # raises without a card unasked
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kind = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    t0 = time.time()
    if args.world_size is None:  # torchrun's world, or this process alone
        created = not dist.is_initialized()
        rank_dev = init_data_parallel(dev)
        world, rank = dist.get_world_size(), dist.get_rank()
        if rank == 0:
            print(f"multichip_smoke: {world}-rank mesh on {dev.type} "
                  f"({kind}, {dist.get_backend()})", flush=True)
        try:
            stages, _ = rank_stages(rank, rank_dev, world, args.reps,
                                    args.skip_scaling)
        finally:
            if created:
                dist.destroy_process_group()
        if rank != 0:
            return 0
    else:
        world = args.world_size
        if dev.type == "cuda" and world > torch.cuda.device_count():
            raise ValueError(f"--world-size {world} but "
                             f"{torch.cuda.device_count()} GPUs visible")
        print(f"multichip_smoke: {world}-rank mesh on {dev.type} ({kind}, "
              f"{backend})", flush=True)
        results = run_local_world(rank_stages, world,
                                  (world, args.reps, args.skip_scaling),
                                  device=dev.type, backend=backend,
                                  timeout=SPAWN_TIMEOUT_S)
        stages = results[0][0]

    with tempfile.TemporaryDirectory() as tmp:
        replica_pool_exercise(world if dev.type == "cpu"
                              else min(world, torch.cuda.device_count()),
                              tmp, device=dev.type)
    stages.insert(len(stages) - (0 if args.skip_scaling else 1),
                  "replica-pool serving (concurrent rollouts == "
                  "single-service)")

    print(f"\nMULTICHIP SMOKE: ALL {len(stages)} STAGES PASSED "
          f"({time.time() - t0:.1f}s, {world} ranks, {dev.type})")
    for i, s in enumerate(stages, 1):
        print(f"  {i}. {s}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
