"""Demo: the parallelism layer, end to end (port of
``examples/demo_parallel.py``): sharded ensemble datagen, a data-parallel
training step and replica-pool serving.

    python -m nbody_gnn_hpc_torch.examples.demo_parallel [--virtual-devices K]
        [--particles 24] [--sims 16] [--steps 50]
    ... --device cpu   # the CPU, asked for

The JAX demo runs one process over a device mesh, and ``--virtual-devices
K`` makes K virtual CPU devices.  CUDA has no virtual devices, so here a
mesh is ranks of a process group: ``--virtual-devices K`` spawns K local
ranks (``parallel.run_local_world``, gloo; on the card they share it, as
NCCL refuses two ranks on one GPU), and 0, the default, is a world of one
in this process (NCCL on the card, gloo on the CPU).  Every rank runs

  1. ``simulate_ensemble(mesh=)`` over the mesh, against the unsharded
     run on the rank alone (rtol 2e-5, atol 1e-5);
  2. the ``gspmd`` data-parallel step (``make_dp_train_step``; the fully
     connected graph, hidden 32, 2 layers, dropout and input noise on,
     batch 2 a rank) against the one-device step on the whole batch (loss
     within 1e-5 relative);

and this process then serves the initial weights from a replica pool
(``build_replica_pool``: ``min(4, K)`` CPU replicas with ``--device cpu``,
one a GPU on the card), ``2 x replicas`` concurrent rollouts through
``RolloutClient``.  On the card the ranks run the ensemble force kernel and
the edge-stream kernels, the pool the edge stream.  The kernel launches of
this process and of its ranks, summed, are printed last.
"""

import argparse
import json
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

SPAWN_TIMEOUT_S = 900.0  # seconds the spawned ranks may take
MODEL_CONFIG = {"node_input_dim": 7, "hidden_dim": 32, "n_layers": 2,
                "output_dim": 6, "dropout": 0.1}


def demo_model():
    """The demo's model with its initial weights (seed 0)."""
    import torch

    from nbody_gnn_hpc_torch.models import NBodyGNN

    return NBodyGNN(generator=torch.Generator().manual_seed(0),
                    **MODEL_CONFIG)


def rank_sections(rank: int, device, n: int, n_sims: int, steps: int
                  ) -> dict:
    """Sections 1 and 2 on this rank of the initialised group; returns the
    figures rank 0 reports and this process's kernel launches."""
    del rank
    import torch
    import torch.distributed as dist

    from nbody_gnn_hpc_torch.ops import (fully_connected_edge_index,
                                         launch_counts)
    from nbody_gnn_hpc_torch.parallel import (make_dp_train_step, make_mesh,
                                              simulate_ensemble)
    from nbody_gnn_hpc_torch.sim import shared_masses
    from nbody_gnn_hpc_torch.train.steps import (make_optimizer,
                                                 make_train_step)

    world = dist.get_world_size()
    mesh = make_mesh()

    # -- 1. sharded ensemble datagen ---------------------------------------
    seeds = list(range(42, 42 + n_sims))
    masses = shared_masses(n, seed=42)
    kw = dict(box_size=10.0, dt=1e-3, shared_masses=masses, device=device)
    t0 = time.time()
    sharded = simulate_ensemble(seeds, n, steps, mesh=mesh, **kw
                                ).positions.cpu().numpy()
    t_mesh = time.time() - t0
    alone = simulate_ensemble(seeds, n, steps, **kw).positions.cpu().numpy()
    np.testing.assert_allclose(sharded, alone, rtol=2e-5, atol=1e-5)

    # -- 2. data-parallel training step ------------------------------------
    rng = np.random.RandomState(0)
    batch = 2 * world
    as_dev = lambda a: torch.as_tensor(  # noqa: E731
        np.asarray(a, np.float32), device=device)
    states = as_dev(rng.randn(batch, n, 6))
    targets = as_dev(rng.randn(batch, n, 6))
    m = as_dev(masses)
    args = (fully_connected_edge_index(n), torch.zeros(6), torch.ones(6),
            (m / m.mean())[:, None])

    def step_loss(make, **mesh_kw):
        model = demo_model().to(device)
        step = make(model, make_optimizer(model, 5e-4, 1e-4), *args,
                    noise_std=0.003, masses=m, **mesh_kw)
        gen = torch.Generator(device=device).manual_seed(1)
        return float(step(states, targets, gen))

    loss_n = step_loss(make_dp_train_step, mesh=mesh)
    loss_1 = step_loss(make_train_step)
    if not abs(loss_n - loss_1) <= 1e-5 * abs(loss_1):
        raise AssertionError(f"DP loss {loss_n!r} != 1-device {loss_1!r}")
    return {"world": world, "t_mesh": t_mesh, "batch": batch,
            "loss_n": loss_n, "loss_1": loss_1,
            "launches": launch_counts()}


def serve_pool(n_replicas: int, device, n: int) -> dict:
    """Section 3: the initial weights behind a pool of ``n_replicas``,
    ``2 x n_replicas`` concurrent rollouts of 5 steps."""
    from nbody_gnn_hpc_torch.client import RolloutClient
    from nbody_gnn_hpc_torch.io import params_to_jax, save_checkpoint
    from nbody_gnn_hpc_torch.serve import build_replica_pool, serve
    from nbody_gnn_hpc_torch.sim import shared_masses

    masses = shared_masses(n, seed=42)
    rng = np.random.RandomState(0)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        save_checkpoint(tmp / "model.pt",
                        params=params_to_jax(demo_model().state_dict()),
                        norm_stats={"state_mean": np.zeros(6, np.float32),
                                    "state_std": np.ones(6, np.float32)})
        (tmp / "config.json").write_text(json.dumps({
            "model_config": MODEL_CONFIG,
            "training_config": {"k_neighbors": 8}}))
        pool = build_replica_pool(str(tmp / "model.pt"),
                                  str(tmp / "config.json"),
                                  n_replicas=n_replicas,
                                  device="cpu" if device.type == "cpu"
                                  else None)
    httpd = serve(pool, host="127.0.0.1", port=0)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    client = RolloutClient(f"http://127.0.0.1:{httpd.server_address[1]}")

    n_req = 2 * pool.model_info["replicas"]
    results = [None] * n_req
    inputs = [(rng.randn(n, 3), rng.randn(n, 3)) for _ in range(n_req)]
    barrier = threading.Barrier(n_req)

    def work(i):
        barrier.wait()
        results[i] = client.rollout(*inputs[i], masses, 5)

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(n_req)]
    t0 = time.time()
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        httpd.shutdown()
        httpd.server_close()
    wall = time.time() - t0
    if not all(r is not None and r["positions"].shape == (6, n, 3)
               for r in results):
        raise AssertionError("a pooled rollout failed or has the wrong "
                             "shape")
    return {"n_req": n_req, "replicas": pool.model_info["replicas"],
            "wall": wall}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--virtual-devices", type=int, default=0,
                        help="Spawn this many local ranks (gloo) as the "
                             "mesh; 0: a world of one in this process")
    parser.add_argument("--particles", type=int, default=24)
    parser.add_argument("--sims", type=int, default=16)
    parser.add_argument("--steps", type=int, default=50)
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' only when "
                             "asked for)")
    args = parser.parse_args(argv)

    import torch
    import torch.distributed as dist

    from nbody_gnn_hpc_torch.device import resolve_device
    from nbody_gnn_hpc_torch.ops import LAUNCH_LINE, launch_counts
    from nbody_gnn_hpc_torch.parallel import (init_data_parallel,
                                              run_local_world)

    dev = resolve_device(args.device)
    sizes = (args.particles, args.sims, args.steps)
    if args.virtual_devices:
        world = args.virtual_devices
        print(f"devices: {world} x {dev.type} (spawned gloo ranks)")
        ranks = run_local_world(rank_sections, world, sizes,
                                device=dev.type, backend="gloo",
                                timeout=SPAWN_TIMEOUT_S)
    else:
        world = 1
        created = not dist.is_initialized()
        rank_dev = init_data_parallel(dev)
        print(f"devices: {world} x {dev.type} ({dist.get_backend()})")
        try:
            ranks = [rank_sections(0, rank_dev, *sizes)]
        finally:
            if created:
                dist.destroy_process_group()
    first = ranks[0]
    print(f"1. datagen: {args.sims} sims x {args.steps} steps sharded over "
          f"{world} devices in {first['t_mesh']:.2f}s — equals unsharded")
    print(f"2. DP train step: batch {first['batch']} sharded over {world} "
          f"devices, loss {first['loss_n']:.6f} == 1-device "
          f"{first['loss_1']:.6f}")

    visible = world if dev.type == "cpu" else torch.cuda.device_count()
    pooled = serve_pool(min(4, world, visible), dev, args.particles)
    print(f"3. serving DP: {pooled['n_req']} concurrent rollouts across "
          f"{pooled['replicas']} device-pinned replicas in "
          f"{pooled['wall']:.2f}s")
    print("All three parallel layers agree with their single-device "
          "equivalents.")
    counts = launch_counts()
    if args.virtual_devices:  # the spawned ranks counted in their processes
        for r in ranks:
            for key, v in r["launches"].items():
                counts[key] += v
    print(LAUNCH_LINE + json.dumps(counts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
