"""Multi-device readiness: the three data-parallel certification stages, the
hybrid-mesh certification, a replica-pool serving exercise and a DP
scaling table (port of ``nbody_gnn_hpc_tpu/parallel/smoke.py``).

The JAX functions run in one process over a device mesh.  Here a mesh is
ranks of a process group, so :func:`certify_multichip`,
:func:`certify_hybrid` and :func:`scaling_table` are called on EVERY rank
of an initialised group (:func:`~nbody_gnn_hpc_torch.parallel.mesh.
init_data_parallel`; ``python -m nbody_gnn_hpc_torch.multichip_smoke``
forms it) and rank 0 prints; :func:`replica_pool_exercise` is one process's
pool.  Each stage compares the mesh's result with the same work done by
this rank alone, on its own device: the 1-rank step.
"""

import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from nbody_gnn_hpc_torch.models import NBodyGNN
from nbody_gnn_hpc_torch.ops.knn import fully_connected_edge_index
from nbody_gnn_hpc_torch.parallel.datagen import simulate_ensemble
from nbody_gnn_hpc_torch.parallel.mesh import make_hybrid_mesh, make_mesh
from nbody_gnn_hpc_torch.parallel.train_dp import make_dp_train_step
from nbody_gnn_hpc_torch.sim.initial_conditions import shared_masses
from nbody_gnn_hpc_torch.train.schedule import make_step_schedule
from nbody_gnn_hpc_torch.train.steps import make_optimizer, make_train_step


def _say(*args) -> None:
    if dist.get_rank() == 0:
        print(*args, flush=True)


class _Problem:
    """A seeded model, optimizer, batch and generator seed: built the same
    on every rank, and again for each step compared."""

    def __init__(self, device, n_particles: int, batch: int, hidden: int,
                 layers: int, dropout: float, unit_stats: bool,
                 schedule: bool):
        self.device = torch.device(device)
        self.kw = dict(hidden_dim=hidden, n_layers=layers, dropout=dropout)
        self.schedule = schedule
        rng = np.random.RandomState(0)
        self.edge_index = fully_connected_edge_index(n_particles)
        as_dev = lambda a: torch.as_tensor(  # noqa: E731
            np.asarray(a, np.float32), device=self.device)
        self.masses = as_dev(rng.uniform(1e10, 1e12, n_particles))
        self.states = as_dev(rng.randn(batch, n_particles, 6))
        self.targets = as_dev(rng.randn(batch, n_particles, 6))
        flat = self.states.reshape(-1, 6)
        self.mean = torch.zeros(6) if unit_stats else flat.mean(0)
        self.std = torch.ones(6) if unit_stats else flat.std(0) + 1e-6
        self.mass_feat = (self.masses / self.masses.mean())[:, None]

    def model_and_optimizer(self):
        model = NBodyGNN(node_input_dim=7, output_dim=6,
                         generator=torch.Generator().manual_seed(0),
                         **self.kw).to(self.device)
        optimizer = make_optimizer(model, 5e-4, 1e-4)
        return model, optimizer

    def step_args(self, noise_std: float):
        kwargs = dict(noise_std=noise_std, masses=self.masses)
        if self.schedule:  # production: warm restarts over 10 steps/epoch
            kwargs["schedule"] = make_step_schedule(5e-4, steps_per_epoch=10)
        return (self.edge_index, self.mean, self.std, self.mass_feat), kwargs

    def generator(self):
        return torch.Generator(device=self.device).manual_seed(1)

    def dp_step(self, mesh, noise_std: float, impl: str = "gspmd"):
        """(loss, parameters) after one DP step over ``mesh``."""
        model, opt = self.model_and_optimizer()
        args, kwargs = self.step_args(noise_std)
        step = make_dp_train_step(model, opt, *args, mesh=mesh, impl=impl,
                                  **kwargs)
        loss = float(step(self.states, self.targets, self.generator()))
        return loss, [p.detach().cpu().numpy() for p in model.parameters()]

    def plain_step(self, noise_std: float):
        """(loss, parameters) after one step on this rank alone."""
        model, opt = self.model_and_optimizer()
        args, kwargs = self.step_args(noise_std)
        step = make_train_step(model, opt, *args, **kwargs)
        loss = float(step(self.states, self.targets, self.generator()))
        return loss, [p.detach().cpu().numpy() for p in model.parameters()]


def _ensemble_pair(mesh, n_sims: int, device):
    """Sharded and unsharded positions of ``n_sims`` systems of N=8 over 4
    steps (the JAX certification's ensemble)."""
    seeds = list(range(42, 42 + n_sims))
    sm = shared_masses(8, seed=42)
    kw = dict(box_size=5.0, dt=1e-3, shared_masses=sm, device=device)
    sharded = simulate_ensemble(seeds, 8, 4, mesh=mesh, **kw)
    alone = simulate_ensemble(seeds, 8, 4, **kw)
    return sharded.positions.cpu().numpy(), alone.positions.cpu().numpy()


def certify_multichip(n_devices: int, device=None) -> Dict[str, float]:
    """The three DP equivalence stages over ranks 0 .. n_devices - 1 (all
    must pass; every rank of the group calls it):

    1. the ``gspmd`` DP step == the 1-rank step, production model (hidden
       256, 6 layers, dropout 0.1, input noise on, clip + AdamW with the
       warm-restart schedule): loss to 1e-5, parameters rtol 1e-4;
    2. the ``shard_map`` DP step == the plain step, noise and dropout off:
       loss to 1e-6;
    3. the sharded ensemble (``n_devices + 1`` systems, so the padding
       runs) == the unsharded one, rtol 2e-5 / atol 1e-5.

    Returns the certified losses; raises AssertionError on a mismatch.
    """
    mesh = make_mesh(n_devices)
    dev = torch.device("cuda") if device is None else torch.device(device)
    if mesh.get_coordinate() is None:  # outside the mesh: nothing to do
        return {}
    prob = _Problem(dev, 16, 2 * n_devices, 256, 6, 0.1, unit_stats=False,
                    schedule=True)

    loss_n, p_n = prob.dp_step(mesh, noise_std=0.003)
    loss_1, p_1 = prob.plain_step(noise_std=0.003)
    assert np.isfinite(loss_n), f"non-finite loss: {loss_n}"
    assert abs(loss_n - loss_1) <= 1e-5 * abs(loss_1), \
        f"gspmd {n_devices}-rank loss {loss_n!r} != 1-rank loss {loss_1!r}"
    for a, b in zip(p_n, p_1):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    _say(f"certify({n_devices}): gspmd step ok, loss {loss_n:.6f} == "
         f"1-rank {loss_1:.6f}, params match")

    det = _Problem(dev, 16, 2 * n_devices, 256, 6, 0.0, unit_stats=False,
                   schedule=True)
    loss_sm, _ = det.dp_step(mesh, noise_std=0.0, impl="shard_map")
    loss_base, _ = det.plain_step(noise_std=0.0)
    assert abs(loss_sm - loss_base) <= 1e-6 * abs(loss_base), \
        f"shard_map loss {loss_sm!r} != single-rank {loss_base!r}"
    _say(f"certify({n_devices}): shard_map step ok, loss {loss_sm:.6f} == "
         f"single-rank {loss_base:.6f}")

    sharded, alone = _ensemble_pair(mesh, n_devices + 1, dev)
    assert np.isfinite(sharded).all()
    np.testing.assert_allclose(sharded, alone, rtol=2e-5, atol=1e-5)
    _say(f"certify({n_devices}): sharded ensemble ok, traj shape="
         f"{tuple(sharded.shape)} == unsharded ({n_devices + 1} sims)")
    return {"loss_gspmd": loss_n, "loss_1dev": loss_1,
            "loss_shard_map": loss_sm, "loss_base": loss_base,
            "n_ensemble_sims": float(n_devices + 1)}


def certify_hybrid(n_devices: int, n_slices: int = 2,
                   device=None) -> Dict[str, float]:
    """Multi-host readiness: the 2-D ``(dcn, data)`` mesh (``n_slices``
    contiguous groups of ranks standing in for hosts) reproduces the
    1-rank step for both DP impls and the unsharded ensemble.  A small
    model: this certifies the mesh plumbing.  Every rank calls it."""
    world = dist.get_world_size()
    if world != n_devices or n_devices % n_slices:
        raise ValueError(f"{n_devices} ranks (world {world}) not divisible "
                         f"into {n_slices} emulated slices")
    mesh = make_hybrid_mesh(n_slices=n_slices)
    assert tuple(mesh.mesh.shape) == (n_slices, n_devices // n_slices)
    dev = torch.device("cuda") if device is None else torch.device(device)
    prob = _Problem(dev, 6, 2 * n_devices, 32, 1, 0.0, unit_stats=True,
                    schedule=False)
    l_g, _ = prob.dp_step(mesh, noise_std=0.0)
    l_ref, _ = prob.plain_step(noise_std=0.0)
    assert abs(l_g - l_ref) <= 1e-5 * abs(l_ref), \
        f"hybrid gspmd loss {l_g!r} != 1-rank {l_ref!r}"
    l_sm, _ = prob.dp_step(mesh, noise_std=0.0, impl="shard_map")
    assert abs(l_sm - l_ref) <= 1e-6 * abs(l_ref), \
        f"hybrid shard_map loss {l_sm!r} != single-rank {l_ref!r}"
    sharded, alone = _ensemble_pair(mesh, n_devices + 1, dev)
    np.testing.assert_allclose(sharded, alone, rtol=2e-5, atol=1e-5)
    _say(f"certify_hybrid({n_devices}): (dcn={n_slices}, "
         f"data={n_devices // n_slices}) mesh ok — gspmd {l_g:.6f} == "
         f"1-rank, shard_map {l_sm:.6f} == plain, sharded ensemble == "
         f"unsharded ({n_devices + 1} sims)")
    return {"loss_gspmd": l_g, "loss_1dev": l_ref, "loss_shard_map": l_sm,
            "loss_base": l_ref}


def replica_pool_exercise(n_devices: int, tmpdir: str,
                          device=None) -> Dict[str, float]:
    """Serving smoke: a pool of ``n_devices`` replicas (one a GPU; CPU
    replicas with ``device="cpu"``), ``2 * n_devices`` concurrent rollouts
    from threads, every answer equal to the single service's (replicas
    share parameters; rollouts are deterministic)."""
    from nbody_gnn_hpc_torch.io.model_io import params_to_jax, save_checkpoint
    from nbody_gnn_hpc_torch.serve import build_replica_pool, build_service

    n_particles, k, steps = 12, 4, 6
    model = NBodyGNN(node_input_dim=7, hidden_dim=32, n_layers=1,
                     output_dim=6, dropout=0.0,
                     generator=torch.Generator().manual_seed(0))
    ckpt = Path(tmpdir) / "model.pt"
    save_checkpoint(ckpt, params=params_to_jax(model.state_dict()),
                    norm_stats={"state_mean": np.zeros(6, np.float32),
                                "state_std": np.ones(6, np.float32)})
    cfg = Path(tmpdir) / "config.json"
    cfg.write_text(
        '{"model_config": {"node_input_dim": 7, "hidden_dim": 32, '
        '"n_layers": 1, "output_dim": 6, "dropout": 0.0}, '
        '"training_config": {"k_neighbors": %d}}' % k)

    pool = build_replica_pool(str(ckpt), str(cfg), n_replicas=n_devices,
                              device=device)
    assert pool.model_info["replicas"] == n_devices
    single = build_service(str(ckpt), str(cfg), device=device)

    rng = np.random.RandomState(7)
    pos = rng.randn(n_particles, 3).astype(np.float32)
    vel = rng.randn(n_particles, 3).astype(np.float32)
    masses = rng.uniform(1e10, 1e12, n_particles).astype(np.float32)
    want = single.rollout(pos, vel, masses, steps)

    results: List[Optional[dict]] = [None] * (2 * n_devices)
    errors: List[BaseException] = []

    def worker(i):
        try:
            results[i] = pool.rollout(pos, vel, masses, steps)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    t0 = time.time()
    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(results))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.time() - t0
    if errors:
        raise errors[0]
    for got in results:
        for key in ("positions", "velocities"):
            np.testing.assert_allclose(np.asarray(got[key]),
                                       np.asarray(want[key]), rtol=1e-5,
                                       atol=1e-5)
    print(f"replica pool: {len(results)} concurrent rollouts over "
          f"{n_devices} replicas in {wall:.2f}s, all == single-service")
    return {"concurrent_rollouts": float(len(results)), "wall_s": wall}


def _timed(fn, reps: int, device: torch.device) -> float:
    """Seconds a call of ``fn`` after one untimed call; the result is read
    back (``float``), so the device's work is inside the time."""
    float(fn())
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    float(out)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) / reps


def scaling_table(n_devices: int, reps: int = 3, per_device_batch: int = 8,
                  device=None) -> List[Dict[str, float]]:
    """DP train-step throughput (``gspmd`` and ``shard_map``) and sharded
    ensemble throughput on meshes of 1, 2, 4, ... ``n_devices`` ranks
    (ranks outside a mesh wait), printed by rank 0 as a table.  The shapes
    are the JAX function's toy ones (N=16, hidden 256, 6 layers): on CPU
    ranks the numbers only exercise the code path.  Every rank calls it.
    """
    dev = torch.device("cuda") if device is None else torch.device(device)
    counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= n_devices]
    if counts[-1] != n_devices:
        counts.append(n_devices)
    rows = []
    for d in counts:
        mesh = make_mesh(d)
        if mesh.get_coordinate() is not None:
            prob = _Problem(dev, 16, per_device_batch * d, 256, 6, 0.1,
                            unit_stats=True, schedule=True)
            times = []
            for impl in ("gspmd", "shard_map"):
                model, opt = prob.model_and_optimizer()
                args, kwargs = prob.step_args(0.003)
                step = make_dp_train_step(model, opt, *args, mesh=mesh,
                                          impl=impl, **kwargs)
                gen = prob.generator()
                times.append(_timed(
                    lambda: step(prob.states, prob.targets, gen), reps, dev))
            seeds = list(range(42, 42 + 4 * d))
            sm = shared_masses(16, seed=42)
            t_gen = _timed(lambda: simulate_ensemble(
                seeds, 16, 32, box_size=5.0, dt=1e-3, shared_masses=sm,
                mesh=mesh, device=dev).positions[-1, -1, 0, 0], 1, dev)
            batch = per_device_batch * d
            rows.append({"devices": d, "global_batch": batch,
                         "gspmd_samples_s": batch / times[0],
                         "shard_map_samples_s": batch / times[1],
                         "datagen_sim_steps_s": len(seeds) * 32 / t_gen})
        dist.barrier()
    _say(f"\nDP scaling table (per-rank batch {per_device_batch}, {reps} "
         f"timed reps, N=16 toy shapes, {dev.type}):")
    _say(f"{'devs':>5} {'batch':>6} {'gspmd samp/s':>13} "
         f"{'shard_map samp/s':>17} {'datagen steps/s':>16}")
    for r in rows:
        _say(f"{r['devices']:>5} {r['global_batch']:>6} "
             f"{r['gspmd_samples_s']:>13.1f} "
             f"{r['shard_map_samples_s']:>17.1f} "
             f"{r['datagen_sim_steps_s']:>16.1f}")
    if rows:
        full = rows[-1]
        pick = ("gspmd" if full["gspmd_samples_s"]
                >= full["shard_map_samples_s"] else "shard_map")
        _say(f"faster DP impl at {full['devices']} ranks: {pick} (gspmd "
             f"{full['gspmd_samples_s']:.1f} vs shard_map "
             f"{full['shard_map_samples_s']:.1f} samples/s)")
    return rows


def rank_stages(rank: int, device, n_devices: int, reps: int,
                skip_scaling: bool) -> Tuple[List[str], Dict[str, float]]:
    """What every rank of ``multichip_smoke`` runs: the certification,
    the hybrid mesh where the world has 4+ ranks in pairs, the scaling
    table; returns the stage names and the certified losses."""
    del rank
    stages = []
    losses = certify_multichip(n_devices, device)
    stages.append("DP certification (gspmd == 1-rank, shard_map == plain, "
                  "sharded ensemble == unsharded)")
    if n_devices >= 4 and n_devices % 2 == 0:
        certify_hybrid(n_devices, n_slices=2, device=device)
        stages.append("multi-host hybrid mesh (2-slice (dcn, data) "
                      "emulation == single-rank)")
    if not skip_scaling:
        rows = scaling_table(n_devices, reps=reps, device=device)
        stages.append(f"DP scaling table ({len(rows)} mesh sizes, gspmd + "
                      f"shard_map + sharded datagen)")
    return stages, losses
