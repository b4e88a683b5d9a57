"""What each rank of the data-parallel tests runs (tests/test_torch_parallel*.py).

A module of its own, importing only torch and the port: every spawned rank
imports it, and a test file would bring JAX into each of them.  Each
function is ``fn(rank, device, *args)`` for ``parallel.run_local_world``
and returns plain tensors and numbers, which the test compares in the
parent process.
"""

import torch

from nbody_gnn_hpc_torch.io.model_io import params_from_jax
from nbody_gnn_hpc_torch.models import NBodyGNN
from nbody_gnn_hpc_torch.models.gnn import BatchRows
from nbody_gnn_hpc_torch.parallel import (make_dp_train_step,
                                          make_hybrid_mesh, make_mesh,
                                          simulate_ensemble)
from nbody_gnn_hpc_torch.sim import shared_masses
from nbody_gnn_hpc_torch.train import make_optimizer, make_train_step

LR, WD = 5e-4, 1e-4


def _state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def split_step(base, parts: int):
    """A train step as ``parts`` ``gspmd`` ranks take it, in one process:
    each part's loss and gradient from the generator state the step starts
    with, divided by ``parts`` and added in rank order, then the update."""

    def step(states, targets, gen):
        b = states.shape[0]
        per = b // parts
        start = gen.get_state()
        flat = None
        for r in range(parts):
            gen.set_state(start)
            for p in base.params:
                p.grad = None
            loss, _ = base.compute_loss(states[r * per:(r + 1) * per],
                                        targets[r * per:(r + 1) * per], gen,
                                        rows=BatchRows(r * per, b))
            loss.backward()
            part = torch.cat([p.grad.reshape(-1) for p in base.params]
                             + [loss.detach().reshape(1)]) / parts
            flat = part if flat is None else flat + part
        offset = 0
        for p in base.params:
            p.grad = flat[offset:offset + p.numel()].view_as(p)
            offset += p.numel()
        base.update()
        return flat[-1].clone()

    return step


def dp_steps(problem, mesh, impl, edge_impl, jax_params=None, dropout=0.0,
             noise_std=0.0, n_steps=1, generator_seed=5,
             dtype=torch.float32, seen=None, split=0):
    """(losses, parameters) after ``n_steps`` DP steps over ``mesh`` (a
    ``make_mesh``-style mesh, or None for the single-device step, or with
    ``split`` > 0 :func:`split_step`) on ``problem``'s batches: weights
    from ``jax_params`` where given, else the port's seeded initialisation
    with a non-zero ``decoder_out``; the model computing in ``dtype``.
    ``seen``, a list, gets what each DP step all-reduces: (the flat
    buffer's dtype, the set of the parameters' gradient dtypes then)."""
    model = NBodyGNN(hidden_dim=problem["hidden"], n_layers=problem["layers"],
                     dropout=dropout, edge_impl=edge_impl, dtype=dtype,
                     generator=torch.Generator().manual_seed(0))
    if jax_params is not None:
        model.load_state_dict(params_from_jax(jax_params))
    else:
        with torch.no_grad():
            model.decoder_out.weight.normal_(
                0, 0.1, generator=torch.Generator().manual_seed(1))
    opt = make_optimizer(model, LR, WD)
    args = (model, opt, problem["edge_index"], problem["mean"],
            problem["std"], problem["mass_feat"])
    kwargs = dict(noise_std=noise_std,
                  masses=torch.from_numpy(problem["masses"]))
    if mesh is None:
        step = make_train_step(*args, **kwargs)
        if split:
            step = split_step(step, split)
    else:
        step = make_dp_train_step(*args, mesh=mesh, impl=impl, **kwargs)
        if seen is not None:
            reduce_mean = step.reduce_mean

            def recorded(flat):
                seen.append((flat.dtype,
                             {p.grad.dtype for p in step.base.params}))
                return reduce_mean(flat)

            step.reduce_mean = recorded
    gen = torch.Generator().manual_seed(generator_seed)
    losses = []
    for i in range(n_steps):
        s = torch.from_numpy(problem["states"][i])
        t = torch.from_numpy(problem["targets"][i])
        losses.append(float(step(s, t, gen)))
    return losses, _state(model)


def ensemble(mesh, n_sims):
    """Positions of ``n_sims`` systems of N=8 over 4 steps, sharded over
    ``mesh`` (None: on this rank alone)."""
    traj = simulate_ensemble(list(range(42, 42 + n_sims)), 8, 4, box_size=5.0,
                             dt=1e-3, shared_masses=shared_masses(8),
                             mesh=mesh, device="cpu")
    return traj.positions.clone()


def world_checks(rank, device, problem, jax_params=None):
    """The checks every world size runs: the ``gspmd`` step with noise and
    dropout on (two steps, both edge impls; and a bf16 model of each edge
    impl, with what its steps all-reduced under ``"bf16_reduced"`` and
    ``"bf16_full_reduced"``), the sharded ensemble
    of 9 systems; on 4 ranks the (dcn, data) hybrid mesh; with
    ``jax_params`` one step from those weights with noise and dropout off,
    both impls, both edge impls (under ``"jax"``)."""
    del rank, device
    mesh = make_mesh()
    seen, seen_full = [], []
    out = {"gspmd": {e: dp_steps(problem, mesh, "gspmd", e, dropout=0.1,
                                 noise_std=0.003, n_steps=2)
                     for e in ("fused", "fused_full")},
           "gspmd_bf16": dp_steps(problem, mesh, "gspmd", "fused",
                                  dropout=0.1, noise_std=0.003, n_steps=2,
                                  dtype=torch.bfloat16, seen=seen),
           "bf16_reduced": seen,
           "gspmd_bf16_full": dp_steps(problem, mesh, "gspmd", "fused_full",
                                       dropout=0.1, noise_std=0.003,
                                       n_steps=2, dtype=torch.bfloat16,
                                       seen=seen_full),
           "bf16_full_reduced": seen_full,
           "shard_map_noisy": dp_steps(problem, mesh, "shard_map", "fused",
                                       dropout=0.1, noise_std=0.003),
           "ensemble": ensemble(mesh, 9)}
    if jax_params is not None:
        out["jax"] = {(impl, e): dp_steps(problem, mesh, impl, e,
                                          jax_params=jax_params)
                      for impl in ("gspmd", "shard_map")
                      for e in ("fused", "fused_full")}
    if torch.distributed.get_world_size() == 4:
        hybrid = make_hybrid_mesh(n_slices=2)
        out["hybrid_shape"] = tuple(hybrid.mesh.shape)
        out["hybrid_names"] = tuple(hybrid.mesh_dim_names)
        out["hybrid_step"] = dp_steps(problem, hybrid, "gspmd", "fused",
                                      dropout=0.1, noise_std=0.003)
        out["hybrid_ensemble"] = ensemble(hybrid, 9)
    return out


def _mesh_trainer(trajectories, model_dir, batch_size,
                  ckpt_backend="pickle"):
    from nbody_gnn_hpc_torch.train import GNNDataset, Trainer

    ds = GNNDataset.from_trajectories(trajectories, sequence_length=5,
                                      k_neighbors=3)
    val = GNNDataset.from_trajectories(
        trajectories[:1], sequence_length=5, k_neighbors=3,
        external_norm_stats=ds.get_normalization_stats())
    model = NBodyGNN(hidden_dim=32, n_layers=2, dropout=0.1)
    return Trainer(model, ds, val, model_dir=model_dir, device="cpu",
                   batch_size=batch_size, seed=0, mesh=make_mesh(),
                   ckpt_backend=ckpt_backend)


def trainer_epochs(rank, device, trajectories, model_dir, epochs):
    """``Trainer(mesh=make_mesh())`` for ``epochs`` epochs: the history,
    the step losses and the parameters."""
    del device
    trainer = _mesh_trainer(trajectories, f"{model_dir}/rank{rank}", 16)
    history = trainer.train(n_epochs=epochs, verbose=False)
    return history, trainer.step_losses, _state(trainer.model)


def orbax_trainer(rank, device, trajectories, model_dir):
    """Two epochs of ``Trainer(mesh=, ckpt_backend="orbax")`` into one
    shared ``model_dir``, then a fresh trainer on each rank restores
    final_model.pt: whether this rank's trainer made a checkpointer while
    training (only the writer does), the trained and the restored
    parameters, and the restored step count."""
    del device
    trainer = _mesh_trainer(trajectories, model_dir, 16, "orbax")
    trainer.train(n_epochs=2, save_every=1, verbose=False)
    wrote = trainer._orbax is not None
    fresh = _mesh_trainer(trajectories, model_dir, 16, "orbax")
    fresh.load_model("final_model.pt")
    return (rank, wrote, _state(trainer.model), _state(fresh.model),
            fresh._step.count)


def trainer_odd_batch(rank, device, trajectories):
    """A Trainer whose batch of 15 cannot split over the ranks: raises."""
    del rank, device
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        _mesh_trainer(trajectories, tmp, 15)



def fail_on_rank_one(rank, device):
    del device
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    return rank
