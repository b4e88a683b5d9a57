"""Data-parallel training through the port's entry points on the CPU:
``Trainer(mesh=)`` over 2 gloo ranks against ``Trainer(mesh=None)`` (as
``tests/test_trainer_mesh.py`` holds the JAX Trainer), ``train_model
--data-parallel --device cpu`` at world one, and ``multichip_smoke
--device cpu --world-size 2``.  Spawned ranks run with
``OMP_NUM_THREADS=1`` and join through a ``file://`` store within a time
limit.  Small shapes: N=8, hidden 32, 2 layers, batch 16.
"""

import json

import numpy as np
import pytest
import torch

from nbody_gnn_hpc_torch.parallel import run_local_world

import torch_dp_ranks as ranks

TIMEOUT = 240.0


def _trajectories():
    r = np.random.RandomState(3)
    n_steps, n = 40, 8
    masses = r.rand(n).astype(np.float32) + 0.5
    return [{"positions": np.cumsum(r.randn(n_steps, n, 3), 0).astype(
                 np.float32),
             "velocities": r.randn(n_steps, n, 3).astype(np.float32),
             "masses": masses} for _ in range(2)]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two epochs on 2 ranks and on one device, from one seed."""
    tmp = tmp_path_factory.mktemp("dp_trainer")
    dp = run_local_world(ranks.trainer_epochs, 2,
                         (_trajectories(), str(tmp / "dp"), 2),
                         timeout=TIMEOUT)
    from nbody_gnn_hpc_torch.models import NBodyGNN
    from nbody_gnn_hpc_torch.train import GNNDataset, Trainer

    trajs = _trajectories()
    ds = GNNDataset.from_trajectories(trajs, sequence_length=5, k_neighbors=3)
    val = GNNDataset.from_trajectories(
        trajs[:1], sequence_length=5, k_neighbors=3,
        external_norm_stats=ds.get_normalization_stats())
    trainer = Trainer(NBodyGNN(hidden_dim=32, n_layers=2, dropout=0.1), ds,
                      val, model_dir=str(tmp / "one"), device="cpu",
                      batch_size=16, seed=0)
    history = trainer.train(n_epochs=2, verbose=False)
    one = (history, trainer.step_losses,
           {k: v.detach().clone() for k, v in trainer.model.state_dict()
            .items()})
    return tmp, dp, one


def test_mesh_epochs_match_single_device(trained):
    """Same seed -> same permutation, noise and dropout; the step losses,
    the validation losses and the parameters agree to float32 rounding of
    the split gradient sums."""
    _, dp, (history, steps, params) = trained
    for rank_history, rank_steps, rank_params in dp:
        np.testing.assert_allclose(rank_steps, steps, rtol=1e-5)
        for key in ("train_loss", "val_loss", "energy_loss",
                    "momentum_loss"):
            np.testing.assert_allclose(rank_history[key], history[key],
                                       rtol=1e-5, err_msg=key)
        for name, want in params.items():
            np.testing.assert_allclose(rank_params[name].numpy(),
                                       want.numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=name)


def test_mesh_trainer_writes_from_its_first_rank_only(trained):
    tmp, dp, _ = trained
    assert not list((tmp / "dp" / "rank1").iterdir())
    written = sorted(p.name for p in (tmp / "dp" / "rank0").iterdir())
    assert written == sorted(p.name for p in (tmp / "one").iterdir())
    assert "best_model.pt" in written and "final_model.pt" in written
    from nbody_gnn_hpc_torch.io import load_checkpoint, params_from_jax

    saved = params_from_jax(load_checkpoint(
        tmp / "dp" / "rank0" / "final_model.pt")["model_state_dict"])
    for name, value in dp[0][2].items():
        assert torch.equal(torch.as_tensor(saved[name]), value), name


def test_mesh_trainer_refuses_a_batch_the_mesh_cannot_split():
    with pytest.raises(RuntimeError, match="does not split"):
        run_local_world(ranks.trainer_odd_batch, 2, (_trajectories(),),
                        timeout=TIMEOUT)


def test_train_model_data_parallel_at_world_one(tmp_path, capsys):
    """Without torchrun the command forms a world of one on the device it
    was given, says so, trains, and leaves no process group behind; its
    last line is still its kernel launches."""
    import torch.distributed as dist

    from nbody_gnn_hpc_torch.config import TrainingConfig
    from nbody_gnn_hpc_torch.io.checkpoint import create_training_dataset
    from nbody_gnn_hpc_torch.train_model import main

    data = tmp_path / "data"
    data.mkdir()
    trajs = [dict(t, n_steps=t["positions"].shape[0])
             for t in _trajectories()]
    for name, part in (("train", trajs), ("val", trajs[:1])):
        create_training_dataset(part, str(data / f"{name}_dataset.h5"),
                                TrainingConfig().sequence_length,
                                masses=trajs[0]["masses"])
    out = tmp_path / "models"
    assert main(["--data-parallel", "--device", "cpu", "--data-dir",
                 str(data), "--model-dir", str(out), "--hidden-dim", "32",
                 "--n-layers", "2", "--k-neighbors", "3", "-b", "8",
                 "--epochs", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert "  Data parallel:  1 ranks (gloo)" in lines
    assert lines[-1].startswith("Kernel launches: ")
    assert not dist.is_initialized()
    assert json.loads((out / "training_history.json").read_text())[
        "completed"]
    assert (out / "final_model.pt").exists()


def test_multichip_smoke_on_two_cpu_ranks(capsys):
    from nbody_gnn_hpc_torch.multichip_smoke import main

    assert main(["--device", "cpu", "--world-size", "2",
                 "--skip-scaling"]) == 0
    out = capsys.readouterr().out
    assert "multichip_smoke: 2-rank mesh on cpu (cpu, gloo)" in out
    assert "MULTICHIP SMOKE: ALL 2 STAGES PASSED" in out
    assert "replica pool: 4 concurrent rollouts over 2 replicas" in out
