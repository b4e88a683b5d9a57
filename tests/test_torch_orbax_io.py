"""The port's async checkpoints (nbody_gnn_hpc_torch/io/orbax_io.py on
torch.distributed.checkpoint), ``Trainer(ckpt_backend="orbax")``,
``latest_checkpoint(backend="orbax")`` and ``train_model --ckpt-backend``
against the JAX package's, on the CPU.

Small sizes: N=8, k=3, hidden 8, one layer, batch 16 (the JAX package's
own orbax-backend test), on the windowed datasets of
``tests/test_dataset_trainer.py``.
"""

import json

import numpy as np
import pytest
import torch

from nbody_gnn_hpc_torch.io import latest_checkpoint
from nbody_gnn_hpc_torch.io.orbax_io import OrbaxCheckpointer, is_durable
from nbody_gnn_hpc_torch.models import NBodyGNN
from nbody_gnn_hpc_torch.parallel import run_local_world
from nbody_gnn_hpc_torch.train import GNNDataset, Trainer
from nbody_gnn_hpc_tpu.io import model_io as jmodel_io
from tests.test_dataset_trainer import dataset_paths  # noqa: F401 (fixture)

import torch_dp_ranks as ranks

pytestmark = pytest.mark.filterwarnings(
    "ignore:torch.distributed is disabled:UserWarning")


def _tree():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4)},
            "step": torch.tensor(7)}


# -- the checkpointer (tests/test_orbax_io.py's cases on torch tensors) -----


def test_async_save_restore_roundtrip(tmp_path):
    mgr = OrbaxCheckpointer(str(tmp_path / "ckpt"), max_to_keep=2)
    tree = _tree()
    assert mgr.save(0, tree, force=True)
    mgr.wait()
    like = {"params": {"w": torch.zeros(3, 4)}, "step": torch.tensor(0)}
    restored = mgr.restore(0, like=like)
    torch.testing.assert_close(restored["params"]["w"],
                               torch.arange(12.0).reshape(3, 4),
                               rtol=0, atol=0)
    assert int(restored["step"]) == 7
    flat = mgr.restore(0)  # no target: every entry by its dotted name
    assert set(flat) == {"params.w", "step"}
    assert torch.equal(flat["params.w"], tree["params"]["w"])

    # max_to_keep retention
    for s in (1, 2):
        mgr.save(s, tree, force=True)
    mgr.wait()
    assert mgr.latest_step() == 2
    assert mgr.all_steps() == [1, 2]
    assert mgr.pending == 0
    mgr.close()


def test_restore_latest_and_missing(tmp_path):
    mgr = OrbaxCheckpointer(str(tmp_path / "empty"))
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    mgr.close()


def test_saved_step_holds_save_time_values(tmp_path):
    """``save`` stages a copy before it returns: an optimizer step taken
    while the write is queued does not reach the saved step."""
    model = torch.nn.Linear(4, 3)
    opt = torch.optim.AdamW(model.parameters(), lr=0.1)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    mgr = OrbaxCheckpointer(str(tmp_path / "ckpt"))
    mgr.save(1, {"params": model.state_dict()})
    model(torch.ones(2, 4)).sum().backward()
    opt.step()
    assert not torch.equal(model.weight, before["weight"])
    mgr.wait()
    after = {k: v.clone() for k, v in model.state_dict().items()}
    restored = mgr.restore(1, like={"params": model.state_dict()})
    for k, v in before.items():
        assert torch.equal(restored["params"][k], v), k
        assert not torch.equal(v, after[k]), k
    mgr.close()


def test_torn_step_is_skipped_and_replaced(tmp_path):
    """A step directory without DCP's ``.metadata`` (a crash mid-write) is
    passed over; a save into its number removes it first; a durable step
    is never overwritten."""
    mgr = OrbaxCheckpointer(str(tmp_path / "ckpt"))
    mgr.save(1, _tree())
    mgr.wait()
    torn = tmp_path / "ckpt" / "2"
    torn.mkdir()
    (torn / "__0_0.distcp").write_bytes(b"half a write")
    (torn / ".metadata.tmp").write_bytes(b"")
    assert not is_durable(torn)
    assert mgr.latest_step() == 1 and mgr.all_steps() == [1]
    mgr.save(2, _tree())
    mgr.wait()
    assert mgr.all_steps() == [1, 2]
    assert sorted(p.name for p in torn.iterdir()) == [".metadata",
                                                      "__0_0.distcp"]
    with pytest.raises(FileExistsError):
        mgr.save(2, _tree())
    mgr.close()


def test_wait_raises_a_failed_write(tmp_path, monkeypatch):
    """A write that fails in the writer thread surfaces at ``wait``; the
    step stays not durable."""
    import torch.distributed.checkpoint as dcp

    def broken(*args, **kwargs):
        raise OSError("disk full")

    mgr = OrbaxCheckpointer(str(tmp_path / "ckpt"))
    monkeypatch.setattr(dcp, "save", broken)
    mgr.save(1, _tree())
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    assert mgr.latest_step() is None
    mgr.close()


# -- Trainer(ckpt_backend="orbax") against the pickle backend ---------------


def _port_trainer(dataset_paths, model_dir, backend):  # noqa: F811
    train, val = dataset_paths
    ds_train = GNNDataset(train, k_neighbors=3)
    ds_val = GNNDataset(val, k_neighbors=3,
                        external_norm_stats=ds_train.get_normalization_stats())
    return Trainer(NBodyGNN(hidden_dim=8, n_layers=1, dropout=0.0), ds_train,
                   ds_val, model_dir=str(model_dir), device="cpu",
                   batch_size=16, noise_std=0.0, seed=3, ckpt_backend=backend)


def _assert_same_state(a, b):
    for (name, p), q in zip(a.model.named_parameters(),
                            b.model.parameters()):
        assert torch.equal(p, q), name
    sa = a.optimizer.state_dict()["state"]
    sb = b.optimizer.state_dict()["state"]
    assert len(sa) == len(sb) == len(list(a.model.parameters()))
    for i, entry in sa.items():
        assert set(entry) == set(sb[i]) == {"step", "exp_avg", "exp_avg_sq"}
        for key, val in entry.items():
            assert torch.equal(val, sb[i][key]), (i, key)


def test_orbax_resume_matches_pickle(dataset_paths, tmp_path):  # noqa: F811
    """tests/test_orbax_backend.py's three checks: the same training under
    both backends; fresh trainers resume bit-equal, AdamW's moments
    included; the continuation is the same."""
    t_pickle = _port_trainer(dataset_paths, tmp_path / "pkl", "pickle")
    t_orbax = _port_trainer(dataset_paths, tmp_path / "obx", "orbax")
    h1 = t_pickle.train(n_epochs=2, early_stopping_patience=10,
                        save_every=10, verbose=False)
    h2 = t_orbax.train(n_epochs=2, early_stopping_patience=10,
                       save_every=10, verbose=False)
    np.testing.assert_allclose(h1["train_loss"], h2["train_loss"], rtol=1e-6)
    _assert_same_state(t_pickle, t_orbax)

    r_pickle = _port_trainer(dataset_paths, tmp_path / "pkl", "pickle")
    r_pickle.load_model("final_model.pt")
    r_orbax = _port_trainer(dataset_paths, tmp_path / "obx", "orbax")
    r_orbax.load_model("final_model.pt")
    _assert_same_state(r_pickle, r_orbax)
    _assert_same_state(r_orbax, t_orbax)
    assert r_pickle.current_epoch == r_orbax.current_epoch == 2
    assert r_pickle._step.count == r_orbax._step.count == t_orbax._step.count
    assert np.isclose(r_pickle.best_val_loss, r_orbax.best_val_loss)
    np.testing.assert_array_equal(r_pickle.norm_stats["state_mean"],
                                  r_orbax.norm_stats["state_mean"])
    assert r_orbax.history["train_loss"] == h2["train_loss"]

    np.testing.assert_allclose(r_pickle.train_epoch(), r_orbax.train_epoch(),
                               rtol=1e-6)


def test_orbax_index_matches_the_jax_trainers(dataset_paths,  # noqa: F811
                                              tmp_path):
    """The sidecar's labels and each entry's fields are the JAX
    ``Trainer(ckpt_backend="orbax")``'s on the same data (hidden 8, one
    layer, 2 epochs, save_every=1); its steps name durable directories."""
    pytest.importorskip("orbax.checkpoint")
    from nbody_gnn_hpc_tpu.models import NBodyGNN as JaxGNN
    from nbody_gnn_hpc_tpu.train import GNNDataset as JaxDataset
    from nbody_gnn_hpc_tpu.train import Trainer as JaxTrainer

    train, val = dataset_paths
    j_train = JaxDataset(train, k_neighbors=3)
    j_val = JaxDataset(val, k_neighbors=3,
                       external_norm_stats=j_train.get_normalization_stats())
    jax_trainer = JaxTrainer(
        JaxGNN(node_input_dim=7, hidden_dim=8, n_layers=1, output_dim=6,
               dropout=0.0, remat=False), j_train, j_val,
        model_dir=str(tmp_path / "jax"), batch_size=16, noise_std=0.0,
        seed=3, fast_prng=False, ckpt_backend="orbax")
    jax_trainer.train(n_epochs=2, early_stopping_patience=10, save_every=1,
                      verbose=False)
    port = _port_trainer(dataset_paths, tmp_path / "port", "orbax")
    port.train(n_epochs=2, early_stopping_patience=10, save_every=1,
               verbose=False)

    want = json.loads((tmp_path / "jax" / "orbax_index.json").read_text())
    got = json.loads((tmp_path / "port" / "orbax_index.json").read_text())
    assert set(got) == set(want) >= {"best_model.pt", "final_model.pt",
                                     "checkpoint_epoch_1.pt",
                                     "checkpoint_epoch_2.pt"}
    for label, entry in got.items():
        assert set(entry) == set(want[label]), label
        assert entry["scheduler_state_dict"] == \
            want[label]["scheduler_state_dict"], label
        assert set(entry["history"]) == set(want[label]["history"]), label
        assert set(entry["norm_stats"]) == set(want[label]["norm_stats"])
        np.testing.assert_allclose(entry["norm_stats"]["state_mean"],
                                   want[label]["norm_stats"]["state_mean"],
                                   rtol=1e-6)
        assert set(entry["model_config"]) == \
            set(want[label]["model_config"]) | {"edge_impl"}
        assert is_durable(tmp_path / "port" / "orbax" / str(entry["step"]))
    assert latest_checkpoint(tmp_path / "port", backend="orbax") == \
        jmodel_io.latest_checkpoint(tmp_path / "jax", backend="orbax") == \
        "final_model.pt"
    again = _port_trainer(dataset_paths, tmp_path / "port", "orbax")
    again.load_model("best_model.pt")
    assert np.isfinite(again.best_val_loss)


# -- latest_checkpoint(backend="orbax"): tests/test_checkpoint_io.py's
# fixtures, each with its own package's durability marker ------------------


def _durable_step(model_dir, step, package):
    d = model_dir / "orbax" / str(step)
    d.mkdir(parents=True, exist_ok=True)
    if package == "jax":
        (d / "_CHECKPOINT_METADATA").write_text("{}")
    else:
        (d / "__0_0.distcp").write_bytes(b"")
        (d / ".metadata").write_bytes(b"")


def _in_flight_step(model_dir, step, package):
    """What a crash mid-write leaves: Orbax's temporary directory, or DCP's
    step directory before ``.metadata`` is renamed into place."""
    if package == "jax":
        (model_dir / "orbax" / f"{step}.orbax-checkpoint-tmp-123").mkdir(
            parents=True)
    else:
        d = model_dir / "orbax" / str(step)
        d.mkdir(parents=True)
        (d / "__0_0.distcp").write_bytes(b"")
        (d / ".metadata.tmp").write_bytes(b"")


def _entry(step, epoch):
    return {"step": step, "scheduler_state_dict": {"epoch": epoch}}


FIXTURES = {
    "empty": (None, [], [], None),
    "durable": ({"best_model.pt": _entry(1, 7),
                 "checkpoint_epoch_10.pt": _entry(2, 10),
                 "selected_model.pt": _entry(3, 99)}, [1, 2, 3], [],
                "checkpoint_epoch_10.pt"),
    "non_durable": ({"best_model.pt": _entry(1, 7),
                     "final_model.pt": _entry(2, 12)}, [1], [2],
                    "best_model.pt"),
    "torn_json": ("{torn", [1, 2], [], None),
    "foreign_names": ({"selected_model.pt": _entry(1, 99),
                       "best_rollout_model.pt": _entry(2, 99)}, [1, 2], [],
                      None),
}


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_latest_checkpoint_orbax_equals_jax(tmp_path, name):
    index, durable, in_flight, expected = FIXTURES[name]
    answers = {}
    for package, latest in (("jax", jmodel_io.latest_checkpoint),
                            ("port", latest_checkpoint)):
        d = tmp_path / package
        d.mkdir()
        if index is not None:
            (d / "orbax_index.json").write_text(
                index if isinstance(index, str) else json.dumps(index))
        for step in durable:
            _durable_step(d, step, package)
        for step in in_flight:
            _in_flight_step(d, step, package)
        answers[package] = latest(d, backend="orbax")
    assert answers["port"] == answers["jax"] == expected


# -- data parallel: only the mesh's first rank writes ------------------------


def _dp_trajectories():
    r = np.random.RandomState(3)
    n_steps, n = 40, 8
    masses = r.rand(n).astype(np.float32) + 0.5
    return [{"positions": np.cumsum(r.randn(n_steps, n, 3), 0).astype(
                 np.float32),
             "velocities": r.randn(n_steps, n, 3).astype(np.float32),
             "masses": masses} for _ in range(2)]


def test_two_ranks_orbax_lead_writes_every_rank_reads(tmp_path):
    """Two gloo ranks share one model directory: rank 0 alone writes (no
    collective in the write, so nothing hangs), both restore the same
    parameters, equal to what they trained."""
    out = run_local_world(ranks.orbax_trainer, 2,
                          (_dp_trajectories(), str(tmp_path)), timeout=240.0)
    assert [(rank, wrote) for rank, wrote, *_ in out] == [(0, True),
                                                         (1, False)]
    for _, _, trained, restored, count in out:
        assert count == out[0][4] > 0
        for key, val in trained.items():
            assert torch.equal(restored[key], val), key
            assert torch.equal(restored[key], out[0][3][key]), key
    index = json.loads((tmp_path / "orbax_index.json").read_text())
    assert latest_checkpoint(tmp_path, backend="orbax") == "final_model.pt"
    last = index["final_model.pt"]["step"]
    assert sorted(int(p.name) for p in (tmp_path / "orbax").iterdir()
                  if is_durable(p)) == list(range(1, last + 1))


# -- the command ------------------------------------------------------------


def test_train_model_orbax_backend_resumes(tmp_path):
    """``train_model --ckpt-backend orbax`` writes the async checkpoints,
    the index and the history plot; ``--resume auto`` picks the durable
    final_model.pt and trains the remaining epoch."""
    from nbody_gnn_hpc_torch.config import TrainingConfig
    from nbody_gnn_hpc_torch.io.checkpoint import create_training_dataset
    from nbody_gnn_hpc_torch.train_model import main

    data = tmp_path / "data"
    data.mkdir()
    trajs = [dict(t, n_steps=t["positions"].shape[0])
             for t in _dp_trajectories()]
    for name, part in (("train", trajs), ("val", trajs[:1])):
        create_training_dataset(part, str(data / f"{name}_dataset.h5"),
                                TrainingConfig().sequence_length,
                                masses=trajs[0]["masses"])
    out = tmp_path / "models"
    flags = ["--device", "cpu", "--data-dir", str(data), "--model-dir",
             str(out), "--hidden-dim", "8", "--n-layers", "1",
             "--k-neighbors", "3", "-b", "16", "--ckpt-backend", "orbax"]
    assert main(flags + ["--epochs", "1"]) == 0
    assert not list(out.glob("*.pt"))
    index = json.loads((out / "orbax_index.json").read_text())
    assert set(index) == {"best_model.pt", "final_model.pt"}
    assert latest_checkpoint(out, backend="orbax") == "final_model.pt"

    assert main(flags + ["--epochs", "2", "--resume", "auto"]) == 0
    index = json.loads((out / "orbax_index.json").read_text())
    assert index["final_model.pt"]["scheduler_state_dict"]["epoch"] == 2
    assert index["final_model.pt"]["step"] > 2
    assert len(index["final_model.pt"]["history"]["train_loss"]) == 2
    pytest.importorskip("matplotlib")
    assert (out / "plots" / "training_history.png").stat().st_size > 0
