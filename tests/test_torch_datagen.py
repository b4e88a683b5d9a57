"""The port's simulator side (energy diagnostics, batched integrator,
ensemble datagen, trajectory/dataset files, the generate_data CLI) against
the JAX package's, at a small size on the CPU.

Trajectory comparisons are over short horizons (12 steps) at 1e-5 of each
field's scale: both sides integrate in float32 and differ in summation
order only; the system is chaotic, so long horizons would not agree.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_gnn_hpc_torch import generate_data
from nbody_gnn_hpc_torch.io import (CheckpointManager, create_training_dataset,
                                    h5_compression_kwargs)
from nbody_gnn_hpc_torch.ops import SMALL_MAX_N
from nbody_gnn_hpc_torch.parallel import (build_ensemble_state,
                                          fetch_host_trajectory,
                                          simulate_ensemble, trajectory_slice)
from nbody_gnn_hpc_torch.parallel.datagen import ensemble_force
from nbody_gnn_hpc_torch.sim import (accelerations, kinetic_energy,
                                     potential_energy, run_trajectory,
                                     run_trajectory_batch, shared_masses,
                                     total_energy, total_momentum)
from nbody_gnn_hpc_torch.sim import energy as port_energy
from nbody_gnn_hpc_torch.train import (GNNDataset, datasets_from_manifest,
                                       write_manifest)
from nbody_gnn_hpc_torch.utils import StageTimer
from nbody_gnn_hpc_tpu.io import CheckpointManager as JaxCheckpointManager
from nbody_gnn_hpc_tpu.io import \
    create_training_dataset as jax_create_training_dataset
from nbody_gnn_hpc_tpu.parallel import \
    build_ensemble_state as jax_build_ensemble_state
from nbody_gnn_hpc_tpu.parallel import \
    simulate_ensemble as jax_simulate_ensemble
from nbody_gnn_hpc_tpu.sim import energy as jax_energy
from nbody_gnn_hpc_tpu.sim.integrator import \
    run_trajectory_batch as jax_run_trajectory_batch
from nbody_gnn_hpc_tpu.train import GNNDataset as JaxGNNDataset
from nbody_gnn_hpc_tpu.train import \
    datasets_from_manifest as jax_datasets_from_manifest

SEEDS, N, STEPS = [42, 43, 44, 45], 12, 12
FIELDS = ("positions", "velocities", "accelerations")


def _close(got, want, tol=1e-5):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * np.abs(want).max())


def _state(seed=0, n=45, batch=None):
    rng = np.random.RandomState(seed)
    shape = (n,) if batch is None else (batch, n)
    return (((rng.rand(*shape, 3) - 0.5) * 10).astype(np.float32),
            (rng.rand(*shape, 3) - 0.5).astype(np.float32),
            rng.uniform(1e10, 1e12, shape).astype(np.float32))


# -- energy diagnostics -------------------------------------------------------

@pytest.mark.parametrize("batch", [None, 3])
def test_energy_matches_jax(batch):
    pos, vel, m = _state(1, batch=batch)
    t = torch.from_numpy
    ke, pe, te = total_energy(t(pos), t(vel), t(m))
    jke, jpe, jte = jax_energy.total_energy(jnp.asarray(pos),
                                            jnp.asarray(vel), jnp.asarray(m))
    for got, want in ((ke, jke), (pe, jpe), (te, jte)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(
        total_momentum(t(vel), t(m)).numpy(),
        np.asarray(jax_energy.total_momentum(jnp.asarray(vel),
                                             jnp.asarray(m))), rtol=1e-5)
    assert torch.equal(ke, kinetic_energy(t(vel), t(m)))


@pytest.mark.parametrize("batch", [None, 2])
def test_blocked_potential_matches_jax_and_dense(monkeypatch, batch):
    pos, _, m = _state(2, n=45, batch=batch)
    t = torch.from_numpy
    dense = potential_energy(t(pos), t(m))
    monkeypatch.setattr(port_energy, "BLOCKED_MIN_N", 16)
    monkeypatch.setattr(port_energy, "PE_BLOCK", 16)  # ragged last block
    blocked = potential_energy(t(pos), t(m))
    np.testing.assert_allclose(blocked.numpy(), dense.numpy(), rtol=1e-5)
    want = jax_energy._potential_energy_blocked(jnp.asarray(pos),
                                                jnp.asarray(m))
    np.testing.assert_allclose(blocked.numpy(), np.asarray(want), rtol=1e-5)


def test_potential_energy_at_heavy_shared_masses():
    """The mean-mass scaling keeps m_i * m_j (1e44 here) out of float32
    overflow; shared (N,) masses broadcast over the batch."""
    pos, _, _ = _state(3, n=20, batch=2)
    m = np.full(20, 1e22, np.float32)
    pe = potential_energy(torch.from_numpy(pos), torch.from_numpy(m))
    want = jax_energy.potential_energy(jnp.asarray(pos), jnp.asarray(m))
    assert pe.shape == (2,) and torch.isfinite(pe).all()
    np.testing.assert_allclose(pe.numpy(), np.asarray(want), rtol=1e-5)


# -- batched integrator and ensemble ------------------------------------------

def _system_of(state, i):
    """System ``i`` of a batched SimState."""
    return type(state)(*(f[i] for f in state))


@pytest.mark.parametrize("save_interval", [1, 5])
def test_run_trajectory_batch_matches_jax(save_interval):
    masses = shared_masses(N)
    jstate = jax_build_ensemble_state(SEEDS, N, 10.0, masses)
    want = jax_run_trajectory_batch(jstate, 0.001, STEPS, save_interval, 1e-9)
    state = build_ensemble_state(SEEDS, N, 10.0, masses, device="cpu")
    got = run_trajectory_batch(state, 0.001, STEPS, save_interval)
    n_saves = 1 + STEPS // save_interval
    assert got.positions.shape == (4, n_saves, N, 3)
    assert got.masses.shape == (4, N) and got.times.shape == (4, n_saves)
    np.testing.assert_array_equal(got.steps.numpy(), np.asarray(want.steps))
    np.testing.assert_allclose(got.times.numpy(), np.asarray(want.times),
                               rtol=1e-5)
    for f in FIELDS:
        _close(getattr(got, f), getattr(want, f))
        _close(getattr(got.final, f), getattr(want.final, f))
    # initial state first; the unsaved tail is integrated into .final
    assert torch.equal(got.positions[:, 0], state.positions)
    assert got.final.step.tolist() == [STEPS] * 4
    # each system equals its own unbatched run
    single = run_trajectory(_system_of(state, 2), 0.001, STEPS, save_interval)
    _close(got.positions[2], single.positions.numpy(), tol=1e-6)


def test_run_trajectory_batch_refuses_an_unbatched_state():
    state = build_ensemble_state(SEEDS, N, 10.0, device="cpu")
    with pytest.raises(ValueError, match="batched"):
        run_trajectory_batch(_system_of(state, 0), 0.001, 2)


@pytest.mark.parametrize("save_interval", [1, 5])
def test_simulate_ensemble_matches_jax(save_interval):
    masses = shared_masses(N)
    want = jax_simulate_ensemble(SEEDS, N, STEPS, save_interval=save_interval,
                                 shared_masses=masses)
    got = simulate_ensemble(SEEDS, N, STEPS, save_interval=save_interval,
                            shared_masses=masses, device="cpu")
    for f in FIELDS:
        _close(getattr(got, f), getattr(want, f))
    _close(got.masses, want.masses, tol=0)
    host = fetch_host_trajectory(got)
    assert isinstance(host.positions, np.ndarray)
    assert isinstance(host.final.velocities, np.ndarray)
    sl = trajectory_slice(host, 3)
    assert sl.positions.shape == (1 + STEPS // save_interval, N, 3)
    assert sl.masses.shape == (N,) and sl.final.positions.shape == (N, 3)
    np.testing.assert_array_equal(sl.velocities, host.velocities[3])


def test_simulate_ensemble_per_sim_masses_and_custom_force():
    """Without shared masses each sim keeps its own draw; ``accel_fn`` is
    the force of the whole batch."""
    calls = []

    def force(p, m, softening=1e-9):
        calls.append(tuple(p.shape))
        return accelerations(p, m, softening)

    got = simulate_ensemble(SEEDS[:2], N, 3, device="cpu", accel_fn=force)
    want = jax_simulate_ensemble(SEEDS[:2], N, 3)
    _close(got.positions, want.positions)
    assert not torch.equal(got.masses[0], got.masses[1])
    assert calls == [(2, N, 3)] * 4  # the initial force + one per step


@pytest.mark.parametrize("device,n,want", [
    ("cpu", 200, "accelerations"),
    ("cuda", 200, "accelerations_small"),
    ("cuda", SMALL_MAX_N, "accelerations_small"),
    ("cuda", SMALL_MAX_N + 1, "accelerations")])
def test_ensemble_force_choice(device, n, want):
    """One launch of kernel 4 for the whole ensemble where a system fits
    its block and the tensors are on the card; the dispatch elsewhere."""
    assert ensemble_force(torch.device(device), n).__name__ == want


def test_simulate_ensemble_refuses_what_is_not_ported():
    # The mesh is ported (tests/test_torch_parallel.py holds it); the JAX
    # function's TPU layouts are not.
    with pytest.raises(TypeError, match="layout"):
        simulate_ensemble(SEEDS, N, 2, layout="planes", device="cpu")


# -- files: both packages read what the other wrote -----------------------------

@pytest.fixture(scope="module")
def ensemble():
    return fetch_host_trajectory(simulate_ensemble(
        SEEDS, N, STEPS, shared_masses=shared_masses(N), device="cpu"))


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_trajectory_files_cross_load(tmp_path, ensemble, writer, reader):
    managers = {"port": CheckpointManager(str(tmp_path)),
                "jax": JaxCheckpointManager(str(tmp_path))}
    sl = trajectory_slice(ensemble, 1)
    if writer == "port":  # the port also takes tensors, on any device
        sl = sl._replace(positions=torch.from_numpy(sl.positions))
    managers[writer].save_trajectory(sl, "sim_0001",
                                     metadata={"seed": 43, "tags": [1, 2]},
                                     compression="lzf")
    assert managers[reader].trajectory_exists("sim_0001")
    back = managers[reader].load_trajectory("sim_0001")
    assert back["positions"].dtype == np.float64  # the reference's schema
    assert back["n_steps"] == STEPS + 1
    assert back["metadata"] == {"seed": 43, "tags": [1, 2]}
    for f in FIELDS + ("times", "steps", "masses"):
        np.testing.assert_array_equal(back[f],
                                      np.asarray(getattr(ensemble, f)[1]))
    assert managers[reader].list_checkpoints() == ["sim_0001 (trajectory)"]
    assert managers[reader].delete_checkpoint("sim_0001")
    with pytest.raises(FileNotFoundError):
        managers[reader].load_trajectory("sim_0001")


@pytest.mark.parametrize("fmt", ["hdf5", "npz"])
@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_state_files_cross_load(tmp_path, fmt, writer, reader):
    managers = {"port": CheckpointManager(str(tmp_path), format=fmt),
                "jax": JaxCheckpointManager(str(tmp_path), format=fmt)}
    pos, vel, m = _state(5, n=7)
    state = {"positions": pos, "velocities": vel, "masses": m, "time": 0.25,
             "step": 250}
    managers[writer].save_state(state, "snap", metadata={"note": "x"})
    back = managers[reader].load_state("snap")
    for key in ("positions", "velocities", "masses"):
        np.testing.assert_array_equal(back[key], state[key])
    assert back["time"] == 0.25 and back["step"] == 250
    assert back["metadata"] == {"note": "x"}
    with pytest.raises(FileNotFoundError):
        managers[reader].load_state("missing")


def _trajectory_dicts(ensemble):
    return [{"positions": ensemble.positions[i],
             "velocities": ensemble.velocities[i],
             "masses": ensemble.masses[i],
             "n_steps": ensemble.positions.shape[1]}
            for i in range(len(SEEDS))]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_training_dataset_files_cross_load(tmp_path, ensemble, writer):
    trajs = _trajectory_dicts(ensemble)
    create = {"port": create_training_dataset,
              "jax": jax_create_training_dataset}[writer]
    path = create(trajs, str(tmp_path / "train_dataset.h5"),
                  sequence_length=3, masses=ensemble.masses[0],
                  compression="none")
    kw = dict(sequence_length=3, k_neighbors=4)
    port, jaxds = GNNDataset(path, **kw), JaxGNNDataset(path, **kw)
    direct = GNNDataset.from_trajectories(trajs, **kw)
    assert port.n_samples == jaxds.n_samples == 4 * (STEPS + 1 - 3)
    for ds in (jaxds, direct):
        np.testing.assert_array_equal(port.last_states, ds.last_states)
        np.testing.assert_array_equal(port.targets, ds.targets)
        np.testing.assert_array_equal(port.masses, ds.masses)
        np.testing.assert_allclose(port.state_mean, ds.state_mean, rtol=1e-6)


def test_dataset_writer_and_codec_checks(tmp_path, ensemble):
    assert h5_compression_kwargs("gzip", 1) == {"compression": "gzip",
                                                "compression_opts": 1}
    assert h5_compression_kwargs("lzf") == {"compression": "lzf"}
    assert h5_compression_kwargs("none") == {}
    with pytest.raises(ValueError, match="compression"):
        h5_compression_kwargs("zstd")
    with pytest.raises(ValueError, match="No samples"):
        create_training_dataset(_trajectory_dicts(ensemble),
                                str(tmp_path / "d.h5"), sequence_length=50)


def test_stage_timer_accumulates():
    timer = StageTimer()
    for _ in range(2):
        with timer.stage("a"):
            pass
    with pytest.raises(RuntimeError):
        with timer.stage("b"):
            raise RuntimeError
    assert set(timer.times) == {"a", "b"}
    report = timer.report()
    assert report.splitlines()[0].startswith("stage")
    assert report.splitlines()[-1].startswith("total")


# -- the generate_data command ------------------------------------------------

CLI = ["-n", str(N), "-s", "5", "--steps", str(STEPS), "--sequence-length",
       "3", "--batch-size", "2", "--compression", "lzf", "--device", "cpu"]


def test_generate_data_cli_writes_resumes_and_matches_jax(tmp_path, capsys):
    out = tmp_path / "data"
    assert generate_data.main(CLI + ["-o", str(out)]) == 0
    names = [f"sim_{i:04d}" for i in range(5)]
    manager = JaxCheckpointManager(str(out / "checkpoints"))
    assert all(manager.trajectory_exists(n) for n in names)
    # the protocol: shared masses from --seed, sim i seeded seed + i
    want = jax_simulate_ensemble([42 + i for i in range(5)], N, STEPS,
                                 shared_masses=shared_masses(N))
    for i, name in enumerate(names):
        t = manager.load_trajectory(name)
        assert t["metadata"] == {"n_particles": N, "seed": 42 + i}
        _close(t["positions"], np.asarray(want.positions[i], np.float64))
        np.testing.assert_array_equal(t["masses"], shared_masses(N))
    # 80/20 split, windows of 3: (13 - 3) samples per trajectory
    train = JaxGNNDataset(str(out / "train_dataset.h5"), sequence_length=3)
    val = GNNDataset(str(out / "val_dataset.h5"), sequence_length=3)
    assert (train.n_samples, val.n_samples) == (40, 10)
    first = manager.load_trajectory(names[0])
    np.testing.assert_array_equal(train.targets[0, :, :3],
                                  first["positions"][3].astype(np.float32))

    # resume: only the missing trajectory is simulated again
    (out / "checkpoints" / "sim_0003_trajectory.h5").unlink()
    stamp = (out / "checkpoints" / "sim_0000_trajectory.h5").stat().st_mtime_ns
    capsys.readouterr()
    assert generate_data.main(CLI + ["-o", str(out), "--no-windows"]) == 0
    printed = capsys.readouterr().out
    assert "Simulated 1 new sims (+4 resumed)" in printed
    assert "skipped 4 sims" in printed
    assert manager.trajectory_exists("sim_0003")
    assert (out / "checkpoints" / "sim_0000_trajectory.h5"
            ).stat().st_mtime_ns == stamp

    # --no-windows: the manifest, read by both packages to the same arrays
    manifest = out / "dataset_manifest.json"
    spec = json.loads(manifest.read_text())
    assert spec["train_sims"] == names[:4] and spec["val_sims"] == names[4:]
    assert spec["sequence_length"] == 3
    got_train, got_val = datasets_from_manifest(manifest, k_neighbors=4,
                                                cache=False)
    want_train, want_val = jax_datasets_from_manifest(manifest, k_neighbors=4,
                                                      cache=False)
    for got, want in ((got_train, want_train), (got_val, want_val)):
        np.testing.assert_array_equal(got.last_states, want.last_states)
        np.testing.assert_array_equal(got.targets, want.targets)
        np.testing.assert_array_equal(got.state_mean, want.state_mean)
        np.testing.assert_array_equal(got.state_std, want.state_std)
    np.testing.assert_array_equal(got_train.last_states, train.last_states)
    np.testing.assert_array_equal(got_val.state_mean, got_train.state_mean)


def test_manifest_sidecar_cache_is_shared_and_invalidated(tmp_path, ensemble):
    ckpt = CheckpointManager(str(tmp_path / "checkpoints"))
    for i in range(3):
        ckpt.save_trajectory(trajectory_slice(ensemble, i), f"sim_{i:04d}",
                             compression="none")
    manifest = write_manifest(tmp_path, ["sim_0000", "sim_0001"],
                              ["sim_0002"], sequence_length=3)
    train, val = datasets_from_manifest(manifest, k_neighbors=4)
    sidecar = tmp_path / "dataset_manifest.json.tensors.npz"
    assert sidecar.exists()
    again, _ = datasets_from_manifest(manifest, k_neighbors=4)  # from cache
    np.testing.assert_array_equal(again.last_states, train.last_states)
    jtrain, jval = jax_datasets_from_manifest(manifest, k_neighbors=4)
    np.testing.assert_array_equal(jtrain.targets, train.targets)
    np.testing.assert_array_equal(jval.last_states, val.last_states)
    # a rewritten trajectory invalidates the sidecar
    ckpt.save_trajectory(trajectory_slice(ensemble, 3), "sim_0001",
                         compression="none")
    fresh, _ = datasets_from_manifest(manifest, k_neighbors=4)
    assert not np.array_equal(fresh.last_states, train.last_states)
    with pytest.raises(ValueError, match="manifest"):
        bad = tmp_path / "bad.json"
        bad.write_text("{}")
        datasets_from_manifest(bad)


def test_train_model_reads_the_manifest(tmp_path):
    from nbody_gnn_hpc_torch import train_model

    out = tmp_path / "data"
    assert generate_data.main(CLI + ["-o", str(out), "--no-windows"]) == 0
    assert not (out / "train_dataset.h5").exists()
    models = tmp_path / "models"
    assert train_model.main([
        "--device", "cpu", "--data-dir", str(out), "--model-dir", str(models),
        "--epochs", "1", "--hidden-dim", "16", "--n-layers", "1",
        "--batch-size", "8", "--k-neighbors", "4"]) == 0
    assert (models / "best_model.pt").exists()
    history = json.loads((models / "training_history.json").read_text())
    assert np.isfinite(history["train_loss"]).all()
    assert train_model.main(["--device", "cpu", "--data-dir",
                             str(tmp_path / "none"), "--model-dir",
                             str(models)]) == 1


# -- the npz trajectory store -------------------------------------------------

def test_npz_trajectory_equals_the_hdf5_one(tmp_path, ensemble):
    """The same arrays, dtypes and metadata from either form; the HDF5 one
    is still what the JAX package's manager reads."""
    metadata = {"n_particles": N, "seed": 43, "tags": [1, 2]}
    backs = {}
    for fmt in ("h5", "npz"):
        manager = CheckpointManager(str(tmp_path / fmt))
        path = manager.save_trajectory(trajectory_slice(ensemble, 1),
                                       "sim_0001", metadata=metadata,
                                       compression="lzf",
                                       trajectory_format=fmt)
        assert path.endswith(f"sim_0001_trajectory.{fmt}")
        assert manager.trajectory_exists("sim_0001")
        assert manager.trajectory_names() == ["sim_0001"]
        assert [p.name for p in (tmp_path / fmt).iterdir()] == [
            f"sim_0001_trajectory.{fmt}"]  # no temporary file left
        backs[fmt] = manager.load_trajectory("sim_0001")
    want = JaxCheckpointManager(str(tmp_path / "h5")).load_trajectory(
        "sim_0001")
    assert set(backs["npz"]) == set(backs["h5"]) == set(want)
    for key in FIELDS + ("times", "steps", "masses"):
        assert backs["npz"][key].dtype == want[key].dtype
        np.testing.assert_array_equal(backs["npz"][key], want[key])
        np.testing.assert_array_equal(backs["h5"][key], want[key])
    assert backs["npz"]["n_steps"] == backs["h5"]["n_steps"] == STEPS + 1
    assert backs["npz"]["metadata"] == backs["h5"]["metadata"] == metadata
    with pytest.raises(ValueError, match="trajectory format"):
        CheckpointManager(str(tmp_path)).save_trajectory(
            trajectory_slice(ensemble, 1), "x", trajectory_format="hdf5")
    npz = CheckpointManager(str(tmp_path / "npz"))
    assert npz.delete_checkpoint("sim_0001")
    assert not npz.trajectory_exists("sim_0001")


def test_both_trajectory_forms_for_one_store_raise(tmp_path, ensemble):
    manager = CheckpointManager(str(tmp_path))
    for fmt in ("h5", "npz"):
        manager.save_trajectory(trajectory_slice(ensemble, 0), "sim_0000",
                                compression="none", trajectory_format=fmt)
    with pytest.raises(ValueError, match="both as HDF5 and as npz"):
        manager.load_trajectory("sim_0000")
    with pytest.raises(ValueError, match="both HDF5 and npz"):
        manager.trajectory_names()
    (tmp_path / "sim_0000_trajectory.h5").unlink()
    manager.save_trajectory(trajectory_slice(ensemble, 1), "sim_0001",
                            compression="none")
    with pytest.raises(ValueError, match="both HDF5 and npz"):
        manager.trajectory_names()  # one run's files in two forms


def test_generate_data_npz_store_resumes_and_loads(tmp_path, capsys):
    """``--trajectory-format npz --no-windows``: npz files equal to the
    HDF5 run's, the manifest records the form, a rerun resumes the npz
    files, and the manifest's datasets equal those of the HDF5 run."""
    npz_out, h5_out = tmp_path / "npz", tmp_path / "h5"
    argv = CLI + ["--no-windows"]
    assert generate_data.main(argv + ["-o", str(npz_out),
                                      "--trajectory-format", "npz"]) == 0
    assert "applies to HDF5 files only" in capsys.readouterr().out
    assert generate_data.main(argv + ["-o", str(h5_out)]) == 0
    names = [f"sim_{i:04d}" for i in range(5)]
    assert sorted(p.name for p in (npz_out / "checkpoints").iterdir()) == [
        f"{n}_trajectory.npz" for n in names]
    npz = CheckpointManager(str(npz_out / "checkpoints"))
    jax_h5 = JaxCheckpointManager(str(h5_out / "checkpoints"))
    for name in names:
        got, want = npz.load_trajectory(name), jax_h5.load_trajectory(name)
        for key in FIELDS + ("times", "steps", "masses"):
            np.testing.assert_array_equal(got[key], want[key])
        assert got["metadata"] == want["metadata"]

    spec = json.loads((npz_out / "dataset_manifest.json").read_text())
    assert spec["trajectory_format"] == "npz"
    h5_spec = json.loads((h5_out / "dataset_manifest.json").read_text())
    assert h5_spec["trajectory_format"] == "h5"
    got_train, got_val = datasets_from_manifest(
        npz_out / "dataset_manifest.json", k_neighbors=4)
    want_train, want_val = jax_datasets_from_manifest(
        h5_out / "dataset_manifest.json", k_neighbors=4, cache=False)
    for got, want in ((got_train, want_train), (got_val, want_val)):
        np.testing.assert_array_equal(got.last_states, want.last_states)
        np.testing.assert_array_equal(got.targets, want.targets)
    capsys.readouterr()
    datasets_from_manifest(npz_out / "dataset_manifest.json", k_neighbors=4)
    assert "Loaded tensors from sidecar cache" in capsys.readouterr().out

    # Resume skips the npz files that exist; the rewritten one changes the
    # cache tag (it stats the npz files).
    stamp = (npz_out / "checkpoints" / "sim_0000_trajectory.npz"
             ).stat().st_mtime_ns
    (npz_out / "checkpoints" / "sim_0003_trajectory.npz").unlink()
    assert generate_data.main(argv + ["-o", str(npz_out),
                                      "--trajectory-format", "npz"]) == 0
    assert "Simulated 1 new sims (+4 resumed)" in capsys.readouterr().out
    assert (npz_out / "checkpoints" / "sim_0000_trajectory.npz"
            ).stat().st_mtime_ns == stamp
    again, _ = datasets_from_manifest(npz_out / "dataset_manifest.json",
                                      k_neighbors=4)
    assert "Loaded tensors from sidecar cache" not in capsys.readouterr().out
    np.testing.assert_array_equal(again.last_states, want_train.last_states)


def test_manifest_without_a_format_reads_hdf5(tmp_path, ensemble):
    """The JAX package writes no ``trajectory_format``: its manifests mean
    HDF5, and their cache tag stats the HDF5 files."""
    from nbody_gnn_hpc_tpu.train import write_manifest as jax_write_manifest

    ckpt = CheckpointManager(str(tmp_path / "checkpoints"))
    for i in range(3):
        ckpt.save_trajectory(trajectory_slice(ensemble, i), f"sim_{i:04d}",
                             compression="none")
    manifest = jax_write_manifest(tmp_path, ["sim_0000", "sim_0001"],
                                  ["sim_0002"], sequence_length=3)
    assert "trajectory_format" not in json.loads(Path(manifest).read_text())
    train, _ = datasets_from_manifest(manifest, k_neighbors=4)
    ckpt.save_trajectory(trajectory_slice(ensemble, 3), "sim_0001",
                         compression="none")
    fresh, _ = datasets_from_manifest(manifest, k_neighbors=4)
    assert not np.array_equal(fresh.last_states, train.last_states)


def test_generate_data_npz_needs_no_windows(tmp_path):
    out = tmp_path / "data"
    with pytest.raises(SystemExit):
        generate_data.main(CLI + ["-o", str(out), "--trajectory-format",
                                  "npz"])
    assert not out.exists()  # refused before any simulation
