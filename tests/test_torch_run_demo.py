"""The port's one-command pipeline (nbody_gnn_hpc_torch/run_demo.py)
against the JAX package's ``scripts/run_demo.py``, on the CPU.

The wiring is held to the JAX runner flag set by flag set: the same
resolved namespace, titles, skips and stage argv, apart from the command
names, the port's ``--device`` / ``--trajectory-format`` and the flags the
port's commands do not have (``OMITTED_FLAGS``).  The end-to-end case runs
all six stages as processes in a temporary workspace, cut to N=13, 6 sims
x 20 steps, hidden 32, 2 layers, 1 epoch, curriculum ``8:2`` and 1
evaluation sim, on the npz store; its CSVs are held against
``scripts/export_csv.py`` and its fine-tuned checkpoint against the JAX
package's model.
"""

import argparse
import importlib.util
import json
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from nbody_gnn_hpc_torch import run_demo as rd
from nbody_gnn_hpc_torch.config import TrainingConfig
from nbody_gnn_hpc_torch.io import CheckpointManager
from nbody_gnn_hpc_torch.ops import LAUNCH_LINE, launch_counts

REPO = Path(__file__).resolve().parent.parent


def _load_jax_run_demo():
    spec = importlib.util.spec_from_file_location(
        "jax_run_demo_module", REPO / "scripts" / "run_demo.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jrd = _load_jax_run_demo()
TRAJECTORY_TABLES = ("sample_trajectory.csv", "simulation_info.csv")


def jax_export(data_dir, model_dir, results_dir, out_dir):
    """``scripts/export_csv.py``, unchanged, as a process."""
    proc = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "export_csv.py"),
         "-d", str(data_dir), "-m", str(model_dir), "-r", str(results_dir),
         "-o", str(out_dir)], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# The flag sets of tests/test_run_demo_wiring.py and of
# tests/test_cli.py::test_run_demo_production_mode_wiring, over both bases
# those files use (compression unset, as main() parses it, and "gzip").
FLAG_SETS = [
    {}, {"rollout_select": True}, {"finetune_rollout": True},
    {"rollout_select": True, "finetune_rollout": True},
    {"production": True}, {"production": True, "finetune_rollout": True},
    {"production": True, "no_finetune_rollout": True},
    {"no_finetune_rollout": True}, {"f64_ground_truth": True},
    {"resume": True}, {"watchdog": 60.0}, {"watchdog": 0.0},
    {"production": True, "watchdog": 0.0}, {"watchdog": -1.0},
    {"production": True, "reference_protocol": True},
    {"reference_protocol": True},
    {"max_samples": 100, "epochs": 3, "no_windows": True},
    {"skip_datagen": True, "skip_training": True},
]
BASES = [{"compression": None}, {"compression": "gzip"}]


def _namespace(**overrides):
    ns = dict(production=False, reference_protocol=False,
              skip_training=False, skip_datagen=False, no_clean=False,
              max_samples=None, epochs=None, no_windows=False,
              compression=None, f64_ground_truth=False, rollout_select=False,
              finetune_rollout=False, no_finetune_rollout=False, resume=False,
              watchdog=None)
    ns.update(overrides)
    return argparse.Namespace(**ns)


def _strip(argv, pairs):
    """``argv`` without each flag in ``pairs`` and the value after it."""
    out = list(argv)
    for flag in pairs:
        if flag in out:
            i = out.index(flag)
            del out[i:i + 2]
    return out


@pytest.mark.parametrize("base", BASES, ids=["unset", "gzip"])
@pytest.mark.parametrize("flags", FLAG_SETS,
                         ids=lambda f: ",".join(sorted(f)) or "bare")
def test_wiring_equals_the_jax_runner(base, flags):
    jax_args = _namespace(**{**base, **flags})
    port_args = _namespace(**{**base, **flags}, trajectory_format="h5",
                           device="cpu")
    try:
        want = jrd.resolve_mode(jax_args)
    except SystemExit:
        with pytest.raises(SystemExit):
            rd.resolve_mode(port_args)
        return
    got = rd.resolve_mode(port_args)
    assert (got.device, got.trajectory_format) == ("cpu", "h5")
    assert {k: v for k, v in vars(got).items()
            if k not in ("device", "trajectory_format")} == vars(want)

    omitted = {}
    for command, flag in rd.OMITTED_FLAGS:
        omitted.setdefault(command, []).append(flag)
    jcfg, cfg = jrd.TrainingConfig(), TrainingConfig()
    assert len(rd.PIPELINE) == len(jrd.PIPELINE) == 6
    for stage, jstage in zip(rd.PIPELINE, jrd.PIPELINE):
        assert stage.title == jstage.title
        assert stage.skip(got) == jstage.skip(want)
        # Both check the same workspace for models/checkpoint_epoch_10.pt.
        argv = stage.argv(got, cfg, REPO)
        jargv = jstage.argv(want, jcfg)
        assert jargv[0] == argv[0] + ".py"
        if argv[0] != "export_csv":  # every stage that drives the device
            assert argv[argv.index("--device") + 1] == "cpu"
        if argv[0] == "generate_data":
            assert argv[argv.index("--trajectory-format") + 1] == "h5"
        assert _strip(argv[1:], ("--device", "--trajectory-format")) == \
            _strip(jargv[1:], omitted.get(argv[0], ()))


def test_constants_equal_the_jax_runner():
    assert rd.CLEAN_MANIFEST == jrd.CLEAN_MANIFEST
    assert rd.WORKSPACE_DIRS == jrd.WORKSPACE_DIRS
    assert rd.PRODUCTION_EPOCHS == jrd.PRODUCTION_EPOCHS
    assert rd.PRODUCTION_WATCHDOG_S == jrd.PRODUCTION_WATCHDOG_S
    # "data/checkpoints" removes both trajectory forms.
    assert ("data/checkpoints", True) in rd.CLEAN_MANIFEST


def test_omitted_flags_are_absent_from_the_port_commands():
    """Each named omission is a flag of the JAX argv that the port's
    command really lacks."""
    import importlib

    cfg = jrd.TrainingConfig()
    for command, flag in rd.OMITTED_FLAGS:
        jax_stage = next(s for s in jrd.PIPELINE
                         if s.argv(_namespace(compression="gzip"),
                                   cfg)[0] == f"{command}.py")
        assert flag in jax_stage.argv(_namespace(compression="gzip"), cfg)
        parser = importlib.import_module(
            f"nbody_gnn_hpc_torch.{command}").build_parser()
        assert flag not in parser._option_string_actions


def test_npz_store_needs_no_windows():
    with pytest.raises(SystemExit, match="npz needs --no-windows"):
        rd.resolve_mode(_namespace(trajectory_format="npz", device=None))
    args = rd.resolve_mode(_namespace(production=True,
                                      trajectory_format="npz", device=None))
    argv = rd._datagen_argv(args, TrainingConfig(), REPO)
    assert argv[argv.index("--trajectory-format") + 1] == "npz"
    assert "--no-windows" in argv
    parsed = rd.build_parser().parse_args([])
    assert (parsed.trajectory_format, parsed.device) == ("h5", None)


def test_skip_datagen_accepts_an_npz_manifest(tmp_path):
    args = _namespace(skip_datagen=True)
    with pytest.raises(SystemExit, match="no training data"):
        rd._require_dataset(args, tmp_path)
    (tmp_path / "data").mkdir()
    (tmp_path / "data" / "dataset_manifest.json").write_text(
        json.dumps({"trajectory_format": "npz"}))
    rd._require_dataset(args, tmp_path)


def test_with_values_replaces_and_appends():
    stages = rd.with_values(rd.PIPELINE, {
        "finetune_rollout": {"--curriculum": "8:2"},
        "train_model": {"--hidden-dim": "32"}})
    args = rd.resolve_mode(_namespace(production=True, device="cpu",
                                      trajectory_format="npz"))
    argv = {s.title: s.argv(args, TrainingConfig(), REPO) for s in stages}
    ft = argv["Fine-tuning Rollout (K-step unrolled objective)"]
    assert ft[ft.index("--curriculum") + 1] == "8:2"
    assert argv["Training GNN Model"][-2:] == ["--hidden-dim", "32"]
    # The production table is left as it was.
    assert "8:1500,16:900" in rd._finetune_argv(args, TrainingConfig(), REPO)


def _tiny(root, *extra, stages=None, **cut):
    """``run_pipeline`` in ``root`` at the cut size, on the CPU.  The
    caller sets ``OMP_NUM_THREADS=1`` for the stages' processes: tiny
    models gain nothing from more threads, and the other test files
    running beside this one keep their cores."""
    args = rd.resolve_mode(rd.build_parser().parse_args(
        ["--device", "cpu", *extra]))
    cfg = TrainingConfig(**{**dict(particles=13, simulations=6, steps=20,
                                   n_test_sims=1, hidden_dim=32, n_layers=2),
                            **cut})
    stages = rd.with_values(stages or rd.PIPELINE, {
        "train_model": {"--hidden-dim": "32", "--n-layers": "2"},
        "finetune_rollout": {"--curriculum": "8:2"}})
    return rd.run_pipeline(args, cfg, root, stages)


def test_a_stalled_stage_stops_the_run_with_the_resume_hint(
        tmp_path, capsys, monkeypatch):
    """Datagen's watchdog fires (117) long before a 100,000-step
    simulation reads back: the runner stops and says to --resume."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    stages = rd.with_values(rd.PIPELINE[:2], {
        "generate_data": {"--steps": "100000", "--watchdog": "0.3"}})
    with pytest.raises(SystemExit) as stop:
        _tiny(tmp_path, "--production", "--trajectory-format", "npz",
              stages=stages, simulations=1)
    assert stop.value.code == 1
    out = capsys.readouterr().out
    assert "Generating Training Data failed with code 117" in out
    assert "WATCHDOG: no batch-readback progress" in out
    assert "rerun with --resume" in out
    assert "STEP: Training GNN Model" not in out


def test_production_pipeline_end_to_end(tmp_path, monkeypatch):
    """All six stages, each a process, on the npz store."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    from nbody_gnn_hpc_tpu.io import load_checkpoint as jax_load_checkpoint
    from nbody_gnn_hpc_tpu.models.gnn import \
        model_from_config as jax_from_config
    from nbody_gnn_hpc_tpu.predict import Predictor as JaxPredictor

    from nbody_gnn_hpc_torch.io import load_checkpoint
    from nbody_gnn_hpc_torch.models import model_from_config
    from nbody_gnn_hpc_torch.predict import Predictor

    (tmp_path / "models").mkdir()
    (tmp_path / "models" / "best_model.pt").write_text("stale")
    records = _tiny(tmp_path, "--production", "--trajectory-format", "npz",
                    "--epochs", "1")
    assert [r["title"] for r in records] == [s.title for s in rd.PIPELINE]
    for r in records:
        assert r["returncode"] == 0, r["title"]
    for r in records[:5]:  # the stages that drive the device
        assert re.search(r"Device:\s+cpu\b", r["output"]), r["title"]
        assert r["argv"][r["argv"].index("--watchdog") + 1] == "1800.0"
        # Each prints its process's launch counts last; the plain versions
        # that run on the CPU launch no kernel.
        counted = [line[len(LAUNCH_LINE):] for line in
                   r["output"].splitlines() if line.startswith(LAUNCH_LINE)]
        assert len(counted) == 1, r["title"]
        assert json.loads(counted[0]) == dict.fromkeys(launch_counts(), 0)
    assert LAUNCH_LINE not in records[5]["output"]  # the export: no device

    data, models = tmp_path / "data", tmp_path / "models"
    spec = json.loads((data / "dataset_manifest.json").read_text())
    assert spec["trajectory_format"] == "npz"
    assert sorted(p.name for p in (data / "checkpoints").iterdir()) == [
        f"sim_{i:04d}_trajectory.npz" for i in range(6)]
    for name in ("best_model.pt", "final_model.pt", "selected_model.pt",
                 "checkpoint_selection.json", "best_rollout_model.pt",
                 "config.json", "training_history.json"):
        assert (models / name).stat().st_size > 10, name  # stale one gone
    results = json.loads(
        (tmp_path / "results" / "evaluation_results.json").read_text())
    assert results["ground_truth"] == "float64_host"
    assert results["model_path"] == "models/best_rollout_model.pt"
    assert np.isfinite([results["average_metrics"][k] for k in (
        "position_rmse", "velocity_rmse")]).all()
    csv_dir = tmp_path / "results" / "csv"
    assert sorted(p.name for p in csv_dir.iterdir()) == sorted(
        ["metrics_summary.csv", "metrics_per_simulation.csv",
         "sample_trajectory.csv", "simulation_info.csv",
         "training_history.csv"])

    # scripts/export_csv.py, unchanged, on the same directories: the JAX
    # script reads HDF5 only, so it writes the other three tables, and
    # the trajectory tables from an HDF5 copy of the store.
    dirs = [str(tmp_path / d) for d in ("data", "models", "results")]
    jax_export(*dirs, tmp_path / "jax_csv")
    h5 = CheckpointManager(str(tmp_path / "h5" / "checkpoints"))
    npz = CheckpointManager(str(data / "checkpoints"))
    for name in npz.trajectory_names():
        t = npz.load_trajectory(name)
        h5.save_trajectory(SimpleNamespace(**t), name, t["metadata"],
                           compression="lzf")
    jax_export(tmp_path / "h5", *dirs[1:], tmp_path / "jax_csv_h5")
    assert sorted(p.name for p in (tmp_path / "jax_csv").iterdir()) == [
        "metrics_per_simulation.csv", "metrics_summary.csv",
        "training_history.csv"]
    for name in sorted(p.name for p in csv_dir.iterdir()):
        want_dir = "jax_csv_h5" if name in TRAJECTORY_TABLES else "jax_csv"
        want = (tmp_path / want_dir / name).read_bytes().replace(
            b"sim_0000_trajectory.h5", b"sim_0000_trajectory.npz")
        assert (csv_dir / name).read_bytes() == want, name

    # The fine-tuned checkpoint: the cut curriculum recorded, readable by
    # the JAX package, and one JAX model step equal to the port's (f32
    # summation order through 2 layers: 1e-5 of the state's scale).
    port_ckpt = load_checkpoint(models / "best_rollout_model.pt")
    ckpt = jax_load_checkpoint(models / "best_rollout_model.pt")
    assert [tuple(r) for r in ckpt["finetune"]["curriculum"]] == [(8, 2)]
    assert ckpt["finetune"]["base"] == "./models/selected_model.pt"
    assert port_ckpt["finetune"]["curriculum"] == \
        ckpt["finetune"]["curriculum"]
    cfg = json.loads((models / "config.json").read_text())
    k = cfg["training_config"]["k_neighbors"]
    jax_pred = JaxPredictor(
        jax_from_config({**cfg["model_config"], "edge_impl": "xla"},
                        dtype_override="float32"),
        model_path=str(models / "best_rollout_model.pt"), k_neighbors=k)
    port = Predictor(model_from_config(cfg["model_config"]),
                     str(models / "best_rollout_model.pt"), device="cpu",
                     k_neighbors=k)
    rng = np.random.RandomState(3)
    pos, vel = rng.randn(13, 3) * 3, rng.randn(13, 3)
    masses = npz.load_trajectory("sim_0000")["masses"]
    got = port.predict_rollout(pos, vel, masses, 1, trajectory=False)
    want = jax_pred.predict_rollout(pos, vel, masses, 1, trajectory=False)
    assert not np.allclose(got["positions"], pos)
    for key in ("positions", "velocities"):
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=1e-5 * np.abs(want[key]).max())
