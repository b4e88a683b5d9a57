"""Rules of the PyTorch port: it imports no JAX and nothing of the JAX
package, and it never runs on the CPU unless asked to."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "nbody_gnn_hpc_tpu"}


def _port_sources():
    files = sorted((REPO / "nbody_gnn_hpc_torch").rglob("*.py"))
    return files + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_nothing_of_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, \
                f"{path.name}:{node.lineno} imports {name}"


def test_importing_the_port_loads_no_jax():
    """Nor h5py: the machine with the card has none, so only the functions
    that touch an HDF5 file import it."""
    code = ("import sys, nbody_gnn_hpc_torch.serve, nbody_gnn_hpc_torch.sim, "
            "nbody_gnn_hpc_torch.client, nbody_gnn_hpc_torch.train, "
            "nbody_gnn_hpc_torch.train_model, nbody_gnn_hpc_torch.config, "
            "nbody_gnn_hpc_torch.generate_data, nbody_gnn_hpc_torch.evaluate, "
            "nbody_gnn_hpc_torch.parallel, nbody_gnn_hpc_torch.io, "
            "nbody_gnn_hpc_torch.utils, nbody_gnn_hpc_torch.ops, "
            "nbody_gnn_hpc_torch.ops.fused_edge_full, "
            "nbody_gnn_hpc_torch.predict.quantize, "
            "nbody_gnn_hpc_torch.quantize_model, "
            "nbody_gnn_hpc_torch.ops.probes, nbody_gnn_hpc_torch.roofline, "
            "nbody_gnn_hpc_torch.utils.profiling, "
            "nbody_gnn_hpc_torch.finetune_rollout, "
            "nbody_gnn_hpc_torch.select_checkpoint, "
            "nbody_gnn_hpc_torch.predict.selection, "
            "nbody_gnn_hpc_torch.run_demo, nbody_gnn_hpc_torch.export_csv, "
            "nbody_gnn_hpc_torch.sim.simulator, "
            "nbody_gnn_hpc_torch.parallel.mesh, "
            "nbody_gnn_hpc_torch.parallel.train_dp, "
            "nbody_gnn_hpc_torch.parallel.smoke, "
            "nbody_gnn_hpc_torch.multichip_smoke, "
            "nbody_gnn_hpc_torch.merge_dataset, "
            "nbody_gnn_hpc_torch.benchmark_bh_temp, "
            "nbody_gnn_hpc_torch.largen_pipeline, "
            "nbody_gnn_hpc_torch.examples.demo_surrogate, "
            "nbody_gnn_hpc_torch.examples.demo_serving, "
            "nbody_gnn_hpc_torch.examples.demo_parallel\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN | {'h5py'})!r})\n"
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(REPO)})
    assert proc.returncode == 0, proc.stderr


def test_every_port_package_has_an_init():
    """setuptools' ``packages.find`` picks up only directories with one."""
    root = REPO / "nbody_gnn_hpc_torch"
    for d in [root] + [p for p in root.iterdir() if p.is_dir()
                       and any(p.glob("*.py"))]:
        assert (d / "__init__.py").exists(), d


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_to_run_on_cpu_unasked(no_cuda):
    from nbody_gnn_hpc_torch import resolve_device
    from nbody_gnn_hpc_torch.models import NBodyGNN
    from nbody_gnn_hpc_torch.predict import Predictor
    from nbody_gnn_hpc_torch.serve import build_service
    from nbody_gnn_hpc_torch.sim import make_state

    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_service("models/best_rollout_model.pt", "models/config.json")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(NBodyGNN(hidden_dim=32, n_layers=1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_state([[0.0, 0, 0]], [[0.0, 0, 0]], [1.0])
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_serve_cli_refuses_cpu_unasked(no_cuda):
    from nbody_gnn_hpc_torch.serve import main

    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--warm-particles", "0", "--port", "0"])


def test_training_entry_points_refuse_cpu_unasked(no_cuda, tmp_path):
    import numpy as np

    from nbody_gnn_hpc_torch.models import NBodyGNN
    from nbody_gnn_hpc_torch.train import GNNDataset, Trainer
    from nbody_gnn_hpc_torch.train_model import main

    rng = np.random.RandomState(0)
    trajs = [dict(positions=rng.randn(8, 10, 3).astype(np.float32),
                  velocities=rng.randn(8, 10, 3).astype(np.float32),
                  masses=np.ones(10))]
    ds = GNNDataset.from_trajectories(trajs, sequence_length=3,
                                      k_neighbors=3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ds.device_arrays()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(NBodyGNN(hidden_dim=32, n_layers=1), ds,
                model_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--data-dir", str(tmp_path), "--model-dir", str(tmp_path)])
    assert ds.device_arrays("cpu")[0].device.type == "cpu"


def test_simulator_entry_points_refuse_cpu_unasked(no_cuda, tmp_path):
    from nbody_gnn_hpc_torch.evaluate import main as evaluate_main
    from nbody_gnn_hpc_torch.generate_data import main as generate_main
    from nbody_gnn_hpc_torch.parallel import (build_ensemble_state,
                                              simulate_ensemble)

    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulate_ensemble([1, 2], 5, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_ensemble_state([1, 2], 5, 10.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate_main(["-o", str(tmp_path / "data"), "-s", "1", "-n", "5"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate_main(["-m", "models/best_rollout_model.pt",
                       "-c", "models/config.json", "-o", str(tmp_path / "r")])
    assert simulate_ensemble([1, 2], 5, 2, device="cpu"
                             ).positions.device.type == "cpu"


def test_deployed_serving_refuses_cpu_unasked(no_cuda, tmp_path):
    """The pool, and the service command with the deployment flags, want a
    GPU; quantizing a checkpoint file is host work and needs none."""
    from nbody_gnn_hpc_torch.io import params_to_jax, save_checkpoint
    from nbody_gnn_hpc_torch.models import NBodyGNN
    from nbody_gnn_hpc_torch.quantize_model import main as quantize_main
    from nbody_gnn_hpc_torch.serve import build_replica_pool, main

    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_replica_pool("models/best_rollout_model.pt",
                           "models/config.json")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_replica_pool("models/best_rollout_model.pt",
                           "models/config.json", n_replicas=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--warm-particles", "0", "--port", "0", "--replicas", "-1",
              "--micro-batch", "8", "--max-inflight", "16", "--quantize",
              "int8"])
    src = tmp_path / "m.pt"
    save_checkpoint(src, params=params_to_jax(
        NBodyGNN(hidden_dim=32, n_layers=1).state_dict()))
    assert quantize_main(["-m", str(src), "--mode", "int8"]) == 0
    assert (tmp_path / "m.int8.pt").exists()


def test_finetune_and_selection_refuse_cpu_unasked(no_cuda, tmp_path):
    """Both commands, and scoring, want a GPU before they read a file."""
    import numpy as np

    from nbody_gnn_hpc_torch.finetune_rollout import main as finetune_main
    from nbody_gnn_hpc_torch.models import NBodyGNN
    from nbody_gnn_hpc_torch.predict import score_checkpoints
    from nbody_gnn_hpc_torch.select_checkpoint import main as select_main

    with pytest.raises(RuntimeError, match="device='cpu'"):
        finetune_main(["-d", str(tmp_path), "-o", str(tmp_path / "o.pt")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        select_main(["-m", str(tmp_path), "-d", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        score_checkpoints(NBodyGNN(hidden_dim=32, n_layers=1),
                          ["models/best_model.pt"],
                          np.zeros((1, 8, 5, 6), np.float32),
                          np.ones(5, np.float32), 3)


def test_pipeline_refuses_cpu_unasked(no_cuda, tmp_path, monkeypatch):
    """Before any stage runs and before the workspace is cleaned."""
    from nbody_gnn_hpc_torch.run_demo import main

    monkeypatch.chdir(tmp_path)
    (tmp_path / "models").mkdir()
    (tmp_path / "models" / "best_model.pt").write_text("kept")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["--production", "--trajectory-format", "npz"])
    assert sorted(p.name for p in tmp_path.rglob("*")) == [
        "best_model.pt", "models"]


def test_ceilings_command_refuses_cpu_unasked(no_cuda):
    from nbody_gnn_hpc_torch.roofline import main, measure_ceilings

    with pytest.raises(RuntimeError, match="device='cpu'"):
        main([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        measure_ceilings(None, (8, 128), 4, (8, 128), (8, 128), 4, 16, 1)


def test_whole_layer_wrapper_runs_its_kernel_on_cuda_tensors_only(
        monkeypatch):
    """On the CPU the wrapper runs the plain version because its tensors
    lie there; a CUDA tensor goes to the kernel's launcher, never to the
    plain version; any other device is refused."""
    from nbody_gnn_hpc_torch.ops import fused_edge_full as ff

    calls = []
    monkeypatch.setattr(ff, "_launch", lambda *a, **k: calls.append("kernel")
                        or (_ for _ in ()).throw(RuntimeError("launched")))
    monkeypatch.setattr(ff, "fused_full_layer_reference",
                        lambda *a, **k: calls.append("plain")
                        or (torch.zeros(4, 32), torch.zeros(4, 32)))

    class _OnCuda:
        """Stands in for a CUDA tensor as far as the dispatch looks."""
        device = torch.device("cuda")

        def dim(self):
            return 3

        def contiguous(self):
            return self

    class _Ctx:
        def save_for_backward(self, *a):
            pass

        def mark_non_differentiable(self, *a):
            pass

    params = [torch.zeros(1)] * len(ff.PARAM_KEYS)
    with pytest.raises(RuntimeError, match="launched"):
        ff._FullLayer.forward(_Ctx(), None, None, None, 0.0, _OnCuda(),
                              _OnCuda(), *params)
    assert calls == ["kernel"]
    ff._FullLayer.forward(_Ctx(), None, None, None, 0.0, torch.zeros(4, 32),
                          torch.zeros(8, 5), *params)
    assert calls == ["kernel", "plain"]
    with pytest.raises(ValueError, match="cuda or cpu"):
        ff.fused_full_layer(torch.zeros(4, 32, device="meta"), None, {},
                            None)


def test_simulator_surface_refuses_cpu_unasked(no_cuda):
    """The simulator, its factories, the batched runs and the aliases want
    a GPU unless the CPU is asked for."""
    import numpy as np

    from nbody_gnn_hpc_torch.sim import (NBodySimulator,
                                         compute_accelerations_direct,
                                         compute_total_energy,
                                         run_parallel_simulations)

    with pytest.raises(RuntimeError, match="device='cpu'"):
        NBodySimulator(n_particles=5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NBodySimulator.create_solar_system()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NBodySimulator.create_galaxy_collision(n_per_galaxy=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_parallel_simulations([{"init": {"n_particles": 5, "seed": s},
                                   "run": {"n_steps": 2}} for s in (1, 2)])
    pos, m = np.zeros((3, 3)), np.ones(3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compute_accelerations_direct(pos, m)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compute_total_energy(pos, pos, m)
    assert NBodySimulator(n_particles=5, device="cpu").device.type == "cpu"


def test_data_parallel_entry_points_refuse_cpu_unasked(no_cuda, tmp_path):
    """Each wants a GPU before it touches a mesh or a process group."""
    import numpy as np
    import torch.distributed as dist

    from nbody_gnn_hpc_torch.models import NBodyGNN
    from nbody_gnn_hpc_torch.multichip_smoke import main as smoke_main
    from nbody_gnn_hpc_torch.parallel import (init_data_parallel,
                                              simulate_ensemble)
    from nbody_gnn_hpc_torch.train import GNNDataset, Trainer
    from nbody_gnn_hpc_torch.train_model import main as train_main

    mesh = object()  # never reached
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simulate_ensemble([1, 2], 5, 2, mesh=mesh)
    rng = np.random.RandomState(0)
    trajs = [dict(positions=rng.randn(8, 10, 3).astype(np.float32),
                  velocities=rng.randn(8, 10, 3).astype(np.float32),
                  masses=np.ones(10))]
    ds = GNNDataset.from_trajectories(trajs, sequence_length=3,
                                      k_neighbors=3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(NBodyGNN(hidden_dim=32, n_layers=1), ds,
                model_dir=str(tmp_path), mesh=mesh)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_main(["--data-parallel", "--data-dir", str(tmp_path),
                    "--model-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        smoke_main(["--skip-scaling"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_data_parallel()
    assert not dist.is_initialized()


@pytest.mark.parametrize("command,argv", [
    ("benchmark_bh_temp", ["-n", "8", "--steps", "1"]),
    ("examples.demo_surrogate", []),
    ("examples.demo_serving", []),
    ("examples.demo_parallel", []),
    ("examples.demo_parallel", ["--virtual-devices", "2"]),
    ("largen_pipeline", ["work"]),
], ids=lambda v: "_".join(v) if isinstance(v, list) else v)
def test_commands_refuse_cpu_unasked(no_cuda, tmp_path, monkeypatch,
                                     command, argv):
    """Each wants a GPU before it writes a file, spawns a rank or starts a
    stage."""
    import importlib

    main = importlib.import_module(f"nbody_gnn_hpc_torch.{command}").main
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(argv)
    assert not any(tmp_path.iterdir())
