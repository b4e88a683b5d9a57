"""The port's evaluation side: its own copies of the metrics and of the
float64 oracle against the JAX package's modules (NumPy on both sides, so
they agree to 1e-12), the evaluate command, and the slice as a whole
(generate -> train -> evaluate) on ``--device cpu`` at a tiny size."""

import json

import numpy as np
import pytest

from nbody_gnn_hpc_torch import evaluate, generate_data, train_model
from nbody_gnn_hpc_torch.sim import reference_f64 as port_f64
from nbody_gnn_hpc_torch.utils import metrics as port_metrics
from nbody_gnn_hpc_tpu.sim import reference_f64 as jax_f64
from nbody_gnn_hpc_tpu.utils import metrics as jax_metrics

TOL = dict(rtol=1e-12, atol=0)


@pytest.fixture(scope="module")
def trajectories():
    """A predicted and a target trajectory (T, N, 3) with masses."""
    rng = np.random.RandomState(0)
    t_pos = rng.randn(9, 14, 3).cumsum(0)
    t_vel = rng.randn(9, 14, 3)
    return (t_pos + 0.1 * rng.randn(9, 14, 3), t_vel + 0.1 * rng.randn(9, 14, 3),
            t_pos, t_vel, rng.uniform(1e10, 1e12, 14).astype(np.float32))


@pytest.mark.parametrize("name", ["compute_rmse", "compute_mae"])
@pytest.mark.parametrize("per_particle", [False, True])
def test_error_metrics_equal_jax_package(trajectories, name, per_particle):
    p_pos, _, t_pos, _, _ = trajectories
    np.testing.assert_allclose(
        getattr(port_metrics, name)(p_pos, t_pos, per_particle),
        getattr(jax_metrics, name)(p_pos, t_pos, per_particle), **TOL)


def test_conservation_metrics_equal_jax_package(trajectories):
    p_pos, p_vel, _, _, m = trajectories
    for chunk in (2 ** 28, 14 * 14 * 8 * 2):  # whole trajectory; 2 steps
        got = port_metrics.compute_energy_error(p_pos, p_vel, m,
                                                max_chunk_bytes=chunk)
        want = jax_metrics.compute_energy_error(p_pos, p_vel, m,
                                                max_chunk_bytes=chunk)
        np.testing.assert_allclose(got[0], want[0], **TOL)
        assert got[1] == pytest.approx(want[1], rel=1e-12)
    got = port_metrics.compute_momentum_error(p_vel, m)
    want = jax_metrics.compute_momentum_error(p_vel, m)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    assert got[1] == pytest.approx(want[1], rel=1e-12)


def test_all_metrics_and_report_equal_jax_package(trajectories):
    got = port_metrics.compute_all_metrics(*trajectories)
    want = jax_metrics.compute_all_metrics(*trajectories)
    assert got.keys() == want.keys()
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, err_msg=key, **TOL)
    assert (port_metrics.format_metrics_report(got)
            == jax_metrics.format_metrics_report(want))
    assert "Position RMSE" in port_metrics.format_metrics_report({})


def test_f64_oracle_equals_jax_package():
    rng = np.random.RandomState(1)
    pos, vel = rng.randn(15, 3), rng.randn(15, 3)
    m = rng.uniform(1e10, 1e12, 15).astype(np.float32)
    np.testing.assert_allclose(port_f64.accelerations_f64(pos, m),
                               jax_f64.accelerations_f64(pos, m), **TOL)
    np.testing.assert_allclose(port_f64.total_energy_f64(pos, vel, m),
                               jax_f64.total_energy_f64(pos, vel, m), **TOL)
    got = port_f64.simulate_f64(pos, vel, m, 0.001, 7, save_interval=3)
    want = jax_f64.simulate_f64(pos, vel, m, 0.001, 7, save_interval=3)
    assert got.positions.shape == (3, 15, 3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


def test_protocol_ground_truth_equals_jax_package(capsys):
    got = port_f64.protocol_ground_truth(2, 10, 8, verbose=True)
    want = jax_f64.protocol_ground_truth(2, 10, 8)
    assert got[0].shape == (2, 9, 10, 3) and got[0].dtype == np.float64
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    assert "f64 ground truth 2/2" in capsys.readouterr().out


def test_average_metrics_leaves_nans_out():
    avg = evaluate.average_metrics([
        {"a": 1.0, "b": float("nan"), "c": 2.0, "d": [1]},
        {"a": 3.0, "b": 1.0, "c": float("nan"), "d": [2]}])
    assert avg == {"a": 2.0, "a_std": 1.0, "c": 2.0, "c_std": 0.0}


# -- the slice as a whole: generate -> train -> evaluate ------------------------

N, STEPS = 12, 12
SCHEMA = {"model_path", "model_type", "n_test_simulations", "n_particles",
          "n_steps", "ground_truth", "quantization", "average_metrics",
          "per_simulation_metrics"}  # scripts/evaluate.py:216-227


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("slice")
    assert generate_data.main([
        "-n", str(N), "-s", "5", "--steps", str(STEPS), "--sequence-length",
        "3", "--compression", "none", "-o", str(root / "data"),
        "--device", "cpu"]) == 0
    assert train_model.main([
        "--device", "cpu", "--data-dir", str(root / "data"), "--model-dir",
        str(root / "models"), "--epochs", "1", "--hidden-dim", "16",
        "--n-layers", "1", "--batch-size", "8", "--k-neighbors", "4"]) == 0
    return root


@pytest.fixture(scope="module")
def evaluated(trained):
    """evaluation_results.json of both ground truths, by name."""
    results = {}
    for ground_truth, flags in (("float64_host", ["--f64-ground-truth"]),
                                ("float32_cpu", [])):
        out = trained / f"results_{ground_truth}"
        assert evaluate.main([
            "-m", str(trained / "models" / "best_model.pt"), "-c",
            str(trained / "models" / "config.json"), "-o", str(out),
            "--n-test-sims", "3", "-n", str(N), "--steps", str(STEPS),
            "--device", "cpu"] + flags) == 0
        results[ground_truth] = json.loads(
            (out / "evaluation_results.json").read_text())
    return results


@pytest.mark.parametrize("ground_truth", ["float64_host", "float32_cpu"])
def test_evaluate_cli_writes_the_results_schema(evaluated, ground_truth):
    results = evaluated[ground_truth]
    assert set(results) == SCHEMA
    assert results["ground_truth"] == ground_truth
    assert results["model_type"] == "gnn" and results["quantization"] is None
    assert (results["n_test_simulations"], results["n_particles"],
            results["n_steps"]) == (3, N, STEPS)
    per_sim = results["per_simulation_metrics"]
    assert len(per_sim) == 3
    # rollout from saved step 5 for steps - 6 steps: steps - 5 frames
    assert len(per_sim[0]["trajectory_distances_per_step"]) == STEPS - 5
    avg = results["average_metrics"]
    for key in ("position_rmse", "velocity_rmse", "position_mae",
                "velocity_mae"):
        assert np.isfinite(avg[key]) and avg[key] > 0
        assert avg[key] == pytest.approx(np.mean([r[key] for r in per_sim]))
        assert avg[f"{key}_std"] == pytest.approx(
            np.std([r[key] for r in per_sim]))


def test_evaluate_f32_ground_truth_is_close_to_the_f64_oracle(evaluated):
    """Over 12 steps the float32 ensemble and the float64 oracle give the
    same metrics to float32 accuracy."""
    a, b = evaluated["float64_host"], evaluated["float32_cpu"]
    for key in ("position_rmse", "velocity_rmse"):
        assert a["average_metrics"][key] == pytest.approx(
            b["average_metrics"][key], rel=1e-3)


def test_evaluate_cli_refusals(trained, monkeypatch):
    import torch

    assert evaluate.main(["-m", str(trained / "missing.pt"),
                          "--device", "cpu"]) == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate.main(["-m", str(trained / "models" / "best_model.pt")])


def test_large_n_composition(tmp_path):
    """generate -> train -> evaluate above the cutoffs, as the JAX
    package's test of the same name: N=2085 > KNN_DENSE_MAX (row-blocked
    k-NN in dataset preparation and rollout), >= PALLAS_MIN_N (the large-N
    force dispatch; the blocked form on the CPU) and >= BLOCKED_MIN_N (the
    blocked potential energy), odd N."""
    from nbody_gnn_hpc_torch.ops import KNN_DENSE_MAX
    from nbody_gnn_hpc_torch.sim import PALLAS_MIN_N

    n = 2085
    assert n > KNN_DENSE_MAX and n >= PALLAS_MIN_N
    assert generate_data.main([
        "-n", str(n), "-s", "3", "--steps", "14", "--sequence-length", "5",
        "--compression", "none", "-o", str(tmp_path / "data"),
        "--device", "cpu"]) == 0
    assert train_model.main([
        "--device", "cpu", "--data-dir", str(tmp_path / "data"),
        "--model-dir", str(tmp_path / "models"), "--epochs", "1",
        "--hidden-dim", "16", "--n-layers", "1", "--k-neighbors", "40",
        "--batch-size", "8"]) == 0
    assert evaluate.main([
        "-m", str(tmp_path / "models" / "final_model.pt"), "-c",
        str(tmp_path / "models" / "config.json"), "-o",
        str(tmp_path / "results"), "--n-test-sims", "1", "-n", str(n),
        "--steps", "14", "--device", "cpu"]) == 0
    results = json.loads(
        (tmp_path / "results" / "evaluation_results.json").read_text())
    assert results["n_particles"] == n
    metrics = results["average_metrics"]
    assert np.isfinite(metrics["position_rmse"])
    # the chunked energy metric at this N: a number, not the NaN fallback
    assert np.isfinite(metrics["target_energy_error"])
