"""Evaluate the GNN against exact-physics ground truth on the GPU (port of
``scripts/evaluate.py``).

    python -m nbody_gnn_hpc_torch.evaluate -m models/best_rollout_model.pt \\
        --f64-ground-truth
    python -m nbody_gnn_hpc_torch.evaluate --device cpu ...   # CPU, asked

The published protocol (reference ``scripts/evaluate.py``): shared masses
from seed 42, test sims seeded ``--seed + i`` in a box of 10 at dt=0.001,
one rollout per sim starting from saved step 5 for ``steps - 6`` steps,
metrics aggregated mean and std into
``<output-dir>/evaluation_results.json``.  The ground truth is the float64
host oracle with ``--f64-ground-truth`` (the reference's precision regime,
so the RMSE compares with its published figures), else the float32
ensemble simulator on the device.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np

SEQ_LEN = 5  # rollout start (published protocol, evaluate.py:79)


def build_parser():
    parser = argparse.ArgumentParser(
        description="Evaluate GNN Model",
        epilog="The JAX CLI's --watchdog is not ported. "
               "Plots need the visualizer, which is not ported either: "
               "they are skipped.")
    parser.add_argument("--model-path", "-m", type=str,
                        default="./models/best_model.pt")
    parser.add_argument("--config-path", "-c", type=str,
                        default="./models/config.json")
    parser.add_argument("--output-dir", "-o", type=str, default="./results")
    parser.add_argument("--n-test-sims", type=int, default=10)
    parser.add_argument("--particles", "-n", type=int, default=200)
    parser.add_argument("--steps", type=int, default=400)
    parser.add_argument("--seed", type=int, default=9999)
    parser.add_argument("--f64-ground-truth", action="store_true",
                        help="Generate ground truth with the float64 host "
                             "oracle (the reference's precision regime, "
                             "nbody.py:179-184) instead of the float32 "
                             "ensemble on the device. Slower, but makes "
                             "RMSE directly comparable with the reference's "
                             "published numbers.")
    parser.add_argument("--quantize", choices=("bf16", "int8"), default=None,
                        help="Evaluate with weight-only quantized weights "
                             "(what `serve --quantize` would serve)")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' only when "
                             "asked for)")
    return parser


def average_metrics(test_results) -> dict:
    """Mean and ``_std`` of every numeric metric over the test sims, NaNs
    left out (``evaluate.py:198-206``)."""
    avg = {}
    for key, v0 in test_results[0].items():
        if isinstance(v0, (int, float)) and not np.isnan(v0):
            values = [r[key] for r in test_results
                      if not np.isnan(r.get(key, float("nan")))]
            if values:
                avg[key] = float(np.mean(values))
                avg[f"{key}_std"] = float(np.std(values))
    return avg


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from nbody_gnn_hpc_torch.device import resolve_device
    from nbody_gnn_hpc_torch.models import model_from_config
    from nbody_gnn_hpc_torch.predict import Predictor
    from nbody_gnn_hpc_torch.serve import DEFAULT_MODEL_CONFIG
    from nbody_gnn_hpc_torch.sim import shared_masses as make_shared_masses
    from nbody_gnn_hpc_torch.utils import compute_all_metrics

    model_path = Path(args.model_path)
    config_path = Path(args.config_path)
    output_dir = Path(args.output_dir)
    if not model_path.exists():
        print(f"Error: Model not found at {model_path}")
        return 1
    device = resolve_device(args.device)  # raises without a card unasked
    output_dir.mkdir(parents=True, exist_ok=True)

    print("=" * 60)
    print("GNN MODEL EVALUATION (PyTorch)")
    print("=" * 60)

    if config_path.exists():
        with open(config_path) as f:
            config = json.load(f)
        model_config = config["model_config"]
        k_neighbors = config.get("training_config", {}).get("k_neighbors", 40)
    else:
        model_config, k_neighbors = DEFAULT_MODEL_CONFIG, 40

    print("\nLoading model...")
    predictor = Predictor(model_from_config(model_config), str(model_path),
                          device=device, k_neighbors=k_neighbors)
    if args.quantize and not predictor.quantization:
        print(f"  (weight-only {args.quantize} quantization)")
        predictor.quantize(args.quantize)

    print(f"\nRunning {args.n_test_sims} test simulations "
          f"({args.particles} particles, {args.steps} steps)...")
    # Shared masses matching training (reference evaluate.py:76-77).
    shared_masses = make_shared_masses(args.particles, seed=42)
    prediction_steps = args.steps - SEQ_LEN - 1

    if args.f64_ground_truth:
        from nbody_gnn_hpc_torch.sim import protocol_ground_truth

        print("  (ground truth: float64 host oracle)")
        ground_truth = "float64_host"
        gt_pos, gt_vel, _ = protocol_ground_truth(
            n_test_sims=args.n_test_sims, n_particles=args.particles,
            n_steps=args.steps, dt=0.001, box_size=10.0, seed=args.seed,
            verbose=True)
    else:
        from nbody_gnn_hpc_torch.parallel import simulate_ensemble

        # All ground truths as one float32 ensemble on the device.
        ground_truth = f"float32_{device.type}"
        ensemble = simulate_ensemble(
            seeds=[args.seed + i for i in range(args.n_test_sims)],
            n_particles=args.particles, n_steps=args.steps, box_size=10.0,
            dt=0.001, shared_masses=shared_masses, device=device)
        gt_pos = ensemble.positions.cpu().numpy().astype(np.float64)
        gt_vel = ensemble.velocities.cpu().numpy().astype(np.float64)

    print("  (plots skipped: the visualizer is not ported)")

    # All rollouts as one batch on the device.
    ai_all = predictor.predict_rollout_batch(
        gt_pos[:, SEQ_LEN].astype(np.float32),
        gt_vel[:, SEQ_LEN].astype(np.float32),
        shared_masses, n_steps=prediction_steps)

    test_results = []
    for i in range(args.n_test_sims):
        print(f"\n  Test {i + 1}/{args.n_test_sims}")
        hpc_pos = gt_pos[i, SEQ_LEN:SEQ_LEN + prediction_steps + 1]
        hpc_vel = gt_vel[i, SEQ_LEN:SEQ_LEN + prediction_steps + 1]
        metrics = compute_all_metrics(
            ai_all["positions"][i][:len(hpc_pos)],
            ai_all["velocities"][i][:len(hpc_vel)],
            hpc_pos, hpc_vel, shared_masses)
        test_results.append(metrics)
        print(f"    Position RMSE: {metrics['position_rmse']:.6e}")
        print(f"    Velocity RMSE: {metrics['velocity_rmse']:.6e}")

    print("\n" + "=" * 60)
    print("EVALUATION RESULTS")
    print("=" * 60)
    avg_metrics = average_metrics(test_results)
    print(f"\nAveraged over {args.n_test_sims} test simulations:")
    print("-" * 40)
    for m in ("position_rmse", "position_mae", "velocity_rmse",
              "velocity_mae"):
        print(f"  {m}: {avg_metrics.get(m, float('nan')):.6e} ± "
              f"{avg_metrics.get(m + '_std', 0):.6e}")
    print("-" * 40)

    results = {
        "model_path": str(model_path),
        "model_type": "gnn",
        "n_test_simulations": args.n_test_sims,
        "n_particles": args.particles,
        "n_steps": args.steps,
        "ground_truth": ground_truth,
        "quantization": predictor.quantization,
        "average_metrics": avg_metrics,
        "per_simulation_metrics": test_results,
    }
    results_path = output_dir / "evaluation_results.json"
    with open(results_path, "w") as f:
        json.dump(results, f, indent=2, default=str)
    print(f"\n  Results: {results_path}")
    print("=" * 60)
    return 0


if __name__ == "__main__":
    sys.exit(main())
