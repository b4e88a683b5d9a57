"""Demo: surrogate rollout serving (port of ``examples/demo_serving.py``):
start the HTTP service in-process, fire concurrent client requests and
show the micro-batcher coalescing them into shared batched rollouts.

    python -m nbody_gnn_hpc_torch.examples.demo_serving [--clients 6]
        [--particles 32] [--steps 20] [--k-neighbors 8]
        [--checkpoint models/best_rollout_model.pt] [--quantize bf16|int8]
    ... --device cpu   # the CPU, asked for

Self-contained by default: a random-weight model (hidden 32, 2 layers,
weights from seed 0) saved to a temporary file, on an ephemeral port.
``--checkpoint`` serves a trained ``.pt`` file, its architecture rebuilt
from the ``config.json`` beside it (the production architecture, hidden
256 and 6 layers, where there is none).  The sections are the JAX demo's:
``/healthz``; ``--clients`` concurrent ``/rollout`` requests through a
``MicroBatcher(max_batch=8, max_wait_s=0.05)``, its buckets warmed first;
the final-state and npz response bodies against JSON; the trajectory
streamed through ``RolloutClient.rollout_stream``; ``/simulate``; the
``/metrics`` request counters.  On the card every rollout step runs the
edge-stream kernel.  The kernel launches are printed last.
"""

import argparse
import json
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np


def post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return json.loads(resp.read())


def demo_model(checkpoint, tmpdir: str):
    """(model, checkpoint path): the checkpoint's architecture from the
    ``config.json`` beside it, or, when ``checkpoint`` is None, a
    random-weight model saved into ``tmpdir``."""
    import torch

    from nbody_gnn_hpc_torch.models import NBodyGNN, model_from_config

    if checkpoint:
        cfg_path = Path(checkpoint).parent / "config.json"
        if cfg_path.exists():
            saved = json.loads(cfg_path.read_text())
            return model_from_config(saved["model_config"],
                                     dtype_override="float32"), checkpoint
        print(f"! no config.json beside {checkpoint}; assuming the "
              "production architecture (hidden 256, 6 layers)")
        return NBodyGNN(node_input_dim=7, hidden_dim=256, n_layers=6,
                        output_dim=6, dropout=0.1), checkpoint

    from nbody_gnn_hpc_torch.io import params_to_jax, save_checkpoint

    model = NBodyGNN(node_input_dim=7, hidden_dim=32, n_layers=2,
                     output_dim=6, dropout=0.0,
                     generator=torch.Generator().manual_seed(0))
    ckpt = str(Path(tmpdir) / "demo_model.pt")
    save_checkpoint(ckpt, params=params_to_jax(model.state_dict()),
                    best_val_loss=0.0, history={},
                    norm_stats={"state_mean": np.zeros(6, np.float32),
                                "state_std": np.ones(6, np.float32)},
                    model_config={})
    return model, ckpt


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--clients", type=int, default=6,
                        help="Concurrent rollout requests to fire")
    parser.add_argument("--particles", type=int, default=32)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="Trained .pt checkpoint (default: demo weights)")
    parser.add_argument("--k-neighbors", type=int, default=8)
    parser.add_argument("--quantize", choices=("bf16", "int8"), default=None,
                        help="Serve weight-only quantized params "
                             "(predict/quantize.py)")
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' only when "
                             "asked for)")
    args = parser.parse_args(argv)

    from nbody_gnn_hpc_torch.device import resolve_device
    from nbody_gnn_hpc_torch.ops import launch_line
    from nbody_gnn_hpc_torch.serve import MicroBatcher, RolloutService, serve

    dev = resolve_device(args.device)
    n, k = args.particles, args.k_neighbors
    with tempfile.TemporaryDirectory() as tmp:  # the service reads it once
        model, ckpt = demo_model(args.checkpoint, tmp)
        service = RolloutService(model, ckpt, k_neighbors=k, device=dev,
                                 quantize=args.quantize)
    print(f"Starting service (N={n}, k={k}, device={service.device})")
    batcher = MicroBatcher(service, max_batch=8, max_wait_s=0.05)
    httpd = serve(service, host="127.0.0.1", port=0, batcher=batcher)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        run_clients(base, service, batcher, args)
    finally:
        httpd.shutdown()
        httpd.server_close()
    print(launch_line())
    return 0


def run_clients(base: str, service, batcher, args) -> None:
    """Every section of the demo against the service at ``base``."""
    from nbody_gnn_hpc_torch.client import RolloutClient

    n = args.particles
    health = json.loads(
        urllib.request.urlopen(f"{base}/healthz", timeout=60).read())
    print("healthz:", health)

    rng = np.random.RandomState(0)

    def one_request(i, results):
        payload = {
            "positions": rng.uniform(-5, 5, (n, 3)).tolist(),
            "velocities": np.zeros((n, 3)).tolist(),
            "masses": rng.uniform(1e10, 1e12, n).tolist(),
            "n_steps": args.steps,
        }
        t0 = time.time()
        try:
            out = post(f"{base}/rollout", payload)
            results[i] = (time.time() - t0,
                          np.asarray(out["positions"]).shape)
        except Exception as e:  # noqa: BLE001 — reported per client
            results[i] = e

    # Run every batch bucket and the stream's chunk once, so the timing
    # below is not the kernels' first use.
    print("Warming rollout program...")
    batcher.warmup(n, args.steps)
    service.warmup(n, service.STREAM_CHUNK)

    print(f"Firing {args.clients} concurrent /rollout requests...")
    results = [None] * args.clients
    threads = [threading.Thread(target=one_request, args=(i, results))
               for i in range(args.clients)]
    t0 = time.time()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.time() - t0

    failures = 0
    for i, res in enumerate(results):
        if isinstance(res, tuple):
            dt, shape = res
            print(f"  client {i}: {dt * 1e3:7.1f} ms   trajectory {shape}")
        else:
            failures += 1
            print(f"  client {i}: FAILED — {res}")
    if failures:
        sys.exit(f"{failures}/{args.clients} requests failed")
    print(f"Concurrent wall clock: {wall * 1e3:.1f} ms "
          f"(micro-batched; sequential would be ~{args.clients}x one rollout)")

    # Response modes: the final state alone and binary npz bodies, both
    # far smaller than a JSON trajectory.
    payload = {"positions": rng.uniform(-5, 5, (n, 3)).tolist(),
               "velocities": np.zeros((n, 3)).tolist(),
               "masses": rng.uniform(1e10, 1e12, n).tolist(),
               "n_steps": args.steps}
    final = post(f"{base}/rollout", {**payload, "trajectory": False})
    req = urllib.request.Request(
        f"{base}/rollout",
        data=json.dumps({**payload, "format": "npz"}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        npz_bytes = resp.read()
    json_bytes = len(json.dumps(post(f"{base}/rollout", payload)).encode())
    print(f"final-only: state {np.asarray(final['positions']).shape}; "
          f"npz trajectory body {len(npz_bytes):,} B vs JSON "
          f"~{json_bytes:,} B")

    # Streaming through the typed client: NDJSON chunks arrive while later
    # chunks are still computing; the first lands after one chunk.
    client = RolloutClient(base)
    t0 = time.time()
    t_first, frames = None, 0
    for chunk in client.rollout_stream(
            np.asarray(payload["positions"]),
            np.asarray(payload["velocities"]),
            np.asarray(payload["masses"]), args.steps):
        if t_first is None:
            t_first = time.time() - t0
        frames += len(chunk["positions"])
    print(f"streamed: {frames} frames, first chunk after "
          f"{t_first * 1e3:.1f} ms, done in {(time.time() - t0) * 1e3:.1f} ms")

    # The same service also exposes the exact-physics engine:
    sim_out = post(f"{base}/simulate", {
        "positions": rng.uniform(-5, 5, (n, 3)).tolist(),
        "velocities": np.zeros((n, 3)).tolist(),
        "masses": rng.uniform(1e10, 1e12, n).tolist(),
        "n_steps": args.steps, "dt": 0.001,
    })
    print(f"/simulate: exact-physics final state "
          f"{np.asarray(sim_out['positions']).shape}, finite="
          f"{np.isfinite(np.asarray(sim_out['positions'])).all()}")

    # Observability: everything above is already on the scrape endpoint.
    metrics = urllib.request.urlopen(f"{base}/metrics",
                                     timeout=60).read().decode()
    counters = [ln for ln in metrics.splitlines()
                if ln.startswith("nbody_requests_total{")]
    print("/metrics request counters:")
    for ln in counters:
        print(f"  {ln}")


if __name__ == "__main__":
    sys.exit(main())
