#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Environment: the card's name and power limit (nvidia-smi); no CUDA
   device is a failure.
2. Build every CUDA kernel of the path from ``nbody_gnn_hpc_torch/csrc``
   (one nvcc per source, all started together).
3. Each kernel against its plain PyTorch version on the card, at the
   serving shapes (N=200, k=40, H=256; B=1 and B=8; and an odd N=13, k=4),
   with evaluation-protocol states (box 10, seeds 9999+i, masses from seed
   42) through the production checkpoint's first layer.  Tolerance
   atol=rtol=1e-4: both sides are float32 and differ only in the order of
   the sums.  Reruns must be bit-identical (no float atomics).  Times with
   CUDA events, inputs warm in L2 as the serving path leaves them.
4. Serving: ``build_service(models/best_rollout_model.pt,
   models/config.json)`` on the default device behind the HTTP server,
   driven through the port's client: /healthz, /rollout N=200 x 394 steps
   (final state, three times), /rollout 20 steps as npz, /rollout_batch
   B=4 x 50 steps, /simulate N=200 x 100 steps.  Launch counts are zeroed
   just before and read just after; every kernel of the path must have
   run, the edge kernel exactly 6 times per rollout step.  Outputs must be
   finite, of the expected shapes, and agree with a ``device="cpu"`` run
   of the same requests.
5. Profile: one 394-step rollout under torch.profiler, for where the time
   goes (device-busy share, time by kernel).

Then it prints the kernel table as one JSON line, the nvidia-smi line,
and as the last line ``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import threading
import time

import numpy as np

MODEL = "models/best_rollout_model.pt"
CONFIG = "models/config.json"
# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and float32
# operations/s outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
KERNEL_TOL = dict(atol=1e-4, rtol=1e-4)
N, K = 200, 40


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_time_ms(fn, reps: int = 20, inner: int = 50) -> float:
    """Median over ``reps`` of the mean device time of ``inner``
    back-to-back calls, by CUDA events, after a warm-up.  A sleep kernel
    ahead of each batch holds the stream while the host enqueues the
    calls, so the events time the device, not the host's launch rate."""
    import torch

    for _ in range(5):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # ~10 ms of device clock cycles
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def eval_states(b: int, n: int = N):
    """Evaluation-protocol states: box 10, seeds 9999+i, shared masses."""
    from nbody_gnn_hpc_torch.sim import random_initial_conditions, shared_masses

    pos, vel = zip(*[random_initial_conditions(n, 10.0, seed=9999 + i)[:2]
                     for i in range(b)])
    return (np.stack(pos).astype(np.float32), np.stack(vel).astype(np.float32),
            shared_masses(n))


def edge_layer_inputs(model, norm_stats, b: int, n: int, k: int, dev):
    """The operands the serving path hands layer 0's edge kernel."""
    import torch

    from nbody_gnn_hpc_torch.ops import (edge_features, knn_edge_index,
                                         target_csr)

    pos, vel, masses = eval_states(b, n)
    mean = torch.as_tensor(norm_stats["state_mean"], device=dev)
    std = torch.as_tensor(norm_stats["state_std"], device=dev)
    p = (torch.as_tensor(pos, device=dev) - mean[:3]) / std[:3]
    v = (torch.as_tensor(vel, device=dev) - mean[3:]) / std[3:]
    m = torch.as_tensor(masses / masses.mean(), device=dev)
    x = torch.cat([p, v, m[None, :, None].expand(b, n, 1)], dim=-1)
    ei = knn_edge_index(p, k)
    layer = model.layers[0]
    with torch.inference_mode():
        h = model.node_encoder(x)
        return (layer.edge_proj_target(h), layer.edge_proj_source(h),
                edge_features(p, ei),
                layer.edge_proj_attr.weight.t().contiguous(),
                layer.edge_norm.weight.detach(), layer.edge_norm.bias.detach(),
                target_csr(ei, n))


def edge_bound_ms(args) -> tuple:
    """Least H100 time for one fused edge-stream call on these operands:
    each input read once, the output written once, over HBM bandwidth; and
    (13 + 2*D) float32 operations per edge channel (z: 2 adds + D FMAs;
    statistics: 3; normalise: 4; SiLU: exp, add, divide; accumulate: 1)
    over the non-tensor-core float32 peak."""
    tp, sp, ea, we, gamma, beta, edges = args
    b, n, h = tp.shape
    e, d = ea.shape[1], ea.shape[2]
    n_bytes = 4 * (tp.numel() + sp.numel() + ea.numel() + we.numel()
                   + gamma.numel() + beta.numel() + edges.perm.numel()
                   + edges.src.numel() + edges.offsets.numel() + b * n * h)
    flops = (13 + 2 * d) * b * e * h
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def phase_kernels(model, norm_stats, dev):
    import torch

    from nbody_gnn_hpc_torch.ops import (fused_edge_layer,
                                         fused_edge_layer_reference)

    report = {}
    for b, n, k in ((1, N, K), (8, N, K), (1, 13, 4)):
        args = edge_layer_inputs(model, norm_stats, b, n, k, dev)
        before = fused_edge_layer.launches
        got = fused_edge_layer(*args)
        torch.cuda.synchronize()
        check(fused_edge_layer.launches == before + 1,
              "fused_edge_layer did not count its launch")
        want = fused_edge_layer_reference(*args)
        err = (got - want).abs().max().item()
        rel = ((got - want).abs() / want.abs().clamp_min(1e-3)).max().item()
        ok = torch.allclose(got, want, **KERNEL_TOL)
        again = fused_edge_layer(*args)
        same = torch.equal(got, again)
        print(f"  fused_edge B={b} N={n} k={k} H={got.shape[-1]}: max abs "
              f"err {err:.3e}, max rel err {rel:.3e} (tolerance "
              f"atol=rtol=1e-4, f32 sum order) -> "
              f"{'ok' if ok else 'MISMATCH'}; rerun bit-identical: {same}",
              flush=True)
        check(ok, f"fused_edge kernel disagrees with its plain version at "
                  f"B={b} N={n} k={k}")
        check(same, "fused_edge kernel reruns are not bit-identical")
        if (b, n) == (1, N):
            with torch.inference_mode():
                ms = cuda_time_ms(lambda: fused_edge_layer(*args))
                plain_ms = cuda_time_ms(
                    lambda: fused_edge_layer_reference(*args))
            bound, bound_by = edge_bound_ms(args)
            report = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound, "bound_by": bound_by}
            print(f"  fused_edge B=1 N={N} k={K}: kernel {ms:.5f} ms, "
                  f"plain {plain_ms:.5f} ms, bound {bound:.6f} ms "
                  f"({bound_by}); no single PyTorch call computes this "
                  f"function (library_ms null)", flush=True)
        if (b, n) == (8, N):
            with torch.inference_mode():
                ms8 = cuda_time_ms(lambda: fused_edge_layer(*args))
                plain8 = cuda_time_ms(
                    lambda: fused_edge_layer_reference(*args))
            bound8, by8 = edge_bound_ms(args)
            print(f"  fused_edge B=8 N={N} k={K}: kernel {ms8:.5f} ms, "
                  f"plain {plain8:.5f} ms, bound {bound8:.6f} ms ({by8})",
                  flush=True)
    return report


def close_to(got, want, rel_scale: float) -> tuple:
    """Max abs difference, checked against rel_scale * max|want|."""
    diff = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    return diff, diff <= rel_scale * float(np.abs(want).max())


def phase_serving(dev_name):
    import torch

    from nbody_gnn_hpc_torch.client import RolloutClient
    from nbody_gnn_hpc_torch.ops import fused_edge_layer
    from nbody_gnn_hpc_torch.serve import build_service, serve

    service = build_service(MODEL, CONFIG)  # the default device: cuda
    check(service.predictor.device.type == "cuda",
          f"service runs on {service.predictor.device}, not cuda")
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is enabled")
    service.warmup(N, 5)
    service.warmup(N, 5, batch=4)
    httpd = serve(service, host="127.0.0.1", port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    client = RolloutClient(f"http://127.0.0.1:{httpd.server_address[1]}")
    pos, vel, masses = eval_states(4)
    lat = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        lat.setdefault(name, []).append(time.perf_counter() - t0)
        return out

    try:
        fused_edge_layer.launches = 0  # main-path run starts here
        health = timed("healthz", client.healthz)
        finals = [timed("rollout_394_final", lambda: client.rollout(
            pos[0], vel[0], masses, 394, trajectory=False))
            for _ in range(3)]
        traj20 = timed("rollout_20_npz", lambda: client.rollout(
            pos[0], vel[0], masses, 20))
        batch = timed("rollout_batch_4x50", lambda: client.rollout_batch(
            pos, vel, masses, 50, trajectory=False))
        sim = timed("simulate_100", lambda: client.simulate(
            pos[0], vel[0], masses, 100))
        launches = fused_edge_layer.launches  # main-path run ends here
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)

    check(health["status"] == "ok" and health["device"] == dev_name,
          f"/healthz answered {health}")
    for f in finals:
        check(f["positions"].shape == (N, 3)
              and np.isfinite(f["positions"]).all()
              and np.isfinite(f["velocities"]).all(),
              "/rollout 394-step final state has a bad shape or non-finite "
              "values")
        check(np.array_equal(f["positions"], finals[0]["positions"]),
              "repeated /rollout requests differ (not deterministic)")
    check(traj20["positions"].shape == (21, N, 3)
          and np.isfinite(traj20["positions"]).all(),
          "/rollout 20-step npz trajectory is wrong")
    check(batch["positions"].shape == (4, N, 3)
          and np.isfinite(batch["positions"]).all(),
          "/rollout_batch final states are wrong")
    check(sim["positions"].shape == (N, 3)
          and np.isfinite(sim["positions"]).all(), "/simulate is wrong")
    steps = 3 * 394 + 20 + 50
    print(f"  fused_edge launches on the main path: {launches} "
          f"(expected 6 layers x {steps} rollout steps = {6 * steps})",
          flush=True)
    check(launches == 6 * steps,
          f"fused_edge ran {launches} times, expected {6 * steps}")

    # The same requests on the CPU (plain versions) as the reference.
    cpu = build_service(MODEL, CONFIG, device="cpu")
    ref = cpu.rollout(pos[0], vel[0], masses, 5)
    for key in ("positions", "velocities"):
        diff, ok = close_to(traj20[key][:6], ref[key], 1e-4)
        print(f"  /rollout frames 0-5 {key} vs device='cpu': max abs diff "
              f"{diff:.3e} (tolerance 1e-4 of scale: f32 sum order through "
              f"6 LayerNorms per step)", flush=True)
        check(ok, f"/rollout {key} disagree with the CPU run")
    ref_b = cpu.rollout_batch(pos[:2], vel[:2], masses, 5, trajectory=False)
    gpu_b = service.rollout_batch(pos[:2], vel[:2], masses, 5,
                                  trajectory=False)
    diff, ok = close_to(gpu_b["positions"], ref_b["positions"], 1e-4)
    print(f"  rollout_batch 2x5 positions vs device='cpu': max abs diff "
          f"{diff:.3e}", flush=True)
    check(ok, "/rollout_batch disagrees with the CPU run")
    ref_sim = cpu.simulate(pos[0], vel[0], masses, 100)
    for key in ("positions", "velocities"):
        diff, ok = close_to(sim[key], ref_sim[key], 1e-3)
        print(f"  /simulate 100 steps {key} vs device='cpu': max abs diff "
              f"{diff:.3e} (tolerance 1e-3 of scale: f32 force-sum order "
              f"amplified by close encounters)", flush=True)
        check(ok, f"/simulate {key} disagree with the CPU run")
    for name, secs in lat.items():
        print(f"  latency {name}: "
              + ", ".join(f"{s * 1e3:.3f} ms" for s in secs), flush=True)
    return service, launches


def phase_profile(service):
    """One 394-step final-state rollout under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    pos, vel, masses = eval_states(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    service.rollout(pos[0], vel[0], masses, 394, trajectory=False)
    plain_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        service.rollout(pos[0], vel[0], masses, 394, trajectory=False)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = [(e.key, e.device_time_total, e.count)
            for e in prof.key_averages() if e.device_time_total > 0]
    if not rows:
        print("  profile: no device time recorded (not measured)")
        return
    # Kernel rows tile the device timeline; aten:: rows count the same
    # kernels again from the operator side.
    rows = sorted((r for r in rows if not r[0].startswith("aten::")),
                  key=lambda r: -r[1])
    busy_us = sum(t for _, t, _ in rows)
    print(f"  profile 394-step rollout (service call, no HTTP): wall "
          f"{plain_wall * 1e3:.1f} ms unprofiled, {wall * 1e3:.1f} ms "
          f"profiled; device busy {busy_us / 1e3:.1f} ms = "
          f"{100 * busy_us / 1e6 / plain_wall:.1f}% of the unprofiled wall",
          flush=True)
    for key, t, count in rows[:15]:
        print(f"    {t / 1e3:9.3f} ms  {count:6d}x  {key[:90]}", flush=True)


def main() -> int:
    # 1. Environment
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    check(bool(smi), "nvidia-smi printed nothing")
    dev_name = torch.cuda.get_device_name(0)
    print(f"[1] {smi[0]} | torch {torch.__version__} CUDA "
          f"{torch.version.cuda} | {dev_name}", flush=True)
    try:
        from nbody_gnn_hpc_torch.io import load_checkpoint, load_into
        from nbody_gnn_hpc_torch.models import model_from_config
        from nbody_gnn_hpc_torch.ops.cuda_build import build
    except ImportError as e:
        fail(f"the port package is not importable here ({e}); run from the "
             f"root of the repository")

    # 2. Build
    t0 = time.perf_counter()
    built = build(["fused_edge"])
    print(f"[2] built {sorted(built) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name, info in built.items():
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {name}: {line.strip()}", flush=True)

    # 3. Kernels against their plain versions
    print("[3] kernels vs plain versions on the card", flush=True)
    dev = torch.device("cuda")
    with open(CONFIG) as f:
        cfg = json.load(f)["model_config"]
    model = model_from_config(cfg).to(dev).eval()
    norm_stats = load_into(model, load_checkpoint(MODEL))
    edge = phase_kernels(model, norm_stats, dev)

    # 4. Serving main path
    print("[4] serving the production checkpoint", flush=True)
    service, launches = phase_serving(dev_name)

    # 5. Where the time goes
    print("[5] profile", flush=True)
    phase_profile(service)

    table = {"kernels": [{
        "name": "fused_edge_fwd", "route": "cuda",
        "source": "nbody_gnn_hpc_torch/csrc/fused_edge.cu",
        "replaces": "nbody_gnn_hpc_tpu/ops/fused_edge.py:91",
        "launches": launches, "max_abs_err": edge["max_abs_err"],
        "ms": edge["ms"], "plain_ms": edge["plain_ms"],
        "bound_ms": edge["bound_ms"], "bound_by": edge["bound_by"],
        "library_ms": None}]}
    check(all(k["launches"] > 0 for k in table["kernels"]),
          "a kernel of the path was never launched")
    print(json.dumps(table), flush=True)
    print(smi[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
