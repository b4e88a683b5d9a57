#!/usr/bin/env python3
"""Drive the PyTorch port's serving and training paths on one NVIDIA GPU
and check them.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Environment: the card's name and power limit (nvidia-smi); no CUDA
   device is a failure.
2. Build every CUDA kernel of the paths from ``nbody_gnn_hpc_torch/csrc``
   (one nvcc per source, all started together).
3. Each kernel against its plain PyTorch version on the card, on the
   production checkpoint's layer-0 operands with evaluation-protocol states
   (box 10, seeds 9999+i, masses from seed 42): the edge forward (kernel 1)
   in inference form at B=1, 8 and in training form (dropout p=0.1, fixed
   seed, the same Philox mask on both sides) at B=1, 24, and the edge
   backward (kernel 2) at B=1, 24, all at N=200, k=40, H=256, plus an odd
   N=13, k=4.  Tolerances: forward atol=rtol=1e-4; backward 1e-4 of each
   gradient's scale (float32 sum order only).  Reruns must be
   bit-identical (no float atomics).  Times with CUDA events, bounds from
   the bytes and float32 operations of each call; the keep fraction of the
   mask against 1-p.
4. Serving: ``build_service(models/best_rollout_model.pt,
   models/config.json)`` on the default device behind the HTTP server,
   driven through the port's client: /healthz, /rollout N=200 x 394 steps
   (final state, three times), /rollout 20 steps as npz, /rollout_batch
   B=4 x 50 steps, /simulate N=200 x 100 steps.  Launch counts are zeroed
   just before and read just after; the edge forward must run exactly 6
   times per rollout step, the backward never.  Outputs must be finite, of
   the expected shapes, and agree with a ``device="cpu"`` run.
5. Profile: one 394-step rollout under torch.profiler, for where the time
   goes (device-busy share, time by kernel).
6. Training, the second main path: 10 trajectories made on the card by the
   port's simulator (N=200, box 10, shared masses, dt 0.001, 40 steps),
   ``GNNDataset.from_trajectories`` (8 train, 2 validation on the train
   statistics), ``Trainer`` on cuda with the production ``TrainingConfig``
   (hidden 256, 6 layers, k=40, batch 24, dropout 0.1, noise 0.003, AdamW
   5e-4 / 1e-4, clip 1.0), 2 epochs.  Counts zeroed just before and read
   just after: forward 6 x (train steps + validation batches), backward
   6 x train steps.  Losses finite; the loss of a fixed batch (dropout and
   noise off) falls over 15 more steps on it.  On one batch with the production checkpoint's parameters the
   gradients of all 2,550,150 parameters through the kernels agree with
   the plain-version path (same seeds, same masks) to 1e-3 of each
   tensor's scale.  The saved best_model.pt is served for 20 rollout steps
   (train -> serve).  Median step wall time and a profiled window.

Then it prints the kernel table as one JSON line, the nvidia-smi line,
and as the last line ``{"ok": true, "device": {...}}``.
"""

import json
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

MODEL = "models/best_rollout_model.pt"
CONFIG = "models/config.json"
# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and float32
# operations/s outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
KERNEL_TOL = dict(atol=1e-4, rtol=1e-4)
# Kernel 2's gradients against the plain backward: float32 sums of up to
# B*E = 192k edge terms in another order, relative to each gradient's
# scale.  The model's gradients through six layers (forward and backward
# through the LayerNorms) get ten times that.
GRAD_RTOL = 1e-4
MODEL_GRAD_RTOL = 1e-3
N, K = 200, 40
DROPOUT_P = 0.1
DROP_SEED = 20261016
TRAIN_DIR = Path("build/chip_smoke_train")  # git-ignored


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
                target_csr(ei, n, sources=True))


def _bound(n_bytes: int, flops: int) -> tuple:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def _operand_bytes(args) -> int:
    tp, sp, ea, we, gamma, beta, edges = args
    return 4 * (tp.numel() + sp.numel() + ea.numel() + we.numel()
                + gamma.numel() + beta.numel() + edges.perm.numel()
                + edges.src.numel() + edges.offsets.numel())


def edge_bound_ms(args, dropout: bool = False) -> tuple:
    """Least H100 time for one fused edge-stream forward on these
    operands: each input read once, the output written once, over HBM
    bandwidth; and (13 + 2*D) float32 operations per edge channel (z: 2
    adds + D FMAs; statistics: 3; normalise: 4; SiLU: exp, add, divide;
    accumulate: 1), one more with dropout (the scale), over the
    non-tensor-core float32 peak.  Philox's integer work is not counted."""
    tp, ea = args[0], args[2]
    b, n, h = tp.shape
    e, d = ea.shape[1], ea.shape[2]
    n_bytes = _operand_bytes(args) + 4 * b * n * h
    return _bound(n_bytes, (13 + 2 * d + int(dropout)) * b * e * h)


def edge_bwd_bound_ms(args, dropout: bool = False) -> tuple:
    """Least H100 time for one edge-stream backward as training calls it
    (no d_edge_attr): reads the operands, both CSRs and g_out, writes
    d_t_proj, d_s_proj and the (D+2, H) parameter gradients; (30 + 4*D)
    float32 operations per edge channel to recompute the stream and form
    dz and its sums (z and statistics 5+2D; x, y 4; sigmoid 3; silu' and
    dy 5; dy*gamma 1; the two means 3; dz 4; d_t_proj, d_s_proj, d_gamma,
    d_beta 5; d_w_e 2D), one more with dropout; Philox not counted."""
    tp, ea, edges = args[0], args[2], args[6]
    b, n, h = tp.shape
    e, d = ea.shape[1], ea.shape[2]
    src = edges.sources
    n_bytes = (_operand_bytes(args) + 4 * (src.perm.numel() + src.dst.numel()
                                           + src.offsets.numel())
               + 4 * b * n * h * 3 + 4 * (d + 2) * h)
    return _bound(n_bytes, (30 + 4 * d + int(dropout)) * b * e * h)


def _grad_errors(got, want) -> tuple:
    """(max abs error, max error relative to each gradient's scale) of
    kernel 2's six gradients against the plain backward's."""
    abs_err = rel_err = 0.0
    for g, w in zip(got, want):
        err = (g - w).abs().max().item()
        abs_err = max(abs_err, err)
        rel_err = max(rel_err, err / (w.abs().max().item() + 1e-6))
    return abs_err, rel_err


def _timed_row(rows, kernel, form, b, n, k, fn, plain_fn, bound, reps):
    ms = cuda_time_ms(fn)
    plain_ms = cuda_time_ms(plain_fn, *reps)
    row = {"kernel": kernel, "form": form, "B": b, "N": n, "k": k, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1]}
    rows.append(row)
    print(f"  {kernel} {form} B={b} N={n} k={k}: kernel {ms:.5f} ms, plain "
          f"{plain_ms:.5f} ms, bound {bound[0]:.6f} ms ({bound[1]}); no "
          f"single PyTorch call computes this function (library_ms null)",
          flush=True)


def phase_kernels(model, norm_stats, dev):
    """Both kernels against their plain versions (called under
    inference_mode: the kernels are called directly, not through
    autograd); returns the timed rows and each kernel's largest absolute
    error."""
    import torch

    from nbody_gnn_hpc_torch.ops import (dropout_keep, fused_edge_backward,
                                         fused_edge_backward_reference,
                                         fused_edge_layer,
                                         fused_edge_layer_reference)

    seed = torch.tensor([DROP_SEED], dtype=torch.int32, device=dev)
    rows, errs = [], {"fused_edge_fwd": 0.0, "fused_edge_bwd": 0.0}
    for b, n, k in ((1, N, K), (8, N, K), (24, N, K), (1, 13, 4)):
        args = edge_layer_inputs(model, norm_stats, b, n, k, dev)
        full = (n, k) == (N, K)
        forms = [("inference", None, 0.0)]
        if b != 8:
            forms.append(("training", seed, DROPOUT_P))
        for form, sd, p in forms:
            before = fused_edge_layer.launches
            got = fused_edge_layer(*args, sd, dropout_p=p,
                                   deterministic=sd is None)
            torch.cuda.synchronize()
            check(fused_edge_layer.launches == before + 1,
                  "fused_edge_layer did not count its launch")
            want = fused_edge_layer_reference(*args, sd, p)
            err = (got - want).abs().max().item()
            ok = torch.allclose(got, want, **KERNEL_TOL)
            same = torch.equal(got, fused_edge_layer(
                *args, sd, dropout_p=p, deterministic=sd is None))
            errs["fused_edge_fwd"] = max(errs["fused_edge_fwd"], err)
            print(f"  fused_edge_fwd {form} B={b} N={n} k={k}: max abs err "
                  f"{err:.3e} (tolerance atol=rtol=1e-4, f32 sum order) -> "
                  f"{'ok' if ok else 'MISMATCH'}; rerun bit-identical: "
                  f"{same}", flush=True)
            check(ok, f"fused_edge_fwd ({form}) disagrees with its plain "
                      f"version at B={b} N={n} k={k}")
            check(same, "fused_edge_fwd reruns are not bit-identical")
            if full and b in ((1, 8) if sd is None else (1, 24)):
                _timed_row(rows, "fused_edge_fwd", form, b, n, k,
                           lambda: fused_edge_layer(
                               *args, sd, dropout_p=p,
                               deterministic=sd is None),
                           lambda: fused_edge_layer_reference(*args, sd, p),
                           edge_bound_ms(args, sd is not None),
                           (5, 10) if b == 24 else ())
        if b == 8:
            continue
        g_out = torch.randn(args[0].shape, device=dev,
                            generator=torch.Generator(dev).manual_seed(b))
        before = fused_edge_backward.launches
        got = fused_edge_backward(*args, g_out, seed, DROPOUT_P)
        torch.cuda.synchronize()
        check(fused_edge_backward.launches == before + 1,
              "fused_edge_backward did not count its launch")
        want = fused_edge_backward_reference(*args, g_out, seed, DROPOUT_P)
        err, rel = _grad_errors(got, want)
        again = fused_edge_backward(*args, g_out, seed, DROPOUT_P)
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        errs["fused_edge_bwd"] = max(errs["fused_edge_bwd"], err)
        print(f"  fused_edge_bwd training B={b} N={n} k={k}: six gradients, "
              f"max abs err {err:.3e}, max err / gradient scale {rel:.3e} "
              f"(tolerance {GRAD_RTOL:g}, f32 sum order) -> "
              f"{'ok' if rel <= GRAD_RTOL else 'MISMATCH'}; rerun "
              f"bit-identical: {same}", flush=True)
        check(rel <= GRAD_RTOL, f"fused_edge_bwd disagrees with its plain "
                                f"version at B={b} N={n} k={k}")
        check(same, "fused_edge_bwd reruns are not bit-identical")
        if full:
            _timed_row(rows, "fused_edge_bwd", "training", b, n, k,
                       lambda: fused_edge_backward(
                           *args, g_out, seed, DROPOUT_P,
                           need_d_edge_attr=False),
                       lambda: fused_edge_backward_reference(
                           *args, g_out, seed, DROPOUT_P),
                       edge_bwd_bound_ms(args, True),
                       (5, 10) if b == 24 else ())
        if b == 24:
            keep = dropout_keep(seed, DROPOUT_P, b, args[2].shape[1],
                                args[0].shape[2]).float().mean().item()
            print(f"  dropout mask B=24 x E=8000 x H=256: keep fraction "
                  f"{keep:.6f} (expected {1 - DROPOUT_P}; binomial sd "
                  f"{np.sqrt(0.09 / (24 * 8000 * 256)):.1e})", flush=True)
            check(abs(keep - (1 - DROPOUT_P)) < 1e-3, "dropout keep fraction")
    return rows, errs


def close_to(got, want, rel_scale: float) -> tuple:
    """Max abs difference, checked against rel_scale * max|want|."""
    diff = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    return diff, diff <= rel_scale * float(np.abs(want).max())


def phase_serving(dev_name):
    import torch

    from nbody_gnn_hpc_torch.client import RolloutClient
    from nbody_gnn_hpc_torch.ops import fused_edge_backward, fused_edge_layer
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
        # main-path run starts here
        fused_edge_layer.launches = fused_edge_backward.launches = 0
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
        # main-path run ends here
        launches = fused_edge_layer.launches
        bwd_launches = fused_edge_backward.launches
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
    check(bwd_launches == 0, "serving launched the backward kernel")

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


def profile_window(label: str, fn) -> None:
    """Run ``fn`` once plain and once under torch.profiler; print the wall
    times, the device-busy share and the top kernels by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # Only the device-side rows (kernels, memsets, copies) tile the device
    # timeline; operator, autograd and annotation rows (such as
    # Optimizer.step) count the same kernels again.
    rows = sorted(((e.key, e.device_time_total, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not e.is_user_annotation
                   and e.device_time_total > 0), key=lambda r: -r[1])
    if not rows:
        print(f"  profile {label}: no device time recorded (not measured)")
        return
    busy_us = sum(t for _, t, _ in rows)
    print(f"  profile {label}: wall {plain_wall * 1e3:.1f} ms unprofiled, "
          f"{wall * 1e3:.1f} ms profiled; device busy {busy_us / 1e3:.1f} ms "
          f"= {100 * busy_us / 1e6 / plain_wall:.1f}% of the unprofiled wall",
          flush=True)
    for key, t, count in rows[:15]:
        print(f"    {t / 1e3:9.3f} ms  {count:6d}x  {key[:90]}", flush=True)


def phase_profile(service):
    """One 394-step final-state rollout under torch.profiler."""
    pos, vel, masses = eval_states(1)
    profile_window("394-step rollout (service call, no HTTP)",
                   lambda: service.rollout(pos[0], vel[0], masses, 394,
                                           trajectory=False))


def training_data(dev, cfg):
    """10 trajectories on the card (port simulator, the datagen protocol:
    N=200, box 10, shared masses, dt 0.001, seeds 42+i; 40 steps) -> train
    (8) and validation (2, on the train statistics) datasets."""
    from nbody_gnn_hpc_torch.sim import (accelerations, make_state,
                                         random_initial_conditions,
                                         run_trajectory, shared_masses)
    from nbody_gnn_hpc_torch.train import GNNDataset

    masses = shared_masses(N)  # the datagen protocol: seed 42, 42 + i
    ics = [random_initial_conditions(N, 10.0, seed=42 + s)[:2]
           for s in range(10)]
    state = make_state(np.stack([p for p, _ in ics]),
                       np.stack([v for _, v in ics]),
                       np.tile(masses, (10, 1)), device=dev)
    state = state._replace(accelerations=accelerations(state.positions,
                                                       state.masses))
    traj = run_trajectory(state, 0.001, 40)
    trajs = [dict(positions=traj.positions[:, i],
                  velocities=traj.velocities[:, i], masses=masses)
             for i in range(10)]
    kw = dict(sequence_length=cfg.sequence_length,
              k_neighbors=cfg.k_neighbors)
    train = GNNDataset.from_trajectories(trajs[:8], **kw)
    val = GNNDataset.from_trajectories(
        trajs[8:], external_norm_stats=train.get_normalization_stats(), **kw)
    return train, val


def model_gradients_agree(train, cfg, dev) -> float:
    """Gradients of every parameter of the production checkpoint on one
    training batch (dropout and noise on), through the kernels and through
    the plain versions with the same generator seed (so the same masks).
    Returns the largest error relative to each tensor's scale."""
    import torch

    from nbody_gnn_hpc_torch.io import load_checkpoint, load_into
    from nbody_gnn_hpc_torch.models import count_parameters, model_from_config
    from nbody_gnn_hpc_torch.ops import fused_edge_layer, fused_edge_layer_plain
    from nbody_gnn_hpc_torch.train import make_optimizer, make_train_step

    with open(CONFIG) as f:
        model = model_from_config(json.load(f)["model_config"]).to(dev)
    load_into(model, load_checkpoint(MODEL))
    masses = torch.as_tensor(train.get_masses_tensor(), device=dev)
    step = make_train_step(
        model, make_optimizer(model, cfg.learning_rate, cfg.weight_decay),
        train.edge_index, train.state_mean, train.state_std,
        (masses / masses.mean())[:, None], noise_std=cfg.noise_std,
        masses=masses)
    states = torch.as_tensor(train.last_states[:cfg.batch_size], device=dev)
    targets = torch.as_tensor(train.targets[:cfg.batch_size], device=dev)

    def grads(edge_stream):
        for layer in model.layers:
            layer.edge_stream = edge_stream
        model.zero_grad(set_to_none=True)
        loss, _ = step.compute_loss(
            states, targets, torch.Generator(dev).manual_seed(321))
        loss.backward()
        return loss.item(), [p.grad.clone() for p in model.parameters()]

    loss_k, g_k = grads(fused_edge_layer)
    loss_p, g_p = grads(fused_edge_layer_plain)
    n = sum(g.numel() for g in g_k)
    check(n == count_parameters(model) == 2_550_150, "parameter count")
    rel = max((a - b).abs().max().item() / (b.abs().max().item() + 1e-12)
              for a, b in zip(g_k, g_p))
    zero = sum(int(b.abs().max().item() == 0) for b in g_p)
    print(f"  gradients of all {n:,} parameters, kernels vs plain versions "
          f"(production checkpoint, B={cfg.batch_size}, dropout + noise on, "
          f"same seeds): loss {loss_k:.7f} vs {loss_p:.7f}; max error / "
          f"tensor scale {rel:.3e} over {len(g_k)} tensors (tolerance "
          f"{MODEL_GRAD_RTOL:g}); tensors with an all-zero gradient: {zero}",
          flush=True)
    check(abs(loss_k - loss_p) <= 1e-5 * abs(loss_p), "losses disagree")
    check(rel <= MODEL_GRAD_RTOL, "kernel-path gradients disagree with the "
                                  "plain-version path")
    return rel


def phase_train(dev):
    """The training main path; returns its launch counts."""
    import torch

    from nbody_gnn_hpc_torch.config import TrainingConfig
    from nbody_gnn_hpc_torch.models import NBodyGNN, count_parameters
    from nbody_gnn_hpc_torch.ops import fused_edge_backward, fused_edge_layer
    from nbody_gnn_hpc_torch.serve import build_service
    from nbody_gnn_hpc_torch.train import Trainer

    cfg = TrainingConfig()  # production: batch 24, hidden 256, 6 layers
    t0 = time.perf_counter()
    train, val = training_data(dev, cfg)
    print(f"  data: {train.n_samples} train / {val.n_samples} validation "
          f"samples from trajectories made on the card, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    trainer = Trainer(
        NBodyGNN(hidden_dim=cfg.hidden_dim, n_layers=cfg.n_layers,
                 dropout=cfg.dropout), train, val, model_dir=str(TRAIN_DIR),
        device=dev, learning_rate=cfg.learning_rate,
        batch_size=cfg.batch_size, weight_decay=cfg.weight_decay,
        noise_std=cfg.noise_std, n_epochs=2, seed=7)
    check(trainer.device.type == "cuda", "trainer is not on cuda")
    check(count_parameters(trainer.model) == 2_550_150, "parameter count")
    val_batches = -(-val.n_samples // cfg.batch_size)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # main-path run starts here
    fused_edge_layer.launches = fused_edge_backward.launches = 0
    history = trainer.train(n_epochs=2,
                            early_stopping_patience=cfg.early_stopping,
                            save_every=10)
    fwd, bwd = fused_edge_layer.launches, fused_edge_backward.launches
    # main-path run ends here
    wall = time.perf_counter() - t0
    steps = 2 * trainer.steps_per_epoch
    want_fwd, want_bwd = 6 * (steps + 2 * val_batches), 6 * steps
    print(f"  2 epochs, {steps} steps at B={cfg.batch_size} + "
          f"{2 * val_batches} validation batches in {wall:.2f} s; peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB; step losses {['%.4f' % x for x in trainer.step_losses]}",
          flush=True)
    print(f"  launches on the training path: fused_edge_fwd {fwd} (expected "
          f"6 x ({steps} + {2 * val_batches}) = {want_fwd}), fused_edge_bwd "
          f"{bwd} (expected 6 x {steps} = {want_bwd})", flush=True)
    check(fwd == want_fwd and bwd == want_bwd, "training launch counts")
    losses = trainer.step_losses + history["val_loss"]
    check(bool(np.isfinite(losses).all()), "a training loss is not finite")
    # Reported, not checked: the per-batch loss of this physics spans orders
    # of magnitude (the kinetic-energy term of close encounters), so epoch
    # means over 10 steps are noise (the JAX package's production history
    # is flat too: 4361.5 -> 4361.9 over epochs 1-4).
    print(f"  first step's loss {trainer.step_losses[0]:.4f}; epoch means "
          f"{['%.4f' % x for x in history['train_loss']]}; validation "
          f"{['%.4f' % x for x in history['val_loss']]}", flush=True)

    # Step time after warm-up and a profiled window, all on one fixed
    # batch; checked: its loss (dropout and noise off) falls over those
    # 15 optimizer steps.
    ids = torch.arange(cfg.batch_size, device=dev)
    s, t = trainer.train_states[ids], trainer.train_targets[ids]
    with torch.no_grad():
        before = trainer._step.compute_loss(s, t, deterministic=True)[0].item()
    times = []
    for _ in range(12):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer._step(s, t, trainer.generator)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    print(f"  train step wall (B={cfg.batch_size}, synchronised, after 2 "
          f"warm-up): median {np.median(times[2:]) * 1e3:.2f} ms, min "
          f"{min(times[2:]) * 1e3:.2f} ms, max {max(times[2:]) * 1e3:.2f} ms",
          flush=True)
    profile_window("3 train steps", lambda: [
        trainer._step(s, t, trainer.generator) for _ in range(3)])
    with torch.no_grad():
        after = trainer._step.compute_loss(s, t, deterministic=True)[0].item()
    print(f"  fixed batch, loss with dropout and noise off: {before:.6f} "
          f"before, {after:.6f} after 15 steps on it", flush=True)
    check(after < before, "15 optimizer steps on one batch did not lower "
                          "its loss")

    model_gradients_agree(train, cfg, dev)

    # train -> serve: the checkpoint the trainer saved, on the card.
    with open(TRAIN_DIR / "config.json", "w") as f:
        json.dump({"model_type": "gnn", "model_config": trainer._model_config,
                   "training_config": cfg.to_dict()}, f, indent=2)
    served = build_service(str(TRAIN_DIR / "best_model.pt"),
                           str(TRAIN_DIR / "config.json"))
    pos, vel, masses = eval_states(1)
    out = served.rollout(pos[0], vel[0], masses, 20)
    check(out["positions"].shape == (21, N, 3)
          and np.isfinite(out["positions"]).all()
          and np.isfinite(out["velocities"]).all(),
          "the trained checkpoint's rollout is wrong")
    ref = build_service(str(TRAIN_DIR / "best_model.pt"),
                        str(TRAIN_DIR / "config.json"), device="cpu").rollout(
        pos[0], vel[0], masses, 5)
    diff, ok = close_to(out["positions"][:6], ref["positions"], 1e-4)
    print(f"  served the trained best_model.pt: 20-step rollout finite; "
          f"frames 0-5 vs device='cpu' max abs diff {diff:.3e}", flush=True)
    check(ok, "the trained checkpoint's rollout disagrees with the CPU run")
    return fwd, bwd


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
    t_start = time.perf_counter()

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
    with torch.inference_mode():
        rows, errs = phase_kernels(model, norm_stats, dev)

    # 4. Serving main path
    print("[4] serving the production checkpoint", flush=True)
    service, serve_fwd = phase_serving(dev_name)

    # 5. Where the serving time goes
    print("[5] profile", flush=True)
    phase_profile(service)

    # 6. Training main path
    print("[6] training the production-width model", flush=True)
    train_fwd, train_bwd = phase_train(dev)

    def main_row(kernel):
        return next(r for r in rows if r["kernel"] == kernel
                    and r["form"] == "training" and r["B"] == 24)

    table = {"kernels": []}
    for name, replaces, launches, by_path in (
            ("fused_edge_fwd", "nbody_gnn_hpc_tpu/ops/fused_edge.py:91 "
             "(and ops/fused_edge_batched.py:91)", serve_fwd + train_fwd,
             {"serving": serve_fwd, "training": train_fwd}),
            ("fused_edge_bwd", "nbody_gnn_hpc_tpu/ops/fused_edge.py:114 "
             "(and ops/fused_edge_batched.py:123)", train_bwd,
             {"serving": 0, "training": train_bwd})):
        row = main_row(name)
        table["kernels"].append({
            "name": name, "route": "cuda",
            "source": "nbody_gnn_hpc_torch/csrc/fused_edge.cu",
            "replaces": replaces, "launches": launches,
            "launches_by_path": by_path, "max_abs_err": errs[name],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "shape": "training form, B=24 N=200 k=40 "
                                         "H=256",
            "by_shape": [r for r in rows if r["kernel"] == name]})
    check(all(k["launches"] > 0 for k in table["kernels"]),
          "a kernel of the paths was never launched")
    print(f"  chip_smoke took {time.perf_counter() - t_start:.1f} s after "
          f"the imports", flush=True)
    print(json.dumps(table), flush=True)
    print(smi[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
