#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, simulator, deployed-serving,
ceilings and rollout fine-tune paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py
    python3 chip_smoke.py --full-finetune   # the production curriculum

Phases (any failure exits non-zero and prints no result line):

1. Environment: the card's name and power limit (nvidia-smi); no CUDA
   device is a failure.
2. Build every CUDA kernel of the paths from ``nbody_gnn_hpc_torch/csrc``
   (one nvcc per source, all started together).
3. Each kernel against its plain PyTorch version on the card, on the
   production checkpoint's layer-0 operands with evaluation-protocol states
   (box 10, seeds 9999+i, masses from seed 42): the edge forward (kernel 1)
   in inference form at B=1, 8, 10 and in training form (dropout p=0.1,
   fixed seed, the same Philox mask on both sides) at B=1, 24, and the edge
   backward (kernel 2) in training form (dropout) at B=1, 24 and in the
   rollout fine-tune's form (no dropout, with d_edge_attr) at B=8, each
   with and without d_edge_attr, all at N=200, k=40, H=256, plus an odd
   N=13, k=4; kernels 1 and 2 also in both forms on two states with hubs
   (half the particles in a small ball; every second edge sent to one
   target), each input's largest in-degree printed.  Kernel 1 must be zero
   wherever its plain version is, kernel 2's d_t_proj and d_s_proj rows
   zero for nodes without edges.  Tolerances: forward atol=rtol=1e-4
   against the plain version evaluated in float64 (the float32 one sums
   with atomics, in an order that changes between runs); backward 1e-4 of
   each gradient's scale (float32 sum order only).  Kernel 2's timed rows
   also give each of its launches' device time (torch.profiler).  The
   direct-force kernels: tiled (kernel 3) and symmetric (kernel 6) at
   N=10,000, 2,085 and 700, kernel 6 also at the edges of its schedule
   (``SYM_EDGE_N``), small (kernel 4) at (B, N) = (300, 200), (100, 200),
   (1, 200), (3, 13), (2000, 13), (2000, 1024) and (256, 926), rtol 2e-4
   with atol 1e-5 of the force scale; kernel 6 against kernel 3; momentum
   neutrality; a coincident heavy pair; zero-mass rows.
   The moment form
   (kernel 5, tensor-core products, dispatched by nothing) at N=700 offset
   by 300 and N=2,085, rtol 2e-4 with atol 2e-5 of scale, and at N=10,000
   against a float64 direct sum at the same tolerance, its per-particle
   difference from its plain version and from kernel 6 reported; it must
   then stay unlaunched on every path below (its launches are this
   script's own, "oracle").  Reruns must be
   bit-identical (no float atomics).  Times with CUDA events, bounds from
   the bytes and float32 operations of each call; the keep fraction of the
   mask against 1-p.  The whole-layer kernel (kernel 7) on the checkpoint's
   layer 0 against ``fused_full_layer_reference`` at B=1, 8 (inference
   form), B=24 (training form: edge dropout and node mask) and N=13, 1e-4
   of the output's scale; its ordinary-launch form (one launch a phase)
   bit-equal to the cooperative one; one layer's gradients against the
   plain composition at 1e-3 of scale; timed beside the port's composed
   layer (two cuBLAS projections, kernel 1, the node side in PyTorch), its
   plain version and its bound, and against its time before the redesign.
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
   tensor's scale.  The same through ``edge_impl="fused_full"`` (kernel 7 forward, kernel 2
   in its backward).  The saved best_model.pt is served for 20 rollout
   steps (train -> serve).  Median step wall time and a profiled window.
7. The simulator side, the third main path.  The ensemble force is timed
   both ways (plain broadcast form, kernel 4) on the production datagen
   shape, 300 sims x 400 steps x N=200.  Then, counts zeroed just before
   and read just after: (a) ``simulate_ensemble`` at that shape (kernel 4
   once per step plus once for the initial force), early frames against a
   ``device="cpu"`` run, energy and momentum finite, a slice of it through
   ``GNNDataset.from_trajectories``; (b) /simulate over HTTP at N=10,000
   x 20 steps and N=2,085 x 50 steps (kernel 6 once per step plus once per
   request), first frames against the ``device="cpu"`` service; (c)
   ``evaluate`` of the production checkpoint against the float64 oracle,
   10 sims x 400 steps: position RMSE < 60 and velocity RMSE < 400.  After
   the counts are read: the large-N dispatch against kernel 3 as the
   oracle on the N=10,000 state (kernel 3 is dispatched by no entry point;
   these launches are reported apart, as "oracle"), and, where h5py is
   importable, the ``generate_data`` command at the datagen shape with
   HDF5 files, a rerun that must resume, and ``datasets_from_manifest``.
8. Serving as it is deployed, the fourth main path: the production
   checkpoint under a config that names ``edge_impl: "fused_full"`` (written
   to a temporary directory), ``build_replica_pool(n_replicas=1)`` +
   ``MicroBatcher(max_batch=8)`` + ``max_inflight`` over HTTP.  Counts
   zeroed just before and read just after: 8 concurrent 394-step
   final-state /rollout requests coalesce into fewer than 8
   ``rollout_batch`` dispatches; kernel 7 runs exactly 6 x 394 x dispatches
   times and kernel 1 never; then ``evaluate`` through ``fused_full``
   (kernel 7 6 x 394 times, RMSE inside the band).  Checked after: each
   answer against the direct single service (5-step trajectories 1e-5 of
   scale, 394-step finals 1e-3: float32 summation order of the batched
   products, amplified over the rollout); frames 0-5 within 1e-4 of scale
   of the ``"fused"`` service and of ``device="cpu"``; /healthz reports
   replicas, edge_impl and quantization; a saturated gate answers 503 with
   Retry-After; int8 and bf16 services against float32 (5e-2 / 2e-2 of
   scale, tests/test_quantize.py); an int8 checkpoint written, reloaded and
   served.  One 394-step rollout of either service under torch.profiler.
9. The card's ceilings, the fifth main path: the rate probes (kernels 10
   and 11) against their plain versions, rtol 1e-5, in each of the five
   forms the measurement launches at its own shape: the one-accumulator
   FMA and rsqrt chains at (1024, 1024) x 4,096 steps, the 4-accumulator
   FMA chain at (512, 512) x 4,096 and the Pallas kernels' form at
   (256, 1024) x 1,024, the last timed; then, counts zeroed just before and read just after, the
   measurement of ``python -m nbody_gnn_hpc_torch.roofline`` in process
   (dependent and 4-accumulator chains, both probes, the bf16 product
   chain), its JSON line printed; any rate above 105 % of its published
   peak fails (the timer would be wrong).

10. The rollout fine-tune and checkpoint selection, the sixth main path,
   on phase 7's datagen states (the first 240 sims train, 240-243 score):
   (a) gradients of the unrolled loss for all 2,550,150 parameters of
   ``models/best_model.pt`` at B=8 and K = 1, 2, 4, 8, through the kernels
   and through the plain versions (the gradient reaches each step's edge
   features through kernel 2's ``d_edge_attr``), for ``fused`` and
   ``fused_full``; K=8 within 1e-3 of each tensor's scale.  Counts zeroed
   just before and read just after: (b) ``finetune_rollout`` over the cut
   curriculum 8:100,16:40 (``log_every`` 20) through ``fused``, then one
   rung 8:20 through ``fused_full``: kernel 1 (or 7) 6 K times for each
   update and validation, kernel 2 6 K times for each update; rung 1's
   validation loss must fall.  After: synchronised step times and one
   step's peak memory at K=8 and 16, (c) three K=8 steps under
   torch.profiler with kernel 2's split, (d) ``score_checkpoints`` of
   ``best_model.pt`` and ``best_rollout_model.pt`` at horizon 395 from
   step 5: the second must win.

Then it prints the kernel table as one JSON line, the nvidia-smi line,
and as the last line ``{"ok": true, "device": {...}}``.

``--full-finetune`` runs phases 1 and 2, simulates the datagen states and
fine-tunes ``models/best_model.pt`` with the production curriculum
8:1500,16:900 on the first 240 sims through the command's own code
(``finetune_rollout.finetune_curriculum``, the watchdog armed), saving
``build/chip_smoke_finetune/best_rollout_model.pt``; then ``evaluate
--f64-ground-truth`` of that file (inside < 60 / < 400) and its score
against its base and the committed fine-tune (it must beat its base); it
ends with a JSON summary line, the nvidia-smi line and the same last line.
"""

import json
import re
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

try:  # the port's published peaks and device timer
    from nbody_gnn_hpc_torch.roofline import (PEAK_BYTES_PER_S, PEAK_F32_PER_S,
                                              PEAK_RSQRT_PER_S, cuda_time_ms,
                                              kernel_times_ms)
except ImportError as e:
    print(f"chip_smoke FAILED: the port package is not importable here ({e}); "
          f"run from the root of the repository", flush=True)
    sys.exit(1)

MODEL = "models/best_rollout_model.pt"
CONFIG = "models/config.json"
# Kernel 1 against its plain version evaluated in float64: the float32 plain
# version sums a target's edges with atomics (scatter_add_), in an order that
# changes from run to run. At a hub of 4,000 edges (values up to ~5,000) its
# own error reaches 3.5e-2 and failed this tolerance in one run of four; the
# kernel's is 1.0e-3.
KERNEL_TOL = dict(atol=1e-4, rtol=1e-4)
# Kernel 2's gradients against the plain backward: float32 sums of up to
# B*E = 192k edge terms in another order, relative to each gradient's
# scale.  The model's gradients through six layers (forward and backward
# through the LayerNorms) get ten times that.
GRAD_RTOL = 1e-4
MODEL_GRAD_RTOL = 1e-3
# Kernel 7 against its plain version, of the output's scale: six float32
# products of depth 256-512 and two LayerNorms in another summation order.
FULL_RTOL_OF_SCALE = 1e-4
# Kernel 7's times before its redesign (8-row tiles, two phases), by form
# and batch: this script on an NVIDIA H100 80GB HBM3 at 700 W.
FULL_MS_BEFORE_REDESIGN = {("inference", 1): 0.16216,
                           ("inference", 8): 0.22350,
                           ("training", 24): 0.67023}
N, K = 200, 40
DROPOUT_P = 0.1
DROP_SEED = 20261016
TRAIN_DIR = Path("build/chip_smoke_train")  # git-ignored
SIM_DIR = Path("build/chip_smoke_sim")      # git-ignored
SERVE_DIR = Path("build/chip_smoke_serve")  # git-ignored
FINETUNE_DIR = Path("build/chip_smoke_finetune")  # git-ignored
ROLLOUT_STEPS = 394  # the evaluation protocol's rollout
# Quantized services against float32 over 5 steps, of the position scale
# (tests/test_quantize.py).
QUANT_RTOL = {"bf16": 2e-2, "int8": 5e-2}
# The force kernels against their plain versions, as the JAX package's
# kernel tests: float32 sum order and rsqrt rounding.
FORCE_RTOL, FORCE_ATOL_OF_SCALE = 2e-4, 1e-5
# Kernel 5 (the moment form) against its plain version: the JAX package's
# test of that form (tests/test_ops.py:178), whose centring cancellation
# amplifies the rounding of the closest pairs.
MXU_ATOL_OF_SCALE = 2e-5
# float32 adds and multiplies the function needs per pair (an FMA is two),
# whatever implements it.  An ordered pair (kernels 3, 4): 3 subtractions
# for the displacement, 3 multiplies + 3 adds for d^2 + eps^2, 2 multiplies
# for r^-3 from the rsqrt, 1 by G*m_j, 3 multiplies + 3 adds into the
# accumulators.  An unordered pair (kernel 6): the same 11 up to r^-3, 2
# multiplies by G*m_j and G*m_i, 6 multiplies + 6 adds into both sides'
# accumulators.  The compare-select of the coincident-pair mask is no float
# operation.
FLOPS_PER_ORDERED_PAIR, FLOPS_PER_UNORDERED_PAIR = 18, 25
# Kernels 10 and 11 against their plain versions: rsqrtf is approximate and
# the rsqrt recurrence contracts; the plain FMA rounds once, as the kernel's.
PROBE_RTOL = 1e-5
# A measured rate above this share of its published peak means a wrong timer.
CEILING_MAX_SHARE = 1.05
DATAGEN = dict(n_sims=300, n_steps=400, n=200, box=10.0, dt=0.001, seed=42)
LARGE_N, ODD_N = 10_000, 2_085
# Kernel 6 at the edges of its schedule (ops.sym_schedule): tiny systems,
# the dispatch's least N (sim.forces.PALLAS_MIN_N), and one below and one
# above a multiple of each tile it takes on an H100 (32 at N=2,085, 64 at
# 4,097-8,192, 128 at N=10,000).
SYM_EDGE_N = (1, 3, 2_048, 2_079, 2_081, 4_159, 4_161, 9_983, 9_985)
# Large-N /simulate against the CPU service, per particle: at N=10,000 in a
# box of 10 the closest pairs sit ~1e-3 apart, where one ulp of a position
# (5e-7) changes the pair force by ~1e-3, so a max-abs tolerance would
# measure those pairs and nothing else.  The typical particle differs by
# float32 force-sum order only.
SIM_MEDIAN_REL, SIM_FAR_REL, SIM_FAR_SHARE = 1e-5, 1e-3, 0.01
# Evaluation band: the JAX package on the CPU measured 34.5 / 202.2
# (RESULTS.md); a wrong port lands near the reference recipe's 121.9 /
# 23,956.
EVAL_POS_RMSE_MAX, EVAL_VEL_RMSE_MAX = 60.0, 400.0
# The rollout fine-tune (phase 10, --full-finetune): its base is the
# committed one-step checkpoint; the train split is the first 80 % of the
# datagen sims, the selection's validation sims the first 4 of the rest.
BASE_MODEL = "models/best_model.pt"
TRAIN_SIMS, SELECT_SIMS = 240, 4
SELECT_START, SELECT_HORIZON = 5, 395
# The JAX package's full-horizon score of best_model.pt on its validation
# sims (models/checkpoint_selection.json).
JAX_BASE_SCORE = 579.33
CUT_CURRICULUM, CUT_LOG_EVERY = "8:100,16:40", 20
FULL_LAYER_RUNG, FULL_LAYER_LOG_EVERY = "8:20", 10  # through kernel 7
FULL_CURRICULUM = "8:1500,16:900"  # the production recipe (RESULTS.md)
GRAD_HORIZONS = (1, 2, 4, 8)


def _kernel_name(mangled: str) -> str:
    """``name<args>`` of a mangled kernel: the length-prefixed name that
    ends in ``_kernel`` and its integer template arguments."""
    for m in re.finditer(r"\d+", mangled):
        digits = m.group()
        for k in range(len(digits)):  # a hash's digits may run into it
            end = m.end() + int(digits[k:])
            name = mangled[m.end():end]
            if name.endswith("_kernel"):
                args = re.match(r"I((?:Li-?\d+E)+)E", mangled[end:])
                values = re.findall(r"-?\d+", args[1]) if args else []
                return name + (f"<{','.join(values)}>" if values else "")
    return mangled


def ptxas_report(log: str) -> list:
    """(kernel, "N registers, spills") of each entry function in an nvcc
    ``-Xptxas -v`` log."""
    out, entry, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = _kernel_name(line.split("'")[1])
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and entry:
            regs = re.search(r"Used (\d+) registers", line)
            out.append((entry, f"{regs.group(1) if regs else '?'} registers, "
                               f"{spill}"))
            entry = None
    return out


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def eval_states(b: int, n: int = N):
    """Evaluation-protocol states: box 10, seeds 9999+i, shared masses."""
    from nbody_gnn_hpc_torch.sim import random_initial_conditions, shared_masses

    pos, vel = zip(*[random_initial_conditions(n, 10.0, seed=9999 + i)[:2]
                     for i in range(b)])
    return (np.stack(pos).astype(np.float32), np.stack(vel).astype(np.float32),
            shared_masses(n))


def edge_layer_inputs(model, norm_stats, b: int, n: int, k: int, dev,
                      state: str = "protocol"):
    """The operands the serving path hands layer 0's edge kernel.

    ``state``: "protocol" (the evaluation states); "clustered" (half the
    particles moved into a ball of radius 0.3 at the centre of the others,
    density falling as r^-2); "hub" (the protocol states' k-NN edges with
    every second edge sent to target 0, which then holds half of them).
    """
    import torch

    from nbody_gnn_hpc_torch.ops import (edge_features, knn_edge_index,
                                         target_csr)

    pos, vel, masses = eval_states(b, n)
    if state == "clustered":
        rng = np.random.RandomState(0)
        v = rng.randn(b, n // 2, 3)
        v *= 0.3 * rng.rand(b, n // 2, 1) / np.linalg.norm(v, axis=-1,
                                                            keepdims=True)
        pos[:, :n // 2] = pos[:, n // 2:].mean(1, keepdims=True) + v
    mean = torch.as_tensor(norm_stats["state_mean"], device=dev)
    std = torch.as_tensor(norm_stats["state_std"], device=dev)
    p = (torch.as_tensor(pos, device=dev) - mean[:3]) / std[:3]
    v = (torch.as_tensor(vel, device=dev) - mean[3:]) / std[3:]
    m = torch.as_tensor(masses / masses.mean(), device=dev)
    x = torch.cat([p, v, m[None, :, None].expand(b, n, 1)], dim=-1)
    ei = knn_edge_index(p, k)
    if state == "hub":
        ei = ei.clone()
        ei[:, 1, ::2] = 0
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


def edge_bwd_bound_ms(args, dropout: bool = False,
                      d_edge_attr: bool = False) -> tuple:
    """Least H100 time for one edge-stream backward: reads the operands,
    both CSRs and g_out, writes d_t_proj, d_s_proj and the (D+2, H)
    parameter gradients, and d_edge_attr where asked; (30 + 4*D) float32
    operations per edge channel to recompute the stream and form dz and its
    sums (z and statistics 5+2D; x, y 4; sigmoid 3; silu' and dy 5;
    dy*gamma 1; the two means 3; dz 4; d_t_proj, d_s_proj, d_gamma, d_beta
    5; d_w_e 2D), one more with dropout, 2*D more for d_edge_attr (its D
    dot products); Philox not counted."""
    tp, ea, edges = args[0], args[2], args[6]
    b, n, h = tp.shape
    e, d = ea.shape[1], ea.shape[2]
    src = edges.sources
    n_bytes = (_operand_bytes(args) + 4 * (src.perm.numel() + src.dst.numel()
                                           + src.offsets.numel())
               + 4 * b * n * h * 3 + 4 * (d + 2) * h
               + (4 * b * e * d if d_edge_attr else 0))
    flops = 30 + 4 * d + int(dropout) + (2 * d if d_edge_attr else 0)
    return _bound(n_bytes, flops * b * e * h)


def _grad_errors(got, want) -> tuple:
    """(max abs error, max error relative to each gradient's scale) of
    kernel 2's six gradients against the plain backward's."""
    abs_err = rel_err = 0.0
    for g, w in zip(got, want):
        err = (g - w).abs().max().item()
        abs_err = max(abs_err, err)
        rel_err = max(rel_err, err / (w.abs().max().item() + 1e-6))
    return abs_err, rel_err


def _timed_row(rows, kernel, form, b, n, k, fn, plain_fn, bound, reps,
               max_in_degree, passes: bool = False):
    """Time ``fn`` and its plain version; with ``passes`` also each kernel
    that one call launches (torch.profiler)."""
    ms = cuda_time_ms(fn)
    plain_ms = cuda_time_ms(plain_fn, *reps)
    row = {"kernel": kernel, "form": form, "B": b, "N": n, "k": k, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bound[0], "bound_by": bound[1],
           "max_in_degree": max_in_degree}
    if passes:
        row["pass_ms"] = kernel_times_ms(fn)
    rows.append(row)
    each = "".join(f"; {name} {t:.5f} ms" for name, t in
                   row.get("pass_ms", {}).items())
    print(f"  {kernel} {form} B={b} N={n} k={k} (largest in-degree "
          f"{max_in_degree}): kernel {ms:.5f} ms, plain {plain_ms:.5f} ms, "
          f"bound {bound[0]:.6f} ms ({bound[1]}); no single PyTorch call "
          f"computes this function (library_ms null){each}", flush=True)


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

    def forward_held(args, b, n, k, form, sd, p, label=""):
        """Kernel 1 against its plain version in float64, and a rerun bit
        for bit."""
        before = fused_edge_layer.launches
        got = fused_edge_layer(*args, sd, dropout_p=p,
                               deterministic=sd is None)
        torch.cuda.synchronize()
        check(fused_edge_layer.launches == before + 1,
              "fused_edge_layer did not count its launch")
        want = fused_edge_layer_reference(
            *[t.double() for t in args[:6]], args[6], sd, p)
        err = (got.double() - want).abs().max().item()
        ok = torch.allclose(got.double(), want, **KERNEL_TOL)
        same = torch.equal(got, fused_edge_layer(
            *args, sd, dropout_p=p, deterministic=sd is None))
        zeros = bool((got[want == 0] == 0).all())
        errs["fused_edge_fwd"] = max(errs["fused_edge_fwd"], err)
        degree = int(args[6].degree.max().item())
        print(f"  fused_edge_fwd {form} B={b} N={n} k={k}{label} (largest "
              f"in-degree {degree}): max abs err {err:.3e} against the plain "
              f"version in float64 (tolerance atol=rtol=1e-4) -> "
              f"{'ok' if ok else 'MISMATCH'}; rerun bit-identical: {same}; "
              f"zero where the plain version is zero: {zeros}", flush=True)
        check(ok, f"fused_edge_fwd ({form}) disagrees with its plain "
                  f"version at B={b} N={n} k={k}{label}")
        check(same, "fused_edge_fwd reruns are not bit-identical")
        check(zeros, "fused_edge_fwd is not zero where its plain version is")
        return degree

    def backward_held(args, b, n, k, form, d_ea, label=""):
        """Kernel 2 against its plain version in ``form`` ("training":
        dropout; "fine-tune": none), with or without d_edge_attr: within
        GRAD_RTOL of each gradient's scale, a rerun bit for bit, and zero
        rows of d_t_proj and d_s_proj where a node has no edges.  Returns
        the call and its upstream gradient."""
        sd, p = (seed, DROPOUT_P) if form == "training" else (None, 0.0)
        g_out = torch.randn(args[0].shape, device=dev,
                            generator=torch.Generator(dev).manual_seed(b))
        call = lambda: fused_edge_backward(  # noqa: E731
            *args, g_out, sd, p, need_d_edge_attr=d_ea)
        before = fused_edge_backward.launches
        got = call()
        torch.cuda.synchronize()
        check(fused_edge_backward.launches == before + 1,
              "fused_edge_backward did not count its launch")
        want = fused_edge_backward_reference(*args, g_out, sd, p)
        if not d_ea:
            check(got[2] is None, "d_edge_attr returned though not asked")
            got, want = got[:2] + got[3:], want[:2] + want[3:]
        err, rel = _grad_errors(got, want)
        again = call()
        if not d_ea:
            again = again[:2] + again[3:]
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        edges = args[6]
        no_in = edges.offsets[:, 1:] == edges.offsets[:, :-1]
        src = edges.sources.offsets
        no_out = src[:, 1:] == src[:, :-1]
        d_tp, d_sp = (g if g.dim() == 3 else g[None] for g in got[:2])
        zeros = bool((d_tp[no_in] == 0).all()) and bool(
            (d_sp[no_out] == 0).all())
        errs["fused_edge_bwd"] = max(errs["fused_edge_bwd"], err)
        print(f"  fused_edge_bwd {form} B={b} N={n} k={k}{label}, "
              f"d_edge_attr {'on' if d_ea else 'off'} (largest in-degree "
              f"{int(edges.degree.max().item())}): max abs err {err:.3e}, "
              f"max err / gradient scale {rel:.3e} (tolerance "
              f"{GRAD_RTOL:g}, f32 sum order) -> "
              f"{'ok' if rel <= GRAD_RTOL else 'MISMATCH'}; rerun "
              f"bit-identical: {same}; zero rows of nodes without edges "
              f"({int(no_in.sum())} targets, {int(no_out.sum())} sources): "
              f"{zeros}", flush=True)
        check(rel <= GRAD_RTOL, f"fused_edge_bwd disagrees with its plain "
                                f"version at B={b} N={n} k={k}{label}")
        check(same, "fused_edge_bwd reruns are not bit-identical")
        check(zeros, "fused_edge_bwd rows of nodes without edges are not "
                     "zero")
        return call, g_out

    # Hubs: a clustered state, and every second edge sent to one target
    # (its edges cross warps and blocks), in both forms of each kernel.
    for state in ("clustered", "hub"):
        for b, form, sd, p in ((1, "inference", None, 0.0),
                               (1, "training", seed, DROPOUT_P),
                               (24, "training", seed, DROPOUT_P)):
            args = edge_layer_inputs(model, norm_stats, b, N, K, dev, state)
            forward_held(args, b, N, K, form, sd, p, f" {state}")
        for b, form, d_ea in ((1, "training", True), (1, "training", False),
                              (8, "fine-tune", True),
                              (24, "training", False)):
            args = edge_layer_inputs(model, norm_stats, b, N, K, dev, state)
            backward_held(args, b, N, K, form, d_ea, f" {state}")
    timed = {"inference": (1, 8, 10), "training": (1, 24)}
    for b, n, k in ((1, N, K), (8, N, K), (10, N, K), (24, N, K),
                    (1, 13, 4)):
        args = edge_layer_inputs(model, norm_stats, b, n, k, dev)
        full = (n, k) == (N, K)
        forms = [("inference", None, 0.0)]
        if b not in (8, 10):
            forms.append(("training", seed, DROPOUT_P))
        for form, sd, p in forms:
            degree = forward_held(args, b, n, k, form, sd, p)
            if full and b in timed[form]:
                _timed_row(rows, "fused_edge_fwd", form, b, n, k,
                           lambda: fused_edge_layer(
                               *args, sd, dropout_p=p,
                               deterministic=sd is None),
                           lambda: fused_edge_layer_reference(*args, sd, p),
                           edge_bound_ms(args, sd is not None),
                           (5, 10) if b == 24 else (), degree)
        if b == 10:
            continue
        # Kernel 2 as training calls it (dropout, no d_edge_attr) at B=1
        # and 24, and as the rollout fine-tune does (no dropout, with
        # d_edge_attr) at B=8; each also in the other d_edge_attr setting.
        form = "fine-tune" if b == 8 else "training"
        for d_ea in (b == 8, b != 8):
            call, g_out = backward_held(args, b, n, k, form, d_ea)
        if full:
            sd, p = (None, 0.0) if b == 8 else (seed, DROPOUT_P)
            _timed_row(rows, "fused_edge_bwd", form, b, n, k,
                       lambda: fused_edge_backward(
                           *args, g_out, sd, p, need_d_edge_attr=b == 8),
                       lambda: fused_edge_backward_reference(
                           *args, g_out, sd, p),
                       edge_bwd_bound_ms(args, sd is not None, b == 8),
                       (5, 10) if b == 24 else (),
                       int(args[6].degree.max().item()), passes=True)
        if b == 24:
            keep = dropout_keep(seed, DROPOUT_P, b, args[2].shape[1],
                                args[0].shape[2]).float().mean().item()
            print(f"  dropout mask B=24 x E=8000 x H=256: keep fraction "
                  f"{keep:.6f} (expected {1 - DROPOUT_P}; binomial sd "
                  f"{np.sqrt(0.09 / (24 * 8000 * 256)):.1e})", flush=True)
            check(abs(keep - (1 - DROPOUT_P)) < 1e-3, "dropout keep fraction")
    return rows, errs


def full_layer_bound_ms(h, ea, p, edges, node_mask, dropout: bool) -> tuple:
    """Least H100 time for one whole-layer forward on these operands: h,
    edge_attr, the CSR, the parameters (and the node mask) read once, h_new
    and summed written once, over HBM bandwidth; and the six products,
    2*N*H*(5H + Ho) a graph, the stream's count (``edge_bound_ms``) and 11
    operations per node channel for the node side's LayerNorm, SiLU and
    mask, over the non-tensor-core float32 peak."""
    b, n, hdim = h.shape
    e, d = ea.shape[1], ea.shape[2]
    ho = p["w2"].shape[0]
    n_bytes = 4 * (h.numel() + ea.numel() + edges.perm.numel()
                   + edges.src.numel() + edges.offsets.numel()
                   + sum(t.numel() for t in p.values())
                   + (0 if node_mask is None else node_mask.numel())
                   + b * n * ho + b * n * hdim)
    flops = (2 * b * n * hdim * (5 * hdim + ho)
             + (13 + 2 * d + int(dropout)) * b * e * hdim + 11 * b * n * hdim)
    return _bound(n_bytes, flops)


def full_layer_inputs(model, norm_stats, b: int, n: int, k: int, dev):
    """The operands the serving path hands layer 0 as a whole: (h,
    edge_attr, parameters, CSR)."""
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
    with torch.inference_mode():
        h = model.node_encoder(x)
    params = {key: t.detach() for key, t
              in model.layers[0].full_layer_params().items()}
    return (h, edge_features(p, ei), params,
            target_csr(ei, n, sources=True))


def phase_full_layer(model, norm_stats, dev):
    """Kernel 7 against its plain version, its ordinary-launch form, one
    layer's gradients, and its times; returns the timed rows and the
    largest absolute error."""
    import torch

    from nbody_gnn_hpc_torch.ops import (fused_edge_backward,
                                         fused_full_layer,
                                         fused_full_layer_plain,
                                         fused_full_layer_reference)
    from nbody_gnn_hpc_torch.ops import fused_edge_full
    from nbody_gnn_hpc_torch.ops.fused_edge_full import PARAM_KEYS, PHASES

    seed = torch.tensor([DROP_SEED], dtype=torch.int32, device=dev)
    layer = model.layers[0]  # the composed ("fused") form of the same layer
    rows, worst = [], 0.0
    for b, n, k, training in ((1, N, K, False), (8, N, K, False),
                              (24, N, K, True), (1, 13, 4, False),
                              (1, 13, 4, True)):
        h, ea, p, edges = full_layer_inputs(model, norm_stats, b, n, k, dev)
        mask = (torch.rand(h.shape, device=dev,
                           generator=torch.Generator(dev).manual_seed(b))
                >= DROPOUT_P).float() / (1 - DROPOUT_P)
        sd, mk, rate = (seed, mask, DROPOUT_P) if training else (None, None,
                                                                 0.0)
        form = "training" if training else "inference"

        def run():
            return fused_full_layer(h, ea, p, edges, sd, mk, dropout_p=rate,
                                    deterministic=not training)

        with torch.inference_mode():
            before = fused_full_layer.launches
            got = run()
            torch.cuda.synchronize()
            per_layer = fused_full_layer.launches - before
            check(per_layer == 1, f"kernel 7 took {per_layer} launches for "
                                  f"one layer (expected one cooperative "
                                  f"launch)")
            want, _ = fused_full_layer_reference(h, ea, p, edges, sd, mk,
                                                 rate)
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            same = torch.equal(got, run())
            fused_edge_full.COOPERATIVE = False
            before = fused_full_layer.launches
            phased = run()
            phased_launches = fused_full_layer.launches - before
            fused_edge_full.COOPERATIVE = True
        worst = max(worst, err)
        ok = err <= FULL_RTOL_OF_SCALE * scale
        print(f"  fused_full_fwd {form} B={b} N={n} k={k}: max abs err "
              f"{err:.3e} at output scale {scale:.3e} (tolerance "
              f"{FULL_RTOL_OF_SCALE:g} of scale, f32 sum order) -> "
              f"{'ok' if ok else 'MISMATCH'}; one cooperative launch; rerun "
              f"bit-identical: {same}; ordinary-launch form "
              f"({phased_launches} launches) bit-equal: "
              f"{torch.equal(got, phased)}", flush=True)
        check(ok, f"fused_full_fwd ({form}) disagrees with its plain "
                  f"version at B={b} N={n} k={k}")
        check(same, "fused_full_fwd reruns are not bit-identical")
        check(phased_launches == PHASES and torch.equal(got, phased),
              "the ordinary-launch form of kernel 7 differs from the "
              "cooperative one")
        if n != N:
            continue
        deg = edges.degree
        layer.train(training)
        gen = torch.Generator(dev)

        def composed():
            return layer(h, ea, edges, deg, gen)

        def phased_form():
            fused_edge_full.COOPERATIVE = False
            try:
                return run()
            finally:
                fused_edge_full.COOPERATIVE = True

        with torch.inference_mode():
            ms = cuda_time_ms(run)
            phased_ms = cuda_time_ms(phased_form)
            phase_ms = []
            for alone in range(1, PHASES + 1):
                fused_edge_full.PHASE_ALONE = alone
                try:
                    phase_ms.append(cuda_time_ms(run))
                finally:
                    fused_edge_full.PHASE_ALONE = None
            # ~20 and ~60 launches a call: ten calls fit behind the sleep
            # that holds the stream, fifty would time the host.
            composed_ms = cuda_time_ms(composed, inner=10)
            plain_ms = cuda_time_ms(
                lambda: fused_full_layer_reference(h, ea, p, edges, sd, mk,
                                                   rate),
                5 if b == 24 else 20, inner=10)
        layer.eval()
        bound = full_layer_bound_ms(h, ea, p, edges, mk, training)
        rows.append({"kernel": "fused_full_fwd", "form": form, "B": b, "N": n,
                     "k": k, "ms": ms, "phased_ms": phased_ms,
                     "phase_ms": phase_ms,
                     "composed_ms": composed_ms, "plain_ms": plain_ms,
                     "bound_ms": bound[0], "bound_by": bound[1]})
        print(f"    kernel {ms:.5f} ms (ordinary-launch form "
              f"{phased_ms:.5f} ms), composed layer (2 cuBLAS projections, "
              f"kernel 1, node side in PyTorch) {composed_ms:.5f} ms, plain "
              f"{plain_ms:.5f} ms, bound {bound[0]:.6f} ms ({bound[1]}); no "
              f"single PyTorch call computes the layer (library_ms null)",
              flush=True)
        print(f"    each phase alone (projections, stream, edge output, "
              f"first node product, LayerNorm, second node product): "
              f"{', '.join(f'{t:.5f}' for t in phase_ms)} ms", flush=True)
        before_ms = FULL_MS_BEFORE_REDESIGN[(form, b)]
        print(f"    kernel 7 {form} B={b}: {ms:.5f} ms = "
              f"{ms / composed_ms:.3f} x the composed layer "
              f"({'below' if ms < composed_ms else 'NOT below'} it), "
              f"{ms / before_ms:.3f} x the design before ({before_ms} ms)",
              flush=True)

    # One layer's gradients, kernel path against the plain composition.
    h, ea, p, edges = full_layer_inputs(model, norm_stats, 4, N, K, dev)
    gen = torch.Generator(dev).manual_seed(4)
    mask = (torch.rand(h.shape, device=dev, generator=gen)
            >= DROPOUT_P).float() / (1 - DROPOUT_P)
    g_out = torch.randn(h.shape, device=dev, generator=gen)

    def grads(fn):
        leaves = [h.clone().requires_grad_(), ea.clone().requires_grad_()]
        params = {key: t.clone().requires_grad_() for key, t in p.items()}
        out = fn(leaves[0], leaves[1], params, edges, seed, mask,
                 dropout_p=DROPOUT_P, deterministic=False)
        check(out.grad_fn is not None, "the layer's output has no grad_fn")
        out.backward(g_out)
        return [t.grad for t in leaves + [params[key] for key in PARAM_KEYS]]

    before = fused_edge_backward.launches
    got = grads(fused_full_layer)
    check(fused_edge_backward.launches == before + 1,
          "kernel 7's backward did not run kernel 2 once")
    want = grads(fused_full_layer_plain)
    rel = max((g - w).abs().max().item() / (w.abs().max().item() + 1e-12)
              for g, w in zip(got, want))
    print(f"  fused_full layer gradients (h, edge_attr, 14 parameters; B=4, "
          f"dropout and node mask on) vs the plain composition: max error / "
          f"gradient scale {rel:.3e} (tolerance {MODEL_GRAD_RTOL:g})",
          flush=True)
    check(rel <= MODEL_GRAD_RTOL, "kernel 7's layer gradients disagree with "
                                  "the plain composition")
    return rows, worst


def close_to(got, want, rel_scale: float) -> tuple:
    """Max abs difference, checked against rel_scale * max|want|."""
    diff = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    return diff, diff <= rel_scale * float(np.abs(want).max())


def particle_errors(got, want) -> tuple:
    """(median, share beyond SIM_FAR_REL, max abs) of the per-particle
    relative difference |got_i - want_i| / |want_i| over (frames, N, 3)."""
    err = np.linalg.norm(got - want, axis=-1)
    rel = err / (np.linalg.norm(want, axis=-1) + 1e-30)
    return (float(np.median(rel)), float((rel > SIM_FAR_REL).mean()),
            float(np.abs(got - want).max()))


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
    return service, launches, traj20


def profile_window(label: str, fn, steps: int = 0):
    """Run ``fn`` once plain and once under torch.profiler; print the wall
    times, the device-busy share, the launches (per step where ``steps``)
    and the top kernels by device time.  Returns the device rows (name,
    device µs, count), or None where no device time was recorded."""
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
        return None
    busy_us = sum(t for _, t, _ in rows)
    n_launches = sum(c for _, _, c in rows)
    per_step = (f" = {n_launches / steps:.1f} a step, wall "
                f"{plain_wall * 1e3 / steps:.3f} ms a step" if steps else "")
    print(f"  profile {label}: wall {plain_wall * 1e3:.1f} ms unprofiled, "
          f"{wall * 1e3:.1f} ms profiled; device busy {busy_us / 1e3:.1f} ms "
          f"= {100 * busy_us / 1e6 / plain_wall:.1f}% of the unprofiled wall; "
          f"{n_launches} kernels, copies and memsets{per_step}", flush=True)
    for key, t, count in rows[:15]:
        print(f"    {t / 1e3:9.3f} ms  {count:6d}x  {key[:90]}", flush=True)
    return rows


def phase_profile(service, label: str = "fused"):
    """One 394-step final-state rollout under torch.profiler."""
    pos, vel, masses = eval_states(1)
    profile_window(f"394-step rollout, edge_impl {label} (service call, no "
                   f"HTTP)",
                   lambda: service.rollout(pos[0], vel[0], masses,
                                           ROLLOUT_STEPS, trajectory=False),
                   steps=ROLLOUT_STEPS)


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


def model_gradients_agree(train, cfg, dev, edge_impl: str = "fused") -> float:
    """Gradients of every parameter of the production checkpoint on one
    training batch (dropout and noise on), through the kernels of
    ``edge_impl`` and through the plain versions with the same generator
    seed (so the same masks).  Returns the largest error relative to each
    tensor's scale."""
    import torch

    from nbody_gnn_hpc_torch.io import load_checkpoint, load_into
    from nbody_gnn_hpc_torch.models import count_parameters, model_from_config
    from nbody_gnn_hpc_torch.ops import (fused_edge_backward,
                                         fused_edge_layer,
                                         fused_edge_layer_plain,
                                         fused_full_layer,
                                         fused_full_layer_plain)
    from nbody_gnn_hpc_torch.train import make_optimizer, make_train_step

    with open(CONFIG) as f:
        model = model_from_config({**json.load(f)["model_config"],
                                   "edge_impl": edge_impl}).to(dev)
    load_into(model, load_checkpoint(MODEL))
    masses = torch.as_tensor(train.get_masses_tensor(), device=dev)
    step = make_train_step(
        model, make_optimizer(model, cfg.learning_rate, cfg.weight_decay),
        train.edge_index, train.state_mean, train.state_std,
        (masses / masses.mean())[:, None], noise_std=cfg.noise_std,
        masses=masses)
    states = torch.as_tensor(train.last_states[:cfg.batch_size], device=dev)
    targets = torch.as_tensor(train.targets[:cfg.batch_size], device=dev)

    def grads(edge_stream, full_layer):
        for layer in model.layers:
            layer.edge_stream, layer.full_layer = edge_stream, full_layer
        model.zero_grad(set_to_none=True)
        loss, _ = step.compute_loss(
            states, targets, torch.Generator(dev).manual_seed(321))
        loss.backward()
        return loss.item(), [p.grad.clone() for p in model.parameters()]

    counted = fused_full_layer if edge_impl == "fused_full" else \
        fused_edge_layer
    before = counted.launches, fused_edge_backward.launches
    loss_k, g_k = grads(fused_edge_layer, fused_full_layer)
    check((counted.launches - before[0],
           fused_edge_backward.launches - before[1]) == (6, 6),
          f"the {edge_impl} kernel path did not launch its forward and "
          f"kernel 2 six times each")
    loss_p, g_p = grads(fused_edge_layer_plain, fused_full_layer_plain)
    n = sum(g.numel() for g in g_k)
    check(n == count_parameters(model) == 2_550_150, "parameter count")
    rel = max((a - b).abs().max().item() / (b.abs().max().item() + 1e-12)
              for a, b in zip(g_k, g_p))
    zero = sum(int(b.abs().max().item() == 0) for b in g_p)
    print(f"  gradients of all {n:,} parameters, edge_impl {edge_impl}, "
          f"kernels vs plain versions (production checkpoint, B={cfg.batch_size}, dropout + noise on, "
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
    model_gradients_agree(train, cfg, dev, edge_impl="fused_full")

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


def force_bound_ms(n_pairs: int, flops_per_pair: int, n_particles: int) -> tuple:
    """Least H100 time for one direct-force call: ``flops_per_pair``
    float32 operations and one rsqrt per pair, each against its own rate
    (the two pipes overlap, so the larger counts), and 16 bytes in, 12 out
    per particle over HBM bandwidth."""
    t_ops = max(n_pairs * flops_per_pair / PEAK_F32_PER_S,
                n_pairs / PEAK_RSQRT_PER_S) * 1e3
    t_bytes = 28 * n_particles / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "bytes" if t_bytes >= t_ops else "operations"


def protocol_system(n: int, dev):
    """One evaluation-protocol system on the card: box 10, seed 9999,
    masses from seed 42."""
    import torch

    pos, vel, masses = eval_states(1, n)
    return (torch.as_tensor(pos[0], device=dev),
            torch.as_tensor(vel[0], device=dev),
            torch.as_tensor(masses, device=dev))


def direct_f64(pos, m, rows: int = 1000):
    """The direct softened sum in float64 on the card, ``rows`` receivers
    at a time: the yardstick of the float32 forms' rounding."""
    import torch

    from nbody_gnn_hpc_torch.device import G, SOFTENING

    p, gm = pos.double(), G * m.double()
    out = torch.empty_like(p)
    for i0 in range(0, len(p), rows):
        d = p[None] - p[i0:i0 + rows, None]
        d2 = (d * d).sum(-1)
        s = torch.where(d2 > 0, (d2 + SOFTENING ** 2) ** -1.5,
                        torch.zeros_like(d2))
        out[i0:i0 + rows] = ((s * gm)[..., None] * d).sum(1)
    return out


def phase_force_kernels(dev):
    """Kernels 3, 4 and 6 against their plain versions (the ``*_reference``
    functions called on CUDA tensors); returns the timed rows and each
    kernel's largest absolute error."""
    import torch

    from nbody_gnn_hpc_torch import ops
    from nbody_gnn_hpc_torch.parallel import build_ensemble_state
    from nbody_gnn_hpc_torch.sim import shared_masses

    rows, errs = [], {}

    def held(name, kernel, plain, pos, m, label, n_pairs, flops, time_it,
             atol_of_scale=FORCE_ATOL_OF_SCALE):
        before = kernel.launches
        got = kernel(pos, m)
        torch.cuda.synchronize()
        check(kernel.launches == before + 1,
              f"{name} did not count its launch")
        want = plain(pos, m)
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        ok = torch.allclose(got, want, rtol=FORCE_RTOL,
                            atol=atol_of_scale * scale)
        same = torch.equal(got, kernel(pos, m))
        errs[name] = max(errs.get(name, 0.0), err)
        print(f"  {name} {label}: max abs err {err:.3e} at force scale "
              f"{scale:.3e} (tolerance rtol {FORCE_RTOL:g}, atol "
              f"{atol_of_scale:g} of scale: f32 sum order, rsqrt) -> "
              f"{'ok' if ok else 'MISMATCH'}; rerun bit-identical: {same}",
              flush=True)
        check(ok, f"{name} disagrees with its plain version at {label}")
        check(same, f"{name} reruns are not bit-identical")
        if time_it:
            ms = cuda_time_ms(lambda: kernel(pos, m))
            # The plain versions of the tiled forms are loops of small
            # launches (3,160 tile pairs at N=10,000): a few calls do.
            plain_ms = cuda_time_ms(lambda: plain(pos, m), 3, 2, 1)
            bound = force_bound_ms(n_pairs, flops, pos.numel() // 3)
            rows.append({"kernel": name, "shape": label, "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound[0],
                         "bound_by": bound[1], "pairs": n_pairs,
                         "gpairs_per_s": n_pairs / ms / 1e6})
            print(f"    kernel {ms:.5f} ms ({n_pairs / ms / 1e6:.1f} G "
                  f"pairs/s), plain {plain_ms:.4f} ms, bound {bound[0]:.6f} "
                  f"ms ({bound[1]}); no single PyTorch call computes the "
                  f"softened pair sum (library_ms null)", flush=True)
        return got

    for n in (LARGE_N, ODD_N, 700):
        pos, _, m = protocol_system(n, dev)
        tiled = held("pairwise_tiled", ops.accelerations_tiled,
                     ops.accelerations_tiled_reference, pos, m, f"N={n}",
                     n * n, FLOPS_PER_ORDERED_PAIR, n != 700)
        sym = held("pairwise_symmetric", ops.accelerations_symmetric,
                   ops.accelerations_symmetric_reference, pos, m, f"N={n}",
                   n * (n - 1) // 2, FLOPS_PER_UNORDERED_PAIR, n != 700)
        scale = tiled.abs().max().item()
        diff = (sym - tiled).abs().max().item()
        check(torch.allclose(sym, tiled, rtol=FORCE_RTOL,
                             atol=FORCE_ATOL_OF_SCALE * scale),
              f"kernel 6 disagrees with kernel 3 at N={n}")
        net = []
        for acc in (tiled, sym):
            f = m[:, None].double() * acc.double()
            net.append((f.sum(0).abs().max() / f.abs().sum()).item())
        print(f"  N={n}: kernel 6 vs kernel 3 max abs diff {diff:.3e}; "
              f"|sum m a| / sum |m a| = {net[0]:.2e} (kernel 3), "
              f"{net[1]:.2e} (kernel 6) (limit 1e-5)", flush=True)
        check(max(net) < 1e-5, f"net force is not neutral at N={n}")
    # Kernel 6's schedule at its edges: the dispatch's least N, one below and
    # one above a multiple of the tile at each rows-a-lane choice (32, 64
    # and 128 particles), tiny systems.
    sm_count = torch.cuda.get_device_properties(dev).multi_processor_count
    for n in SYM_EDGE_N:
        pos, _, m = protocol_system(n, dev)
        tile = 32 * ops.sym_schedule(n, sm_count)
        held("pairwise_symmetric", ops.accelerations_symmetric,
             ops.accelerations_symmetric_reference, pos, m,
             f"N={n} (tiles of {tile})", n * (n - 1) // 2,
             FLOPS_PER_UNORDERED_PAIR, False)

    # Kernel 5, the moment form, which no entry point dispatches: held
    # against its plain version at the JAX test's tolerance on an offset
    # cloud (tests/test_ops.py:170-178) and at N=2,085.  At N=10,000, the
    # shape it is timed at, it is held against a float64 direct sum at the
    # same tolerance, and its close-pair error, per particle, against its
    # plain version, kernel 6 and the float64 sum is reported.
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is enabled: kernel 5's plain version needs float32 products")
    for n, offset in ((700, 300.0), (ODD_N, 0.0), (LARGE_N, 0.0)):
        pos, _, m = protocol_system(n, dev)
        pos = pos + offset
        label = f"N={n}" + (f", offset by {offset:g}" if offset else "")
        if n != LARGE_N:
            held("pairwise_symmetric_mxu", ops.accelerations_symmetric_mxu,
                 ops.accelerations_symmetric_mxu_reference, pos, m, label,
                 n * (n - 1) // 2, FLOPS_PER_UNORDERED_PAIR, False,
                 MXU_ATOL_OF_SCALE)
            continue
        got = ops.accelerations_symmetric_mxu(pos, m)
        plain = ops.accelerations_symmetric_mxu_reference(pos, m)
        k6 = ops.accelerations_symmetric(pos, m)
        f64 = direct_f64(pos, m)
        for a, b, what in ((got, plain, "kernel 5 vs its plain version"),
                           (got, k6, "kernel 5 vs kernel 6"),
                           (got, f64, "kernel 5 vs the float64 direct sum"),
                           (plain, f64, "kernel 5's plain version vs float64"),
                           (k6, f64, "kernel 6 vs float64")):
            rel = (a.double() - b).norm(dim=1) / b.double().norm(dim=1)
            print(f"  {label}, {what}, per particle: median relative "
                  f"difference {rel.median().item():.3e}, largest "
                  f"{rel.max().item():.3e} (reported)", flush=True)
        check(bool(torch.isfinite(got).all()),
              f"kernel 5 gave non-finite forces at {label}")
        scale = f64.abs().max().item()
        share = ((got.double() - f64).abs() / (
            MXU_ATOL_OF_SCALE * scale + FORCE_RTOL * f64.abs())).max().item()
        print(f"  {label}: kernel 5 vs the float64 direct sum at rtol "
              f"{FORCE_RTOL:g}, atol {MXU_ATOL_OF_SCALE:g} of scale: largest "
              f"difference {share:.3f} of the tolerance -> "
              f"{'ok' if share <= 1 else 'MISMATCH'}", flush=True)
        check(share <= 1, f"kernel 5 disagrees with the float64 direct sum at "
              f"{label}")
        # The time includes the wrapper's centring (a mean and a
        # subtraction), part of the function as a caller runs it.
        ms = cuda_time_ms(lambda: ops.accelerations_symmetric_mxu(pos, m))
        plain_ms = cuda_time_ms(
            lambda: ops.accelerations_symmetric_mxu_reference(pos, m), 3, 2, 1)
        n_pairs = n * (n - 1) // 2
        bound = force_bound_ms(n_pairs, FLOPS_PER_UNORDERED_PAIR, n)
        rows.append({"kernel": "pairwise_symmetric_mxu", "shape": f"N={n}",
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
                     "bound_by": bound[1], "pairs": n_pairs,
                     "gpairs_per_s": n_pairs / ms / 1e6})
        print(f"    kernel with the wrapper's centring {ms:.5f} ms "
              f"({n_pairs / ms / 1e6:.1f} G pairs/s), "
              f"plain {plain_ms:.4f} ms, bound {bound[0]:.6f} ms "
              f"({bound[1]}: kernel 6's work, whatever implements it); no "
              f"single PyTorch call computes the softened pair sum "
              f"(library_ms null)", flush=True)

    def small_plain(pos, m):
        # The plain version 100 systems at a time: its pair planes at
        # B=2,000, N=1,024 would take ~60 GB at once.
        return torch.cat([ops.accelerations_small_reference(
            pos[i:i + 100], m[i:i + 100]) for i in range(0, len(pos), 100)])

    # Kernel 4 at the datagen batch (300), generate_data's default batch
    # (100) and one system, timed; its schedule's edges untimed: a ragged
    # N, the largest N, a large B, and a block of two per SM whose size is
    # not a power-of-two count of warps.
    masses = shared_masses(DATAGEN["n"], seed=DATAGEN["seed"])
    for b, n in ((DATAGEN["n_sims"], DATAGEN["n"]), (100, DATAGEN["n"]),
                 (1, DATAGEN["n"]), (3, 13), (2000, 13),
                 (2000, ops.SMALL_MAX_N), (256, 926)):
        state = build_ensemble_state(
            [DATAGEN["seed"] + i for i in range(b)], n, DATAGEN["box"],
            masses if n == DATAGEN["n"] else None, device=dev,
            accel_fn=lambda p, m: torch.zeros_like(p))
        r, k, threads = ops.small_schedule(b, n, sm_count)
        held("pairwise_small", ops.accelerations_small,
             small_plain if b * n > DATAGEN["n_sims"] * DATAGEN["n"]
             else ops.accelerations_small_reference,
             state.positions, state.masses, f"B={b} N={n}", b * n * n,
             FLOPS_PER_ORDERED_PAIR, n == DATAGEN["n"])
        print(f"    schedule: {r} receivers a lane group, {k} lanes a "
              f"receiver, {threads} threads a block", flush=True)

    # A coincident heavy pair (G*m/eps^3 overflows float32) stays finite,
    # and zero-mass particles are force-neutral, in all three kernels.
    heavy_pos = torch.tensor([[0.0, 0, 0], [0.0, 0, 0], [1.0, 0, 0]],
                             device=dev)
    heavy_m = torch.tensor([2e30, 2e30, 1.0], device=dev)
    pos, _, m = protocol_system(300, dev)
    extra = torch.cat([pos, pos.new_full((45, 3), 2.5)])
    extra_m = torch.cat([m, m.new_zeros(45)])
    for name, kernel in (("pairwise_tiled", ops.accelerations_tiled),
                         ("pairwise_small", ops.accelerations_small),
                         ("pairwise_symmetric", ops.accelerations_symmetric)):
        acc = kernel(heavy_pos, heavy_m)
        check(bool(torch.isfinite(acc).all()) and acc[0, 0].item() > 0
              and acc[2, 0].item() < 0,
              f"{name}: a coincident heavy pair gives {acc.tolist()}")
        base = kernel(pos, m)
        diff = (kernel(extra, extra_m)[:300] - base).abs().max().item()
        check(diff <= 2e-5 * base.abs().max().item(),
              f"{name}: zero-mass particles moved the forces by {diff:.3e}")
    print("  coincident heavy pair finite and zero-mass rows force-neutral "
          "(2e-5 of scale) in kernels 3, 4, 6", flush=True)
    return rows, errs


def datagen_cli(host, d: dict, device: str, out_dir: Path) -> None:
    """``python -m nbody_gnn_hpc_torch.generate_data`` at the shape ``d``
    with HDF5 files (needs h5py): its trajectory files must hold what
    ``simulate_ensemble`` gave for the same seeds (``host``), a rerun must
    resume every file, and the manifest must load as datasets."""
    from nbody_gnn_hpc_torch import generate_data, ops
    from nbody_gnn_hpc_torch.io import CheckpointManager
    from nbody_gnn_hpc_torch.train import datasets_from_manifest
    from nbody_gnn_hpc_torch.train.dataset import MANIFEST_NAME

    shutil.rmtree(out_dir, ignore_errors=True)
    argv = ["--particles", str(d["n"]), "--simulations", str(d["n_sims"]),
            "--steps", str(d["n_steps"]), "--box-size", str(d["box"]),
            "--seed", str(d["seed"]), "--batch-size", "100",
            "--compression", "lzf", "--no-windows", "--device", device,
            "--output-dir", str(out_dir)]
    before = ops.accelerations_small.launches
    t0 = time.perf_counter()
    check(generate_data.main(argv) == 0, "generate_data failed")
    wall = time.perf_counter() - t0
    ran = ops.accelerations_small.launches - before
    n_batches = -(-d["n_sims"] // 100)
    check(device == "cpu" or ran == n_batches * (d["n_steps"] + 1),
          f"generate_data launched kernel 4 {ran} times")
    manager = CheckpointManager(str(out_dir / "checkpoints"))
    for i in (0, d["n_sims"] - 1):
        back = manager.load_trajectory(f"sim_{i:04d}")
        check(np.array_equal(back["positions"], host.positions[i])
              and np.array_equal(back["velocities"], host.velocities[i]),
              f"trajectory file sim_{i:04d} differs from simulate_ensemble")
    before = ops.accelerations_small.launches
    check(generate_data.main(argv) == 0, "generate_data failed on a rerun")
    check(ops.accelerations_small.launches == before,
          "a rerun of generate_data simulated again instead of resuming")
    train, val = datasets_from_manifest(out_dir / MANIFEST_NAME,
                                        k_neighbors=K, cache=False)
    n_train = int(0.8 * d["n_sims"])
    per_sim = d["n_steps"] + 1 - 5
    check(train.n_samples == n_train * per_sim
          and val.n_samples == (d["n_sims"] - n_train) * per_sim
          and np.isfinite(train.targets).all(),
          "the manifest's datasets have the wrong size")
    print(f"  generate_data --no-windows --compression lzf on {device}: "
          f"{d['n_sims']} sims x {d['n_steps']} steps in {wall:.2f} s "
          f"(simulate, read back, write HDF5) = "
          f"{d['n_sims'] * d['n_steps'] / wall:,.0f} sim-steps/s; kernel 4 "
          f"launches {ran}; files equal simulate_ensemble's arrays; a rerun "
          f"resumed all files; datasets_from_manifest {train.n_samples} + "
          f"{val.n_samples} samples", flush=True)


def phase_simulator(service, dev):
    """The simulator side: datagen, large-N /simulate, evaluation.  Returns
    the launch counts of the five kernels on this path."""
    import torch

    from nbody_gnn_hpc_torch import evaluate, ops
    from nbody_gnn_hpc_torch.client import RolloutClient
    from nbody_gnn_hpc_torch.parallel import (build_ensemble_state,
                                              fetch_host_trajectory,
                                              simulate_ensemble)
    from nbody_gnn_hpc_torch.serve import build_service, serve
    from nbody_gnn_hpc_torch.sim import (accelerations, make_state,
                                         rollout_steps, run_trajectory_batch,
                                         shared_masses, total_energy,
                                         total_momentum)
    from nbody_gnn_hpc_torch.train import GNNDataset

    d = DATAGEN
    seeds = [d["seed"] + i for i in range(d["n_sims"])]
    masses = shared_masses(d["n"], seed=d["seed"])
    sim_steps = d["n_sims"] * d["n_steps"]

    def datagen(accel_fn=None, n_sims=d["n_sims"], device=dev):
        return simulate_ensemble(seeds[:n_sims], d["n"], d["n_steps"],
                                 box_size=d["box"], dt=d["dt"],
                                 shared_masses=masses, device=device,
                                 accel_fn=accel_fn)

    # The ensemble force both ways, in turns on this one card.  Wall time of
    # the whole call (host-built initial conditions, 400 steps, the saved
    # stacks on the device), synchronised.
    walls = {"plain": [], "kernel 4": []}
    datagen(n_sims=8)  # first-use costs
    for label, fn in (("plain", accelerations),
                      ("kernel 4", ops.accelerations_small),
                      ("kernel 4", ops.accelerations_small),
                      ("plain", accelerations)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        traj = datagen(fn)
        torch.cuda.synchronize()
        walls[label].append(time.perf_counter() - t0)
        del traj
    for label, secs in walls.items():
        print(f"  datagen {d['n_sims']} x {d['n_steps']} x N={d['n']} with "
              f"the {label} force: "
              + ", ".join(f"{w:.3f} s = {sim_steps / w:,.0f} sim-steps/s"
                          for w in secs), flush=True)
    state = build_ensemble_state(seeds, d["n"], d["box"], masses, device=dev)
    profile_window(
        "50 datagen steps, kernel 4 force (300 x N=200)",
        lambda: run_trajectory_batch(state, d["dt"], 50,
                                     accel_fn=ops.accelerations_small))
    profile_window(
        "50 datagen steps, plain force (300 x N=200)",
        lambda: run_trajectory_batch(state, d["dt"], 50,
                                     accel_fn=accelerations))
    del state

    (pos_l,), (vel_l,), m_l = eval_states(1, LARGE_N)
    (pos_o,), (vel_o,), m_o = eval_states(1, ODD_N)
    httpd = serve(service, host="127.0.0.1", port=0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    client = RolloutClient(f"http://127.0.0.1:{httpd.server_address[1]}")
    counted = [ops.fused_edge_layer, ops.fused_edge_backward,
               ops.accelerations_tiled, ops.accelerations_small,
               ops.accelerations_symmetric]
    lat = {}
    try:
        # main-path run starts here
        for fn in counted:
            fn.launches = 0
        # (a) datagen
        t0 = time.perf_counter()
        traj = datagen()
        torch.cuda.synchronize()
        t_sim = time.perf_counter() - t0
        host = fetch_host_trajectory(traj)
        t_all = time.perf_counter() - t0
        # (b) large-N /simulate over HTTP
        t0 = time.perf_counter()
        sim_l = client.simulate(pos_l, vel_l, m_l, 20, trajectory=True)
        lat[f"simulate N={LARGE_N} x 20 (trajectory, npz)"] = \
            time.perf_counter() - t0
        t0 = time.perf_counter()
        sim_o = client.simulate(pos_o, vel_o, m_o, 50, trajectory=True)
        lat[f"simulate N={ODD_N} x 50 (trajectory, npz)"] = \
            time.perf_counter() - t0
        # (c) evaluation against the float64 oracle
        t0 = time.perf_counter()
        rc = evaluate.main(["-m", MODEL, "-c", CONFIG, "-o",
                            str(SIM_DIR / "eval"), "--f64-ground-truth"])
        t_eval = time.perf_counter() - t0
        launches = [fn.launches for fn in counted]
        # main-path run ends here
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    # Kernel 3 as the oracle of the large-N dispatch on the N=10,000 state.
    # No entry point dispatches kernel 3 (nor does the JAX package dispatch
    # its counterpart): these two calls are this script's own and are
    # counted apart from the path's.
    state_l = make_state(pos_l, vel_l, m_l, device=dev)
    acc6 = accelerations(state_l.positions, state_l.masses)
    acc3 = ops.accelerations_tiled(state_l.positions, state_l.masses)
    oracle = [fn.launches - n for fn, n in zip(counted, launches)]
    fwd, bwd, tiled, small, sym = launches
    print(f"  launches on the simulator path: pairwise_small {small} "
          f"(expected {d['n_steps']} steps + 1), pairwise_symmetric {sym} "
          f"(expected (20 + 1) + (50 + 1)), pairwise_tiled {tiled} (no entry "
          f"point dispatches it), fused_edge_fwd {fwd} (expected 6 x 394 "
          f"evaluation rollout steps), fused_edge_bwd {bwd}; the oracle "
          f"comparison after it: pairwise_tiled {oracle[2]}, "
          f"pairwise_symmetric {oracle[4]}", flush=True)
    check(small == d["n_steps"] + 1, "datagen launch count")
    check(sym == 21 + 51, f"/simulate ran kernel 6 {sym} times, expected 72")
    check(tiled == 0 and fwd == 6 * 394 and bwd == 0,
          "simulator-path launch counts")
    check(oracle == [0, 0, 1, 0, 1], "oracle comparison launch counts")

    # (a) checked
    n_saves = d["n_steps"] + 1
    check(host.positions.shape == (d["n_sims"], n_saves, d["n"], 3)
          and host.masses.shape == (d["n_sims"], d["n"])
          and host.steps[0, -1] == d["n_steps"], "datagen shapes")
    check(all(np.isfinite(getattr(host, f)).all() for f in
              ("positions", "velocities", "accelerations", "times")),
          "datagen produced non-finite values")
    mib = sum(getattr(host, f).nbytes for f in
              ("positions", "velocities", "accelerations")) / 2 ** 20
    print(f"  datagen main run: {t_sim:.3f} s on the card = "
          f"{sim_steps / t_sim:,.0f} sim-steps/s; {t_all:.3f} s with the "
          f"readback of {mib:.0f} MiB = {sim_steps / t_all:,.0f} "
          f"sim-steps/s", flush=True)
    ref = fetch_host_trajectory(simulate_ensemble(
        seeds[:3], d["n"], 20, box_size=d["box"], dt=d["dt"],
        shared_masses=masses, device="cpu"))
    for key in ("positions", "velocities"):
        diff, ok = close_to(getattr(host, key)[:3, :21], getattr(ref, key),
                            1e-3)
        print(f"  datagen sims 0-2, frames 0-20 {key} vs device='cpu': max "
              f"abs diff {diff:.3e} (tolerance 1e-3 of scale: f32 force-sum "
              f"order amplified by close encounters)", flush=True)
        check(ok, f"datagen {key} disagree with the CPU run")
    final = traj.final
    ke, pe, te = total_energy(final.positions, final.velocities, final.masses)
    ke0, pe0, te0 = total_energy(traj.positions[:, 0], traj.velocities[:, 0],
                                 traj.masses)
    mom = total_momentum(final.velocities, final.masses)
    mom0 = total_momentum(traj.velocities[:, 0], traj.masses)
    check(all(bool(torch.isfinite(t).all()) for t in (ke, pe, te, mom)),
          "energy or momentum diagnostics are not finite")
    drift = ((mom - mom0).norm(dim=-1)
             / (final.masses[..., None] * final.velocities).norm(dim=-1).sum(-1))
    print(f"  diagnostics over {d['n_sims']} sims: total energy at step 0 "
          f"{te0.min().item():.3e}..{te0.max().item():.3e}, at step "
          f"{d['n_steps']} {te.min().item():.3e}..{te.max().item():.3e} "
          f"(unresolved close encounters at softening 1e-9 are the "
          f"reference's behaviour too); momentum drift / sum |m v| max "
          f"{drift.max().item():.2e}", flush=True)
    del traj
    trajs = [dict(positions=host.positions[i], velocities=host.velocities[i],
                  masses=host.masses[i]) for i in range(10)]
    train = GNNDataset.from_trajectories(trajs[:8], sequence_length=5,
                                         k_neighbors=K)
    val = GNNDataset.from_trajectories(
        trajs[8:], sequence_length=5, k_neighbors=K,
        external_norm_stats=train.get_normalization_stats())
    check(train.n_samples == 8 * (n_saves - 5)
          and val.n_samples == 2 * (n_saves - 5)
          and train.edge_index.shape == (2, d["n"] * K),
          "datagen -> dataset gave wrong sizes")
    try:
        import h5py  # noqa: F401
    except ImportError:
        print(f"  datagen -> GNNDataset.from_trajectories in memory "
              f"({train.n_samples} + {val.n_samples} samples); h5py is not "
              f"importable here, so no trajectory or dataset file was "
              f"written", flush=True)
    else:
        print(f"  datagen -> GNNDataset.from_trajectories in memory "
              f"({train.n_samples} + {val.n_samples} samples); h5py is "
              f"importable, so the generate_data command runs too",
              flush=True)
        datagen_cli(host, d, str(dev), SIM_DIR / "data")

    # (b) checked
    cpu = build_service(MODEL, CONFIG, device="cpu")
    for label, out, (p, v, m), steps, frames in (
            (f"N={LARGE_N}", sim_l, (pos_l, vel_l, m_l), 20, 2),
            (f"N={ODD_N}", sim_o, (pos_o, vel_o, m_o), 50, 5)):
        n = len(m)
        check(out["positions"].shape == (steps + 1, n, 3)
              and out["velocities"].shape == (steps + 1, n, 3)
              and out["times"].shape == (steps + 1,)
              and np.isfinite(out["positions"]).all()
              and np.isfinite(out["velocities"]).all(),
              f"/simulate at {label} has a bad shape or non-finite values")
        ref = cpu.simulate(p, v, m, frames, trajectory=True)
        for key in ("positions", "velocities"):
            med, far, diff = particle_errors(out[key][1:frames + 1],
                                             ref[key][1:])
            print(f"  /simulate {label} frames 1-{frames} {key} vs "
                  f"device='cpu': per-particle relative difference median "
                  f"{med:.2e} (limit {SIM_MEDIAN_REL:g}), share beyond "
                  f"{SIM_FAR_REL:g}: {far:.2%} (limit {SIM_FAR_SHARE:.0%}); "
                  f"max abs diff {diff:.3e} at scale "
                  f"{np.abs(ref[key]).max():.3e}", flush=True)
            check(np.array_equal(out[key][0], ref[key][0])
                  and med <= SIM_MEDIAN_REL and far <= SIM_FAR_SHARE,
                  f"/simulate {label} {key} disagree with the CPU run")
    scale = acc3.abs().max().item()
    diff = (acc6 - acc3).abs().max().item()
    print(f"  N={LARGE_N} state: the dispatch (kernel 6) vs kernel 3 as the "
          f"oracle, max abs diff {diff:.3e} at force scale {scale:.3e}",
          flush=True)
    check(torch.allclose(acc6, acc3, rtol=FORCE_RTOL,
                         atol=FORCE_ATOL_OF_SCALE * scale),
          "the large-N dispatch disagrees with kernel 3")
    for name, secs in lat.items():
        print(f"  latency {name}: {secs * 1e3:.1f} ms", flush=True)
    state_l = state_l._replace(accelerations=acc6)
    profile_window(f"20 leapfrog steps at N={LARGE_N} (kernel 6)",
                   lambda: rollout_steps(state_l, 0.001, 20))

    # (c) checked
    check(rc == 0, f"evaluate exited {rc}")
    with open(SIM_DIR / "eval" / "evaluation_results.json") as f:
        results = json.load(f)
    avg = results["average_metrics"]
    print(f"  evaluate {MODEL}, f64 oracle, {results['n_test_simulations']} "
          f"sims x {results['n_steps']} steps at N={results['n_particles']} "
          f"in {t_eval:.1f} s: position RMSE {avg['position_rmse']:.4f} ± "
          f"{avg['position_rmse_std']:.4f}, velocity RMSE "
          f"{avg['velocity_rmse']:.4f} ± {avg['velocity_rmse_std']:.4f} "
          f"(the JAX package on the CPU: 34.5 ± 41.0 / 202.2; band < "
          f"{EVAL_POS_RMSE_MAX:g} / < {EVAL_VEL_RMSE_MAX:g})", flush=True)
    check(results["ground_truth"] == "float64_host"
          and len(results["per_simulation_metrics"]) == 10,
          "evaluation_results.json is not the f64 protocol's")
    check(avg["position_rmse"] < EVAL_POS_RMSE_MAX
          and avg["velocity_rmse"] < EVAL_VEL_RMSE_MAX,
          "the evaluation RMSE is outside the band")
    names = ("fused_edge_fwd", "fused_edge_bwd", "pairwise_tiled",
             "pairwise_small", "pairwise_symmetric")
    # The datagen run's (sims, saves, N, 6) states: phase 10's data.
    states = np.concatenate([host.positions, host.velocities], -1)
    return (dict(zip(names, launches)), dict(zip(names, oracle)), states,
            host.masses[0])


class _Served:
    """A service behind its HTTP server for the length of a ``with``."""

    def __init__(self, service, **kw):
        from nbody_gnn_hpc_torch.serve import serve

        self.httpd = serve(service, host="127.0.0.1", port=0, **kw)
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=30)


def _concurrently(fns):
    """Run the calls at once, one thread each; returns their results."""
    results, errors = [None] * len(fns), [None] * len(fns)
    barrier = threading.Barrier(len(fns))

    def work(i):
        barrier.wait()
        try:
            results[i] = fns[i]()
        except Exception as e:  # noqa: BLE001 - reported below
            errors[i] = e

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    for e in errors:
        check(e is None, f"a concurrent request failed: {e!r}")
    return results


def phase_deployed(dev_name, fused_service, fused_traj20):
    """Serving as it is deployed: the whole-layer kernel behind the replica
    pool, the micro-batcher and the in-flight gate, with quantization.
    Returns the launch counts of kernels 7, 1 and 2 on this path."""
    import urllib.error
    import urllib.request

    from nbody_gnn_hpc_torch import evaluate
    from nbody_gnn_hpc_torch.client import RolloutClient
    from nbody_gnn_hpc_torch.ops import (fused_edge_backward,
                                         fused_edge_layer, fused_full_layer)
    from nbody_gnn_hpc_torch.predict import quantize_checkpoint
    from nbody_gnn_hpc_torch.serve import (MicroBatcher, build_replica_pool,
                                           build_service)

    shutil.rmtree(SERVE_DIR, ignore_errors=True)
    SERVE_DIR.mkdir(parents=True)
    with open(CONFIG) as f:
        cfg = json.load(f)
    cfg["model_config"]["edge_impl"] = "fused_full"
    config_full = str(SERVE_DIR / "config.json")
    with open(config_full, "w") as f:
        json.dump(cfg, f, indent=2)

    n_req = 8
    pool = build_replica_pool(MODEL, config_full, n_replicas=1)
    check(pool.services[0].predictor.device.type == "cuda",
          "the pool's replica is not on cuda")
    batcher = MicroBatcher(pool, max_batch=n_req, max_wait_s=0.25)
    batcher.warmup(N, 2)  # every bucket once: first-use costs
    pos, vel, masses = eval_states(n_req)
    counted = (fused_full_layer, fused_edge_layer, fused_edge_backward)
    with _Served(pool, batcher=batcher, max_inflight=2 * n_req) as srv:
        client = RolloutClient(srv.url)
        # main-path run starts here
        for fn in counted:
            fn.launches = 0
        dispatched = batcher.dispatches
        health = client.healthz()
        t0 = time.perf_counter()
        finals = _concurrently([
            (lambda i=i: client.rollout(pos[i], vel[i], masses,
                                        ROLLOUT_STEPS, trajectory=False))
            for i in range(n_req)])
        wall = time.perf_counter() - t0
        dispatches = batcher.dispatches - dispatched
        served = [fn.launches for fn in counted]
        t0 = time.perf_counter()
        rc = evaluate.main(["-m", MODEL, "-c", config_full, "-o",
                            str(SERVE_DIR / "eval"), "--f64-ground-truth"])
        t_eval = time.perf_counter() - t0
        launches = [fn.launches for fn in counted]
        # main-path run ends here
        short = _concurrently([
            (lambda i=i: client.rollout(pos[i], vel[i], masses, 5))
            for i in range(n_req)])
    print(f"  {n_req} concurrent {ROLLOUT_STEPS}-step final-state /rollout "
          f"requests through the pool (1 replica) and the micro-batcher "
          f"(max_batch {n_req}): {dispatches} rollout_batch dispatch(es), "
          f"{wall * 1e3:.1f} ms for all; kernel 7 launches {served[0]} "
          f"(expected 6 x {ROLLOUT_STEPS} x {dispatches} = "
          f"{6 * ROLLOUT_STEPS * dispatches}), kernel 1 {served[1]}, "
          f"kernel 2 {served[2]}", flush=True)
    check(1 <= dispatches < n_req, f"{n_req} concurrent requests took "
                                   f"{dispatches} dispatches")
    check(served == [6 * ROLLOUT_STEPS * dispatches, 0, 0],
          "deployed-serving launch counts")
    check(health["status"] == "ok" and health["model"]["replicas"] == 1
          and health["model"]["edge_impl"] == "fused_full"
          and health["model"]["quantization"] is None
          and dev_name in health["device"],
          f"/healthz of the pool answered {health}")

    # Each answer against the direct single service.
    direct = build_service(MODEL, config_full)
    worst_final = worst_short = 0.0
    for i in range(n_req):
        check(finals[i]["positions"].shape == (N, 3)
              and np.isfinite(finals[i]["positions"]).all()
              and np.isfinite(finals[i]["velocities"]).all(),
              "a micro-batched final state is wrong")
        want = direct.rollout(pos[i], vel[i], masses, ROLLOUT_STEPS,
                              trajectory=False)
        diff, ok = close_to(finals[i]["positions"], want["positions"], 1e-3)
        worst_final = max(worst_final, diff)
        check(ok, f"micro-batched request {i} disagrees with the direct "
                  f"service after {ROLLOUT_STEPS} steps ({diff:.3e})")
        want = direct.rollout(pos[i], vel[i], masses, 5)
        diff, ok = close_to(short[i]["positions"], want["positions"], 1e-5)
        worst_short = max(worst_short, diff)
        check(short[i]["positions"].shape == (6, N, 3) and ok,
              f"micro-batched request {i} disagrees with the direct service "
              f"over 5 steps ({diff:.3e})")
    print(f"  each of the {n_req} answers vs the direct single service: "
          f"{ROLLOUT_STEPS}-step finals max abs diff {worst_final:.3e} "
          f"(tolerance 1e-3 of scale: f32 sum order of the batched "
          f"products, amplified over the rollout); 5-step trajectories "
          f"{worst_short:.3e} (1e-5 of scale)", flush=True)

    # fused_full against the "fused" service and the CPU port.
    full5 = direct.rollout(pos[0], vel[0], masses, 5)
    cpu5 = build_service(MODEL, config_full, device="cpu").rollout(
        pos[0], vel[0], masses, 5)
    for key in ("positions", "velocities"):
        for label, ref in (("the 'fused' service", fused_traj20[key][:6]),
                           ("device='cpu'", cpu5[key])):
            diff, ok = close_to(full5[key], ref, 1e-4)
            print(f"  fused_full frames 0-5 {key} vs {label}: max abs diff "
                  f"{diff:.3e} (tolerance 1e-4 of scale)", flush=True)
            check(ok, f"fused_full {key} disagree with {label}")

    # A saturated gate sheds with 503 + Retry-After; probes still answer.
    body = json.dumps({"positions": pos[0].tolist(),
                       "velocities": vel[0].tolist(),
                       "masses": masses.tolist(), "n_steps": ROLLOUT_STEPS,
                       "trajectory": False}).encode()

    def post():
        req = urllib.request.Request(
            f"{srv.url}/rollout", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            return resp.status

    with _Served(pool, max_inflight=1) as srv:
        first = {}
        holder = threading.Thread(
            target=lambda: first.setdefault("status", post()))
        holder.start()
        deadline = time.monotonic() + 30
        while srv.httpd.inflight.count() < 1 and time.monotonic() < deadline:
            time.sleep(0.001)
        time.sleep(0.05)  # the holder is past the gate and on the device
        shed = None
        try:
            post()
        except urllib.error.HTTPError as e:
            shed = (e.code, e.headers.get("Retry-After"), e.read().decode())
        with urllib.request.urlopen(f"{srv.url}/healthz", timeout=30) as r:
            probe = r.status
        holder.join(timeout=300)
        with urllib.request.urlopen(f"{srv.url}/metrics", timeout=30) as r:
            metrics = r.read().decode()
    print(f"  max_inflight=1 with one {ROLLOUT_STEPS}-step request on the "
          f"device: the next answered {shed and shed[:2]}, /healthz "
          f"{probe}, the holder {first.get('status')}", flush=True)
    check(shed is not None and shed[0] == 503 and shed[1] == "1"
          and "max_inflight" in shed[2], f"the saturated gate gave {shed}")
    check(probe == 200 and first.get("status") == 200
          and 'endpoint="/rollout",status="503"' in metrics,
          "probes or the holder failed under saturation")

    # Weight-only quantization against float32 (in memory), and an int8
    # checkpoint written, reloaded and served.
    base = full5["positions"]
    scale = float(np.abs(base).max())
    quant5 = {}
    for mode in ("int8", "bf16"):
        svc = build_service(MODEL, config_full, quantize=mode)
        check(svc.model_info["quantization"] == mode,
              f"the {mode} service reports {svc.model_info}")
        kept = sum(p.numel() for p in svc.predictor.model.parameters())
        quant5[mode] = svc.rollout(pos[0], vel[0], masses, 5)["positions"]
        diff = float(np.abs(quant5[mode] - base).max())
        print(f"  {mode} service, 5 steps vs float32: max abs diff "
              f"{diff:.3e} = {diff / scale:.2e} of scale (tolerance "
              f"{QUANT_RTOL[mode]:g}); float32 parameters left in the "
              f"model: {kept:,} of 2,550,150", flush=True)
        check(0 < diff <= QUANT_RTOL[mode] * scale
              and np.isfinite(quant5[mode]).all(),
              f"the {mode} service is not close to float32")
        check(kept < 20_000, "the float32 kernels are still resident")
    info = quantize_checkpoint(MODEL, str(SERVE_DIR / "model.int8.pt"), "int8")
    from_file = build_service(str(SERVE_DIR / "model.int8.pt"), config_full)
    with _Served(from_file) as srv:
        client = RolloutClient(srv.url)
        health = client.healthz()
        out = client.rollout(pos[0], vel[0], masses, 5)
    print(f"  int8 checkpoint: {info['src_bytes']:,} -> "
          f"{info['dst_bytes']:,} bytes ({info['ratio']}x); reloaded and "
          f"served over HTTP, /healthz quantization "
          f"{health['model']['quantization']}; equal to the in-memory int8 "
          f"service: {np.array_equal(out['positions'], quant5['int8'])}",
          flush=True)
    check(health["model"]["quantization"] == "int8"
          and np.array_equal(out["positions"], quant5["int8"]),
          "the reloaded int8 checkpoint serves something else")

    # evaluate through fused_full, checked.
    check(rc == 0, f"evaluate (fused_full) exited {rc}")
    with open(SERVE_DIR / "eval" / "evaluation_results.json") as f:
        avg = json.load(f)["average_metrics"]
    print(f"  evaluate through edge_impl fused_full, f64 oracle, in "
          f"{t_eval:.1f} s: position RMSE {avg['position_rmse']:.4f}, "
          f"velocity RMSE {avg['velocity_rmse']:.4f} (band < "
          f"{EVAL_POS_RMSE_MAX:g} / < {EVAL_VEL_RMSE_MAX:g}); kernel 7 "
          f"launches {launches[0] - served[0]} (expected 6 x "
          f"{ROLLOUT_STEPS}), kernel 1 {launches[1]}", flush=True)
    check(avg["position_rmse"] < EVAL_POS_RMSE_MAX
          and avg["velocity_rmse"] < EVAL_VEL_RMSE_MAX,
          "the fused_full evaluation RMSE is outside the band")
    check(launches[0] - served[0] == 6 * ROLLOUT_STEPS
          and launches[1:] == [0, 0], "fused_full evaluation launch counts")

    phase_profile(fused_service, "fused")
    phase_profile(direct, "fused_full")
    return dict(zip(("fused_full_fwd", "fused_edge_fwd", "fused_edge_bwd"),
                    launches))


def probe_bound_ms(x, steps: int, rsqrt: bool) -> tuple:
    """Least H100 time for one probe call at four accumulators: x read and
    the result written once over HBM bandwidth, against 2 operations per
    FMA over the float32 peak (kernel 10), or one rsqrt per step over the
    special-function rate against the adds over the float32 peak (kernel
    11)."""
    n_steps = x.numel() * steps * 4
    t_bytes = 8 * x.numel() / PEAK_BYTES_PER_S * 1e3
    t_ops = (max(n_steps / PEAK_RSQRT_PER_S, n_steps / PEAK_F32_PER_S)
             if rsqrt else 2 * n_steps / PEAK_F32_PER_S) * 1e3
    return max(t_ops, t_bytes), "bytes" if t_bytes >= t_ops else "operations"


def phase_ceilings(dev):
    """Kernels 10 and 11 against their plain versions in every form the
    ceilings measurement launches, each at its own shape, and timed in the
    Pallas kernels' form; then that measurement in process, the main path
    of this phase.  Returns the timed rows, each probe's largest absolute
    error and the launches of that run."""
    import torch

    from nbody_gnn_hpc_torch import ops, roofline

    rows, errs = [], {}
    names = {ops.fma_probe: "probe_fma", ops.rsqrt_probe: "probe_rsqrt"}
    plains = {ops.fma_probe: ops.fma_probe_reference,
              ops.rsqrt_probe: ops.rsqrt_probe_reference}
    for form, kernel, shape, seed, steps, kw in roofline.probe_forms(
            **roofline.SHAPES):
        name, plain = names[kernel], plains[kernel]
        x = roofline.probe_input(shape, seed, dev)
        before = kernel.launches
        got = kernel(x, steps, **kw)
        torch.cuda.synchronize()
        check(kernel.launches == before + 1, f"{name} did not count its launch")
        want = plain(x, steps, **kw)
        rel = ((got - want).abs() / want.abs()).max().item()
        same = torch.equal(got, kernel(x, steps, **kw))
        errs[name] = max(errs.get(name, 0.0), (got - want).abs().max().item())
        label = f"{tuple(x.shape)} k={steps}"
        print(f"  {name} as {form} {label}: max relative err {rel:.3e} "
              f"(tolerance {PROBE_RTOL:g}: rsqrtf is approximate; the plain "
              f"FMA rounds once, as __fmaf_rn does) -> "
              f"{'ok' if rel <= PROBE_RTOL else 'MISMATCH'}; rerun "
              f"bit-identical: {same}", flush=True)
        check(rel <= PROBE_RTOL, f"{name} as {form} disagrees with its plain "
              f"version")
        check(same, f"{name} reruns are not bit-identical")
        if not form.startswith("kernel_"):
            continue
        ms = cuda_time_ms(lambda: kernel(x, steps))
        # 16,384 (FMA) or 8,192 (rsqrt) small launches a call: a few do.
        plain_ms = cuda_time_ms(lambda: plain(x, steps), 3, 1, 1)
        bound = probe_bound_ms(x, steps, kernel is ops.rsqrt_probe)
        rows.append({"kernel": name, "shape": label, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound[0],
                     "bound_by": bound[1]})
        print(f"    kernel {ms:.5f} ms, plain {plain_ms:.4f} ms (launch-bound "
              f"loops), bound {bound[0]:.6f} ms ({bound[1]}); no single "
              f"PyTorch call computes this loop (library_ms null)",
              flush=True)

    # main-path run starts here
    ops.fma_probe.launches = ops.rsqrt_probe.launches = 0
    result = roofline.measure_ceilings(dev, **roofline.SHAPES)
    launches = {"probe_fma": ops.fma_probe.launches,
                "probe_rsqrt": ops.rsqrt_probe.launches}
    # main-path run ends here
    print(f"  ceilings {json.dumps(result)}", flush=True)
    for key, share in result["share_of_published_peak"].items():
        print(f"  {key}: {result[key]:.4f} = {100 * share:.2f} % of the "
              f"published peak {result['published_peak'][key]:g}",
              flush=True)
        check(0 < share <= CEILING_MAX_SHARE,
              f"{key} reads {100 * share:.1f} % of its published peak (the "
              f"timer is wrong above {100 * CEILING_MAX_SHARE:.0f} %)")
    print(f"  launches of the ceilings run: probe_fma {launches['probe_fma']} "
          f"(chain, 4-accumulator chain, kernel 10), probe_rsqrt "
          f"{launches['probe_rsqrt']}", flush=True)
    check(min(launches.values()) > 0, "the ceilings run launched no probe")
    return rows, errs, launches


def _finetune_model(edge_impl, dev):
    """The committed config's model, with ``edge_impl`` where one is given,
    holding ``models/best_model.pt``; returns (model, norm_stats)."""
    from nbody_gnn_hpc_torch.io import load_checkpoint, load_into
    from nbody_gnn_hpc_torch.models import model_from_config

    with open(CONFIG) as f:
        cfg = json.load(f)["model_config"]
    if edge_impl is not None:
        cfg = {**cfg, "edge_impl": edge_impl}
    model = model_from_config(cfg).to(dev)
    return model, load_into(model, load_checkpoint(BASE_MODEL))


def unroll_gradients_agree(data, masses, dev, edge_impl: str) -> float:
    """Gradients of the unrolled loss for every parameter of
    ``best_model.pt`` at B=8, through the kernels of ``edge_impl`` and
    through the plain versions, at each horizon of ``GRAD_HORIZONS``.
    Returns the error at the last, relative to each tensor's scale."""
    import torch

    from nbody_gnn_hpc_torch.models import count_parameters
    from nbody_gnn_hpc_torch.ops import (fused_edge_backward,
                                         fused_edge_layer,
                                         fused_edge_layer_plain,
                                         fused_full_layer,
                                         fused_full_layer_plain)
    from nbody_gnn_hpc_torch.train import make_unroll_loss

    model, norm_stats = _finetune_model(edge_impl, dev)
    check(count_parameters(model) == 2_550_150, "parameter count")
    mass_feat = (masses / masses.mean())[:, None].astype(np.float32)
    rng = np.random.RandomState(11)
    k_max = max(GRAD_HORIZONS)
    si = torch.as_tensor(rng.randint(0, TRAIN_SIMS, 8), device=dev)
    ti = torch.as_tensor(rng.randint(0, data.shape[1] - k_max - 1, 8),
                         device=dev)
    seq = data[si[:, None], ti[:, None] + torch.arange(k_max + 1,
                                                       device=dev)]
    counted = fused_full_layer if edge_impl == "fused_full" else \
        fused_edge_layer

    def grads(k, loss_fn, edge_stream, full_layer):
        for layer in model.layers:
            layer.edge_stream, layer.full_layer = edge_stream, full_layer
        model.zero_grad(set_to_none=True)
        loss = loss_fn(seq[:, :k + 1])
        loss.backward()
        return loss.item(), [p.grad.clone() for p in model.parameters()]

    for k in GRAD_HORIZONS:
        loss_fn = make_unroll_loss(model, norm_stats, mass_feat, K, N, k)
        before = counted.launches, fused_edge_backward.launches
        loss_k, g_k = grads(k, loss_fn, fused_edge_layer, fused_full_layer)
        check((counted.launches - before[0],
               fused_edge_backward.launches - before[1]) == (6 * k, 6 * k),
              f"the {edge_impl} kernel path did not launch its forward and "
              f"kernel 2 {6 * k} times each at K={k}")
        loss_p, g_p = grads(k, loss_fn, fused_edge_layer_plain,
                            fused_full_layer_plain)
        rel = max((a - b).abs().max().item() / (b.abs().max().item() + 1e-12)
                  for a, b in zip(g_k, g_p))
        zero = sum(int(b.abs().max().item() == 0) for b in g_p)
        print(f"  unroll gradients, edge_impl {edge_impl}, K={k}, B=8, all "
              f"{sum(g.numel() for g in g_k):,} parameters of "
              f"{BASE_MODEL}: loss {loss_k:.8f} kernels vs {loss_p:.8f} "
              f"plain; max error / tensor scale {rel:.3e}; tensors with an "
              f"all-zero gradient: {zero}", flush=True)
        check(abs(loss_k - loss_p) <= 1e-4 * abs(loss_p),
              f"unroll losses disagree at K={k}")
    check(rel <= MODEL_GRAD_RTOL and zero == 0,
          f"{edge_impl}: kernel-path unroll gradients at K={k} disagree with "
          f"the plain path beyond {MODEL_GRAD_RTOL:g} of scale")
    return rel


def _timed_steps(model, norm_stats, masses, data, horizon: int,
                 reps: int = 7) -> tuple:
    """Median and minimum ms of synchronised fine-tune steps at B=8 (after
    one warm-up step), and the peak device memory of one step above what
    was allocated before it, in GiB."""
    import torch

    from nbody_gnn_hpc_torch.train import (make_optimizer, make_unroll_loss,
                                           make_unroll_step)

    mass_feat = (masses / masses.mean())[:, None].astype(np.float32)
    step = make_unroll_step(
        model, make_unroll_loss(model, norm_stats, mass_feat, K, N, horizon),
        make_optimizer(model, 5e-5, 1e-4))
    rng = np.random.RandomState(horizon)
    win = torch.arange(horizon + 1, device=data.device)
    times, peak = [], 0.0
    for i in range(reps + 1):
        si = torch.as_tensor(rng.randint(0, TRAIN_SIMS, 8),
                             device=data.device)
        ti = torch.as_tensor(rng.randint(0, data.shape[1] - horizon - 1, 8),
                             device=data.device)
        seq = data[si[:, None], ti[:, None] + win]
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        step(seq)
        torch.cuda.synchronize()
        if i:
            times.append((time.perf_counter() - t0) * 1e3)
            peak = max(peak, (torch.cuda.max_memory_allocated() - base)
                       / 2 ** 30)
    return float(np.median(times)), min(times), peak


def curriculum_launches(spec: str, log_every: int) -> tuple:
    """Forward and kernel-2 launches of a curriculum: 6 layers x K steps
    for each update and each validation (the initial one, then every
    ``log_every`` steps and the last), the backward for each update."""
    from nbody_gnn_hpc_torch.finetune_rollout import parse_curriculum

    rungs = parse_curriculum(spec)
    return (sum(6 * h * (s + 1 + -(-s // log_every)) for h, s in rungs),
            sum(6 * h * s for h, s in rungs))


def run_curriculum(model, norm_stats, train_states, masses, spec: str,
                   log_every: int, label: str) -> list:
    """The rungs of ``spec`` through ``finetune_rollout``, each from the
    last rung's best; prints each rung's wall, mean step and peak memory.
    Returns [(horizon, steps, history, wall s, peak GiB), ...]."""
    import torch

    from nbody_gnn_hpc_torch.finetune_rollout import parse_curriculum
    from nbody_gnn_hpc_torch.train import finetune_rollout

    out = []
    for horizon, steps in parse_curriculum(spec):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, history = finetune_rollout(
            model, train_states, norm_stats, masses, k_neighbors=K,
            horizon=horizon, n_steps=steps, log_every=log_every)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        out.append((horizon, steps, history, wall, peak))
        print(f"  {label} rung K={horizon} x {steps} steps: {wall:.2f} s "
              f"with {1 + -(-steps // log_every)} validations = "
              f"{wall * 1e3 / steps:.1f} ms a step; peak device memory "
              f"{peak:.2f} GiB (the data on the device included); "
              f"validation {['%.6f' % v for v in history['val_loss']]}",
              flush=True)
    return out


def phase_finetune(states, masses, dev):
    """The rollout fine-tune and checkpoint selection, the sixth main path,
    on phase 7's datagen states.  Returns its launch counts."""
    import torch

    from nbody_gnn_hpc_torch.ops import (fused_edge_backward,
                                         fused_edge_layer, fused_full_layer)
    from nbody_gnn_hpc_torch.predict import (score_checkpoints,
                                             select_checkpoint)

    data = torch.as_tensor(states[:TRAIN_SIMS], device=dev)
    # (a) kernel-path unroll gradients against the plain path
    for impl in ("fused", "fused_full"):
        unroll_gradients_agree(data, masses, dev, impl)
    del data

    # (b) the cut curriculum through finetune_rollout, the config's
    # edge_impl ("fused"), then one short rung through "fused_full".
    counted = (fused_edge_layer, fused_edge_backward, fused_full_layer)
    fused, norm_stats = _finetune_model("fused", dev)
    full, _ = _finetune_model("fused_full", dev)
    train_states = states[:TRAIN_SIMS]
    # main-path run starts here
    for fn in counted:
        fn.launches = 0
    rungs = run_curriculum(fused, norm_stats, train_states, masses,
                           CUT_CURRICULUM, CUT_LOG_EVERY, "fused")
    full_rungs = run_curriculum(full, norm_stats, train_states, masses,
                                FULL_LAYER_RUNG, FULL_LAYER_LOG_EVERY,
                                "fused_full")
    launches = [fn.launches for fn in counted]
    # main-path run ends here
    want_fwd, want_bwd = curriculum_launches(CUT_CURRICULUM, CUT_LOG_EVERY)
    want_full, want_full_bwd = curriculum_launches(FULL_LAYER_RUNG,
                                                   FULL_LAYER_LOG_EVERY)
    want = [want_fwd, want_bwd + want_full_bwd, want_full]
    print(f"  launches on the fine-tune path: fused_edge_fwd {launches[0]}, "
          f"fused_edge_bwd {launches[1]}, fused_full_fwd {launches[2]} "
          f"(expected {want}: 6 layers x K for each update and validation, "
          f"kernel 2 under kernel 7 too)", flush=True)
    check(launches == want, "fine-tune launch counts")
    first = rungs[0][2]["val_loss"]
    print(f"  rung 1 validation loss {first[0]:.6f} -> {first[-1]:.6f} (the "
          f"JAX run behind best_rollout_model.pt: 0.00121 -> 0.00104 over "
          f"its first 100 steps)", flush=True)
    check(bool(np.isfinite([v for r in rungs + full_rungs
                            for v in r[2]["val_loss"]]).all()),
          "a fine-tune validation loss is not finite")
    check(first[-1] < first[0], "rung 1 did not lower the validation loss")

    # Step times (synchronised, B=8) and one step's peak memory.
    data = torch.as_tensor(train_states, device=dev)
    for label, model in (("fused", fused), ("fused_full", full)):
        for horizon in (8, 16):
            med, low, peak = _timed_steps(model, norm_stats, masses, data,
                                          horizon)
            print(f"  fine-tune step, edge_impl {label}, K={horizon}, B=8: "
                  f"median {med:.2f} ms, min {low:.2f} ms; one step's peak "
                  f"device memory above its inputs {peak:.3f} GiB",
                  flush=True)

    # (c) three K=8 steps under torch.profiler, and kernel 2's split.
    from nbody_gnn_hpc_torch.train import (make_optimizer, make_unroll_loss,
                                           make_unroll_step)

    step = make_unroll_step(fused, make_unroll_loss(
        fused, norm_stats, (masses / masses.mean())[:, None], K, N, 8),
        make_optimizer(fused, 5e-5, 1e-4))
    seq = data[:8, :9]
    rows = profile_window("3 fine-tune steps, K=8, B=8, edge_impl fused",
                          lambda: [step(seq) for _ in range(3)], steps=3)
    del data
    if rows:
        busy = sum(t for _, t, _ in rows)
        parts = {name: sum(t for key, t, _ in rows if name in key)
                 for name in ("fused_edge_bwd_source_kernel",
                              "fused_edge_bwd_target_kernel",
                              "reduce_rows_kernel", "fused_edge_fwd_kernel")}
        print("  kernel shares of the device time: " + ", ".join(
            f"{name} {t / 1e3:.3f} ms ({100 * t / busy:.1f} %)"
            for name, t in parts.items()), flush=True)

    # (d) checkpoint selection on the first validation sims
    val = states[TRAIN_SIMS:TRAIN_SIMS + SELECT_SIMS]
    with open(CONFIG) as f:
        cfg = json.load(f)
    from nbody_gnn_hpc_torch.models import model_from_config

    t0 = time.perf_counter()
    scores = score_checkpoints(model_from_config(cfg["model_config"]),
                               [BASE_MODEL, MODEL], val, masses, K,
                               horizon=SELECT_HORIZON,
                               start_step=SELECT_START, device=dev)
    best = select_checkpoint(scores)
    print(f"  selection, {SELECT_HORIZON} steps from step {SELECT_START} on "
          f"sims {TRAIN_SIMS}-{TRAIN_SIMS + SELECT_SIMS - 1} in "
          f"{time.perf_counter() - t0:.1f} s: " + "; ".join(
              f"{s['path']} position RMSE {s['position_rmse']:.4f}, velocity "
              f"RMSE {s['velocity_rmse']:.4f}" for s in scores)
          + f" (the JAX package's record for {BASE_MODEL}: "
            f"{JAX_BASE_SCORE}); selected {best['path']}", flush=True)
    check(best["path"] == MODEL, f"selection did not rank {MODEL} first")
    return dict(zip(("fused_edge_fwd", "fused_edge_bwd", "fused_full_fwd"),
                    launches))


def full_finetune(dev) -> dict:
    """``--full-finetune``: the production curriculum on the datagen
    states' train split, saved through the command's own code
    (``finetune_curriculum``), evaluated against the float64 oracle and
    scored against its base and the committed fine-tune."""
    import torch

    from nbody_gnn_hpc_torch import evaluate
    from nbody_gnn_hpc_torch.finetune_rollout import (finetune_curriculum,
                                                      parse_curriculum)
    from nbody_gnn_hpc_torch.models import model_from_config
    from nbody_gnn_hpc_torch.ops import (fused_edge_backward,
                                         fused_edge_layer, fused_full_layer)
    from nbody_gnn_hpc_torch.parallel import (fetch_host_trajectory,
                                              simulate_ensemble)
    from nbody_gnn_hpc_torch.predict import (score_checkpoints,
                                             select_checkpoint)
    from nbody_gnn_hpc_torch.sim import shared_masses
    from nbody_gnn_hpc_torch.train import rollout_tune

    d = DATAGEN
    masses = shared_masses(d["n"], seed=d["seed"])
    t0 = time.perf_counter()
    host = fetch_host_trajectory(simulate_ensemble(
        [d["seed"] + i for i in range(d["n_sims"])], d["n"], d["n_steps"],
        box_size=d["box"], dt=d["dt"], shared_masses=masses, device=dev))
    states = np.concatenate([host.positions, host.velocities], -1)
    del host
    print(f"  datagen {d['n_sims']} x {d['n_steps']} x N={d['n']} on the "
          f"card with the readback: {time.perf_counter() - t0:.2f} s",
          flush=True)
    check(bool(np.isfinite(states).all()), "datagen states are not finite")
    with open(CONFIG) as f:
        cfg = json.load(f)
    model, norm_stats = _finetune_model(None, dev)
    rungs = parse_curriculum(FULL_CURRICULUM)
    out = FINETUNE_DIR / "best_rollout_model.pt"
    shutil.rmtree(FINETUNE_DIR, ignore_errors=True)

    # Each rung's wall and peak memory, around the function the command
    # calls (measurement only).
    measured, real = [], rollout_tune.finetune_rollout

    def timed(*args, **kw):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        result = real(*args, **kw)
        torch.cuda.synchronize()
        measured.append((time.perf_counter() - t,
                         torch.cuda.max_memory_allocated() / 2 ** 30))
        return result

    counted = (fused_edge_layer, fused_edge_backward, fused_full_layer)
    rollout_tune.finetune_rollout = timed
    try:
        t0 = time.perf_counter()
        # main-path run starts here
        for fn in counted:
            fn.launches = 0
        histories = finetune_curriculum(
            model, states[:TRAIN_SIMS], norm_stats, masses, rungs,
            output=out, base=BASE_MODEL, model_config=cfg["model_config"],
            k_neighbors=K, watchdog_s=600)
        launches = [fn.launches for fn in counted]
        # main-path run ends here
        wall = time.perf_counter() - t0
    finally:
        rollout_tune.finetune_rollout = real
    want_fwd, want_bwd = curriculum_launches(FULL_CURRICULUM, 100)
    summary = {"curriculum": FULL_CURRICULUM, "wall_s": wall, "rungs": []}
    for (h, s), r, (rung_wall, peak) in zip(rungs, histories, measured):
        val = r["history"]["val_loss"]
        summary["rungs"].append({"horizon": h, "steps": s, "wall_s": rung_wall,
                                 "ms_a_step": rung_wall * 1e3 / s,
                                 "peak_gib": peak, "val_loss": val})
        print(f"  rung K={h} x {s}: {rung_wall:.1f} s = "
              f"{rung_wall * 1e3 / s:.1f} ms a step (validations included); "
              f"peak device memory {peak:.2f} GiB; validation {val[0]:.6f} "
              f"-> best {min(val):.6f}, last {val[-1]:.6f}", flush=True)
    print(f"  curriculum {FULL_CURRICULUM} in {wall:.1f} s (save included); "
          f"launches fused_edge_fwd {launches[0]} (expected {want_fwd}), "
          f"fused_edge_bwd {launches[1]} (expected {want_bwd}), "
          f"fused_full_fwd {launches[2]}", flush=True)
    check(launches == [want_fwd, want_bwd, 0], "fine-tune launch counts")
    check(bool(np.isfinite([v for r in histories
                            for v in r["history"]["val_loss"]]).all()),
          "a fine-tune validation loss is not finite")
    first = histories[0]["history"]["val_loss"]
    check(first[-1] < first[0], "rung 1 did not lower the validation loss")

    t0 = time.perf_counter()
    rc = evaluate.main(["-m", str(out), "-c", CONFIG, "-o",
                        str(FINETUNE_DIR / "eval"), "--f64-ground-truth"])
    check(rc == 0, f"evaluate exited {rc}")
    with open(FINETUNE_DIR / "eval" / "evaluation_results.json") as f:
        avg = json.load(f)["average_metrics"]
    summary["evaluation"] = {k: avg[k] for k in (
        "position_rmse", "position_rmse_std", "velocity_rmse",
        "velocity_rmse_std")}
    print(f"  evaluate {out}, f64 oracle, in {time.perf_counter() - t0:.1f} "
          f"s: position RMSE {avg['position_rmse']:.4f} ± "
          f"{avg['position_rmse_std']:.4f}, velocity RMSE "
          f"{avg['velocity_rmse']:.4f} ± {avg['velocity_rmse_std']:.4f} "
          f"(band < {EVAL_POS_RMSE_MAX:g} / < {EVAL_VEL_RMSE_MAX:g}; the JAX "
          f"fine-tune lands at 33-36, RESULTS.md)", flush=True)
    check(avg["position_rmse"] < EVAL_POS_RMSE_MAX
          and avg["velocity_rmse"] < EVAL_VEL_RMSE_MAX,
          "the fine-tuned checkpoint's evaluation RMSE is outside the band")

    scores = score_checkpoints(
        model_from_config(cfg["model_config"]), [BASE_MODEL, MODEL, str(out)],
        states[TRAIN_SIMS:TRAIN_SIMS + SELECT_SIMS], masses, K,
        horizon=SELECT_HORIZON, start_step=SELECT_START, device=dev)
    summary["selection"] = {s["path"]: s["position_rmse"] for s in scores}
    print(f"  selection, {SELECT_HORIZON} steps on sims {TRAIN_SIMS}-"
          f"{TRAIN_SIMS + SELECT_SIMS - 1}: " + "; ".join(
              f"{s['path']} {s['position_rmse']:.4f} / "
              f"{s['velocity_rmse']:.4f}" for s in scores)
          + f"; selected {select_checkpoint(scores)['path']} (the JAX "
            f"package's record for {BASE_MODEL}: {JAX_BASE_SCORE})",
          flush=True)
    check(scores[2]["position_rmse"] < scores[0]["position_rmse"],
          "the fine-tuned checkpoint does not beat its base")
    return summary


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--full-finetune", action="store_true",
                        help=f"build, simulate the datagen states, then run "
                             f"the production curriculum {FULL_CURRICULUM} "
                             f"from {BASE_MODEL}, evaluate and score the "
                             f"result (instead of phases 3-10)")
    args = parser.parse_args(argv)
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
    from nbody_gnn_hpc_torch.io import load_checkpoint, load_into
    from nbody_gnn_hpc_torch.models import model_from_config
    from nbody_gnn_hpc_torch.ops.cuda_build import build, build_log
    t_start = time.perf_counter()

    # 2. Build
    t0 = time.perf_counter()
    sources = ["fused_edge", "pairwise", "fused_edge_full", "probes"]
    built = build(sources)
    print(f"[2] built {sorted(built) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for name in sources:
        for entry, report in ptxas_report(build_log(name)):
            print(f"    {name}: {entry}: {report}", flush=True)
    dev = torch.device("cuda")
    if args.full_finetune:
        print(f"[10] the production fine-tune {FULL_CURRICULUM}, its "
              f"evaluation and selection", flush=True)
        summary = full_finetune(dev)
        print(f"  chip_smoke --full-finetune took "
              f"{time.perf_counter() - t_start:.1f} s after the imports",
              flush=True)
        print(json.dumps({"full_finetune": summary}), flush=True)
        print(smi[0], flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": dev_name,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    # 3. Kernels against their plain versions
    print("[3] kernels vs plain versions on the card", flush=True)
    with open(CONFIG) as f:
        cfg = json.load(f)["model_config"]
    model = model_from_config(cfg).to(dev).eval()
    norm_stats = load_into(model, load_checkpoint(MODEL))
    from nbody_gnn_hpc_torch.ops import accelerations_symmetric_mxu as mxu

    with torch.inference_mode():
        rows, errs = phase_kernels(model, norm_stats, dev)
        force_rows, force_errs = phase_force_kernels(dev)
    full_rows, full_err = phase_full_layer(model, norm_stats, dev)
    # Kernel 5 is dispatched by no entry point: its launches so far are this
    # script's own, and each path below must launch it no time.
    mxu_by_path = {"oracle": mxu.launches}

    def path(name, fn, *args):
        mxu.launches = 0
        out = fn(*args)
        mxu_by_path[name] = mxu_by_path.get(name, 0) + mxu.launches
        return out

    # 4. Serving main path
    print("[4] serving the production checkpoint", flush=True)
    service, serve_fwd, traj20 = path("serving", phase_serving, dev_name)

    # 5. Where the serving time goes
    print("[5] profile", flush=True)
    path("serving", phase_profile, service)

    # 6. Training main path
    print("[6] training the production-width model", flush=True)
    train_fwd, train_bwd = path("training", phase_train, dev)

    # 7. The simulator side, the third main path
    print("[7] the simulator side: datagen, large-N /simulate, evaluation",
          flush=True)
    sim, oracle, states, sim_masses = path("simulator", phase_simulator,
                                           service, dev)

    # 8. Serving as it is deployed, the fourth main path
    print("[8] serving as deployed: fused_full behind the pool, the "
          "micro-batcher and the gate; quantization", flush=True)
    deployed = path("deployed", phase_deployed, dev_name, service, traj20)

    # 9. The card's ceilings, the fifth main path
    print("[9] the card's ceilings: kernels 10 and 11, python -m "
          "nbody_gnn_hpc_torch.roofline in process", flush=True)
    probe_rows, probe_errs, ceilings = path("ceilings", phase_ceilings, dev)

    # 10. The rollout fine-tune and checkpoint selection, the sixth path
    print("[10] rollout fine-tune and checkpoint selection", flush=True)
    finetune = path("finetune", phase_finetune, states, sim_masses, dev)
    del states
    print(f"  kernel 5 (pairwise_symmetric_mxu) launches by path: "
          f"{mxu_by_path} (every entry-point path must read 0)", flush=True)
    check(all(v == 0 for k, v in mxu_by_path.items() if k != "oracle"),
          "an entry point launched kernel 5, which nothing dispatches")

    by_path = {
        "fused_edge_fwd": {"serving": serve_fwd, "training": train_fwd},
        "fused_edge_bwd": {"serving": 0, "training": train_bwd}}
    table = {"kernels": []}
    for name, source, replaces, shape, kernel_rows, err in (
            ("fused_edge_fwd", "fused_edge",
             "nbody_gnn_hpc_tpu/ops/fused_edge.py:91 (and "
             "ops/fused_edge_batched.py:91)", None, rows, errs),
            ("fused_edge_bwd", "fused_edge",
             "nbody_gnn_hpc_tpu/ops/fused_edge.py:114 (and "
             "ops/fused_edge_batched.py:123)", None, rows, errs),
            ("pairwise_tiled", "pairwise",
             "nbody_gnn_hpc_tpu/ops/pairwise.py:41", f"N={LARGE_N}",
             force_rows, force_errs),
            ("pairwise_small", "pairwise",
             "nbody_gnn_hpc_tpu/ops/pairwise.py:139",
             f"B={DATAGEN['n_sims']} N={DATAGEN['n']}", force_rows,
             force_errs),
            ("pairwise_symmetric", "pairwise",
             "nbody_gnn_hpc_tpu/ops/pairwise.py:212", f"N={LARGE_N}",
             force_rows, force_errs),
            ("fused_full_fwd", "fused_edge_full",
             "nbody_gnn_hpc_tpu/ops/fused_edge_full.py:78", "deployed",
             full_rows, {"fused_full_fwd": full_err}),
            ("pairwise_symmetric_mxu", "pairwise",
             "nbody_gnn_hpc_tpu/ops/pairwise.py:291", f"N={LARGE_N}",
             force_rows, force_errs),
            ("probe_fma", "probes", "benchmarks/roofline.py:184",
             probe_rows[0]["shape"], probe_rows, probe_errs),
            ("probe_rsqrt", "probes", "benchmarks/roofline.py:214",
             probe_rows[1]["shape"], probe_rows, probe_errs)):
        mine = [r for r in kernel_rows if r["kernel"] == name]
        if shape is None:  # the edge kernels: the training form at B=24
            row = next(r for r in mine
                       if r["form"] == "training" and r["B"] == 24)
            shape = "training form, B=24 N=200 k=40 H=256"
        elif shape == "deployed":  # kernel 7: the micro-batched dispatch
            row = next(r for r in mine
                       if r["form"] == "inference" and r["B"] == 8)
            shape = "inference form, B=8 N=200 k=40 H=256"
        else:
            row = next(r for r in mine if r["shape"] == shape)
        # "oracle": this script's own calls in phase 7 (the dispatch held
        # against kernel 3), counted apart from what the entry points ran.
        paths = {"serving": 0, "training": 0, **by_path.get(name, {}),
                 "simulator": sim.get(name, 0),
                 "deployed": deployed.get(name, 0),
                 "ceilings": ceilings.get(name, 0),
                 "finetune": finetune.get(name, 0),
                 "oracle": oracle.get(name, 0)}
        if name == "pairwise_symmetric_mxu":
            paths = {key: mxu_by_path.get(key, 0) for key in paths}
        table["kernels"].append({
            "name": name, "route": "cuda",
            "source": f"nbody_gnn_hpc_torch/csrc/{source}.cu",
            "replaces": replaces, "launches": sum(paths.values()),
            "launches_by_path": paths, "max_abs_err": err[name],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "shape": shape, "by_shape": mine,
            **({"composed_ms": row["composed_ms"]}
               if "composed_ms" in row else {})})
    # Kernels 3 and 5 are dispatched by no entry point: their launches are
    # this script's own comparisons.  The probes run on the ceilings path.
    # Every other kernel must have been launched by an entry point.
    for k in table["kernels"]:
        by = k["launches_by_path"]
        if k["name"] in ("pairwise_tiled", "pairwise_symmetric_mxu"):
            ran = by["oracle"]
        elif k["name"].startswith("probe_"):
            ran = by["ceilings"]
        else:
            ran = k["launches"] - by["oracle"]
        check(ran > 0, f"{k['name']} was never launched on a path")
    check(min(finetune.values()) > 0, "the fine-tune path launched no "
                                      "kernel 1, 2 or 7")
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
