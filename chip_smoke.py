#!/usr/bin/env python3
"""Drive the PyTorch port's serving, training, simulator, deployed-serving,
ceilings, rollout fine-tune, one-command pipeline, data-parallel,
simulator-surface and checkpoint paths, its last commands, bf16
training and GNS's training on one NVIDIA GPU and check them.

    python3 chip_smoke.py
    python3 chip_smoke.py --full-finetune   # the production curriculum
    python3 chip_smoke.py --large-n         # the large-N pipeline
    python3 chip_smoke.py --gns             # phase 16 alone

Phases (any failure exits non-zero and prints no result line):

1. Environment: the card's name and power limit (nvidia-smi); no CUDA
   device is a failure.
2. Build every CUDA kernel of the paths from ``nbody_gnn_hpc_torch/csrc``
   (one nvcc per source, all started together); print each kernel's
   registers, spills, static shared memory, SASS instruction count and
   tensor-core (HMMA, HGMMA) instructions; kernel 7's bf16 form must hold
   some, its float32 form none.
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
   by 300 and N=2,085, rtol 2e-4 with atol 2e-5 of scale, at the edges of
   its schedule (``MXU_EDGE_N``), and at N=10,000 against a float64 direct
   sum at the same tolerance, its per-particle difference from its plain
   version and from kernel 6 reported; it must then stay unlaunched on
   every path below (its launches are this script's own, "oracle").
   Reruns must be bit-identical (no float atomics).  Times with CUDA events, bounds from
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
5. Profile: a 40-step rollout (``PROFILE_STEPS``) under torch.profiler,
   for where the time goes (device-busy share, time by kernel).
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
   these launches are reported apart, as "oracle"), and the
   ``generate_data`` command at the datagen shape on the npz store (and
   with HDF5 files where h5py is importable): files equal to
   ``simulate_ensemble``'s, a rerun that must resume, the manifest's form,
   and ``datasets_from_manifest``.
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
   served; a bf16 checkpoint written and reloaded where ``ml_dtypes``
   imports (equal to the in-memory bf16 service over 5 steps; where it
   does not, said so).  A 40-step rollout of either service under
   torch.profiler.
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
11. The one-command pipeline, the seventh main path:
   ``run_demo.run_pipeline`` with ``--production --trajectory-format npz
   --device cuda --epochs 1 --max-samples 2400`` over ``TrainingConfig()``
   whole, in a fresh temporary directory (removed after), each stage a
   process: datagen 300 x 400 at N=200 on the npz store, one epoch of 100
   steps, selection at the full horizon, the fine-tune curriculum cut to
   8:100,16:40 (the only change to the stage table), evaluation of 10 sims
   against the f64 oracle, the CSV export.  Every stage must exit 0 and
   the five that drive the device name cuda; the manifest must record
   npz beside 300 npz trajectories; every model, selection, evaluation and
   CSV file must exist; training must have run in bf16 (``config.json``),
   as ``train_model`` does on the card; the RMSEs must be finite and
   inside the evaluation band (< 60 / < 400); ``best_rollout_model.pt``
   must record the cut curriculum from ``selected_model.pt``.  Each
   stage's process starts its counts at 0 and prints them last
   (``ops.launch_line``): kernel 4 once per step and batch in datagen,
   the bf16 forms of kernels 1 and 2 6 times per step and validation
   batch in training, kernels 1 and 2 6 times per update and validation
   in the fine-tune, kernel 1 6 x 395 per checkpoint in selection and 6 x
   394 in evaluation, exactly.  A JSON line ``{"pipeline": ...}`` gives each
   stage's wall, the total, the two RMSEs and the cuts.
12. Data parallel and the simulator surface, the eighth main path, each
   drive's counts zeroed just before and read just after.  (a) World one
   on NCCL (``parallel.init_data_parallel``, ``make_mesh``) at the
   production width (N=200, k=40, hidden 256, 6 layers, B=24, dropout and
   noise on), on 18 trajectories made on the card: the ``gspmd`` DP step
   against ``make_train_step`` (two steps; loss and every parameter within
   1e-6 of scale, bit-equality reported), ``Trainer(mesh=make_mesh())``
   for an epoch of 20 steps and a validation against ``Trainer(mesh=None)``
   (the same tolerance), kernels 1 and 2 exactly 6 a step and validation
   batch; ``simulate_ensemble(mesh=)`` over (300, 200) x 50 bit-equal to the
   unsharded run, kernel 4 51 times.  (b) Two gloo ranks sharing
   ``cuda:0``, spawned processes (NCCL refuses two ranks on one GPU): the
   ``gspmd`` step with noise and dropout on through ``fused`` and
   ``fused_full`` (kernel 7's cooperative launch in two processes) against
   one device taking the same two halves (1e-6 of each tensor's scale) and
   against one device's whole batch: loss rtol 1e-5, the first step's
   clipped gradients 1e-4 of each tensor's scale and the parameters after
   it element by element at rtol 1e-4 / atol 1e-6 (certify_multichip's
   one-step hold; after the second step the same measure is printed);
   each rank's kernels 1 (or 7) and 2 exactly 12.  The sharded ensembles of 301 sims x 4
   steps: the JAX certification's systems (N=8, box 5) against the
   unsharded run at rtol 2e-5 / atol 1e-5, the datagen protocol's (N=200,
   box 10) per particle (as [7] compares large-N runs); both bit for bit
   against one device simulating the same two blocks; kernel 4 five times
   a rank.  (c) ``NBodySimulator.create_galaxy_collision
   (n_per_galaxy=1100)`` (N=2,200) for 50 steps: kernel 6 once a force
   evaluation (52), frames 1-5 per particle against ``device="cpu"`` (as
   [7] compares large-N runs), the energy after 50 steps within a factor 4
   of the float64 oracle's from the same scene (both printed);
   ``run_parallel_simulations`` over 8 same-parameter configs at N=200 x
   50 steps plus one other config: one ensemble (kernel 4 51 times) and
   one run alone, in input order, frames 0-5 against ``device="cpu"``
   (1e-3 of scale).  (d) The GNN above N = 2,048: a 5-step rollout at
   N=2,085 (the row-blocked k-NN) through ``fused`` and ``fused_full``
   against ``device="cpu"`` per particle, kernel 1 (or 7) 6 x 5 times, and
   one training step there (B=2) through kernels 1 and 2 against the plain
   versions on the card (1e-3 of each gradient's scale).  The kernels
   line's ``launches_by_path`` has ``parallel`` (the spawned ranks'
   counts, read in their processes, included), ``simulator_surface`` and
   ``surrogate_large_n``.
13. Async training checkpoints, the plots and the viewer, the ninth main
   path.  Phase 6's data size (10 sims x 40 steps at N=200, written by
   ``generate_data --no-windows --trajectory-format npz``, 8 train / 2
   validation) at the production width.  Counts zeroed just before and
   read just after each drive: (a) ``Trainer(ckpt_backend="orbax")`` and a
   ``"pickle"`` trainer from the same seed, 2 epochs, ``save_every=1``
   (kernels 1 and 2 exactly 6 a step and validation batch), the time each
   ``save_model`` blocks, the final wait for durability; (b) fresh
   trainers load each backend's ``final_model.pt``: parameters, AdamW
   step and both moments bit-equal to what was saved and between the
   backends, epoch, step count and ``norm_stats`` equal, the next epoch's
   losses within rtol 1e-6.  After: (c) ``save_model``, one more step,
   wait, restore: the pre-step parameters; the train step wall without a
   write in flight, and for the trainer's flat layout and for the
   per-tensor state dicts, in turns, the save call, the steps a write
   outlasts and the save to durable; (d) an index entry whose step lacks
   ``.metadata`` is passed over by ``latest_checkpoint(backend="orbax")``;
   (e) ``train_model --ckpt-backend orbax`` as a process for one epoch,
   then with ``--resume auto`` to two (each one's launches read from its
   line, exactly: the bf16 forms of kernels 1 and 2, its default on the
   card); (f) where matplotlib imports, evaluate's three plots
   (a 20-step rollout of the production checkpoint against the float32
   ground truth), train_model's and the demo's, each non-empty; where it
   does not, the commands must say that they skipped them; (g)
   ``python -m nbody_gnn_hpc_torch.examples.demo_galaxy_collision`` at its
   defaults as a process (its wall and launches), and
   ``export_interactive_html`` of phase 12's galaxy trajectory (N=2,200 x
   50 steps): every particle and 17 of 51 frames in its ``DATA``.  A JSON
   line ``{"checkpoint": ...}`` gives the times.  The kernels line's
   ``launches_by_path`` has ``checkpoint``, where kernels 1 and 2 must
   have run.

14. The last commands, the tenth main path, each a process from the
   repository root whose counts start at 0 and which prints them last
   (``launches_by_path["commands"]``): ``benchmark_bh_temp -n 5000 --steps
   5`` (kernel 6 exactly 2 + 50 x 6 times; its rounds and average step time
   printed), ``examples.demo_surrogate --trajectory-format npz`` at its
   defaults (kernel 4 exactly twice 81 times, kernels 1 and 2; six npz
   trajectories; finite RMSEs), ``merge_dataset`` on that store where h5py
   imports (train 4 x 76 and val 2 x 76 windows with masses; where it does
   not, said so), ``examples.demo_serving`` at its defaults and at the
   production width (``models/best_rollout_model.pt``, N=200, k=40, int8;
   every client answered, kernel 1), ``examples.demo_parallel`` at world one
   and with two spawned gloo ranks (its three sections; kernel 4 exactly
   twice 51 times a rank, kernels 1 and 2).  Kernel 5 must read 0 in each.
   A JSON line ``{"commands": ...}`` gives each command's wall, its
   launches and the benchmark's step time.

15. bf16 training, the production recipe's precision, the eleventh main
   path.  (a) The bf16-stream form of kernels 1 and 2 (bf16 t_proj /
   s_proj; kernel 1 rounds each activation to bf16 after dropout and sums
   in float32; kernel 2 reads g_out at bf16 precision, rounds dz to bf16
   for d_t_proj only and returns d_t_proj / d_s_proj in bf16) against
   their plain bf16 versions on the checkpoint's layer-0 operands:
   kernel 1 in inference form at B=1 and in training form at B=1 and 24,
   kernel 2 in training form at B=1 and 24; within 2^-7 of scale with at
   most 1 % of the elements beyond 1e-4 of scale (a bf16 rounding that a
   float32 difference flips moves a value by its bf16 step), kernel 2's
   float32 gradients within 1e-4 of scale; exact launch counts (the bf16
   forms are counted apart, as ``fused_edge_fwd_bf16`` /
   ``fused_edge_bwd_bf16``); reruns bit for bit; CUDA-event times of the
   bf16 and float32 kernels on the same operands, and the bound.  (b)
   ``Trainer`` with a bf16 ``NBodyGNN`` at the production configuration
   (B=24, hidden 256, 6 layers, dropout and noise on) for an epoch on
   phase 13's data size, counts zeroed just before and read just after
   (the bf16 forms exactly 6 a step and validation batch, the float32
   ones never); losses finite, parameters float32; on one batch the bf16
   and float32 models' step walls in turns and a profiled window each,
   the bf16 loss falling; the production checkpoint's gradients through
   the bf16 kernels against the plain bf16 path (5e-2 of each tensor's
   scale, the loss 1e-3); the saved checkpoint, whose config says
   bfloat16, served at float32 by ``build_service`` for 5 steps against
   ``device="cpu"`` (1e-4 of scale).  (c) ``python -m
   nbody_gnn_hpc_torch.train_model`` for one step and its validation, as
   three processes at once: its defaults write ``"dtype": "bfloat16"``
   and launch the bf16 forms, ``--no-bf16`` writes float32 and launches
   the float32 ones, ``--remat`` launches kernel 1 once more a layer (the
   recompute), and its first step's loss and the validation loss after
   that step equal the default run's.  (d) Kernel 7's bf16 form
   (``edge_impl="fused_full"`` in a bf16 model: every product on the bf16
   tensor cores with a float32 sum, rounded where the TPU kernel rounds):
   (d1) against its plain bf16 version on the checkpoint's layer-0
   operands with wt and ws in bf16, inference at B=1 and 8, training at
   B=24 and the odd shape N=13, k=4 in both forms, within 2^-6 of scale
   (h_new is rounded twice) with at most 20 % of the elements beyond 1e-4
   of scale (a flipped rounding moves a whole row of the output a little),
   the float32 kernel
   on the same bf16 weights refused by that rule, the
   cooperative and ordinary-launch forms bit-equal, exact launch counts
   (``fused_full_fwd_bf16``), reruns bit for bit, timed beside the float32
   form; (d2) one layer's gradients at B=24 in training form against the
   reference backward on the card within 2^-7 of each one's scale, d_wt
   and d_ws bf16-exact; (d3) ``Trainer`` with a bf16 ``fused_full`` model at the
   production configuration for an epoch (exact launches), its fixed-batch
   loss falling, its step wall and busy share in turns with (b)'s bf16
   ``fused`` step, its checkpoint served at float32 through kernel 7 for 5
   steps against ``device="cpu"``; (d4) ``train_model --edge-impl
   fused_full`` at its defaults as a fourth process beside (c)'s, writing
   ``"dtype": "bfloat16"`` and ``"edge_impl": "fused_full"``.  A JSON
   line ``{"bf16": ...}`` gives the step walls, busy shares and losses.

16. GNS (``architecture: "gns"``, ``models/gns.py``), the second
   architecture, at the benchmark cell ``gns-n5000-train-bf16-b2``'s shape
   (B=2, N=5,000, k=40, latent 128).  (a) The receiver sum
   (``csrc/edge_sum.cu``, counted as ``edge_sum``) and the backward of
   the receiver gather, which is the same kernel, against
   ``receiver_sum_plain`` in float64 within 1e-5 of scale, each twice and
   bit-equal; timed by CUDA events beside the plain ``scatter_add_`` and
   the bound (211.6 MB over HBM bandwidth).  (b) GNS at its published
   widths (1,588,998 parameters) in bf16 through ``make_train_step`` for
   6 steps, counts zeroed just before and read just after: ``edge_sum``
   exactly 20 a step and no other hand-written kernel, one eager step,
   one capture, then replays, losses finite; the replayed step's wall.

Then it prints the kernel table as one JSON line, the nvidia-smi line,
and as the last line ``{"ok": true, "device": {...}}``.

The kernels line's ``launches_by_path`` has ``bf16`` (phase 15's two
Trainers and its four processes) and ``gns`` (phase 16's steps; its
kernel comparisons count under ``oracle``).

``--gns`` runs phases 1, 2 and 16 and prints a JSON line ``{"gns": ...,
"edge_sum": ...}`` (the summary and the kernel's timed row), the
nvidia-smi line and the same last line.

``--full-finetune`` runs phases 1 and 2, simulates the datagen states and
fine-tunes ``models/best_model.pt`` with the production curriculum
8:1500,16:900 on the first 240 sims through the command's own code
(``finetune_rollout.finetune_curriculum``, the watchdog armed), saving
``build/chip_smoke_finetune/best_rollout_model.pt``; then ``evaluate
--f64-ground-truth`` of that file (inside < 60 / < 400) and its score
against its base and the committed fine-tune (it must beat its base); it
ends with a JSON summary line, the nvidia-smi line and the same last line.

``--large-n`` runs phases 1 and 2, then ``python -m
nbody_gnn_hpc_torch.largen_pipeline build/chip_smoke_largen
--trajectory-format npz`` as a process: datagen, training (hidden 256, 6
layers, k=40) and evaluation at N=2,085 and 5,000, each stage a process of
its own; every stage must run on cuda, both scales give finite RMSEs, and
kernels 1, 2 and 6 run and kernel 5 not.  It prints the stage walls and
results, a JSON summary line, the nvidia-smi line and the same last line.
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
    from nbody_gnn_hpc_torch.roofline import (PEAK_BF16_PER_S,
                                              PEAK_BYTES_PER_S, PEAK_F32_PER_S,
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
# The profiled serving window ([5], [8]): every step of a rollout is alike
# (337 launches with "fused", 175 with "fused_full").  Over all 394 steps
# [5] took 70.7 s on an H100's host around a 3.2 s rollout and its 9.9 s
# profiled twin: the rest was reading the profile's 132,777 launches.
PROFILE_STEPS = 40
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
# Kernel 3 at the edges of its schedule (ops.tiled_schedule on 132 SMs), as
# (B, N): tiny systems, a last tile one short (2,047, 9,727) and of one
# source (4,097, 9,729), one above a multiple of k (2,049), ragged receiver
# groups (2,111, 4,097, 9,727, 9,729), k split into 2 and 4 slices (2,049 to
# 4,097), blocks that stage two and four systems (3 x 2,085, 300 x 200).
TILED_EDGE = ((1, 1), (1, 3), (1, 2_047), (1, 2_049), (1, 2_111), (1, 4_097),
              (1, 9_727), (1, 9_729), (3, ODD_N), (300, 200))
# Kernel 5 at the edges of its schedule (ops.mma_schedule on 132 SMs): tiny
# systems (tiles of 32), one below and one above a multiple of the tile it
# takes near N=2,085 (64: 2,048, 2,112) and N=10,000 (128: 9,984).  From
# MXU_F64_MIN_N on it is held, as at N=10,000, to the float64 direct sum:
# there the float32 plain version itself misses that sum by ~2.8 times the
# tolerance (the moment form's close-pair rounding), so no implementation
# of the form could be held to it.
MXU_EDGE_N = (1, 2, 127, 129, 2_047, 2_049, 2_111, 2_113, 9_983, 9_985)
MXU_F64_MIN_N = 9_000
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
# Phase 11, the one-command pipeline: --production over TrainingConfig()
# whole (datagen 300 x 400 at N=200 on the npz store, selection at the full
# horizon, evaluation of 10 sims against the f64 oracle), its depth cut to
# one epoch of 2,400 samples and the fine-tune to phase 10's curriculum.
PIPELINE_FLAGS = ("--production", "--trajectory-format", "npz", "--device",
                  "cuda", "--epochs", "1", "--max-samples", "2400")
PIPELINE_CUTS = {"finetune_rollout": {"--curriculum": CUT_CURRICULUM}}
PIPELINE_LOG = Path("build/chip_smoke_pipeline.log")  # git-ignored


# Template arguments of a mangled kernel name: integers, float and bf16.
_TEMPLATE_ARG = r"Li(-?\d+)E|(f)|13(__nv_bfloat16)"


def _kernel_name(mangled: str) -> str:
    """``name<args>`` of a mangled kernel: the shortest length-prefixed
    name that ends in ``_kernel`` (a hash's digits may run into the length
    and make a longer one) and its template arguments (integers, ``float``
    and ``bf16``)."""
    found = []
    for m in re.finditer(r"\d+", mangled):
        digits = m.group()
        for k in range(len(digits)):
            end = m.end() + int(digits[k:])
            name = mangled[m.end():end]
            if name.endswith("_kernel"):
                args = re.match(rf"I((?:{_TEMPLATE_ARG})+)E", mangled[end:])
                values = [i or ("float" if f else "bf16") for i, f, _ in
                          re.findall(_TEMPLATE_ARG, args[1])] if args else []
                found.append(name + (f"<{','.join(values)}>" if values
                                     else ""))
    return min(found, key=len) if found else mangled


def ptxas_report(log: str) -> list:
    """(kernel, "N registers, spills, static shared memory") of each entry
    function in an nvcc ``-Xptxas -v`` log."""
    out, entry, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = _kernel_name(line.split("'")[1])
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line and entry:
            regs = re.search(r"Used (\d+) registers", line)
            smem = re.search(r"(\d+) bytes smem", line)
            out.append((entry, f"{regs.group(1) if regs else '?'} registers, "
                               f"{spill}, {smem.group(1) if smem else 0} "
                               f"bytes static shared memory"))
            entry = None
    return out


def sass_counts(lib: Path) -> dict:
    """{kernel: (SASS instructions, NOPs aside; tensor-core instructions,
    HMMA and HGMMA)} of each function in a built library, by ``cuobjdump
    -sass`` (empty where the tool is missing): static counts, so the body
    of a loop the compiler unrolled counts once an iteration and that of a
    loop it kept, once."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not (Path(tool).exists() and lib.exists()):
        return {}
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = _kernel_name(line.split("Function :")[1].strip())
            counts[name] = [0, 0]
        elif name and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?!NOP\b)\S", line):
            counts[name][0] += 1
            counts[name][1] += bool(re.search(r"\bH(G)?MMA\.", line))
    return {k: tuple(v) for k, v in counts.items()}


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
    return sum(t.numel() * t.element_size() for t in (
        tp, sp, ea, we, gamma, beta, edges.perm, edges.src, edges.offsets))


def edge_bound_ms(args, dropout: bool = False) -> tuple:
    """Least H100 time for one fused edge-stream forward on these
    operands: each input read once (t_proj and s_proj at their element
    size: 2 bytes in the bf16 stream), the float32 output written once,
    over HBM bandwidth; and (13 + 2*D) float32 operations per edge channel
    (z: 2 adds + D FMAs; statistics: 3; normalise: 4; SiLU: exp, add,
    divide; accumulate: 1), one more with dropout (the scale), over the
    non-tensor-core float32 peak.  Philox's integer work and the bf16
    stream's conversions are not counted."""
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
    dot products); Philox not counted.  In the bf16 stream d_t_proj and
    d_s_proj are written at 2 bytes (g_out is float32 in both)."""
    tp, ea, edges = args[0], args[2], args[6]
    b, n, h = tp.shape
    e, d = ea.shape[1], ea.shape[2]
    src = edges.sources
    n_bytes = (_operand_bytes(args) + 4 * (src.perm.numel() + src.dst.numel()
                                           + src.offsets.numel())
               + b * n * h * (4 + 2 * tp.element_size()) + 4 * (d + 2) * h
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


def profile_window(label: str, fn, steps: int = 0, out: dict = None):
    """Run ``fn`` once plain and once under torch.profiler; print the wall
    times, the device-busy share, the launches (per step where ``steps``)
    and the top kernels by device time.  Returns the device rows (name,
    device µs, count), or None where no device time was recorded; ``out``
    gets the unprofiled wall (ms) and the busy share."""
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
    if out is not None:
        out.update(wall_ms=plain_wall * 1e3,
                   busy_share=busy_us / 1e6 / plain_wall)
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
    """A PROFILE_STEPS-step final-state rollout under torch.profiler."""
    pos, vel, masses = eval_states(1)
    profile_window(f"{PROFILE_STEPS}-step rollout, edge_impl {label} "
                   f"(service call, no HTTP)",
                   lambda: service.rollout(pos[0], vel[0], masses,
                                           PROFILE_STEPS, trajectory=False),
                   steps=PROFILE_STEPS)


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


def model_gradients_agree(train, cfg, dev, edge_impl: str = "fused",
                          dtype: str = "float32") -> dict:
    """Gradients of every parameter of the production checkpoint on one
    training batch (dropout and noise on), through the kernels of
    ``edge_impl`` and through the plain versions with the same generator
    seed (so the same masks), the model computing in ``dtype``.

    bfloat16: the bf16 forms, held to BF16_MODEL_GRAD_RTOL and
    BF16_LOSS_RTOL; then two more runs through the kernels.  With remat
    the loss and every gradient must equal the kernel path's bit for bit
    (the recomputed backward is read: ``decoder_out`` is non-zero here).
    A float32 model of the same weights is the control: its gradients,
    held to the bf16 plain path by the same measure, must lie beyond
    BF16_MODEL_GRAD_RTOL, so that limit tells the bf16 forms from a model
    that rounds nothing.  Returns the readings (errors relative to each
    tensor's scale)."""
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
        config = {**json.load(f)["model_config"], "edge_impl": edge_impl}
    masses = torch.as_tensor(train.get_masses_tensor(), device=dev)
    states = torch.as_tensor(train.last_states[:cfg.batch_size], device=dev)
    targets = torch.as_tensor(train.targets[:cfg.batch_size], device=dev)

    def built(dt):
        m = model_from_config(config, dtype_override=dt).to(dev)
        load_into(m, load_checkpoint(MODEL))
        return m, make_train_step(
            m, make_optimizer(m, cfg.learning_rate, cfg.weight_decay),
            train.edge_index, train.state_mean, train.state_std,
            (masses / masses.mean())[:, None], noise_std=cfg.noise_std,
            masses=masses)

    model, step = built(dtype)

    def grads(edge_stream, full_layer, m=model, st=step):
        for layer in m.layers:
            layer.edge_stream, layer.full_layer = edge_stream, full_layer
        m.zero_grad(set_to_none=True)
        loss, _ = st.compute_loss(
            states, targets, torch.Generator(dev).manual_seed(321))
        loss.backward()
        return loss.item(), [p.grad.clone() for p in m.parameters()]

    def rel_of(got, want):
        return max((a - b).abs().max().item() / (b.abs().max().item() + 1e-12)
                   for a, b in zip(got, want))

    bf16 = dtype == "bfloat16"
    rtol, loss_rtol = ((BF16_MODEL_GRAD_RTOL, BF16_LOSS_RTOL) if bf16
                       else (MODEL_GRAD_RTOL, 1e-5))

    def launched():
        if bf16:
            return (fused_edge_layer.bf16_launches,
                    fused_edge_backward.bf16_launches)
        counted = fused_full_layer if edge_impl == "fused_full" else \
            fused_edge_layer
        return counted.launches, fused_edge_backward.launches

    def delta(before):
        return tuple(a - b for a, b in zip(launched(), before))

    before = launched()
    loss_k, g_k = grads(fused_edge_layer, fused_full_layer)
    check(delta(before) == (6, 6),
          f"the {edge_impl} {dtype} kernel path did not launch its forward "
          f"and kernel 2 six times each")
    loss_p, g_p = grads(fused_edge_layer_plain, fused_full_layer_plain)
    n = sum(g.numel() for g in g_k)
    check(n == count_parameters(model) == 2_550_150, "parameter count")
    rel = rel_of(g_k, g_p)
    zero = sum(int(b.abs().max().item() == 0) for b in g_p)
    print(f"  gradients of all {n:,} parameters, edge_impl {edge_impl}, "
          f"{dtype}, kernels vs plain versions (production checkpoint, "
          f"B={cfg.batch_size}, dropout + noise on, same seeds): loss "
          f"{loss_k:.7f} vs {loss_p:.7f}; max error / tensor scale "
          f"{rel:.3e} over {len(g_k)} tensors (tolerance {rtol:g}); tensors "
          f"with an all-zero gradient: {zero}", flush=True)
    check(all(p.dtype == g.dtype == torch.float32
              for p, g in zip(model.parameters(), g_k)),
          "a parameter or its gradient is not float32")
    check(zero == 0, "a parameter's gradient is all zero")
    check(abs(loss_k - loss_p) <= loss_rtol * abs(loss_p), "losses disagree")
    check(rel <= rtol, "kernel-path gradients disagree with the "
                       "plain-version path")
    readings = {"kernel_vs_plain": rel}
    if not bf16:
        return readings

    # remat: the layers recomputed in the backward pass, their kernels
    # launched again, the same draws.
    model.remat = True
    before = launched()
    loss_r, g_r = grads(fused_edge_layer, fused_full_layer)
    model.remat = False
    moved = delta(before)
    same = loss_r == loss_k and all(torch.equal(a, b)
                                    for a, b in zip(g_r, g_k))
    readings["remat_vs_kernel"] = rel_of(g_r, g_k)
    print(f"  remat=True, the same batch and seeds through the kernels: loss "
          f"{loss_r!r} vs {loss_k!r}; every gradient bit-equal to the run "
          f"without remat: {same} (max error / scale "
          f"{readings['remat_vs_kernel']:.3e}); launches {moved} (12 "
          f"forward, 6 backward)", flush=True)
    check(same, "remat changed the loss or a gradient")
    check(moved == (12, 6), "remat did not recompute each layer's forward "
                            "kernel once")

    # The control: a float32 model of the same weights, through its kernels.
    _, g_c = grads(fused_edge_layer, fused_full_layer, *built("float32"))
    control = readings["float32_vs_plain"] = rel_of(g_c, g_p)
    print(f"  control: the float32 model's gradients (same weights, seeds) "
          f"against the bf16 plain path: max error / tensor scale "
          f"{control:.3e}; the limit {BF16_MODEL_GRAD_RTOL:g} lies between "
          f"it and the bf16 kernels' {rel:.3e}: "
          f"{rel <= BF16_MODEL_GRAD_RTOL < control}", flush=True)
    check(control > BF16_MODEL_GRAD_RTOL,
          "the bf16 gradient limit does not tell the bf16 forms from a "
          "float32 model")
    return readings


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
    # Kernel 3's schedule at its edges (TILED_EDGE), untimed.
    for b, n in TILED_EDGE:
        pos, _, m = eval_states(b, n)
        pos = torch.as_tensor(pos if b > 1 else pos[0], device=dev)
        r, k, threads, tile = ops.tiled_schedule(b, n, sm_count)
        held("pairwise_tiled", ops.accelerations_tiled,
             ops.accelerations_tiled_reference, pos,
             torch.as_tensor(m, device=dev),
             f"B={b} N={n} (r {r}, k {k}, {threads} threads, tiles of "
             f"{tile})", b * n * n, FLOPS_PER_ORDERED_PAIR, False)

    # Kernel 5, the moment form, which no entry point dispatches: held
    # against its plain version at the JAX test's tolerance on an offset
    # cloud (tests/test_ops.py:170-178) and at N=2,085, where it is also
    # timed.  At N=10,000, where it is timed too, it is held against a
    # float64 direct sum at the same tolerance, and its close-pair error,
    # per particle, against its plain version, kernel 6 and the float64 sum
    # is reported.
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is enabled: kernel 5's plain version needs float32 products")

    def mxu_f64_gate(pos, m, label):
        # Kernel 5 against the float64 direct sum at the JAX test's
        # tolerance: finite, one count a call, reruns bit-identical.
        before = ops.accelerations_symmetric_mxu.launches
        got = ops.accelerations_symmetric_mxu(pos, m)
        torch.cuda.synchronize()
        check(ops.accelerations_symmetric_mxu.launches == before + 1,
              "pairwise_symmetric_mxu did not count its launch")
        check(bool(torch.isfinite(got).all()),
              f"kernel 5 gave non-finite forces at {label}")
        f64 = direct_f64(pos, m)
        tol = (MXU_ATOL_OF_SCALE * f64.abs().max().item()
               + FORCE_RTOL * f64.abs())
        share = ((got.double() - f64).abs() / tol).max().item()
        plain = ops.accelerations_symmetric_mxu_reference(pos, m)
        plain_share = ((plain.double() - f64).abs() / tol).max().item()
        same = torch.equal(got, ops.accelerations_symmetric_mxu(pos, m))
        print(f"  {label}: kernel 5 vs the float64 direct sum at rtol "
              f"{FORCE_RTOL:g}, atol {MXU_ATOL_OF_SCALE:g} of scale: largest "
              f"difference {share:.3f} of the tolerance -> "
              f"{'ok' if share <= 1 else 'MISMATCH'}; rerun bit-identical: "
              f"{same}; its float32 plain version's own difference "
              f"{plain_share:.3f} (reported)", flush=True)
        check(share <= 1, f"kernel 5 disagrees with the float64 direct sum at "
              f"{label}")
        check(same, "pairwise_symmetric_mxu reruns are not bit-identical")
        return got, f64, plain

    for n in MXU_EDGE_N:
        pos, _, m = protocol_system(n, dev)
        tile, warps = ops.mma_schedule(n, sm_count)
        label = f"N={n} (tiles of {tile}, {warps} warps a pair)"
        if n >= MXU_F64_MIN_N:
            mxu_f64_gate(pos, m, label)
            continue
        held("pairwise_symmetric_mxu", ops.accelerations_symmetric_mxu,
             ops.accelerations_symmetric_mxu_reference, pos, m, label,
             n * (n - 1) // 2, FLOPS_PER_UNORDERED_PAIR, False,
             MXU_ATOL_OF_SCALE)
    for n, offset in ((700, 300.0), (ODD_N, 0.0), (LARGE_N, 0.0)):
        pos, _, m = protocol_system(n, dev)
        pos = pos + offset
        label = f"N={n}" + (f", offset by {offset:g}" if offset else "")
        if n != LARGE_N:
            held("pairwise_symmetric_mxu", ops.accelerations_symmetric_mxu,
                 ops.accelerations_symmetric_mxu_reference, pos, m, label,
                 n * (n - 1) // 2, FLOPS_PER_UNORDERED_PAIR, n == ODD_N,
                 MXU_ATOL_OF_SCALE)
            continue
        got, f64, plain = mxu_f64_gate(pos, m, label)
        k6 = ops.accelerations_symmetric(pos, m)
        for a, b, what in ((got, plain, "kernel 5 vs its plain version"),
                           (got, k6, "kernel 5 vs kernel 6"),
                           (got, f64, "kernel 5 vs the float64 direct sum"),
                           (plain, f64, "kernel 5's plain version vs float64"),
                           (k6, f64, "kernel 6 vs float64")):
            rel = (a.double() - b).norm(dim=1) / b.double().norm(dim=1)
            print(f"  {label}, {what}, per particle: median relative "
                  f"difference {rel.median().item():.3e}, largest "
                  f"{rel.max().item():.3e} (reported)", flush=True)
        # The time includes the centring (the kernel's first launch), part
        # of the function as a caller runs it.
        ms = cuda_time_ms(lambda: ops.accelerations_symmetric_mxu(pos, m))
        plain_ms = cuda_time_ms(
            lambda: ops.accelerations_symmetric_mxu_reference(pos, m), 3, 2, 1)
        n_pairs = n * (n - 1) // 2
        bound = force_bound_ms(n_pairs, FLOPS_PER_UNORDERED_PAIR, n)
        rows.append({"kernel": "pairwise_symmetric_mxu", "shape": f"N={n}",
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
                     "bound_by": bound[1], "pairs": n_pairs,
                     "gpairs_per_s": n_pairs / ms / 1e6})
        print(f"    kernel with its centring {ms:.5f} ms "
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


def datagen_cli(host, d: dict, device: str, out_dir: Path,
                fmt: str = "npz") -> None:
    """``python -m nbody_gnn_hpc_torch.generate_data`` at the shape ``d``
    with trajectory files of form ``fmt`` (``"h5"`` needs h5py): its files
    must hold what ``simulate_ensemble`` gave for the same seeds
    (``host``), a rerun must resume every file, and the manifest must
    record the form and load as datasets.  The files are removed after.
    One batch of all the sims, as ``host`` was made: kernel 4's schedule
    depends on the batch, so batches of another size sum in another
    order."""
    from nbody_gnn_hpc_torch import generate_data, ops
    from nbody_gnn_hpc_torch.io import CheckpointManager
    from nbody_gnn_hpc_torch.train import datasets_from_manifest
    from nbody_gnn_hpc_torch.train.dataset import MANIFEST_NAME

    shutil.rmtree(out_dir, ignore_errors=True)
    argv = ["--particles", str(d["n"]), "--simulations", str(d["n_sims"]),
            "--steps", str(d["n_steps"]), "--box-size", str(d["box"]),
            "--seed", str(d["seed"]), "--batch-size", str(d["n_sims"]),
            "--compression", "lzf", "--no-windows", "--device", device,
            "--trajectory-format", fmt, "--output-dir", str(out_dir)]
    before = ops.accelerations_small.launches
    t0 = time.perf_counter()
    check(generate_data.main(argv) == 0, "generate_data failed")
    wall = time.perf_counter() - t0
    ran = ops.accelerations_small.launches - before
    check(device == "cpu" or ran == d["n_steps"] + 1,
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
    check(sorted(manager.trajectory_names())
          == [f"sim_{i:04d}" for i in range(d["n_sims"])]
          and len(list((out_dir / "checkpoints").glob(
              f"*_trajectory.{fmt}"))) == d["n_sims"],
          f"generate_data did not write {d['n_sims']} .{fmt} trajectories")
    with open(out_dir / MANIFEST_NAME) as f:
        check(json.load(f).get("trajectory_format") == fmt,
              f"the manifest does not record the {fmt} store")
    train, val = datasets_from_manifest(out_dir / MANIFEST_NAME,
                                        k_neighbors=K, cache=False)
    n_train = int(0.8 * d["n_sims"])
    per_sim = d["n_steps"] + 1 - 5
    check(train.n_samples == n_train * per_sim
          and val.n_samples == (d["n_sims"] - n_train) * per_sim
          and np.isfinite(train.targets).all(),
          "the manifest's datasets have the wrong size")
    size = sum(p.stat().st_size
               for p in (out_dir / "checkpoints").iterdir()) / 2 ** 30
    shutil.rmtree(out_dir, ignore_errors=True)
    print(f"  generate_data --no-windows --trajectory-format {fmt} on "
          f"{device}: {d['n_sims']} sims x {d['n_steps']} steps in "
          f"{wall:.2f} s (simulate, read back, write {size:.2f} GiB) = "
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
    print(f"  datagen -> GNNDataset.from_trajectories in memory "
          f"({train.n_samples} + {val.n_samples} samples)", flush=True)
    datagen_cli(host, d, str(dev), SIM_DIR / "data", "npz")
    try:
        import h5py  # noqa: F401
    except ImportError:
        print("  h5py is not importable here: the generate_data command "
              "wrote the npz store only, no HDF5 file", flush=True)
    else:
        datagen_cli(host, d, str(dev), SIM_DIR / "data", "h5")

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
        except (Exception, SystemExit) as e:  # noqa: BLE001 - reported below
            errors[i] = e  # SystemExit: a check failed in the thread

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
    # A bf16 file holds ml_dtypes.bfloat16 arrays: written and read back
    # where ml_dtypes imports.
    try:
        import ml_dtypes  # noqa: F401
    except ImportError:
        print("  ml_dtypes is not importable here: the bf16 checkpoint file "
              "is verified on the CPU only (tests/test_torch_quantize.py)",
              flush=True)
    else:
        info = quantize_checkpoint(MODEL, str(SERVE_DIR / "model.bf16.pt"),
                                   "bf16")
        from_file = build_service(str(SERVE_DIR / "model.bf16.pt"),
                                  config_full)
        out = from_file.rollout(pos[0], vel[0], masses, 5)["positions"]
        same = np.array_equal(out, quant5["bf16"])
        print(f"  bf16 checkpoint: {info['src_bytes']:,} -> "
              f"{info['dst_bytes']:,} bytes ({info['ratio']}x); reloaded, "
              f"quantization {from_file.model_info['quantization']}; 5 steps "
              f"equal to the in-memory bf16 service: {same}", flush=True)
        check(from_file.model_info["quantization"] == "bf16" and same,
              "the reloaded bf16 checkpoint serves something else")

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
    model = model_from_config(cfg, dtype_override="float32").to(dev)
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
    scores = score_checkpoints(model_from_config(cfg["model_config"],
                                                 dtype_override="float32"),
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
        model_from_config(cfg["model_config"], dtype_override="float32"),
        [BASE_MODEL, MODEL, str(out)],
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


def stage_launches(output: str) -> dict:
    """The kernel launches a stage's process printed last
    (``ops.launch_line``): its counts started at 0 with the process."""
    from nbody_gnn_hpc_torch.ops import read_launch_line

    try:
        return read_launch_line(output)
    except ValueError as e:
        fail(f"a stage's kernel launches: {e}")


def phase_pipeline() -> dict:
    """The one-command pipeline, the seventh main path: ``run_pipeline``
    with ``PIPELINE_FLAGS`` in a fresh temporary directory, each stage a
    process; returns the kernel launches of all stages."""
    import contextlib
    import tempfile

    from nbody_gnn_hpc_torch import run_demo
    from nbody_gnn_hpc_torch.config import TrainingConfig
    from nbody_gnn_hpc_torch.finetune_rollout import parse_curriculum
    from nbody_gnn_hpc_torch.io import CheckpointManager, load_checkpoint

    cfg = TrainingConfig()
    args = run_demo.resolve_mode(run_demo.build_parser().parse_args(
        list(PIPELINE_FLAGS)))
    stages = run_demo.with_values(run_demo.PIPELINE, PIPELINE_CUTS)
    root = Path(tempfile.mkdtemp(prefix="chip_smoke_pipeline_"))
    PIPELINE_LOG.parent.mkdir(parents=True, exist_ok=True)
    print(f"  run_demo {' '.join(PIPELINE_FLAGS)} in {root}, the fine-tune "
          f"curriculum cut to {CUT_CURRICULUM}; the stages' output in "
          f"{PIPELINE_LOG}", flush=True)
    try:
        t0 = time.perf_counter()
        with open(PIPELINE_LOG, "w") as log, contextlib.redirect_stdout(log):
            try:
                records = run_demo.run_pipeline(args, cfg, root, stages)
            except SystemExit:
                records = None
        total = time.perf_counter() - t0
        if records is None:
            print("".join(PIPELINE_LOG.read_text().splitlines(True)[-80:]),
                  flush=True)
            fail("a pipeline stage failed (the end of its log is above)")
        ran = [r for r in records if "skipped" not in r]
        check([r["title"] for r in ran] == [s.title for s in stages],
              f"the pipeline ran {[r['title'] for r in ran]}")
        device_stages = ran[:5]  # all but the CSV export, which reads files
        for r in device_stages:
            check(re.search(r"Device:\s+cuda\b", r["output"]) is not None,
                  f"{r['title']} did not run on cuda")
        by_stage = {r["argv"][0]: stage_launches(r["output"])
                    for r in device_stages}

        # The artifacts.
        data, models, results = (root / d for d in ("data", "models",
                                                    "results"))
        with open(data / "dataset_manifest.json") as f:
            check(json.load(f).get("trajectory_format") == "npz",
                  "the manifest does not record the npz store")
        check(len(list((data / "checkpoints").glob("sim_*_trajectory.npz")))
              == cfg.simulations
              and CheckpointManager(str(data / "checkpoints"))
              .trajectory_names()[-1] == f"sim_{cfg.simulations - 1:04d}",
              f"datagen did not write {cfg.simulations} npz trajectories")
        for name in ("best_model.pt", "final_model.pt", "selected_model.pt",
                     "checkpoint_selection.json", "best_rollout_model.pt",
                     "config.json", "training_history.json"):
            check((models / name).exists(), f"models/{name} is missing")
        tables = sorted(p.name for p in (results / "csv").glob("*.csv"))
        check(tables == ["metrics_per_simulation.csv", "metrics_summary.csv",
                         "sample_trajectory.csv", "simulation_info.csv",
                         "training_history.csv"],
              f"results/csv holds {tables}")
        with open(results / "evaluation_results.json") as f:
            evaluation = json.load(f)
        rmse = [evaluation["average_metrics"][k]
                for k in ("position_rmse", "velocity_rmse")]
        check(evaluation["ground_truth"] == "float64_host"
              and evaluation["n_test_simulations"] == cfg.n_test_sims
              and bool(np.isfinite(rmse).all()),
              f"the evaluation is not finite or not the protocol: {rmse}")
        with open(models / "config.json") as f:
            check(json.load(f)["model_config"]["dtype"] == "bfloat16",
                  "the pipeline's train_model did not train in bf16")
        ft = load_checkpoint(models / "best_rollout_model.pt")["finetune"]
        check([tuple(r) for r in ft["curriculum"]]
              == parse_curriculum(CUT_CURRICULUM)
              and ft["base"] == "./models/selected_model.pt",
              f"best_rollout_model.pt records {ft['curriculum']} from "
              f"{ft['base']}")
        with open(models / "checkpoint_selection.json") as f:
            selection = json.load(f)

        # Each stage's kernel launches, counted in its own process.
        n_saves, per_sim = cfg.steps + 1, cfg.steps + 1 - cfg.sequence_length
        n_train = int(0.8 * cfg.simulations)
        val = (cfg.simulations - n_train) * per_sim
        steps = min(2400, n_train * per_sim) // cfg.batch_size
        ft_fwd, ft_bwd = curriculum_launches(CUT_CURRICULUM, 100)
        want = {
            "generate_data": {"pairwise_small":
                              -(-cfg.simulations // 100) * n_saves},
            # train_model trains in bf16 on the card (its default).
            "train_model": {"fused_edge_fwd_bf16":
                            6 * (steps + -(-val // cfg.batch_size)),
                            "fused_edge_bwd_bf16": 6 * steps},
            "select_checkpoint": {"fused_edge_fwd": 6 * selection["horizon"]
                                  * len(selection["scores"])},
            "finetune_rollout": {"fused_edge_fwd": ft_fwd,
                                 "fused_edge_bwd": ft_bwd},
            "evaluate": {"fused_edge_fwd": 6 * (cfg.steps - 6)}}
        for command, counts in by_stage.items():
            got = {k: v for k, v in counts.items() if v}
            check(got == want[command],
                  f"{command} launched {got}, expected {want[command]}")
        launches = {k: sum(c[k] for c in by_stage.values())
                    for k in next(iter(by_stage.values()))}
        summary = {
            "stages": [{"title": r["title"], "returncode": r["returncode"],
                        "seconds": r["seconds"]} for r in ran],
            "total_s": total, "position_rmse": rmse[0],
            "velocity_rmse": rmse[1],
            "selection": {Path(x["path"]).name: x["position_rmse"]
                          for x in selection["scores"]},
            "cuts": {"epochs": 1, "max_samples": 2400,
                     "curriculum": CUT_CURRICULUM,
                     "production_curriculum": FULL_CURRICULUM},
            "launches": {k: v for k, v in launches.items() if v}}
        for r in ran:
            counts = by_stage.get(r["argv"][0], {})
            print(f"  {r['title']}: exit {r['returncode']} in "
                  f"{r['seconds']:.1f} s, kernel launches "
                  f"{ {k: v for k, v in counts.items() if v} }", flush=True)
        print(f"  the pipeline took {total:.1f} s; evaluation of "
              f"best_rollout_model.pt (one bf16 epoch, cut fine-tune) "
              f"against the f64 oracle: position RMSE {rmse[0]:.4f}, "
              f"velocity RMSE {rmse[1]:.4f} (band < {EVAL_POS_RMSE_MAX:g} / "
              f"< {EVAL_VEL_RMSE_MAX:g})", flush=True)
        print(json.dumps({"pipeline": summary}), flush=True)
        check(rmse[0] < EVAL_POS_RMSE_MAX and rmse[1] < EVAL_VEL_RMSE_MAX,
              "the pipeline's evaluation RMSE is outside the band")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


# Phase 12: data parallel and the simulator surface.  Two gloo ranks share
# the one card (NCCL refuses two ranks on one GPU); world one runs NCCL.
DP_VAL_SIMS, DP_STEPS, DP_SIM_STEPS = 2, 20, 40  # 20 steps of B=24
DP_REL = 1e-6      # world one against one device, of each tensor's scale
# Two ranks: each launch sums over its own 12 graphs, in another order than
# one device's 24.  Held to one device taking the same two halves (within
# DP_REL: the same arithmetic), and to one device's whole batch at float32
# sum order: the loss, the first step's clipped gradients to 1e-4 of each
# tensor's scale, and the parameters after the first step element by
# element at rtol 1e-4 / atol 1e-6, as certify_multichip (and the JAX
# certification) hold one step.  After the second step the same measure
# is printed, not held: AdamW's m / sqrt(v) turns a small gradient's
# relative sum-order difference into a difference of its update (1.25 of
# that limit on a weight, measured on an H100).
DP2_LOSS_RTOL, DP2_GRAD_REL = 1e-5, 1e-4
DP2_PARAM_RTOL, DP2_PARAM_ATOL = 1e-4, 1e-6
DP_ENSEMBLE = dict(n_sims=300, n=200, n_steps=50)  # world one, sharded
# Two ranks, 301 sims (one padded): the JAX certification's systems (N=8,
# box 5) held to its tolerance, and the datagen protocol's (N=200, box 10)
# held bit for bit to one device taking the same two blocks and per
# particle to one device's whole batch: kernel 4 sums in an order set by
# its batch, and at N=200 close pairs amplify that order over 4 steps
# (max abs 2.98e-5 measured on an H100, past the certification's atol).
DP2_ENSEMBLES = {"certification": dict(n_sims=301, n=8, n_steps=4, box=5.0),
                 "datagen": dict(n_sims=301, n=200, n_steps=4, box=10.0)}
DP2_RTOL, DP2_ATOL = 2e-5, 1e-5
GALAXY_PER, GALAXY_STEPS, GALAXY_FRAMES = 1_100, 50, 5  # N=2,200 > 2,048
# Softening 1e-9 at dt 0.01 leaves the scene's close encounters unresolved:
# its energy grows several times over in 50 steps in every run (float32 and
# float64 alike).  The card's end energy is held to the float64 oracle's
# order, the trajectories being chaotic past the first frames.
GALAXY_ENERGY_BAND = (0.25, 4.0)
SURFACE_SIMS, SURFACE_STEPS = 8, 50  # run_parallel_simulations' group
SURROGATE_STEPS = 5  # the GNN at N=2,085 (ODD_N), fused and fused_full
DP2_TIMEOUT_S = 300
DP_WIDTH = dict(hidden_dim=256, n_layers=6)  # TrainingConfig()'s
# The two-rank DP steps: name -> (edge_impl, dtype).  bf16 is held to one
# device taking the same halves only: its bf16 Dense rounds each half's
# weight gradient to bf16 (as the JAX model does), and AdamW's first step
# turns such a rounding into the sign of an update.
DP_VARIANTS = {"fused": ("fused", "float32"),
               "fused_full": ("fused_full", "float32"),
               "fused bf16": ("fused", "bfloat16")}


def _sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _counts() -> dict:
    from nbody_gnn_hpc_torch.ops import launch_counts

    return launch_counts()


def _zero_counts() -> None:
    from nbody_gnn_hpc_torch import ops

    for fn in (ops.fused_edge_layer, ops.fused_edge_backward,
               ops.accelerations_tiled, ops.accelerations_small,
               ops.accelerations_symmetric, ops.fused_full_layer,
               ops.accelerations_symmetric_mxu, ops.fma_probe,
               ops.rsqrt_probe, ops.receiver_sum):
        fn.launches = 0
    ops.fused_edge_layer.bf16_launches = 0
    ops.fused_edge_backward.bf16_launches = 0
    ops.fused_full_layer.bf16_launches = 0


def _add(total: dict, more: dict) -> dict:
    return {k: total.get(k, 0) + more.get(k, 0)
            for k in set(total) | set(more)}


def _rel_err(got, want) -> float:
    """Largest |got - want| over tensors, relative to each tensor's scale."""
    return max(_rel_errs(got, want).values())


def _rel_errs(got, want) -> dict:
    """|got - want| / scale of each tensor of two ``{name: tensor}``
    dicts (or two lists)."""
    if not isinstance(want, dict):
        got, want = dict(enumerate(got)), dict(enumerate(want))
    return {k: float((got[k].float() - w.float()).abs().max())
            / (float(w.float().abs().max()) + 1e-12)
            for k, w in want.items()}


def _allclose_ratio(got: dict, want: dict, rtol: float, atol: float):
    """The largest |got - want| / (atol + rtol |want|) over the elements of
    two ``{name: tensor}`` dicts, and its tensor's name: at most 1 where
    ``np.allclose(got, want, rtol, atol)`` holds for every tensor."""
    ratios = {k: float(((got[k].double() - w.double()).abs()
                        / (atol + rtol * w.double().abs())).max())
              for k, w in want.items()}
    worst = max(ratios, key=ratios.get)
    return ratios[worst], worst


def dp_data(dev):
    """Train (cut to DP_STEPS batches of 24) and validation (DP_VAL_SIMS)
    datasets from trajectories made on the card (the datagen protocol,
    DP_SIM_STEPS steps), and the problem the DP steps take, as numpy."""
    from nbody_gnn_hpc_torch.config import TrainingConfig
    from nbody_gnn_hpc_torch.parallel import (fetch_host_trajectory,
                                              simulate_ensemble)
    from nbody_gnn_hpc_torch.sim import shared_masses
    from nbody_gnn_hpc_torch.train import GNNDataset

    cfg = TrainingConfig()
    n = DP_STEPS * cfg.batch_size  # samples; cut as train_model --max-samples
    n_train = -(-n // (DP_SIM_STEPS + 1 - cfg.sequence_length))
    n_sims = n_train + DP_VAL_SIMS
    host = fetch_host_trajectory(simulate_ensemble(
        list(range(42, 42 + n_sims)), N, DP_SIM_STEPS, box_size=10.0,
        dt=0.001,
        shared_masses=shared_masses(N), device=dev))
    trajs = [dict(positions=host.positions[i], velocities=host.velocities[i],
                  masses=host.masses[i]) for i in range(n_sims)]
    kw = dict(sequence_length=cfg.sequence_length, k_neighbors=K)
    train = GNNDataset.from_trajectories(trajs[:n_train], **kw)
    train.last_states, train.targets = (train.last_states[:n],
                                        train.targets[:n])
    train.n_samples = n
    val = GNNDataset.from_trajectories(
        trajs[n_train:],
        external_norm_stats=train.get_normalization_stats(), **kw)
    b = cfg.batch_size
    problem = dict(edge_index=train.edge_index,
                   masses=train.get_masses_tensor(), mean=train.state_mean,
                   std=train.state_std, width=DP_WIDTH,
                   states=train.last_states[:2 * b].reshape(2, b, N, 6),
                   targets=train.targets[:2 * b].reshape(2, b, N, 6))
    return cfg, train, val, problem


def _split_step(base, parts: int):
    """A train step as ``parts`` ``gspmd`` ranks take it, in one process:
    each part's loss and gradient drawn from the generator state the step
    starts with, divided by ``parts`` and added in rank order (what the
    ranks' all-reduce adds), then the update."""
    import torch

    from nbody_gnn_hpc_torch.models.gnn import BatchRows

    def step(states, targets, gen):
        b = states.shape[0]
        per = b // parts
        start = gen.get_state()
        flat = None
        for r in range(parts):
            gen.set_state(start)
            for p in base.params:
                p.grad = None
            lo = r * per
            loss, _ = base.compute_loss(states[lo:lo + per],
                                        targets[lo:lo + per], gen,
                                        rows=BatchRows(lo, b))
            loss.backward()
            part = torch.cat([p.grad.reshape(-1) for p in base.params]
                             + [loss.detach().reshape(1)]) / parts
            flat = part if flat is None else flat + part
        offset = 0
        for p in base.params:
            p.grad = flat[offset:offset + p.numel()].view_as(p)
            offset += p.numel()
        base.update()
        return flat[-1].clone()

    return step


def dp_steps(dev, problem, edge_impl, mesh, split: int = 0,
             dtype: str = "float32"):
    """Two train steps at the production width (hidden 256, 6 layers,
    dropout 0.1, noise 0.003) on ``problem``'s batches from a seeded model
    computing in ``dtype``, through ``make_train_step``'s ``compute_loss``
    and ``update`` (``mesh`` None: the eager step the DP step shares), the
    ``gspmd`` DP step, or (``split`` > 0) ``split`` ranks' arithmetic in
    this one process:
    (losses, parameters on the host, synchronised step walls, the first
    step's clipped gradients and the parameters after it on the host)."""
    import torch

    from nbody_gnn_hpc_torch.models import NBodyGNN
    from nbody_gnn_hpc_torch.parallel import make_dp_train_step
    from nbody_gnn_hpc_torch.train import make_optimizer, make_train_step

    model = NBodyGNN(**problem["width"], dropout=DROPOUT_P,
                     edge_impl=edge_impl, dtype=dtype,
                     generator=torch.Generator().manual_seed(11)).to(dev)
    m = torch.as_tensor(problem["masses"], device=dev)
    args = (model, make_optimizer(model, 5e-4, 1e-4), problem["edge_index"],
            problem["mean"], problem["std"], (m / m.mean())[:, None])
    kw = dict(noise_std=0.003, masses=m)
    if mesh is not None:
        step = make_dp_train_step(*args, mesh=mesh, **kw)
    else:
        step = _split_step(make_train_step(*args, **kw), split or 1)
    gen = torch.Generator(dev).manual_seed(12)
    losses, walls, grads, first = [], [], None, None
    for s, t in zip(problem["states"], problem["targets"]):
        s = torch.as_tensor(s, device=dev)
        t = torch.as_tensor(t, device=dev)
        _sync(dev)
        t0 = time.perf_counter()
        losses.append(step(s, t, gen).item())
        walls.append(time.perf_counter() - t0)
        if grads is None:
            grads = {k: p.grad.detach().cpu()
                     for k, p in model.named_parameters()}
            first = {k: p.detach().cpu() for k, p in
                     model.named_parameters()}
    return losses, {k: p.detach().cpu() for k, p in
                    model.named_parameters()}, walls, grads, first


def _ensemble_positions(dev, ens, seeds, mesh=None):
    from nbody_gnn_hpc_torch.parallel import simulate_ensemble
    from nbody_gnn_hpc_torch.sim import shared_masses

    return simulate_ensemble(seeds, ens["n"], ens["n_steps"],
                             box_size=ens["box"], dt=0.001,
                             shared_masses=shared_masses(ens["n"]),
                             mesh=mesh, device=dev).positions.cpu()


def _dp_rank(rank, dev, problem, variants, ensembles):
    """One of two gloo ranks on the shared card: the DP steps of each
    variant (DP_VARIANTS) and the sharded ensembles, each with its own
    launch counts."""
    from nbody_gnn_hpc_torch.parallel import make_mesh

    mesh = make_mesh()
    out = {}
    for key in variants:
        edge_impl, dtype = DP_VARIANTS[key]
        _zero_counts()
        out[key] = dp_steps(dev, problem, edge_impl, mesh, dtype=dtype) + (
            _counts(),)
    for name, ens in ensembles.items():
        _zero_counts()
        _sync(dev)
        t0 = time.perf_counter()
        seeds = list(range(42, 42 + ens["n_sims"]))
        pos = _ensemble_positions(dev, ens, seeds, mesh)
        out[name] = (pos if rank == 0 else None, time.perf_counter() - t0,
                     _counts())
    return out


def phase_parallel(dev):
    """Data parallel: NCCL at world one, two gloo ranks sharing the card,
    and the sharded ensemble.  Returns the launches of this path (both
    ranks' processes included)."""
    import torch
    import torch.distributed as dist

    from nbody_gnn_hpc_torch.models import NBodyGNN
    from nbody_gnn_hpc_torch.parallel import (init_data_parallel, make_mesh,
                                              run_local_world,
                                              simulate_ensemble)
    from nbody_gnn_hpc_torch.sim import shared_masses
    from nbody_gnn_hpc_torch.train import Trainer

    cfg, train, val, problem = dp_data(dev)
    launches = {}
    created = not dist.is_initialized()
    rank_dev = init_data_parallel(dev)
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          "world one is not one NCCL rank")
    try:
        mesh = make_mesh()
        # (a) the gspmd step at world one against make_train_step
        want = dp_steps(rank_dev, problem, "fused", None)
        _zero_counts()
        got = dp_steps(rank_dev, problem, "fused", mesh)
        c = _counts()
        launches = _add(launches, c)
        rel = _rel_err(got[1], want[1])
        bit = got[0] == want[0] and all(torch.equal(got[1][k], v)
                                        for k, v in want[1].items())
        print(f"  world one (NCCL): gspmd DP step vs make_train_step, 2 "
              f"steps at B={len(problem['states'][0])}, {DP_WIDTH}, "
              f"dropout + noise: "
              f"losses {got[0]} vs {want[0]}; parameters max error / scale "
              f"{rel:.3e} (tolerance {DP_REL:g}); bit-equal: {bit}; step "
              f"walls {['%.2f ms' % (w * 1e3) for w in got[2]]} vs "
              f"{['%.2f ms' % (w * 1e3) for w in want[2]]}; launches "
              f"fused_edge_fwd {c['fused_edge_fwd']}, fused_edge_bwd "
              f"{c['fused_edge_bwd']} (expected 12 each)", flush=True)
        check(all(abs(a - b) <= DP_REL * abs(b) for a, b in
                  zip(got[0], want[0])) and rel <= DP_REL,
              "the DP step at world one disagrees with make_train_step")
        check((c["fused_edge_fwd"], c["fused_edge_bwd"]) == (12, 12),
              "DP step launch counts at world one")
        # ... and a bf16 model through the same step.
        want = dp_steps(rank_dev, problem, "fused", None, dtype="bfloat16")
        _zero_counts()
        got = dp_steps(rank_dev, problem, "fused", mesh, dtype="bfloat16")
        c = _counts()
        launches = _add(launches, c)
        rel = _rel_err(got[1], want[1])
        print(f"  world one (NCCL), bf16 model: gspmd DP step vs "
              f"make_train_step: losses {got[0]} vs {want[0]}; parameters "
              f"max error / scale {rel:.3e} (tolerance {DP_REL:g}); "
              f"parameters and gradients float32: "
              f"{all(p.dtype == torch.float32 for p in got[1].values())}, "
              f"{all(g.dtype == torch.float32 for g in got[3].values())}; "
              f"launches fused_edge_fwd_bf16 {c['fused_edge_fwd_bf16']}, "
              f"fused_edge_bwd_bf16 {c['fused_edge_bwd_bf16']} (expected 12 "
              f"each)", flush=True)
        check(all(abs(a - b) <= DP_REL * abs(b) for a, b in
                  zip(got[0], want[0])) and rel <= DP_REL,
              "the bf16 DP step at world one disagrees with make_train_step")
        check(all(t.dtype == torch.float32 for t in
                  list(got[1].values()) + list(got[3].values())),
              "the bf16 DP step's parameters or gradients are not float32")
        check((c["fused_edge_fwd_bf16"], c["fused_edge_bwd_bf16"],
               c["fused_edge_fwd"], c["fused_edge_bwd"]) == (12, 12, 0, 0),
              "bf16 DP step launch counts at world one")

        # (b) Trainer(mesh=) for an epoch of 20 steps and a validation
        def trainer(m):
            return Trainer(
                NBodyGNN(**DP_WIDTH, dropout=cfg.dropout), train, val,
                model_dir=str(TRAIN_DIR / f"dp_{m is not None}"),
                device=rank_dev, learning_rate=cfg.learning_rate,
                batch_size=cfg.batch_size, weight_decay=cfg.weight_decay,
                noise_std=cfg.noise_std, seed=7, mesh=m)

        results = []
        for m in (None, mesh):
            t = trainer(m)
            val_batches = -(-val.n_samples // cfg.batch_size)
            _zero_counts()
            _sync(rank_dev)
            t0 = time.perf_counter()
            t.train_epoch()
            loss_val = t.validate()[0]
            wall = time.perf_counter() - t0
            c = _counts()
            if m is not None:
                launches = _add(launches, c)
                want_fwd = 6 * (t.steps_per_epoch + val_batches)
                check((t.steps_per_epoch, c["fused_edge_fwd"],
                       c["fused_edge_bwd"]) == (DP_STEPS, want_fwd,
                                                6 * DP_STEPS),
                      "Trainer(mesh=) launch counts")
            results.append((t.step_losses, loss_val,
                            [p.detach().cpu() for p in t.model.parameters()],
                            wall, c))
        (l1, v1, p1, w1, _), (lm, vm, pm, wm, cm) = results
        rel = _rel_err(pm, p1)
        bit = lm == l1 and vm == v1 and all(torch.equal(a, b)
                                            for a, b in zip(pm, p1))
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(lm + [vm],
                                                            l1 + [v1]))
        print(f"  world one: Trainer(mesh=make_mesh()) vs Trainer(mesh=None), "
              f"{DP_STEPS} steps + validation: step losses max relative "
              f"difference {loss_rel:.3e}, validation {vm:.6f} vs {v1:.6f}, "
              f"parameters max error / scale {rel:.3e} (tolerance "
              f"{DP_REL:g}); bit-equal: {bit}; "
              f"epoch + validation wall {wm:.3f} s vs {w1:.3f} s; launches "
              f"fused_edge_fwd {cm['fused_edge_fwd']}, fused_edge_bwd "
              f"{cm['fused_edge_bwd']}", flush=True)
        check(loss_rel <= DP_REL and rel <= DP_REL,
              "Trainer(mesh=) disagrees with Trainer(mesh=None)")

        # (c) the sharded ensemble at world one
        e = DP_ENSEMBLE
        kw = dict(box_size=10.0, dt=0.001, shared_masses=shared_masses(e["n"]),
                  device=rank_dev)
        seeds = list(range(42, 42 + e["n_sims"]))
        walls = {}
        for label, m in (("unsharded", None), ("mesh", mesh)):
            _zero_counts()
            _sync(rank_dev)
            t0 = time.perf_counter()
            traj = simulate_ensemble(seeds, e["n"], e["n_steps"], mesh=m, **kw)
            _sync(rank_dev)
            walls[label] = time.perf_counter() - t0
            if m is not None:
                c = _counts()
                launches = _add(launches, c)
                check(c["pairwise_small"] == e["n_steps"] + 1,
                      "sharded ensemble launch count at world one")
                sharded = traj.positions
            else:
                alone = traj.positions
        equal = torch.equal(sharded, alone)
        print(f"  world one: simulate_ensemble(mesh=) {e['n_sims']} x "
              f"{e['n_steps']} x N={e['n']}: bit-equal to the unsharded run: "
              f"{equal}; {walls['mesh']:.3f} s vs {walls['unsharded']:.3f} s "
              f"unsharded; pairwise_small {e['n_steps'] + 1}", flush=True)
        check(equal, "simulate_ensemble(mesh=) at world one differs from "
                     "the unsharded run")
    finally:
        if created:
            dist.destroy_process_group()

    # (d) two gloo ranks sharing cuda:0 (spawned processes)
    t0 = time.perf_counter()
    ranks = run_local_world(_dp_rank, 2, (problem, tuple(DP_VARIANTS),
                                          DP2_ENSEMBLES),
                            device="cuda", backend="gloo",
                            timeout=DP2_TIMEOUT_S)
    spawn_wall = time.perf_counter() - t0
    for key, (edge_impl, dtype) in DP_VARIANTS.items():
        bf16 = dtype == "bfloat16"
        want = dp_steps(dev, problem, edge_impl, None, dtype=dtype)
        split = dp_steps(dev, problem, edge_impl, None, split=2, dtype=dtype)
        counted = "fused_full_fwd" if edge_impl == "fused_full" else \
            "fused_edge_fwd"
        bwd = "fused_edge_bwd"
        if bf16:
            counted, bwd = counted + "_bf16", bwd + "_bf16"
        for r, out in enumerate(ranks):
            losses, params, walls, grads, first, c = out[key]
            launches = _add(launches, c)
            # The two ranks against one device doing the same two halves.
            same = _rel_errs({**params, **{f"d {k}": g for k, g in
                                           grads.items()}},
                             {**split[1], **{f"d {k}": g for k, g in
                                             split[3].items()}})
            bit = losses == split[0] and max(same.values()) == 0.0
            # ... and against one device's whole batch: float32 order.
            g_errs = _rel_errs(grads, want[3])
            p_errs = _rel_errs(params, want[1])
            g_worst = max(g_errs, key=g_errs.get)
            p_worst = max(p_errs, key=p_errs.get)
            first_ratio, first_at = _allclose_ratio(
                first, want[4], DP2_PARAM_RTOL, DP2_PARAM_ATOL)
            p_ratio, p_ratio_at = _allclose_ratio(
                params, want[1], DP2_PARAM_RTOL, DP2_PARAM_ATOL)
            loss_ok = all(abs(a - b) <= DP2_LOSS_RTOL * abs(b)
                          for a, b in zip(losses, want[0]))
            print(f"  two gloo ranks on cuda:0, rank {r}, {key}: "
                  f"losses {losses}; vs one device taking the same two "
                  f"halves: losses {split[0]}, parameters and first "
                  f"gradients max error / scale {max(same.values()):.3e} "
                  f"(tolerance {DP_REL:g}), bit-equal: {bit}; vs one "
                  f"device's whole batch: losses {want[0]}, first clipped "
                  f"gradients max error / scale {g_errs[g_worst]:.3e} "
                  f"({g_worst}; tolerance {DP2_GRAD_REL:g}), parameters "
                  f"after the first step: largest |difference| / (atol + "
                  f"rtol |want|) {first_ratio:.3e} ({first_at}; rtol "
                  f"{DP2_PARAM_RTOL:g} / atol {DP2_PARAM_ATOL:g}: at most "
                  f"1), after two steps (printed): {p_ratio:.3e} "
                  f"({p_ratio_at}), max error / scale "
                  f"{p_errs[p_worst]:.3e} ({p_worst}, scale "
                  f"{float(want[1][p_worst].abs().max()):.3e}); step walls "
                  f"{['%.2f ms' % (w * 1e3) for w in walls]} (one device "
                  f"{['%.2f ms' % (w * 1e3) for w in want[2]]}); launches "
                  f"{counted} {c[counted]}, {bwd} {c[bwd]} (expected 12 "
                  f"each)" + (" (bf16: the whole batch printed, not held)"
                              if bf16 else ""), flush=True)
            check(max(same.values()) <= DP_REL,
                  f"two-rank {key} DP step disagrees with one device "
                  f"taking the same two halves")
            check(bf16 or (loss_ok and g_errs[g_worst] <= DP2_GRAD_REL
                           and first_ratio <= 1.0),
                  f"two-rank {key} DP step disagrees with one device")
            check((c[counted], c[bwd]) == (12, 12),
                  f"two-rank {key} DP launch counts")
            check(all(t.dtype == torch.float32 for t in
                      list(params.values()) + list(grads.values())),
                  f"two-rank {key}: a parameter or gradient is not float32")
    for name, ens in DP2_ENSEMBLES.items():
        seeds = list(range(42, 42 + ens["n_sims"]))
        per = -(-ens["n_sims"] // 2)
        padded = seeds + seeds[-1:] * (2 * per - ens["n_sims"])
        alone = _ensemble_positions(dev, ens, seeds)
        blocks = torch.cat([_ensemble_positions(dev, ens, padded[:per]),
                            _ensemble_positions(dev, ens, padded[per:])]
                           )[:ens["n_sims"]]
        sharded, wall, _ = ranks[0][name]
        for r, out in enumerate(ranks):
            c = out[name][2]
            launches = _add(launches, c)
            check(c["pairwise_small"] == ens["n_steps"] + 1,
                  f"rank {r}'s sharded {name} ensemble launch count")
        bit = torch.equal(sharded, blocks)
        close = torch.allclose(sharded, alone, rtol=DP2_RTOL, atol=DP2_ATOL)
        med, far, diff = particle_errors(sharded.numpy(), alone.numpy())
        print(f"  two gloo ranks: simulate_ensemble(mesh=) of the {name} "
              f"systems, {ens['n_sims']} x {ens['n_steps']} steps at "
              f"N={ens['n']} ({per} a rank, {2 * per - ens['n_sims']} "
              f"padded), {wall:.3f} s on rank 0: bit-equal to one device "
              f"taking the same two blocks: {bit}; against one device's "
              f"whole batch max abs difference {diff:.3e}, within rtol "
              f"{DP2_RTOL:g} / atol {DP2_ATOL:g}: {close}; per particle "
              f"median {med:.2e}, beyond {SIM_FAR_REL:g} {far:.2%}; "
              f"pairwise_small {ens['n_steps'] + 1} a rank", flush=True)
        check(bit, f"the two-rank {name} ensemble differs from one device "
                   f"taking the same blocks")
        check(close if name == "certification" else
              med <= SIM_MEDIAN_REL and far <= SIM_FAR_SHARE,
              f"the two-rank {name} ensemble disagrees with the unsharded")
    print(f"  the two ranks took {spawn_wall:.1f} s from spawn to join",
          flush=True)
    return launches


def phase_simulator_surface(dev):
    """NBodySimulator across the large-N threshold and
    run_parallel_simulations' grouping.  Returns this path's launches."""
    from nbody_gnn_hpc_torch.sim import (NBodySimulator,
                                         run_parallel_simulations)
    from nbody_gnn_hpc_torch.sim.reference_f64 import (simulate_f64,
                                                       total_energy_f64)

    # The galaxy collision: N=2,200 >= 2,048, so every force evaluation is
    # kernel 6 (the constructor's, the factory's recompute, one a step).
    np.random.seed(2026)
    _zero_counts()
    _sync(dev)
    t0 = time.perf_counter()
    sim = NBodySimulator.create_galaxy_collision(n_per_galaxy=GALAXY_PER,
                                                 device=dev)
    e0 = sim.get_energy()
    _sync(dev)
    t1 = time.perf_counter()
    traj = sim.run_trajectory(GALAXY_STEPS)
    _sync(dev)
    t_run = time.perf_counter() - t1
    e1 = sim.get_energy()
    launches = _counts()
    t_all = time.perf_counter() - t0
    n = 2 * GALAXY_PER
    check(launches["pairwise_symmetric"] == GALAXY_STEPS + 2
          and launches["pairwise_small"] == 0,
          f"the galaxy run launched kernel 6 "
          f"{launches['pairwise_symmetric']} times, expected "
          f"{GALAXY_STEPS} steps + 2")
    np.random.seed(2026)
    ref = NBodySimulator.create_galaxy_collision(n_per_galaxy=GALAXY_PER,
                                                 device="cpu")
    check(np.array_equal(ref.positions, traj.positions[0].cpu().numpy()),
          "the galaxy's initial conditions differ between devices")
    # The float64 oracle from the same scene, on the host: its energy
    # change over the same steps is the reference's for this scene.
    oracle = simulate_f64(ref.positions, ref.velocities, ref.masses, ref.dt,
                          GALAXY_STEPS, ref.softening)
    e_ref = total_energy_f64(oracle.positions[-1], oracle.velocities[-1],
                             ref.masses, ref.softening)[2]
    want = ref.run_trajectory(GALAXY_FRAMES).positions.numpy()
    got = traj.positions[:GALAXY_FRAMES + 1].cpu().numpy()
    med, far, diff = particle_errors(got[1:], want[1:])
    drift = abs(e1[2] - e0[2]) / abs(e0[2])
    ref_drift = abs(e_ref - e0[2]) / abs(e0[2])
    print(f"  NBodySimulator.create_galaxy_collision(n_per_galaxy="
          f"{GALAXY_PER}) (N={n}), {GALAXY_STEPS} steps: run_trajectory "
          f"{t_run * 1e3:.2f} ms, with the scene and two energies "
          f"{t_all * 1e3:.2f} ms; pairwise_symmetric "
          f"{launches['pairwise_symmetric']} (expected {GALAXY_STEPS} + 2); "
          f"total energy {e0[2]:.6e} -> {e1[2]:.6e}, relative change "
          f"{drift:.3e} (the float64 oracle from the same scene: -> "
          f"{e_ref:.6e}, relative change {ref_drift:.3e}; ratio "
          f"{e1[2] / e_ref:.3f}, band {GALAXY_ENERGY_BAND}); frames "
          f"1-{GALAXY_FRAMES} vs device='cpu' per "
          f"particle: median {med:.2e} (limit {SIM_MEDIAN_REL:g}), share "
          f"beyond {SIM_FAR_REL:g} {far:.2%} (limit {SIM_FAR_SHARE:.0%}), "
          f"max abs {diff:.3e}", flush=True)
    check(med <= SIM_MEDIAN_REL and far <= SIM_FAR_SHARE
          and bool(np.isfinite(traj.positions.cpu().numpy()).all()),
          "the galaxy run disagrees with the CPU run")
    lo, hi = GALAXY_ENERGY_BAND
    check(lo <= e1[2] / e_ref <= hi, "the galaxy run's energy after "
          f"{GALAXY_STEPS} steps is not of the float64 oracle's order")

    # run_parallel_simulations: one group of SURFACE_SIMS same-parameter
    # configs (one ensemble through kernel 4) and one other config alone.
    def configs(device):
        dev_kw = {"device": device}
        group = [{"init": {"n_particles": N, "box_size": 10.0, "seed": s,
                           **dev_kw}, "run": {"n_steps": SURFACE_STEPS}}
                 for s in range(42, 42 + SURFACE_SIMS)]
        lone = {"init": {"n_particles": 150, "box_size": 10.0, "seed": 7,
                         **dev_kw}, "run": {"n_steps": 20,
                                            "save_interval": 4}}
        return group[:4] + [lone] + group[4:]

    _zero_counts()
    _sync(dev)
    t0 = time.perf_counter()
    out = run_parallel_simulations(configs(dev))
    wall = time.perf_counter() - t0
    c = _counts()
    launches = _add(launches, c)
    check(c["pairwise_small"] == SURFACE_STEPS + 1
          and c["pairwise_symmetric"] == 0,
          f"run_parallel_simulations launched kernel 4 "
          f"{c['pairwise_small']} times, expected {SURFACE_STEPS} + 1")
    ref = run_parallel_simulations(configs("cpu"))
    worst = 0.0
    for i, (g, w) in enumerate(zip(out, ref)):
        check([s["step"] for s in g] == [s["step"] for s in w],
              f"run_parallel_simulations config {i}: saved steps differ")
        got = np.stack([s["positions"] for s in g[:6]])
        want = np.stack([s["positions"] for s in w[:6]])
        worst = max(worst, close_to(got, want, 1e-3)[0]
                    / float(np.abs(want).max()))
    print(f"  run_parallel_simulations: {SURFACE_SIMS} same-parameter "
          f"configs at N={N} x {SURFACE_STEPS} steps as one ensemble + one "
          f"config alone, in input order, {wall * 1e3:.1f} ms; "
          f"pairwise_small {c['pairwise_small']} (expected "
          f"{SURFACE_STEPS} + 1); frames 0-5 vs device='cpu' max abs "
          f"difference / scale {worst:.3e} (tolerance 1e-3)", flush=True)
    check(len(out) == SURFACE_SIMS + 1 and worst <= 1e-3,
          "run_parallel_simulations disagrees with the CPU run")
    return launches


def phase_surrogate_large_n(dev):
    """The GNN above N = 2,048: a short rollout at N=2,085 through ``fused``
    and ``fused_full`` (the row-blocked k-NN, kernels 1 and 7) against
    ``device="cpu"``, and one training step there (kernels 1 and 2)
    against the plain versions on the card.  Returns its launches."""
    import tempfile

    import torch

    from nbody_gnn_hpc_torch.io import load_checkpoint, load_into
    from nbody_gnn_hpc_torch.models import model_from_config
    from nbody_gnn_hpc_torch.ops import (fused_edge_layer,
                                         fused_edge_layer_plain,
                                         fused_full_layer,
                                         fused_full_layer_plain,
                                         knn_edge_index)
    from nbody_gnn_hpc_torch.serve import build_service
    from nbody_gnn_hpc_torch.train import make_optimizer, make_train_step

    (pos,), (vel,), masses = eval_states(1, ODD_N)
    want = build_service(MODEL, CONFIG, device="cpu").rollout(
        pos, vel, masses, SURROGATE_STEPS)
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        with open(CONFIG) as f:
            cfg = json.load(f)
        cfg["model_config"]["edge_impl"] = "fused_full"
        config_full = str(Path(tmp) / "config.json")
        with open(config_full, "w") as f:
            json.dump(cfg, f)
        for label, config, counted in (("fused", CONFIG, "fused_edge_fwd"),
                                       ("fused_full", config_full,
                                        "fused_full_fwd")):
            service = build_service(MODEL, config, device=dev)
            _zero_counts()
            got = service.rollout(pos, vel, masses, SURROGATE_STEPS)
            c = _counts()
            launches = _add(launches, c)
            worst = []
            for key in ("positions", "velocities"):
                med, far, diff = particle_errors(got[key][1:], want[key][1:])
                worst.append((key, med, far, diff))
                check(np.array_equal(got[key][0], want[key][0])
                      and med <= SIM_MEDIAN_REL and far <= SIM_FAR_SHARE,
                      f"the {label} rollout at N={ODD_N} disagrees with the "
                      f"CPU run ({key})")
            print(f"  surrogate at N={ODD_N}, {SURROGATE_STEPS}-step rollout "
                  f"through {label}: per particle vs device='cpu' "
                  + "; ".join(f"{k} median {m:.2e}, beyond {SIM_FAR_REL:g} "
                              f"{f:.2%}, max abs {d:.3e}"
                              for k, m, f, d in worst)
                  + f"; {counted} {c[counted]} (expected 6 x "
                    f"{SURROGATE_STEPS})", flush=True)
            check(c[counted] == 6 * SURROGATE_STEPS and
                  c["fused_edge_bwd"] == 0,
                  f"the {label} rollout's launch counts at N={ODD_N}")

    # One training step at N=2,085, B=2: kernels against plain versions.
    with open(CONFIG) as f:
        model = model_from_config(json.load(f)["model_config"],
                                  dtype_override="float32").to(dev)
    norm = load_into(model, load_checkpoint(MODEL))
    (p2,), (v2,), _ = eval_states(1, ODD_N)
    states = np.stack([np.concatenate([pos, vel], -1),
                       np.concatenate([p2 + 0.01, v2], -1)]).astype(np.float32)
    ei = knn_edge_index(torch.as_tensor(pos, device=dev), K)
    m = torch.as_tensor(masses, device=dev)
    step = make_train_step(model, make_optimizer(model, 5e-4, 1e-4), ei,
                           norm["state_mean"], norm["state_std"],
                           (m / m.mean())[:, None], noise_std=0.003, masses=m)
    s = torch.as_tensor(states, device=dev)
    t = s + 0.01

    def grads(edge_stream, full_layer):
        for layer in model.layers:
            layer.edge_stream, layer.full_layer = edge_stream, full_layer
        model.zero_grad(set_to_none=True)
        loss, _ = step.compute_loss(s, t, torch.Generator(dev).manual_seed(5))
        loss.backward()
        return loss.item(), [p.grad.clone() for p in model.parameters()]

    _zero_counts()
    loss_k, g_k = grads(fused_edge_layer, fused_full_layer)
    c = _counts()
    launches = _add(launches, c)
    loss_p, g_p = grads(fused_edge_layer_plain, fused_full_layer_plain)
    rel = _rel_err(g_k, g_p)
    print(f"  surrogate at N={ODD_N}: one training step (B=2, dropout + "
          f"noise, the production checkpoint) through kernels 1 and 2 vs the "
          f"plain versions: loss {loss_k:.7f} vs {loss_p:.7f}; gradients max "
          f"error / scale {rel:.3e} (tolerance {MODEL_GRAD_RTOL:g}); "
          f"fused_edge_fwd {c['fused_edge_fwd']}, fused_edge_bwd "
          f"{c['fused_edge_bwd']} (expected 6 each)", flush=True)
    check(abs(loss_k - loss_p) <= 1e-5 * abs(loss_p)
          and rel <= MODEL_GRAD_RTOL, f"training at N={ODD_N}: kernel path "
                                      f"disagrees with the plain versions")
    check((c["fused_edge_fwd"], c["fused_edge_bwd"]) == (6, 6),
          f"training step launch counts at N={ODD_N}")
    return launches


CKPT_DIR = Path("build/chip_smoke_ckpt")  # git-ignored
CKPT_DATA = dict(n=N, n_sims=10, n_steps=40)  # phase 6's data size
INFLIGHT_SAVES = 4  # saves a layout, train steps timed while each writes
VIEWER_MAX_STEPS = 20  # the viewer's frame cap, so that it subsamples


def _command(argv: list, log: Path, timeout: float = 300) -> tuple:
    """``python -m <argv>`` as a process from the repository root: (its
    output, its wall in s).  The output goes to ``log``; a failure prints
    its last lines and fails."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", *argv], capture_output=True,
                          text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    log.write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        print("".join((proc.stdout + proc.stderr).splitlines(True)[-60:]),
              flush=True)
    check(proc.returncode == 0, f"{argv[0]} exited {proc.returncode}")
    return proc.stdout, wall


def _edge_launches(c: dict) -> str:
    """The edge kernels' launches of a count dict, for a report line."""
    other = sum(v for k, v in c.items() if not k.startswith("fused_edge"))
    return ", ".join(f"{k} {c.get(k, 0)}" for k in (
        "fused_edge_fwd", "fused_edge_bwd", "fused_edge_fwd_bf16",
        "fused_edge_bwd_bf16")) + f", other kernels {other}"


def _same_training_state(a, b) -> bool:
    """Whether two trainers hold bit-equal parameters and AdamW states
    (step, both moments)."""
    import torch

    sa, sb = a.optimizer.state_dict()["state"], b.optimizer.state_dict()[
        "state"]
    return (all(torch.equal(p, q) for p, q in zip(a.model.parameters(),
                                                  b.model.parameters()))
            and len(sa) == len(sb) == len(list(a.model.parameters()))
            and all(set(sa[i]) == set(sb[i])
                    and all(torch.equal(v, sb[i][k]) for k, v in
                            sa[i].items()) for i in sa))


def phase_checkpoint(dev):
    """Async training checkpoints, the plots and the viewer on the card.
    Returns this path's launches (the trainers' runs, the resumed epochs
    and the two train_model processes)."""
    import torch

    from nbody_gnn_hpc_torch import evaluate, generate_data
    from nbody_gnn_hpc_torch.config import TrainingConfig
    from nbody_gnn_hpc_torch.io import latest_checkpoint
    from nbody_gnn_hpc_torch.io.orbax_io import OrbaxCheckpointer, is_durable
    from nbody_gnn_hpc_torch.models import NBodyGNN
    from nbody_gnn_hpc_torch.parallel import simulate_ensemble
    from nbody_gnn_hpc_torch.serve import build_service
    from nbody_gnn_hpc_torch.sim import NBodySimulator, shared_masses
    from nbody_gnn_hpc_torch.train import Trainer, datasets_from_manifest
    from nbody_gnn_hpc_torch.train.dataset import MANIFEST_NAME
    from nbody_gnn_hpc_torch.utils import export_interactive_html

    cfg = TrainingConfig()  # production: batch 24, hidden 256, 6 layers
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    data = CKPT_DIR / "data"
    check(generate_data.main([
        "--particles", str(CKPT_DATA["n"]), "--simulations",
        str(CKPT_DATA["n_sims"]), "--steps", str(CKPT_DATA["n_steps"]),
        "--no-windows", "--trajectory-format", "npz", "--device", str(dev),
        "--output-dir", str(data)]) == 0, "generate_data failed")
    train, val = datasets_from_manifest(data / MANIFEST_NAME, k_neighbors=K,
                                        cache=False)

    def trainer(backend):
        return Trainer(
            NBodyGNN(hidden_dim=cfg.hidden_dim, n_layers=cfg.n_layers,
                     dropout=cfg.dropout), train, val,
            model_dir=str(CKPT_DIR / backend), device=dev,
            learning_rate=cfg.learning_rate, batch_size=cfg.batch_size,
            weight_decay=cfg.weight_decay, noise_std=cfg.noise_std,
            n_epochs=2, seed=7, ckpt_backend=backend)

    # (a) Two epochs under each backend from one seed, save_every=1; how
    # long each save_model call blocks, and the orbax run's final wait.
    steps = 2 * (train.n_samples // cfg.batch_size)
    val_batches = 2 * -(-val.n_samples // cfg.batch_size)
    trained, blocked, launches, waited = {}, {}, {}, []
    for backend in ("orbax", "pickle"):
        t = trained[backend] = trainer(backend)
        blocked[backend] = []

        def timed(name, save=t.save_model, out=blocked[backend]):
            t0 = time.perf_counter()
            path = save(name)
            out.append((time.perf_counter() - t0) * 1e3)
            return path

        t.save_model = timed
        if backend == "orbax":
            mgr = t._orbax_mgr()

            def timed_wait(wait=mgr.wait):
                t0 = time.perf_counter()
                wait()
                waited.append((time.perf_counter() - t0) * 1e3)

            mgr.wait = timed_wait
        _zero_counts()
        t0 = time.perf_counter()
        history = t.train(n_epochs=2, save_every=1, verbose=False,
                          early_stopping_patience=cfg.early_stopping)
        wall = time.perf_counter() - t0
        c = _counts()
        launches = _add(launches, c)
        del t.save_model  # the class's again
        if backend == "orbax":
            del mgr.wait
        check((c["fused_edge_fwd"], c["fused_edge_bwd"])
              == (6 * (steps + val_batches), 6 * steps),
              f"the {backend} run's launch counts")
        check(bool(np.isfinite(t.step_losses + history["val_loss"]).all()),
              f"a loss of the {backend} run is not finite")
        print(f"  {backend}: 2 epochs ({steps} steps at B={cfg.batch_size}, "
              f"{val_batches} validation batches), save_every=1, in "
              f"{wall:.2f} s; save_model blocked "
              f"{['%.2f' % x for x in blocked[backend]]} ms (median "
              f"{np.median(blocked[backend]):.2f})"
              + (f"; the wait for durability at the end {waited[-1]:.2f} ms"
                 if backend == "orbax" else "")
              + f"; fused_edge_fwd {c['fused_edge_fwd']}, fused_edge_bwd "
                f"{c['fused_edge_bwd']}", flush=True)
    index = json.loads((CKPT_DIR / "orbax" / "orbax_index.json").read_text())
    check(sorted(index) == ["best_model.pt", "checkpoint_epoch_1.pt",
                            "checkpoint_epoch_2.pt", "final_model.pt"]
          and all(is_durable(CKPT_DIR / "orbax" / "orbax" / str(e["step"]))
                  for e in index.values()),
          f"the orbax index or its steps are wrong: {index}")
    same_runs = _same_training_state(trained["orbax"], trained["pickle"])
    print(f"  the two backends' runs from one seed: losses equal "
          f"{trained['orbax'].step_losses == trained['pickle'].step_losses}, "
          f"parameters and AdamW states bit-equal {same_runs}", flush=True)

    # (b) Fresh trainers resume final_model.pt from each backend.
    fresh = {b: trainer(b) for b in trained}
    for b, t in fresh.items():
        t.load_model("final_model.pt")
        check(_same_training_state(t, trained[b]),
              f"the {b} resume is not bit-equal to the state it saved")
    o, p = fresh["orbax"], fresh["pickle"]
    check(o.current_epoch == p.current_epoch == 2
          and o._step.count == p._step.count == steps
          and all(np.array_equal(o.norm_stats[k], p.norm_stats[k])
                  for k in p.norm_stats), "the resumed metadata differ")
    check(same_runs == _same_training_state(o, p),
          "the two resumes differ other than their runs did")
    _zero_counts()
    next_loss = {b: t.train_epoch() for b, t in fresh.items()}
    launches = _add(launches, _counts())
    print(f"  fresh trainers load final_model.pt: each bit-equal to the "
          f"state its backend saved (parameters, AdamW step and both "
          f"moments), epoch {o.current_epoch}, step count {o._step.count}, "
          f"norm_stats equal; orbax against pickle bit-equal "
          f"{_same_training_state(o, p)}; the next epoch's loss "
          f"{next_loss['orbax']:.7f} vs {next_loss['pickle']:.7f} (rtol "
          f"1e-6)", flush=True)
    check(same_runs, "the two backends' runs from one seed differ")
    check(abs(next_loss["orbax"] - next_loss["pickle"])
          <= 1e-6 * abs(next_loss["pickle"]), "the resumed epochs differ")

    # (c) The saved step holds save-time values: one more step while the
    # write is queued does not reach it.
    t = trained["orbax"]
    ids = torch.arange(cfg.batch_size, device=dev)
    s, y = t.train_states[ids], t.train_targets[ids]
    before = {k: v.clone() for k, v in t.model.state_dict().items()}
    t.save_model("probe.pt")
    queued = t._orbax.pending
    t._step(s, y, t.generator)
    changed = sum(not torch.equal(v, before[k])
                  for k, v in t.model.state_dict().items())
    t._wait_durable()
    probe = trainer("orbax")
    probe.load_model("probe.pt")
    kept = all(torch.equal(v, before[k])
               for k, v in probe.model.state_dict().items())
    print(f"  save_model, one more step ({changed} of {len(before)} tensors "
          f"changed; writes still queued at the step: {queued}), wait, "
          f"restore: equal to the pre-step parameters {kept}", flush=True)
    check(changed > 0 and kept, "the saved step does not hold the values "
                                "of the moment save_model was called")

    # The step wall with a write in flight and without one.
    def step_ms():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t._step(s, y, t.generator)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    idle = [step_ms() for _ in range(10)][2:]
    # The trainer's flat layout against the per-tensor state dicts (~320
    # tensors), in turns: the save call, the steps a write outlasts, the
    # save to durable.
    layouts = {"flat": t._flat_state,
               "per_tensor": lambda: {"params": t.model.state_dict(),
                                      "opt_state": t.optimizer.state_dict()}}
    cost = {name: {"save_block_ms": [], "step_ms_write_in_flight": [],
                   "save_to_durable_ms": []} for name in layouts}
    for turn, name in enumerate(("per_tensor", "flat", "flat", "per_tensor")):
        mgr = OrbaxCheckpointer(str(CKPT_DIR / "inflight" / str(turn)))
        for i in range(INFLIGHT_SAVES // 2):  # two turns a layout
            t0 = time.perf_counter()
            mgr.save(i + 1, layouts[name]())
            cost[name]["save_block_ms"].append(
                (time.perf_counter() - t0) * 1e3)
            while mgr.pending:
                during = step_ms()
                if mgr.pending:  # the write outlasted the whole step
                    cost[name]["step_ms_write_in_flight"].append(during)
            mgr.wait()
            cost[name]["save_to_durable_ms"].append(
                (time.perf_counter() - t0) * 1e3)
        mgr.close()
    n_bytes = sum(v.numel() * v.element_size() for k, v in
                  t._flat_state().items() if torch.is_tensor(v))
    print(f"  train step wall (B={cfg.batch_size}, synchronised) with no "
          f"write in flight: median {np.median(idle):.2f} ms (min "
          f"{min(idle):.2f}, max {max(idle):.2f}); {n_bytes / 1e6:.1f} MB "
          f"staged a save", flush=True)
    for name, c in cost.items():
        busy = c["step_ms_write_in_flight"]
        print(f"  {name} layout: save blocks "
              f"{['%.2f' % x for x in c['save_block_ms']]} ms; with a write "
              f"in flight the step "
              + (f"median {np.median(busy):.2f} ms over {len(busy)} steps "
                 f"(min {min(busy):.2f}, max {max(busy):.2f})" if busy else
                 "never: every write ended within one step")
              + f"; save to durable "
                f"{['%.1f' % x for x in c['save_to_durable_ms']]} ms",
              flush=True)

    # (d) Durability: an index entry whose step is not durable.
    model_dir = CKPT_DIR / "orbax"
    check(latest_checkpoint(model_dir, backend="orbax") == "final_model.pt",
          "latest_checkpoint(backend='orbax') did not pick final_model.pt")
    torn = t._orbax_step + 1
    (model_dir / "orbax" / str(torn)).mkdir()
    (model_dir / "orbax" / str(torn) / "__0_0.distcp").write_bytes(b"")
    index = json.loads((model_dir / "orbax_index.json").read_text())
    index["checkpoint_epoch_99.pt"] = {
        "step": torn, "scheduler_state_dict": {"epoch": 99}}
    (model_dir / "orbax_index.json").write_text(json.dumps(index))
    picked = latest_checkpoint(model_dir, backend="orbax")
    print(f"  an index entry at epoch 99 whose step {torn} has no .metadata: "
          f"latest_checkpoint(backend='orbax') -> {picked}", flush=True)
    check(picked == "final_model.pt", "a non-durable step was picked")

    # (e) The command on the card: train_model --ckpt-backend orbax, then
    # --resume auto to two epochs; each process's launches read from it.
    # (g)'s galaxy demo runs as a process beside them (it launches no
    # kernel; its wall is its process's, not a measurement).
    cli_dir = CKPT_DIR / "cli"
    argv = ["nbody_gnn_hpc_torch.train_model", "--data-dir", str(data),
            "--model-dir", str(cli_dir), "--ckpt-backend", "orbax"]
    per_epoch = (train.n_samples // cfg.batch_size,
                 -(-val.n_samples // cfg.batch_size))
    cli_runs = (("first", ["--epochs", "1"]),
                ("resumed", ["--epochs", "2", "--resume", "auto"]))
    (demo_out, demo_wall), cli_outs = _concurrently([
        lambda: _command(["nbody_gnn_hpc_torch.examples.demo_galaxy_collision",
                          "-o", str(CKPT_DIR / "demo")],
                         CKPT_DIR / "demo.log"),
        lambda: [_command(argv + flags, CKPT_DIR / f"cli_{run}.log")
                 for run, flags in cli_runs]])
    for (run, flags), (out, wall) in zip(cli_runs, cli_outs):
        c = stage_launches(out)
        launches = _add(launches, c)
        resumed = re.search(r"Resumed from: +\S+ \(epoch (\d+)", out)
        print(f"  train_model --ckpt-backend orbax {' '.join(flags)}: "
              f"{wall:.2f} s as a process"
              + (f", resumed at epoch {resumed.group(1)}" if resumed else "")
              + f"; {_edge_launches(c)}", flush=True)
        # The command trains in bf16 on the card (its default): the bf16
        # forms of kernels 1 and 2, and no float32 ones.
        check((c["fused_edge_fwd_bf16"], c["fused_edge_bwd_bf16"],
               c["fused_edge_fwd"], c["fused_edge_bwd"])
              == (6 * sum(per_epoch), 6 * per_epoch[0], 0, 0),
              f"the {run} train_model run's launch counts")
        check((resumed is None) == (run == "first")
              and (resumed is None or resumed.group(1) == "1"),
              f"the {run} train_model run did not resume as it should")
    index = json.loads((cli_dir / "orbax_index.json").read_text())
    check(index["final_model.pt"]["scheduler_state_dict"]["epoch"] == 2
          and latest_checkpoint(cli_dir, backend="orbax") == "final_model.pt"
          and not list(cli_dir.glob("*.pt")),
          "the resumed train_model run left the wrong checkpoints")

    # (g) The galaxy demo at its defaults, as a process (N=1,000: below
    # 2,048 the force takes the plain broadcast form; no kernel).
    demo = stage_launches(demo_out)
    print(f"  demo_galaxy_collision at its defaults (2 x 500 particles, 300 "
          f"steps): {demo_wall:.2f} s as a process; "
          f"{_edge_launches(demo)}", flush=True)
    check("Integrating 1000 particles for 300 steps" in demo_out,
          "the galaxy demo ran another scene")

    # (f) Plots: evaluate's three (on a short rollout of the production
    # checkpoint against the float32 ground truth), train_model's and the
    # demo's.  Where matplotlib does not import, the commands say so.
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        print("  matplotlib is not importable here: the plots (evaluate's, "
              "train_model's, the demos') are verified on the CPU only "
              "(tests/test_torch_visualization.py and the command tests)",
              flush=True)
        check("(plotting skipped:" in demo_out
              and "(Could not create plot:" in out,
              "the demo or train_model did not say that it skipped its plot")
    else:
        from nbody_gnn_hpc_torch.utils import Visualizer

        masses = shared_masses(N, seed=42)
        truth = simulate_ensemble([9999], N, 25, box_size=10.0, dt=0.001,
                                  shared_masses=masses, device=dev)
        hpc_pos = truth.positions[0, 5:].cpu().numpy()
        hpc_vel = truth.velocities[0, 5:].cpu().numpy()
        ai = build_service(MODEL, CONFIG, device=dev).rollout(
            hpc_pos[0], hpc_vel[0], masses, len(hpc_pos) - 1)
        evaluate.plot_test(Visualizer(str(CKPT_DIR / "plots")), hpc_pos,
                           hpc_vel, ai["positions"], ai["velocities"],
                           masses)
        files = [CKPT_DIR / "plots" / f"{name}_test_1.png" for name in (
            "comparison", "error_over_time", "energy_conservation")] + [
            cli_dir / "plots" / "training_history.png",
            CKPT_DIR / "demo" / "galaxy_collision.png",
            CKPT_DIR / "demo" / "galaxy_distribution.png"]
        sizes = {f.name: f.stat().st_size if f.exists() else 0
                 for f in files}
        print(f"  plots written (bytes): {sizes}", flush=True)
        check(all(sizes.values()), "a plot file is missing or empty")

    # (g) The viewer on phase 12's galaxy-collision trajectory (N=2,200).
    np.random.seed(2026)
    sim = NBodySimulator.create_galaxy_collision(n_per_galaxy=GALAXY_PER,
                                                 device=dev)
    traj = sim.run_trajectory(GALAXY_STEPS)
    t0 = time.perf_counter()
    html = export_interactive_html(
        traj.positions, traj.masses, CKPT_DIR / "galaxy.html",
        times=traj.times, title="Galaxy collision (chip_smoke)",
        max_steps=VIEWER_MAX_STEPS, max_particles=2 * GALAXY_PER)
    wall = time.perf_counter() - t0
    text = Path(html).read_text()
    viewer = json.loads(re.search(r"const DATA = (\{.*?\});\n", text,
                                  re.S).group(1))
    frames = GALAXY_STEPS + 1
    want = len(range(0, frames, -(-frames // VIEWER_MAX_STEPS)))
    print(f"  export_interactive_html of the N={2 * GALAXY_PER} galaxy "
          f"trajectory ({frames} frames, capped at {VIEWER_MAX_STEPS}): "
          f"{len(viewer['positions'])} frames x "
          f"{len(viewer['positions'][0])} particles, {len(text):,} bytes, "
          f"{wall * 1e3:.1f} ms", flush=True)
    check(len(viewer["positions"]) == len(viewer["times"]) == want
          and len(viewer["positions"][0]) == len(viewer["masses"])
          == 2 * GALAXY_PER, "the viewer's data has the wrong shape")
    print(json.dumps({"checkpoint": {
        "save_model_block_ms": blocked, "final_wait_ms": waited[0],
        "staged_bytes": n_bytes, "step_ms_idle": idle, "layouts": cost,
        "demo_galaxy_s": demo_wall}}), flush=True)
    return launches


COMMANDS_DIR = Path("build/chip_smoke_commands")  # git-ignored
BH_ARGV = ("-n", "5000", "--steps", "5")  # the script's defaults
BH_ROUND = 50  # benchmark_bh_temp.CHUNK: steps a timed round
SURROGATE = dict(sims=6, n=24, steps=80)  # demo_surrogate's defaults
PARALLEL = dict(n=24, sims=16, steps=50)  # demo_parallel's defaults
FULL_WIDTH_SERVING = ("--checkpoint", MODEL, "--particles", "200",
                      "--k-neighbors", "40", "--quantize", "int8")
LARGEN_DIR = Path("build/chip_smoke_largen")  # git-ignored
LARGEN_TIMEOUT_S = 3000


def _launch_line_last(out: str, label: str) -> dict:
    """The counts of the launch line ``out`` ends with (the large-N
    pipeline's sums those its stages printed before it)."""
    from nbody_gnn_hpc_torch.ops import LAUNCH_LINE

    last = out.splitlines()[-1]
    check(last.startswith(LAUNCH_LINE),
          f"{label} did not print its kernel launches last")
    return json.loads(last[len(LAUNCH_LINE):])


def phase_commands() -> dict:
    """The six commands ported last, each a process from the repository
    root, its launches read from the line it prints last.  Returns their
    sum and a summary (walls, the benchmark's step time)."""
    import importlib.util

    COMMANDS_DIR.mkdir(parents=True, exist_ok=True)
    total, walls, launched = {}, {}, {}

    def start(label, module, *flags):
        return _command([f"nbody_gnn_hpc_torch.{module}", *flags],
                        COMMANDS_DIR / f"{label}.log")

    def run(label, module, *flags, done=None):
        """The command's (output, counts); ``done``: its (output, wall),
        where it already ran."""
        out, wall = done if done is not None else start(label, module,
                                                        *flags)
        c = _launch_line_last(out, label)
        nonzero = {k: v for k, v in c.items() if v}
        print(f"  {label}: {wall:.2f} s as a process; launches {nonzero}",
              flush=True)
        walls[label], launched[label] = wall, c
        check(c["pairwise_symmetric_mxu"] == 0, f"{label} launched kernel 5")
        total.update(_add(total, c))
        return out, c

    # The large-N step benchmark: kernel 6 once a force evaluation (the
    # initial one, the warm-up step, an untimed round and the rounds).
    out, c = run("benchmark_bh_temp", "benchmark_bh_temp", *BH_ARGV)
    rounds = [float(v) for v in re.findall(
        r"^Round \d+ \(\d+ steps\): (\S+) ms/step$", out, re.M)]
    avg = re.search(r"^Average step time: (\S+)s \((\S+) Gpairs/s\)$",
                    out, re.M)
    n_rounds = int(BH_ARGV[3])
    check(avg is not None and len(rounds) == n_rounds
          and all(np.isfinite(rounds)), "benchmark_bh_temp printed no "
                                        "rounds or no average")
    check(c["pairwise_symmetric"] == 2 + BH_ROUND * (n_rounds + 1),
          f"benchmark_bh_temp launched kernel 6 {c['pairwise_symmetric']} "
          f"times")
    bench = {"n": int(BH_ARGV[1]), "round_ms_per_step": rounds,
             "avg_step_s": float(avg.group(1)),
             "gpairs_per_s": float(avg.group(2))}

    # The demos as five processes at once (the benchmark ran alone: it
    # times its steps; a demo's wall is its process's, not a measurement).
    demos = {"demo_surrogate": ("examples.demo_surrogate",
                                "--trajectory-format", "npz"),
             "demo_serving": ("examples.demo_serving",),
             "demo_serving_full_width": ("examples.demo_serving",
                                         *FULL_WIDTH_SERVING),
             "demo_parallel_virtual_devices_0": (
                 "examples.demo_parallel", "--virtual-devices", "0"),
             "demo_parallel_virtual_devices_2": (
                 "examples.demo_parallel", "--virtual-devices", "2")}
    t0 = time.perf_counter()
    ran = dict(zip(demos, _concurrently([
        (lambda label=label, argv=argv: start(label, *argv))
        for label, argv in demos.items()])))
    print(f"  the five demo processes at once in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # The surrogate quickstart on the npz store: kernel 4 for the ensemble
    # and the test system (once a step and for the initial force), kernels
    # 1 and 2 in training, kernel 1 in the rollout.
    out, c = run("demo_surrogate", *demos["demo_surrogate"],
                 done=ran["demo_surrogate"])
    workdir = Path(re.search(r"^workdir: (\S+)$", out, re.M).group(1))
    rmse = [float(v) for v in re.findall(r"position RMSE: (\S+)", out)]
    check(len(rmse) == 2 and all(np.isfinite(rmse)),
          "demo_surrogate printed no finite RMSE")
    check(c["pairwise_small"] == 2 * (SURROGATE["steps"] + 1)
          and c["fused_edge_fwd"] > 0 and c["fused_edge_bwd"] > 0,
          "demo_surrogate did not launch kernels 1, 2 and 4 as it should")
    names = sorted(p.name for p in (workdir / "checkpoints").iterdir())
    check(names == [f"sim_{i:04d}_trajectory.npz"
                    for i in range(SURROGATE["sims"])],
          f"demo_surrogate wrote {names}")

    # merge_dataset on that npz store, where h5py imports (the datasets are
    # HDF5); the card's machine has had none.
    if importlib.util.find_spec("h5py") is None:
        print("  merge_dataset skipped: h5py is not importable here (its "
              "datasets are HDF5); verified on the CPU against "
              "scripts/merge_dataset.py (tests/test_torch_merge_dataset.py)",
              flush=True)
    else:
        import h5py

        run("merge_dataset", "merge_dataset", "-o", str(workdir),
            "--sequence-length", "5")
        per_file = SURROGATE["steps"] + 1 - 5
        for name, files in (("train_dataset.h5", 4), ("val_dataset.h5", 2)):
            with h5py.File(workdir / name, "r") as f:
                check(int(f.attrs["n_samples"]) == files * per_file
                      and f["inputs"].shape[1:] == (5, SURROGATE["n"], 6)
                      and "masses" in f, f"merge_dataset wrote a wrong "
                                         f"{name}")
    shutil.rmtree(workdir)

    # The serving demo at its defaults and at the production width (the
    # trained checkpoint, int8 weights): kernel 1 on every rollout step.
    for label, flags in (("demo_serving", ()),
                         ("demo_serving_full_width", FULL_WIDTH_SERVING)):
        out, c = run(label, *demos[label], done=ran[label])
        check("Concurrent wall clock" in out and out.count("client ") == 6
              and "FAILED" not in out and "finite=True" in out,
              f"{label} did not answer every client")
        check(c["fused_edge_fwd"] > 0, f"{label} launched no kernel 1")
        if flags:
            check("'quantization': 'int8'" in out
                  and "'hidden_dim': 256" in out,
                  f"{label} did not serve the int8 production model")

    # The parallel demo, a world of one (NCCL) and two gloo ranks sharing
    # the card: kernel 4 twice a rank (sharded and alone), kernels 1 and 2
    # in the step, kernel 1 in the pool.
    for ranks in ("0", "2"):
        label = f"demo_parallel_virtual_devices_{ranks}"
        out, c = run(label, *demos[label], done=ran[label])
        check("equals unsharded" in out and "== 1-device" in out
              and "device-pinned replicas" in out,
              f"{label} did not print its three sections")
        world = int(ranks) or 1
        check(c["pairwise_small"] == 2 * world * (PARALLEL["steps"] + 1)
              and c["fused_edge_fwd"] > 0 and c["fused_edge_bwd"] > 0,
              f"{label} did not launch kernels 1, 2 and 4 as it should")
    summary = {"walls_s": walls, "benchmark_bh_temp": bench,
               "launches": launched}
    print(json.dumps({"commands": summary}), flush=True)
    return total


def large_n() -> dict:
    """``--large-n``: ``python -m nbody_gnn_hpc_torch.largen_pipeline`` on
    the npz store in ``LARGEN_DIR``, as a process; its stage walls,
    results and launches (kernels 1, 2 and 6 must run, kernel 5 not)."""
    if LARGEN_DIR.exists():
        shutil.rmtree(LARGEN_DIR)
    LARGEN_DIR.parent.mkdir(parents=True, exist_ok=True)
    log = LARGEN_DIR.parent / "chip_smoke_largen.log"
    out, wall = _command(["nbody_gnn_hpc_torch.largen_pipeline",
                          str(LARGEN_DIR), "--trajectory-format", "npz"],
                         log, timeout=LARGEN_TIMEOUT_S)
    c = _launch_line_last(out, "largen_pipeline")
    walls = re.findall(r"^STAGE_WALL (\w+) n=(\d+) (\S+) s$", out, re.M)
    results = re.findall(r"^LARGEN_RESULT n=(\d+) posRMSE=(\S+) "
                         r"velRMSE=(\S+) energy_err=(\S+)$", out, re.M)
    for line in out.splitlines():
        if line.startswith(("STAGE_WALL", "LARGEN_RESULT")):
            print(f"  {line}", flush=True)
    check(len(walls) == 6 and [r[0] for r in results] == ["2085", "5000"],
          "largen_pipeline did not run both scales")
    check(all(np.isfinite(float(v)) for r in results for v in r[1:3]),
          "largen_pipeline gave a non-finite RMSE")
    stages = out.split("\nSTEP: ")[1:]
    check(len(stages) == 6 and all(re.search(r"Device:\s+cuda\b", st)
                                   for st in stages),
          "a largen_pipeline stage did not run on cuda")
    # Its train_model stages train in bf16 on the card (their default).
    check(min(c[k] for k in ("fused_edge_fwd", "fused_edge_fwd_bf16",
                             "fused_edge_bwd_bf16", "pairwise_symmetric")) > 0
          and c["pairwise_symmetric_mxu"] == c["fused_edge_bwd"] == 0,
          f"largen_pipeline launched {c}")
    return {"wall_s": wall, "launches": c,
            "stage_walls_s": {f"{stage} n={n}": float(s)
                              for stage, n, s in walls},
            "results": {n: {"position_rmse": float(p),
                            "velocity_rmse": float(v), "energy_err": e}
                        for n, p, v, e in results}}


# Phase 15: bf16 training, the production recipe's precision.
BF16_DIR = Path("build/chip_smoke_bf16")  # git-ignored
# The bf16 stream against its plain bf16 version: where a float32
# difference of the two (the kernel's approximate sigmoid, the sum order)
# moves a value across a bf16 rounding boundary, the result moves by that
# value's bf16 step (2^-8 of it).  So the largest error may reach
# BF16_MAX_OF_SCALE of the result's scale, and at most BF16_SHARE of the
# elements may lie beyond the float32 bound (1e-4 of scale).  The share
# tells the forms apart: the bf16 kernels put at most 0.004 % of the
# elements beyond it, the float32 kernels on the same bf16 values 6-7 %
# (kernel 1) and 22-41 % (kernel 2's d_t, d_s), measured on an H100; every
# run holds that control.  Kernel 2's float32 results (d_edge_attr, d_W_e,
# d_gamma, d_beta, from the unrounded dz of the same bf16 inputs) keep
# GRAD_RTOL.
BF16_MAX_OF_SCALE, BF16_SHARE = 2.0 ** -7, 1e-2
# Kernel 7's bf16 form against its plain bf16 version.  h_new is rounded
# twice, bf16(bf16(a W2^T) + bf16(b2)): where the product lies in a binade
# above h_new's (b2 of the other sign), a step of the first rounding is two
# of h_new's, so the largest error may reach BF16_FULL_MAX_OF_SCALE (8.1e-3
# of scale measured on the checkpoint's operands at B=24).  And one bf16
# step in t, s, a stream term or z1 moves every channel of its row of h_new
# a little (each output reads the whole row of a), so more elements lie
# beyond 1e-4 of scale than in kernels 1 and 2: 0.04-0.08 % on the
# checkpoint's operands, 0.8-1.0 % on random ones at N=200 and 2.7-3.4 % at
# N=13 (a row is 7.7 % of the elements there); at most BF16_FULL_SHARE.
# The float32 kernel on the same bf16 weights puts 85-95 % beyond and must
# be refused (H100).  Its gradients against the reference backward: within
# BF16_MAX_OF_SCALE of each one's scale (one bf16 step of its largest
# element; d_wt and d_ws are bf16; 5.2e-3 measured); float32 sums of bf16
# terms over the batch put up to half of a gradient's elements beyond 1e-4
# of scale, so no share is held there.
BF16_FULL_MAX_OF_SCALE, BF16_FULL_SHARE = 2.0 ** -6, 0.2
# The bf16 model, kernel path against plain path on the production
# checkpoint: those bf16 steps carried through six layers, 7.0e-3 and
# 2.3e-2 of scale on two batches; the float32 model of the same weights
# reads 3.0 against the bf16 plain path (H100; held in every run).
BF16_MODEL_GRAD_RTOL, BF16_LOSS_RTOL = 5e-2, 1e-3
BF16_FIXED_STEPS = 12  # optimizer steps on one batch a dtype, 2 warm-up
BF16_CLI_SAMPLES = 24  # train_model --max-samples: one step of B=24


def bf16_errors(got, want) -> tuple:
    """(max abs error, max error / scale, share of elements beyond 1e-4 of
    scale) of a bf16-stream result against its plain version."""
    got, want = got.float(), want.float()
    scale = want.abs().max().item() + 1e-6
    err = (got - want).abs()
    return (err.max().item(), err.max().item() / scale,
            (err > 1e-4 * scale).float().mean().item())


def phase_bf16_kernels(model, norm_stats, dev):
    """(a) Kernels 1 and 2 in their bf16-stream form against their plain
    bf16 versions, on the production checkpoint's layer-0 operands with
    the projections in bf16: kernel 1 in inference form at B=1 and in
    training form (dropout 0.1) at B=1 and 24, kernel 2 in training form
    at B=1 and 24 (the batch folded); exact launch counts (bf16 forms
    only); a rerun bit for bit; CUDA-event times of both dtypes' kernels.
    Called under inference_mode.  Returns the timed rows and each form's
    largest absolute error."""
    import torch

    from nbody_gnn_hpc_torch.ops import (fused_edge_backward,
                                         fused_edge_backward_reference,
                                         fused_edge_layer,
                                         fused_edge_layer_reference)

    seed = torch.tensor([DROP_SEED], dtype=torch.int32, device=dev)
    rows, errs = [], {"fused_edge_fwd_bf16": 0.0, "fused_edge_bwd_bf16": 0.0}

    def counts():
        return (fused_edge_layer.launches, fused_edge_layer.bf16_launches,
                fused_edge_backward.launches,
                fused_edge_backward.bf16_launches)

    def within(got, want):
        _, rel, share = bf16_errors(got, want)
        return rel <= BF16_MAX_OF_SCALE and share <= BF16_SHARE

    def held(name, label, got, want, again, moved, control):
        err, rel, share = bf16_errors(got, want)
        ok = within(got, want)
        errs[name] = max(errs[name], err)
        _, c_rel, c_share = bf16_errors(control, want)
        print(f"  {name} {label}: max abs err {err:.3e}, {rel:.3e} of "
              f"scale, {100 * share:.3f} % beyond 1e-4 of scale (tolerance "
              f"{BF16_MAX_OF_SCALE:g} of scale, {100 * BF16_SHARE:g} %) -> "
              f"{'ok' if ok else 'MISMATCH'}; rerun bit-identical: {again}; "
              f"control, the float32 kernel on the same bf16 values: "
              f"{c_rel:.3e} of scale, {100 * c_share:.3f} % beyond -> "
              f"{'refused' if not within(control, want) else 'PASSED'}",
              flush=True)
        check(ok, f"{name} disagrees with its plain bf16 version ({label})")
        check(not within(control, want),
              f"{name}'s tolerance does not tell the bf16 stream from the "
              f"float32 one ({label})")
        check(again, f"{name} reruns are not bit-identical")
        check(moved, f"{name} did not count one bf16 launch and no float32 "
                     f"one ({label})")

    def timed(name, form, b, fn, fn32, plain, bound, reps):
        ms, ms32 = cuda_time_ms(fn), cuda_time_ms(fn32)
        plain_ms = cuda_time_ms(plain, *reps)
        rows.append({"kernel": name, "form": form, "B": b, "N": N, "k": K,
                     "ms": ms, "ms_float32": ms32, "plain_ms": plain_ms,
                     "bound_ms": bound[0], "bound_by": bound[1]})
        print(f"  {name} {form} B={b}: bf16 kernel {ms:.5f} ms, float32 "
              f"kernel {ms32:.5f} ms (same call, same operands), plain bf16 "
              f"{plain_ms:.5f} ms, bound {bound[0]:.6f} ms ({bound[1]}; "
              f"float32 operands: {bound[2]:.6f} ms); library_ms null",
              flush=True)

    for b, form, sd, p in ((1, "inference", None, 0.0),
                           (1, "training", seed, DROPOUT_P),
                           (24, "training", seed, DROPOUT_P)):
        a32 = edge_layer_inputs(model, norm_stats, b, N, K, dev)
        args = (a32[0].bfloat16(), a32[1].bfloat16()) + a32[2:]
        rounded = (args[0].float(), args[1].float()) + a32[2:]
        kw = dict(dropout_p=p, deterministic=sd is None)
        before = counts()
        got = fused_edge_layer(*args, sd, **kw)
        torch.cuda.synchronize()
        moved = tuple(x - y for x, y in zip(counts(), before)) == (0, 1, 0, 0)
        check(got.dtype == torch.float32, "kernel 1's bf16 form is not "
                                          "float32 out")
        held("fused_edge_fwd_bf16", f"{form} B={b}", got,
             fused_edge_layer_reference(*args, sd, p),
             torch.equal(got, fused_edge_layer(*args, sd, **kw)), moved,
             fused_edge_layer(*rounded, sd, **kw))
        timed("fused_edge_fwd_bf16", form, b,
              lambda: fused_edge_layer(*args, sd, **kw),
              lambda: fused_edge_layer(*a32, sd, **kw),
              lambda: fused_edge_layer_reference(*args, sd, p),
              edge_bound_ms(args, sd is not None) + (
                  edge_bound_ms(a32, sd is not None)[0],),
              (3, 5) if b == 24 else ())
    for b in (1, 24):
        a32 = edge_layer_inputs(model, norm_stats, b, N, K, dev)
        args = (a32[0].bfloat16(), a32[1].bfloat16()) + a32[2:]
        rounded = (args[0].float(), args[1].float()) + a32[2:]
        g_out = torch.randn(a32[0].shape, device=dev,
                            generator=torch.Generator(dev).manual_seed(b))
        before = counts()
        got = fused_edge_backward(*args, g_out, seed, DROPOUT_P,
                                  need_d_edge_attr=False)
        torch.cuda.synchronize()
        moved = tuple(x - y for x, y in zip(counts(), before)) == (0, 0, 0, 1)
        check([g.dtype for g in got[:2]] == [torch.bfloat16] * 2
              and got[2] is None, "kernel 2's bf16 form returned the wrong "
                                  "dtypes")
        want = fused_edge_backward_reference(*args, g_out, seed, DROPOUT_P)
        again = fused_edge_backward(*args, g_out, seed, DROPOUT_P,
                                    need_d_edge_attr=False)
        same = all(torch.equal(x, y) for x, y in zip(got[:2] + got[3:],
                                                     again[:2] + again[3:]))
        control = fused_edge_backward(*rounded, g_out, seed, DROPOUT_P,
                                      need_d_edge_attr=False)
        for i, label in enumerate(("d_t_proj", "d_s_proj")):
            held("fused_edge_bwd_bf16", f"training B={b} {label}", got[i],
                 want[i], same, moved, control[i])
        err, rel = _grad_errors(got[3:], want[3:])
        errs["fused_edge_bwd_bf16"] = max(errs["fused_edge_bwd_bf16"], err)
        print(f"  fused_edge_bwd_bf16 training B={b} d_W_e, d_gamma, d_beta "
              f"(float32): max abs err {err:.3e}, max err / gradient scale "
              f"{rel:.3e} (tolerance {GRAD_RTOL:g}) -> "
              f"{'ok' if rel <= GRAD_RTOL else 'MISMATCH'}", flush=True)
        check(rel <= GRAD_RTOL, "kernel 2's bf16 form: a float32 gradient "
                                "disagrees with its plain version")
        timed("fused_edge_bwd_bf16", "training", b,
              lambda: fused_edge_backward(*args, g_out, seed, DROPOUT_P,
                                          need_d_edge_attr=False),
              lambda: fused_edge_backward(*a32, g_out, seed, DROPOUT_P,
                                          need_d_edge_attr=False),
              lambda: fused_edge_backward_reference(*args, g_out, seed,
                                                    DROPOUT_P),
              edge_bwd_bound_ms(args, True) + (
                  edge_bwd_bound_ms(a32, True)[0],),
              (3, 5) if b == 24 else ())
    return rows, errs


def full_layer_bf16_bound_ms(h, ea, p, edges, node_mask,
                             dropout: bool) -> tuple:
    """Least H100 time for one whole-layer forward in the bf16 form:
    ``full_layer_bound_ms``'s bytes (wt and ws at their 2 bytes), and its
    operations with the six products, 2*N*H*(5H + Ho) a graph, at the bf16
    tensor-core peak (their operands are bf16) beside the stream's and the
    node side's float32 work at the float32 peak: the two times add."""
    b, n, hdim = h.shape
    e, d = ea.shape[1], ea.shape[2]
    ho = p["w2"].shape[0]
    n_bytes = (4 * (h.numel() + ea.numel() + edges.perm.numel()
                    + edges.src.numel() + edges.offsets.numel()
                    + (0 if node_mask is None else node_mask.numel())
                    + b * n * ho + b * n * hdim)
               + sum(t.numel() * t.element_size() for t in p.values()))
    products = 2 * b * n * hdim * (5 * hdim + ho)
    rest = (13 + 2 * d + int(dropout)) * b * e * hdim + 11 * b * n * hdim
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = (products / PEAK_BF16_PER_S + rest / PEAK_F32_PER_S) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def _bf16_weights(p):
    """A layer's parameters in the bf16 form: wt and ws bfloat16."""
    return dict(p, wt=p["wt"].bfloat16(), ws=p["ws"].bfloat16())


def phase_full_bf16_kernels(model, norm_stats, dev):
    """(d1) Kernel 7's bf16 form against its plain bf16 version on the
    production checkpoint's layer-0 operands (wt and ws in bf16): inference
    at B=1 and 8, training (dropout 0.1, the same Philox mask and node mask)
    at B=24, the odd shape (B=1, N=13, k=4) in both forms; the cooperative
    and the ordinary-launch form bit-equal; the bf16 rule of kernels 1 and
    2 with BF16_FULL_MAX_OF_SCALE and BF16_FULL_SHARE, the float32 kernel
    on the same bf16 weights refused by it; exact launch
    counts of both forms; a rerun bit for bit; CUDA-event times of both
    forms on the same operands.  Called under inference_mode.  Returns the
    timed rows and the largest absolute error."""
    import torch

    from nbody_gnn_hpc_torch.ops import (fused_edge_full, fused_full_layer,
                                         fused_full_layer_reference)
    from nbody_gnn_hpc_torch.ops.fused_edge_full import PHASES

    seed = torch.tensor([DROP_SEED], dtype=torch.int32, device=dev)
    rows, worst = [], 0.0

    def counts():
        return (fused_full_layer.launches, fused_full_layer.bf16_launches)

    def within(got, want):
        _, rel, share = bf16_errors(got, want)
        return rel <= BF16_FULL_MAX_OF_SCALE and share <= BF16_FULL_SHARE

    for b, n, k, training in ((1, N, K, False), (8, N, K, False),
                              (24, N, K, True), (1, 13, 4, False),
                              (1, 13, 4, True)):
        h, ea, p, edges = full_layer_inputs(model, norm_stats, b, n, k, dev)
        p16 = _bf16_weights(p)
        rounded = dict(p, wt=p16["wt"].float(), ws=p16["ws"].float())
        mask = (torch.rand(h.shape, device=dev,
                           generator=torch.Generator(dev).manual_seed(b))
                >= DROPOUT_P).float() / (1 - DROPOUT_P)
        sd, mk, rate = ((seed, mask, DROPOUT_P) if training
                        else (None, None, 0.0))
        form = "training" if training else "inference"

        def run(params=p16):
            return fused_full_layer(h, ea, params, edges, sd, mk,
                                    dropout_p=rate,
                                    deterministic=not training)

        before = counts()
        got = run()
        torch.cuda.synchronize()
        moved = tuple(x - y for x, y in zip(counts(), before))
        want, _ = fused_full_layer_reference(h, ea, p16, edges, sd, mk, rate)
        again = torch.equal(got, run())
        fused_edge_full.COOPERATIVE = False
        try:
            before = counts()
            phased = run()
            phased_moved = tuple(x - y for x, y in zip(counts(), before))
        finally:
            fused_edge_full.COOPERATIVE = True
        control = run(rounded)
        err, rel, share = bf16_errors(got, want)
        _, c_rel, c_share = bf16_errors(control, want)
        ok = within(got, want)
        worst = max(worst, err)
        print(f"  fused_full_fwd_bf16 {form} B={b} N={n} k={k}: max abs err "
              f"{err:.3e}, {rel:.3e} of scale, {100 * share:.3f} % beyond "
              f"1e-4 of scale (tolerance {BF16_FULL_MAX_OF_SCALE:g} of "
              f"scale, {100 * BF16_FULL_SHARE:g} %) -> "
              f"{'ok' if ok else 'MISMATCH'}; "
              f"launches {moved} (float32, bf16); ordinary-launch form "
              f"{phased_moved} bit-equal: {torch.equal(got, phased)}; rerun "
              f"bit-identical: {again}; control, the float32 kernel on the "
              f"same bf16 weights: {c_rel:.3e} of scale, "
              f"{100 * c_share:.3f} % beyond -> "
              f"{'refused' if not within(control, want) else 'PASSED'}",
              flush=True)
        check(got.dtype == torch.float32, "kernel 7's bf16 form is not "
                                          "float32 out")
        check(ok, f"fused_full_fwd_bf16 disagrees with its plain bf16 "
                  f"version ({form} B={b} N={n})")
        check(not within(control, want), "the bf16 rule does not tell "
                                         "kernel 7's bf16 form from its "
                                         "float32 one")
        check(moved == (0, 1) and phased_moved == (0, PHASES),
              "kernel 7's bf16 form did not count one cooperative bf16 "
              "launch (six ordinary ones) and no float32 one")
        check(torch.equal(got, phased), "the ordinary-launch form of "
                                        "kernel 7's bf16 form differs")
        check(again, "fused_full_fwd_bf16 reruns are not bit-identical")
        if n != N:
            continue
        ms, ms32 = cuda_time_ms(run), cuda_time_ms(lambda: run(p))
        plain_ms = cuda_time_ms(
            lambda: fused_full_layer_reference(h, ea, p16, edges, sd, mk,
                                               rate),
            5 if b == 24 else 20, inner=10)
        bound = full_layer_bf16_bound_ms(h, ea, p16, edges, mk, training)
        bound32 = full_layer_bound_ms(h, ea, p, edges, mk, training)
        rows.append({"kernel": "fused_full_fwd_bf16", "form": form, "B": b,
                     "N": n, "k": k, "ms": ms, "ms_float32": ms32,
                     "plain_ms": plain_ms,
                     "bound_ms": bound[0], "bound_by": bound[1],
                     "bound_ms_float32": bound32[0]})
        print(f"    bf16 form {ms:.5f} ms, float32 form {ms32:.5f} ms "
              f"(same call, same operands), plain bf16 {plain_ms:.5f} ms, "
              f"bound {bound[0]:.6f} ms ({bound[1]}; the float32 form's "
              f"{bound32[0]:.6f}); library_ms null", flush=True)
    return rows, worst


def full_bf16_layer_gradients(model, norm_stats, dev) -> float:
    """(d2) One layer's gradients in the bf16 form at B=24 in training form
    (dropout and node mask): the custom backward on the card (kernel 7's
    and kernel 2's bf16 forms, one launch each) against the reference
    backward on the card (``fused_full_layer_backward_reference``: the
    plain forward's summed, kernel 2's plain bf16 version), every gradient
    within BF16_MAX_OF_SCALE of its scale; d_wt and d_ws bf16 and
    bf16-exact.  Returns the largest error relative to a gradient's
    scale."""
    import torch

    from nbody_gnn_hpc_torch.ops import (fused_edge_backward,
                                         fused_full_layer,
                                         fused_full_layer_backward_reference)
    from nbody_gnn_hpc_torch.ops.fused_edge_full import PARAM_KEYS

    h, ea, p, edges = full_layer_inputs(model, norm_stats, 24, N, K, dev)
    p16 = _bf16_weights(p)
    gen = torch.Generator(dev).manual_seed(24)
    mask = (torch.rand(h.shape, device=dev, generator=gen)
            >= DROPOUT_P).float() / (1 - DROPOUT_P)
    g_out = torch.randn(h.shape, device=dev, generator=gen)
    seed = torch.tensor([DROP_SEED], dtype=torch.int32, device=dev)
    leaves = [h.clone().requires_grad_(), ea.clone().requires_grad_()]
    params = {key: t.clone().requires_grad_() for key, t in p16.items()}

    def counts():
        return (fused_full_layer.launches, fused_full_layer.bf16_launches,
                fused_edge_backward.launches,
                fused_edge_backward.bf16_launches)

    before = counts()
    out = fused_full_layer(leaves[0], leaves[1], params, edges, seed, mask,
                           dropout_p=DROPOUT_P, deterministic=False)
    out.backward(g_out)
    torch.cuda.synchronize()
    moved = tuple(x - y for x, y in zip(counts(), before))
    got = [t.grad for t in leaves + [params[key] for key in PARAM_KEYS]]
    want = fused_full_layer_backward_reference(h, ea, p16, edges, g_out,
                                               seed, mask, DROPOUT_P)
    worst, shares = 0.0, 0.0
    for name, g, w in zip(("h", "edge_attr") + PARAM_KEYS, got, want):
        _, rel, share = bf16_errors(g, w)
        worst, shares = max(worst, rel), max(shares, share)
        dtype = torch.bfloat16 if name in ("wt", "ws") else torch.float32
        check(g.dtype == w.dtype == dtype, f"kernel 7's bf16 backward gave "
                                           f"d_{name} in {g.dtype}")
    exact = all(torch.equal(g.float(), g.float().bfloat16().float())
                for g in (params["wt"].grad, params["ws"].grad))
    print(f"  fused_full bf16 layer gradients (h, edge_attr, 14 parameters; "
          f"B=24, dropout and node mask on) vs the reference backward: max "
          f"error / gradient scale {worst:.3e} (tolerance "
          f"{BF16_MAX_OF_SCALE:g}), at most {100 * shares:.2f} % of a "
          f"gradient's elements beyond 1e-4 of scale; d_wt, d_ws "
          f"bf16-exact: {exact}; "
          f"launches {moved} (kernel 7 float32, bf16; kernel 2 float32, "
          f"bf16)", flush=True)
    check(worst <= BF16_MAX_OF_SCALE, "kernel 7's bf16 backward disagrees "
                                      "with the reference backward")
    check(exact, "d_wt or d_ws is not bf16-exact")
    check(moved == (0, 1, 0, 1), "kernel 7's bf16 layer did not run kernel "
                                 "7's and kernel 2's bf16 forms once each")
    return worst


def train_full_bf16(dev, cfg, width, train, val, val_batches, batch,
                    fused_step) -> dict:
    """(d3) ``Trainer`` with a bf16 ``NBodyGNN(edge_impl="fused_full")`` at
    the production configuration for an epoch, counts zeroed just before
    and read just after (kernel 7's and kernel 2's bf16 forms, 6 a step and
    kernel 7's 6 a validation batch; no float32 form, no kernel 1); losses
    finite, parameters float32; on one batch its step wall in turns with
    (b)'s bf16 ``fused`` step and a profiled window each, its loss falling;
    its checkpoint served at float32 through ``build_service`` for 5 steps
    against ``device="cpu"``.  Returns a summary with the launches."""
    import torch

    from nbody_gnn_hpc_torch.models import NBodyGNN
    from nbody_gnn_hpc_torch.serve import build_service
    from nbody_gnn_hpc_torch.train import Trainer

    model_dir = BF16_DIR / "trainer_fused_full"
    trainer = Trainer(
        NBodyGNN(dtype=torch.bfloat16, edge_impl="fused_full", **width),
        train, val, model_dir=str(model_dir), device=dev,
        learning_rate=cfg.learning_rate, batch_size=cfg.batch_size,
        weight_decay=cfg.weight_decay, noise_std=cfg.noise_std, n_epochs=1,
        seed=7)
    # main-path run starts here
    _zero_counts()
    history = trainer.train(n_epochs=1, save_every=10)
    launches = _counts()
    # main-path run ends here
    steps = trainer.steps_per_epoch
    want = {"fused_full_fwd_bf16": 6 * (steps + val_batches),
            "fused_edge_bwd_bf16": 6 * steps}
    got = {k: v for k, v in launches.items() if v}
    print(f"  Trainer, bf16 model, edge_impl fused_full, 1 epoch: {steps} "
          f"steps at B={cfg.batch_size} + {val_batches} validation batches; "
          f"step losses {['%.4f' % x for x in trainer.step_losses]}, "
          f"validation {['%.4f' % x for x in history['val_loss']]}; "
          f"launches {got} (expected {want})", flush=True)
    check(got == want, "the bf16 fused_full training path's launch counts")
    check(bool(np.isfinite(trainer.step_losses + history["val_loss"]).all()),
          "a bf16 fused_full training loss is not finite")
    check(trainer.model.dtype == torch.bfloat16
          and all(p.dtype == torch.float32
                  for p in trainer.model.parameters()),
          "the bf16 fused_full model's parameters are not float32")

    s, t = batch
    steppers = {"fused": fused_step, "fused_full": trainer._step}
    with torch.no_grad():
        before = trainer._step.compute_loss(s, t, deterministic=True)[0].item()
    walls = {name: [] for name in steppers}
    gen = torch.Generator(dev).manual_seed(6)
    for turn in range(2 * BF16_FIXED_STEPS):
        name = ("fused", "fused_full")[turn // 2 % 2]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steppers[name](s, t, gen)
        torch.cuda.synchronize()
        walls[name].append(time.perf_counter() - t0)
    with torch.no_grad():
        after = trainer._step.compute_loss(s, t, deterministic=True)[0].item()
    summary = {"step_ms": {}, "busy_share": {}, "launches": launches}
    for name, w in walls.items():
        summary["step_ms"][name] = float(np.median(w[2:]) * 1e3)
        print(f"  train step wall, bf16 {name} (B={cfg.batch_size}, "
              f"synchronised, in turns of two, after 2 warm-up): median "
              f"{summary['step_ms'][name]:.2f} ms, min "
              f"{min(w[2:]) * 1e3:.2f} ms, max {max(w[2:]) * 1e3:.2f} ms",
              flush=True)
        window = {}
        profile_window(f"3 train steps, bf16 {name}", lambda: [
            steppers[name](s, t, gen) for _ in range(3)], steps=3,
            out=window)
        summary["busy_share"][name] = window.get("busy_share")
    print(f"  fixed batch, bf16 fused_full loss with dropout and noise off: "
          f"{before:.6f} before, {after:.6f} after {BF16_FIXED_STEPS} "
          f"steps on it", flush=True)
    check(after < before, "bf16 fused_full steps on one batch did not lower "
                          "its loss")

    # Its checkpoint served at float32 (through kernel 7's float32 form).
    with open(model_dir / "config.json", "w") as f:
        json.dump({"model_type": "gnn", "model_config": {
            **trainer._model_config, "dtype": "bfloat16", "remat": False},
            "training_config": cfg.to_dict()}, f, indent=2)
    served = build_service(str(model_dir / "best_model.pt"),
                           str(model_dir / "config.json"))
    ref = build_service(str(model_dir / "best_model.pt"),
                        str(model_dir / "config.json"), device="cpu")
    check(served.predictor.model.dtype == ref.predictor.model.dtype
          == torch.float32 and served.predictor.model.edge_impl
          == "fused_full", "the bf16 fused_full checkpoint was not served "
                           "at float32 through kernel 7")
    pos, vel, masses = eval_states(1)
    out = served.rollout(pos[0], vel[0], masses, 5)
    diff, ok = close_to(out["positions"], ref.rollout(
        pos[0], vel[0], masses, 5)["positions"], 1e-4)
    print(f"  served the bf16 fused_full best_model.pt at float32: 5 steps, "
          f"max abs diff from device='cpu' {diff:.3e} (1e-4 of scale)",
          flush=True)
    check(ok and np.isfinite(out["positions"]).all(),
          "the bf16 fused_full checkpoint's rollout disagrees with the CPU "
          "run")
    return summary


def phase_bf16(dev, model, norm_stats) -> tuple:
    """Phase 15, bf16 training: (a) the kernels' bf16 form
    (``phase_bf16_kernels``); (b) ``Trainer`` with the production
    ``TrainingConfig`` (B=24, hidden 256, 6 layers) and a bf16 model for an
    epoch, losses finite, parameters float32, a fixed batch's loss falling
    over its optimizer steps, the step wall and busy share beside the
    float32 model's on the same batch, kernel-path and plain-path gradients
    of the production checkpoint in bf16 (with remat and a float32 control,
    ``model_gradients_agree``), and the saved checkpoint served
    at float32 (``build_service``) for 5 steps against ``device="cpu"``;
    (c) ``python -m nbody_gnn_hpc_torch.train_model`` as three processes at
    once, at its defaults (bf16), with ``--no-bf16`` and with ``--remat``;
    (d) kernel 7's bf16 form: (d1) ``phase_full_bf16_kernels``, (d2)
    ``full_bf16_layer_gradients``, (d3) ``train_full_bf16``, (d4)
    ``train_model --edge-impl fused_full`` as a fourth process beside (c)'s.
    Returns (timed rows, errors, this path's launches, a summary)."""
    import torch

    from nbody_gnn_hpc_torch import generate_data
    from nbody_gnn_hpc_torch.config import TrainingConfig
    from nbody_gnn_hpc_torch.models import NBodyGNN
    from nbody_gnn_hpc_torch.serve import build_service
    from nbody_gnn_hpc_torch.train import (Trainer, datasets_from_manifest,
                                           make_optimizer, make_train_step)
    from nbody_gnn_hpc_torch.train.dataset import MANIFEST_NAME

    with torch.inference_mode():
        rows, errs = phase_bf16_kernels(model, norm_stats, dev)
        # (d1) kernel 7's bf16 form
        full_rows, errs["fused_full_fwd_bf16"] = phase_full_bf16_kernels(
            model, norm_stats, dev)
    rows += full_rows
    # (d2) one layer's gradients in kernel 7's bf16 form
    full_grad_rel = full_bf16_layer_gradients(model, norm_stats, dev)

    # (b) Trainer in bf16 at the production configuration.
    cfg = TrainingConfig()
    shutil.rmtree(BF16_DIR, ignore_errors=True)
    data = BF16_DIR / "data"
    check(generate_data.main([
        "--particles", str(CKPT_DATA["n"]), "--simulations",
        str(CKPT_DATA["n_sims"]), "--steps", str(CKPT_DATA["n_steps"]),
        "--no-windows", "--trajectory-format", "npz", "--device", str(dev),
        "--output-dir", str(data)]) == 0, "generate_data failed")
    train, val = datasets_from_manifest(data / MANIFEST_NAME, k_neighbors=K,
                                        cache=False)
    width = dict(hidden_dim=cfg.hidden_dim, n_layers=cfg.n_layers,
                 dropout=cfg.dropout)
    trainer = Trainer(
        NBodyGNN(dtype=torch.bfloat16, **width), train, val,
        model_dir=str(BF16_DIR / "trainer"), device=dev,
        learning_rate=cfg.learning_rate, batch_size=cfg.batch_size,
        weight_decay=cfg.weight_decay, noise_std=cfg.noise_std, n_epochs=1,
        seed=7)
    val_batches = -(-val.n_samples // cfg.batch_size)
    # main-path run starts here
    _zero_counts()
    history = trainer.train(n_epochs=1, save_every=10)
    launches = _counts()
    # main-path run ends here
    steps = trainer.steps_per_epoch
    want = {"fused_edge_fwd_bf16": 6 * (steps + val_batches),
            "fused_edge_bwd_bf16": 6 * steps}
    got = {k: v for k, v in launches.items() if v}
    print(f"  Trainer, bf16 model, 1 epoch: {steps} steps at B="
          f"{cfg.batch_size} + {val_batches} validation batches; step losses "
          f"{['%.4f' % x for x in trainer.step_losses]}, validation "
          f"{['%.4f' % x for x in history['val_loss']]}; launches {got} "
          f"(expected {want})", flush=True)
    check(got == want, "the bf16 training path's launch counts")
    check(bool(np.isfinite(trainer.step_losses + history["val_loss"]).all()),
          "a bf16 training loss is not finite")
    check(trainer.model.dtype == torch.bfloat16
          and all(p.dtype == torch.float32
                  for p in trainer.model.parameters()),
          "the bf16 model's parameters are not float32")

    # One batch: bf16 and float32 models from the same weights, step walls
    # in turns, a profiled window each; the bf16 loss must fall.
    ids = torch.arange(cfg.batch_size, device=dev)
    s, t = trainer.train_states[ids], trainer.train_targets[ids]
    f32 = NBodyGNN(**width).to(dev)
    f32.load_state_dict(trainer.model.state_dict())
    masses = trainer.masses
    step32 = make_train_step(
        f32, make_optimizer(f32, cfg.learning_rate, cfg.weight_decay),
        trainer.edge_index, trainer.norm_stats["state_mean"],
        trainer.norm_stats["state_std"], (masses / masses.mean())[:, None],
        noise_std=cfg.noise_std, masses=masses)
    steppers = {"bfloat16": trainer._step, "float32": step32}
    with torch.no_grad():
        before = trainer._step.compute_loss(s, t, deterministic=True)[0].item()
    walls = {"bfloat16": [], "float32": []}
    gen = torch.Generator(dev).manual_seed(5)
    for turn in range(2 * BF16_FIXED_STEPS):
        name = ("bfloat16", "float32")[turn // 2 % 2]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steppers[name](s, t, gen)
        torch.cuda.synchronize()
        walls[name].append(time.perf_counter() - t0)
    with torch.no_grad():
        after = trainer._step.compute_loss(s, t, deterministic=True)[0].item()
    summary = {"step_ms": {}, "busy_share": {}}
    for name, w in walls.items():
        summary["step_ms"][name] = float(np.median(w[2:]) * 1e3)
        print(f"  train step wall, {name} (B={cfg.batch_size}, "
              f"synchronised, in turns of two, after 2 warm-up): median "
              f"{summary['step_ms'][name]:.2f} ms, min "
              f"{min(w[2:]) * 1e3:.2f} ms, max {max(w[2:]) * 1e3:.2f} ms",
              flush=True)
        window = {}
        profile_window(f"3 train steps, {name}", lambda: [
            steppers[name](s, t, gen) for _ in range(3)], steps=3,
            out=window)
        summary["busy_share"][name] = window.get("busy_share")
    print(f"  fixed batch, bf16 loss with dropout and noise off: "
          f"{before:.6f} before, {after:.6f} after {BF16_FIXED_STEPS} bf16 "
          f"steps on it", flush=True)
    check(after < before, "bf16 optimizer steps on one batch did not lower "
                          "its loss")
    summary["grad_rel"] = model_gradients_agree(train, cfg, dev,
                                                dtype="bfloat16")

    # The bf16-trained checkpoint served at float32 (config.json says
    # bfloat16, as train_model writes it).
    model_dir = BF16_DIR / "trainer"
    with open(model_dir / "config.json", "w") as f:
        json.dump({"model_type": "gnn", "model_config": {
            **trainer._model_config, "dtype": "bfloat16", "remat": False},
            "training_config": cfg.to_dict()}, f, indent=2)
    served = build_service(str(model_dir / "best_model.pt"),
                           str(model_dir / "config.json"))
    ref = build_service(str(model_dir / "best_model.pt"),
                        str(model_dir / "config.json"), device="cpu")
    check(served.predictor.model.dtype == ref.predictor.model.dtype
          == torch.float32,
          "the bf16-trained checkpoint was not served at float32")
    pos, vel, masses = eval_states(1)
    out = served.rollout(pos[0], vel[0], masses, 5)
    diff, ok = close_to(out["positions"], ref.rollout(
        pos[0], vel[0], masses, 5)["positions"], 1e-4)
    print(f"  served the bf16-trained best_model.pt at float32: 5 steps, "
          f"max abs diff from device='cpu' {diff:.3e} (1e-4 of scale)",
          flush=True)
    check(ok and np.isfinite(out["positions"]).all(),
          "the bf16-trained checkpoint's rollout disagrees with the CPU run")

    # (d3) Trainer with edge_impl="fused_full" in bf16 (kernel 7's bf16
    # form) at the production configuration, on (b)'s data.
    summary["fused_full"] = train_full_bf16(
        dev, cfg, width, train, val, val_batches, (s, t), trainer._step)
    launches = _add(launches, summary["fused_full"].pop("launches"))

    # (c) The command, three processes at once: defaults, --no-bf16 and
    # --remat, one step of B=24 each, then validation; (d4) at once with
    # them, --edge-impl fused_full at its defaults (bf16).
    runs = {"default": [], "no_bf16": ["--no-bf16"], "remat": ["--remat"],
            "fused_full": ["--edge-impl", "fused_full"]}
    argv = ["nbody_gnn_hpc_torch.train_model", "--data-dir", str(data),
            "--epochs", "1", "--max-samples", str(BF16_CLI_SAMPLES)]
    t0 = time.perf_counter()
    outs = _concurrently([
        (lambda name=name, flags=flags: _command(
            argv + ["--model-dir", str(BF16_DIR / name)] + flags,
            BF16_DIR / f"{name}.log")) for name, flags in runs.items()])
    print(f"  train_model x {len(runs)} at once in "
          f"{time.perf_counter() - t0:.1f} s",
          flush=True)
    vb = 6 * val_batches
    want = {"default": {"fused_edge_fwd_bf16": 6 + vb,
                        "fused_edge_bwd_bf16": 6},
            "no_bf16": {"fused_edge_fwd": 6 + vb, "fused_edge_bwd": 6},
            # remat runs each layer's forward again in the backward
            "remat": {"fused_edge_fwd_bf16": 12 + vb,
                      "fused_edge_bwd_bf16": 6},
            "fused_full": {"fused_full_fwd_bf16": 6 + vb,
                           "fused_edge_bwd_bf16": 6}}
    history = {}
    for (name, flags), (out, wall) in zip(runs.items(), outs):
        c = stage_launches(out)
        launches = _add(launches, c)
        model_cfg = json.loads((BF16_DIR / name / "config.json")
                               .read_text())["model_config"]
        history[name] = json.loads((BF16_DIR / name /
                                    "training_history.json").read_text())
        got = {k: v for k, v in c.items() if v}
        print(f"  train_model {' '.join(flags) or '(defaults)'}: {wall:.1f} "
              f"s; config.json dtype {model_cfg['dtype']}, remat "
              f"{model_cfg['remat']}; first step's loss "
              f"{history[name]['train_loss'][0]!r}, validation "
              f"{history[name]['val_loss'][0]!r}; launches {got}", flush=True)
        check(re.search(r"Device:\s+cuda\b", out) is not None,
              f"train_model {name} did not run on cuda")
        check((model_cfg["dtype"], model_cfg["remat"],
               model_cfg["edge_impl"]) == (
            "float32" if name == "no_bf16" else "bfloat16", name == "remat",
            "fused_full" if name == "fused_full" else "fused"),
            f"train_model {name} wrote {model_cfg}")
        check(got == want[name], f"train_model {name} launched {got}, "
                                 f"expected {want[name]}")
    # The flag reaches the model (config.json, the recomputing launches)
    # and changes no loss.  The zero-initialised decoder_out zeroes every
    # gradient upstream of it in a first step, so these losses do not read
    # the recomputed backward: (b) holds remat's gradients to the kernel
    # path's on the production checkpoint.  The run without remat steps
    # through the step's CUDA graph and --remat stays eager, with the same
    # AdamW (make_optimizer's on CUDA).
    same = [history["remat"][key][0] == history["default"][key][0]
            for key in ("train_loss", "val_loss")]
    print(f"  --remat: first step's loss equal to the run without it: "
          f"{same[0]}; validation loss after that step equal: {same[1]} "
          f"({history['remat']['val_loss'][0]!r}; float32: "
          f"{history['no_bf16']['val_loss'][0]!r})", flush=True)
    check(all(same), "--remat changed the first step's loss or its "
                     "validation loss")
    check(all(np.isfinite(history["fused_full"][key][0])
              for key in ("train_loss", "val_loss")),
          "train_model --edge-impl fused_full gave a loss that is not finite")
    summary["cli"] = {name: {"train_loss": h["train_loss"][0],
                             "val_loss": h["val_loss"][0]}
                      for name, h in history.items()}
    summary["full_grad_rel"] = full_grad_rel
    print(json.dumps({"bf16": summary}), flush=True)
    return rows, errs, launches, summary


# Phase 16: GNS (models/gns.py, architecture "gns") and its receiver sum
# (csrc/edge_sum.cu) at the benchmark cell gns-n5000-train-bf16-b2's shape:
# GNS's batch of 2 graphs of N=5,000, k=40, latent 128, 10 message-passing
# steps, bf16 products.
GNS_CONFIG = dict(architecture="gns", latent_size=128, mlp_hidden_size=128,
                  mlp_num_hidden_layers=2, num_message_passing_steps=10,
                  output_dim=6, dtype="bfloat16")
GNS_PARAMETERS = 1_588_998
GNS_B, GNS_N, GNS_K = 2, 5000, 40
GNS_SHAPE = f"B={GNS_B} N={GNS_N} k={GNS_K} F=128"
# Graphed steps: the first eager, the second captured, the rest replays.
GNS_STEPS = 6
# The receiver sum against the plain sum in float64, of the output's scale:
# float32 adds of a target's ~k=40 terms in CSR order (a 40-term float32 sum
# of unit normals is off by a few 1e-7 of its scale).
EDGE_SUM_RTOL_OF_SCALE = 1e-5


def edge_sum_bound_ms(b: int, n: int, e: int, f: int) -> tuple:
    """Least H100 time for one receiver sum: the (b, e, f) float32 messages
    and the target-major CSR (perm (b, e), offsets (b, n + 1), int32) read
    once and the (b, n, f) float32 sums written once, over HBM bandwidth
    (211.6 MB at GNS's shape); one float32 add a message element."""
    n_bytes = 4 * (b * e * f + b * e + b * (n + 1) + b * n * f)
    return _bound(n_bytes, b * e * f)


def phase_gns(dev) -> tuple:
    """Phase 16, GNS's training path.  (a) The receiver sum
    (``ops.receiver_sum``, ``edge_sum`` in ``launch_counts()``) and the
    backward of ``ops.receiver_gather`` (the same kernel) on the card at
    B=2, N=5,000, k=40, F=128 (a k-NN graph of uniform positions in the box
    of 10) against ``receiver_sum_plain`` in float64 within
    ``EDGE_SUM_RTOL_OF_SCALE`` of scale, each call twice and bit-equal;
    the kernel and the gather's forward and backward timed by CUDA events
    beside the plain version's ``scatter_add_`` (float atomics) and the
    bound.  (b) GNS at its published widths
    (1,588,998 parameters) in bf16 through ``make_train_step`` for
    ``GNS_STEPS`` steps at that shape, counts zeroed just before and read
    just after: ``edge_sum`` exactly 20 a step (10 layers forward and
    backward) and no other hand-written kernel; one eager step, one
    capture, then replays; losses finite; the replayed step's wall by CUDA
    events.  Returns (timed rows, the largest error of scale, the steps'
    launches, (a)'s launches, a summary)."""
    import gc

    import torch

    from nbody_gnn_hpc_torch.models import model_from_config
    from nbody_gnn_hpc_torch.ops import (knn_edge_index, receiver_gather,
                                         receiver_sum, receiver_sum_plain,
                                         target_csr)
    from nbody_gnn_hpc_torch.train import make_optimizer, make_train_step

    b, n, k, f = GNS_B, GNS_N, GNS_K, GNS_CONFIG["latent_size"]
    e = n * k
    gen = torch.Generator(dev).manual_seed(2002)
    pos = 10.0 * torch.rand(b, n, 3, generator=gen, device=dev)
    edges = target_csr(knn_edge_index(pos, k), n)
    max_in_degree = int((edges.offsets[:, 1:] - edges.offsets[:, :-1]).max())
    msg = torch.randn(b, e, f, generator=gen, device=dev)
    x = torch.randn(b, n, f, generator=gen, device=dev, requires_grad=True)
    g_edge = torch.randn(b, e, f, generator=gen, device=dev)
    _sync(dev)
    _zero_counts()
    with torch.no_grad():
        sums = [receiver_sum(msg, edges) for _ in range(2)]
    grads = [torch.autograd.grad(receiver_gather(x, edges), x, g_edge)[0]
             for _ in range(2)]
    _sync(dev)
    check(_counts()["edge_sum"] == 4, f"four receiver sums launched "
                                      f"{_counts()['edge_sum']} kernels")
    worst = 0.0
    for name, (got, again), operand in (("receiver_sum", sums, msg),
                                         ("receiver_gather's backward",
                                          grads, g_edge)):
        want = receiver_sum_plain(operand.double(), edges)
        err = ((got.double() - want).abs().max()
               / want.abs().max()).item()
        same = torch.equal(got, again)
        print(f"  {name} {GNS_SHAPE} (largest in-degree {max_in_degree}): "
              f"{err:.3e} of scale from the float64 sum (tolerance "
              f"{EDGE_SUM_RTOL_OF_SCALE:g}), rerun bit-equal: {same}",
              flush=True)
        check(same, f"{name} gave other bits on a second call")
        check(err <= EDGE_SUM_RTOL_OF_SCALE, f"{name} is {err:.3e} of scale "
                                             f"from the float64 sum")
        worst = max(worst, err)
    with torch.no_grad():
        ms = cuda_time_ms(lambda: receiver_sum(msg, edges))
        plain_ms = cuda_time_ms(lambda: receiver_sum_plain(msg, edges))
    gather_ms = cuda_time_ms(lambda: torch.autograd.grad(
        receiver_gather(x, edges), x, g_edge))
    bound = edge_sum_bound_ms(b, n, e, f)
    row = {"kernel": "edge_sum", "form": "training", "B": b, "N": n, "k": k,
           "shape": GNS_SHAPE, "ms": ms, "plain_ms": plain_ms,
           "library_ms": plain_ms, "bound_ms": bound[0],
           "bound_by": bound[1], "gather_and_backward_ms": gather_ms,
           "max_in_degree": max_in_degree}
    print(f"  edge_sum {GNS_SHAPE}: kernel {ms:.5f} ms, receiver_gather "
          f"forward and backward {gather_ms:.5f} ms, plain (scatter_add_, "
          f"float atomics; the library's call) {plain_ms:.5f} ms, bound "
          f"{bound[0]:.6f} ms ({bound[1]}), {100 * bound[0] / ms:.1f} % of "
          f"it", flush=True)
    _sync(dev)
    oracle = _counts()
    del msg, x, g_edge, sums, grads, edges, pos

    model = model_from_config(GNS_CONFIG).to(dev)
    n_params = sum(p.numel() for p in model.parameters())
    check(n_params == GNS_PARAMETERS, f"GNS at the published widths has "
                                      f"{n_params} parameters, expected "
                                      f"{GNS_PARAMETERS}")
    states = 2 * torch.randn(b * GNS_STEPS, n, 6, generator=gen, device=dev)
    targets = states + 0.01 * torch.randn(b * GNS_STEPS, n, 6, generator=gen,
                                          device=dev)
    masses = 1 + torch.rand(n, generator=gen, device=dev)
    edge_index = knn_edge_index(states[0, :, :3], k)
    flat = states.reshape(-1, 6)
    optimizer = make_optimizer(model, 1e-4, 0.0)
    step = make_train_step(model, optimizer, edge_index, flat.mean(0),
                           flat.std(0), (masses / masses.mean())[:, None],
                           noise_std=6.7e-4, masses=masses)
    run_gen = torch.Generator(dev).manual_seed(3)
    _sync(dev)
    _zero_counts()
    losses = [step(states[b * i:b * (i + 1)], targets[b * i:b * (i + 1)],
                   run_gen) for i in range(GNS_STEPS)]
    _sync(dev)
    launched = {key: v for key, v in _counts().items() if v}
    ran = (step.eager_steps, step.captures, step.graph_replays)
    losses = [float(v) for v in losses]
    print(f"  GNS ({n_params:,} parameters, {GNS_CONFIG['dtype']}) through "
          f"make_train_step, "
          f"{GNS_STEPS} steps at {GNS_SHAPE}: launches {launched} (20 a "
          f"step: {launched.get('edge_sum', 0) / GNS_STEPS:g}); eager, "
          f"captures, replays {ran}; losses {losses}", flush=True)
    check(launched == {"edge_sum": 20 * GNS_STEPS},
          f"GNS's steps launched {launched}, expected only edge_sum, 20 a "
          f"step")
    check(ran == (1, 1, GNS_STEPS - 2), f"GNS's step ran (eager, captures, "
                                        f"replays) {ran}")
    check(all(np.isfinite(losses)), "a GNS loss is not finite")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(GNS_STEPS):
        step(states[b * i:b * (i + 1)], targets[b * i:b * (i + 1)], run_gen)
    end.record()
    _sync(dev)
    step_ms = start.elapsed_time(end) / GNS_STEPS
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"  GNS replayed step {step_ms:.3f} ms ({1e3 * b / step_ms:.2f} "
          f"samples/s); the process's peak allocation so far "
          f"{peak / 1e9:.2f} GB", flush=True)
    summary = {"n_params": n_params, "launches": launched, "ran": ran,
               "losses": losses, "step_ms": step_ms, "edge_sum_ms": ms,
               "edge_sum_bound_ms": bound[0], "err_of_scale": worst}
    del step, optimizer, model, states, targets
    gc.collect()
    torch.cuda.empty_cache()
    return [row], worst, launched, oracle, summary


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--full-finetune", action="store_true",
                        help=f"build, simulate the datagen states, then run "
                             f"the production curriculum {FULL_CURRICULUM} "
                             f"from {BASE_MODEL}, evaluate and score the "
                             f"result (instead of phases 3-14)")
    parser.add_argument("--large-n", action="store_true",
                        help="build, then run python -m "
                             "nbody_gnn_hpc_torch.largen_pipeline (N=2,085 "
                             "and 5,000, the production width) on the npz "
                             "store (instead of phases 3-14)")
    parser.add_argument("--gns", action="store_true",
                        help="build, then run phase 16 alone: the receiver "
                             "sum and GNS's graphed training step at B=2, "
                             "N=5,000, k=40 (instead of phases 3-16)")
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
    from nbody_gnn_hpc_torch.ops.cuda_build import (build, build_log,
                                                    library_path)
    t_start = time.perf_counter()

    # 2. Build
    t0 = time.perf_counter()
    sources = ["fused_edge", "fused_edge_bf16", "pairwise", "fused_edge_full",
               "fused_edge_full_bf16", "probes", "edge_sum"]
    built = build(sources)
    print(f"[2] built {sorted(built) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    tensor_core = {}
    for name in sources:
        sass = sass_counts(library_path(name))
        for entry, report in ptxas_report(build_log(name)):
            count, tc = sass.get(entry, ("unknown", "unknown"))
            print(f"    {name}: {entry}: {report}, {count} SASS "
                  f"instructions, {tc} tensor-core (HMMA, HGMMA)",
                  flush=True)
            if name.startswith("fused_edge_full"):
                tensor_core[entry] = tc
    # Kernel 7's products: the bf16 form's on the bf16 tensor cores, the
    # float32 form's on none (float32 FMAs).
    check(bool(tensor_core) and all(
        isinstance(tc, int) and (tc > 0) == entry.endswith(",bf16>")
        for entry, tc in tensor_core.items()),
        f"kernel 7's SASS: the bf16 form must hold tensor-core instructions "
        f"and the float32 form none ({tensor_core})")
    dev = torch.device("cuda")
    if args.gns:
        print("[16] GNS: the receiver sum and the graphed training step",
              flush=True)
        rows, _, _, _, summary = phase_gns(dev)
        print(f"  chip_smoke --gns took {time.perf_counter() - t_start:.1f} "
              f"s after the imports", flush=True)
        print(json.dumps({"gns": summary, "edge_sum": rows[0]}), flush=True)
        print(smi[0], flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": dev_name,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if args.large_n:
        print("[14] the large-N pipeline: largen_pipeline --trajectory-format "
              "npz", flush=True)
        summary = large_n()
        print(f"  chip_smoke --large-n took "
              f"{time.perf_counter() - t_start:.1f} s after the imports",
              flush=True)
        print(json.dumps({"large_n": summary}), flush=True)
        print(smi[0], flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": dev_name,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
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

    clock = [time.perf_counter()]

    def took(phase):  # the phase that started at the last mark
        now = time.perf_counter()
        print(f"  phase {phase} took {now - clock[0]:.1f} s", flush=True)
        clock[0] = now

    # 3. Kernels against their plain versions
    print("[3] kernels vs plain versions on the card", flush=True)
    with open(CONFIG) as f:
        cfg = json.load(f)["model_config"]
    model = model_from_config(cfg, dtype_override="float32").to(dev).eval()
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

    took(3)

    # 4. Serving main path
    print("[4] serving the production checkpoint", flush=True)
    service, serve_fwd, traj20 = path("serving", phase_serving, dev_name)
    took(4)

    # 5. Where the serving time goes
    print("[5] profile", flush=True)
    path("serving", phase_profile, service)
    took(5)

    # 6. Training main path
    print("[6] training the production-width model", flush=True)
    train_fwd, train_bwd = path("training", phase_train, dev)
    took(6)

    # 7. The simulator side, the third main path
    print("[7] the simulator side: datagen, large-N /simulate, evaluation",
          flush=True)
    sim, oracle, states, sim_masses = path("simulator", phase_simulator,
                                           service, dev)
    took(7)

    # 8. Serving as it is deployed, the fourth main path
    print("[8] serving as deployed: fused_full behind the pool, the "
          "micro-batcher and the gate; quantization", flush=True)
    deployed = path("deployed", phase_deployed, dev_name, service, traj20)
    took(8)

    # 9. The card's ceilings, the fifth main path
    print("[9] the card's ceilings: kernels 10 and 11, python -m "
          "nbody_gnn_hpc_torch.roofline in process", flush=True)
    probe_rows, probe_errs, ceilings = path("ceilings", phase_ceilings, dev)
    took(9)

    # 10. The rollout fine-tune and checkpoint selection, the sixth path
    print("[10] rollout fine-tune and checkpoint selection", flush=True)
    finetune = path("finetune", phase_finetune, states, sim_masses, dev)
    del states
    took(10)

    # 11. The one-command pipeline, the seventh main path: each stage is a
    # process whose counts start at 0 and which prints them last.
    print("[11] the one-command pipeline: run_demo --production on the npz "
          "store", flush=True)
    pipeline = phase_pipeline()
    mxu_by_path["pipeline"] = pipeline["pairwise_symmetric_mxu"]
    took(11)

    # 12. Data parallel and the simulator surface (and the GNN above
    # N = 2,048): each drive's counts zeroed just before and read after,
    # the two spawned ranks' read in their processes.
    print("[12] data parallel and the simulator surface", flush=True)
    t12 = time.perf_counter()
    parallel = phase_parallel(dev)
    surface = phase_simulator_surface(dev)
    surrogate = phase_surrogate_large_n(dev)
    # Their drives zero every count (kernel 5's too): its count on each
    # path is the sum of the drives' windows, as for the pipeline.
    for name, launched in (("parallel", parallel),
                           ("simulator_surface", surface),
                           ("surrogate_large_n", surrogate)):
        mxu_by_path[name] = launched.get("pairwise_symmetric_mxu", 0)
    print(f"  phase 12 took {time.perf_counter() - t12:.1f} s", flush=True)

    # 13. Async training checkpoints, the plots and the viewer: the
    # drives' counts zeroed just before and read after, the two train_model
    # processes' read from their launch lines.
    print("[13] async checkpoints (ckpt_backend orbax), resume, plots, the "
          "galaxy demo and the HTML viewer", flush=True)
    t13 = time.perf_counter()
    checkpoint = phase_checkpoint(dev)
    mxu_by_path["checkpoint"] = checkpoint.get("pairwise_symmetric_mxu", 0)
    print(f"  phase 13 took {time.perf_counter() - t13:.1f} s", flush=True)

    # 14. The six commands ported last, each a process whose counts start
    # at 0 and which prints them last.
    print("[14] the last commands: benchmark_bh_temp, demo_surrogate, "
          "merge_dataset, demo_serving, demo_parallel", flush=True)
    t14 = time.perf_counter()
    commands = phase_commands()
    mxu_by_path["commands"] = commands.get("pairwise_symmetric_mxu", 0)
    print(f"  phase 14 took {time.perf_counter() - t14:.1f} s", flush=True)

    # 15. bf16 training, the production recipe's precision: the bf16 forms
    # of kernels 1, 2 and 7 against their plain versions, bf16 Trainers
    # and the train_model command (counts zeroed just before each drive).
    print("[15] bf16 training: the bf16 stream of kernels 1 and 2, kernel "
          "7's bf16 form, Trainer in bf16 (fused and fused_full), "
          "train_model --no-bf16 / --remat / --edge-impl fused_full",
          flush=True)
    t15 = time.perf_counter()
    bf16_rows, bf16_errs, bf16, bf16_summary = phase_bf16(dev, model,
                                                          norm_stats)
    mxu_by_path["bf16"] = bf16.get("pairwise_symmetric_mxu", 0)
    print(f"  phase 15 took {time.perf_counter() - t15:.1f} s", flush=True)

    # 16. GNS, the second architecture: its receiver sum against the plain
    # sum, then its graphed training step (counts zeroed just before).
    print("[16] GNS: the receiver sum and the graphed training step",
          flush=True)
    t16 = time.perf_counter()
    gns_rows, gns_err, gns, gns_oracle, _ = phase_gns(dev)
    mxu_by_path["gns"] = gns.get("pairwise_symmetric_mxu", 0)
    print(f"  phase 16 took {time.perf_counter() - t16:.1f} s", flush=True)
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
            ("fused_edge_fwd_bf16", "fused_edge_bf16",
             "nbody_gnn_hpc_tpu/ops/fused_edge.py:91 with cd = bfloat16 "
             "(:184; and ops/fused_edge_batched.py:91)", None, bf16_rows,
             bf16_errs),
            ("fused_edge_bwd_bf16", "fused_edge_bf16",
             "nbody_gnn_hpc_tpu/ops/fused_edge.py:114 with cd = bfloat16 "
             "(:184; and ops/fused_edge_batched.py:123)", None, bf16_rows,
             bf16_errs),
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
            ("fused_full_fwd_bf16", "fused_edge_full_bf16",
             "nbody_gnn_hpc_tpu/ops/fused_edge_full.py:78 with cd = "
             "bfloat16 (:158)", None, bf16_rows, bf16_errs),
            ("pairwise_symmetric_mxu", "pairwise",
             "nbody_gnn_hpc_tpu/ops/pairwise.py:291", f"N={LARGE_N}",
             force_rows, force_errs),
            ("probe_fma", "probes", "benchmarks/roofline.py:184",
             probe_rows[0]["shape"], probe_rows, probe_errs),
            ("probe_rsqrt", "probes", "benchmarks/roofline.py:214",
             probe_rows[1]["shape"], probe_rows, probe_errs),
            ("edge_sum", "edge_sum",
             "none: the JAX package has no model with per-edge latents",
             GNS_SHAPE, gns_rows, {"edge_sum": gns_err})):
        mine = [r for r in kernel_rows if r["kernel"] == name]
        if shape is None:  # the bf16 and edge kernels: training at B=24
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
                 "pipeline": pipeline.get(name, 0),
                 "parallel": parallel.get(name, 0),
                 "simulator_surface": surface.get(name, 0),
                 "surrogate_large_n": surrogate.get(name, 0),
                 "checkpoint": checkpoint.get(name, 0),
                 "commands": commands.get(name, 0),
                 "bf16": bf16.get(name, 0),
                 "gns": gns.get(name, 0),
                 "oracle": oracle.get(name, 0) + gns_oracle.get(name, 0)}
        if name == "pairwise_symmetric_mxu":
            paths = {key: mxu_by_path.get(key, 0) for key in paths}
        table["kernels"].append({
            "name": name, "route": "cuda",
            "source": f"nbody_gnn_hpc_torch/csrc/{source}.cu",
            "replaces": replaces, "launches": sum(paths.values()),
            "launches_by_path": paths, "max_abs_err": err[name],
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row.get("library_ms"), "shape": shape,
            "by_shape": mine,
            **({"composed_ms": row["composed_ms"]}
               if "composed_ms" in row else {}),
            **({"ms_float32": row["ms_float32"]}
               if "ms_float32" in row else {})})
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
    check(min(pipeline[k] for k in ("fused_edge_fwd", "fused_edge_bwd",
                                    "pairwise_small")) > 0,
          "the pipeline launched no kernel 1, 2 or 4")
    check(min(parallel.get(k, 0) for k in (
        "fused_edge_fwd", "fused_edge_bwd", "fused_full_fwd",
        "pairwise_small")) > 0, "data parallel launched no kernel 1, 2, 4 "
                                "or 7")
    check(min(surface.get(k, 0) for k in ("pairwise_small",
                                          "pairwise_symmetric")) > 0,
          "the simulator surface launched no kernel 4 or 6")
    check(min(checkpoint.get(k, 0) for k in ("fused_edge_fwd",
                                             "fused_edge_bwd")) > 0,
          "the checkpoint path launched no kernel 1 or 2")
    check(min(commands.get(k, 0) for k in (
        "fused_edge_fwd", "fused_edge_bwd", "pairwise_small",
        "pairwise_symmetric")) > 0, "the last commands launched no kernel "
                                    "1, 2, 4 or 6")
    check(min(p.get(k, 0) for p in (pipeline, checkpoint, bf16)
              for k in ("fused_edge_fwd_bf16", "fused_edge_bwd_bf16")) > 0,
          "the pipeline's, train_model's or the bf16 path's training "
          "launched no bf16 kernel 1 or 2")
    check(bf16.get("fused_full_fwd_bf16", 0) > 0, "the bf16 path launched "
                                                  "no bf16 kernel 7")
    check(gns.get("edge_sum", 0) == 20 * GNS_STEPS, "the GNS path did not "
                                                    "launch edge_sum 20 "
                                                    "times a step")
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
