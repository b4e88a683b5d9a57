"""Time the edge-stream kernels (kernels 1 and 2), the direct-force
kernels (kernels 3, 4, 5 and 6) and the whole-layer kernel (kernel 7) of
two checkouts on one card.

    python -m nbody_gnn_hpc_torch.compare_checkouts --other DIR \
        [--kernels edge|force|full|all]

DIR is another checkout of this repository (for example the parent commit
unpacked with ``git archive`` into a git-ignored directory).  Each turn is
one process started in a checkout's root: it builds that checkout's
sources of the selected group, reports the compiler's registers and spills
for every kernel in them, and times that checkout's kernels with
``roofline.cuda_time_ms``.  Turns run other, this, this, other, so a drift
of the card over the call falls on both alike.  Prints one line per turn
and, last, a JSON object with every turn's times.  Needs a CUDA device.

``edge`` (``csrc/fused_edge.cu``): ``fused_edge_layer`` (kernel 1) and
``fused_edge_backward`` (kernel 2) on the production checkpoint's layer-0
operands (``chip_smoke.edge_layer_inputs``), N=200, k=40: kernel 1 at the
five shapes of the main paths, B=1, 8, 10 inference and B=1, 24 training
(dropout 0.1); kernel 2 in training form (dropout 0.1, no ``d_edge_attr``)
at B=1 and 24 and in the rollout fine-tune's form (no dropout, with
``d_edge_attr``) at B=8, on one upstream gradient per batch drawn from a
fixed seed, with the device time of each of its launches
(``roofline.kernel_times_ms``, this checkout's, in both turns).

``force`` (``csrc/pairwise.cu``): ``accelerations_small`` (kernel 4) on
datagen ensembles (``parallel.build_ensemble_state``, ``sim.
shared_masses``, ``chip_smoke.DATAGEN``) of 300, 100 (the ``generate_data``
default batch) and 1 systems of N=200, and ``accelerations_symmetric``
(kernel 6), ``accelerations_tiled`` (kernel 3) and
``accelerations_symmetric_mxu`` (kernel 5, the call as a caller runs it,
its centring included) on the evaluation-protocol systems
(``chip_smoke.protocol_system``) of N=10,000 and 2,085 (``LARGE_N``,
``ODD_N``); kernels 6 and 5 with the device time of each of their
launches.

``full`` (``csrc/fused_edge_full.cu`` and ``fused_edge_full_bf16.cu``):
``fused_full_layer`` (kernel 7) in its bf16 form (wt and ws bf16) on the
production checkpoint's layer-0 operands (``chip_smoke.full_layer_inputs``),
N=200, k=40, inference at B=1 and 8, training (dropout 0.1, the node mask
of ``chip_smoke``) at B=24: the call, each launch by torch.profiler (the
kernel alone), each phase alone through the ordinary-launch form
(``PHASE_ALONE``; each phase reads the scratch the whole-layer call before
it wrote, where the caching allocator hands the same blocks back); the
float32 form's call and the SHA-256 of its h_new and summed (the bytes of
both), which two checkouts that share the float32 form's design give
alike; and the composed bf16 layer (the bf16 model's ``fused`` layer 0:
bf16 cuBLAS projections, kernel 1's bf16 form, the node side in PyTorch)
on the same operands, two calls a timing so the host keeps up.
"""

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path

from nbody_gnn_hpc_torch.ops.cuda_build import build_log
from nbody_gnn_hpc_torch.roofline import kernel_times_ms

ROOT = Path(__file__).resolve().parents[1]
SHAPES = (("inference", 1), ("inference", 8), ("inference", 10),
          ("training", 1), ("training", 24))
FULL_SHAPES = (("inference", 1), ("inference", 8), ("training", 24))
BWD_SHAPES = (("training", 1), ("training", 24), ("fine-tune", 8))
ENSEMBLES = (300, 100, 1)  # kernel 4's systems of N=200

# Each turn runs in a checkout's root, with only what every checkout since
# kernel 7's redesign has: chip_smoke's operands and constants, the
# compiler report, the roofline timer, the simulator's ensemble builder;
# this checkout's build_log and kernel_times_ms are prepended.
_HEAD = """
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from nbody_gnn_hpc_torch.ops.cuda_build import build, library_path
from nbody_gnn_hpc_torch.roofline import cuda_time_ms
regs, rows = [], []
built = build(SOURCES)
for src in SOURCES:
    log = built.get(src, {}).get("log") or build_log(src)
    regs += [f"{src} {name}: {report}"
             for name, report in cs.ptxas_report(log)]
dev = torch.device("cuda")
"""
_EDGE = """
from nbody_gnn_hpc_torch.io import load_checkpoint, load_into
from nbody_gnn_hpc_torch.models import model_from_config
from nbody_gnn_hpc_torch.ops import fused_edge_backward, fused_edge_layer
with open(cs.CONFIG) as f:  # float32 in every checkout, whatever it reads
    model = model_from_config({**json.load(f)["model_config"],
                               "dtype": "float32"}).to(dev).eval()
stats = load_into(model, load_checkpoint(cs.MODEL))
seed = torch.tensor([cs.DROP_SEED], dtype=torch.int32, device=dev)
with torch.inference_mode():
    for form, b in SHAPES:
        args = cs.edge_layer_inputs(model, stats, b, cs.N, cs.K, dev)
        sd, p = (seed, cs.DROPOUT_P) if form == "training" else (None, 0.0)
        fn = lambda: fused_edge_layer(*args, sd, dropout_p=p,
                                      deterministic=sd is None)
        fn()
        torch.cuda.synchronize()
        rows.append({"kernel": 1, "form": f"{form} B={b}",
                     "ms": cuda_time_ms(fn),
                     "bound_ms": cs.edge_bound_ms(args, sd is not None)[0]})
    for form, b in BWD_SHAPES:
        args = cs.edge_layer_inputs(model, stats, b, cs.N, cs.K, dev)
        g_out = torch.randn(args[0].shape, device=dev,
                            generator=torch.Generator(dev).manual_seed(b))
        sd, p = (seed, cs.DROPOUT_P) if form == "training" else (None, 0.0)
        fn = lambda: fused_edge_backward(*args, g_out, sd, p,
                                         need_d_edge_attr=form != "training")
        fn()
        torch.cuda.synchronize()
        rows.append({"kernel": 2, "form": f"{form} B={b}",
                     "ms": cuda_time_ms(fn), "passes": kernel_times_ms(fn)})
"""
_FORCE = """
from nbody_gnn_hpc_torch import ops
from nbody_gnn_hpc_torch.parallel import build_ensemble_state
from nbody_gnn_hpc_torch.sim import shared_masses
d = cs.DATAGEN
masses = shared_masses(d["n"], seed=d["seed"])
with torch.inference_mode():
    for b in ENSEMBLES:
        state = build_ensemble_state(
            [d["seed"] + i for i in range(b)], d["n"], d["box"], masses,
            device=dev, accel_fn=lambda p, m: torch.zeros_like(p))
        fn = lambda: ops.accelerations_small(state.positions, state.masses)
        fn()
        torch.cuda.synchronize()
        rows.append({"kernel": 4, "form": f"B={b} N={d['n']}",
                     "ms": cuda_time_ms(fn)})
    for n in (cs.LARGE_N, cs.ODD_N):
        pos, _, m = cs.protocol_system(n, dev)
        fn = lambda: ops.accelerations_symmetric(pos, m)
        fn()
        torch.cuda.synchronize()
        rows.append({"kernel": 6, "form": f"N={n}", "ms": cuda_time_ms(fn),
                     "passes": kernel_times_ms(fn)})
        fn = lambda: ops.accelerations_tiled(pos, m)
        fn()
        torch.cuda.synchronize()
        rows.append({"kernel": 3, "form": f"N={n}", "ms": cuda_time_ms(fn)})
        fn = lambda: ops.accelerations_symmetric_mxu(pos, m)
        fn()
        torch.cuda.synchronize()
        rows.append({"kernel": 5, "form": f"N={n}", "ms": cuda_time_ms(fn),
                     "passes": kernel_times_ms(fn)})
"""
_FULL = """
import copy
import hashlib
from nbody_gnn_hpc_torch.io import load_checkpoint, load_into
from nbody_gnn_hpc_torch.models import model_from_config
from nbody_gnn_hpc_torch.ops import fused_edge_full as ff
with open(cs.CONFIG) as f:
    model = model_from_config({**json.load(f)["model_config"],
                               "dtype": "float32"}).to(dev).eval()
stats = load_into(model, load_checkpoint(cs.MODEL))
seed = torch.tensor([cs.DROP_SEED], dtype=torch.int32, device=dev)
layer16 = copy.deepcopy(model.layers[0])  # the composed bf16 layer
layer16.dtype = layer16.node_mlp.dtype = torch.bfloat16
layer16.edge_impl = "fused"
gen = torch.Generator(dev)
with torch.inference_mode():
    for form, b in FULL_SHAPES:
        h, ea, p, edges = cs.full_layer_inputs(model, stats, b, cs.N, cs.K,
                                               dev)
        p16 = dict(p, wt=p["wt"].bfloat16(), ws=p["ws"].bfloat16())
        mask = (torch.rand(h.shape, device=dev,
                           generator=torch.Generator(dev).manual_seed(b))
                >= cs.DROPOUT_P).float() / (1 - cs.DROPOUT_P)
        sd, mk, rate = ((seed, mask, cs.DROPOUT_P) if form == "training"
                        else (None, None, 0.0))
        run = lambda q: ff.fused_full_layer(h, ea, q, edges, sd, mk,
                                            dropout_p=rate,
                                            deterministic=sd is None)
        fn = lambda: run(p16)
        fn()
        torch.cuda.synchronize()
        phase_ms = []
        for alone in range(1, ff.PHASES + 1):
            ff.PHASE_ALONE = alone
            try:
                phase_ms.append(cuda_time_ms(fn))
            finally:
                ff.PHASE_ALONE = None
        out, summed = ff._launch(h, ea, p, edges, sd, mk, rate)
        digest = hashlib.sha256(out.cpu().numpy().tobytes()
                                + summed.cpu().numpy().tobytes()).hexdigest()
        layer16.train(form == "training")
        composed_ms = cuda_time_ms(
            lambda: layer16(h, ea, edges, edges.degree, gen), inner=2)
        layer16.eval()
        rows.append({"kernel": 7, "form": f"bf16 {form} B={b}",
                     "ms": cuda_time_ms(fn), "passes": kernel_times_ms(fn),
                     "phase_ms": phase_ms,
                     "float32_ms": cuda_time_ms(lambda: run(p)),
                     "float32_sha256": digest,
                     "composed_bf16_ms": composed_ms})
"""
GROUPS = {"edge": (("fused_edge",), _EDGE),
          "force": (("pairwise",), _FORCE),
          "full": (("fused_edge_full", "fused_edge_full_bf16"), _FULL)}


def run_turn(checkout: Path, groups) -> dict:
    """One turn of the kernel ``groups`` in ``checkout``'s root; its JSON
    line."""
    code = (f"SHAPES = {SHAPES!r}\nBWD_SHAPES = {BWD_SHAPES!r}\n"
            f"ENSEMBLES = {ENSEMBLES!r}\nFULL_SHAPES = {FULL_SHAPES!r}\n"
            f"SOURCES = {[s for g in groups for s in GROUPS[g][0]]!r}\n"
            + inspect.getsource(build_log)
            + inspect.getsource(kernel_times_ms) + _HEAD
            + "".join(GROUPS[g][1] for g in groups)
            + 'print(json.dumps({"registers": regs, "rows": rows}))\n')
    out = subprocess.run([sys.executable, "-c", code], cwd=checkout,
                         capture_output=True, text=True, check=False)
    if out.returncode != 0:
        raise RuntimeError(f"turn in {checkout} failed (exit "
                           f"{out.returncode}):\n{out.stdout}\n{out.stderr}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="root of the other checkout")
    ap.add_argument("--kernels", choices=("edge", "force", "full", "all"),
                    default="all", help="kernels 1 and 2 (edge), 3, 4, 5 and 6 "
                    "(force), 7 (full), or all three")
    args = ap.parse_args(argv)
    groups = tuple(GROUPS) if args.kernels == "all" else (args.kernels,)
    turns = []
    for name, path in (("other", args.other), ("this", ROOT), ("this", ROOT),
                       ("other", args.other)):
        result = run_turn(path.resolve(), groups)
        turns.append({"checkout": name, **result})
        times = ", ".join(
            f"kernel {r['kernel']} {r['form']} {r['ms']:.5f}"
            + "".join(f" ({k} {t:.5f})" for k, t in r.get("passes", {}).items())
            + (f" phases {' '.join(f'{t:.5f}' for t in r['phase_ms'])}"
               f" float32 {r['float32_ms']:.5f} sha256 "
               f"{r['float32_sha256'][:16]} composed bf16 "
               f"{r['composed_bf16_ms']:.5f}" if "phase_ms" in r else "")
            for r in result["rows"])
        print(f"{name}: {times} ms", flush=True)
    for name in ("other", "this"):
        regs = next((t["registers"] for t in turns
                     if t["checkout"] == name and t["registers"]), [])
        for line in regs:
            print(f"{name} build: {line}", flush=True)
    print(json.dumps({"turns": turns}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
