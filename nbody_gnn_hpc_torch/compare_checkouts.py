"""Time the edge-stream kernels (kernels 1 and 2) of two checkouts on one
card.

    python -m nbody_gnn_hpc_torch.compare_checkouts --other DIR

DIR is another checkout of this repository (for example the parent commit
unpacked with ``git archive`` into a git-ignored directory).  Each turn is
one process started in a checkout's root: it builds that checkout's
``csrc/fused_edge.cu``, reports the compiler's registers and spills for
every kernel in it, and times that checkout's ``fused_edge_layer`` (kernel
1) and ``fused_edge_backward`` (kernel 2) with ``roofline.cuda_time_ms`` on
the production checkpoint's layer-0 operands (``chip_smoke.
edge_layer_inputs``), N=200, k=40: kernel 1 at the five shapes of the main
paths, B=1, 8, 10 inference and B=1, 24 training (dropout 0.1); kernel 2
in training form (dropout 0.1, no ``d_edge_attr``) at B=1 and 24 and in
the rollout fine-tune's form (no dropout, with ``d_edge_attr``) at B=8, on
one upstream gradient per batch drawn from a fixed seed, with the device
time of each of its launches (``roofline.kernel_times_ms``, this
checkout's, in both turns).  Turns run other,
this, this, other, so a drift of the card over the call falls on both
alike.  Prints one line per turn and, last, a JSON object with every
turn's times.  Needs a CUDA device.
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
BWD_SHAPES = (("training", 1), ("training", 24), ("fine-tune", 8))

# Runs in a checkout's root, with only what every checkout since kernel 7's
# redesign has: chip_smoke's operands, kernel 1's bound and the compiler
# report, the roofline timer; this checkout's build_log and kernel_times_ms
# are prepended.
_TURN = """
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from nbody_gnn_hpc_torch.io import load_checkpoint, load_into
from nbody_gnn_hpc_torch.models import model_from_config
from nbody_gnn_hpc_torch.ops import fused_edge_backward, fused_edge_layer
from nbody_gnn_hpc_torch.ops.cuda_build import build, library_path
from nbody_gnn_hpc_torch.roofline import cuda_time_ms
log = (build(["fused_edge"]).get("fused_edge", {}).get("log")
       or build_log("fused_edge"))  # or built before this turn
regs = [f"{name}: {report}" for name, report in cs.ptxas_report(log)]
dev = torch.device("cuda")
with open(cs.CONFIG) as f:
    model = model_from_config(json.load(f)["model_config"]).to(dev).eval()
stats = load_into(model, load_checkpoint(cs.MODEL))
seed = torch.tensor([cs.DROP_SEED], dtype=torch.int32, device=dev)
rows = []
with torch.inference_mode():
    for form, b in SHAPES:
        args = cs.edge_layer_inputs(model, stats, b, cs.N, cs.K, dev)
        sd, p = (seed, cs.DROPOUT_P) if form == "training" else (None, 0.0)
        fn = lambda: fused_edge_layer(*args, sd, dropout_p=p,
                                      deterministic=sd is None)
        fn()
        torch.cuda.synchronize()
        rows.append({"kernel": 1, "form": form, "B": b, "ms": cuda_time_ms(fn),
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
        rows.append({"kernel": 2, "form": form, "B": b,
                     "ms": cuda_time_ms(fn), "passes": kernel_times_ms(fn)})
print(json.dumps({"registers": regs, "rows": rows}))
"""


def run_turn(checkout: Path) -> dict:
    """One turn in ``checkout``'s root; its JSON line."""
    code = (f"SHAPES = {SHAPES!r}\nBWD_SHAPES = {BWD_SHAPES!r}\n"
            + inspect.getsource(build_log)
            + inspect.getsource(kernel_times_ms) + _TURN)
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
    args = ap.parse_args(argv)
    turns = []
    for name, path in (("other", args.other), ("this", ROOT), ("this", ROOT),
                       ("other", args.other)):
        result = run_turn(path.resolve())
        turns.append({"checkout": name, **result})
        times = ", ".join(
            f"kernel {r['kernel']} {r['form']} B={r['B']} {r['ms']:.5f}"
            + "".join(f" ({k} {t:.5f})" for k, t in r.get("passes", {}).items())
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
