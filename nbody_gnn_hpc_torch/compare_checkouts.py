"""Time the edge-stream forward (kernel 1) of two checkouts on one card.

    python -m nbody_gnn_hpc_torch.compare_checkouts --other DIR

DIR is another checkout of this repository (for example the parent commit
unpacked with ``git archive`` into a git-ignored directory).  Each turn is
one process started in a checkout's root: it builds that checkout's
``csrc/fused_edge.cu``, prints the compiler's register and spill lines, and
times that checkout's ``fused_edge_layer`` with
``roofline.cuda_time_ms`` on the production checkpoint's layer-0 operands
(``chip_smoke.edge_layer_inputs``) at the five shapes of the main paths:
B=1, 8, 10 inference and B=1, 24 training (dropout 0.1), N=200, k=40.
Turns run other, this, this, other, so a drift of the card over the
call falls on both alike.  Prints one line per turn and, last, a
JSON object with every turn's times.  Needs a CUDA device.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = (("inference", 1), ("inference", 8), ("inference", 10),
          ("training", 1), ("training", 24))

# Runs in a checkout's root, with only what every checkout since kernel 7's
# redesign has: chip_smoke's operands and bound, the roofline timer.
_TURN = """
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from nbody_gnn_hpc_torch.io import load_checkpoint, load_into
from nbody_gnn_hpc_torch.models import model_from_config
from nbody_gnn_hpc_torch.ops import fused_edge_layer
from nbody_gnn_hpc_torch.ops.cuda_build import build
from nbody_gnn_hpc_torch.roofline import cuda_time_ms
log = build(["fused_edge"]).get("fused_edge", {}).get("log", "")
regs = [l.strip() for l in log.splitlines()
        if "entry function" in l or "registers" in l or "spill" in l]
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
        rows.append({"form": form, "B": b, "ms": cuda_time_ms(fn),
                     "bound_ms": cs.edge_bound_ms(args, sd is not None)[0]})
print(json.dumps({"registers": regs, "rows": rows}))
"""


def run_turn(checkout: Path) -> dict:
    """One turn in ``checkout``'s root; its JSON line."""
    code = f"SHAPES = {SHAPES!r}\n" + _TURN
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
        times = ", ".join(f"{r['form']} B={r['B']} {r['ms']:.5f}"
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
