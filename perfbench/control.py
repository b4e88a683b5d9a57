"""The readings the limits of ``correct`` are set from, on the card, in one
process: the program's numbers over many seeds (the lower readings), the
control's (the reference in the program's place at the precision below
the configuration's: int8 products for bf16 training, TF32 for float32
serving; the upper readings), and the program's with a fault planted.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3
        [--control-seeds 1,2,3] [--faults frozen,half_batch]
        [--fault-seeds 1,2,3] [--seconds 6]

Training cells (whose driver defines ``reference_readings``,
:mod:`perfbench.drivers`) need no window: set-up drives the step through
the first steps the reference follows, through the cell's own driver.
Serving cells run a short window of the cell's own traffic a seed through
one service.  Prints one JSON line a reading.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CONTROL_PREC = {"bfloat16": "int8", "float32": "tf32"}


def _ints(text):
    return [int(x) for x in text.split(",") if x] if text else []


def emit(**row):
    print(json.dumps(row, default=str), flush=True)


def train_readings(cell, args, device):
    drv = cell.driver()
    prec = cell.config["model_config"]["dtype"]
    for seed in sorted(set(args.seeds) | set(args.control_seeds)
                       | set(args.fault_seeds)):
        t = time.perf_counter()
        state = drv.setup(cell, seed, device)
        drv.release(state)
        ref = drv.reference_readings(state, prec)
        if seed in args.seeds:
            emit(kind="program", seed=seed,
                 **drv.compare(state["program"], ref),
                 seconds=time.perf_counter() - t)
        if seed in args.control_seeds:
            low = drv.reference_readings(state, CONTROL_PREC[prec])
            emit(kind="control", seed=seed, **drv.compare(low, ref))
        if seed in args.fault_seeds:
            for fault in args.faults:
                bad = drv.setup(cell, seed, device, fault=fault)
                drv.release(bad)
                emit(kind=f"fault:{fault}", seed=seed,
                     **drv.compare(bad["program"], ref))
        del state


def serve_readings(cell, args, device):
    from perfbench.drivers import serving

    driver = cell.driver()
    state = serving.setup(cell, 0, device)
    services = serving._services(state["service"])
    plain = {id(s): s.rollout_batch for s in services}
    prec = "float32"
    seeds = sorted(set(args.seeds) | set(args.control_seeds)
                   | set(args.fault_seeds))
    for seed in seeds:
        if seed in args.control_seeds:
            emit(kind="control", seed=seed, **control_gaps(state, seed))
        runs = [None] if seed in args.seeds else []
        runs += args.faults if seed in args.fault_seeds else []
        for fault in runs:
            for s in services:
                s.rollout_batch = plain[id(s)]
                serving._plant(s, fault)
            state["seed"] = seed
            record = driver.window(state, args.seconds, None)
            ref = serving.reference_outputs(state, prec)
            gaps = serving.rollout_gaps(state, ref)
            metric = {k: v for k, v in record.items()
                      if isinstance(v, (int, float))}
            emit(kind="program" if fault is None else f"fault:{fault}",
                 seed=seed, **gaps, **metric)
    serving.release(state)


def control_gaps(state, seed):
    """The control in the program's place: the first ``check_sample``
    requests of the seed's mix rolled out by the reference at TF32, as if
    they had been answered, against the reference at float32.  It needs no
    window: the answers are the reference's own."""
    from perfbench.drivers import loadgen, serving

    state["seed"] = seed
    want = int(state["cell"].traffic["check_sample"])
    state["records"] = [loadgen.Record(i, 0.0) for i in range(want)]
    for rec in state["records"]:
        rec.status = 200
    ref = serving.reference_outputs(state, "float32")
    low = serving.reference_outputs(state, CONTROL_PREC["float32"])
    for rec in state["records"]:
        rec.positions, rec.velocities = low[rec.index]
    return serving.rollout_gaps(state, ref)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--faults", type=lambda s: s.split(",") if s else [],
                    default=[])
    ap.add_argument("--fault-seeds", type=_ints, default=[])
    ap.add_argument("--seconds", type=float, default=6.0)
    args = ap.parse_args(argv)
    import torch

    from perfbench import drivers, harness

    cell = harness.Cell(harness.load_manifest(), args.workload)
    device = torch.device("cuda")
    if drivers.is_training(cell.driver()):
        train_readings(cell, args, device)
    else:
        serve_readings(cell, args, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
