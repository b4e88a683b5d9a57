"""The large-N surrogate pipeline: datagen -> train -> evaluate at
Barnes-Hut-regime N on the production architecture (port of
``scripts/largen_pipeline.sh``).

    python -m nbody_gnn_hpc_torch.largen_pipeline [WORKDIR]
        [--trajectory-format h5|npz]
    ... --device cpu   # the CPU, asked for

Two scales, the script's own, cut in sims, steps and epochs (not in width:
hidden 256, 6 layers, k=40, the physics loss):

- N=2,085, 6 sims x 120 steps, 3 epochs at batch 4, 2 test sims: just above
  every blocked cut-off (``KNN_DENSE_MAX`` = ``PALLAS_MIN_N`` = 2,048), odd
  N;
- N=5,000, 3 sims x 60 steps, 2 epochs at batch 2, 1 test sim: the
  reference's own Barnes-Hut benchmark scale.

Each stage is the port's command in a process of its own, run in
``WORKDIR/n<N>`` (default ``runs_largen``, relative to the current
directory) with ``--watchdog 2400``.  After each the command prints
``STAGE_WALL <stage> n=<N> <s> s``, after each scale ``LARGEN_RESULT
n=<N> posRMSE=... velRMSE=... energy_err=...`` from
``results/evaluation_results.json``.  ``--trajectory-format h5`` (the
default) writes the script's lzf-compressed windowed HDF5 datasets;
``npz`` writes the npz trajectory store with ``--no-windows`` and the
manifest, which needs no h5py.  On the card the datagen and the ground
truth run the symmetric force kernel and training and evaluation the
edge-stream kernels.  The stages' kernel launches, summed, are printed
last.
"""

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Dict, Optional

from nbody_gnn_hpc_torch.io.checkpoint import TRAJECTORY_FORMATS

WATCHDOG_S = "2400"
# (N, sims, steps, epochs, batch size, test sims), the script's order.
SCALES = ((2085, 6, 120, 3, 4, 2), (5000, 3, 60, 2, 2, 1))


def stage_argvs(n: int, sims: int, steps: int, epochs: int, batch: int,
                tests: int, trajectory_format: str) -> list:
    """(stage, its title, the port command's argv) of one scale."""
    if trajectory_format == "npz":
        store = ["--no-windows", "--trajectory-format", "npz"]
    else:
        store = ["--compression", "lzf"]
    watchdog = ["--watchdog", WATCHDOG_S]
    return [
        ("datagen", f"N={n}: datagen ({sims} sims x {steps} steps, "
                    f"{trajectory_format})",
         ["generate_data", "--particles", str(n), "--simulations",
          str(sims), "--steps", str(steps), "--sequence-length", "5",
          *store, *watchdog, "-o", "./data"]),
        ("train", f"N={n}: train ({epochs} epochs, b{batch}, production "
                  f"arch)",
         ["train_model", "--epochs", str(epochs), "--batch-size",
          str(batch), "--k-neighbors", "40", "--physics-loss", *watchdog,
          "-d", "./data", "-o", "./models"]),
        ("evaluate", f"N={n}: evaluate ({tests} test sims)",
         ["evaluate", "--n-test-sims", str(tests), "--particles", str(n),
          "--steps", str(steps), *watchdog]),
    ]


def run_scale(workdir, n: int, sims: int, steps: int, epochs: int,
              batch: int, tests: int, trajectory_format: str = "h5",
              device: Optional[str] = None,
              values: Optional[Dict[str, Dict[str, str]]] = None) -> dict:
    """Datagen, training and evaluation of one scale in ``workdir/n<N>``,
    each a process (``run_demo.execute``: the output printed as it comes,
    the run ended at a failed stage).  ``device`` goes to every stage;
    ``values`` replaces or appends argv values by command, as
    ``run_demo.with_values`` does (how a test shrinks the model).  Returns
    each stage's wall and launches and the evaluation's average metrics."""
    from nbody_gnn_hpc_torch.ops import read_launch_line
    from nbody_gnn_hpc_torch.run_demo import Stage, execute, with_values

    root = Path(workdir) / f"n{n}"
    root.mkdir(parents=True, exist_ok=True)
    device_argv = ["--device", device] if device else []
    stages = stage_argvs(n, sims, steps, epochs, batch, tests,
                         trajectory_format)
    runs = with_values(tuple(
        Stage(title, lambda a, c, r, argv=argv: argv + device_argv)
        for _, title, argv in stages), values or {})
    out = {"n": n, "walls": {}, "launches": {}}
    for (stage, _, _), run in zip(stages, runs):
        t0 = time.perf_counter()
        record = execute(run, argparse.Namespace(), None, root)
        wall = time.perf_counter() - t0
        print(f"STAGE_WALL {stage} n={n} {wall:.1f} s", flush=True)
        out["walls"][stage] = wall
        out["launches"][stage] = read_launch_line(record["output"])
    with open(root / "results" / "evaluation_results.json") as f:
        m = json.load(f)["average_metrics"]
    out["metrics"] = m
    print(f"LARGEN_RESULT n={n} posRMSE={m['position_rmse']!r} "
          f"velRMSE={m['velocity_rmse']!r} "
          f"energy_err={m.get('target_energy_error')!r}", flush=True)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Large-N surrogate pipeline (N=2,085 and 5,000)")
    parser.add_argument("workdir", nargs="?", default="runs_largen")
    parser.add_argument("--trajectory-format", choices=TRAJECTORY_FORMATS,
                        default="h5",
                        help="h5: the script's lzf windowed datasets (needs "
                             "h5py); npz: the npz store and the manifest")
    parser.add_argument("--device", default=None,
                        help="torch device for every stage (default cuda; "
                             "'cpu' only when asked for)")
    args = parser.parse_args(argv)

    from nbody_gnn_hpc_torch.device import resolve_device
    from nbody_gnn_hpc_torch.ops import LAUNCH_LINE, launch_counts

    device = str(resolve_device(args.device))  # raises before any stage
    total = launch_counts()
    for scale in SCALES:
        result = run_scale(args.workdir, *scale,
                           trajectory_format=args.trajectory_format,
                           device=device)
        for counts in result["launches"].values():
            for key, v in counts.items():
                total[key] += v
    print("DONE")
    print(LAUNCH_LINE + json.dumps(total))
    return 0


if __name__ == "__main__":
    sys.exit(main())
