"""The knee of an open-loop serving cell: the highest rate the deployed
service sustains, found by a sweep of fixed rates through one service.

    python3 perfbench/knee.py --workload n200-serve-open --seed 1
        --rates 2,3,4,5,6 --seconds 30

Prints one JSON line a rate: requests due, shed (503) and failed shares,
the median and 90th percentile of due-to-answer times, the median in the
window's first and last quarters, and the requests still unanswered when
the window closed.  A rate is sustained where nothing is shed and the last
quarter's median is within 1.5x the first's (no backlog growing over the
window).
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def quarter_medians(records, latencies, t0, seconds):
    import statistics

    first = [lat for r, lat in zip(records, latencies)
             if r.due - t0 < seconds / 4]
    last = [lat for r, lat in zip(records, latencies)
            if r.due - t0 >= 3 * seconds / 4]
    return (statistics.median(first) if first else None,
            statistics.median(last) if last else None)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args(argv)
    import torch

    from perfbench import harness
    from perfbench.drivers import open_loop, serving

    cell = harness.Cell(harness.load_manifest(), args.workload)
    state = serving.setup(cell, args.seed, torch.device("cuda"))
    for rate in (float(r) for r in args.rates.split(",")):
        cell.traffic["rate_per_s"] = rate
        rec = open_loop.window(state, args.seconds)
        records = state["records"]
        lat = serving.latencies_ms(state, records)
        close = state["t0"] + args.seconds
        q1, q4 = quarter_medians(records, lat, state["t0"], args.seconds)
        row = dict(
            rate_per_s=rate, due=len(records),
            shed=sum(r.status == 503 for r in records) / len(records),
            failed=rec["failed"] / len(records),
            p50_ms=rec["rollout_p50_ms"], p90_ms=rec["rollout_p90_ms"],
            first_quarter_median_ms=q1, last_quarter_median_ms=q4,
            open_at_close=sum(1 for r in records
                              if r.done is None or r.done > close),
            dispatches=rec["dispatches"])
        row["sustained"] = (row["shed"] == 0 and row["failed"] == 0
                            and q4 is not None and q1 is not None
                            and q4 <= 1.5 * q1)
        print(json.dumps(row), flush=True)
    serving.release(state)
    return 0


if __name__ == "__main__":
    sys.exit(main())
