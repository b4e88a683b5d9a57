"""An open loop of final-state ``/rollout`` requests through the deployed
service: each request sent when it is due (:func:`perfbench.traffic.
arrivals`), whatever the earlier ones are doing.  End to end:
``rollout_p90_ms``, the 90th percentile of due-to-answer times of every
request due in the window, a shed or failed one counted as unanswered
until the collection ended."""

from perfbench.drivers import serving
from perfbench.harness import percentile
from perfbench.drivers.serving import check, release, setup  # noqa: F401


def window(state: dict, seconds: float, trace=None) -> dict:
    rec = serving.run_window(state, seconds, trace, "open")
    records = rec["records"]
    lat = serving.latencies_ms(state, records)
    failed = sum(1 for r in records if r.status != 200)
    return {"rollout_p90_ms": percentile(lat, 90),
            "rollout_p50_ms": percentile(lat, 50),
            "attempted": len(records), "failed": failed,
            "late_s": max(0.0, state["collect_end"] - rec["t0"]
                          - seconds),
            "dispatches": rec["dispatches"]}
