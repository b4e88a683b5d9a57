"""A closed loop of final-state ``/rollout`` requests through the deployed
service: ``clients`` clients, each sending its next request when its last
answer came.  End to end: ``rollout_particle_steps_per_s``, N x steps of
every rollout answered in the window, over the window."""

from perfbench.drivers import serving
from perfbench.drivers.serving import check, release, setup  # noqa: F401


def window(state: dict, seconds: float, trace=None) -> dict:
    rec = serving.run_window(state, seconds, trace, "closed")
    records = rec["records"]
    close = rec["t0"] + seconds
    n = state["cell"].config["particles"]
    steps = int(state["cell"].traffic["n_steps"])
    answered = [r for r in records
                if r.status == 200 and r.done is not None and r.done <= close]
    return {"rollout_particle_steps_per_s": len(answered) * n * steps
            / seconds,
            "attempted": len(records),
            "failed": sum(1 for r in records if r.status != 200),
            "answered_in_window": len(answered),
            "dispatches": rec["dispatches"]}
