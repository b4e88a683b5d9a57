"""Reductions the per-layer metrics share (each metric's reader is a file
of its own under ``perfbench/metrics/``).  Every function takes the run's
:class:`perfbench.run.Reading` and returns None where there is nothing to
read: no trace, an incomplete trace, or no work of that kind in it."""

from typing import List, Optional, Tuple

from perfbench import workcount


def shapes(reading) -> dict:
    cfg = reading.cell.config
    mc = cfg["model_config"]
    return dict(n=cfg["particles"], k=cfg["k_neighbors"],
                h=mc["hidden_dim"], n_layers=mc["n_layers"],
                node_in=mc["node_input_dim"], out=mc["output_dim"])


def complete_trace(reading):
    """The trace where every counted kernel it should hold is in it."""
    trace = reading.trace
    if trace is None or not trace.device_ops:
        return None
    ok, _ = trace.complete()
    return trace if ok else None


def traced_dispatches(reading) -> List[Tuple[int, int, int, float]]:
    """(requests, padded batch, horizon, returned) of the dispatches whose
    device work lies in the traced span."""
    from perfbench.drivers.serving import in_window

    span = reading.state.get("span")
    if span is None:
        return []
    return in_window(reading.state["log"], *span)


def launches_per_step(reading, steps: int) -> Optional[float]:
    trace = complete_trace(reading)
    if trace is None or steps <= 0 or trace.launch_calls == 0:
        return None
    return trace.launch_calls / steps


def idle_share(reading) -> Optional[float]:
    trace = complete_trace(reading)
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)


def train_mfu(reading) -> Optional[float]:
    """The least time of the window's steps at the published peaks, over
    the window."""
    rec = reading.record
    if rec.get("steps", 0) <= 0:
        return None
    s = shapes(reading)
    cfg = reading.cell.config
    work = workcount.train_step_work(
        reading.cell.traffic["batch_size"], s["n"], s["k"], s["h"],
        s["n_layers"], s["node_in"], s["out"], reading.state["n_params"],
        cfg["model_config"]["dtype"])
    return 100.0 * rec["steps"] * work.least_s() / rec["window_s"]


def serve_mfu(reading) -> Optional[float]:
    """The least time of the rollout steps of every request answered by a
    dispatch returning in the window, at the published peaks, over the
    window."""
    state = reading.state
    t0, seconds = state.get("t0"), state.get("seconds")
    if t0 is None:
        return None
    from perfbench.drivers.serving import in_window

    s = shapes(reading)
    least = 0.0
    for requests, _, steps, _ in in_window(state["log"], t0, t0 + seconds):
        least += steps * workcount.rollout_step_work(
            requests, s["n"], s["k"], s["h"], s["n_layers"], s["node_in"],
            s["out"]).least_s()
    return 100.0 * least / seconds if least > 0 else None


def train_kernel_roofline(reading, kernel: str) -> Optional[float]:
    """Least time of the traced steps' launches of kernel 1 ("edge_fwd")
    or 2 ("edge_bwd") over their device time in the trace."""
    trace = complete_trace(reading)
    if trace is None:
        return None
    seconds = trace.kernel_seconds(kernel)
    steps = reading.record.get("traced_steps", 0)
    if seconds <= 0 or steps <= 0:
        return None
    s = shapes(reading)
    b = reading.cell.traffic["batch_size"]
    e = s["n"] * s["k"]
    elem = 2 if reading.cell.config["model_config"]["dtype"] == "bfloat16" \
        else 4
    one = (workcount.edge_fwd_s if kernel == "edge_fwd"
           else workcount.edge_bwd_s)(b, s["n"], e, s["h"], elem, True)
    return 100.0 * steps * s["n_layers"] * one / seconds


def serve_kernel_roofline(reading) -> Optional[float]:
    """Least time of kernel 1's launches in the traced dispatches (float32
    stream, no dropout, at each dispatch's padded batch) over kernel 1's
    device time in the trace."""
    trace = complete_trace(reading)
    if trace is None:
        return None
    seconds = trace.kernel_seconds("edge_fwd")
    if seconds <= 0:
        return None
    s = shapes(reading)
    e = s["n"] * s["k"]
    least = sum(steps * s["n_layers"] * workcount.edge_fwd_s(
        bucket, s["n"], e, s["h"], 4, False)
        for _, bucket, steps, _ in traced_dispatches(reading))
    return 100.0 * least / seconds if least > 0 else None


def serve_launches_per_step(reading) -> Optional[float]:
    steps = sum(d[2] for d in traced_dispatches(reading))
    return launches_per_step(reading, steps)
