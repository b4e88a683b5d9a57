"""dispatch_fill.largen: requests a micro-batch dispatch took, over the
micro-batcher's max_batch, in % (the harness's count of each dispatch of
serve.py's MicroBatcher over the window)."""


def read(reading):
    state = reading.state
    if state.get("t0") is None:
        return None
    from perfbench.drivers.serving import in_window

    done = in_window(state["log"], state["t0"], state["t0"] + state["seconds"])
    if not done:
        return None
    cap = reading.cell.config["deployment"]["micro_batch"]
    return 100.0 * sum(d[0] for d in done) / (len(done) * cap)
