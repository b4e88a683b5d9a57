"""mfu.gns: the least time of the window's GNS training steps at the H100's
published peaks (perfbench.workcount_gns: bf16 products at 989 TFLOP/s,
the rest at 67), over the window, in %."""

from perfbench import workcount_gns


def read(reading):
    rec = reading.record
    if rec.get("steps", 0) <= 0:
        return None
    return (100.0 * rec["steps"] * workcount_gns.cell_step_s(reading)
            / rec["window_s"])
