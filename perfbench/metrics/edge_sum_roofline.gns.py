"""edge_sum_roofline.gns: the receiver sum (csrc/edge_sum.cu, twice a
message-passing step: forward and backward) over the traced span: the
least time of its launches there (perfbench.workcount_gns, bytes at
3.35 TB/s) over its device time in the trace, in % (complete traces
only)."""

from perfbench import readers, workcount_gns


def read(reading):
    trace = readers.complete_trace(reading)
    if trace is None:
        return None
    seconds = trace.kernel_seconds("edge_sum")
    launches = trace.counted.get("edge_sum", 0)
    if seconds <= 0 or launches <= 0:
        return None
    return (100.0 * launches * workcount_gns.cell_receiver_sum_s(reading)
            / seconds)
