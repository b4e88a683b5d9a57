"""edge_fwd_roofline.train: kernel 1 (the edge-stream forward, bf16
stream, with dropout) over the traced steps: its least time from the frozen
work counts over its device time in the trace, in % (complete traces
only)."""

from perfbench import readers


def read(reading):
    return readers.train_kernel_roofline(reading, "edge_fwd")
