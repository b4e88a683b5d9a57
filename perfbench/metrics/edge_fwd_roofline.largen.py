"""edge_fwd_roofline.largen: kernel 1 (float32 edge-stream forward) in the
traced dispatches, its least time from the frozen work counts over its
device time in the trace, in % (complete traces only)."""

from perfbench import readers


def read(reading):
    return readers.serve_kernel_roofline(reading)
