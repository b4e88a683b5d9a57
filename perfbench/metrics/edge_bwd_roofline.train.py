"""edge_bwd_roofline.train: kernel 2 (the edge-stream backward, bf16
stream, with dropout; its source and target passes and parameter sum) over
the traced steps: least time from the frozen work counts over its device
time in the trace, in % (complete traces only)."""

from perfbench import readers


def read(reading):
    return readers.train_kernel_roofline(reading, "edge_bwd")
