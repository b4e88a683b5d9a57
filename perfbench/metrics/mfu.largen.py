"""mfu.largen: the least time of the rollout steps answered in the window at
the H100's published peaks (float32 products and the rest at 67 TFLOP/s,
perfbench.workcount), over the window, in %."""

from perfbench import readers


def read(reading):
    return readers.serve_mfu(reading)
