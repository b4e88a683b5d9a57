"""mfu.train: the least time of the window's training steps at the H100's
published peaks (perfbench.workcount: bf16 products at 989 TFLOP/s, the
rest at 67), over the window, in %."""

from perfbench import readers


def read(reading):
    return readers.train_mfu(reading)
