"""launches_per_step.train: the host's kernel-launch calls in the traced
span, a training step (complete traces only)."""

from perfbench import readers


def read(reading):
    return readers.launches_per_step(
        reading, reading.record.get("traced_steps", 0))
