"""launches_per_step.largen: the host's kernel-launch calls in the traced
span, a rollout step of a dispatch (complete traces only)."""

from perfbench import readers


def read(reading):
    return readers.serve_launches_per_step(reading)
