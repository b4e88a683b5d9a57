"""idle_outside_rollout.largen: idle_share less idle_in_rollout: device-idle
time outside every ``serve.rollout`` span (HTTP, JSON, the micro-batcher's
queue), over the traced span, in % (complete traces only)."""

from perfbench import spans


def read(reading):
    return spans.idle_outside(reading, "serve.rollout")
