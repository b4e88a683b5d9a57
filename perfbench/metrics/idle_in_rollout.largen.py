"""idle_in_rollout.largen: device-idle time inside the program's
``serve.rollout`` spans (a dispatch's rollout under the device lock, any
thread), over the traced span, in % (complete traces only)."""

from perfbench import spans


def read(reading):
    return spans.idle_inside(reading, "serve.rollout")
