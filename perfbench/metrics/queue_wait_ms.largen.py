"""queue_wait_ms.largen: the mean wait of a micro-batched /rollout request
from enqueue to the start of its dispatch's rollout under the device lock,
in ms (serve.py's ``nbody_batch_queue_seconds`` over the run's
requests)."""

from perfbench import spans


def read(reading):
    return spans.queue_wait_ms(reading)
