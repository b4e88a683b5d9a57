"""knn_ms.largen: device time of the operations that start inside the
program's ``predict.knn`` spans, a traced ``predict.step`` span, in ms
(complete traces only; none where the device is busy over half the traced
span, as a deep launch queue then starts operations after their span)."""

from perfbench import spans


def read(reading):
    return spans.device_ms_per_span(reading, "predict.knn", "predict.step")
