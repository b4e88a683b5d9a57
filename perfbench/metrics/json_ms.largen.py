"""json_ms.largen: JSON decode (json.loads and validation) plus encode
(tolist, dumps, write) a compute request, in ms (serve.py's
``nbody_json_seconds`` over the run's requests)."""

from perfbench import spans


def read(reading):
    return spans.json_ms(reading)
