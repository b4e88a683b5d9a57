"""The load generator: a process of its own (standard library and NumPy
only, so it neither takes the server's interpreter lock nor touches the
card) that sends ``/rollout`` requests and records when each was due, when
its answer came and what it said.

Requests and arrival times come from :mod:`perfbench.traffic`, made from
the seed in this process and again, identically, in the server's process
for the comparison.  Times are ``time.monotonic()``, one clock for both
processes.
"""

import http.client
import json
import threading
import time
from typing import List

import numpy as np

from perfbench import traffic as gen


class Record:
    __slots__ = ("index", "due", "done", "status", "positions",
                 "velocities", "error")

    def __init__(self, index: int, due: float):
        self.index, self.due = index, due
        self.done = None
        self.status = 0
        self.positions = self.velocities = None
        self.error = ""

    def as_tuple(self):
        return (self.index, self.due, self.done, self.status,
                self.positions, self.velocities, self.error)


def _post(port: int, body: bytes, rec: Record, timeout: float) -> None:
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
        try:
            conn.request("POST", "/rollout", body,
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
            rec.status = resp.status
            if resp.status == 200:
                out = json.loads(data)
                rec.positions = np.asarray(out["positions"], np.float32)
                rec.velocities = np.asarray(out["velocities"], np.float32)
            else:
                rec.error = data[:200].decode(errors="replace")
        finally:
            conn.close()
    except OSError as e:  # refused, reset or timed out: a failed request
        rec.error = f"{type(e).__name__}: {e}"
    rec.done = time.monotonic()


def open_loop(port: int, mix: dict, n: int, seed: int, t0: float,
              seconds: float, wait_s: float) -> List[Record]:
    """Every request of the schedule sent at its due time, each on its own
    thread, whatever the earlier ones are doing; answers awaited until
    ``wait_s`` past the window's close."""
    due = gen.arrivals(mix, seed, seconds)
    records, threads = [], []
    deadline = t0 + seconds + wait_s
    for i, offset in enumerate(due):
        rec = Record(i, t0 + offset)
        body = json.dumps(gen.request(mix, n, seed, i)).encode()
        delay = rec.due - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        th = threading.Thread(target=_post, daemon=True, args=(
            port, body, rec, max(1.0, deadline - time.monotonic())))
        th.start()
        records.append(rec)
        threads.append(th)
    for th in threads:
        th.join(max(0.0, deadline - time.monotonic()))
    return records


def closed_loop(port: int, mix: dict, n: int, seed: int, t0: float,
                seconds: float, wait_s: float) -> List[Record]:
    """``clients`` threads, each sending its next request when its last
    answer came, until the window closes; request j of client c is request
    c + clients * j of the mix."""
    clients = int(mix["clients"])
    records: List[Record] = []
    lock = threading.Lock()
    deadline = t0 + seconds + wait_s

    def client(c: int) -> None:
        j = 0
        delay = t0 - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        while time.monotonic() < t0 + seconds:
            i = c + clients * j
            body = json.dumps(gen.request(mix, n, seed, i)).encode()
            rec = Record(i, time.monotonic())
            with lock:
                records.append(rec)
            _post(port, body, rec, max(1.0, deadline - time.monotonic()))
            j += 1

    threads = [threading.Thread(target=client, args=(c,), daemon=True)
               for c in range(clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(max(0.0, deadline - time.monotonic()) + 1.0)
    return sorted(records, key=lambda r: r.index)


def main(conn, kind: str, port: int, mix: dict, n: int, seed: int,
         t0: float, seconds: float, wait_s: float) -> None:
    """The child's entry: run the loop and send the records back."""
    loop = {"open": open_loop, "closed": closed_loop}[kind]
    try:
        records = loop(port, mix, n, seed, t0, seconds, wait_s)
        conn.send(("ok", [r.as_tuple() for r in records]))
    except Exception as e:  # report, so that the parent does not hang
        conn.send(("error", f"{type(e).__name__}: {e}"))
    finally:
        conn.close()
