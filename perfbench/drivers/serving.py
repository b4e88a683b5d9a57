"""Serving cells: the deployed rollout service (``serve.py``'s own
constructors, as its command line builds them: a replica pool, the
micro-batcher, the in-flight gate, weight-only quantization) in this
process, driven over HTTP by a load generator in a child process
(:mod:`perfbench.drivers.loadgen`).

Set-up builds the service and warms every micro-batch bucket with a
``warm_steps`` rollout of the cell's N.  The window starts the generator;
the harness records each dispatch (requests, padded batch, horizon, when
it returned).  After the window a sample of the answered requests, drawn
from the seed, is rolled out again by the plain reference and compared.

Traffic keys, besides :mod:`perfbench.traffic`'s: ``warm_steps``,
``wait_s`` (how long past the close answers are awaited),
``check_sample`` (requests compared), ``reference_batch`` (systems a
reference rollout holds), ``trace_at_s`` / ``trace_s``.
"""

import multiprocessing
import threading
import time

import numpy as np
import torch

from perfbench import harness
from perfbench import traffic as gen
from perfbench.drivers import loadgen
from perfbench.reference import rollout as ref_rollout

# How long before the window's start the generator is started, so that
# its process is up when the first request is due.
LEAD_S = 3.0


def _services(service):
    return getattr(service, "services", [service])


def _hold_all(services):
    for s in services:
        s._lock.acquire()


def _free_all(services):
    for s in services:
        s._lock.release()


def setup(cell, seed: int, device, fault=None) -> dict:
    """``fault`` plants a fault in the program: "altered" (the first
    system of every dispatch answers another state), "half_batch" (a
    dispatch rolls out the first half of its systems and answers the rest
    with the last of them)."""
    from nbody_gnn_hpc_torch.serve import (MicroBatcher, build_replica_pool,
                                           serve)

    cfg, tr = cell.config, cell.traffic
    dep = cfg["deployment"]
    root = cell.root
    marks = [("start", time.perf_counter())]
    replicas = dep["replicas"]
    service = build_replica_pool(
        str(root / cfg["checkpoint"]), str(root / cfg["service_config"]),
        n_replicas=(None if replicas < 0 else replicas)
        if device.type == "cuda" else 1,
        device=None if device.type == "cuda" else "cpu",
        quantize=dep["quantize"])
    marks.append(("service_built", time.perf_counter()))
    batcher = MicroBatcher(service, max_batch=dep["micro_batch"],
                           max_wait_s=dep["micro_batch_wait_ms"] / 1e3)
    batcher.warmup(cfg["particles"], tr["warm_steps"])
    marks.append(("warmup", time.perf_counter()))
    for svc in _services(service):
        _plant(svc, fault)
    log, lock = [], threading.Lock()
    inner = batcher._dispatch

    def dispatch(jobs, n_steps):
        inner(jobs, n_steps)
        bucket = next(b for b in batcher.buckets if b >= len(jobs))
        with lock:
            log.append((len(jobs), bucket, n_steps, time.monotonic()))

    batcher._dispatch = dispatch
    httpd = serve(service, host="127.0.0.1", port=0, batcher=batcher,
                  max_inflight=dep["max_inflight"])
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return dict(setup_stages=harness.stage_seconds(marks), cell=cell,
                seed=seed, device=device, service=service, batcher=batcher,
                httpd=httpd, thread=thread, log=log)


def _plant(svc, fault) -> None:
    if fault is None:
        return
    inner = svc.rollout_batch

    def altered(pos, vel, masses, n_steps, trajectory=True):
        out = inner(pos, vel, masses, n_steps, trajectory)
        out["positions"][0] = out["positions"][0] * np.float32(1.001)
        return out

    def half(pos, vel, masses, n_steps, trajectory=True):
        b = len(pos)
        keep = (b + 1) // 2
        masses = np.asarray(masses)
        out = inner(pos[:keep], vel[:keep],
                    masses[:keep] if masses.ndim == 2 else masses, n_steps,
                    trajectory)
        pad = lambda a: np.concatenate(  # noqa: E731
            [a] + [a[-1:]] * (b - keep))
        return {k: pad(v) for k, v in out.items()}

    planted = {"altered": altered, "half_batch": half}
    if fault not in planted:
        raise ValueError(f"unknown fault {fault!r}")
    svc.rollout_batch = planted[fault]


def run_window(state: dict, seconds: float, trace, kind: str) -> dict:
    """Start the generator, trace a span if asked, collect the records."""
    cell, tr = state["cell"], state["cell"].traffic
    services = _services(state["service"])
    cuda = state["device"].type == "cuda"
    ctx = multiprocessing.get_context("spawn")
    recv, send = ctx.Pipe(duplex=False)
    t0 = time.monotonic() + LEAD_S
    port = state["httpd"].server_address[1]
    proc = ctx.Process(target=loadgen.main, args=(
        send, kind, port, tr, cell.config["particles"], state["seed"], t0,
        seconds, float(tr["wait_s"])))
    proc.start()
    send.close()
    dispatches0 = state["batcher"].dispatches
    span = None
    if trace is not None:
        at = t0 + min(float(tr["trace_at_s"]), seconds)
        time.sleep(max(0.0, at - time.monotonic()))
        _hold_all(services)
        if cuda:
            torch.cuda.synchronize()
        trace.start()
        _free_all(services)
        begin = time.monotonic()
        time.sleep(max(0.0, min(float(tr["trace_s"]),
                                t0 + seconds - time.monotonic())))
        _hold_all(services)
        end = time.monotonic()
        if cuda:
            torch.cuda.synchronize()
        trace.stop()
        _free_all(services)
        span = (begin, end)
    time.sleep(max(0.0, t0 + seconds - time.monotonic()))
    dispatches1 = state["batcher"].dispatches
    status, payload = recv.recv()
    proc.join(30)
    if proc.is_alive():
        proc.kill()
        proc.join()
    if status != "ok":
        raise RuntimeError(f"load generator failed: {payload}")
    records = [loadgen.Record(i, due) for i, due, *_ in payload]
    for rec, (_, _, done, st, p, v, err) in zip(records, payload):
        rec.done, rec.status, rec.positions, rec.velocities, rec.error = \
            done, st, p, v, err
    state["records"] = records
    state["t0"], state["seconds"] = t0, seconds
    state["span"] = span
    state["collect_end"] = time.monotonic()
    return {"records": records, "t0": t0, "seconds": seconds,
            "dispatches": dispatches1 - dispatches0, "span": span}


def in_window(log, lo: float, hi: float):
    """Dispatches that returned in (lo, hi]."""
    return [d for d in log if lo < d[3] <= hi]


def release(state: dict) -> None:
    """Stop the server and free the service."""
    httpd = state.pop("httpd")
    httpd.shutdown()
    httpd.server_close()
    state.pop("thread").join(10)
    state.pop("batcher")
    service = state.pop("service")
    for svc in _services(service):
        svc.predictor = None
    del service
    if state["device"].type == "cuda":
        torch.cuda.empty_cache()


def check(state: dict) -> dict:
    """A sample of the answered requests, drawn from the seed, rolled out
    again by the reference at float32 from the checkpoint's weights
    rounded by the serving rule; the numbers compared are
    :func:`rollout_gaps`'s."""
    ref = reference_outputs(state, "float32")
    return rollout_gaps(state, ref)


def sample(state: dict):
    """The answered requests the comparison takes: ``check_sample`` of
    them drawn from the seed (all of them where fewer answered)."""
    ok = [r for r in state["records"] if r.status == 200]
    want = int(state["cell"].traffic["check_sample"])
    rng = gen._rng(state["seed"], 3)
    pick = rng.permutation(len(ok))[:want]
    return [ok[i] for i in sorted(pick)]


def reference_outputs(state: dict, prec: str) -> dict:
    """{request index: (positions, velocities)} of the reference's rollouts
    of :func:`sample`'s requests, in precision ``prec``."""
    cell = state["cell"]
    cfg, tr = cell.config, cell.traffic
    params, stats = ref_rollout.load_params(str(cell.root
                                                / cfg["checkpoint"]))
    if cfg["deployment"]["quantize"] == "int8":
        params = ref_rollout.int8_weights(params)
    n = cfg["particles"]
    picked = sample(state)
    out = {}
    group = int(tr["reference_batch"])
    for lo in range(0, len(picked), group):
        part = picked[lo:lo + group]
        inputs = [gen.states(tr, n, state["seed"], r.index) for r in part]
        pos, vel, m = (np.stack([x[i] for x in inputs]) for i in range(3))
        rp, rv = ref_rollout.rollout(
            params, stats, pos, vel, m, int(tr["n_steps"]),
            cfg["k_neighbors"], cfg["model_config"]["n_layers"], prec,
            state["device"])
        for j, r in enumerate(part):
            out[r.index] = (rp[j].cpu().numpy(), rv[j].cpu().numpy())
    return out


def rollout_gaps(state: dict, ref: dict) -> dict:
    """Per compared request: the distance of each particle's answered final
    position (velocity) from the reference's, over the spread of the
    reference's particles about their centre (the RMS distance); then
    ``pos_gap`` / ``vel_gap``: the median over particles of that, the
    largest over the requests; and ``unanswered``: the share of the
    requests due that got no HTTP answer at all after the wait (a 503 is an
    answer: the request counts as failed, not as wrong)."""
    by_index = {r.index: r for r in state["records"]}
    pos_gaps, vel_gaps = [], []
    for i, (rp, rv) in ref.items():
        rec = by_index[i]
        for got, want, gaps in ((rec.positions, rp, pos_gaps),
                                (rec.velocities, rv, vel_gaps)):
            scale = np.sqrt(((want - want.mean(0)) ** 2).sum(-1).mean())
            dist = np.linalg.norm(np.asarray(got, np.float64) - want, axis=-1)
            gaps.append(float(np.median(dist) / scale))
    records = state["records"]
    silent = sum(1 for r in records if r.status == 0)
    return {"pos_gap": max(pos_gaps) if pos_gaps else float("inf"),
            "vel_gap": max(vel_gaps) if vel_gaps else float("inf"),
            "unanswered": silent / max(1, len(records)),
            "compared": len(ref)}


def latencies_ms(state: dict, records) -> list:
    """Due-to-answer times; a request shed, failed or never answered counts
    as answered when the collection ended."""
    end = state["collect_end"]
    return [((r.done if r.status == 200 and r.done else end) - r.due) * 1e3
            for r in records]

