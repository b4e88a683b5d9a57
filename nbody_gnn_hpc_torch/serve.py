"""Rollout HTTP service for the GNN surrogate on the GPU.

Port of ``nbody_gnn_hpc_tpu/serve.py``: a checkpoint-loaded
:class:`~nbody_gnn_hpc_torch.predict.Predictor` behind a stdlib HTTP
server.  Runs on ``cuda`` unless built with ``device="cpu"``.

Endpoints (JSON over HTTP):
  GET  /healthz        -> {"status": "ok", "device": <CUDA device name>,
                           "model": ...}
  GET  /metrics        -> Prometheus text: request counters by endpoint and
                          status, latency histograms, JSON decode and encode
                          seconds, the micro-batcher's queue wait, requests
                          a dispatch and requests of dispatches held for a
                          replica, uptime
  POST /rollout        -> {"positions": (N,3), "velocities": (N,3),
                           "masses": (N,), "n_steps": int,
                           "trajectory": bool = true,
                           "format": "json"|"npz", "stream": bool = false,
                           "chunk": int}
                          -> (n_steps+1, N, 3) trajectories, or the final
                          (N, 3) state with "trajectory": false
  POST /rollout_batch  -> the same with (B, N, 3) states and (N,) or (B, N)
                          masses, one batched rollout for all systems
  POST /simulate       -> exact-physics KDK leapfrog; "dt", "trajectory"
                          (default false), "save_interval", "stream"

"format": "npz" answers with an uncompressed f32 .npz body (the compute
precision), far smaller and cheaper than float text.  "stream": true sends
NDJSON, one line per chunk ({"frame_start", "positions", "velocities"[,
"times"]}), then {"done": true}; an error mid-stream arrives as a final
{"error": ...} line.  Device access is serialised with a lock, released
between chunks so long streams interleave with other requests.

As it is deployed, the service sits behind three more pieces:
:class:`MicroBatcher` coalesces concurrent single-system ``/rollout``
requests into one batched rollout, and while every replica is busy it keeps
them queued, so that the next free replica takes them together;
:func:`build_replica_pool` puts one
replica of the model on each GPU behind the single-service interface, so
independent requests run on different cards; and ``max_inflight`` sheds
compute requests beyond a bound with 503 + ``Retry-After`` while ``/healthz``
and ``/metrics`` keep answering.  ``quantize`` serves weight-only bf16 or
int8 weights (:mod:`nbody_gnn_hpc_torch.predict.quantize`).

Run it with ``python -m nbody_gnn_hpc_torch.serve -m
models/best_rollout_model.pt -c models/config.json [--micro-batch 8]
[--replicas -1] [--max-inflight 32] [--quantize int8]``.
"""

import argparse
import collections
import contextlib
import itertools
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from nbody_gnn_hpc_torch.utils.profiling import (NEW_REQUEST, annotate,
                                                 clock_ns, current_span,
                                                 record_span)

DEFAULT_MODEL_CONFIG = {"node_input_dim": 7, "hidden_dim": 256,
                        "n_layers": 6, "output_dim": 6, "dropout": 0.1}


def build_service(model_path: str, config_path: str, device=None,
                  quantize: Optional[str] = None) -> "RolloutService":
    """RolloutService from a checkpoint + persisted config.json (the schema
    the JAX package's ``train_model.py`` writes); float32 inference, with
    ``quantize`` ("bf16" / "int8") over weight-only quantized weights.  A
    ``model_config`` that names ``edge_impl: "fused_full"`` is served
    through the whole-layer kernel."""
    from nbody_gnn_hpc_torch.models import model_from_config

    cfg_path = Path(config_path)
    if cfg_path.exists():
        cfg = json.loads(cfg_path.read_text())
        model_config = cfg["model_config"]
        k_neighbors = cfg.get("training_config", {}).get("k_neighbors", 40)
    else:
        model_config, k_neighbors = DEFAULT_MODEL_CONFIG, 40
    return RolloutService(model_from_config(model_config,
                                            dtype_override="float32"),
                          model_path,
                          k_neighbors=k_neighbors, device=device,
                          quantize=quantize)


class RolloutService:
    """Checkpoint-backed rollout engine on one device."""

    # Rollout steps per streamed chunk: the device lock is held per chunk
    # and host memory is bounded at one chunk.
    STREAM_CHUNK = 64
    # Steps per locked segment of /simulate, so a long simulation
    # interleaves with other requests.
    SIM_CHUNK = 200

    def __init__(self, model, checkpoint_path: str, k_neighbors: int = 40,
                 device=None, quantize: Optional[str] = None):
        import torch

        from nbody_gnn_hpc_torch.predict import Predictor

        self.predictor = Predictor(model, checkpoint_path, device=device,
                                   k_neighbors=k_neighbors)
        if quantize and not self.predictor.quantization:
            # A checkpoint that already carries quantized weights wins.
            self.predictor.quantize(quantize)
        self._lock = threading.Lock()  # one device; serialise dispatches
        self.model_info = {
            "hidden_dim": model.hidden_dim, "n_layers": model.n_layers,
            "k_neighbors": k_neighbors, "checkpoint": str(checkpoint_path),
            "edge_impl": model.edge_impl,
            "quantization": self.predictor.quantization,
        }
        dev = self.predictor.device
        self.device = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else str(dev))

    def warmup(self, n_particles: int, n_steps: int,
               batch: Optional[int] = None) -> None:
        """Run one rollout of the given shape so that the first real
        request pays no first-use cost (the kernel build, CUDA context and
        library handles)."""
        rng = np.random.RandomState(0)
        pos = rng.randn(n_particles, 3).astype(np.float32)
        vel = rng.randn(n_particles, 3).astype(np.float32)
        masses = rng.uniform(1e10, 1e12, n_particles).astype(np.float32)
        if batch:
            self.rollout_batch(np.stack([pos] * batch),
                               np.stack([vel] * batch), masses, n_steps,
                               trajectory=False)
        else:
            self.rollout(pos, vel, masses, n_steps, trajectory=False)

    def rollout(self, positions, velocities, masses, n_steps: int,
                trajectory: bool = True):
        """``trajectory=False`` returns only the final (N, 3) state."""
        with self._lock, self._rollout_span(1, n_steps):
            out = self.predictor.predict_rollout(
                np.asarray(positions, np.float32),
                np.asarray(velocities, np.float32),
                np.asarray(masses, np.float32), n_steps=int(n_steps),
                trajectory=trajectory, out_dtype=np.float32)
        return {"positions": out["positions"],
                "velocities": out["velocities"]}

    def rollout_batch(self, positions, velocities, masses, n_steps: int,
                      trajectory: bool = True):
        with self._lock, self._rollout_span(len(positions), n_steps):
            out = self.predictor.predict_rollout_batch(
                np.asarray(positions, np.float32),
                np.asarray(velocities, np.float32),
                np.asarray(masses, np.float32), n_steps=int(n_steps),
                trajectory=trajectory, out_dtype=np.float32)
        return {"positions": out["positions"],
                "velocities": out["velocities"]}

    def rollout_stream(self, positions, velocities, masses, n_steps: int,
                       chunk: Optional[int] = None):
        """GNN rollout as a generator of ``{"frame_start", "positions",
        "velocities"}`` chunks whose frames concatenate to exactly the
        ``trajectory=True`` rollout (no frame repeated across chunks).  The
        device lock is held per chunk; every chunk, the tail included, runs
        ``chunk`` steps (the tail's surplus is discarded)."""
        chunk = int(chunk or self.STREAM_CHUNK)
        yield from _stream_rollout_chunks(
            lambda pos, vel, m: self.rollout_chunk(pos, vel, m, chunk),
            positions, velocities, masses, int(n_steps), chunk)

    def rollout_chunk(self, pos, vel, masses, chunk: int):
        """One stream chunk under the device lock: (chunk+1, N, 3)
        position and velocity arrays."""
        with self._lock, self._rollout_span(1, chunk):
            out = self.predictor.predict_rollout(
                pos, vel, masses, n_steps=chunk, trajectory=True,
                out_dtype=np.float32)
        return out["positions"], out["velocities"]

    @staticmethod
    def _rollout_span(bucket: int, n_steps: int):
        """Under the device lock, at the start of a rollout: ends the queue
        wait of the micro-batched jobs this thread dispatches, and opens
        the ``serve.rollout`` span with their request ids (and ``held``:
        whether their leader found every replica busy)."""
        dispatch = getattr(_dispatching, "jobs", None)
        attrs = {}
        if dispatch is None:
            span = current_span()
            requests = [span.request] if span is not None else []
            batch = bucket
        else:
            batcher, jobs = dispatch
            _dispatching.jobs = None
            batcher._queue_ended(jobs)
            requests = [j.request for j in jobs]
            batch = len(jobs)
            attrs["held"] = jobs[0].held  # the dispatch's leader
        return annotate("serve.rollout", requests=requests, batch=batch,
                        bucket=bucket, steps=int(n_steps), **attrs)

    def simulate_stream(self, positions, velocities, masses, n_steps: int,
                        dt: float = 0.001, save_interval: int = 1):
        """Exact-physics trajectory as a generator of ``{"frame_start",
        "positions", "velocities", "times"}`` chunks in saved-frame index
        space; they concatenate to the buffered trajectory response."""
        state = self._prepare_sim_state(positions, velocities, masses)
        for start, ps, vs, ts in self._sim_frames(state, dt, int(n_steps),
                                                  int(save_interval)):
            yield {"frame_start": start, "positions": ps,
                   "velocities": vs, "times": ts}

    def _prepare_sim_state(self, positions, velocities, masses):
        from nbody_gnn_hpc_torch.sim import accelerations, make_state

        state = make_state(np.asarray(positions, np.float32),
                           np.asarray(velocities, np.float32),
                           np.asarray(masses, np.float32),
                           device=self.predictor.device)
        return state._replace(
            accelerations=accelerations(state.positions, state.masses))

    def _advance(self, state, dt, steps: int):
        """Advance without saving, at most SIM_CHUNK steps per locked
        segment."""
        from nbody_gnn_hpc_torch.sim.integrator import rollout_steps

        done = 0
        while done < steps:
            todo = min(self.SIM_CHUNK, steps - done)
            with self._lock:
                state = rollout_steps(state, dt, todo)
            done += todo
        return state

    def _sim_frames(self, state, dt, n_steps: int, save_interval: int):
        """Saved-frame chunks ``(frame_start, positions, velocities,
        times)``, each locked segment at most ~SIM_CHUNK steps:

        - ``save_interval <= SIM_CHUNK``: trajectory segments aligned to
          the save cadence (several saves per segment);
        - ``save_interval > SIM_CHUNK``: fast-forward each interval in
          SIM_CHUNK segments and capture the state at every save boundary.
          The trailing ``n_steps % save_interval`` steps are unobservable
          in trajectory output (reference nbody.py:237-241) and skipped.
        """
        from nbody_gnn_hpc_torch.sim.integrator import run_trajectory

        host = lambda t: t.cpu().numpy()  # noqa: E731
        if save_interval <= self.SIM_CHUNK:
            chunk = max(save_interval,
                        (self.SIM_CHUNK // save_interval) * save_interval)
            done = 0
            while done < n_steps:
                todo = min(chunk, n_steps - done)
                with self._lock:
                    traj = run_trajectory(state, dt, todo,
                                          save_interval=save_interval)
                state = traj.final
                skip = 0 if done == 0 else 1  # drop duplicated chunk head
                yield (done // save_interval + skip,
                       host(traj.positions[skip:]),
                       host(traj.velocities[skip:]),
                       host(traj.times[skip:]))
                done += todo
            return
        yield (0, host(state.positions[None]), host(state.velocities[None]),
               host(state.time[None]))
        for k in range(n_steps // save_interval):
            state = self._advance(state, dt, save_interval)
            yield (k + 1, host(state.positions[None]),
                   host(state.velocities[None]), host(state.time[None]))

    def simulate(self, positions, velocities, masses, n_steps: int,
                 dt: float = 0.001, trajectory: bool = False,
                 save_interval: int = 1):
        """Exact-physics run on the service's device: the final state, or
        the saved trajectory with ``trajectory``."""
        n_steps = int(n_steps)
        state = self._prepare_sim_state(positions, velocities, masses)
        if not trajectory:
            state = self._advance(state, dt, n_steps)
            return {"positions": state.positions.cpu().numpy(),
                    "velocities": state.velocities.cpu().numpy()}
        parts = list(self._sim_frames(state, dt, n_steps,
                                      int(save_interval)))
        return {key: np.concatenate([p[i] for p in parts])
                for i, key in ((1, "positions"), (2, "velocities"),
                               (3, "times"))}


class Metrics:
    """In-process request metrics in Prometheus text format (``GET
    /metrics``): counters by endpoint/status, latency histograms by
    endpoint, JSON decode and encode seconds, uptime, and the series of
    ``batcher`` (a :class:`MicroBatcher`) where there is one. Thread-safe;
    one instance per server."""

    BUCKETS = (0.005, 0.02, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)
    JSON_STAGES = ("decode", "encode")

    def __init__(self, batcher: Optional["MicroBatcher"] = None):
        self._lock = threading.Lock()
        self._requests = {}    # (endpoint, status) -> count
        self._hist = {}        # endpoint -> [bucket counts..., +Inf]
        self._sum = {}         # endpoint -> total seconds
        # stage -> [seconds, count]: decode is json.loads + validation of a
        # compute request's body, encode the reply's tolist/dumps/write.
        self.json = {stage: [0.0, 0] for stage in self.JSON_STAGES}
        self.batcher = batcher
        self._started = time.time()

    def observe_json(self, stage: str, seconds: float) -> None:
        with self._lock:
            entry = self.json[stage]
            entry[0] += seconds
            entry[1] += 1

    def observe(self, endpoint: str, status: int, seconds: float) -> None:
        with self._lock:
            key = (endpoint, int(status))
            self._requests[key] = self._requests.get(key, 0) + 1
            h = self._hist.setdefault(endpoint,
                                      [0] * (len(self.BUCKETS) + 1))
            for i, edge in enumerate(self.BUCKETS):
                if seconds <= edge:
                    h[i] += 1
                    break
            else:
                h[-1] += 1
            self._sum[endpoint] = self._sum.get(endpoint, 0.0) + seconds

    def render(self) -> str:
        with self._lock:
            lines = [
                "# HELP nbody_requests_total Requests by endpoint and "
                "HTTP status.",
                "# TYPE nbody_requests_total counter",
            ]
            for (endpoint, status), n in sorted(self._requests.items()):
                lines.append(f'nbody_requests_total{{endpoint="{endpoint}",'
                             f'status="{status}"}} {n}')
            lines += [
                "# HELP nbody_request_seconds Request latency.",
                "# TYPE nbody_request_seconds histogram",
            ]
            for endpoint in sorted(self._hist):
                h = self._hist[endpoint]
                cum = 0
                for edge, n in zip(self.BUCKETS, h):
                    cum += n
                    lines.append(
                        f'nbody_request_seconds_bucket{{endpoint='
                        f'"{endpoint}",le="{edge}"}} {cum}')
                cum += h[-1]
                lines.append(f'nbody_request_seconds_bucket{{endpoint='
                             f'"{endpoint}",le="+Inf"}} {cum}')
                lines.append(f'nbody_request_seconds_count{{endpoint='
                             f'"{endpoint}"}} {cum}')
                lines.append(f'nbody_request_seconds_sum{{endpoint='
                             f'"{endpoint}"}} {self._sum[endpoint]:.6f}')
            lines += [
                "# HELP nbody_json_seconds JSON decode (json.loads and "
                "validation) and encode (tolist, dumps, write) of compute "
                "requests.",
                "# TYPE nbody_json_seconds summary",
            ]
            for stage, (seconds, n) in self.json.items():
                lines.append(f'nbody_json_seconds_sum{{stage="{stage}"}} '
                             f'{seconds:.6f}')
                lines.append(f'nbody_json_seconds_count{{stage="{stage}"}} '
                             f'{n}')
            lines.append("# HELP nbody_uptime_seconds Seconds since server "
                         "construction.")
            lines.append("# TYPE nbody_uptime_seconds gauge")
            lines.append(f"nbody_uptime_seconds "
                         f"{time.time() - self._started:.1f}")
        text = "\n".join(lines) + "\n"
        if self.batcher is not None:
            text += self.batcher.render()
        return text


def _stream_rollout_chunks(run_chunk, positions, velocities, masses,
                           n_steps: int, chunk: int):
    """Chunk loop of a streamed GNN rollout; the carry between chunks is
    host-side f32. ``run_chunk(pos, vel, masses) -> (ps, vs)`` runs
    ``chunk`` steps and returns (chunk+1, N, 3) arrays."""
    pos = np.asarray(positions, np.float32)
    vel = np.asarray(velocities, np.float32)
    masses = np.asarray(masses, np.float32)
    done = 0
    while done < n_steps:
        todo = min(chunk, n_steps - done)
        ps, vs = run_chunk(pos, vel, masses)  # (chunk+1, N, 3)
        pos, vel = ps[todo], vs[todo]
        lo = 0 if done == 0 else 1  # drop duplicated chunk head
        yield {"frame_start": done + lo,
               "positions": ps[lo:todo + 1],
               "velocities": vs[lo:todo + 1]}
        done += todo


def build_replica_pool(model_path: str, config_path: str,
                       n_replicas: Optional[int] = None, device=None,
                       quantize: Optional[str] = None) -> "ReplicaPool":
    """One :class:`RolloutService` replica per GPU (``cuda:0`` ..), or the
    first ``n_replicas`` of them, behind the single-service interface:
    independent requests run at once on different cards instead of
    serialising on one device lock.  The 2.5M-parameter model replicates
    whole.  With ``device="cpu"`` (the tests) ``n_replicas`` is any count
    given explicitly, each replica with its own copy of the model and its
    own lock."""
    import torch

    dev = None if device is None else torch.device(device)
    if dev is not None and dev.type == "cpu":
        n = 1 if n_replicas is None else int(n_replicas)
        if n < 1:
            raise ValueError(f"n_replicas={n}: need at least one replica")
        devices = ["cpu"] * n
    else:
        from nbody_gnn_hpc_torch.device import resolve_device

        resolve_device(device)  # raises where there is no GPU
        visible = torch.cuda.device_count()
        n = visible if n_replicas is None else int(n_replicas)
        if not 1 <= n <= visible:
            raise ValueError(f"n_replicas={n} but {visible} GPUs visible")
        devices = [f"cuda:{i}" for i in range(n)]
    services = []
    for i, d in enumerate(devices):
        svc = build_service(model_path, config_path, device=d,
                            quantize=quantize)
        svc.device = f"{d}:{i}" if d == "cpu" else f"{svc.device} ({d})"
        services.append(svc)
    return ReplicaPool(services)


class ReplicaPool:
    """Pool of replicas with the :class:`RolloutService` surface.

    Each request takes a free replica (FIFO; it blocks while every replica
    is busy, as requests to a single service wait for its lock) and runs on
    that replica's device.  GNN streams take a replica per chunk (their
    carry is on the host), so long streams spread over the pool; /simulate
    streams keep one replica (their state lives on its device).  Composes
    with :class:`MicroBatcher`: each coalesced dispatch takes one replica.
    """

    def __init__(self, services):
        import queue

        if not services:
            raise ValueError("ReplicaPool needs at least one service")
        self.services = list(services)
        self._free = queue.Queue()
        for s in self.services:
            self._free.put(s)
        self.STREAM_CHUNK = self.services[0].STREAM_CHUNK
        self.model_info = {**self.services[0].model_info,
                           "replicas": len(self.services)}
        self.device = ", ".join(s.device for s in self.services)

    def warmup(self, *args, **kwargs) -> None:
        for s in self.services:
            s.warmup(*args, **kwargs)

    def _run(self, method, *args, **kwargs):
        s = self._free.get()
        try:
            return getattr(s, method)(*args, **kwargs)
        finally:
            self._free.put(s)

    def rollout(self, *args, **kwargs):
        return self._run("rollout", *args, **kwargs)

    def rollout_batch(self, *args, **kwargs):
        return self._run("rollout_batch", *args, **kwargs)

    def simulate(self, *args, **kwargs):
        return self._run("simulate", *args, **kwargs)

    def rollout_stream(self, positions, velocities, masses, n_steps: int,
                       chunk: Optional[int] = None):
        """Each chunk takes a free replica: FIFO rotation alternates the
        replicas when several are free."""
        chunk = int(chunk or self.STREAM_CHUNK)
        yield from _stream_rollout_chunks(
            lambda pos, vel, m: self._run("rollout_chunk", pos, vel, m,
                                          chunk),
            positions, velocities, masses, int(n_steps), chunk)

    def simulate_stream(self, *args, **kwargs):
        """The whole stream keeps its replica; exhaustion or abandonment
        releases it."""
        s = self._free.get()
        try:
            yield from s.simulate_stream(*args, **kwargs)
        finally:
            self._free.put(s)


class _Job:
    """One queued single-system rollout awaiting a coalesced dispatch:
    when it was queued (:func:`clock_ns`), and the span it waits in, whose
    request id and thread its ``serve.queue`` span takes.  ``event`` is set
    when the job is answered or elected to lead its key's queue; a leader's
    ``slot`` is set when a replica is its to take, and ``held`` says that
    it found every replica busy when it was elected.  A leader is always
    the oldest job, so the first of the jobs it dispatches."""

    __slots__ = ("pos", "vel", "masses", "trajectory", "event", "result",
                 "error", "queued_ns", "waiter", "slot", "held")

    def __init__(self, pos, vel, masses, trajectory=True):
        self.pos, self.vel, self.masses = pos, vel, masses
        self.trajectory = trajectory
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.queued_ns = clock_ns()
        self.waiter = current_span()
        self.slot = None
        self.held = False

    @property
    def request(self) -> Optional[int]:
        return self.waiter.request if self.waiter is not None else None


# (batcher, jobs) of the micro-batched dispatch this thread is running, for
# the service to end the jobs' queue wait once it holds the device lock.
_dispatching = threading.local()


class MicroBatcher:
    """Coalesce concurrent single-system ``/rollout`` requests into one
    batched rollout.

    Without it concurrent requests serialise on the device lock: B clients
    pay B rollouts one after the other.  With it, requests of one
    (n_particles, n_steps) key queue under one leader, the key's oldest
    request, and run as one ``rollout_batch`` (per-system masses) of at
    most ``max_batch`` systems.  The leader takes a replica before it takes
    its queue; the replicas are the ``ReplicaPool``'s services, or the one
    service otherwise.  A leader that finds a replica free waits at most
    ``max_wait_s`` for followers (or until ``max_batch`` have come), then
    dispatches: a lone request on an idle service pays that window and a
    rollout of one.  While every replica is busy, leaders wait for one in
    the order they came, and what arrives meanwhile joins their queues; the
    first replica to free takes the oldest ``max_batch`` of the longest
    waiting leader's key at once, with no second window.  The jobs beyond
    ``max_batch`` elect their oldest as the next leader, which waits for
    the next free replica.  Batches are padded up to fixed buckets (1, 2,
    4, ... and ``max_batch`` itself) by repeating the last system, and the
    padding is sliced off the results: a bounded set of batch shapes, which
    :meth:`warmup` runs once each.
    """

    def __init__(self, service, max_batch: int = 8,
                 max_wait_s: float = 0.005):
        self.service = service
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        # max_batch itself is a bucket, so the lookup in _dispatch succeeds
        # for a cap that is no power of two (6 -> (1, 2, 4, 6)).
        self.buckets = tuple(sorted(
            {2 ** i for i in range(max(1, max_batch).bit_length())
             if 2 ** i <= max_batch} | {max_batch}))
        self.dispatches = 0  # rollout_batch calls made, for the metrics
        self.requests_dispatched = 0  # requests those dispatches held
        # Queue wait, enqueue to the start of the dispatch's rollout under
        # the device lock: seconds summed over the requests that started.
        self.queue_seconds = 0.0
        self.queue_count = 0
        # Dispatches whose leader found every replica busy, and the
        # requests they took.
        self.held_dispatches = 0
        self.held_requests = 0
        self._lock = threading.Lock()
        self._pending = {}  # (n_particles, n_steps) -> list[_Job]
        # Replicas no leader holds, and the slot events of the leaders
        # waiting for one, oldest first.
        self._free = (len(service.services)
                      if isinstance(service, ReplicaPool) else 1)
        self._waiting = collections.deque()

    def warmup(self, n_particles: int, n_steps: int) -> None:
        """Run every bucket size once for a (N, n_steps) shape."""
        for b in self.buckets:
            self.service.warmup(n_particles, n_steps, batch=b)

    def rollout(self, positions, velocities, masses, n_steps: int,
                trajectory: bool = True):
        pos = np.asarray(positions, np.float32)
        vel = np.asarray(velocities, np.float32)
        masses = np.asarray(masses, np.float32)
        key = (pos.shape[0], int(n_steps))
        job = _Job(pos, vel, masses, trajectory)
        with self._lock:
            queue = self._pending.setdefault(key, [])
            queue.append(job)
            first = len(queue) == 1
            if first:
                self._elect(job)
        job.event.wait()
        if job.slot is not None:
            # Elected: it leads its key's queue and dispatches itself with
            # the first chunk.  Only a leader that found a replica free
            # keeps the window: a held queue gathered followers meanwhile.
            self._lead(key, int(n_steps), job,
                       window=first and not job.held)
        if job.error is not None:
            raise job.error
        return job.result

    def _elect(self, job) -> None:
        """Under the lock: make ``job`` its key's leader and wake its
        thread.  It takes a free replica, or queues for the next."""
        job.slot = threading.Event()
        if self._free:
            self._free -= 1
            job.slot.set()
        else:
            job.held = True
            self._waiting.append(job.slot)
        job.event.set()

    def _lead(self, key, n_steps: int, leader, window: bool) -> None:
        leader.slot.wait()
        deadline = time.monotonic() + self.max_wait_s
        while window and time.monotonic() < deadline:
            with self._lock:
                if len(self._pending[key]) >= self.max_batch:
                    break
            time.sleep(0.0005)
        # The key is popped once drained, so a long-lived server keeps no
        # empty list per request shape.
        with self._lock:
            queue = self._pending.pop(key)
            jobs, rest = queue[:self.max_batch], queue[self.max_batch:]
            if rest:
                self._pending[key] = rest
                self._elect(rest[0])
            if leader.held:
                self.held_dispatches += 1
                self.held_requests += len(jobs)
        try:
            self._dispatch(jobs, n_steps)
        finally:
            with self._lock:
                if self._waiting:
                    self._waiting.popleft().set()
                else:
                    self._free += 1

    def _dispatch(self, jobs, n_steps: int) -> None:
        bucket = next(b for b in self.buckets if b >= len(jobs))
        take = jobs + [jobs[-1]] * (bucket - len(jobs))
        with self._lock:
            self.dispatches += 1
            self.requests_dispatched += len(jobs)
        try:
            # If nobody in this batch wants the trajectory, none is kept.
            want_traj = any(j.trajectory for j in jobs)
            _dispatching.jobs = (self, jobs)
            try:
                out = self.service.rollout_batch(
                    np.stack([j.pos for j in take]),
                    np.stack([j.vel for j in take]),
                    np.stack([j.masses for j in take]), n_steps,
                    trajectory=want_traj)
            finally:
                _dispatching.jobs = None
            for i, j in enumerate(jobs):
                sel = (slice(None) if j.trajectory or not want_traj
                       else -1)
                j.result = {"positions": out["positions"][i][sel],
                            "velocities": out["velocities"][i][sel]}
        except Exception as e:  # surface to every waiter
            for j in jobs:
                j.error = e
        for j in jobs:
            j.event.set()

    def _queue_ended(self, jobs) -> None:
        """The jobs' dispatch starts its rollout: their queue wait ends."""
        now = clock_ns()
        with self._lock:
            self.queue_seconds += sum(now - j.queued_ns for j in jobs) / 1e9
            self.queue_count += len(jobs)
        for j in jobs:
            record_span("serve.queue", j.queued_ns, now, parent=j.waiter)

    def render(self) -> str:
        """The batcher's series in Prometheus text."""
        with self._lock:
            return "\n".join([
                "# HELP nbody_batch_queue_seconds Micro-batched /rollout "
                "requests' wait from enqueue to their dispatch's rollout.",
                "# TYPE nbody_batch_queue_seconds summary",
                f"nbody_batch_queue_seconds_sum {self.queue_seconds:.6f}",
                f"nbody_batch_queue_seconds_count {self.queue_count}",
                "# HELP nbody_batch_requests Requests a micro-batch "
                "dispatch.",
                "# TYPE nbody_batch_requests summary",
                f"nbody_batch_requests_sum {self.requests_dispatched}",
                f"nbody_batch_requests_count {self.dispatches}",
                "# HELP nbody_batch_held_requests Requests a micro-batch "
                "dispatch whose leader found every replica busy and held "
                "its queue.",
                "# TYPE nbody_batch_held_requests summary",
                f"nbody_batch_held_requests_sum {self.held_requests}",
                f"nbody_batch_held_requests_count {self.held_dispatches}"]) \
                + "\n"


def _short_repr(val, limit: int = 80) -> str:
    """Bounded repr for error messages (never echo a multi-MB field)."""
    r = repr(val)
    return r if len(r) <= limit else r[:limit] + f"... ({len(r)} chars)"


def _require_int(val, name: str) -> int:
    """A JSON integer (an integral float is tolerated; a bool or a string
    is a 400, not a silent coercion like int(True) == 1)."""
    if isinstance(val, bool) or not isinstance(val, (int, float)) \
            or (isinstance(val, float) and not val.is_integer()):
        raise ValueError(f"{name} must be a JSON integer, "
                         f"got {_short_repr(val)}")
    return int(val)


def _require_number(val, name: str) -> float:
    if isinstance(val, bool) or not isinstance(val, (int, float)):
        raise ValueError(f"{name} must be a JSON number, "
                         f"got {_short_repr(val)}")
    return float(val)


def _require_bool(payload: dict, key: str, default: bool) -> bool:
    val = payload.get(key, default)
    if not isinstance(val, bool):
        raise ValueError(f"{key} must be a JSON bool, got "
                         f"{type(val).__name__}")
    return val


def _validate(payload: dict, batched: bool) -> Tuple[np.ndarray, np.ndarray,
                                                     np.ndarray, int]:
    try:
        pos = np.asarray(payload["positions"], np.float32)
        vel = np.asarray(payload["velocities"], np.float32)
        masses = np.asarray(payload["masses"], np.float32)
        n_steps = _require_int(payload["n_steps"], "n_steps")
    except (KeyError, TypeError, ValueError) as e:
        raise ValueError(f"bad request: {e}")
    want_dims = 3 if batched else 2
    masses_ok = (masses.ndim == 1 and masses.shape[0] == pos.shape[-2]) or \
        (batched and masses.ndim == 2 and pos.ndim == 3
         and masses.shape == pos.shape[:2])  # per-system masses (B, N)
    if pos.ndim != want_dims or pos.shape != vel.shape \
            or pos.shape[-1] != 3 or not masses_ok:
        raise ValueError(
            f"shape mismatch: positions {pos.shape}, velocities {vel.shape},"
            f" masses {masses.shape} (batched={batched})")
    if not (1 <= n_steps <= 100_000):
        raise ValueError(f"n_steps out of range: {n_steps}")
    if not (np.isfinite(pos).all() and np.isfinite(vel).all()
            and np.isfinite(masses).all()):
        raise ValueError("non-finite values in input arrays")
    return pos, vel, masses, n_steps


_COMPUTE_PATHS = ("/rollout", "/rollout_batch", "/simulate")


class _Inflight:
    """Thread-safe count of requests being handled, which a graceful
    shutdown drains on."""

    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()

    def __enter__(self):
        with self._lock:
            self._n += 1
        return self

    def __exit__(self, *exc):
        with self._lock:
            self._n -= 1

    def count(self) -> int:
        with self._lock:
            return self._n


def make_handler(service: RolloutService,
                 batcher: Optional[MicroBatcher] = None,
                 metrics: Optional[Metrics] = None,
                 max_inflight: Optional[int] = None):
    known_paths = _COMPUTE_PATHS + ("/healthz",)
    # Backpressure: the server starts a thread per connection, so without a
    # bound a burst piles threads, each holding its decoded arrays, onto the
    # device lock.  Beyond max_inflight compute requests the next ones are
    # shed with 503 + Retry-After; /healthz and /metrics never shed.
    gate = threading.Semaphore(max_inflight) if max_inflight else None
    inflight = _Inflight()

    class Handler(BaseHTTPRequestHandler):
        _status = 0  # last response code, recorded by the _reply helpers

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _observed(self, inner) -> None:
            """Run a handler, recording (endpoint, status, wall seconds);
            unknown paths share one label so cardinality stays bounded."""
            if metrics is None or self.path == "/metrics":
                inner()
                return
            t0 = time.perf_counter()
            self._status = 0
            try:
                inner()
            finally:
                endpoint = (self.path if self.path in known_paths
                            else "<other>")
                metrics.observe(endpoint, self._status,
                                time.perf_counter() - t0)

        def _send(self, code: int, body: bytes, ctype: str,
                  headers: Optional[dict] = None) -> None:
            self._status = code
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            for key, val in (headers or {}).items():
                self.send_header(key, val)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        @contextlib.contextmanager
        def _json_stage(self, stage: str):
            """A ``serve.<stage>`` span, its seconds counted in
            ``nbody_json_seconds``."""
            t0 = time.perf_counter()
            try:
                with annotate("serve." + stage):
                    yield
            finally:
                if metrics is not None:
                    metrics.observe_json(stage, time.perf_counter() - t0)

        def _reply(self, code: int, obj: dict) -> None:
            self._send(code, json.dumps(obj).encode(), "application/json")

        def _reply_stream(self, chunks) -> None:
            """NDJSON: one line per chunk, then ``{"done": true}``;
            ``Connection: close`` delimits the body."""
            self._status = 200
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Connection", "close")
            self.end_headers()
            try:
                for obj in chunks:
                    line = json.dumps(
                        {k: v.tolist() if isinstance(v, np.ndarray) else v
                         for k, v in obj.items()})
                    self.wfile.write(line.encode() + b"\n")
                    self.wfile.flush()
                self.wfile.write(b'{"done": true}\n')
            except (BrokenPipeError, ConnectionResetError):
                self._status = 499  # client closed the request
            except Exception as e:
                # Headers are out: report in-band and record a failure.
                self._status = 500
                try:
                    self.wfile.write(json.dumps(
                        {"error": f"{type(e).__name__}: {e}"}).encode()
                        + b"\n")
                except OSError:
                    pass
            self.close_connection = True

        def _start_stream(self, chunks) -> None:
            """Compute the first chunk before the headers, so input errors
            still get a real HTTP status, then stream the rest."""
            first = next(chunks)
            self._reply_stream(itertools.chain([first], chunks))

        def _reply_npz(self, arrays: dict) -> None:
            import io
            buf = io.BytesIO()
            np.savez(buf, **{k: np.asarray(v, np.float32)
                             for k, v in arrays.items()})
            self._send(200, buf.getvalue(), "application/octet-stream")

        def do_GET(self):
            self._observed(self._do_get)

        def _do_get(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok",
                                  "device": service.device,
                                  "model": service.model_info})
            elif self.path == "/metrics" and metrics is not None:
                self._send(200, metrics.render().encode(),
                           "text/plain; version=0.0.4")
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            with inflight, annotate("serve.request", request=NEW_REQUEST,
                                    path=self.path):
                self._gated_post()

        def _gated_post(self):
            if gate is not None and not gate.acquire(blocking=False):
                self._observed(self._shed)
                return
            try:
                self._observed(self._do_post)
            finally:
                if gate is not None:
                    gate.release()

        def _shed(self):
            # Drain the body first: closing a socket with unread data sends
            # a reset that can discard the 503 before the client reads it.
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            self._send(503, json.dumps(
                {"error": f"server busy: max_inflight ({max_inflight}) "
                          "compute requests in flight"}).encode(),
                "application/json", {"Retry-After": "1"})

        def _do_post(self):
            if self.path not in _COMPUTE_PATHS:
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                body = self.rfile.read(length)
                batched = self.path == "/rollout_batch"
                with self._json_stage("decode"):
                    payload = json.loads(body)
                    pos, vel, masses, n_steps = _validate(payload, batched)
                fmt = payload.get("format", "json")
                if fmt not in ("json", "npz"):
                    raise ValueError(f"format must be 'json' or 'npz', "
                                     f"got {fmt!r}")
                stream = _require_bool(payload, "stream", False)
                if stream:
                    if batched:
                        raise ValueError("stream is supported on /rollout "
                                         "and /simulate only")
                    if fmt != "json":
                        raise ValueError("stream responses are NDJSON; "
                                         "use format 'json'")
                if self.path == "/simulate":
                    dt = _require_number(payload.get("dt", 0.001), "dt")
                    save_interval = _require_int(
                        payload.get("save_interval", 1), "save_interval")
                    trajectory = _require_bool(payload, "trajectory", False)
                    if not (0.0 < dt <= 1.0) or not np.isfinite(dt):
                        raise ValueError(f"dt out of range: {dt}")
                    if not (1 <= save_interval <= n_steps):
                        raise ValueError(
                            f"save_interval out of range: {save_interval}")
                    if stream:
                        # Nothing is buffered, so streams are exempt from
                        # the saved-frame cap below.
                        self._start_stream(service.simulate_stream(
                            pos, vel, masses, n_steps, dt=dt,
                            save_interval=save_interval))
                        return
                    if trajectory and n_steps // save_interval > 4000:
                        raise ValueError(
                            "trajectory mode is capped at 4000 saved frames "
                            f"(n_steps/save_interval = "
                            f"{n_steps // save_interval}); raise "
                            "save_interval or lower n_steps")
                    out = service.simulate(
                        pos, vel, masses, n_steps, dt=dt,
                        trajectory=trajectory, save_interval=save_interval)
                else:
                    traj = _require_bool(payload, "trajectory", True)
                    if stream:
                        chunk = _require_int(
                            payload.get("chunk", service.STREAM_CHUNK),
                            "chunk")
                        if not (1 <= chunk <= 1024):
                            raise ValueError(
                                f"chunk out of range [1, 1024]: {chunk}")
                        self._start_stream(service.rollout_stream(
                            pos, vel, masses, n_steps, chunk=chunk))
                        return
                    if batched:
                        run = service.rollout_batch
                    elif batcher is not None:
                        run = batcher.rollout
                    else:
                        run = service.rollout
                    out = run(pos, vel, masses, n_steps, trajectory=traj)
                with self._json_stage("encode"):
                    if fmt == "npz":
                        self._reply_npz(out)
                    else:
                        self._reply(200, {k: v.tolist()
                                          for k, v in out.items()})
            except ValueError as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:  # keep the server alive on bad input
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

    Handler.inflight = inflight
    return Handler


def serve(service: RolloutService, host: str = "127.0.0.1",
          port: int = 8742, batcher: Optional[MicroBatcher] = None,
          max_inflight: Optional[int] = None) -> ThreadingHTTPServer:
    """Start the HTTP server (returns it; call ``serve_forever`` to block).
    ``service`` is a :class:`RolloutService` or a :class:`ReplicaPool`;
    ``batcher`` coalesces concurrent ``/rollout`` requests; ``max_inflight``
    bounds the compute requests in progress (size it to a few times the
    replica count or the micro-batch cap), the excess is shed with 503.
    ``httpd.metrics`` is its :class:`Metrics` registry; ``httpd.inflight``
    counts requests in progress, for a graceful drain."""
    metrics = Metrics(batcher)
    handler = make_handler(service, batcher, metrics,
                           max_inflight=max_inflight)
    httpd = ThreadingHTTPServer((host, port), handler)
    httpd.metrics = metrics
    httpd.inflight = handler.inflight
    return httpd


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="GNN rollout service on the GPU")
    parser.add_argument("--model-path", "-m", default="models/best_rollout_model.pt")
    parser.add_argument("--config-path", "-c", default="models/config.json")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8742)
    parser.add_argument("--device", default=None,
                        help="torch device (default cuda; 'cpu' only when "
                             "asked for)")
    parser.add_argument("--warm-particles", type=int, default=200,
                        help="warm up a rollout of this N (0 = skip)")
    parser.add_argument("--warm-steps", type=int, default=394)
    parser.add_argument("--warm-batch", type=int, default=0,
                        help="also warm up a batched rollout of this size "
                             "(0 = skip)")
    parser.add_argument("--micro-batch", type=int, default=0, metavar="B",
                        help="coalesce concurrent /rollout requests into "
                             "batched rollouts of up to B systems (padded "
                             "to power-of-two buckets; 0 = off)")
    parser.add_argument("--micro-batch-wait-ms", type=float, default=5.0,
                        help="how long a micro-batch leader that finds a "
                             "replica free waits for followers to join")
    parser.add_argument("--quantize", choices=("bf16", "int8"), default=None,
                        help="weight-only quantized weights on the device "
                             "(a smaller resident model; compute stays "
                             "float32)")
    parser.add_argument("--replicas", type=int, default=0, metavar="R",
                        help="one model replica per GPU, up to R (-1 = "
                             "every visible GPU; 0 = a single service)")
    parser.add_argument("--max-inflight", type=int, default=0, metavar="M",
                        help="shed compute requests beyond M in flight with "
                             "503 + Retry-After (0 = unbounded); /healthz "
                             "and /metrics always answer")
    parser.add_argument("--grace-period", type=float, default=10.0,
                        metavar="S",
                        help="seconds to drain in-flight requests on "
                             "SIGTERM/Ctrl-C")
    args = parser.parse_args(argv)

    import signal

    if args.replicas:
        service = build_replica_pool(
            args.model_path, args.config_path,
            n_replicas=None if args.replicas < 0 else args.replicas,
            device=args.device, quantize=args.quantize)
        print(f"Replica pool: {service.model_info['replicas']} replicas "
              f"({service.device})")
    else:
        service = build_service(args.model_path, args.config_path,
                                device=args.device, quantize=args.quantize)
    batcher = MicroBatcher(service, max_batch=args.micro_batch,
                           max_wait_s=args.micro_batch_wait_ms / 1e3) \
        if args.micro_batch > 0 else None

    def _term(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _term)
    httpd = None
    try:
        if args.warm_particles:
            print(f"Warming up (N={args.warm_particles}, "
                  f"steps={args.warm_steps}) on {service.device}...")
            service.warmup(args.warm_particles, args.warm_steps,
                           batch=args.warm_batch or None)
            if batcher is not None:
                print(f"Warming micro-batch buckets {batcher.buckets}...")
                batcher.warmup(args.warm_particles, args.warm_steps)
        httpd = serve(service, host=args.host, port=args.port,
                      batcher=batcher,
                      max_inflight=args.max_inflight or None)
        print(f"Serving on http://{args.host}:{httpd.server_address[1]} "
              f"(endpoints: /healthz, /metrics, /rollout, /rollout_batch, "
              f"/simulate)", flush=True)
        httpd.serve_forever()
    except KeyboardInterrupt:
        print("\nShutting down.")
        if httpd is not None:
            httpd.shutdown()
            deadline = time.time() + args.grace_period
            while httpd.inflight.count() and time.time() < deadline:
                time.sleep(0.1)
            left = httpd.inflight.count()
            if left:
                print(f"Grace period elapsed with {left} request(s) still "
                      "in flight; exiting anyway.")
            httpd.server_close()


if __name__ == "__main__":
    main()
