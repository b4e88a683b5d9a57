"""Typed client for the rollout HTTP service (serve.py).

A copy of ``nbody_gnn_hpc_tpu/client.py``: both services speak the same
wire protocol, and this package imports nothing from the JAX one.

The service speaks plain JSON/npz/NDJSON over HTTP, so any language can
call it; this module is the canonical Python consumer — it picks the
efficient transport for each call so users don't have to know the wire
details (binary npz bodies for bulk trajectories, NDJSON streaming for
incremental consumption, final-state-only programs for next-state serving).

Stdlib-only (urllib), mirroring the server's no-dependency design.

    from nbody_gnn_hpc_torch.client import RolloutClient
    c = RolloutClient("http://localhost:8742")
    out = c.rollout(pos, vel, masses, n_steps=394)        # npz transport
    final = c.rollout(pos, vel, masses, 394, trajectory=False)
    for chunk in c.rollout_stream(pos, vel, masses, 394):  # frames as they
        consume(chunk["positions"])                        # are computed
"""

import io
import json
import urllib.error
import urllib.request
from typing import Dict, Iterator, Optional

import numpy as np

__all__ = ["RolloutClient", "ServiceError"]


class ServiceError(RuntimeError):
    """An HTTP error or an in-band mid-stream error from the service."""

    def __init__(self, message: str, status: Optional[int] = None):
        super().__init__(message)
        self.status = status


def _state_payload(positions, velocities, masses, n_steps: int) -> dict:
    return {
        "positions": np.asarray(positions, np.float32).tolist(),
        "velocities": np.asarray(velocities, np.float32).tolist(),
        "masses": np.asarray(masses, np.float32).tolist(),
        "n_steps": int(n_steps),
    }


class RolloutClient:
    """Client for one service endpoint base URL.

    ``fmt``: default response transport for bulk calls — "npz" (binary
    f32, ~5x smaller than JSON and far cheaper to parse; the default) or
    "json".

    ``retries_503``: how many times to retry a request the server shed
    with 503 (its ``max_inflight`` backpressure), honoring the response's
    Retry-After delay. Default 0 — shedding surfaces as ServiceError so
    callers with their own load control see it immediately.
    """

    def __init__(self, base_url: str, timeout: float = 600.0,
                 fmt: str = "npz", retries_503: int = 0):
        if fmt not in ("json", "npz"):
            raise ValueError(f"fmt must be 'json' or 'npz', got {fmt!r}")
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.fmt = fmt
        self.retries_503 = int(retries_503)

    # -- transport ----------------------------------------------------------

    def _open(self, path: str, payload: dict):
        """POST and return the open response, mapping HTTP errors to
        ServiceError with the server's in-body message (after exhausting
        any configured 503 retries)."""
        import time

        data = json.dumps(payload).encode()
        attempt = 0
        while True:
            req = urllib.request.Request(
                f"{self.base_url}{path}", data=data,
                headers={"Content-Type": "application/json"})
            try:
                return urllib.request.urlopen(req, timeout=self.timeout)
            except urllib.error.HTTPError as e:
                detail = e.read().decode(errors="replace")
                if e.code == 503 and attempt < self.retries_503:
                    attempt += 1
                    try:
                        delay = float(e.headers.get("Retry-After") or 1.0)
                    except ValueError:
                        delay = 1.0
                    time.sleep(min(max(delay, 0.0), 30.0))
                    continue
                try:
                    detail = json.loads(detail).get("error", detail)
                except ValueError:
                    pass
                raise ServiceError(detail, status=e.code) from None

    def _post(self, path: str, payload: dict) -> Dict[str, np.ndarray]:
        with self._open(path, payload) as resp:
            body = resp.read()
            if resp.headers.get("Content-Type") == \
                    "application/octet-stream":
                return dict(np.load(io.BytesIO(body)))
        return {k: np.asarray(v) for k, v in json.loads(body).items()}

    # -- endpoints ----------------------------------------------------------

    def healthz(self) -> dict:
        with urllib.request.urlopen(f"{self.base_url}/healthz",
                                    timeout=self.timeout) as resp:
            return json.loads(resp.read())

    def rollout(self, positions, velocities, masses, n_steps: int,
                trajectory: bool = True) -> Dict[str, np.ndarray]:
        """GNN surrogate rollout: ``positions``/``velocities`` arrays of
        shape (n_steps+1, N, 3), or the final (N, 3) state when
        ``trajectory=False`` (a cheaper compiled program AND a tiny
        response — the right call for next-state serving)."""
        payload = _state_payload(positions, velocities, masses, n_steps)
        payload["trajectory"] = trajectory
        payload["format"] = self.fmt
        return self._post("/rollout", payload)

    def rollout_batch(self, positions, velocities, masses, n_steps: int,
                      trajectory: bool = True) -> Dict[str, np.ndarray]:
        """Batched rollout: (B, N, 3) inputs, one device program for the
        whole batch; ``masses`` is (N,) shared or (B, N) per system."""
        payload = _state_payload(positions, velocities, masses, n_steps)
        payload["trajectory"] = trajectory
        payload["format"] = self.fmt
        return self._post("/rollout_batch", payload)

    def rollout_stream(self, positions, velocities, masses, n_steps: int,
                       chunk: Optional[int] = None
                       ) -> Iterator[Dict[str, np.ndarray]]:
        """Stream the rollout: yields ``{"frame_start": int, "positions":
        (F, N, 3), "velocities": (F, N, 3)}`` chunks as the server computes
        them (frames concatenate to the ``trajectory=True`` rollout).
        Abandoning the iterator closes the connection, which stops the
        server computing further chunks."""
        payload = _state_payload(positions, velocities, masses, n_steps)
        payload["stream"] = True
        if chunk is not None:
            payload["chunk"] = int(chunk)
        yield from self._stream("/rollout", payload)

    def simulate(self, positions, velocities, masses, n_steps: int,
                 dt: float = 0.001, trajectory: bool = False,
                 save_interval: int = 1) -> Dict[str, np.ndarray]:
        """Exact-physics N-body run on the service's device (final state by
        default; sampled trajectory with ``trajectory=True``)."""
        payload = _state_payload(positions, velocities, masses, n_steps)
        payload.update(dt=float(dt), trajectory=trajectory,
                       save_interval=int(save_interval), format=self.fmt)
        return self._post("/simulate", payload)

    def simulate_stream(self, positions, velocities, masses, n_steps: int,
                        dt: float = 0.001, save_interval: int = 1
                        ) -> Iterator[Dict[str, np.ndarray]]:
        """Stream an exact-physics trajectory (exempt from the buffered
        trajectory-mode saved-frame cap — nothing is held server-side)."""
        payload = _state_payload(positions, velocities, masses, n_steps)
        payload.update(dt=float(dt), save_interval=int(save_interval),
                       stream=True)
        yield from self._stream("/simulate", payload)

    def _stream(self, path: str, payload: dict
                ) -> Iterator[Dict[str, np.ndarray]]:
        with self._open(path, payload) as resp:
            for raw in resp:
                obj = json.loads(raw)
                if "error" in obj:
                    raise ServiceError(obj["error"])
                if obj.get("done"):
                    return
                yield {k: (np.asarray(v, np.float32)
                           if isinstance(v, list) else v)
                       for k, v in obj.items()}
        raise ServiceError("stream ended without the done terminator "
                           "(connection dropped mid-stream)")
