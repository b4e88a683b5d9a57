"""The one generator of serving traffic: it reads a mix's parameters (a
``perfbench/workloads/*.json`` file) and makes, from the run's seed, the
arrival times and the requests.

Parameters: ``n_steps`` (the rollout horizon of every request), ``box``
(positions uniform in a cube of that side), ``velocity_scale`` (velocities
uniform in +-scale * box / 2), ``mass_range``, and for an open loop
``rate_per_s`` with ``arrivals: "poisson"``.

Every seed gets the same work: the same number of requests, the same gaps
between arrivals (the exponential distribution's quantiles at the mix's
rate), in an order of its own, or, where the mix gives
``arrival_order_seed``, in the one order that seed draws; only the
particles' states differ.
"""

import math
from typing import List

import numpy as np


def _rng(seed: int, *stream: int) -> np.random.Generator:
    """A NumPy generator for (seed, stream...), for any seed below 2^64."""
    return np.random.default_rng(np.random.SeedSequence(
        [seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, *stream]))


def arrivals(mix: dict, seed: int, seconds: float) -> List[float]:
    """Due times (seconds from the window's start) of an open loop: round(
    rate * seconds) requests, the first at 0, the gaps the exponential's
    quantiles scaled to fill the window, in the order drawn from the mix's
    ``arrival_order_seed`` where it has one, else from ``seed``."""
    if mix.get("arrivals") != "poisson":
        raise ValueError(f"unknown arrivals {mix.get('arrivals')!r}")
    m = max(1, round(float(mix["rate_per_s"]) * seconds))
    gaps = np.array([-math.log(1.0 - (i + 0.5) / m) for i in range(m)])
    gaps *= seconds / gaps.sum()
    order = _rng(int(mix.get("arrival_order_seed", seed)), 1).permutation(m)
    times = np.concatenate([[0.0], np.cumsum(gaps[order])[:-1]])
    return times.tolist()


def states(mix: dict, n: int, seed: int, index: int):
    """(positions, velocities, masses) of request ``index``, float32."""
    rng = _rng(seed, 2, index)
    box = float(mix["box"])
    pos = ((rng.random((n, 3)) - 0.5) * box).astype(np.float32)
    vel = ((rng.random((n, 3)) - 0.5) * float(mix["velocity_scale"])
           * box).astype(np.float32)
    lo, hi = mix["mass_range"]
    masses = rng.uniform(lo, hi, n).astype(np.float32)
    return pos, vel, masses


def request(mix: dict, n: int, seed: int, index: int) -> dict:
    """The JSON body of request ``index``: a final-state rollout."""
    pos, vel, masses = states(mix, n, seed, index)
    return {"positions": pos.tolist(), "velocities": vel.tolist(),
            "masses": masses.tolist(), "n_steps": int(mix["n_steps"]),
            "trajectory": False}
