"""The traffic generator: every seed the same work, the seed's own
states."""

import json

import numpy as np
import pytest

from perfbench import harness, traffic

MIX = json.loads((harness.BENCH / "workloads" / "serve_open_394.json")
                 .read_text())


@pytest.mark.parametrize("order_seed", [None, 7])
def test_every_seed_the_same_arrivals(order_seed):
    mix = dict(MIX, rate_per_s=0.5)
    mix.pop("arrival_order_seed", None)
    if order_seed is not None:
        mix["arrival_order_seed"] = order_seed
    a = traffic.arrivals(mix, 2 ** 31 + 5, 40.0)
    b = traffic.arrivals(mix, 12, 40.0)
    assert len(a) == len(b) == 20 and a[0] == b[0] == 0.0
    assert all(0 <= t < 40.0 for t in a) and a == sorted(a)
    gaps = lambda t: sorted(np.diff(t + [40.0]).round(9))  # noqa: E731
    assert gaps(a) == gaps(b)
    assert (a == b) == (order_seed is not None)


def test_states_come_from_the_seed():
    one = traffic.states(MIX, 50, 2 ** 33 + 1, 3)
    again = traffic.states(MIX, 50, 2 ** 33 + 1, 3)
    other = traffic.states(MIX, 50, 1, 3)
    assert all(np.array_equal(x, y) for x, y in zip(one, again))
    assert not np.array_equal(one[0], other[0])
    pos, vel, masses = one
    assert np.abs(pos).max() <= MIX["box"] / 2
    assert np.abs(vel).max() <= MIX["velocity_scale"] * MIX["box"] / 2
    assert masses.min() >= MIX["mass_range"][0]


def test_request_round_trips_at_float32():
    body = json.loads(json.dumps(traffic.request(MIX, 30, 9, 0)))
    pos, _, _ = traffic.states(MIX, 30, 9, 0)
    assert np.array_equal(np.asarray(body["positions"], np.float32), pos)
    assert body["n_steps"] == MIX["n_steps"] and body["trajectory"] is False
