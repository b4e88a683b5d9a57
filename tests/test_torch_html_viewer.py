"""The port's interactive HTML viewer (nbody_gnn_hpc_torch/utils/
html_viewer.py): byte-equal to the JAX package's for the same inputs, its
subsampling and its refusal of a bad shape."""

import json
import re

import numpy as np
import pytest
import torch

from nbody_gnn_hpc_torch.utils import export_interactive_html
from nbody_gnn_hpc_tpu.utils import \
    export_interactive_html as jax_export_interactive_html


def _data(path):
    return json.loads(re.search(r"const DATA = (\{.*?\});\n",
                                path.read_text(), re.S).group(1))


@pytest.mark.parametrize("case", ["small_with_times", "subsampled",
                                  "truncated_particles"])
def test_html_is_byte_equal_to_jax(tmp_path, case):
    r = np.random.RandomState(0)
    t, n, kw = {"small_with_times": (30, 10, {"title": "Test Run"}),
                "subsampled": (1000, 8, {"max_steps": 100}),
                "truncated_particles": (12, 40, {"max_particles": 25})}[case]
    pos = np.cumsum(r.randn(t, n, 3), axis=0)
    masses = r.uniform(1e10, 1e12, n)
    times = np.arange(t) * 0.001 if case == "small_with_times" else None
    want = jax_export_interactive_html(pos, masses, tmp_path / "jax.html",
                                       times=times, **kw)
    got = export_interactive_html(pos, masses, tmp_path / "port.html",
                                  times=times, **kw)
    from_tensors = export_interactive_html(
        torch.from_numpy(pos), torch.from_numpy(masses),
        tmp_path / "tensors.html",
        times=None if times is None else torch.from_numpy(times), **kw)
    assert open(got, "rb").read() == open(want, "rb").read()
    assert open(from_tensors, "rb").read() == open(want, "rb").read()
    data = _data(tmp_path / "port.html")
    stride = -(-t // kw.get("max_steps", 400))
    assert len(data["positions"]) == len(range(0, t, stride))
    assert len(data["positions"][0]) == len(data["masses"]) == \
        min(n, kw.get("max_particles", 2000))
    assert ("times" in data) == (times is not None)


def test_export_subsamples_big_trajectories(tmp_path):
    r = np.random.RandomState(1)
    out = export_interactive_html(r.randn(1000, 8, 3), np.ones(8),
                                  tmp_path / "big.html", max_steps=100)
    assert len(_data(tmp_path / "big.html")["positions"]) == 100
    assert out == str(tmp_path / "big.html")


def test_export_rejects_bad_shape(tmp_path):
    with pytest.raises(ValueError):
        export_interactive_html(np.zeros((5, 3)), np.ones(3),
                                tmp_path / "x.html")
