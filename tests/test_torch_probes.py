"""The port's rate probes (nbody_gnn_hpc_torch/ops/probes.py), its ceilings
command (nbody_gnn_hpc_torch/roofline.py) and its trace hooks
(nbody_gnn_hpc_torch/utils/profiling.py), on the CPU.

The JAX counterparts of the probes are closures inside ``main()`` of
``benchmarks/roofline.py``, which runs the whole benchmark and writes
``benchmarks/results.json``, so they cannot be imported: their bodies are
copied here, with the lines they come from, and run through
``pl.pallas_call(..., interpret=True)`` (the Pallas kernels) or ``jax.jit``
(the XLA chains).  On the CPU each wrapper takes its plain version, which
repeats the CUDA kernel's loop in torch ops; the kernels themselves are held
against these plain versions on the card (tests/test_torch_gpu.py).
"""

import hashlib
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental import pallas as pl

from nbody_gnn_hpc_torch import roofline
from nbody_gnn_hpc_torch.ops import (fma_probe, fma_probe_reference,
                                     rsqrt_probe, rsqrt_probe_reference)
from nbody_gnn_hpc_torch.utils import annotate, device_trace

REPO = Path(__file__).resolve().parent.parent
TILE, K, UNROLL = (8, 128), 64, 8
# XLA on the CPU contracts a * c + x into one FMA, as the CUDA kernel's
# __fmaf_rn does, and the plain version rounds each step once too: the FMA
# forms agree bit for bit; the rsqrt forms by 1.2e-07 (rsqrt rounding).
PROBE_RTOL = 1e-6
TINY = dict(chain_shape=(8, 128), chain_steps=16, chain4_shape=(8, 128),
            probe_shape=(8, 128), probe_steps=16, mm_size=32, mm_chain=2)
RATES = ("chain_fma_f32_tflops", "chain4_fma_f32_tflops",
         "chain_rsqrt_grate_gps", "kernel_fma_f32_tflops",
         "kernel_fma_tslots", "kernel_rsqrt_grate_gps", "tc_bf16_tflops")
SLOT_COSTS = ("chain_rsqrt_slot_cost", "kernel_rsqrt_slot_cost")


# benchmarks/roofline.py:184-198, with k_pl = K and unroll_pl = UNROLL.
def _vpu_fma_kernel(x_ref, o_ref):
    x = x_ref[...]
    c1, c2, c3, c4 = (jnp.float32(0.9999), jnp.float32(0.9998),
                      jnp.float32(0.9997), jnp.float32(0.9996))

    def body(i, accs):
        a1, a2, a3, a4 = accs
        for _ in range(UNROLL):
            a1, a2, a3, a4 = (a1 * c1 + x, a2 * c2 + x,
                              a3 * c3 + x, a4 * c4 + x)
        return (a1, a2, a3, a4)

    a1, a2, a3, a4 = lax.fori_loop(0, K // UNROLL, body, (x, x, x, x))
    o_ref[...] = (a1 + a2) + (a3 + a4)


# benchmarks/roofline.py:214-227, with k_pl = K and unroll_pl = UNROLL.
def _vpu_rsqrt_kernel(x_ref, o_ref):
    x = x_ref[...]
    b = jnp.float32(1e-4)

    def body(i, accs):
        a1, a2, a3, a4 = accs
        for _ in range(UNROLL):
            a1, a2, a3, a4 = (lax.rsqrt(a1) + b, lax.rsqrt(a2) + b,
                              lax.rsqrt(a3) + b, lax.rsqrt(a4) + b)
        return (a1, a2, a3, a4)

    a1, a2, a3, a4 = lax.fori_loop(
        0, K // UNROLL, body, (x, x + 1.0, x + 2.0, x + 3.0))
    o_ref[...] = (a1 + a2) + (a3 + a4)


# benchmarks/roofline.py:89-96 and :117-124 (unroll, k_iters = UNROLL,
# K // UNROLL; a, b = 0.9999, 1e-4 as at :98-99).
@jax.jit
def fma_chain(x):
    a, b = jnp.float32(0.9999), jnp.float32(1e-4)

    def body(i, x):
        for _ in range(UNROLL):
            x = x * a + b
        return x

    return lax.fori_loop(0, K // UNROLL, body, x)


@jax.jit
def rsqrt_chain(x):
    b = jnp.float32(1e-4)

    def body(i, x):
        for _ in range(UNROLL):
            x = lax.rsqrt(x) + b
        return x

    return lax.fori_loop(0, K // UNROLL, body, x)


# benchmarks/roofline.py:145-156 (unroll // 4 steps an iteration, k_iters *
# 4 iterations: K steps per accumulator).
@jax.jit
def fma4_chain(x):
    a, b = jnp.float32(0.9999), jnp.float32(1e-4)

    def body(i, accs):
        a1, a2, a3, a4 = accs
        for _ in range(UNROLL // 4):
            a1, a2, a3, a4 = (a1 * a + b, a2 * a + b, a3 * a + b, a4 * a + b)
        return (a1, a2, a3, a4)

    a1, a2, a3, a4 = lax.fori_loop(0, K * 4 // UNROLL, body,
                                   (x, x + 1.0, x + 2.0, x + 3.0))
    return (a1 + a2) + (a3 + a4)


def _pallas(body):
    return lambda x: pl.pallas_call(
        body, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32),
        interpret=True)(x)


# name: (JAX function, the probe form of the ceilings measurement that
# stands for it).  The port's wrapper and arguments come from the
# measurement's own table, roofline.probe_forms, so that table is what is
# held against the JAX bodies.
FORMS = {
    "kernel10": (_pallas(_vpu_fma_kernel), "kernel_fma"),
    "kernel11": (_pallas(_vpu_rsqrt_kernel), "kernel_rsqrt"),
    "fma_chain": (fma_chain, "chain_fma"),
    "rsqrt_chain": (rsqrt_chain, "chain_rsqrt"),
    "fma4_chain": (fma4_chain, "chain4_fma"),
}
ROOFLINE_FORMS = {f[0]: f for f in roofline.probe_forms(**roofline.SHAPES)}
PLAIN = {fma_probe: fma_probe_reference, rsqrt_probe: rsqrt_probe_reference}


def _x(shape=TILE, seed=3):
    return np.random.RandomState(seed).uniform(0.5, 1.5, shape).astype(
        np.float32)


@pytest.mark.parametrize("name", sorted(FORMS))
def test_plain_version_matches_jax(name):
    jax_fn, form = FORMS[name]
    _, wrapper, _, _, _, kw = ROOFLINE_FORMS[form]
    plain = PLAIN[wrapper]
    x = _x()
    want = np.asarray(jax_fn(jnp.asarray(x)))
    got = wrapper(torch.from_numpy(x), K, **kw)  # a CPU tensor: the plain form
    assert got.shape == TILE and got.dtype == torch.float32
    assert torch.equal(got, plain(torch.from_numpy(x), K, **kw))
    np.testing.assert_allclose(got.numpy(), want, rtol=PROBE_RTOL, atol=0)
    assert wrapper.launches == 0  # counts kernel launches only


def test_ceilings_forms_are_the_scripts():
    """The measurement launches the five forms above, each at the script's
    shape and step count, and nothing else."""
    assert set(ROOFLINE_FORMS) == {form for _, form in FORMS.values()}
    shapes = {name: (tuple(shape), steps) for name, _, shape, _, steps, _
              in ROOFLINE_FORMS.values()}
    assert shapes == {"chain_fma": ((1024, 1024), 4096),
                      "chain_rsqrt": ((1024, 1024), 4096),
                      "chain4_fma": ((512, 512), 4096),
                      "kernel_fma": ((256, 1024), 1024),
                      "kernel_rsqrt": ((256, 1024), 1024)}


def test_the_plain_fma_rounds_once_as_the_kernel_does():
    """Why the plain version takes each step in float64: a float32 multiply
    and add round twice, and with multipliers as close to 1 as 0.9999 the
    loop barely contracts, so over a kernel run of 1,024 steps they drift
    from the fused form by more than the kernel's 1e-5 tolerance."""
    x = torch.from_numpy(_x())
    fused = fma_probe_reference(x, 1024)
    acc = [x.clone() for _ in range(4)]
    for _ in range(1024):
        acc = [a * torch.tensor(c) + x for a, c in
               zip(acc, (0.9999, 0.9998, 0.9997, 0.9996))]
    twice = (acc[0] + acc[1]) + (acc[2] + acc[3])
    assert ((twice - fused).abs() / fused.abs()).max() > 1e-5


def test_probe_defaults_are_the_pallas_kernels():
    """The wrappers' defaults are kernels 10 and 11 at the script's k."""
    assert fma_probe.__defaults__[0] == rsqrt_probe.__defaults__[0] == 1024
    x = torch.from_numpy(_x())
    torch.testing.assert_close(
        fma_probe(x, K), fma_probe(x, K, mul=(0.9999, 0.9998, 0.9997, 0.9996),
                                   start=(0.0,) * 4, add=None))
    torch.testing.assert_close(
        rsqrt_probe(x, K), rsqrt_probe(x, K, start=(0.0, 1.0, 2.0, 3.0),
                                       add=1e-4))


def test_probes_refuse_other_accumulator_counts():
    x = torch.from_numpy(_x())
    with pytest.raises(ValueError, match="accumulators"):
        fma_probe(x, 4, mul=(0.9, 0.9), start=(0.0, 1.0))
    with pytest.raises(ValueError, match="accumulators"):
        fma_probe(x, 4, mul=(0.9,), start=(0.0, 1.0, 2.0, 3.0))
    with pytest.raises(ValueError, match="accumulators"):
        rsqrt_probe(x, 4, start=(0.0, 1.0, 2.0))
    with pytest.raises(ValueError, match="cuda or cpu"):
        fma_probe(x.to("meta"), 4)
    assert fma_probe.launches == rsqrt_probe.launches == 0


def _tree_digest(root: Path) -> str:
    digest = hashlib.sha256()
    for path in sorted(root.rglob("*")):
        if path.is_file() and "__pycache__" not in path.parts:
            digest.update(str(path.relative_to(root)).encode())
            digest.update(path.read_bytes())
    return digest.hexdigest()


def test_ceilings_measurement_on_cpu_at_tiny_shapes():
    result = roofline.measure_ceilings("cpu", **TINY)
    assert result["device"] == "cpu" and result["timer"] == "host clock"
    for key in RATES:
        assert math.isfinite(result[key]) and result[key] > 0, key
        share = result["share_of_published_peak"][key]
        assert math.isfinite(share) and share > 0, key
    # On the CPU both plain steps are two torch ops of one size, so the sign
    # of a slot cost there is noise; on the card it is the rsqrt's cost.
    for key in SLOT_COSTS:
        assert math.isfinite(result[key]), key
    assert set(result["ms"]) == {"chain_fma", "chain_rsqrt", "chain4_fma",
                                 "kernel_fma", "kernel_rsqrt",
                                 "tc_bf16_chain"}
    assert all(t > 0 for t in result["ms"].values())
    json.dumps(result)  # one JSON line


def test_ceilings_command_writes_only_where_asked(tmp_path, monkeypatch,
                                                  capsys):
    """``--out`` writes the printed line; nothing under benchmarks/
    changes, and a path there is refused before anything runs."""
    before = _tree_digest(REPO / "benchmarks")
    monkeypatch.setattr(roofline, "SHAPES", TINY)
    out = tmp_path / "ceilings.json"
    assert roofline.main(["--device", "cpu", "--out", str(out)]) == 0
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(out.read_text()) == json.loads(printed)
    assert roofline.main(["--device", "cpu"]) == 0
    with pytest.raises(ValueError, match="benchmarks/"):
        roofline.main(["--device", "cpu", "--out",
                       str(REPO / "benchmarks" / "ceilings.json")])
    assert _tree_digest(REPO / "benchmarks") == before


def test_ceilings_command_raises_without_a_gpu():
    """``python -m nbody_gnn_hpc_torch.roofline`` runs on the card unless
    asked for the CPU: without a GPU it raises."""
    proc = subprocess.run(
        [sys.executable, "-m", "nbody_gnn_hpc_torch.roofline"], cwd=REPO,
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": str(REPO),
             "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr
    assert proc.stdout == ""


def test_device_trace_is_a_noop_without_a_directory(tmp_path):
    with device_trace(None):
        torch.ones(4).sum()
    assert not any(tmp_path.iterdir())


def test_device_trace_writes_annotated_regions(tmp_path):
    log_dir = tmp_path / "trace"
    with device_trace(str(log_dir)):
        with annotate("ceilings_probe_region"):
            fma_probe(torch.from_numpy(_x()), 4)
    traces = list(log_dir.glob("*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(e.get("name") == "ceilings_probe_region" for e in events)
