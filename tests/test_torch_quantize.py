"""Weight-only serving quantization of the port (predict/quantize.py)
against the JAX package's on the same arrays: the cases of
tests/test_quantize.py, plus files crossing between the two packages both
ways.  All on the CPU (``device="cpu"`` asked for)."""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_gnn_hpc_torch.io import (load_checkpoint, load_into,
                                    params_from_jax, params_to_jax,
                                    save_checkpoint)
from nbody_gnn_hpc_torch.models import NBodyGNN
from nbody_gnn_hpc_torch.predict import (MODES, Predictor, dequantize_params,
                                         quantize_checkpoint, quantize_params)
from nbody_gnn_hpc_tpu.io import save_checkpoint as jax_save_checkpoint
from nbody_gnn_hpc_tpu.models import NBodyGNN as JaxGNN
from nbody_gnn_hpc_tpu.models import init_model
from nbody_gnn_hpc_tpu.predict import Predictor as JaxPredictor
from nbody_gnn_hpc_tpu.predict import dequantize_params as jax_dequantize
from nbody_gnn_hpc_tpu.predict import \
    quantize_checkpoint as jax_quantize_checkpoint
from nbody_gnn_hpc_tpu.predict import quantize_params as jax_quantize

REPO = Path(__file__).parent.parent
N, K = 12, 5
KW = dict(node_input_dim=7, hidden_dim=32, n_layers=2, output_dim=6,
          dropout=0.1)
STATS = {"state_mean": np.zeros(6, np.float32),
         "state_std": np.ones(6, np.float32)}


@pytest.fixture(scope="module")
def jparams():
    """JAX-initialised parameters moved off the zero-init head (numpy
    noise), so rollouts move and quantization shows."""
    params = init_model(JaxGNN(**KW), jax.random.PRNGKey(0), N, N * K)
    rng = np.random.RandomState(7)
    return jax.tree_util.tree_map(
        lambda p: np.asarray(p) + 0.05 * rng.randn(*p.shape).astype(
            np.float32), params)


@pytest.fixture(scope="module")
def ckpt(jparams, tmp_path_factory):
    path = tmp_path_factory.mktemp("quant") / "best_model.pt"
    jax_save_checkpoint(path, params=jparams, norm_stats=STATS,
                        model_config=KW)
    return str(path)


def _predictor(path, **kw):
    return Predictor(NBodyGNN(**KW), path, device="cpu", k_neighbors=K, **kw)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(N, 3).astype(np.float32),
            rng.randn(N, 3).astype(np.float32) * 0.1,
            rng.uniform(1e10, 1e12, N).astype(np.float32))


def _tree(rng):
    return {"dense": {"kernel": rng.randn(64, 32).astype(np.float32) * 0.3,
                      "bias": rng.randn(32).astype(np.float32)},
            "norm": {"scale": rng.randn(32).astype(np.float32)}}


def test_int8_equals_jax_and_error_is_bounded():
    w = _tree(np.random.RandomState(0))
    q, jq = quantize_params(w, "int8"), jax_quantize(w, "int8")
    leaf = q["dense"]["kernel"]
    assert set(leaf) == {"q", "scale"}
    assert leaf["q"].dtype == np.int8 and leaf["scale"].shape == (32,)
    np.testing.assert_array_equal(leaf["q"], jq["dense"]["kernel"]["q"])
    np.testing.assert_array_equal(leaf["scale"],
                                  jq["dense"]["kernel"]["scale"])
    np.testing.assert_array_equal(q["dense"]["bias"], w["dense"]["bias"])
    deq = dequantize_params(q)
    np.testing.assert_array_equal(
        deq["dense"]["kernel"], np.asarray(jax_dequantize(jq)["dense"]
                                           ["kernel"]))
    err = np.abs(deq["dense"]["kernel"] - w["dense"]["kernel"])
    assert np.all(err <= leaf["scale"] / 2 + 1e-7)


def test_int8_on_tensors_equals_numpy():
    """The device form (torch leaves) makes the numbers of the file form."""
    w = _tree(np.random.RandomState(1))
    wt = {"dense": {k: torch.from_numpy(v) for k, v in w["dense"].items()},
          "norm": {"scale": torch.from_numpy(w["norm"]["scale"])}}
    q, qt = quantize_params(w, "int8"), quantize_params(wt, "int8")
    assert qt["dense"]["kernel"]["q"].dtype == torch.int8
    np.testing.assert_array_equal(qt["dense"]["kernel"]["q"].numpy(),
                                  q["dense"]["kernel"]["q"])
    np.testing.assert_array_equal(qt["dense"]["kernel"]["scale"].numpy(),
                                  q["dense"]["kernel"]["scale"])
    np.testing.assert_array_equal(
        dequantize_params(qt)["dense"]["kernel"].numpy(),
        dequantize_params(q)["dense"]["kernel"])
    assert qt["dense"]["bias"] is wt["dense"]["bias"]


def test_bf16_casts_kernels_only_and_equals_jax():
    w = _tree(np.random.RandomState(2))
    q, jq = quantize_params(w, "bf16"), jax_quantize(w, "bf16")
    assert q["dense"]["kernel"].dtype == jnp.bfloat16
    assert q["dense"]["bias"].dtype == np.float32
    np.testing.assert_array_equal(
        q["dense"]["kernel"].astype(np.float32),
        np.asarray(jq["dense"]["kernel"]).astype(np.float32))
    deq = dequantize_params(q)
    assert deq["dense"]["kernel"].dtype == np.float32
    np.testing.assert_allclose(deq["dense"]["kernel"], w["dense"]["kernel"],
                               rtol=1e-2, atol=1e-2)
    qt = quantize_params({"k": torch.from_numpy(w["dense"]["kernel"])},
                         "bf16")
    assert qt["k"].dtype == torch.bfloat16
    np.testing.assert_array_equal(dequantize_params(qt)["k"].numpy(),
                                  deq["dense"]["kernel"])


def test_dequantize_plain_tree_is_cast_noop():
    w = {"a": np.random.RandomState(3).randn(4, 4).astype(np.float32),
         "step": 3}
    out = dequantize_params(w)
    np.testing.assert_array_equal(out["a"], w["a"])
    assert out["step"] == 3


def test_bad_mode_raises():
    assert MODES == ("bf16", "int8")
    with pytest.raises(ValueError, match="mode"):
        quantize_params({}, "fp4")


@pytest.mark.parametrize("mode,rtol", [("bf16", 2e-2), ("int8", 5e-2)])
def test_predictor_quantized_close_to_f32_and_to_jax(ckpt, jparams, mode,
                                                     rtol):
    """The tolerances of tests/test_quantize.py against the float32
    rollout; against the JAX Predictor quantized the same way 1e-4 of
    scale (the same weights, float32 summation order)."""
    pos, vel, masses = _inputs()
    pred = _predictor(ckpt)
    base = pred.predict_rollout(pos, vel, masses, n_steps=5)
    n_params = sum(p.numel() for p in pred.model.parameters())
    pred.quantize(mode)
    assert pred.quantization == mode
    quant = pred.predict_rollout(pos, vel, masses, n_steps=5)
    scale = np.abs(base["positions"]).max()
    np.testing.assert_allclose(quant["positions"], base["positions"],
                               rtol=rtol, atol=rtol * scale)
    assert not np.array_equal(quant["positions"], base["positions"])
    # The float32 kernels left the model: the quantized tree is resident.
    assert sum(p.numel() for p in pred.model.parameters()) < n_params / 10
    with pytest.raises(ValueError, match="already"):
        pred.quantize(mode)
    jpred = JaxPredictor(JaxGNN(**KW), k_neighbors=K, params=jparams)
    jpred.norm_stats = STATS
    jpred.quantize(mode)
    want = jpred.predict_rollout(pos, vel, masses, n_steps=5)
    np.testing.assert_allclose(quant["positions"], want["positions"],
                               rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_quantized_checkpoint_roundtrip_and_cross_loading(ckpt, tmp_path,
                                                          mode):
    """A file written by either package serves in both."""
    pos, vel, masses = _inputs(1)
    base = _predictor(ckpt).predict_single(pos, vel, masses)
    scale = np.abs(base[0]).max()
    ours, theirs = tmp_path / f"port.{mode}.pt", tmp_path / f"jax.{mode}.pt"
    info = quantize_checkpoint(ckpt, str(ours), mode)
    jax_quantize_checkpoint(ckpt, str(theirs), mode)
    assert info["mode"] == mode and info["ratio"] > 1.5
    assert ours.stat().st_size < Path(ckpt).stat().st_size
    assert load_checkpoint(ours)["quantization"] == mode
    assert load_checkpoint(ours)["optimizer_state_dict"] is None
    results = []
    for path in (ours, theirs):
        loaded = _predictor(str(path))
        assert loaded.quantization == mode
        results.append(loaded.predict_single(pos, vel, masses)[0])
        jloaded = JaxPredictor(JaxGNN(**KW), str(path), k_neighbors=K)
        assert jloaded.quantization == mode
        np.testing.assert_allclose(
            jloaded.predict_single(pos, vel, masses)[0], results[-1],
            rtol=0, atol=1e-4 * scale)
    np.testing.assert_array_equal(results[0], results[1])
    np.testing.assert_allclose(results[0], base[0], atol=5e-2 * scale)
    # A float32 checkpoint loads again over quantized weights.
    loaded.load_model(ckpt)
    assert loaded.quantization is None
    np.testing.assert_array_equal(
        loaded.predict_single(pos, vel, masses)[0], base[0])


def test_load_into_dequantizes_a_quantized_checkpoint(ckpt, tmp_path):
    dst = tmp_path / "m.int8.pt"
    quantize_checkpoint(ckpt, str(dst), "int8")
    model, ref = NBodyGNN(**KW), NBodyGNN(**KW)
    stats = load_into(model, load_checkpoint(dst))
    load_into(ref, load_checkpoint(ckpt))
    assert set(stats) == {"state_mean", "state_std"}
    for (name, p), q in zip(model.named_parameters(), ref.parameters()):
        assert p.dtype == torch.float32 and p.shape == q.shape
        if p.dim() == 1:
            assert torch.equal(p, q), name
        else:
            bound = q.abs().amax(dim=1, keepdim=True) / 127 / 2 + 1e-7
            assert torch.all((p - q).abs() <= bound), name


def test_requantize_rejected(ckpt, tmp_path):
    dst = tmp_path / "m.bf16.pt"
    quantize_checkpoint(ckpt, str(dst), "bf16")
    with pytest.raises(ValueError, match="already"):
        quantize_checkpoint(str(dst), str(tmp_path / "m2.pt"), "int8")


def test_device_tree_roundtrips_the_state_dict():
    """params_to_jax(numpy=False) keeps tensors; params_from_jax takes
    them back."""
    model = NBodyGNN(generator=torch.Generator().manual_seed(0), **KW)
    sd = model.state_dict()
    tree = params_to_jax(sd, numpy=False)
    assert torch.is_tensor(tree["layer_0"]["edge_out"]["kernel"])
    back = params_from_jax(tree)
    assert list(back) == list(sd)
    assert all(torch.equal(back[k], sd[k]) and back[k].is_contiguous()
               for k in sd)


def test_quantize_cli(tmp_path):
    model = NBodyGNN(node_input_dim=7, hidden_dim=16, n_layers=1,
                     output_dim=6,
                     generator=torch.Generator().manual_seed(0))
    src = tmp_path / "m.pt"
    save_checkpoint(src, params=params_to_jax(model.state_dict()))
    out = subprocess.run(
        [sys.executable, "-m", "nbody_gnn_hpc_torch.quantize_model",
         "-m", str(src), "--mode", "int8"],
        capture_output=True, text=True, timeout=240, cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert (tmp_path / "m.int8.pt").exists()
    assert "smaller" in out.stdout
