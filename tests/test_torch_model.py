"""Port GNN (nbody_gnn_hpc_torch/models) against the JAX NBodyGNN.

Weights are made by the JAX ``init_model`` (or read from the committed
production checkpoint) and carried across with ``params_from_jax``; inputs
come from a seeded numpy RNG.
"""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_gnn_hpc_torch.io import load_checkpoint, load_into, params_from_jax
from nbody_gnn_hpc_torch.models import (NBodyGNN, count_parameters,
                                        model_from_config)
from nbody_gnn_hpc_torch.ops import knn_edge_index
from nbody_gnn_hpc_tpu.models import NBodyGNN as JaxGNN
from nbody_gnn_hpc_tpu.models import count_parameters as jax_count
from nbody_gnn_hpc_tpu.models import init_model
from nbody_gnn_hpc_tpu.models.gnn import model_from_config as jax_from_config
from nbody_gnn_hpc_tpu.ops.knn import knn_edge_index as jax_knn

N, K, H, LAYERS = 16, 4, 32, 2
CKPT = "models/best_rollout_model.pt"
CONFIG = "models/config.json"


def _small(seed=0):
    kw = dict(node_input_dim=7, hidden_dim=H, n_layers=LAYERS, output_dim=6,
              dropout=0.1)
    jparams = init_model(JaxGNN(remat=False, **kw), jax.random.PRNGKey(seed),
                         N, N * K)
    # Non-zero decoder_out so the comparison sees the whole network.
    jparams = jax.tree_util.tree_map(
        lambda p: p + 0.01 * np.sign(np.arange(p.size).reshape(p.shape) % 3
                                     - 1), jparams)
    model = NBodyGNN(**kw)
    model.load_state_dict(params_from_jax(jparams))
    return kw, jparams, model.eval()


def _graph(n, k, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, 7).astype(np.float32)
    ei = np.asarray(jax_knn(jnp.asarray(x[:, :3]), k))
    return x, ei


def test_parameter_count_matches_reference():
    model = NBodyGNN(hidden_dim=256, n_layers=6)
    assert count_parameters(model) == 2_550_150
    kw, jparams, small = _small()
    assert count_parameters(small) == jax_count(jparams)


@pytest.mark.parametrize("edge_impl", ["fused", "xla"])
def test_forward_matches_jax(edge_impl):
    """JAX "fused" runs the Pallas kernel in interpret mode on the CPU;
    tolerance: f32 summation order through 2 layers of LayerNorm."""
    kw, jparams, model = _small(seed=1)
    x, ei = _graph(N, K, seed=2)
    want = JaxGNN(remat=False, edge_impl=edge_impl, **kw).apply(
        {"params": jparams}, jnp.asarray(x), jnp.asarray(ei),
        deterministic=True)
    with torch.inference_mode():
        got = model(torch.from_numpy(x), torch.tensor(ei).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_batched_forward_equals_per_graph():
    _, _, model = _small(seed=3)
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(3, 13, 7).astype(np.float32))
    ei = knn_edge_index(x[..., :3], 4)
    with torch.inference_mode():
        batched = model(x, ei)
        for b in range(3):
            torch.testing.assert_close(batched[b], model(x[b], ei[b]),
                                       rtol=1e-6, atol=1e-6)
        shared = model(x, ei[0])  # one (2, E) edge set for the whole batch
        torch.testing.assert_close(shared[1], model(x[1], ei[0]),
                                   rtol=1e-6, atol=1e-6)


def test_zero_init_decoder_returns_input_state():
    model = NBodyGNN(hidden_dim=H, n_layers=LAYERS,
                     generator=torch.Generator().manual_seed(0)).eval()
    x = torch.randn(N, 7, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        out = model(x, knn_edge_index(x[:, :3], K))
    assert torch.equal(out, x[:, :6])


def test_lecun_normal_init_matches_flax_distribution():
    model = NBodyGNN(hidden_dim=256, n_layers=1,
                     generator=torch.Generator().manual_seed(0))
    w = model.layers[0].edge_proj_source.weight  # fan_in 256
    std = 1 / np.sqrt(256)
    assert abs(w.std().item() - std) < 0.02 * std
    assert w.abs().max().item() <= 2 * std / 0.87962566103423978 + 1e-7
    assert torch.all(model.layers[0].edge_proj_target.bias == 0)
    assert torch.all(model.norms[0].weight == 1)
    ref = jax_count(init_model(JaxGNN(hidden_dim=256, n_layers=1),
                               jax.random.PRNGKey(0), 8, 16))
    assert count_parameters(model) == ref


def test_training_mode_edge_stream_not_ported():
    """Training mode runs the edge stream with dropout: its draws come
    from the generator alone (same seed, same output), differ from eval
    mode, and every parameter gets a gradient."""
    _, _, model = _small()
    x, ei = _graph(N, K, seed=5)
    x, ei = torch.from_numpy(x), torch.tensor(ei).long()
    model.train()
    runs = [model(x, ei, generator=torch.Generator().manual_seed(s))
            for s in (3, 3, 4)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    with torch.no_grad():
        assert not torch.equal(runs[0], model.eval()(x, ei))
    runs[0].square().sum().backward()
    for name, p in model.named_parameters():
        assert p.grad is not None and p.grad.abs().sum() > 0, name


def test_load_into_refuses_quantized_checkpoint(tmp_path):
    """A checkpoint marked with a quantization the port does not know is
    refused; "bf16" and "int8" ones load, dequantized to float32 (their
    values are held in tests/test_torch_quantize.py)."""
    from nbody_gnn_hpc_torch.predict import quantize_params

    _, jparams, model = _small()
    with pytest.raises(ValueError, match="quantized"):
        load_into(model, {"model_state_dict": jparams,
                          "quantization": "fp4"})
    before = model.decoder_0.weight.clone()
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    load_into(model, {"model_state_dict": quantize_params(tree, "int8"),
                      "quantization": "int8"})
    after = model.decoder_0.weight
    assert after.dtype == torch.float32 and not torch.equal(after, before)
    torch.testing.assert_close(after, before, rtol=0,
                               atol=before.abs().max().item() / 127)


def test_production_checkpoint_full_width_matches_jax():
    """models/best_rollout_model.pt at N=200, k=40, H=256, 6 layers.
    Tolerance 1e-4 relative to the output scale: six LayerNorms of f32
    summation-order differences."""
    with open(CONFIG) as f:
        cfg = json.load(f)["model_config"]
    ckpt = load_checkpoint(CKPT)
    model = model_from_config(cfg, dtype_override="float32").eval()
    stats = load_into(model, ckpt)
    assert set(stats) == {"state_mean", "state_std"}
    assert count_parameters(model) == 2_550_150
    x, ei = _graph(200, 40, seed=6)
    jmodel = jax_from_config({**cfg, "edge_impl": "xla"},
                             dtype_override="float32")
    jparams = jax.tree_util.tree_map(jnp.asarray, ckpt["model_state_dict"])
    want = np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(x),
                                   jnp.asarray(ei), deterministic=True))
    with torch.inference_mode():
        got = model(torch.from_numpy(x), torch.tensor(ei).long()).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def test_checkpoint_unpickles_with_numpy_only():
    """The production checkpoint names only numpy globals, so the port
    reads it without the JAX stack."""
    seen = set()

    class Recorder(pickle.Unpickler):
        def find_class(self, module, name):
            seen.add(module.split(".")[0])
            return super().find_class(module, name)

    with open(CKPT, "rb") as f:
        Recorder(f).load()
    assert seen == {"numpy"}
