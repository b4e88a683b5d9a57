"""The plain references against ``nbody_gnn_hpc_torch`` with
``device="cpu"`` at tiny sizes."""

import numpy as np
import pytest
import torch

from nbody_gnn_hpc_torch.io.model_io import params_from_jax
from nbody_gnn_hpc_torch.models.gnn import NBodyGNN
from nbody_gnn_hpc_torch.ops.fused_edge import dropout_keep
from nbody_gnn_hpc_torch.ops.knn import knn_edge_index
from nbody_gnn_hpc_torch.predict import Predictor
from nbody_gnn_hpc_torch.predict.quantize import (dequantize_params,
                                                  quantize_params)
from perfbench.drivers.train_loop import make_weights, port_to_flax
from perfbench.reference import gnn, philox, rollout
from perfbench.tests.tiny import SEED

MC = dict(node_input_dim=7, hidden_dim=32, n_layers=2, output_dim=6,
          dropout=0.1)


def _model_and_weights(dtype="float32"):
    weights = make_weights(torch.Generator().manual_seed(3), MC, "cpu")
    model = NBodyGNN(**MC, dtype=dtype)
    model.load_state_dict(params_from_jax(weights))
    return model, weights


def _inputs(b=3, n=24, k=5):
    g = torch.Generator().manual_seed(1)
    x = torch.randn((b, n, 7), generator=g)
    return x, knn_edge_index(x[..., :3], k)


def test_port_names_map_to_flax_names():
    model, weights = _model_and_weights()
    names = {port_to_flax(k, p.dim()) for k, p in model.named_parameters()}
    assert names == set(weights)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_the_port(dtype):
    model, weights = _model_and_weights(dtype)
    model.eval()
    x, ei = _inputs()
    with torch.no_grad():
        want = model(x, ei, x[..., :3])
        got = gnn.forward(weights, x, x[..., :3], ei, 2, dtype)
    tol = 1e-5 if dtype == "float32" else 2e-2
    assert torch.allclose(got, want, atol=tol, rtol=tol)


def test_dropout_draws_match_the_port():
    """The reference's draws from one generator are the training
    forward's: same masks, same seeds, same result."""
    model, weights = _model_and_weights()
    model.train()
    x, ei = _inputs()
    want = model(x, ei, x[..., :3],
                 generator=torch.Generator().manual_seed(SEED))
    g = torch.Generator().manual_seed(SEED)
    torch.randn((3, 24, 6), generator=g)  # the step's noise comes first
    draws = gnn.draw_step(torch.Generator().manual_seed(SEED), 3, 24, 32, 2,
                          0.1, "cpu")
    got = gnn.forward(weights, x, x[..., :3], ei, 2, "float32", draws, 0.1)
    assert not torch.allclose(got, want)  # the noise shifted the draws
    gen = torch.Generator().manual_seed(SEED)
    encoder = torch.rand((3, 24, 32), generator=gen) >= 0.1
    layers = [(torch.randint(0, gnn.SEED_BOUND, (1,), generator=gen,
                             dtype=torch.int32),
               torch.rand((3, 24, 32), generator=gen) >= 0.1)
              for _ in range(2)]
    draws = {"encoder": encoder, "layers": layers,
             "decoder": torch.rand((3, 24, 32), generator=gen) >= 0.1}
    got = gnn.forward(weights, x, x[..., :3], ei, 2, "float32", draws, 0.1)
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("graph0", [0, 5])
def test_edge_keep_is_the_kernels_mask(graph0):
    seed = torch.tensor([123456789], dtype=torch.int32)
    assert torch.equal(philox.edge_keep(seed, 0.1, 3, 40, 256, graph0),
                       dropout_keep(seed, 0.1, 3, 40, 256, graph0))


def test_int8_rule_matches_the_port():
    _, weights = _model_and_weights()
    tree = {"a": {"kernel": weights["decoder_0/kernel"].numpy(),
                  "bias": weights["decoder_0/bias"].numpy()}}
    want = dequantize_params(quantize_params(tree, "int8"))
    got = rollout.int8_weights({"k": tree["a"]["kernel"],
                                "b": tree["a"]["bias"]})
    assert np.array_equal(got["k"], want["a"]["kernel"])
    assert np.array_equal(got["b"], want["a"]["bias"])


def test_knn_matches_the_port():
    pos = torch.randn((2, 700, 3), generator=torch.Generator().manual_seed(4))
    got = rollout.knn(pos, 9, block=256)
    want = knn_edge_index(pos, 9)
    assert torch.equal(got[:, 0], want[:, 0])
    assert torch.equal(got[:, 1].reshape(2, 700, 9).sort(-1).values,
                       want[:, 1].reshape(2, 700, 9).sort(-1).values)


def test_rollout_matches_the_predictor(tmp_path):
    model, weights = _model_and_weights()
    from nbody_gnn_hpc_torch.io.model_io import save_checkpoint

    tree = {}
    for name, value in weights.items():
        node = tree
        *head, leaf = name.split("/")
        for key in head:
            node = node.setdefault(key, {})
        node[leaf] = value.numpy()
    stats = {"state_mean": np.zeros(6, np.float32) + 0.1,
             "state_std": np.full(6, 3.0, np.float32)}
    path = tmp_path / "m.pt"
    save_checkpoint(path, params=tree, norm_stats=stats)
    pred = Predictor(NBodyGNN(**MC), str(path), device="cpu", k_neighbors=6)
    pred.quantize("int8")
    rng = np.random.RandomState(0)
    pos = ((rng.rand(2, 30, 3) - 0.5) * 10).astype(np.float32)
    vel = ((rng.rand(2, 30, 3) - 0.5)).astype(np.float32)
    m = rng.uniform(1e10, 1e12, (2, 30)).astype(np.float32)
    out = pred.predict_rollout_batch(pos, vel, m, 5, trajectory=False)
    params, ns = rollout.load_params(str(path))
    rp, rv = rollout.rollout(rollout.int8_weights(params), ns, pos, vel, m,
                             5, 6, 2)
    assert np.allclose(rp.numpy(), out["positions"], atol=1e-4, rtol=1e-4)
    assert np.allclose(rv.numpy(), out["velocities"], atol=1e-4, rtol=1e-4)


def test_lower_precisions_round():
    x = torch.tensor([1.0 + 2 ** -12, 3.0])
    assert torch.equal(gnn.round_tf32(x), torch.tensor([1.0, 3.0]))
    y = gnn.fake_int8(torch.tensor([[1.0, 0.003, -0.5]]), -1)
    assert torch.allclose(y, torch.tensor([[1.0, 0.0, -64 / 127]]))
