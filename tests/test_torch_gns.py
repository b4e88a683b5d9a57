"""GNS (nbody_gnn_hpc_torch/models/gns.py) and its receiver sum
(ops/edge_sum.py) against the plain reference the benchmark holds it to
(perfbench/reference/gns.py), on the CPU at a small size (B=2, N=24, k=4,
latent 16, 3 message-passing steps); the command, the checkpoint and the
rollout around it; and, marked ``gpu`` (they skip without a card), the
kernel and the graphed step on the card.  They import no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gns.py
"""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nbody_gnn_hpc_torch.io.model_io import params_from_jax, params_to_jax
from nbody_gnn_hpc_torch.models import NBodyGNN, model_from_config
from nbody_gnn_hpc_torch.models.gns import GNS
from nbody_gnn_hpc_torch.ops import (launch_counts, receiver_gather,
                                     receiver_sum, receiver_sum_plain,
                                     target_csr)
from nbody_gnn_hpc_torch.ops.knn import knn_edge_index
from nbody_gnn_hpc_torch.train import make_optimizer, make_train_step
from nbody_gnn_hpc_torch.utils import profiling
from perfbench.reference import gns as ref

B, N, K, L, STEPS = 2, 24, 4, 16, 3
SMALL = dict(architecture="gns", latent_size=L, mlp_hidden_size=L,
             mlp_num_hidden_layers=2, num_message_passing_steps=STEPS,
             output_dim=6)
PUBLISHED = dict(architecture="gns", latent_size=128, mlp_hidden_size=128,
                 mlp_num_hidden_layers=2, num_message_passing_steps=10,
                 output_dim=6)
# Port against reference, both float32 on the CPU: the port sums at the
# receivers in CSR order and the sender's gradient over k, the reference
# by its sort-and-segment sum and scatter; they differ by float32
# reduction order only.
RTOL = 1e-5


def _flat(tree, prefix=""):
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(val, dict):
            yield from _flat(val, path)
        else:
            yield path, val


def _model(seed=0, **kw):
    """GNS at the small size, every parameter nudged off its initial
    value (the LayerNorm biases start at zero)."""
    model = model_from_config({**SMALL, **kw})
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    return model


def _inputs(seed=1):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(B, N, 7, generator=gen)
    return x, knn_edge_index(x[..., :3], K)


def _reference_params(model):
    return {k: v.detach().clone().requires_grad_(True)
            for k, v in _flat(params_to_jax(model.state_dict(),
                                            numpy=False))}


def _as_port(grads: dict) -> dict:
    tree = {}
    for path, g in grads.items():
        node = tree
        parts = path.split("/")
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = g
    return params_from_jax(tree)


def _close(got, want, rtol=RTOL):
    """Within rtol of the tensor's scale."""
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() <= rtol * max(scale, 1e-30), (
        (got - want).abs().max().item(), scale)


# -- the model -------------------------------------------------------------


def test_published_widths_build_1588998_parameters():
    model = model_from_config(PUBLISHED)
    assert isinstance(model, GNS)
    assert sum(p.numel() for p in model.parameters()) == 1_588_998
    assert model.model_config == PUBLISHED
    shapes = ref.param_shapes(128, 128, 2, 10, 6)
    assert sum(torch.Size(s).numel() for s in shapes.values()) == 1_588_998


@pytest.mark.parametrize("config,built", [
    ({**SMALL, "dtype": "bfloat16"}, "gns"),
    ({"node_input_dim": 7, "hidden_dim": 16, "n_layers": 1,
      "output_dim": 6, "dropout": 0.1}, "gnn"),
])
def test_model_from_config_dispatches_on_architecture(config, built):
    model = model_from_config(config)
    assert type(model) is {"gns": GNS, "gnn": NBodyGNN}[built]
    if built == "gns":
        assert model.dtype == torch.bfloat16
        rebuilt = model_from_config(config, dtype_override="float32")
        assert rebuilt.dtype == torch.float32


def test_model_from_config_refuses_an_unknown_architecture():
    with pytest.raises(ValueError, match="architecture"):
        model_from_config({**SMALL, "architecture": "graphcast"})


def test_forward_and_gradients_equal_the_reference():
    model = _model()
    x, edge_index = _inputs()
    params = _reference_params(model)
    got = model(x, edge_index, x[..., :3])
    want = ref.forward(params, x, x[..., :3], edge_index, STEPS, 2)
    _close(got, want)
    cot = torch.randn(got.shape, generator=torch.Generator().manual_seed(3))
    (got * cot).sum().backward()
    (want * cot).sum().backward()
    grads = _as_port({k: v.grad for k, v in params.items()})
    for name, p in model.named_parameters():
        _close(p.grad, grads[name])
        assert grads[name].abs().max() > 0, name


def test_edge_input_is_the_concatenation_in_the_products_dtype():
    """The edge MLP reads [e, v[sender], v[receiver]] cast to bf16 as
    the reference's first Dense casts its concatenation: the same bits."""
    model = _model(dtype="bfloat16")
    x, edge_index = _inputs()
    gen = torch.Generator().manual_seed(4)
    e = torch.randn(B, N * K, L, generator=gen)
    v = torch.randn(B, N, L, generator=gen)
    edges = target_csr(edge_index, N)
    got = model.layers[1].edge_input(e, v, edges, K)
    want = torch.cat([e, ref.gather(v, edges.row), ref.gather(v, edges.col)],
                     -1).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_forward_takes_one_unbatched_graph():
    model = _model()
    x, edge_index = _inputs()
    one = model(x[0], edge_index[0])
    torch.testing.assert_close(one, model(x[:1], edge_index[:1])[0])


def test_forward_records_its_spans():
    model = _model()
    x, edge_index = _inputs()
    profiling.SPANS.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        model(x, edge_index)
    spans = {s.name: s for s in profiling.recorded_spans()}
    profiling.SPANS.clear()
    assert {"gns.encode", "gns.process", "gns.decode"} <= set(spans)
    assert spans["gns.process"].attrs == {"layers": STEPS,
                                          "edges": N * K}


# -- the receiver sum ------------------------------------------------------


def test_receiver_sum_plain_equals_a_float64_sum_and_repeats_bitwise():
    x, edge_index = _inputs()
    edges = target_csr(edge_index, N)
    msg = torch.randn(B, N * K, 36,
                      generator=torch.Generator().manual_seed(5))
    got = receiver_sum(msg, edges)
    want = torch.zeros(B, N, 36, dtype=torch.float64)
    for g in range(B):
        want[g].index_add_(0, edges.col[g], msg[g].double())
    torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=1e-6)
    assert torch.equal(receiver_sum_plain(msg, edges), got)
    assert torch.equal(receiver_sum(msg, edges), got)


def test_receiver_sum_and_gather_pass_gradcheck():
    x, edge_index = _inputs()
    edges = target_csr(edge_index[:, :, :N * 2], N)  # some nodes receive 0
    gen = torch.Generator().manual_seed(6)
    msg = torch.randn(B, N * 2, 3, dtype=torch.float64, generator=gen,
                      requires_grad=True)
    nodes = torch.randn(B, N, 3, dtype=torch.float64, generator=gen,
                        requires_grad=True)
    assert torch.autograd.gradcheck(lambda m: receiver_sum(m, edges), (msg,))
    assert torch.autograd.gradcheck(lambda h: receiver_gather(h, edges),
                                    (nodes,))


# -- training --------------------------------------------------------------


def _problem(seed=7, samples=6):
    gen = torch.Generator().manual_seed(seed)
    states = 2 * torch.randn(samples, N, 6, generator=gen)
    targets = states + 0.01 * torch.randn(samples, N, 6, generator=gen)
    masses = 1 + torch.rand(N, generator=gen)
    flat = states.reshape(-1, 6)
    return (states, targets, masses, knn_edge_index(states[0, :, :3], K),
            flat.mean(0), flat.std(0))


def test_train_steps_equal_the_reference_trainer():
    """Three steps of make_train_step (noise, loss, clip, AdamW) against
    the reference trainer from the same weights, batches and noise."""
    states, targets, masses, edge_index, mean, std = _problem()
    lr, wd, noise = 1e-3, 0.0, 0.05
    model = _model(seed=2)
    params = {k: v.detach().clone() for k, v in _flat(
        params_to_jax(model.state_dict(), numpy=False))}
    step = make_train_step(model, make_optimizer(model, lr, wd), edge_index,
                           mean, std, (masses / masses.mean())[:, None],
                           noise_std=noise, masses=masses)
    trainer = ref.ReferenceTrainer(params, mean, std, masses, edge_index,
                                   SMALL, noise, lr, wd, "float32", chunk=1)
    gen, ref_gen = (torch.Generator().manual_seed(9) for _ in range(2))
    for i in range(3):
        s, t = states[2 * i:2 * i + 2], targets[2 * i:2 * i + 2]
        loss = step(s, t, gen).item()
        want, _ = trainer.step(s, t, ref.draw_step(ref_gen, 2, N, "cpu"))
        assert abs(loss - want) <= RTOL * abs(want), (i, loss, want)
    start = _as_port(params)
    port = _as_port({k: v.detach() for k, v in trainer.params.items()})
    for name, p in model.named_parameters():
        # Each leaf's change over the three steps: Adam normalises each
        # gradient element, so an element near zero moves by up to ~lr
        # whichever way round-off tips it; the leaf's change as a whole
        # agrees to float32 reduction order.
        want = port[name] - start[name]
        gap = torch.linalg.vector_norm(p.detach() - port[name]).item()
        assert gap <= 1e-3 * torch.linalg.vector_norm(want).item(), name


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """``train_model --architecture gns`` at a small size on the CPU."""
    from nbody_gnn_hpc_torch import generate_data, train_model

    root = tmp_path_factory.mktemp("gns")
    assert generate_data.main([
        "-n", "12", "-s", "4", "--steps", "10", "--sequence-length", "3",
        "--compression", "none", "-o", str(root / "data"),
        "--device", "cpu"]) == 0
    assert train_model.main([
        "--device", "cpu", "--architecture", "gns", "--data-dir",
        str(root / "data"), "--model-dir", str(root / "models"),
        "--epochs", "1", "--hidden-dim", "16", "--n-layers", "2",
        "--k-neighbors", "4"]) == 0
    return root / "models"


def test_train_model_trains_gns_with_the_published_recipe(trained):
    cfg = json.loads((trained / "config.json").read_text())
    assert cfg["model_type"] == "gns"
    assert cfg["model_config"] == {
        "architecture": "gns", "latent_size": 16, "mlp_hidden_size": 16,
        "mlp_num_hidden_layers": 2, "num_message_passing_steps": 2,
        "output_dim": 6, "dtype": "float32"}
    tc = cfg["training_config"]
    assert (tc["batch_size"], tc["learning_rate"], tc["noise_std"],
            tc["weight_decay"]) == (2, 1e-4, 6.7e-4, 0.0)


def test_checkpoint_keeps_the_architecture_and_rolls_out(trained):
    from nbody_gnn_hpc_torch.io.model_io import load_checkpoint
    from nbody_gnn_hpc_torch.predict import Predictor

    ckpt = load_checkpoint(trained / "best_model.pt")
    assert ckpt["model_config"]["architecture"] == "gns"
    cfg = json.loads((trained / "config.json").read_text())["model_config"]
    model = model_from_config({**cfg, "dtype": "bfloat16"},
                              dtype_override="float32")
    predictor = Predictor(model, str(trained / "best_model.pt"),
                          device="cpu", k_neighbors=4)
    gen = torch.Generator().manual_seed(11)
    pos, vel = torch.randn(12, 3, generator=gen), torch.randn(
        12, 3, generator=gen)
    out = predictor.predict_rollout(pos.numpy(), vel.numpy(),
                                    torch.ones(12).numpy(), 3)
    assert out["positions"].shape == (4, 12, 3)
    assert torch.isfinite(torch.as_tensor(out["positions"])).all()


def test_train_model_refuses_gnn_only_flags(tmp_path):
    from nbody_gnn_hpc_torch import train_model

    assert train_model.main(["--device", "cpu", "--architecture", "gns",
                             "--remat", "--data-dir", str(tmp_path)]) == 2


# -- on the card -----------------------------------------------------------


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the receiver sum kernel has no CPU "
                    "mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,n,k,f", [(2, 5000, 40, 128), (1, 200, 40, 128),
                                     (3, 37, 5, 36)])
def test_kernel_matches_the_plain_sum_and_repeats_bitwise(cuda, b, n, k, f):
    gen = torch.Generator(cuda).manual_seed(n + f)
    pos = torch.randn(b, n, 3, generator=gen, device=cuda)
    edges = target_csr(knn_edge_index(pos, k), n)
    msg = torch.randn(b, n * k, f, generator=gen, device=cuda)
    before = receiver_sum.launches
    got = receiver_sum(msg, edges)
    again = receiver_sum(msg, edges)
    torch.cuda.synchronize()
    assert receiver_sum.launches == before + 2
    assert torch.equal(got, again)
    want = receiver_sum_plain(msg.double(), edges)
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)



@pytest.mark.gpu
def test_kernel_refuses_a_wider_or_misaligned_message(cuda):
    pos = torch.randn(1, 30, 3, device=cuda)
    edges = target_csr(knn_edge_index(pos, 3), 30)
    with pytest.raises(ValueError, match="up to 128"):
        receiver_sum(torch.randn(1, 90, 132, device=cuda), edges)
    shifted = torch.randn(1 * 90 * 128 + 1, device=cuda)[1:].view(1, 90, 128)
    with pytest.raises(ValueError, match="16-byte"):
        receiver_sum(shifted, edges)


def _eager(step, opt):
    """The step without its graph: ``compute_loss``, ``backward`` and
    ``update``, as the data-parallel step takes it."""
    def run(s, t, gen):
        opt.zero_grad(set_to_none=True)
        loss, _ = step.compute_loss(s, t, gen)
        loss.backward()
        step.update()
        return loss.detach()
    return run


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graphed_step_equals_the_eager_arithmetic_bitwise(cuda, dtype):
    n, k, steps = 500, 16, 5
    gen = torch.Generator(cuda).manual_seed(0)
    states = 2 * torch.randn(12, n, 6, generator=gen, device=cuda)
    targets = states + 0.01 * torch.randn(12, n, 6, generator=gen,
                                          device=cuda)
    masses = 1 + torch.rand(n, generator=gen, device=cuda)
    edge_index = knn_edge_index(states[0, :, :3], k)
    flat = states.reshape(-1, 6)
    out = {}
    for side in ("graphed", "eager"):
        model = GNS(latent_size=64, mlp_hidden_size=64,
                    num_message_passing_steps=3, dtype=dtype,
                    generator=torch.Generator().manual_seed(5)).to(cuda)
        opt = make_optimizer(model, 1e-3, 0.0)
        step = make_train_step(model, opt, edge_index, flat.mean(0),
                               flat.std(0), (masses / masses.mean())[:, None],
                               noise_std=6.7e-4, masses=masses)
        fn = step if side == "graphed" else _eager(step, opt)
        run_gen = torch.Generator(cuda).manual_seed(3)
        before = launch_counts()
        losses = [fn(states[2 * i:2 * i + 2], targets[2 * i:2 * i + 2],
                     run_gen) for i in range(steps)]
        torch.cuda.synchronize()
        after = launch_counts()
        out[side] = dict(losses=[x.item() for x in losses],
                         params=[p.detach().clone()
                                 for p in model.parameters()],
                         step=step,
                         rise={key: after[key] - before[key] for key in after
                               if after[key] != before[key]})
    g, e = out["graphed"], out["eager"]
    assert (g["step"].eager_steps, g["step"].captures,
            g["step"].graph_replays) == (1, 1, steps - 2)
    assert g["losses"] == e["losses"]
    assert all(torch.equal(a, b) for a, b in zip(g["params"], e["params"]))
    # each step: one receiver sum a layer forward and one backward
    assert g["rise"] == e["rise"] == {"edge_sum": steps * 2 * 3}
