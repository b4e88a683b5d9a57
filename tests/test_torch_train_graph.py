"""The training step's CUDA graph (``make_train_step`` in
``nbody_gnn_hpc_torch/train/steps.py``) on the card, from the same
weights, seed and batches on every side: graphed steps held bit for bit
against the eager step (``compute_loss``, ``backward``, ``update``, the
path the data-parallel step takes) and the ``remat`` step, which stays
eager: ``make_optimizer``'s one AdamW on CUDA; the draws inside the graph
against the eager draws; the launch counters over a capture and its
replays; a second input signature; a reloaded optimizer state;
``fused_full``, which stays eager; a ``Trainer`` checkpoint written on
the card (its file form, a resume) and one written on the CPU.

These tests need an NVIDIA GPU with the CUDA toolkit (``nvcc``); without a
card they skip.  They import no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_train_graph.py
"""

import copy
import pickle
import warnings

import numpy as np
import pytest
import torch

from nbody_gnn_hpc_torch.models import NBodyGNN, gnn
from nbody_gnn_hpc_torch.ops import knn_edge_index, launch_counts
from nbody_gnn_hpc_torch.train import (GNNDataset, Trainer, make_optimizer,
                                       make_train_step)
from nbody_gnn_hpc_torch.train import steps as steps_module
from nbody_gnn_hpc_torch.train.schedule import make_step_schedule

pytestmark = pytest.mark.gpu

N, K, H, LAYERS = 64, 8, 64, 2
SAMPLES, BATCH = 40, 8  # 5 steps an epoch: 8 steps cross an epoch boundary
LR, WD = 5e-4, 1e-4
STEPS = 8
SCHEDULE = make_step_schedule(LR, SAMPLES // BATCH)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the graph captures CUDA kernels)")
    return torch.device("cuda")


def _problem(dev, seed=0):
    gen = torch.Generator(dev).manual_seed(seed)
    states = 2 * torch.randn(SAMPLES, N, 6, generator=gen, device=dev)
    targets = states + 0.01 * torch.randn(SAMPLES, N, 6, generator=gen,
                                          device=dev)
    masses = 1 + torch.rand(N, generator=gen, device=dev)
    return states, targets, masses, knn_edge_index(states[0, :, :3], K)


def _build(dev, problem, dtype="float32", **model_kw):
    states, _, masses, edge_index = problem
    model = NBodyGNN(node_input_dim=7, hidden_dim=H, n_layers=LAYERS,
                     output_dim=6, dropout=0.1, dtype=dtype,
                     generator=torch.Generator().manual_seed(5),
                     **model_kw).to(dev)
    opt = make_optimizer(model, LR, WD)
    flat = states.reshape(-1, 6)
    step = make_train_step(
        model, opt, edge_index, flat.mean(0), flat.std(0),
        (masses / masses.mean())[:, None], masses=masses, schedule=SCHEDULE)
    return model, opt, step


def _eager(step, opt):
    """The eager step as the data-parallel step takes it."""
    def run(s, t, gen):
        opt.zero_grad(set_to_none=True)
        loss, _ = step.compute_loss(s, t, gen)
        loss.backward()
        step.update()
        return loss.detach()
    return run


class Feed:
    """``Trainer.train_epoch``'s order: a permutation an epoch from the
    run's generator, then the epoch's batches."""

    def __init__(self, fn, problem, gen):
        self.fn, self.states, self.targets = fn, problem[0], problem[1]
        self.gen, self.ids, self.i = gen, None, SAMPLES // BATCH

    def next(self, rows=BATCH):
        if self.i == SAMPLES // BATCH:
            perm = torch.randperm(SAMPLES, generator=self.gen,
                                  device=self.states.device)
            self.ids, self.i = perm.view(-1, BATCH), 0
        ids = self.ids[self.i][:rows]
        self.i += 1
        return self.fn(self.states[ids], self.targets[ids], self.gen)


class Draws:
    """Copies of a step's draws (the noise, each mask, each layer's seed)
    into buffers made at its first step.  In a capture the copies are
    captured too, so each replay writes its own draws there."""

    active = None

    def __init__(self):
        self.bufs, self.i = [], 0

    def keep(self, t):
        if self.i == len(self.bufs):
            self.bufs.append(t.detach().clone())
        else:
            self.bufs[self.i].copy_(t)
        self.i += 1
        return t

    def taken(self):
        self.i = 0
        return [b.clone() for b in self.bufs]


def _recorded(fn):
    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        return out if Draws.active is None else Draws.active.keep(out)
    return wrapper


def _record_draws(mp):
    mp.setattr(gnn, "draw_rows", _recorded(gnn.draw_rows))
    mp.setattr(steps_module, "draw_rows", _recorded(steps_module.draw_rows))
    draws = gnn.ParticleInteractionLayer.draws

    def layer_draws(self, h, generator=None, rows=None):
        seed, keep = draws(self, h, generator, rows)
        if seed is not None and Draws.active is not None:
            Draws.active.keep(seed)
        return seed, keep
    mp.setattr(gnn.ParticleInteractionLayer, "draws", layer_draws)


def _rise(before):
    after = launch_counts()
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def runs(request, cuda):
    """STEPS steps on each side (graphed, the eager step, the remat step)
    from the same weights, seed and batches, each side's draws recorded
    step by step."""
    dtype = request.param
    problem = _problem(cuda)
    out = {"dtype": dtype}
    with pytest.MonkeyPatch.context() as mp:
        _record_draws(mp)
        for side in ("graphed", "eager", "remat"):
            model, opt, step = _build(cuda, problem, dtype,
                                      remat=side == "remat")
            fn = _eager(step, opt) if side == "eager" else step
            gen = torch.Generator(cuda).manual_seed(77)
            feed, rec = Feed(fn, problem, gen), Draws()
            losses, draws = [], []
            before = launch_counts()
            for _ in range(STEPS):
                Draws.active = rec
                losses.append(feed.next())
                Draws.active = None
                draws.append(rec.taken())
            torch.cuda.synchronize()
            out[side] = dict(
                losses=losses, draws=draws, rise=_rise(before),
                params=[p.detach().clone() for p in model.parameters()],
                gen=gen.get_state(), step=step)
    return out


@pytest.mark.parametrize("side", ["eager", "remat"])
def test_graphed_steps_match_the_eager_steps(runs, side):
    """One AdamW arithmetic: the graph's, the eager update's and the remat
    step's losses and parameters are the same bits."""
    g, e = runs["graphed"], runs[side]
    assert [x.item() for x in g["losses"]] == [x.item() for x in e["losses"]]
    assert all(torch.equal(a, b) for a, b in zip(g["params"], e["params"]))
    if side == "remat":
        assert (e["step"].eager_steps, e["step"].captures,
                e["step"].graph_replays) == (STEPS, 0, 0)


def test_graphed_steps_draw_the_eager_draws(runs):
    g, e = runs["graphed"], runs["eager"]
    assert len(g["draws"]) == len(e["draws"]) == STEPS
    for got, want in zip(g["draws"], e["draws"]):
        # the noise, the encoder's mask, each layer's seed and mask, the
        # decoder's mask
        assert len(got) == len(want) == 3 + 2 * LAYERS
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(g["gen"], e["gen"])
    # successive steps drew anew
    assert not torch.equal(g["draws"][1][0], g["draws"][2][0])


def test_launch_counts_are_exact_over_capture_and_replays(runs):
    g, e = runs["graphed"], runs["eager"]
    step = g["step"]
    assert (step.eager_steps, step.captures, step.graph_replays,
            step.count) == (1, 1, STEPS - 2, STEPS)
    suffix = "_bf16" if runs["dtype"] == "bfloat16" else ""
    want = {f"fused_edge_fwd{suffix}": STEPS * LAYERS,
            f"fused_edge_bwd{suffix}": STEPS * LAYERS}
    assert g["rise"] == e["rise"] == want


def test_each_graphed_step_returns_a_loss_of_its_own(runs):
    losses = runs["graphed"]["losses"]
    assert len({x.data_ptr() for x in losses}) == STEPS
    assert len({x.item() for x in losses}) == STEPS


def _paired(cuda, problem):
    """A graphed side and the eager step, from the same weights and
    seed."""
    sides = []
    for graphed in (True, False):
        model, opt, step = _build(cuda, problem)
        gen = torch.Generator(cuda).manual_seed(78)
        fn = step if graphed else _eager(step, opt)
        sides.append((model, opt, step, Feed(fn, problem, gen)))
    return sides


def _same(got, want, got_model, want_model):
    assert [x.item() for x in got] == [x.item() for x in want]
    assert all(torch.equal(a, b) for a, b in zip(got_model.parameters(),
                                                 want_model.parameters()))


def test_a_second_signature_gets_its_own_graph(cuda):
    problem = _problem(cuda, seed=1)
    (gm, _, gs, gf), (em, _, es, ef) = _paired(cuda, problem)
    plan = [BATCH] * 3 + [BATCH // 2] * 3 + [BATCH] * 2
    got = [gf.next(rows) for rows in plan]
    want = [ef.next(rows) for rows in plan]
    assert (gs.eager_steps, gs.captures, gs.graph_replays) == (2, 2, 4)
    _same(got, want, gm, em)
    # an eager launch of the kernels after the replays
    s, t = problem[0][:BATCH], problem[1][:BATCH]
    with torch.no_grad():
        a = gs.compute_loss(s, t, deterministic=True)[0]
        b = es.compute_loss(s, t, deterministic=True)[0]
    assert a.item() == b.item()


def test_a_reloaded_optimizer_state_is_captured_anew(cuda):
    problem = _problem(cuda, seed=2)
    (gm, go, gs, gf), (em, eo, es, ef) = _paired(cuda, problem)
    got = [gf.next() for _ in range(3)]
    want = [ef.next() for _ in range(3)]
    for opt in (go, eo):
        opt.load_state_dict(copy.deepcopy(opt.state_dict()))
    got += [gf.next() for _ in range(3)]
    want += [ef.next() for _ in range(3)]
    assert (gs.eager_steps, gs.captures, gs.graph_replays) == (2, 2, 2)
    _same(got, want, gm, em)


@pytest.mark.parametrize("model_kw", [{"edge_impl": "fused_full"},
                                      {"remat": True}],
                         ids=["fused_full", "remat"])
def test_fused_full_and_remat_stay_eager_with_the_eager_numbers(cuda,
                                                                 model_kw):
    """Both steps stay eager and step ``make_optimizer``'s AdamW, the
    graph's (capturable, its LR a float32 tensor on the card for its whole
    life), without a warning that it is not captured.  remat recomputes
    the same bits, so it is held to the graphed step of the same weights;
    kernel 7 sums in its own order, so fused_full is held to its eager
    update, which ``test_graphed_steps_match_the_eager_steps`` holds to
    the graph."""
    problem = _problem(cuda, seed=3)
    full = "edge_impl" in model_kw
    sides = []
    for side in ("stays eager", "graph's numbers"):
        model, opt, step = _build(cuda, problem, **(
            model_kw if side == "stays eager" or full else {}))
        fn = _eager(step, opt) if side != "stays eager" and full else step
        feed = Feed(fn, problem, torch.Generator(cuda).manual_seed(79))
        (group,) = opt.param_groups
        lr = group["lr"]
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=".*capturable")
            sides.append((model, step, [feed.next() for _ in range(3)]))
        assert group["capturable"] and opt.param_groups[0]["lr"] is lr
        assert lr.is_cuda and lr.dtype == torch.float32
    (gm, gs, got), (em, _, want) = sides
    assert (gs.eager_steps, gs.captures, gs.graph_replays) == (3, 0, 0)
    assert [x.item() for x in got] == [x.item() for x in want]
    assert all(torch.equal(a, b) for a, b in zip(gm.parameters(),
                                                 em.parameters()))


def _trainer(device, model_dir, backend="pickle"):
    """A Trainer of 45 samples (5 steps an epoch), the same on every
    device."""
    rng = np.random.RandomState(8)
    masses = rng.uniform(1e10, 1e11, N)
    train = GNNDataset.from_trajectories([dict(
        positions=(5 * rng.randn(20, N, 3)).astype(np.float32),
        velocities=rng.randn(20, N, 3).astype(np.float32), masses=masses)
        for _ in range(3)], sequence_length=5, k_neighbors=K)
    return Trainer(NBodyGNN(node_input_dim=7, hidden_dim=H, n_layers=LAYERS,
                            output_dim=6, dropout=0.1), train,
                   model_dir=str(model_dir), device=device, batch_size=BATCH,
                   seed=1, ckpt_backend=backend)


def _resumed_on_the_graph(trainer, n):
    (group,) = trainer.optimizer.param_groups
    assert group["capturable"] and group["lr"].is_cuda
    assert all(st["step"].is_cuda and st["step"].dtype == torch.float32
               for st in trainer.optimizer.state.values())
    trainer.train_epoch()
    step = trainer._step
    assert (step.eager_steps, step.captures, step.graph_replays,
            step.count) == (1, 1, n - 2, 2 * n)


@pytest.mark.parametrize("backend", ["pickle", "orbax"])
def test_a_cuda_checkpoint_holds_the_file_form_and_resumes_bit_for_bit(
        cuda, tmp_path, backend):
    run = _trainer(cuda, tmp_path, backend)
    run.train_epoch()
    run.save_model("mid.pt")
    run._wait_durable()
    draws = run.generator.get_state()  # the run's draws go on from here
    run.train_epoch()
    if backend == "pickle":
        with open(tmp_path / "mid.pt", "rb") as f:
            (group,) = pickle.load(f)["optimizer_state_dict"]["param_groups"]
    else:  # DCP's flat names
        from nbody_gnn_hpc_torch.io.orbax_io import OrbaxCheckpointer

        flat = OrbaxCheckpointer(str(tmp_path / "orbax")).restore()
        group = {k: flat[f"param_groups.0.{k}"] for k in ("lr", "capturable")}
    assert type(group["lr"]) is float and group["capturable"] is False

    resumed = _trainer(cuda, tmp_path, backend)
    resumed.load_model("mid.pt")
    resumed.generator.set_state(draws)
    _resumed_on_the_graph(resumed, run.steps_per_epoch)
    assert resumed.step_losses == run.step_losses[run.steps_per_epoch:]
    assert all(torch.equal(a, b) for a, b in zip(resumed.model.parameters(),
                                                 run.model.parameters()))
    got, want = (t.optimizer.state_dict()["state"] for t in (resumed, run))
    assert all(torch.equal(got[i][k], want[i][k])
               for i in want for k in ("step", "exp_avg", "exp_avg_sq"))


def test_a_file_written_on_the_cpu_steps_through_the_graph_on_cuda(
        cuda, tmp_path):
    host = _trainer("cpu", tmp_path)
    host.train_epoch()
    host.save_model("host.pt")
    card = _trainer(cuda, tmp_path)
    card.load_model("host.pt")
    _resumed_on_the_graph(card, host.steps_per_epoch)
    assert np.isfinite(card.step_losses).all()
