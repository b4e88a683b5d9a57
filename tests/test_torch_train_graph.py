"""The training step's CUDA graph (``make_train_step`` in
``nbody_gnn_hpc_torch/train/steps.py``) on the card, from the same
weights, seed and batches on every side: graphed steps held bit for bit
against the same arithmetic run eagerly (AdamW capturable), and against
the eager step (``compute_loss``, ``backward``, ``update``, the path the
data-parallel step takes); the draws inside the graph against the eager
draws; the launch counters over a capture and its replays; a second input
signature; a reloaded optimizer state; the paths that stay eager.

These tests need an NVIDIA GPU with the CUDA toolkit (``nvcc``); without a
card they skip.  They import no JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_train_graph.py
"""

import copy

import pytest
import torch

from nbody_gnn_hpc_torch.models import NBodyGNN, gnn
from nbody_gnn_hpc_torch.ops import knn_edge_index, launch_counts
from nbody_gnn_hpc_torch.train import make_optimizer, make_train_step
from nbody_gnn_hpc_torch.train import steps as steps_module
from nbody_gnn_hpc_torch.train.schedule import make_step_schedule
from nbody_gnn_hpc_torch.train.steps import (GRAD_CLIP_NORM,
                                             clip_by_global_norm_)

pytestmark = pytest.mark.gpu

N, K, H, LAYERS = 64, 8, 64, 2
SAMPLES, BATCH = 40, 8  # 5 steps an epoch: 8 steps cross an epoch boundary
LR, WD = 5e-4, 1e-4
STEPS = 8
SCHEDULE = make_step_schedule(LR, SAMPLES // BATCH)
# Graphed against the eager step: the graphed path's AdamW is capturable
# (its bias corrections in float32 on the device, not in Python doubles),
# which moves the first update by a rounding: under 1e-2 of the LR, where
# a real difference moves a parameter by up to 2 LR.  The later steps'
# gradients then differ, and AdamW's first steps amplify that (an update
# is about LR x the sign of a small gradient), so the losses of 8 steps
# agree only as far as the card showed, with room: float32 2.1e-5,
# bf16 6.6e-4 (bf16 products round the parameters' differences further).
FIRST_UPDATE_GAP = 1e-2 * LR
LOSS_GAP = {"float32": 1e-4, "bfloat16": 5e-3}


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


def _capturable(step, opt):
    """The graphed step's arithmetic, eagerly: AdamW capturable, reading
    its LR from a device tensor."""
    lrs = [torch.zeros((), device=step.params[0].device)
           for _ in opt.param_groups]

    def run(s, t, gen):
        for group, lr in zip(opt.param_groups, lrs):
            lr.fill_(SCHEDULE(step.count))
            group["lr"], group["capturable"] = lr, True
        opt.zero_grad(set_to_none=True)
        loss, _ = step.compute_loss(s, t, gen)
        loss.backward()
        clip_by_global_norm_([p.grad for p in step.params], GRAD_CLIP_NORM)
        opt.step()
        step.count += 1
        return loss.detach()
    return run


SIDES = {"eager": _eager, "capturable": _capturable}


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
    """STEPS steps on each side (graphed, the same arithmetic eagerly, the
    eager step) from the same weights, seed and batches, each side's
    draws recorded step by step."""
    dtype = request.param
    problem = _problem(cuda)
    out = {"dtype": dtype}
    with pytest.MonkeyPatch.context() as mp:
        _record_draws(mp)
        for side in ("graphed", "capturable", "eager"):
            model, opt, step = _build(cuda, problem, dtype)
            fn = step if side == "graphed" else SIDES[side](step, opt)
            gen = torch.Generator(cuda).manual_seed(77)
            feed, rec = Feed(fn, problem, gen), Draws()
            losses, draws, first = [], [], None
            before = launch_counts()
            for _ in range(STEPS):
                Draws.active = rec
                losses.append(feed.next())
                Draws.active = None
                draws.append(rec.taken())
                if first is None:
                    first = [p.detach().clone() for p in model.parameters()]
            torch.cuda.synchronize()
            out[side] = dict(
                losses=losses, draws=draws, rise=_rise(before), first=first,
                params=[p.detach().clone() for p in model.parameters()],
                gen=gen.get_state(), step=step)
    return out


def test_graphed_steps_are_the_same_arithmetic_bit_for_bit(runs):
    g, c = runs["graphed"], runs["capturable"]
    assert [x.item() for x in g["losses"]] == [x.item() for x in c["losses"]]
    assert all(torch.equal(a, b) for a, b in zip(g["params"], c["params"]))


def test_graphed_steps_match_the_eager_steps(runs):
    g, e = runs["graphed"], runs["eager"]
    first_gap = max((a - b).abs().max().item()
                    for a, b in zip(g["first"], e["first"]))
    loss_gap = max(abs(a.item() - b.item()) / abs(b.item())
                   for a, b in zip(g["losses"], e["losses"]))
    print(f"{runs['dtype']}: graphed against eager steps: the first "
          f"update's worst parameter gap {first_gap:.3e} "
          f"({first_gap / LR:.3e} LR); {STEPS} steps' worst loss gap "
          f"{loss_gap:.3e}")
    # the first step reads the same weights and draws on both sides
    assert g["losses"][0].item() == e["losses"][0].item()
    assert first_gap <= FIRST_UPDATE_GAP
    assert loss_gap <= LOSS_GAP[runs["dtype"]]


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
    """A graphed side and the same arithmetic eagerly, from the same
    weights and seed."""
    sides = []
    for graphed in (True, False):
        model, opt, step = _build(cuda, problem)
        gen = torch.Generator(cuda).manual_seed(78)
        fn = step if graphed else _capturable(step, opt)
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
    problem = _problem(cuda, seed=3)
    sides = []
    for graphed in (True, False):
        model, opt, step = _build(cuda, problem, **model_kw)
        gen = torch.Generator(cuda).manual_seed(79)
        feed = Feed(step if graphed else _eager(step, opt), problem, gen)
        sides.append((model, step, [feed.next() for _ in range(3)]))
    (gm, gs, got), (em, _, want) = sides
    assert (gs.eager_steps, gs.captures, gs.graph_replays) == (3, 0, 0)
    assert [x.item() for x in got] == [x.item() for x in want]
    assert all(torch.equal(a, b) for a, b in zip(gm.parameters(),
                                                 em.parameters()))
