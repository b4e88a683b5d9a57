"""Training cells: the port's production training step (``make_train_step``,
as ``Trainer`` builds it) fed batches in ``Trainer.train_epoch``'s order: a
permutation of the training set from the run's generator each epoch, a step
a batch with no host sync between steps, the epoch's losses read back at
its end.

Set-up makes the data and the weights on the card from the seed, builds
the model, optimizer and step once, and drives that step through its first
``reference_steps`` steps, keeping what the comparison needs: each step's
loss, the norm of each parameter's first gradient as AdamW holds it after
step 1 (its first moment over 1 - beta1), and each parameter's change
after the last of them.  The same step then runs its warm-up and the
window.  After the window the reference follows those first steps from the
same weights, batches and random draws.

Traffic keys: ``batch_size``, ``reference_steps``, ``warmup_steps``,
``reference_chunk_edges`` (edges a reference forward holds), and the traced
span ``trace_at_s`` / ``trace_s``.
"""

import time
from typing import Optional

import torch

from perfbench import harness
from perfbench.reference import gnn as ref_gnn
from perfbench.reference import train as ref_train
from perfbench.reference.rollout import knn

BETA1 = 0.9
# Leaves left out of the gradient and change comparisons: those whose
# reference gradient is below this share of the median leaf's (round-off
# moves them under AdamW).
NEGLIGIBLE_GRAD = 1e-3


def port_to_flax(name: str, ndim: int) -> str:
    """``layers.0.edge_out.weight`` -> ``layer_0/edge_out/kernel``."""
    parts = name.split(".")
    if parts[0] in ("layers", "norms"):
        parts[:2] = [f"{parts[0][:-1]}_{parts[1]}"]
    if parts[-1] == "weight":
        parts[-1] = "kernel" if ndim == 2 else "scale"
    return "/".join(parts)


def make_weights(gen: torch.Generator, mc: dict, device) -> dict:
    """Every leaf random from one draw: kernels N(0, 1/fan_in), biases
    N(0, 0.05^2), LayerNorm scales 1 + N(0, 0.05^2)."""
    shapes = ref_gnn.param_shapes(mc["node_input_dim"], mc["hidden_dim"],
                                  mc["n_layers"], mc["output_dim"])
    total = sum(int(torch.Size(s).numel()) for s in shapes.values())
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        size = int(torch.Size(shape).numel())
        x = flat[at:at + size].view(shape)
        at += size
        if len(shape) == 2:
            x = x / shape[0] ** 0.5
        elif name.endswith("/scale"):
            x = 1.0 + 0.05 * x
        else:
            x = 0.05 * x
        out[name] = x.clone()
    return out


def make_data(gen: torch.Generator, samples: int, n: int, device):
    """(states, targets, masses): positions uniform in a box of side 10,
    velocities uniform in +-0.5, targets the states moved by N(0, 0.01^2),
    masses uniform in [1e10, 1e12]."""
    states = torch.rand((samples, n, 6), generator=gen, device=device) - 0.5
    states[..., :3] *= 10.0
    targets = states + 0.01 * torch.randn((samples, n, 6), generator=gen,
                                          device=device)
    masses = 1e10 + (1e12 - 1e10) * torch.rand((n,), generator=gen,
                                               device=device)
    return states, targets, masses


class Feed:
    """``Trainer.train_epoch``'s order over (states, targets): a
    permutation a epoch from ``gen``, the remainder dropped, the epoch's
    losses read back at its end."""

    def __init__(self, step, states, targets, gen, batch: int):
        self.step, self.states, self.targets = step, states, targets
        self.gen, self.batch = gen, batch
        self.n_batches = states.shape[0] // batch
        self.batch_ids, self.i, self.losses = None, 0, []

    def next(self) -> torch.Tensor:
        if self.batch_ids is None or self.i == self.n_batches:
            if self.losses:
                torch.stack(self.losses).tolist()
                self.losses = []
            perm = torch.randperm(self.states.shape[0], generator=self.gen,
                                  device=self.states.device)
            self.batch_ids = perm[:self.n_batches * self.batch].view(
                self.n_batches, self.batch)
            self.i = 0
        ids = self.batch_ids[self.i]
        self.i += 1
        loss = self.step(self.states[ids], self.targets[ids], self.gen)
        self.losses.append(loss)
        return loss


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def setup(cell, seed: int, device, fault: Optional[str] = None) -> dict:
    """Build the step and drive its first steps; ``fault`` plants a fault
    in the program ("frozen": the optimizer never updates; "half_batch":
    each step takes the first half of its batch)."""
    from nbody_gnn_hpc_torch.device import use_full_f32
    from nbody_gnn_hpc_torch.io.model_io import params_from_jax
    from nbody_gnn_hpc_torch.models.gnn import model_from_config
    from nbody_gnn_hpc_torch.train.schedule import make_step_schedule
    from nbody_gnn_hpc_torch.train.steps import (make_optimizer,
                                                 make_train_step)

    cfg, tr = cell.config, cell.traffic
    mc, tc = cfg["model_config"], cfg["training_config"]
    n, k, batch = cfg["particles"], cfg["k_neighbors"], tr["batch_size"]
    marks = [("start", time.perf_counter())]
    if device.type == "cuda":
        use_full_f32()
    data_gen = torch.Generator(device).manual_seed(seed ^ 0x5DEECE66D)
    weights = make_weights(data_gen, mc, device)
    states, targets, masses = make_data(data_gen, cfg["train_samples"], n,
                                        device)
    edge_index = knn(states[:10, :, :3].mean(0, keepdim=True), k)[0]
    flat = states[:500].reshape(-1, 6)
    mean, std = flat.mean(0), flat.std(0).clamp_min(1e-6)
    _sync(device)
    marks.append(("data", time.perf_counter()))

    with torch.device(device):
        model = model_from_config(mc if device.type == "cuda"
                                  else {**mc, "dtype": "float32"})
    model.load_state_dict(params_from_jax(weights))
    optimizer = make_optimizer(model, tc["learning_rate"],
                               tc["weight_decay"])
    step = make_train_step(
        model, optimizer, edge_index, mean, std,
        (masses / masses.mean())[:, None], noise_std=tc["noise_std"],
        masses=masses,
        schedule=make_step_schedule(tc["learning_rate"],
                                    cfg["train_samples"] // batch))
    if fault == "frozen":
        optimizer.step = lambda *a, **kw: None
    elif fault == "half_batch":
        whole = step
        step = lambda s, t, g: whole(s[:batch // 2], t[:batch // 2], g)  # noqa
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")
    gen = torch.Generator(device).manual_seed(seed)
    feed = Feed(step, states, targets, gen, batch)
    marks.append(("step_built", time.perf_counter()))

    params = list(model.parameters())
    names = [port_to_flax(nm, p.dim()) for nm, p in model.named_parameters()]
    before = [p.detach().clone() for p in params]
    losses = []
    for i in range(tr["reference_steps"]):
        losses.append(feed.next())
        if i == 0:
            moments = [optimizer.state[p]["exp_avg"] if p in optimizer.state
                       else torch.zeros_like(p) for p in params]
            grad_norms = torch.stack(torch._foreach_norm(moments)) / (
                1 - BETA1)
    change_norms = torch.stack([torch.linalg.vector_norm(p.detach() - b)
                                for p, b in zip(params, before)])
    first_ids = feed.batch_ids[:tr["reference_steps"]].clone()
    del before
    _sync(device)
    marks.append(("first_steps", time.perf_counter()))
    for _ in range(tr["warmup_steps"]):
        feed.next()
    _sync(device)
    marks.append(("warmup", time.perf_counter()))
    return dict(setup_stages=harness.stage_seconds(marks), cell=cell,
                seed=seed, device=device, model=model,
                optimizer=optimizer, feed=feed, weights=weights,
                batch=batch, names=names, losses=losses,
                grad_norms=grad_norms, change_norms=change_norms,
                first_ids=first_ids, states=states, targets=targets,
                masses=masses, edge_index=edge_index, mean=mean, std=std,
                n_params=sum(p.numel() for p in params))


def window(state: dict, seconds: float, trace=None) -> dict:
    """Steps for ``seconds``; ``trace`` (a :class:`perfbench.tracing.Trace`)
    is started and stopped at step boundaries, ``trace_at_s`` into the
    window, for ``trace_s`` seconds, with the device idle at both ends."""
    feed, device, tr = state["feed"], state["device"], state["cell"].traffic
    steps = traced_steps = 0
    tracing = done = False
    _sync(device)
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter() - t0
        if trace is not None and not done:
            if not tracing and now >= tr["trace_at_s"]:
                _sync(device)
                trace.start()
                tracing = True
            elif tracing and now >= tr["trace_at_s"] + tr["trace_s"]:
                _sync(device)
                trace.stop()
                tracing, done = False, True
        if now >= seconds:
            break
        feed.next()
        steps += 1
        traced_steps += tracing
    _sync(device)
    t1 = time.perf_counter()
    if tracing:
        trace.stop()
    samples = steps * state["batch"]
    return {"train_samples_per_s": samples / (t1 - t0),
            "attempted": steps, "failed": 0, "steps": steps,
            "window_s": t1 - t0, "traced_steps": traced_steps}


def release(state: dict) -> None:
    """Free the program's state, keeping the inputs the reference needs:
    the weights, the first batches, the edges and the statistics."""
    ids = state["first_ids"]
    state["first_states"] = state["states"][ids.reshape(-1)].view(
        *ids.shape, *state["states"].shape[1:])
    state["first_targets"] = state["targets"][ids.reshape(-1)].view_as(
        state["first_states"])
    state["program"] = {
        "losses": [float(x) for x in state["losses"]],
        "grad": dict(zip(state["names"], state["grad_norms"].tolist())),
        "change": dict(zip(state["names"], state["change_norms"].tolist()))}
    for key in ("model", "optimizer", "feed", "states", "targets",
                "losses", "grad_norms", "change_norms"):
        state.pop(key, None)
    if state["device"].type == "cuda":
        torch.cuda.empty_cache()


def reference_readings(state: dict, prec: str) -> dict:
    """The reference's losses, first-gradient norms and changes over the
    same first steps, in precision ``prec``; checks that its generator
    gives the same first batches."""
    cell, device = state["cell"], state["device"]
    cfg, tr = cell.config, cell.traffic
    mc, tc = cfg["model_config"], cfg["training_config"]
    n, k, batch = cfg["particles"], cfg["k_neighbors"], state["batch"]
    chunk = max(1, tr["reference_chunk_edges"] // (n * k))
    rt = ref_train.ReferenceTrainer(
        state["weights"], state["mean"], state["std"], state["masses"],
        state["edge_index"], mc["n_layers"], mc["dropout"], tc["noise_std"],
        tc["learning_rate"], tc["weight_decay"], prec, chunk)
    gen = torch.Generator(device).manual_seed(state["seed"])
    samples = cfg["train_samples"]
    perm = torch.randperm(samples, generator=gen, device=device)
    n_steps = tr["reference_steps"]
    ids = perm[:n_steps * batch].view(n_steps, batch)
    if not torch.equal(ids, state["first_ids"]):
        raise RuntimeError("the reference's generator gives other batches")
    start = {kk: v.detach().clone() for kk, v in rt.params.items()}
    losses, grads = [], None
    for i in range(n_steps):
        draws = ref_gnn.draw_step(gen, batch, n, mc["hidden_dim"],
                                  mc["n_layers"], mc["dropout"], device)
        loss, got = rt.step(state["first_states"][i],
                            state["first_targets"][i], draws)
        losses.append(loss)
        if i == 0:
            grads = ref_train.leaf_norms(got)
    change = ref_train.leaf_norms({kk: rt.params[kk].detach() - start[kk]
                                   for kk in start})
    return {"losses": losses, "grad": grads, "change": change}


def compare(program: dict, reference: dict) -> dict:
    """The numbers compared: the first step's loss gap and the worst
    step's, relative to the reference's loss, and the worst leaf's gap of
    first-gradient norms and of change norms
    (:func:`perfbench.reference.train.worst_leaf_gap`), over the leaves
    whose reference gradient is not negligible.  The first step's loss
    holds the same weights and draws on both sides, so the rounding the
    first updates carry into the later steps does not reach it."""
    want_g = reference["grad"]
    med = sorted(want_g.values())[len(want_g) // 2]
    leaves = [kk for kk, v in want_g.items() if v >= NEGLIGIBLE_GRAD * med]
    gaps = [abs(a - b) / abs(b) for a, b in
            zip(program["losses"], reference["losses"])]
    grad_gap, grad_leaf = ref_train.worst_leaf_gap(program["grad"], want_g,
                                                   leaves)
    change_gap, change_leaf = ref_train.worst_leaf_gap(
        program["change"], reference["change"], leaves)
    return {"first_loss_gap": gaps[0], "loss_gap": max(gaps),
            "grad_gap": grad_gap, "change_gap": change_gap,
            "grad_leaf": grad_leaf, "change_leaf": change_leaf,
            "left_out": sorted(set(want_g) - set(leaves))}


def check(state: dict) -> dict:
    """The numbers compared, program against the reference at the
    configuration's precision."""
    prec = state["cell"].config["model_config"]["dtype"]
    if state["device"].type != "cuda":
        prec = "float32"  # the program trains in float32 off the card
    return compare(state["program"], reference_readings(state, prec))
