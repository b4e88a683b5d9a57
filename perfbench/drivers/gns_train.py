"""Training cells of GNS (``model_config`` ``architecture: "gns"``): the
port's production training step (``make_train_step``, its CUDA graph, the
physics loss, the clip, AdamW), fed as :mod:`perfbench.drivers.train_loop`
feeds ``NBodyGNN``: ``Trainer.train_epoch``'s order, no host sync between
steps.  Set-up, the window, the release and the comparison are
``train_loop``'s; the model, its weights and the plain reference
(:mod:`perfbench.reference.gns`) are GNS's.

Traffic keys as ``train_loop``'s: ``batch_size``, ``reference_steps``,
``warmup_steps``, ``reference_chunk_edges``, ``trace_at_s``, ``trace_s``.
"""

import gc
import time
from typing import Optional

import torch

from perfbench import harness
from perfbench.drivers import train_loop
from perfbench.drivers.train_loop import (BETA1, Feed, _sync, compare,
                                          make_data, port_to_flax)
from perfbench.reference import gns as ref_gns
from perfbench.reference import train as ref_train
from perfbench.reference.rollout import knn

def make_weights(gen: torch.Generator, mc: dict, device) -> dict:
    """Every leaf random from one draw, as ``train_loop.make_weights``:
    kernels N(0, 1/fan_in), biases N(0, 0.05^2), LayerNorm scales
    1 + N(0, 0.05^2)."""
    shapes = ref_gns.shapes_of(mc)
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


def setup(cell, seed: int, device, fault: Optional[str] = None) -> dict:
    """Build the step and drive its first steps; ``fault`` as
    ``train_loop.setup`` takes it ("frozen", "half_batch")."""
    from nbody_gnn_hpc_torch.device import use_full_f32
    from nbody_gnn_hpc_torch.io.model_io import params_from_jax
    from nbody_gnn_hpc_torch.models import model_from_config
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
    graphed = step
    if fault == "frozen":
        optimizer.step = lambda *a, **kw: None
    elif fault == "half_batch":
        half = batch // 2
        step = lambda s, t, g: graphed(s[:half], t[:half], g)  # noqa: E731
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
                optimizer=optimizer, feed=feed, step=graphed,
                weights=weights, batch=batch, names=names, losses=losses,
                grad_norms=grad_norms, change_norms=change_norms,
                first_ids=first_ids, states=states, targets=targets,
                masses=masses, edge_index=edge_index, mean=mean, std=std,
                n_params=sum(p.numel() for p in params))


def window(state: dict, seconds: float, trace=None) -> dict:
    """``train_loop.window``, its record also holding how the step ran
    by the window's end: ``eager_steps``, ``captures`` and
    ``graph_replays`` (on the card 1, 1 and every later step)."""
    record = train_loop.window(state, seconds, trace)
    step = state["step"]
    record.update(eager_steps=step.eager_steps, captures=step.captures,
                  graph_replays=step.graph_replays)
    return record


def release(state: dict) -> None:
    """``train_loop.release``, the step freed with the model.  The step's
    closure refers to itself, so only the collector frees it, and with it
    its CUDA graph's memory pool: without it a process that sets up seed
    after seed (``control.py``) keeps every seed's graph on the card."""
    state.pop("step", None)
    train_loop.release(state)
    gc.collect()
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
    rt = ref_gns.ReferenceTrainer(
        state["weights"], state["mean"], state["std"], state["masses"],
        state["edge_index"], mc, tc["noise_std"], tc["learning_rate"],
        tc["weight_decay"], prec, chunk)
    gen = torch.Generator(device).manual_seed(state["seed"])
    perm = torch.randperm(cfg["train_samples"], generator=gen, device=device)
    n_steps = tr["reference_steps"]
    ids = perm[:n_steps * batch].view(n_steps, batch)
    if not torch.equal(ids, state["first_ids"]):
        raise RuntimeError("the reference's generator gives other batches")
    start = {kk: v.detach().clone() for kk, v in rt.params.items()}
    losses, grads = [], None
    for i in range(n_steps):
        draws = ref_gns.draw_step(gen, batch, n, device)
        loss, got = rt.step(state["first_states"][i],
                            state["first_targets"][i], draws)
        losses.append(loss)
        if i == 0:
            grads = ref_train.leaf_norms(got)
    change = ref_train.leaf_norms({kk: rt.params[kk].detach() - start[kk]
                                   for kk in start})
    return {"losses": losses, "grad": grads, "change": change}


def check(state: dict) -> dict:
    """The numbers compared, program against the reference at the
    configuration's precision (float32 off the card, where the program
    trains in float32)."""
    prec = state["cell"].config["model_config"]["dtype"]
    if state["device"].type != "cuda":
        prec = "float32"
    return compare(state["program"], reference_readings(state, prec))
