"""The training step (port of ``nbody_gnn_hpc_tpu/train/steps.py``):
normalise -> input noise with the pos resync -> mass-feature concat ->
dropout forward over the batch -> physics loss -> global-norm clip ->
AdamW (reference ``train.py:396-435``).

The batch is one (B, N, 7) forward through the edge kernels' batch axis
(the JAX package vmaps the per-graph forward).  The optimizer is
``torch.optim.AdamW`` with optax's defaults (betas 0.9/0.999, eps 1e-8,
decoupled weight decay on every parameter, as ``optax.adamw`` with no
mask); the clip is written as ``optax.clip_by_global_norm`` writes it.
On CUDA it is capturable, so every training path there runs one AdamW.

On CUDA the step is one CUDA graph.  The first call with an input
signature (the batch's shapes, dtypes and device, and the generator
object) runs eagerly, on the stream that signature's graph is captured on;
the second captures the whole step (zero_grad, normalise, noise, the
forward with every draw, loss, backward, clip, AdamW) and replays it;
every later call writes the update's LR into the tensor AdamW reads,
copies the batch into the graph's inputs and replays.  The generator is
registered with the graph, which reads its seed and offset at each
replay, so the draws are the eager step's.  The step stays eager off
CUDA, under ``remat``, with ``edge_impl="fused_full"`` (kernel 7's
cooperative launch) and with an optimizer not in ``make_optimizer``'s
CUDA form (capturable, its LR a device tensor).  A signature starts
again from an eager step when a parameter's storage, an optimizer state
or LR tensor, or another hyperparameter changes
(``optimizer.load_state_dict``, a resume).
"""

from typing import Callable, Optional

import torch

from nbody_gnn_hpc_torch.models.gnn import draw_rows
from nbody_gnn_hpc_torch.ops import (CapturedLaunches, arrival_counters,
                                     arrivals_from)
from nbody_gnn_hpc_torch.ops.knn import is_row_regular
from nbody_gnn_hpc_torch.train.loss import PhysicsInformedLoss, mse_loss
from nbody_gnn_hpc_torch.utils.profiling import annotate

GRAD_CLIP_NORM = 1.0  # reference train.py:429


def make_optimizer(model: torch.nn.Module, learning_rate: float,
                   weight_decay: float) -> torch.optim.AdamW:
    """``optax.adamw(lr, weight_decay=wd)`` over every parameter.  On CUDA
    capturable (its bias correction in float32 on the device), its LR a
    float32 tensor there for its whole life: the one AdamW of every CUDA
    training path, graphed or eager.  Files hold the CPU form."""
    dev = next(model.parameters()).device
    cuda = dev.type == "cuda"
    optimizer = torch.optim.AdamW(
        model.parameters(), betas=(0.9, 0.999), eps=1e-8,
        weight_decay=weight_decay, capturable=cuda,
        lr=torch.tensor(learning_rate, dtype=torch.float32, device=dev)
        if cuda else learning_rate)
    # torch warns once that a capturable optimizer steps outside a capture:
    # every eager CUDA step does, on purpose.
    optimizer._warned_capturable_if_run_uncaptured = True
    return optimizer


def file_state(optimizer: torch.optim.Optimizer) -> dict:
    """``optimizer.state_dict()`` as files hold it from every device: each
    group's LR a float and ``capturable`` False; the state as it is."""
    state = optimizer.state_dict()
    return {**state, "param_groups": [
        {**g, "lr": float(g["lr"]), "capturable": False}
        for g in state["param_groups"]]}


def load_file_state(optimizer: torch.optim.Optimizer, state: dict) -> None:
    """Load ``file_state``'s form, written on any device, into
    ``optimizer``, which keeps its own: its ``capturable`` flags, its LR
    tensors (filled) and, if capturable, its step counts on the device."""
    live = optimizer.param_groups
    optimizer.load_state_dict({**state, "param_groups": [
        {**g, "capturable": own["capturable"]}
        for g, own in zip(state["param_groups"], live)]})
    for g, own in zip(optimizer.param_groups, live):
        if torch.is_tensor(own["lr"]):
            g["lr"] = own["lr"].fill_(g["lr"])


def clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """In place, as optax: g if ||g|| < max_norm else g / ||g|| * max_norm.
    Returns the global norm (a device tensor; nothing syncs)."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    torch._foreach_div_(grads, torch.where(keep, torch.ones_like(norm), norm))
    torch._foreach_mul_(grads, torch.where(keep, torch.ones_like(norm),
                                           torch.full_like(norm, max_norm)))
    return norm


class _StepGraph:
    """One input signature's graph: the stream it is warmed up and
    captured on, its static inputs and loss, its kernels' arrival
    counters, the gradients it computes, the launches its capture counted
    and what it was built on."""

    def __init__(self, generator, device: torch.device):
        self.generator = generator  # held, as its id is in the signature
        self.stream = torch.cuda.Stream(device)
        self.launches = CapturedLaunches()
        self.graph = self.built_on = None
        self.states = self.targets = self.loss = self.arrivals = None
        self.grads = []


def make_train_step(model, optimizer: torch.optim.Optimizer, edge_index,
                    state_mean, state_std, mass_feat,
                    noise_std: float = 0.003,
                    masses: Optional[torch.Tensor] = None,
                    criterion: Optional[PhysicsInformedLoss] = None,
                    use_physics_loss: bool = True,
                    schedule: Optional[Callable[[int], float]] = None):
    """Build ``step(states, targets, generator) -> loss`` over RAW
    (unnormalised) (B, N, 6) batches on the model's device.

    ``step`` updates the model and optimizer in place and returns the
    batch loss as a device tensor of its own.  ``step.count`` is the
    number of updates so far; the LR of update ``count`` is
    ``schedule(count)`` (the base LR first, as optax counts).
    ``step.eager_steps``, ``step.captures`` and ``step.graph_replays``
    count the calls that ran eagerly, captured the step's graph, and
    replayed it (the module's docstring says when each happens); the
    ``train.step`` span's ``graph`` attribute says which a call was.
    ``step.compute_loss(states, targets, generator=None,
    deterministic=False, rows=None)`` gives (total, details) for one
    batch, for training and validation alike; ``rows``
    (:class:`~nbody_gnn_hpc_torch.models.gnn.BatchRows`) says that the batch
    is a data-parallel rank's rows of a larger one, whose draws it then
    makes.  ``step.update()`` applies the gradients held in the parameters'
    ``.grad``: clip, the LR of this update, AdamW, ``count + 1``, eagerly;
    ``step.params`` lists those parameters in the optimizer's order.
    """
    if criterion is None and use_physics_loss:
        criterion = PhysicsInformedLoss()
    n_nodes = int(mass_feat.reshape(-1).shape[0])
    if not is_row_regular(edge_index, n_nodes):
        raise ValueError(
            "edge_index is not row-regular (row != repeat(arange(N), k)); "
            "build edges with ops/knn.py")
    dev = next(model.parameters()).device
    as_dev = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    edge_index = as_dev(edge_index).long()
    mean, std = as_dev(state_mean).float(), as_dev(state_std).float()
    mass_feat = as_dev(mass_feat).float().reshape(n_nodes, 1)
    if masses is not None:
        masses = as_dev(masses).float()
    params = [p for group in optimizer.param_groups for p in group["params"]]
    full_layer = any(getattr(m, "edge_impl", None) == "fused_full"
                     for m in model.modules())
    graphs = {}  # input signature -> _StepGraph

    def forward(states, targets, generator, deterministic, rows):
        """(prediction, normalised targets)."""
        model.train(not deterministic)
        s_norm = (states - mean) / std
        t_norm = (targets - mean) / std
        # Input-noise injection on the 6 state features, pos resynced to the
        # noised positions (train.py:409-415).
        if noise_std > 0 and not deterministic:
            s_norm = s_norm + noise_std * draw_rows(
                torch.randn, s_norm.shape, generator, dev, rows)
        pos = s_norm[..., :3]
        x = torch.cat([s_norm, mass_feat.expand(*s_norm.shape[:2], 1)], -1)
        pred = model(x, edge_index, pos, generator=generator, rows=rows)
        return pred, t_norm

    def score(pred, t_norm):
        if criterion is not None:
            return criterion(pred, t_norm, masses)
        total = mse_loss(pred, t_norm)
        zero = torch.zeros((), dtype=pred.dtype, device=dev)
        return total, {"total": total, "position": zero, "velocity": zero,
                       "energy": zero, "momentum": zero}

    def compute_loss(states, targets, generator=None, deterministic=False,
                     rows=None):
        return score(*forward(states, targets, generator, deterministic,
                              rows))

    def set_lr():
        """Each group's LR for update ``step.count``, written into the
        group's tensor where the LR is one (a graph reads it there)."""
        if schedule is not None:
            lr = schedule(step.count)
            for group in optimizer.param_groups:
                if torch.is_tensor(group["lr"]):
                    group["lr"].fill_(lr)
                else:
                    group["lr"] = lr

    def clip_and_step():
        clip_by_global_norm_([p.grad for p in params], GRAD_CLIP_NORM)
        optimizer.step()

    def update():
        set_lr()
        clip_and_step()
        step.count += 1

    def run(states, targets, generator):
        """The step's work, each phase in its span: the batch loss."""
        with annotate("train.forward"):
            optimizer.zero_grad(set_to_none=True)
            pred, t_norm = forward(states, targets, generator, False, None)
        with annotate("train.loss"):
            loss, _ = score(pred, t_norm)
        with annotate("train.backward"):
            loss.backward()
        with annotate("train.update"):
            clip_and_step()
        return loss.detach()

    def graphable(states) -> bool:
        return (states.is_cuda and not getattr(model, "remat", False)
                and not full_layer
                and all(g.get("capturable") and torch.is_tensor(g["lr"])
                        for g in optimizer.param_groups))

    def built_on() -> tuple:
        """What a graph reads by address or holds as a constant: each
        parameter's storage, each optimizer state tensor and LR tensor,
        and every other hyperparameter."""
        state, groups = optimizer.state, optimizer.param_groups
        return ([p.data_ptr() for p in params],
                [t for p in params for t in state.get(p, {}).values()]
                + [g["lr"] for g in groups],
                [[(k, v) for k, v in g.items() if k not in ("params", "lr")]
                 for g in groups])

    def same(a: tuple, b: tuple) -> bool:
        return (a[0] == b[0] and a[2] == b[2] and len(a[1]) == len(b[1])
                and all(x is y for x, y in zip(a[1], b[1])))

    def warm(entry: _StepGraph, states, targets, generator):
        """The signature's first step, eager, on the stream its graph is
        captured on: AdamW's state, cuBLAS's workspace for that stream and
        the kernels' scratch exist before the capture."""
        current = torch.cuda.current_stream(states.device)
        entry.stream.wait_stream(current)
        with torch.cuda.stream(entry.stream):
            loss = run(states, targets, generator)
        current.wait_stream(entry.stream)
        entry.built_on = built_on()
        return loss

    def capture(entry: _StepGraph, states, targets, generator):
        """Capture the step on this batch into the signature's graph, then
        replay it once."""
        entry.states, entry.targets = states.clone(), targets.clone()
        b = states.shape[0] if states.dim() == 3 else 1
        entry.arrivals = arrival_counters(b, edge_index.shape[-1],
                                          states.device)
        optimizer.zero_grad(set_to_none=True)
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        with arrivals_from(entry.arrivals, entry.stream), \
                entry.launches.capturing(), \
                torch.cuda.graph(graph, stream=entry.stream,
                                 capture_error_mode="thread_local"):
            entry.loss = run(entry.states, entry.targets, generator)
        entry.graph = graph
        entry.grads = [p.grad for p in params]
        entry.built_on = built_on()
        graph.replay()
        return entry.loss.clone()

    def replay(entry: _StepGraph, states, targets):
        entry.states.copy_(states)
        entry.targets.copy_(targets)
        # The graph computes the gradients into its own tensors; hand them
        # to the parameters, as an eager step leaves its gradients there.
        for p, g in zip(params, entry.grads):
            if p.grad is not g:
                p.grad = g
        entry.graph.replay()
        entry.launches.replayed()
        return entry.loss.clone()

    def step(states, targets, generator=None):
        set_lr()
        if not graphable(states):
            with annotate("train.step", graph="eager"):
                loss = run(states, targets, generator)
            step.eager_steps += 1
        else:
            key = (states.shape, states.dtype, targets.shape, targets.dtype,
                   states.device, id(generator))
            entry = graphs.get(key)
            if entry is not None and not same(entry.built_on, built_on()):
                entry = None  # a tensor it reads was replaced
            if entry is None:
                entry = graphs[key] = _StepGraph(generator, states.device)
                with annotate("train.step", graph="eager"):
                    loss = warm(entry, states, targets, generator)
                step.eager_steps += 1
            elif entry.graph is None:
                with annotate("train.step", graph="capture"):
                    loss = capture(entry, states, targets, generator)
                step.captures += 1
            else:
                with annotate("train.step", graph="replay"):
                    loss = replay(entry, states, targets)
                step.graph_replays += 1
        step.count += 1
        return loss

    step.count = step.eager_steps = step.captures = step.graph_replays = 0
    step.compute_loss = compute_loss
    step.update = update
    step.params = params
    return step
