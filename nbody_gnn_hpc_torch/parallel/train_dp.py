"""Data-parallel training step over a device mesh (port of
``nbody_gnn_hpc_tpu/parallel/train_dp.py``).

The parameters are replicated: every rank holds the model and the
optimizer.  Each rank takes its rows of the global batch
(:func:`~nbody_gnn_hpc_torch.parallel.mesh.batch_sharding`), computes their
loss and gradient through the same
:func:`~nbody_gnn_hpc_torch.train.steps.make_train_step` the single-device
trainer uses (so the two cannot drift), and the gradients and the loss are
averaged over the mesh in one flattened all-reduce per mesh axis, not one
per tensor.  Clip 1.0 and AdamW then run identically on every rank, so the
parameters stay replicated.
"""

from typing import Optional

import torch
import torch.distributed as dist

from nbody_gnn_hpc_torch.models.gnn import BatchRows
from nbody_gnn_hpc_torch.parallel.mesh import batch_sharding, mesh_groups
from nbody_gnn_hpc_torch.train.loss import PhysicsInformedLoss
from nbody_gnn_hpc_torch.train.steps import make_train_step

DP_IMPLS = ("gspmd", "shard_map")
# Odd 64-bit constant the rank is folded into a generator's seed with.
_FOLD = 0x9E3779B97F4A7C15


class DataParallelStep:
    """``step(states, targets, generator=None) -> loss`` over the GLOBAL
    (B, N, 6) raw batch, the same tensors on every rank, B divisible by the
    mesh size; the returned loss is the global batch's.  ``count``,
    ``compute_loss`` and ``update`` are the wrapped single-device step's."""

    def __init__(self, base, mesh, impl: str):
        self.base = base
        self.impl = impl
        self.shard = batch_sharding(mesh)
        self.groups = mesh_groups(mesh)
        self._local = {}  # id(generator) -> (generator, this rank's own)

    @property
    def count(self) -> int:
        return self.base.count

    @count.setter
    def count(self, value: int) -> None:
        self.base.count = value

    def compute_loss(self, *args, **kwargs):
        return self.base.compute_loss(*args, **kwargs)

    def _rank_generator(self, generator):
        """``shard_map``'s draws: a generator of this rank's own, seeded
        with the rank folded into ``generator``'s seed (made once, then
        carried from step to step)."""
        if generator is None:
            return None
        mine = self._local.get(id(generator))
        if mine is None or mine[0] is not generator:
            seed = (generator.initial_seed()
                    + (self.shard.index + 1) * _FOLD) % 2 ** 64
            mine = (generator, torch.Generator(
                device=generator.device).manual_seed(seed))
            self._local[id(generator)] = mine
        return mine[1]

    def reduce_sum(self, flat: torch.Tensor) -> torch.Tensor:
        """``flat`` summed over the mesh, in place: one all-reduce a mesh
        axis, inner axis first."""
        for group in self.groups:
            dist.all_reduce(flat, group=group)
        return flat

    def reduce_mean(self, flat: torch.Tensor) -> torch.Tensor:
        """``flat`` averaged over the mesh, in place."""
        flat /= self.shard.count
        return self.reduce_sum(flat)

    def __call__(self, states, targets, generator=None):
        b = states.shape[0]
        if b % self.shard.count:
            raise ValueError(f"a batch of {b} does not split over "
                             f"{self.shard.count} ranks")
        lo, hi = self.shard.bounds(b)
        params = self.base.params
        for p in params:
            p.grad = None
        if self.impl == "gspmd":
            loss, _ = self.base.compute_loss(
                states[lo:hi], targets[lo:hi], generator,
                rows=BatchRows(lo, b))
        else:
            loss, _ = self.base.compute_loss(
                states[lo:hi], targets[lo:hi],
                self._rank_generator(generator))
        loss.backward()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]
        flat = self.reduce_mean(torch.cat(
            [g.reshape(-1) for g in grads] + [loss.detach().reshape(1)]))
        offset = 0
        for p in params:
            n = p.numel()
            p.grad = flat[offset:offset + n].view_as(p)
            offset += n
        self.base.update()
        return flat[-1].clone()  # not a view that would keep ``flat``


def make_dp_train_step(model, optimizer, edge_index, state_mean, state_std,
                       mass_feat, mesh, noise_std: float = 0.003,
                       masses: Optional[torch.Tensor] = None,
                       criterion: Optional[PhysicsInformedLoss] = None,
                       impl: str = "gspmd", **step_kwargs
                       ) -> DataParallelStep:
    """Build a data-parallel train step over ``mesh`` (1-D ``("data",)`` or
    the 2-D ``("dcn", "data")`` hybrid mesh: the batch splits over every
    axis, and the gradient is reduced within a host before across hosts).

    Arguments as :func:`~nbody_gnn_hpc_torch.train.steps.make_train_step`
    (``step_kwargs`` passes its others, e.g. ``schedule``), plus ``mesh``
    and ``impl``, which says how the ranks draw their noise and dropout:

    - ``"gspmd"`` (default): each rank draws what the single-device step
      draws for its rows (:class:`~nbody_gnn_hpc_torch.models.gnn.BatchRows`:
      node-side masks and input noise at the global batch's shape, its rows
      kept; the edge stream's Philox counter offset by the rank's first
      row), so the step equals the single-device step with noise and
      dropout on.
    - ``"shard_map"``: each rank draws at its own shape from a generator
      with its rank folded into the seed: the same distribution, other
      bits; equal to the single-device step when noise and dropout are off.

    Unlike the JAX ``gspmd`` step, which pins its XLA edge branch because
    GSPMD cannot split a Pallas call (``train_dp.py:62-68``), both impls
    run the CUDA kernels on every rank: the edge stream (kernels 1 and 2)
    or, with ``edge_impl="fused_full"``, the whole layer (kernels 7 and 2).
    """
    if impl not in DP_IMPLS:
        raise ValueError(f"unknown dp impl {impl!r}")
    base = make_train_step(model, optimizer, edge_index, state_mean,
                           state_std, mass_feat, noise_std=noise_std,
                           masses=masses, criterion=criterion, **step_kwargs)
    return DataParallelStep(base, mesh, impl)
