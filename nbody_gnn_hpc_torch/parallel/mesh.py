"""Process groups and device meshes for data parallelism (port of
``nbody_gnn_hpc_tpu/parallel/mesh.py``).

The JAX package shards the batch axis over a ``jax.sharding.Mesh`` of the
devices one process sees.  Here every rank is a process with one device
(torchrun's layout), and a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the
initialised process group:

- :func:`make_mesh`: 1-D, named ``("data",)``;
- :func:`make_hybrid_mesh`: 2-D ``("dcn", "data")``, the inner axis within a
  host, the outer across hosts (the JAX function's slices; hosts stand in
  for them here, :func:`slice_structure`).

:func:`batch_sharding` says which rows of a leading batch axis a rank
holds; :func:`replicated` is every row.  :func:`init_data_parallel` sets up
the group from torchrun's environment (or a world of one): NCCL for a CUDA
device, gloo for the CPU.  Another backend is used only where a caller
names it (two gloo ranks can share one card, which NCCL refuses).
:func:`run_local_world` spawns a world of ranks on this host, each joined
through a ``file://`` store.
"""

import os
import pickle
import queue as queue_mod
import socket
import tempfile
import time
import traceback
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from nbody_gnn_hpc_torch.device import resolve_device

DATA_AXIS = "data"
DCN_AXIS = "dcn"

# This process's rank device, set by init_data_parallel: a mesh's device
# type is its type.
_rank_device: Optional[torch.device] = None


def init_data_parallel(device=None, backend: Optional[str] = None,
                       init_method: Optional[str] = None,
                       rank: Optional[int] = None,
                       world_size: Optional[int] = None) -> torch.device:
    """Join (or form) the process group this rank trains in; returns the
    rank's device.

    ``device``: cuda unless the CPU is asked for; a CUDA rank takes
    ``cuda:LOCAL_RANK``.  ``backend``: NCCL for CUDA and gloo for the CPU
    unless named.  ``rank``, ``world_size`` and ``init_method`` come from
    torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``) where not given; with neither, the world is this
    process alone, on an in-memory store.  A group that already exists is
    kept.
    """
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                          % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    global _rank_device
    _rank_device = dev
    if dist.is_initialized():
        return dev
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world_size = (int(env.get("WORLD_SIZE", 1)) if world_size is None
                  else world_size)
    if init_method is None and "MASTER_ADDR" in env:
        init_method = "env://"
    if init_method is None:
        if world_size != 1:
            raise ValueError(f"a world of {world_size} ranks needs an "
                             f"init_method or torchrun's environment")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    else:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size)
    return dev


def _device_type() -> str:
    """The type of the device :func:`init_data_parallel` gave this rank."""
    if _rank_device is None:
        raise RuntimeError("no rank device: join the process group with "
                           "init_data_parallel() first")
    return _rank_device.type


def make_mesh(n_devices: Optional[int] = None,
              axis_name: str = DATA_AXIS) -> DeviceMesh:
    """1-D mesh over ranks 0 .. ``n_devices`` - 1 of the process group
    (default: all), on the rank's device type.  Every rank of the group
    calls it; a rank outside the mesh holds no rows of it."""
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if not 1 <= n <= world:
        raise ValueError(f"requested {n} devices, have {world}")
    return DeviceMesh(_device_type(), torch.arange(n),
                      mesh_dim_names=(axis_name,))


def slice_structure() -> Optional[Tuple[int, int]]:
    """``(n_hosts, ranks_per_host)`` when the group spans more than one
    host with as many ranks on each, ranks of a host contiguous (torchrun's
    layout), else None.  Hosts stand in for the JAX function's TPU slices:
    the interconnect within one is fast, between them slow.  Ranks per host
    come from ``LOCAL_WORLD_SIZE`` where torchrun sets it, else from the
    ranks' host names (a collective: every rank calls it)."""
    world = dist.get_world_size()
    if "LOCAL_WORLD_SIZE" in os.environ:
        per = int(os.environ["LOCAL_WORLD_SIZE"])
    else:
        names = [None] * world
        dist.all_gather_object(names, socket.gethostname())
        per = names.count(names[0])
        if any(names[i] != names[i - i % per] for i in range(world)):
            return None
    if per >= world or world % per:
        return None
    return world // per, per


def make_hybrid_mesh(n_slices: Optional[int] = None,
                     axis_names: Tuple[str, str] = (DCN_AXIS, DATA_AXIS)
                     ) -> DeviceMesh:
    """2-D ``(dcn, data)`` mesh over every rank of the group.

    ``n_slices`` given: contiguous groups of world / n_slices ranks (a
    multi-host layout emulated anywhere, as the tests do).  ``None``: the
    hosts, read by :func:`slice_structure`; raises on one host, where
    :func:`make_mesh` is the mesh to use.
    """
    world = dist.get_world_size()
    if n_slices is None:
        st = slice_structure()
        if st is None:
            raise ValueError("the process group spans one host; pass "
                             "n_slices explicitly or use make_mesh()")
        n_slices = st[0]
    if world % n_slices:
        raise ValueError(f"{world} devices not divisible into {n_slices} "
                         f"slices")
    return DeviceMesh(_device_type(),
                      torch.arange(world).reshape(n_slices, -1),
                      mesh_dim_names=tuple(axis_names))


class BatchSharding(NamedTuple):
    """Rank ``index`` of ``count`` that split a leading batch axis."""

    index: int
    count: int

    def bounds(self, n: int) -> Tuple[int, int]:
        """This rank's rows [start, stop) of ``n``: blocks of
        ceil(n / count) in rank order, so the padding of
        :func:`pad_to_multiple` falls on the last ranks."""
        per = -(-n // self.count)
        start = min(n, self.index * per)
        return start, min(n, start + per)


def _flat_index(mesh: DeviceMesh) -> int:
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
    idx = 0
    for size, c in zip(mesh.mesh.shape, coord):
        idx = idx * size + c
    return idx


def batch_sharding(mesh: DeviceMesh, axis_name=None) -> BatchSharding:
    """This rank's share of a leading batch axis split over every mesh axis
    (or over ``axis_name``), ranks in row-major mesh order: a 1-D data mesh
    and a 2-D (dcn, data) mesh both get full-mesh data parallelism."""
    if axis_name is None:
        return BatchSharding(_flat_index(mesh), mesh.mesh.numel())
    return BatchSharding(mesh.get_local_rank(axis_name),
                         mesh.size(mesh.mesh_dim_names.index(axis_name)))


def replicated(mesh: DeviceMesh) -> BatchSharding:
    """Every rank holds every row (the parameters' layout)."""
    del mesh
    return BatchSharding(0, 1)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def mesh_groups(mesh: DeviceMesh) -> list:
    """The process groups of the mesh's axes, inner axis first: an
    all-reduce over each in turn reduces over the whole mesh, within a host
    before across hosts."""
    return [mesh.get_group(d) for d in reversed(range(mesh.ndim))]


def _rank_main(rank: int, fn: Callable, world_size: int, device: str,
               backend: str, init_file: str, args: tuple, results) -> None:
    torch.set_num_threads(1)
    try:
        if device == "cuda":  # rank r on card r (all on one card: shared)
            device = f"cuda:{rank % torch.cuda.device_count()}"
        dev = init_data_parallel(device, backend=backend,
                                 init_method=f"file://{init_file}",
                                 rank=rank, world_size=world_size)
        # Pickled here, by value: the queue would otherwise pass a tensor's
        # storage by a handle that dies with this process.
        results.put((rank, pickle.dumps(fn(rank, dev, *args)), None))
    except BaseException:  # noqa: BLE001 — reported to the parent
        results.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_local_world(fn: Callable, world_size: int, args: tuple = (), *,
                    device: str = "cpu", backend: str = "gloo",
                    timeout: float = 300.0) -> list:
    """Run ``fn(rank, device, *args)`` in ``world_size`` spawned processes
    that form one process group (``backend``, joined through a ``file://``
    store in a temporary directory); returns the ranks' results in rank
    order.  Each rank runs with ``OMP_NUM_THREADS=1``.  Raises the first
    rank's error, or ``TimeoutError`` if the ranks do not all finish within
    ``timeout`` seconds; every process is ended before it returns.  ``fn``
    and ``args`` must pickle (a module-level function)."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    saved = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"  # read by each child at start
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, fn, world_size, device, backend,
                                   os.path.join(tmp, "store"), args,
                                   results))
                 for r in range(world_size)]
        try:
            for p in procs:
                p.start()
        finally:
            if saved is None:
                os.environ.pop("OMP_NUM_THREADS")
            else:
                os.environ["OMP_NUM_THREADS"] = saved
        deadline = time.monotonic() + timeout
        out, errors = {}, []
        try:
            while len(out) + len(errors) < world_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"{world_size - len(out)} of {world_size} ranks did "
                        f"not finish within {timeout:.0f} s")
                try:
                    rank, value, err = results.get(timeout=min(remaining,
                                                               1.0))
                except queue_mod.Empty:
                    if errors or any(p.exitcode not in (None, 0)
                                     for p in procs):
                        break
                    continue
                if err is None:
                    out[rank] = pickle.loads(value)
                else:
                    errors.append(f"rank {rank}:\n{err}")
        finally:
            for p in procs:
                p.join(timeout=max(0.0, min(10.0,
                                            deadline - time.monotonic())))
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    if len(out) < world_size:
        codes = [p.exitcode for p in procs]
        raise RuntimeError(f"ranks ended without a result (exit codes "
                           f"{codes})")
    return [out[r] for r in range(world_size)]
