"""Async checkpoints on ``torch.distributed.checkpoint`` (port of
``nbody_gnn_hpc_tpu/io/orbax_io.py``).

The JAX package's ``OrbaxCheckpointer`` streams a training state to disk
in the background while training goes on.  This class keeps its name and
its API, but the files on disk are **DCP's format, not Orbax's**: a step
is a directory ``<directory>/<step>/`` holding ``__0_0.distcp`` and
``.metadata``.  Neither package reads the other's async checkpoints (the
pickle ``.pt`` files still cross both ways).

Usage:
    mgr = OrbaxCheckpointer("./models/orbax")
    mgr.save(step, {"params": model.state_dict(),
                    "opt_state": optimizer.state_dict()}, force=True)
    mgr.wait()   # block until every queued write is durable
    restored = mgr.restore(step, like={...})

``save`` copies every tensor of the tree to host memory (one device to
host copy for tensors on the card) and returns; a writer thread then runs
``dcp.save(..., no_dist=True)`` on that copy, so the saved step holds the
values of the moment ``save`` was called.  ``dcp.async_save`` is not used
for this: it refuses a process group without a CPU backend (NCCL alone,
as data-parallel training on the card runs), and how much of its staging
happens before it returns differs between PyTorch releases.

A step counts only once DCP's ``FileSystemWriter`` has renamed its
``.metadata.tmp`` into ``<step>/.metadata``, the last thing it writes:
this backend's durability marker, the counterpart of Orbax's
``_CHECKPOINT_METADATA``.  A step directory without it is torn (a crash
mid-write) and is skipped by ``latest_step`` and ``all_steps``.
"""

import copy
import shutil
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, List, Optional

import torch

# The file DCP writes last into a step directory (by rename): a step whose
# directory holds it is durable.
DURABLE_MARKER = ".metadata"


def is_durable(step_dir) -> bool:
    """Whether ``step_dir`` holds a complete DCP checkpoint."""
    return (Path(step_dir) / DURABLE_MARKER).exists()


def _stage(tree: Any) -> Any:
    """A host copy of ``tree``: tensors copied to the CPU (detached, never
    sharing storage with the input), every other leaf deep-copied, so later
    updates of the live state cannot reach the write."""
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _stage(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_stage(v) for v in tree]
    return copy.deepcopy(tree)


class OrbaxCheckpointer:
    """Numbered async checkpoints of a nested dict of tensors under one
    directory.  ``max_to_keep``: once a write is durable, the oldest
    durable steps beyond this many are deleted (None keeps all)."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = None):
        import torch.distributed.checkpoint as dcp

        self._dcp = dcp
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._writer: Optional[ThreadPoolExecutor] = None  # on first save
        self._pending: List[Future] = []

    def _step_dir(self, step: int) -> Path:
        return self.directory / str(int(step))

    def save(self, step: int, tree: Any, force: bool = False) -> bool:
        """Queue a write of ``tree`` at ``step``; returns once the tree is
        staged in host memory.  ``force`` is kept for the JAX signature
        (every call saves).  A durable ``step`` raises FileExistsError; a
        torn one is removed first."""
        del force
        step_dir = self._step_dir(step)
        if is_durable(step_dir):
            raise FileExistsError(f"step {step} already saved in "
                                  f"{self.directory}")
        if step_dir.exists():
            shutil.rmtree(step_dir)
        staged = _stage(tree)
        if self._writer is None:
            self._writer = ThreadPoolExecutor(max_workers=1,
                                              thread_name_prefix="dcp-writer")

        def write():
            self._dcp.save(staged, checkpoint_id=str(step_dir), no_dist=True)
            self._prune()

        self._pending.append(self._writer.submit(write))
        return True

    def _prune(self) -> None:
        """Delete the oldest durable steps beyond ``max_to_keep`` (runs in
        the writer thread after each write)."""
        if self.max_to_keep is None:
            return
        steps = self.all_steps()
        for step in steps[:max(0, len(steps) - self.max_to_keep)]:
            shutil.rmtree(self._step_dir(step), ignore_errors=True)

    @property
    def pending(self) -> int:
        """Queued writes that are not durable yet."""
        return sum(not f.done() for f in self._pending)

    def restore(self, step: Optional[int] = None, like: Any = None) -> Any:
        """Restore ``step`` (default: the latest durable one).  ``like`` is
        the target tree: DCP fills the tensors it holds in place (on their
        devices) and replaces its other leaves; keys the checkpoint has
        and ``like`` lacks are not read, so an optimizer state must be
        built before it is restored into.  Without ``like``, a flat dict
        of every saved entry by DCP's dotted name (tensors on the CPU)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no durable checkpoints in "
                                    f"{self.directory}")
        step_dir = self._step_dir(step)
        if not is_durable(step_dir):
            raise FileNotFoundError(f"step {step} in {self.directory} is "
                                    f"not durable")
        if like is None:
            from torch.distributed.checkpoint.metadata import \
                TensorStorageMetadata

            meta = self._dcp.FileSystemReader(str(step_dir)).read_metadata()
            like = {name: torch.empty(md.size, dtype=md.properties.dtype)
                    if isinstance(md, TensorStorageMetadata) else None
                    for name, md in meta.state_dict_metadata.items()}
        self._dcp.load(like, checkpoint_id=str(step_dir), no_dist=True)
        return like

    def all_steps(self) -> List[int]:
        """The durable steps, in increasing order."""
        return sorted(int(d.name) for d in self.directory.iterdir()
                      if d.name.isdigit() and is_durable(d))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        """Block until every queued write is durable; raises the first
        error a write met (the others are still waited for)."""
        pending, self._pending = self._pending, []
        first = None
        for future in pending:
            err = future.exception()
            if err is not None and first is None:
                first = err
        if first is not None:
            raise first

    def close(self) -> None:
        """Wait for the queued writes, then stop the writer thread."""
        try:
            self.wait()
        finally:
            if self._writer is not None:
                self._writer.shutdown(wait=True)
                self._writer = None
