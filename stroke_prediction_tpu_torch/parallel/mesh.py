"""The data-parallel mesh and its row rule (port of parallel/mesh.py).

JAX describes data parallelism as a device mesh with a ``data`` axis and
lets XLA insert the collectives.  Here each rank is a process on its own
card (``parallel/distributed.py``), and the mesh is stated explicitly:
this process's rank and the world size.

The row rule of JAX's ``shard_batch`` and of its learner's in-graph gather:
a batch whose size divides the world is sharded by rows, rank ``r``
holding ``rows[r::world]``; any other batch is replicated, every rank
running it whole.  A :class:`Sharding` says which of the two a step is.
While a step runs inside ``with sharding.active():``, :func:`current`
returns that sharding, and the reductions over the batch (BN moments, the
Dice sums, the measures' counts and the gradients;
``parallel/collectives.py``) sum over the ranks if it is sharded over more
than one.  Outside, and in a replicated step, they stay local.

The ``space`` axis (the H axis sharded with halo exchanges) is not ported.
"""

from __future__ import annotations

import contextlib
import contextvars
from dataclasses import dataclass
from typing import Iterator, Optional

from stroke_prediction_tpu_torch.parallel.distributed import (
    process_count, process_index)


@dataclass(frozen=True)
class Mesh:
    """``world`` processes on a ``data`` axis; this one is ``rank``."""

    rank: int
    world: int


def make_data_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The mesh over the process group: ``n_devices`` ranks, by default
    all of them.  A rank is a process, so ``n_devices`` must be the
    group's size."""
    world = process_count()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh of {n} ranks needs a process group of "
                         f"{n} processes, this one has {world}")
    return Mesh(process_index(), n)


def make_mesh(data: int = 1, space: int = 1) -> Mesh:
    if space > 1:
        raise NotImplementedError("the 'space' axis (H sharded over ranks) "
                                  "is not ported")
    return make_data_mesh(data)


@dataclass(frozen=True)
class Sharding:
    """How one step's batch lies on ``mesh`` (``None``: one process)."""

    mesh: Optional[Mesh]
    sharded: bool

    @property
    def reduces(self) -> bool:
        """Whether the step's batch reductions sum over the ranks."""
        return self.sharded and self.mesh is not None and self.mesh.world > 1

    def take(self, rows):
        """This rank's rows of a global batch (a sequence, array or tensor
        indexed along its first axis)."""
        if not self.reduces:
            return rows
        return rows[self.mesh.rank::self.mesh.world]

    def global_size(self, n_local: int) -> int:
        """The global batch of a step with ``n_local`` rows here."""
        return n_local * self.mesh.world if self.reduces else n_local

    @contextlib.contextmanager
    def active(self) -> Iterator["Sharding"]:
        token = _ACTIVE.set(self)
        try:
            yield self
        finally:
            _ACTIVE.reset(token)


LOCAL = Sharding(None, False)
_ACTIVE: contextvars.ContextVar[Sharding] = contextvars.ContextVar(
    "sharding", default=LOCAL)


def current() -> Sharding:
    """The sharding of the step running now (:data:`LOCAL` outside one)."""
    return _ACTIVE.get()


def batch_sharding(mesh: Optional[Mesh], spatial: bool = False) -> Sharding:
    """Rows over the ``data`` axis."""
    if spatial:
        raise NotImplementedError("spatial (H-axis) sharding is not ported")
    return Sharding(mesh, True)


def replicate(mesh: Optional[Mesh]) -> Sharding:
    return Sharding(mesh, False)


def row_sharding(mesh: Optional[Mesh], n_rows: int) -> Sharding:
    """The row rule: sharded when ``n_rows`` divides over the mesh, else
    replicated."""
    if mesh is not None and n_rows % mesh.world == 0:
        return batch_sharding(mesh)
    return replicate(mesh)


def shard_batch(mesh: Optional[Mesh], tree: dict,
                spatial: bool = False) -> dict:
    """This rank's part of a global batch ``{key: array or None}``: each
    array with a first axis that divides over the mesh is sharded by rows,
    any other is kept whole."""
    if spatial:
        raise NotImplementedError("spatial (H-axis) sharding is not ported")

    def local(v):
        if v is None or v.ndim == 0:
            return v
        return row_sharding(mesh, len(v)).take(v)

    return {k: local(v) for k, v in tree.items()}
