"""The mesh, its row rule and its H-block rule (port of parallel/mesh.py).

JAX describes parallelism as a device mesh with a ``data`` axis and an
optional ``space`` axis and lets XLA insert the collectives.  Here each
rank is a process on its own card (``parallel/distributed.py``), and the
mesh is stated explicitly: this process's rank, the world size and the
size of the ``space`` axis.  The ranks are laid out as JAX lays out its
devices (``np.array(devices).reshape(data, space)``): rank
``d * space + s`` holds data index ``d`` and space index ``s``.

The row rule of JAX's ``shard_batch`` and of its learner's in-graph gather:
a batch whose size divides over the ``data`` axis is sharded by rows, data
index ``d`` holding ``rows[d::data]``; any other batch is replicated, every
rank running it whole.  A :class:`Sharding` says which of the two a step is.
While a step runs inside ``with sharding.active():``, :func:`current`
returns that sharding, and the reductions over the batch (BN moments, the
Dice sums, the measures' counts and the gradients;
``parallel/collectives.py``) sum over the ranks if it is sharded over more
than one.  Outside, and in a replicated step, they stay local.

The ``space`` axis (``batch_sharding(mesh, spatial=True)``, JAX's
``P("data", None, "space")``) splits the H axis of ``(B, D, H, W, C)``
volumes by :func:`block`, balanced by the global H: at a tensor of global
height ``H``, space index ``s`` of ``S`` owns rows
``[floor(s * H / S), floor((s + 1) * H / S))``, and a block is empty where
``H < S``.  Each op of a spatial step fetches the rows its own output rows
need from their owners (``parallel/spatial.py``,
``collectives.exchange_rows``), where XLA's SPMD partitioner inserts halo
exchanges.  The global H of the tensors a step makes is kept in the
sharding's record (:meth:`Sharding.record`), so that every op works out its
output's global H and each rank's block without a collective.
"""

from __future__ import annotations

import contextlib
import contextvars
import weakref
from dataclasses import dataclass, field
from typing import Iterator, Optional, Tuple

from stroke_prediction_tpu_torch.parallel.distributed import (
    process_count, process_index)


@dataclass(frozen=True)
class Mesh:
    """``world`` processes on a ``(data, space)`` mesh, ``space`` ranks a
    data index; this one is ``rank``."""

    rank: int
    world: int
    space: int = 1

    def __post_init__(self):
        if self.space < 1 or self.world % self.space:
            raise ValueError(f"a space axis of {self.space} does not divide "
                             f"{self.world} ranks")
        if not 0 <= self.rank < self.world:
            raise ValueError(f"rank {self.rank} is outside 0..{self.world - 1}")

    @property
    def data(self) -> int:
        return self.world // self.space

    @property
    def data_index(self) -> int:
        return self.rank // self.space

    @property
    def space_index(self) -> int:
        return self.rank % self.space

    def space_rank(self, s: int) -> int:
        """The rank of space index ``s`` at this rank's data index."""
        return self.data_index * self.space + s


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
    """The ``(data, space)`` mesh over the process group, which must hold
    ``data * space`` processes."""
    world = process_count()
    if data < 1 or space < 1 or data * space != world:
        raise ValueError(f"a {data} x {space} mesh needs a process group of "
                         f"{data * space} processes, this one has {world}")
    return Mesh(process_index(), world, space)


def block(height: int, index: int, n: int) -> Tuple[int, int]:
    """Rows ``[lo, hi)`` of a global ``height`` that space index ``index``
    of ``n`` owns."""
    return index * height // n, (index + 1) * height // n


@dataclass(frozen=True)
class Sharding:
    """How one step's batch lies on ``mesh`` (``None``: one process):
    rows over the ``data`` axis where ``sharded``, and H over the ``space``
    axis where ``spatial``."""

    mesh: Optional[Mesh]
    sharded: bool
    spatial: bool = False
    # id(tensor) -> (weak reference, global H) of the tensors of a spatial
    # step (record / recorded)
    heights: dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def reduces(self) -> bool:
        """Whether the step's batch reductions sum over the ranks."""
        return self.sharded and self.mesh is not None and self.mesh.world > 1

    def take(self, rows):
        """This rank's rows of a global batch (a sequence, array or tensor
        indexed along its first axis)."""
        if not self.reduces:
            return rows
        return rows[self.mesh.data_index::self.mesh.data]

    def global_size(self, n_local: int) -> int:
        """The global batch of a step with ``n_local`` rows here."""
        return n_local * self.mesh.data if self.reduces else n_local

    def record(self, x, height: int):
        """Note ``height`` as the global H of ``x`` (a tensor of this
        spatial step) and return ``x``."""
        if len(self.heights) > 256:
            for key in [k for k, (ref, _) in self.heights.items()
                        if ref() is None]:
                del self.heights[key]
        self.heights[id(x)] = (weakref.ref(x), height)
        return x

    def recorded(self, x) -> Optional[int]:
        """The global H noted for ``x``, or ``None``."""
        entry = self.heights.get(id(x))
        if entry is None or entry[0]() is not x:
            return None
        return entry[1]

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
    """Rows over the ``data`` axis and, with ``spatial``, H over the
    ``space`` axis (a mesh without one, or no mesh, shards rows only, as
    JAX's ``batch_sharding`` does).  On a mesh with a ``space`` axis a
    step shards H: rows alone would leave the ranks of a data index holding
    the same rows, which the reductions over all ranks would count again."""
    spatial = spatial and mesh is not None and mesh.space > 1
    if mesh is not None and mesh.space > 1 and not spatial:
        raise ValueError(f"a mesh with a space axis of {mesh.space} shards "
                         f"H: use spatial=True")
    return Sharding(mesh, True, spatial)


def replicate(mesh: Optional[Mesh]) -> Sharding:
    return Sharding(mesh, False)


def row_sharding(mesh: Optional[Mesh], n_rows: int) -> Sharding:
    """The row rule: sharded when ``n_rows`` divides over the ``data``
    axis, else replicated."""
    if mesh is not None and n_rows % mesh.data == 0:
        return batch_sharding(mesh)
    return replicate(mesh)


def shard_batch(mesh: Optional[Mesh], tree: dict,
                spatial: bool = False) -> dict:
    """This rank's part of a global batch ``{key: array or None}``: each
    array with a first axis that divides over the ``data`` axis is sharded
    by rows, any other is kept whole; with ``spatial``, each such array of
    five or more axes ``(B, D, H, W, ...)`` is cut to this rank's block of
    its own H as well (JAX's ``shard_batch``)."""
    cut = spatial and mesh is not None and mesh.space > 1

    def local(v):
        if v is None or v.ndim == 0:
            return v
        if mesh is None or len(v) % mesh.data:
            return v
        v = v[mesh.data_index::mesh.data]
        if cut and v.ndim >= 5:
            lo, hi = block(v.shape[2], mesh.space_index, mesh.space)
            v = v[:, :, lo:hi]
        return v

    return {k: local(v) for k, v in tree.items()}
