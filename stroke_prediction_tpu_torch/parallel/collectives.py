"""The reductions and row exchanges that make an N-rank sharded step equal
the one-process step on the global batch.

Under ``jit`` on a sharded mesh XLA turns the batch reductions of the
JAX step into cross-replica sums, and its SPMD partitioner turns a conv of
an H-sharded volume into halo exchanges, by itself.  Here they are
explicit, and each is the identity unless the running step is sharded over
more than one rank (``parallel.mesh.current().reduces``):

* :func:`reduce_sums` — ``all_reduce(SUM)`` inside the autograd graph: its
  backward is ``all_reduce(SUM)`` of the incoming gradient.  BN's moment
  sums and the Dice loss's sums go through it.
* :func:`global_mean` — a mean over the global batch through
  :func:`reduce_sums` (the CAE losses' hinges and latent L1 terms); under
  H sharding the sum and the element count in one call.
* :func:`reduce_max` — ``all_reduce(MAX)``, no gradient (the measures'
  surface distance maximum).
* :func:`average_gradients` — every parameter's gradient in one flat
  ``all_reduce(SUM)``, divided by the world.
* :func:`exchange_rows` — under a spatial sharding, the H rows that each
  space rank needs, fetched from their owners; its backward sends each
  fetched row's gradient back to its owner and adds it there (the
  adjoint).

Why the gradient is exact: every rank computes the same global loss, so
each rank's backward reaches the sum collectives with the same gradient,
and their backward sums it over the ranks: every gradient on rank ``r``'s
graph is ``world`` times the true gradient along ``r``'s path.  The row
exchanges' adjoints carry those gradients to the rows' owners unchanged.
Summing the parameter gradients over the ranks adds the paths, and dividing
by the world removes the factor.

The reductions use ``all_reduce`` alone: gloo, which runs several ranks on
one card (NCCL refuses a shared device), takes CUDA tensors in
``all_reduce`` and ``broadcast`` alone.  The row exchanges are point to
point: over NCCL ``batch_isend_irecv`` of the card's tensors; over gloo
``isend`` / ``irecv`` of host copies (a CUDA tensor's rows are staged
through the host); any other backend raises.  Every rank must reach the
collectives in the same order, which the same graph on every rank gives.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterable, List, Sequence, Tuple

import torch
import torch.distributed as dist

from stroke_prediction_tpu_torch.parallel.mesh import Mesh, block, current

# exchanges of this process since the last reset_exchange_counts():
# exchange_rows calls, their adjoints, the bytes received in both, and the
# bytes an all-gather of the same tensors (and its reduce-scatter adjoint)
# would have received
EXCHANGE_COUNTS = {"exchanges": 0, "adjoints": 0, "bytes": 0,
                   "all_gather_bytes": 0}


def reset_exchange_counts() -> None:
    for k in EXCHANGE_COUNTS:
        EXCHANGE_COUNTS[k] = 0


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.contiguous().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, op=dist.ReduceOp.SUM)
        return g


def reduce_sums(*xs: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Each of ``xs`` (tensors of one shape) summed over the ranks of the
    running sharded step, in one collective, with the summed gradient in
    backward; ``xs`` themselves otherwise."""
    if not current().reduces:
        return xs
    return tuple(_AllReduceSum.apply(torch.stack(xs)).unbind())


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the running sharded step's global batch: this
    rank's sum, summed over the ranks, over its element count times the
    world (the row rule gives every rank equal rows), with the summed
    gradient in backward; ``torch.mean(x)`` otherwise.

    Under a spatial sharding the H blocks differ in size: this rank's sum
    and element count go through one ``reduce_sums`` together, in float64
    (as the step's other sums, ``parallel.spatial.sum_dtype``), and the
    mean is their ratio.  A tensor of fewer than five axes holds no H and
    is the same on every space rank of a data index: space index 0 alone
    counts it."""
    sharding = current()
    if not sharding.reduces:
        return torch.mean(x)
    if not sharding.spatial:
        wide = torch.promote_types(x.dtype, torch.float32)
        total, = reduce_sums(torch.sum(x, dtype=wide))
        return (total / (x.numel() * sharding.mesh.world)).to(x.dtype)
    mine = float(x.ndim >= 5 or sharding.mesh.space_index == 0)
    total, count = reduce_sums(
        torch.sum(x, dtype=torch.float64) * mine,
        torch.tensor(x.numel() * mine, dtype=torch.float64, device=x.device))
    return (total / count).to(x.dtype)


def reduce_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise maximum over the ranks of the running sharded step
    (no gradient); ``x`` itself otherwise."""
    if not current().reduces:
        return x
    y = x.detach().contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX)
    return y


def average_gradients(params: Iterable[torch.Tensor]) -> None:
    """Replace each ``.grad`` by its mean over the ranks of the running
    sharded step, in one collective; nothing otherwise."""
    sharding = current()
    if not sharding.reduces:
        return
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    flat /= sharding.mesh.world
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


# ---------------------------------------------------------------- H axis


def _spatial_mesh() -> Mesh:
    sharding = current()
    if not sharding.spatial:
        raise ValueError("no spatial (H-sharded) step is running")
    return sharding.mesh


def exchange_backend(x: torch.Tensor) -> str:
    """The backend that moves rows of ``x``: ``nccl`` (CUDA tensors) or
    ``gloo``; any other raises."""
    backend = dist.get_backend()
    if backend == "nccl" and x.device.type != "cuda":
        raise ValueError(f"NCCL moves rows of CUDA tensors, not of "
                         f"{x.device}")
    if backend not in ("nccl", "gloo"):
        raise NotImplementedError(f"row exchanges over {backend!r} are not "
                                  f"ported: use nccl or gloo")
    return backend


@dataclass(frozen=True)
class _Plan:
    """One rank's part of an exchange of the rows of a tensor of global
    height ``height``: it needs global rows ``[lo, hi)`` and owns
    ``[offset, offset + n_own)``; ``own`` its own rows among them; ``recv``
    and ``send`` ``(peer rank, a, b)``: global rows ``[a, b)`` it receives
    from or sends to each peer."""

    height: int
    lo: int
    hi: int
    offset: int
    n_own: int
    own: Tuple[int, int]
    recv: Tuple[Tuple[int, int, int], ...]
    send: Tuple[Tuple[int, int, int], ...]


def _make_plan(mesh: Mesh, height: int,
               needs: Sequence[Tuple[int, int]]) -> _Plan:
    n = mesh.space
    if len(needs) != n:
        raise ValueError(f"{len(needs)} needs for {n} space ranks")
    for lo, hi in needs:
        if not 0 <= lo <= hi <= height:
            raise ValueError(f"rows [{lo}, {hi}) are outside [0, {height})")
    blocks = [block(height, s, n) for s in range(n)]
    me = mesh.space_index
    (lo, hi), (o_lo, o_hi) = needs[me], blocks[me]
    own, recv, send = (0, 0), [], []
    for s, (b_lo, b_hi) in enumerate(blocks):
        a, b = max(lo, b_lo), min(hi, b_hi)
        if s == me:
            own = (a, b) if a < b else (0, 0)
            continue
        if a < b:
            recv.append((mesh.space_rank(s), a, b))
        a, b = max(needs[s][0], o_lo), min(needs[s][1], o_hi)
        if a < b:
            send.append((mesh.space_rank(s), a, b))
    return _Plan(height, lo, hi, o_lo, o_hi - o_lo, own, tuple(recv),
                 tuple(send))


def _rows(x: torch.Tensor, a: int, b: int) -> torch.Tensor:
    return x.narrow(2, a, b - a)


def _transport(outgoing: List[Tuple[int, torch.Tensor]],
               incoming: List[Tuple[int, torch.Size]],
               like: torch.Tensor) -> List[torch.Tensor]:
    """Send each ``(peer, tensor)`` of ``outgoing`` and receive a tensor of
    each ``(peer, shape)`` of ``incoming`` (``like``'s type and device),
    as raw bytes: over NCCL between the cards' tensors, over gloo through
    host copies."""
    backend = exchange_backend(like)
    host = backend == "gloo"
    dev = torch.device("cpu") if host else like.device
    size = like.element_size()
    sends = [(peer, t.contiguous().view(-1).view(torch.uint8).to(dev))
             for peer, t in outgoing]
    recvs = [(peer, torch.empty(shape.numel() * size, dtype=torch.uint8,
                                device=dev)) for peer, shape in incoming]
    if backend == "nccl":
        ops = ([dist.P2POp(dist.isend, t, peer) for peer, t in sends]
               + [dist.P2POp(dist.irecv, t, peer) for peer, t in recvs])
        works = dist.batch_isend_irecv(ops) if ops else []
    else:
        works = ([dist.isend(t, peer) for peer, t in sends]
                 + [dist.irecv(t, peer) for peer, t in recvs])
    for w in works:
        w.wait()
    return [buf.to(like.device).view(like.dtype).view(shape)
            for (_, buf), (_, shape) in zip(recvs, incoming)]


def _shape(x: torch.Tensor, n_rows: int) -> torch.Size:
    return torch.Size(x.shape[:2] + (n_rows,) + x.shape[3:])


def _count(kind: str, x: torch.Tensor, plan: _Plan, received: int) -> None:
    row = math.prod(x.shape[:2] + x.shape[3:]) * x.element_size()
    EXCHANGE_COUNTS[kind] += 1
    EXCHANGE_COUNTS["bytes"] += received * row
    EXCHANGE_COUNTS["all_gather_bytes"] += (plan.height - plan.n_own) * row


def _gather(x: torch.Tensor, plan: _Plan) -> torch.Tensor:
    """Global rows ``[plan.lo, plan.hi)`` of the tensor whose block
    ``x`` is."""
    got = _transport([(p, _rows(x, a - plan.offset, b - plan.offset))
                      for p, a, b in plan.send],
                     [(p, _shape(x, b - a)) for p, a, b in plan.recv], x)
    pieces = [(a, t) for (_, a, _), t in zip(plan.recv, got)]
    if plan.own[1] > plan.own[0]:
        pieces.append((plan.own[0], _rows(x, plan.own[0] - plan.offset,
                                          plan.own[1] - plan.offset)))
    _count("exchanges", x, plan, sum(b - a for _, a, b in plan.recv))
    if not pieces:
        return x.new_empty(_shape(x, 0))
    return torch.cat([t for _, t in sorted(pieces, key=lambda p: p[0])],
                     dim=2)


def _scatter_add(g: torch.Tensor, plan: _Plan,
                 x_shape: torch.Size) -> torch.Tensor:
    """The adjoint of :func:`_gather`: the gradient of this rank's block
    from ``g`` (the gradient of its rows ``[plan.lo, plan.hi)``), each
    fetched row's gradient sent back to its owner and added there."""
    g = g.contiguous()
    got = _transport([(p, _rows(g, a - plan.lo, b - plan.lo))
                      for p, a, b in plan.recv],
                     [(p, _shape(g, b - a)) for p, a, b in plan.send], g)
    dx = g.new_zeros(x_shape)
    if plan.own[1] > plan.own[0]:
        _rows(dx, plan.own[0] - plan.offset, plan.own[1] - plan.offset).add_(
            _rows(g, plan.own[0] - plan.lo, plan.own[1] - plan.lo))
    for (_, a, b), t in zip(plan.send, got):
        _rows(dx, a - plan.offset, b - plan.offset).add_(t)
    _count("adjoints", dx, plan, sum(b - a for _, a, b in plan.send))
    return dx


class _ExchangeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan, ctx.x_shape = plan, x.shape
        return _gather(x, plan)

    @staticmethod
    def backward(ctx, g):
        return _scatter_add(g, ctx.plan, ctx.x_shape), None


def exchange_rows(x: torch.Tensor, height: int,
                  needs: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Global H rows ``needs[s]`` (``[lo, hi)``) of a tensor of global
    height ``height`` for this rank, space index ``s``, of the running
    spatial step: ``x`` is this rank's block of it (``(B, D, H, W, C)``,
    the rows :func:`parallel.mesh.block` gives), and ``needs`` holds every
    space rank's need, so that each rank knows what to send.  The rows come
    from their owners, which may be several, not neighbours, or hold an
    empty block; only the rows needed move.  In backward the gradient of
    each received row goes back to its owner and is added to that row's
    gradient there."""
    mesh = _spatial_mesh()
    plan = _make_plan(mesh, height, needs)
    if x.shape[2] != plan.n_own:
        raise ValueError(f"x holds {x.shape[2]} rows of H, the block rule "
                         f"gives space index {mesh.space_index} "
                         f"{plan.n_own} of {height}")
    exchange_backend(x)
    return _ExchangeRows.apply(x, plan)

