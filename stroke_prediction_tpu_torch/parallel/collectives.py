"""The reductions that make an N-rank sharded step equal the one-process
step on the global batch.

Under ``jit`` on a sharded mesh XLA turns the batch reductions of the
JAX step into cross-replica sums by itself.  Here they are explicit, and
each is the identity unless the running step is sharded over more than
one rank (``parallel.mesh.current().reduces``):

* :func:`reduce_sums` — ``all_reduce(SUM)`` inside the autograd graph: its
  backward is ``all_reduce(SUM)`` of the incoming gradient.  BN's moment
  sums and the Dice loss's sums go through it.
* :func:`global_mean` — a mean over the global batch through
  :func:`reduce_sums` (the CAE losses' hinges and latent L1 terms).
* :func:`reduce_max` — ``all_reduce(MAX)``, no gradient (the measures'
  surface distance maximum).
* :func:`average_gradients` — every parameter's gradient in one flat
  ``all_reduce(SUM)``, divided by the world.

Why the gradient is exact: every rank computes the same global loss, so
each rank's backward reaches the sum collectives with the same gradient,
and their backward sums it over the ranks: every gradient on rank ``r``'s
graph is ``world`` times the true gradient along ``r``'s path.  Summing
the parameter gradients over the ranks adds the paths, and dividing by
the world removes the factor.

Only ``all_reduce`` is used: gloo, which runs two ranks on one card, takes
CUDA tensors in ``all_reduce`` and ``broadcast`` alone.  Every rank must
reach the collectives in the same order, which the same graph on every
rank gives.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import torch
import torch.distributed as dist

from stroke_prediction_tpu_torch.parallel.mesh import current


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
    gradient in backward; ``torch.mean(x)`` otherwise."""
    sharding = current()
    if not sharding.reduces:
        return torch.mean(x)
    wide = torch.promote_types(x.dtype, torch.float32)
    total, = reduce_sums(torch.sum(x, dtype=wide))
    return (total / (x.numel() * sharding.mesh.world)).to(x.dtype)


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
