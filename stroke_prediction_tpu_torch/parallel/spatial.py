"""The H axis of a spatial step, op by op (the ``space`` mesh axis).

Under a spatial sharding (``parallel.mesh.batch_sharding(mesh,
spatial=True)``) every ``(B, D, H, W, C)`` tensor of the U-Nets and the
CAE holds this rank's block of its global H, by ``parallel.mesh.block``.
An op that reads rows beyond an output row (a 3^3 conv of stride 1 or 2,
padded along H or not, a transposed conv, a 2x pool, the x2 upsample, a
crop) computes its own output rows (owner computes): it works out the
global H of its output from its input's, asks for the input rows its block
of the output needs (:func:`rows`, through ``collectives.exchange_rows``),
runs as in one process on them and notes its output's global H
(:func:`record`).  Padding along H is global (:func:`padded_rows`): zero
rows are added only where the rows fetched cross the volume's edge, so
only the first and last space ranks pad.  Per-voxel ops (BN's affine, the
1^3 convs, the activations, the sigmoid) run on the block as it is; the
reductions over the batch (BN's moments, the Dice sums, the global means)
sum the owned rows over all ranks (``parallel/collectives.py``), over
:func:`global_count` positions.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from stroke_prediction_tpu_torch.parallel.collectives import (
    exchange_backend, exchange_rows)
from stroke_prediction_tpu_torch.parallel.mesh import block, current


def active() -> bool:
    """Whether the running step shards H."""
    return current().spatial


def height(x: torch.Tensor) -> int:
    """The global H of ``x`` (``(B, D, H, W, C)``, this rank's block) in the
    running spatial step: the sharding's record, or, for a tensor it does
    not know (the step's input), the ranks' row counts summed over this
    data index in one ``all_reduce``, which must follow the block rule."""
    sharding = current()
    if not sharding.spatial:
        raise ValueError("no spatial (H-sharded) step is running")
    h = sharding.recorded(x)
    if h is not None:
        return h
    mesh = sharding.mesh
    device = x.device if exchange_backend(x) == "nccl" else "cpu"
    counts = torch.zeros(mesh.world, dtype=torch.int64, device=device)
    counts[mesh.rank] = x.shape[2]
    dist.all_reduce(counts, op=dist.ReduceOp.SUM)
    rows = counts.tolist()[mesh.space_rank(0):mesh.space_rank(mesh.space)]
    h = sum(rows)
    want = [b - a for a, b in (block(h, s, mesh.space)
                               for s in range(mesh.space))]
    if rows != want:
        raise ValueError(f"the space ranks hold {rows} rows of H, the block "
                         f"rule gives {want} of {h}")
    record(x, h)
    return h


def global_count(x: torch.Tensor) -> int:
    """The count of ``x``'s positions (every axis but the channels) in the
    running step's global batch: this rank's count times the data ranks
    of a sharded step (the row rule gives every rank equal rows); under a
    spatial sharding ``B · D · H · W`` with the global B and H (the H
    blocks need not be equal)."""
    sharding = current()
    if not sharding.spatial:
        return sharding.global_size(x.numel() // x.shape[-1])
    b, d, _, w = x.shape[:4]
    return sharding.global_size(b) * d * height(x) * w


def sum_dtype(x: torch.Tensor) -> torch.dtype:
    """The type that the batch sums of ``x`` (BN's moments, the Dice sums)
    accumulate in: float64 under a spatial step, ``x``'s own otherwise.

    A float32 step's gradients move with the last bits of those sums: a
    LeakyReLU output near zero crosses the kink at a few voxels, and each
    such voxel moves every gradient upstream of it by up to 1e-3 of its
    largest.  Summed in float32, each layout of the ranks (mesh shape, rows
    to data indices) rounds them its own way; accumulated in float64 and
    rounded once, every layout gets the same sums, and so the same forward
    and the same gradients to their summation order."""
    return torch.float64 if active() else x.dtype


def record(y: torch.Tensor, h: int) -> torch.Tensor:
    """``y``, its global H noted as ``h``."""
    return current().record(y, h)


def like(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``y``, noted with ``x``'s global H (a concatenation of blocks along
    the channels) under a spatial step; ``y`` otherwise."""
    return record(y, height(x)) if active() else y


def spatial_shape(x: torch.Tensor) -> Tuple[int, int, int]:
    """``x``'s (D, H, W), H global under a spatial step."""
    d, h, w = x.shape[-4:-1]
    return (d, height(x), w) if active() else (d, h, w)


def rows(x: torch.Tensor, h_in: int, h_out: int,
         need: Callable[[int, int], Tuple[int, int]]) -> torch.Tensor:
    """The input rows that this rank's block of an output of global height
    ``h_out`` reads: ``need(lo, hi)`` gives the input rows ``[a, b)`` that
    output rows ``[lo, hi)`` read, for each space rank's block (an empty
    block needs none).  ``x`` is this rank's block of an input of global
    height ``h_in``."""
    mesh = current().mesh
    needs = []
    for s in range(mesh.space):
        lo, hi = block(h_out, s, mesh.space)
        needs.append(need(lo, hi) if hi > lo else (0, 0))
    return exchange_rows(x, h_in, needs)


def own_block(h: int) -> Tuple[int, int]:
    """This rank's rows ``[lo, hi)`` of a tensor of global height ``h``."""
    mesh = current().mesh
    return block(h, mesh.space_index, mesh.space)


def padded_rows(x: torch.Tensor, h_in: int, h_out: int,
                need: Callable[[int, int], Tuple[int, int]]) -> torch.Tensor:
    """:func:`rows` of an input zero-padded along H: ``need(lo, hi)`` gives
    the rows ``[a, b)`` of the input padded at both ends that output rows
    ``[lo, hi)`` read, in the input's own numbering (``a`` may be negative
    and ``b`` past ``h_in``).  The rows inside ``[0, h_in)`` come from
    their owners; the zero rows are added here, where the range crosses
    the volume's edge, so that no zero row falls inside the volume."""
    def clipped(lo, hi):
        a, b = need(lo, hi)
        return max(a, 0), min(b, h_in)

    got = rows(x, h_in, h_out, clipped)
    lo, hi = own_block(h_out)
    if hi <= lo:
        return got
    a, b = need(lo, hi)
    top, bottom = max(-a, 0), max(b - h_in, 0)
    if top or bottom:
        got = F.pad(got, (0, 0, 0, 0, top, bottom))
    return got


def conv_rows(x: torch.Tensor, h_in: int, stride: int = 1,
              pad: int = 0) -> Tuple[torch.Tensor, int]:
    """(input rows, global H of the output) of a 3^3 conv of ``stride``
    with ``pad`` zero rows at each end of H, ``x`` this rank's block of an
    input of global height ``h_in``: output rows ``[lo, hi)`` read the
    padded rows ``[stride * lo - pad, stride * (hi - 1) - pad + 3)`` (a
    valid conv ``[lo, hi + 2)``, stride 2 padding 1 ``[2 lo - 1, 2 hi)``,
    stride 2 valid ``[2 lo, 2 hi + 1)``, stride 1 padding 2
    ``[lo - 2, hi)``), with the padding already in place: the caller runs
    the conv with no H padding on them, and stride 2 keeps the global
    parity.  Every space rank must own an output row: an empty block would
    leave a rank's kernel and bias out of its graph."""
    h_out = (h_in + 2 * pad - 3) // stride + 1
    n = current().mesh.space
    if h_out < n:
        raise ValueError(f"a conv's output of {h_out} rows of H does not "
                         f"cover {n} space ranks")
    return padded_rows(
        x, h_in, h_out,
        lambda lo, hi: (stride * lo - pad, stride * (hi - 1) - pad + 3)), h_out


def transposed_rows(x: torch.Tensor, h_in: int, k: int, stride: int
                    ) -> Tuple[torch.Tensor, int, int]:
    """(input rows, global H of the output, offset) of a transposed conv of
    kernel ``k`` and ``stride`` (padding 0): output row ``o`` sums input
    rows ``i`` with ``stride * i <= o <= stride * i + k - 1``.  The
    transposed conv of the rows ``[a, b)`` fetched holds output rows from
    ``stride * a`` on, so this rank's block of the output starts at
    ``offset`` in it."""
    h_out = (h_in - 1) * stride + k

    def need(lo, hi):
        return max(0, -((k - 1 - lo) // stride)), min(h_in,
                                                        (hi - 1) // stride + 1)

    lo, hi = own_block(h_out)
    offset = lo - stride * need(lo, hi)[0] if hi > lo else 0
    return rows(x, h_in, h_out, need), h_out, offset


def crop_rows(x: torch.Tensor, h_in: int, h_out: int,
              start: int) -> torch.Tensor:
    """This rank's block of the rows ``[start, start + h_out)`` of a tensor
    of global height ``h_in`` (a crop along H: output rows ``[lo, hi)``
    read ``[lo + start, hi + start)``), noted with ``h_out``."""
    return record(rows(x, h_in, h_out,
                       lambda lo, hi: (lo + start, hi + start)), h_out)


def rows_spanning(x: torch.Tensor, h_in: int, a: int,
                  b: int) -> torch.Tensor:
    """Rows ``[a, b)`` of a tensor of global height ``h_in`` for this rank,
    where each rank's need is its own (known only from its data, as the
    points a warp samples): the space ranks' needs go round in one
    ``all_reduce``, then the rows move by ``exchange_rows``."""
    mesh = current().mesh
    device = x.device if exchange_backend(x) == "nccl" else "cpu"
    spans = torch.zeros(mesh.world, 2, dtype=torch.int64, device=device)
    spans[mesh.rank] = torch.tensor([a, b])
    dist.all_reduce(spans, op=dist.ReduceOp.SUM)
    needs = spans[mesh.space_rank(0):mesh.space_rank(mesh.space)].tolist()
    return exchange_rows(x, h_in, [tuple(n) for n in needs])


def whole(x: torch.Tensor) -> torch.Tensor:
    """All the global rows of ``x`` on every space rank (an all-gather by
    ``exchange_rows``): for an op that needs the whole volume, as the EDT
    of HD / ASSD."""
    h = height(x)
    return exchange_rows(x, h, [(0, h)] * current().mesh.space)
