"""Losses and binary segmentation measures (port of eval/metrics.py).

HD/ASSD come from surface distances computed on the device with the
separable EDT (ops/edt.py, kernel K5); they are inf when either mask is
empty.

In a sharded data-parallel step (``parallel.mesh.current()``) the Dice
loss, :func:`monotonicity_hinge` and :func:`binary_measures` are those of
the global batch: their sums (the Dice's three, the hinge's, the measures'
counts and distance sums, the distance maximum) are reduced over the ranks
before any ratio is formed.  Under H sharding each rank sums its own rows
of H (the labels cut by the same block rule as the outputs).  HD and ASSD
need the whole volume (a surface voxel's neighbours, the EDT's pass along
H): every rank fetches the thresholded masks' whole H as uint8 (the one
all-gather of a spatial step, counted by the exchange counters), runs the
surface and the EDT on the global volume, and counts only the surface
voxels of its own rows, so that the ranks' sums add disjoint parts and the
maximum is the global one.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from stroke_prediction_tpu_torch.core.dto import BinaryMeasures
from stroke_prediction_tpu_torch.ops.edt import edt_to_sites
from stroke_prediction_tpu_torch.parallel import spatial
from stroke_prediction_tpu_torch.parallel.collectives import (
    global_mean, reduce_max, reduce_sums)


def batch_dice_loss(outputs: torch.Tensor, targets: torch.Tensor,
                    label_weights: Sequence[float] = (1.0,),
                    epsilon: float = 1e-7) -> torch.Tensor:
    """Soft Dice loss over the flattened batch, per (last-axis) label
    channel, weighted.  Under H sharding its three sums accumulate in
    float64 (``parallel.spatial.sum_dtype``)."""
    if targets.shape[-1] != len(label_weights):
        raise ValueError("Ground truth number of labels does not match "
                         "label weight vector")
    wide = torch.promote_types(outputs.dtype, torch.float32)
    o = outputs.to(wide)
    t = targets.to(wide)
    axes = tuple(range(o.ndim - 1))
    # global sums first; epsilon is added once, to the global sums
    acc = spatial.sum_dtype(o)
    inter, oo, tt = (s.to(wide) for s in reduce_sums(
        torch.sum(o * t, dim=axes, dtype=acc),
        torch.sum(o * o, dim=axes, dtype=acc),
        torch.sum(t * t, dim=axes, dtype=acc)))
    dice = (2.0 * inter + epsilon) / (oo + tt + epsilon)
    # the weights as Python numbers: no host copy (a captured step)
    return 1.0 - torch.sum(torch.stack([dice[i] * w for i, w in
                                        enumerate(label_weights)]))


def monotonicity_hinge(diff: torch.Tensor) -> torch.Tensor:
    """``mean(|d| - d)``: penalizes the negative entries of ``d``, the CAE
    loss's core <= interpolation <= penumbra ordering term; in a sharded
    step the mean over the global batch."""
    return global_mean(torch.abs(diff) - diff)


def _surface6(mask: torch.Tensor) -> torch.Tensor:
    """Surface voxels of (N, D, H, W) masks under 6-connectivity erosion
    with a zero border (scipy ``binary_erosion`` default).  Made from the
    padded copy, so the result is contiguous whatever ``mask``'s layout
    (the tester's labels arrive transposed) and the EDT's kernels read it
    in place."""
    p = F.pad(mask, (1, 1, 1, 1, 1, 1), value=False)
    c = p[:, 1:-1, 1:-1, 1:-1]
    eroded = (c
              & p[:, :-2, 1:-1, 1:-1] & p[:, 2:, 1:-1, 1:-1]
              & p[:, 1:-1, :-2, 1:-1] & p[:, 1:-1, 2:, 1:-1]
              & p[:, 1:-1, 1:-1, :-2] & p[:, 1:-1, 1:-1, 2:])
    return c & ~eroded


def _surface_distance_stats(a: torch.Tensor, b: torch.Tensor,
                            rows: Tuple[int, Optional[int]] = (0, None)):
    """(max, sum, count) per volume, each (N,), of the distances from
    surface(a) to surface(b) at the surface voxels of H rows ``rows``
    (``[lo, hi)``, all by default); a, b: (N, D, H, W) bool.  The EDT runs
    once for all N volumes (two K5 kernel launches on the card)."""
    lo, hi = rows
    sa = _surface6(a)[:, :, lo:hi]
    dist_to_b = edt_to_sites(_surface6(b), axes=(1, 2, 3))[:, :, lo:hi]
    d = torch.where(sa, dist_to_b, torch.zeros_like(dist_to_b))
    axes = (1, 2, 3)
    return torch.amax(d, axes), torch.sum(d, axes), torch.sum(sa, axes)


def _to_b3(m: torch.Tensor) -> torch.Tensor:
    """(D, H, W), (D, H, W, C) or (B, D, H, W, C) -> (N, D, H, W)."""
    if m.ndim == 3:
        return m[None]
    if m.ndim == 4:
        return torch.movedim(m, -1, 0)
    if m.ndim == 5:
        return torch.movedim(m, -1, 1).reshape((-1,) + tuple(m.shape[1:4]))
    raise ValueError(f"unsupported mask rank {m.ndim}")


def _measure_sums(r: torch.Tensor, t: torch.Tensor, n: int,
                  with_distances: bool) -> dict:
    """The sums behind the measures of ``n`` groups of the thresholded
    masks' leading axis (one group: the whole arrays), each (n,): ``tp``,
    ``fp``, ``fn``, ``tn``; with distances the surface distances' maximum
    ``dmax``, sum ``dsum`` and count ``dcount`` over both directions.
    Sums of disjoint parts of a group add, maxima take the maximum."""
    rf = r.reshape(n, -1).float()
    tf = t.reshape(n, -1).float()
    sums = {"tp": torch.sum(rf * tf, 1), "fp": torch.sum(rf * (1 - tf), 1),
            "fn": torch.sum((1 - rf) * tf, 1),
            "tn": torch.sum((1 - rf) * (1 - tf), 1)}
    if with_distances:
        rows: Tuple[int, Optional[int]] = (0, None)
        if spatial.active():
            rows = spatial.own_block(spatial.height(r))
            r, t = (spatial.whole(spatial.like(m.to(torch.uint8), m)).bool()
                    for m in (r, t))
        r3, t3 = _to_b3(r), _to_b3(t)
        m1, s1, n1 = (v.reshape(n, -1) for v in
                      _surface_distance_stats(r3, t3, rows))
        m2, s2, n2 = (v.reshape(n, -1) for v in
                      _surface_distance_stats(t3, r3, rows))
        sums.update(dmax=torch.maximum(m1.amax(1), m2.amax(1)),
                    dsum=s1.sum(1) + s2.sum(1),
                    dcount=(n1.sum(1) + n2.sum(1)).float())
    return sums


def _reduced(sums: dict) -> dict:
    """``sums`` over the ranks of a sharded step (itself otherwise): the
    counts and distance sums added in one collective, the maximum in
    another."""
    keys = [k for k in sums if k != "dmax"]
    out = dict(zip(keys, reduce_sums(*(sums[k] for k in keys))))
    if "dmax" in sums:
        out["dmax"] = reduce_max(sums["dmax"])
    return out


def _measure_ratios(sums: dict) -> BinaryMeasures:
    """The measures from :func:`_measure_sums`' sums; HD and ASSD inf
    without distances or where either mask is empty."""
    tp, fp, fn, tn = sums["tp"], sums["fp"], sums["fn"], sums["tn"]
    zero = torch.zeros_like(tp)

    def ratio(num, den):
        return torch.where(den > 0, num / torch.clamp(den, min=1), zero)

    inf = torch.full_like(tp, float("inf"))
    hd = assd = inf
    if "dmax" in sums:
        nonempty = (tp + fp > 0) & (tp + fn > 0)
        hd = torch.where(nonempty, sums["dmax"], inf)
        assd = torch.where(nonempty, sums["dsum"] / torch.clamp(
            sums["dcount"], min=1), inf)
    return BinaryMeasures(dc=ratio(2 * tp, 2 * tp + fp + fn), hd=hd,
                          assd=assd, precision=ratio(tp, tp + fp),
                          sensitivity=ratio(tp, tp + fn),
                          specificity=ratio(tn, tn + fp))


def _measures(r: torch.Tensor, t: torch.Tensor, n: int,
              with_distances: bool) -> BinaryMeasures:
    """The measures of ``n`` groups of the thresholded masks' leading axis
    (one group: the whole arrays), each field (n,)."""
    return _measure_ratios(_measure_sums(r, t, n, with_distances))


def binary_measures(result: torch.Tensor, target: torch.Tensor,
                    binary_threshold: float = 0.5,
                    with_distances: bool = True) -> BinaryMeasures:
    """Dice, HD, ASSD, precision, sensitivity, specificity for one
    structure, as 0-d float32 tensors on the inputs' device; in a sharded
    step those of the global batch."""
    sums = _measure_sums(result > binary_threshold,
                         target > binary_threshold, 1, with_distances)
    m = _measure_ratios(_reduced(sums))
    return BinaryMeasures(*(v[0] for v in _fields(m)))


def binary_measures_per_sample(result: torch.Tensor, target: torch.Tensor,
                               binary_threshold: float = 0.5,
                               with_distances: bool = True
                               ) -> BinaryMeasures:
    """:func:`binary_measures` of each sample of (N, D, H, W, C) masks, each
    field (N,): what the JAX package's ``vmap`` of ``binary_measures`` over
    the leading axis computes, with one EDT call a direction for all N."""
    return _measures(result > binary_threshold, target > binary_threshold,
                     result.shape[0], with_distances)


def _fields(m: BinaryMeasures):
    return (m.dc, m.hd, m.assd, m.precision, m.sensitivity, m.specificity)


def binary_measures_host(result, target, binary_threshold: float = 0.5,
                         with_distances: bool = True) -> BinaryMeasures:
    """:func:`binary_measures` with host floats (for printing/curves)."""
    m = binary_measures(torch.as_tensor(result), torch.as_tensor(target),
                        binary_threshold, with_distances)
    return BinaryMeasures(*torch.stack(_fields(m)).tolist())
