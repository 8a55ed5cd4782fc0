"""Losses and binary segmentation measures (port of eval/metrics.py).

HD/ASSD come from surface distances computed on the device with the
separable EDT (ops/edt.py, kernel K5); they are inf when either mask is
empty.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from stroke_prediction_tpu_torch.core.dto import BinaryMeasures
from stroke_prediction_tpu_torch.ops.edt import edt_to_sites


def batch_dice_loss(outputs: torch.Tensor, targets: torch.Tensor,
                    label_weights: Sequence[float] = (1.0,),
                    epsilon: float = 1e-7) -> torch.Tensor:
    """Soft Dice loss over the flattened batch, per (last-axis) label
    channel, weighted."""
    if targets.shape[-1] != len(label_weights):
        raise ValueError("Ground truth number of labels does not match "
                         "label weight vector")
    wide = torch.promote_types(outputs.dtype, torch.float32)
    o = outputs.to(wide)
    t = targets.to(wide)
    axes = tuple(range(o.ndim - 1))
    inter = torch.sum(o * t, dim=axes)
    denom = torch.sum(o * o, dim=axes) + torch.sum(t * t, dim=axes)
    dice = (2.0 * inter + epsilon) / (denom + epsilon)
    w = torch.as_tensor(label_weights, dtype=wide, device=o.device)
    return 1.0 - torch.sum(w * dice)


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


def _surface_distance_stats(a: torch.Tensor, b: torch.Tensor):
    """(max, sum, count) over all N volumes of the distances from
    surface(a) to surface(b); a, b: (N, D, H, W) bool.  The EDT runs once
    for all N volumes (two K5 kernel launches on the card)."""
    sa = _surface6(a)
    dist_to_b = edt_to_sites(_surface6(b), axes=(1, 2, 3))
    d = torch.where(sa, dist_to_b, torch.zeros_like(dist_to_b))
    return torch.amax(d), torch.sum(d), torch.sum(sa)


def _to_b3(m: torch.Tensor) -> torch.Tensor:
    """(D, H, W), (D, H, W, C) or (B, D, H, W, C) -> (N, D, H, W)."""
    if m.ndim == 3:
        return m[None]
    if m.ndim == 4:
        return torch.movedim(m, -1, 0)
    if m.ndim == 5:
        return torch.movedim(m, -1, 1).reshape((-1,) + tuple(m.shape[1:4]))
    raise ValueError(f"unsupported mask rank {m.ndim}")


def binary_measures(result: torch.Tensor, target: torch.Tensor,
                    binary_threshold: float = 0.5,
                    with_distances: bool = True) -> BinaryMeasures:
    """Dice, HD, ASSD, precision, sensitivity, specificity for one
    structure, as 0-d float32 tensors on the inputs' device."""
    r = result > binary_threshold
    t = target > binary_threshold
    rf = r.reshape(-1).float()
    tf = t.reshape(-1).float()

    tp = torch.sum(rf * tf)
    fp = torch.sum(rf * (1 - tf))
    fn = torch.sum((1 - rf) * tf)
    tn = torch.sum((1 - rf) * (1 - tf))
    zero = torch.zeros_like(tp)

    def ratio(num, den):
        return torch.where(den > 0, num / torch.clamp(den, min=1), zero)

    dc = ratio(2 * tp, 2 * tp + fp + fn)
    precision = ratio(tp, tp + fp)
    sensitivity = ratio(tp, tp + fn)
    specificity = ratio(tn, tn + fp)

    inf = torch.full_like(tp, float("inf"))
    hd = assd = inf
    if with_distances:
        r3, t3 = _to_b3(r), _to_b3(t)
        m1, s1, n1 = _surface_distance_stats(r3, t3)
        m2, s2, n2 = _surface_distance_stats(t3, r3)
        nonempty = torch.any(r) & torch.any(t)
        hd = torch.where(nonempty, torch.maximum(m1, m2), inf)
        assd = torch.where(nonempty,
                           (s1 + s2) / torch.clamp(n1 + n2, min=1), inf)
    return BinaryMeasures(dc=dc, hd=hd, assd=assd, precision=precision,
                          sensitivity=sensitivity, specificity=specificity)


def binary_measures_host(result, target, binary_threshold: float = 0.5,
                         with_distances: bool = True) -> BinaryMeasures:
    """:func:`binary_measures` with host floats (for printing/curves)."""
    m = binary_measures(torch.as_tensor(result), torch.as_tensor(target),
                        binary_threshold, with_distances)
    vals = torch.stack([m.dc, m.hd, m.assd, m.precision, m.sensitivity,
                        m.specificity]).tolist()
    return BinaryMeasures(*vals)
