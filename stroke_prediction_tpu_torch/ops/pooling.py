"""Max pooling over channels-last volumes (port of ops/pooling.py).

The 2x2x2 / stride-2 pool is a reshape + max; its gradient is the JAX
package's equality mask (``_max_pool3d_2x_bwd``): every input equal to its
window's max receives the window's full gradient, so tied maxima (common in
bfloat16) each get all of it, where ``torch.amax``'s own backward would
split it evenly among them.  Floor-cropped tails get zero.

Under a spatial step (H sharded over the ranks, ``parallel/spatial.py``)
each rank pools its block of the output from input rows ``[2 lo, 2 hi)``,
fetched from their owners, so no window straddles two ranks; the gradient
of a fetched row goes back to its owner.
"""

from __future__ import annotations

import torch

from stroke_prediction_tpu_torch.parallel import spatial


def _pool(x: torch.Tensor) -> torch.Tensor:
    *lead, d, h, w, c = x.shape
    d2, h2, w2 = d // 2, h // 2, w // 2
    x = x[..., :2 * d2, :2 * h2, :2 * w2, :]
    x = x.reshape(*lead, d2, 2, h2, 2, w2, 2, c)
    n = len(lead)
    return torch.amax(x, dim=(n + 1, n + 3, n + 5))


def _up2(t: torch.Tensor, shape) -> torch.Tensor:
    """Nearest x2 repeat of the three spatial axes of ``(..., D, H, W, C)``,
    zero-padded at the end of each axis to ``shape``."""
    n = t.ndim
    for ax in (n - 4, n - 3, n - 2):
        t = torch.repeat_interleave(t, 2, dim=ax)
    pad = []
    for ax in (n - 2, n - 3, n - 4):          # F.pad order: last axis first
        pad += [0, shape[ax] - t.shape[ax]]
    return torch.nn.functional.pad(t, [0, 0] + pad)


class _MaxPool3d2x(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = _pool(x)
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        # cropped tails compare against a zero-padded max and get a zero
        # gradient through the padded g, as the JAX +inf pad does
        hit = x == _up2(y, x.shape)
        return torch.where(hit, _up2(g.to(x.dtype), x.shape),
                           torch.zeros((), dtype=x.dtype, device=x.device))


def max_pool3d(x: torch.Tensor) -> torch.Tensor:
    """2x2x2 / stride-2 max pool of the three spatial axes of
    ``(..., D, H, W, C)``, VALID (odd dims are floored, like
    ``nn.MaxPool3d(2, 2)``), with the JAX package's tie rule in its
    gradient."""
    if not spatial.active():
        return _MaxPool3d2x.apply(x)
    h = spatial.height(x)
    x = spatial.rows(x, h, h // 2, lambda lo, hi: (2 * lo, 2 * hi))
    return spatial.record(_MaxPool3d2x.apply(x), h // 2)
