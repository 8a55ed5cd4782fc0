"""Max pooling over channels-last volumes (port of ops/pooling.py).

Forward only: the JAX backward's tie rule (every tied max gets the full
gradient) belongs to the training slice.
"""

from __future__ import annotations

import torch


def max_pool3d(x: torch.Tensor) -> torch.Tensor:
    """2x2x2 / stride-2 max pool of the three spatial axes of
    ``(..., D, H, W, C)``, VALID (odd dims are floored, like
    ``nn.MaxPool3d(2, 2)``)."""
    *lead, d, h, w, c = x.shape
    d2, h2, w2 = d // 2, h // 2, w // 2
    x = x[..., :2 * d2, :2 * h2, :2 * w2, :]
    x = x.reshape(*lead, d2, 2, h2, 2, w2, 2, c)
    n = len(lead)
    return torch.amax(x, dim=(n + 1, n + 3, n + 5))
