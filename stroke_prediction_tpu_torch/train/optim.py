"""Optimizer construction: Adam + L2 weight decay + MultiStep LR + the CAE
learners' beta1 ramp (port of train/optim.py).

``torch.optim.Adam(weight_decay=wd)`` adds ``wd * p`` to the gradient before
the moments, which is the JAX package's ``add_decayed_weights(wd) ->
scale_by_adam -> scale_by_learning_rate(lr)`` chain (the formula pinned by
tests/test_optim.py).  The learning rate is a ``param_groups`` entry that
the learner sets at each epoch start, as the JAX learner sets the injected
hyperparameter; beta1 likewise (:func:`set_beta1`), the port's
``set_hyperparams(opt_state, b1=...)``.
"""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import torch


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   learning_rate: float = 1e-3,
                   betas: Tuple[float, float] = (0.9, 0.999),
                   weight_decay: float = 1e-5,
                   eps: float = 1e-8) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=learning_rate, betas=betas, eps=eps,
                            weight_decay=weight_decay)


def multistep_lr(base_lr: float, milestones: Sequence[int],
                 gamma: float = 0.1):
    """torch ``MultiStepLR`` equivalent:
    ``lr(epoch) = base * gamma ** #{m in milestones : m <= epoch}``."""
    ms = sorted(milestones)

    def schedule(epoch: int) -> float:
        return base_lr * gamma ** sum(1 for m in ms if m <= epoch)

    return schedule


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def beta1_ramp(base_b1: float, epoch: int, n_ramp_epochs: int = 4) -> float:
    """The CAE learners' beta1 warm ramp: ``base_b1 - 0.1 * (n - epoch)``
    for the first ``n`` epochs, then ``base_b1``."""
    if epoch < n_ramp_epochs:
        return base_b1 - 0.1 * (n_ramp_epochs - epoch)
    return base_b1


def set_beta1(optimizer: torch.optim.Optimizer, b1: float) -> None:
    for group in optimizer.param_groups:
        group["betas"] = (b1, group["betas"][1])
