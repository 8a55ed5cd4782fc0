"""Optimizer construction: Adam + L2 weight decay + MultiStep LR + the CAE
learners' beta1 ramp (port of train/optim.py).

``torch.optim.Adam(weight_decay=wd)`` adds ``wd * p`` to the gradient before
the moments, which is the JAX package's ``add_decayed_weights(wd) ->
scale_by_adam -> scale_by_learning_rate(lr)`` chain (the formula pinned by
tests/test_optim.py).  The learning rate is a ``param_groups`` entry that
the learner sets at each epoch start, as the JAX learner sets the injected
hyperparameter; beta1 likewise (:func:`set_beta1`), the port's
``set_hyperparams(opt_state, b1=...)``.  :func:`trainable_by_path` freezes a
model but for the parameters it names, the port's ``trainable_mask_by_path``
and masked optax chain.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import torch


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   learning_rate: float = 1e-3,
                   betas: Tuple[float, float] = (0.9, 0.999),
                   weight_decay: float = 1e-5,
                   eps: float = 1e-8) -> torch.optim.Adam:
    return torch.optim.Adam(params, lr=learning_rate, betas=betas, eps=eps,
                            weight_decay=weight_decay)


def trainable_by_path(model: torch.nn.Module,
                      wanted_substrings: Sequence[str]
                      ) -> List[torch.nn.Parameter]:
    """Freeze every parameter of ``model`` but those where a component of
    its name contains one of ``wanted_substrings`` (e.g. ``('reduce1',
    'reduce2', 'step_head')``): those get ``requires_grad_(False)``.
    Returns the trainable ones in ``model.parameters()`` order, for
    :func:`make_optimizer`, so that a frozen parameter gets neither an update
    nor the L2 term, as under the JAX package's ``optax.masked(inner, mask)``
    + ``masked(set_to_zero(), ~mask)``.  The names' components are the
    port's (``enc.reduce1.kernel``); for the step head's names they are the
    flax path's."""
    trainable = []
    for name, p in model.named_parameters():
        keep = any(s in part for part in name.split(".")
                   for s in wanted_substrings)
        p.requires_grad_(keep)
        if keep:
            trainable.append(p)
    return trainable


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
