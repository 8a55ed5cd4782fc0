"""Optimizer construction: Adam + L2 weight decay + MultiStep LR + the CAE
learners' beta1 ramp (port of train/optim.py).

:class:`Adam` adds ``wd * p`` to the gradient before the moments, which is
the JAX package's ``add_decayed_weights(wd) -> scale_by_adam ->
scale_by_learning_rate(lr)`` chain (the formula pinned by
tests/test_optim.py).  Its learning rate and betas are 0-d tensors on the
parameters' device, which the learner sets in place at each epoch start
(:func:`set_learning_rate`, :func:`set_beta1`), as the JAX learner sets the
injected hyperparameters that its compiled steps take as arguments: a CUDA
graph that captured a step reads the new values when it replays
(train/learner.py).  :func:`trainable_by_path` freezes a model but for the
parameters it names, the port's ``trainable_mask_by_path`` and masked optax
chain.
"""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple, Union

import torch

Scalar = Union[float, torch.Tensor]


class Adam(torch.optim.Adam):
    """``torch.optim.Adam`` (L2 weight decay, no amsgrad) whose step reads
    nothing on the host, so that a CUDA graph can capture it.

    The learning rate and both betas are 0-d tensors of the parameters'
    type on their device, held for the optimizer's life and changed in
    place; each parameter's step count is a 0-d float32 tensor there too
    (``state["step"]``, the ``.optim`` format's count).  The update is
    torch's capturable one, written with foreach ops that take a device
    tensor as the scalar, the same arithmetic on the CPU and on the card:

        m = b1 m + (1 - b1) g,  v = b2 v + (1 - b2) g^2,
        p += m / ((sqrt(v) / sqrt(1 - b2^t) + eps) (b1^t - 1) / lr)

    A learning rate set as a Python number (``param_groups[i]["lr"] =
    1e-3``) is read as one, and a graph that captured it keeps it.

    Why not ``torch.optim.Adam(capturable=True)`` with these tensors: torch
    refuses ``capturable`` for CPU parameters, and its CPU update reads
    each step count on the host (``Tensor.item``), so the planned step's
    body would differ between the CPU, where the tests hold it to no host
    read, and the card."""

    def __init__(self, params, lr: float = 1e-3,
                 betas: Tuple[float, float] = (0.9, 0.999),
                 eps: float = 1e-8, weight_decay: float = 0.0):
        # capturable: load_state_dict puts each step count on its
        # parameter's device
        super().__init__(params, lr=lr, betas=betas, eps=eps,
                         weight_decay=weight_decay, capturable=True)
        self._held: List[Tuple[torch.Tensor, ...]] = [
            self._hold(group, None) for group in self.param_groups]

    @staticmethod
    def _hold(group: dict, held) -> Tuple[torch.Tensor, ...]:
        """The group's lr and betas in ``held``'s tensors (new ones the
        first time), which the group then holds."""
        p = group["params"][0]
        dtype = p.dtype if p.is_floating_point() else torch.float32
        values = (group["lr"], *group["betas"])
        if held is None:
            held = tuple(torch.zeros((), dtype=dtype, device=p.device)
                         for _ in values)
        for t, v in zip(held, values):
            if isinstance(v, torch.Tensor):
                if v is not t:
                    t.copy_(v)
            else:
                t.fill_(v)
        group["lr"], group["betas"] = held[0], held[1:]
        return held

    def load_state_dict(self, state_dict) -> None:
        super().load_state_dict(state_dict)
        for i, group in enumerate(self.param_groups):
            self._held[i] = self._hold(group, self._held[i])

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adam.step takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                st = self.state[p]
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.float32,
                                             device=p.device)
                    st["exp_avg"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
                    st["exp_avg_sq"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
            states = [self.state[p] for p in params]
            steps = [st["step"] for st in states]
            m = [st["exp_avg"] for st in states]
            v = [st["exp_avg_sq"] for st in states]
            grads = [p.grad for p in params]
            lr, (b1, b2) = group["lr"], group["betas"]

            torch._foreach_add_(steps, 1)
            if group["weight_decay"]:
                grads = torch._foreach_add(grads, params,
                                           alpha=group["weight_decay"])
            torch._foreach_mul_(m, b1)
            torch._foreach_add_(m, torch._foreach_mul(grads, 1 - b1))
            torch._foreach_mul_(v, b2)
            torch._foreach_add_(v, torch._foreach_mul(
                torch._foreach_mul(grads, grads), 1 - b2))
            # (b1^t - 1) / lr and sqrt(1 - b2^t), a 0-d tensor a parameter
            step_size = _powers(b1, steps)
            torch._foreach_sub_(step_size, 1)
            torch._foreach_div_(step_size, lr)
            bc2 = _powers(b2, steps)
            torch._foreach_sub_(bc2, 1)
            torch._foreach_neg_(bc2)
            torch._foreach_sqrt_(bc2)
            denom = torch._foreach_sqrt(v)
            torch._foreach_div_(denom, bc2)
            torch._foreach_add_(denom, group["eps"])
            torch._foreach_mul_(denom, step_size)
            torch._foreach_addcdiv_(params, m, denom)
        return None


def _powers(base: Scalar, steps: List[torch.Tensor]) -> List[torch.Tensor]:
    """``base ** t`` for each step count ``t``, with ``base`` a Python
    number or a 0-d device tensor (read on the device)."""
    if isinstance(base, torch.Tensor):
        return torch._foreach_pow([base] * len(steps), steps)
    return torch._foreach_pow(base, steps)


def make_optimizer(params: Iterable[torch.nn.Parameter],
                   learning_rate: float = 1e-3,
                   betas: Tuple[float, float] = (0.9, 0.999),
                   weight_decay: float = 1e-5,
                   eps: float = 1e-8) -> Adam:
    return Adam(params, lr=learning_rate, betas=betas, eps=eps,
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


def _set(value: Scalar, new: float) -> Scalar:
    """``new`` in place of ``value``: written into it where it is a
    tensor (an :class:`Adam`'s, which a captured step reads), else
    returned."""
    if isinstance(value, torch.Tensor):
        value.fill_(new)
        return value
    return new


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = _set(group["lr"], lr)


def beta1_ramp(base_b1: float, epoch: int, n_ramp_epochs: int = 4) -> float:
    """The CAE learners' beta1 warm ramp: ``base_b1 - 0.1 * (n - epoch)``
    for the first ``n`` epochs, then ``base_b1``."""
    if epoch < n_ramp_epochs:
        return base_b1 - 0.1 * (n_ramp_epochs - epoch)
    return base_b1


def set_beta1(optimizer: torch.optim.Optimizer, b1: float) -> None:
    for group in optimizer.param_groups:
        group["betas"] = (_set(group["betas"][0], b1), group["betas"][1])
