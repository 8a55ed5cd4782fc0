"""Weights across the two packages: the flax variable tree of ``Unet3D`` <->
the port's ``Unet3D.state_dict()``.

The port keeps the JAX layouts (conv kernels ``(kD, kH, kW, C_in, C_out)``,
BN vectors), so the mapping is by name only:

  params/UnetBlock_{i}/BnConvActBlock_{j}/Conv3d_0/{kernel,bias}
      -> blocks.{i}.layers.{j}.conv.{kernel,bias}
  params/UnetBlock_{i}/BnConvActBlock_{j}/BatchNorm_0/BatchNorm_0/{scale,bias}
      -> blocks.{i}.layers.{j}.bn.{scale,bias}
  batch_stats/UnetBlock_{i}/BnConvActBlock_{j}/BatchNorm_0/BatchNorm_0/{mean,var}
      -> blocks.{i}.layers.{j}.bn.{mean,var}
  params/Conv3d_{k}/{kernel,bias} -> head.{k}.{kernel,bias}

The optimizer state goes the same way: the optax tree that the JAX learner
writes to ``.optim`` (``optax.inject_hyperparams`` around ``add_decayed_weights
-> scale_by_adam -> scale_by_learning_rate``)

  count, hyperparams/{learning_rate, b1}, hyperparams_states = {},
  inner_state/{0: {}, 1: {count, mu/<params>, nu/<params>}, 2: {}}

(the two empty ``EmptyState`` slots serialise as empty maps) maps onto
``torch.optim.Adam``'s state dict: one ``count`` (int32) for torch's
per-parameter ``step``, ``mu`` / ``nu`` for ``exp_avg`` / ``exp_avg_sq``.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch

from stroke_prediction_tpu_torch.utils.checkpoint import save_checkpoint

_N_BLOCKS, _N_LAYERS, _N_HEAD = 5, 2, 2


def _unet_key_map() -> Iterator[Tuple[Tuple[str, ...], str]]:
    for i in range(_N_BLOCKS):
        for j in range(_N_LAYERS):
            jax_pre = (f"UnetBlock_{i}", f"BnConvActBlock_{j}")
            pre = f"blocks.{i}.layers.{j}."
            for leaf in ("kernel", "bias"):
                yield ("params",) + jax_pre + ("Conv3d_0", leaf), \
                    pre + "conv." + leaf
            bn = jax_pre + ("BatchNorm_0", "BatchNorm_0")
            for leaf in ("scale", "bias"):
                yield ("params",) + bn + (leaf,), pre + "bn." + leaf
            for leaf in ("mean", "var"):
                yield ("batch_stats",) + bn + (leaf,), pre + "bn." + leaf
    for k in range(_N_HEAD):
        for leaf in ("kernel", "bias"):
            yield ("params", f"Conv3d_{k}", leaf), f"head.{k}.{leaf}"


def _tree_get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _tree_set(tree, path, value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def unet_state_from_jax(state: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` flax tree (numpy leaves) ->
    the port's ``Unet3D`` state dict."""
    return {key: torch.from_numpy(np.array(_tree_get(state, path),
                                           dtype=np.float32))
            for path, key in _unet_key_map()}


def unet_state_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's ``Unet3D`` state dict -> the flax variable tree."""
    tree: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for path, key in _unet_key_map():
        _tree_set(tree, path, state_dict[key].detach().cpu().numpy().astype(
            np.float32))
    return tree


def save_unet_checkpoint(path: str, model) -> None:
    """Write the port's ``Unet3D`` as a ``.model`` file that the JAX
    package's ``load_checkpoint`` / tester read (header as
    ``unet_learner.py`` writes it)."""
    save_checkpoint(path, unet_state_to_jax(model.state_dict()),
                    {"kind": "unet3d", "channels": list(model.channels)})


def _param_paths(model) -> List[Tuple[Tuple[str, ...], torch.nn.Parameter]]:
    """(flax path under "params", parameter) in ``model.parameters()``
    order, which is the order of the optimizer's state indices."""
    path_of = {key: path[1:] for path, key in _unet_key_map()
               if path[0] == "params"}
    return [(path_of[name], p) for name, p in model.named_parameters()]


def adam_state_to_jax(optimizer: torch.optim.Adam, model) -> Dict[str, Any]:
    """The port's Adam state -> the optax state tree of the JAX learner
    (numpy leaves), for ``{"opt_state": tree}`` in a ``.optim`` file."""
    group = optimizer.param_groups[0]
    count = 0
    mu: Dict[str, Any] = {}
    nu: Dict[str, Any] = {}
    for path, p in _param_paths(model):
        st = optimizer.state.get(p, {})
        if st:
            count = int(st["step"])
            m = st["exp_avg"].detach().cpu().numpy().astype(np.float32)
            v = st["exp_avg_sq"].detach().cpu().numpy().astype(np.float32)
        else:
            m = v = np.zeros(tuple(p.shape), np.float32)
        _tree_set(mu, path, m)
        _tree_set(nu, path, v)
    return {
        "count": np.asarray(count, np.int32),
        "hyperparams": {
            "learning_rate": np.asarray(group["lr"], np.float32),
            "b1": np.asarray(group["betas"][0], np.float32)},
        "hyperparams_states": {},
        "inner_state": {"0": {}, "2": {},
                        "1": {"count": np.asarray(count, np.int32),
                              "mu": mu, "nu": nu}},
    }


def adam_state_from_jax(opt_state: Dict[str, Any], model,
                        optimizer: torch.optim.Adam) -> Dict[str, Any]:
    """An optax state tree (as read from a ``.optim`` file) -> a state dict
    for ``optimizer.load_state_dict``; the settings that the tree does not
    hold (beta2, eps, weight decay) are the optimizer's own."""
    sd = optimizer.state_dict()
    adam = opt_state["inner_state"]["1"]
    count = int(adam["count"])
    state = {}
    if count:
        for i, (path, p) in enumerate(_param_paths(model)):
            state[i] = {
                "step": torch.tensor(float(count), dtype=torch.float32),
                "exp_avg": torch.from_numpy(np.array(
                    _tree_get(adam["mu"], path), np.float32)),
                "exp_avg_sq": torch.from_numpy(np.array(
                    _tree_get(adam["nu"], path), np.float32))}
    groups = copy.deepcopy(sd["param_groups"])
    hyper = opt_state["hyperparams"]
    for g in groups:
        g["lr"] = float(hyper["learning_rate"])
        g["betas"] = (float(hyper["b1"]), g["betas"][1])
    return {"state": state, "param_groups": groups}
