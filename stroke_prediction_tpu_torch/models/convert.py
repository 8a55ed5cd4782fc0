"""Weights across the two packages: the flax variable trees of ``Unet3D``,
``LargeUnet3D`` and of the CAE models <-> the port's ``state_dict()``s.

The port keeps the JAX layouts (conv and transposed-conv kernels ``(kD, kH,
kW, C_in, C_out)``, dense kernels ``(C_in, C_out)``, BN vectors), so the
mapping is by name only.  A BN -> conv block (``BnConvActBlock_{j}``):

  params/<block>/Conv3d_0/{kernel,bias} -> <block'>.conv.{kernel,bias}
  params/<block>/BatchNorm_0/BatchNorm_0/{scale,bias} -> <block'>.bn.{...}
  batch_stats/<block>/BatchNorm_0/BatchNorm_0/{mean,var} -> <block'>.bn.{...}

U-Net (``unet3d``, five blocks; ``large_unet3d``, seven):
``UnetBlock_{i}/BnConvActBlock_{j}`` -> ``blocks.{i}.layers.{j}``,
``Conv3d_{k}`` -> ``head.{k}``.

CAE (``cae3d``, and ``cae3d_ctp``, whose tree is ``cae3d``'s with the
entry conv's C_in the mask's and the images' channels; ``enc3d`` /
``enc3d_step`` are the encoder alone, its tree without the ``enc/`` level
and its keys without ``enc.``):

  enc/encoder/BnConvActBlock_{j}  -> enc.encoder.blocks.{j}
  enc/{reduce1,reduce2,step_head}/{kernel,bias} -> enc.<same>  (step)
  dec/decoder/BatchNorm_{i}/BatchNorm_0 -> dec.decoder.bns.{i}
  dec/decoder/Conv3d_{i}               -> dec.decoder.convs.{i}
  dec/decoder/ConvTranspose3d_{i}/ConvTranspose_0 -> dec.decoder.cts.{i}

The optimizer state goes the same way: the optax tree that the JAX learner
writes to ``.optim`` (``optax.inject_hyperparams`` around ``add_decayed_weights
-> scale_by_adam -> scale_by_learning_rate``)

  count, hyperparams/{learning_rate, b1}, hyperparams_states = {},
  inner_state/{0: {}, 1: {count, mu/<params>, nu/<params>}, 2: {}}

(the two empty ``EmptyState`` slots serialise as empty maps) maps onto
``torch.optim.Adam``'s state dict: one ``count`` (int32) for torch's
per-parameter ``step``, ``mu`` / ``nu`` for ``exp_avg`` / ``exp_avg_sq``.
A model with frozen parameters (``requires_grad`` False, the optimizer
over the others: ``train.optim.trainable_by_path``) has the layout of the
JAX learner's masked chain (``optax.masked(inner, mask)``, then
``masked(set_to_zero(), ~mask)``):

  inner_state/{0: {inner_state: {0: {}, 1: {count, mu, nu}, 2: {}}},
               1: {inner_state: {}}}

with each frozen leaf of ``mu`` and ``nu`` an empty map.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Iterator, List, Tuple

import numpy as np
import torch

from stroke_prediction_tpu_torch.utils.checkpoint import save_checkpoint

KeyMap = Iterator[Tuple[Tuple[str, ...], str]]

# U-Net blocks by kind, layers a block and head convs; CAE encoder blocks,
# decoder BNs, 3^3 and 1^3 convs and transposed convs; Enc3DStep's head
_N_BLOCKS = {"unet3d": 5, "large_unet3d": 7}
_N_LAYERS, _N_HEAD = 2, 2
_N_ENC, _N_DEC_BN, _N_DEC_CONV, _N_DEC_CT = 10, 12, 8, 4
_STEP_HEAD = ("reduce1", "reduce2", "step_head")


def _params(jax_pre, pre) -> KeyMap:
    for leaf in ("kernel", "bias"):
        yield ("params",) + jax_pre + (leaf,), pre + leaf


def _bn(jax_pre, pre) -> KeyMap:
    for leaf in ("scale", "bias"):
        yield ("params",) + jax_pre + (leaf,), pre + leaf
    for leaf in ("mean", "var"):
        yield ("batch_stats",) + jax_pre + (leaf,), pre + leaf


def _block(jax_pre, pre) -> KeyMap:
    yield from _params(jax_pre + ("Conv3d_0",), pre + "conv.")
    yield from _bn(jax_pre + ("BatchNorm_0", "BatchNorm_0"), pre + "bn.")


def _unet_key_map(n_blocks: int = _N_BLOCKS["unet3d"]) -> KeyMap:
    for i in range(n_blocks):
        for j in range(_N_LAYERS):
            yield from _block((f"UnetBlock_{i}", f"BnConvActBlock_{j}"),
                              f"blocks.{i}.layers.{j}.")
    for k in range(_N_HEAD):
        yield from _params((f"Conv3d_{k}",), f"head.{k}.")


def _encoder_key_map(jax_pre, pre, step: bool) -> KeyMap:
    for j in range(_N_ENC):
        yield from _block(jax_pre + ("encoder", f"BnConvActBlock_{j}"),
                          f"{pre}encoder.blocks.{j}.")
    if step:
        for name in _STEP_HEAD:
            yield from _params(jax_pre + (name,), pre + name + ".")


def _cae_key_map(config: Dict[str, Any]) -> KeyMap:
    """The CAE tree of a ``cae3d``, ``cae3d_ctp``, ``enc3d`` or
    ``enc3d_step`` header."""
    kind = config["kind"]
    if kind in ("enc3d", "enc3d_step"):
        yield from _encoder_key_map((), "", kind == "enc3d_step")
        return
    if kind not in ("cae3d", "cae3d_ctp"):
        raise ValueError(f"Unknown model kind: {kind}")
    yield from _encoder_key_map(("enc",), "enc.", bool(config.get("step")))
    dec, pre = ("dec", "decoder"), "dec.decoder."
    for i in range(_N_DEC_BN):
        yield from _bn(dec + (f"BatchNorm_{i}", "BatchNorm_0"),
                       f"{pre}bns.{i}.")
    for i in range(_N_DEC_CONV):
        yield from _params(dec + (f"Conv3d_{i}",), f"{pre}convs.{i}.")
    for i in range(_N_DEC_CT):
        yield from _params(dec + (f"ConvTranspose3d_{i}", "ConvTranspose_0"),
                           f"{pre}cts.{i}.")


def _key_map(config: Dict[str, Any]) -> KeyMap:
    if config["kind"] in _N_BLOCKS:
        return _unet_key_map(_N_BLOCKS[config["kind"]])
    return _cae_key_map(config)


def _tree_get(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def _tree_set(tree, path, value) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def _from_jax(state: Dict[str, Any], key_map: KeyMap
              ) -> Dict[str, torch.Tensor]:
    out = {}
    for path, key in key_map:
        try:
            leaf = _tree_get(state, path)
        except KeyError:
            # flax creates Enc3DStep's head at its first call: a tree
            # initialised with a time to treatment has none
            if set(path) & set(_STEP_HEAD):
                continue
            raise
        out[key] = torch.from_numpy(np.array(leaf, dtype=np.float32))
    return out


def _to_jax(state_dict: Dict[str, torch.Tensor], key_map: KeyMap
            ) -> Dict[str, Any]:
    tree: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for path, key in key_map:
        if key not in state_dict and set(path) & set(_STEP_HEAD):
            continue            # an Enc3DStep loaded without its head
        _tree_set(tree, path, state_dict[key].detach().cpu().numpy().astype(
            np.float32))
    return tree


def state_from_jax(state: Dict[str, Any], config: Dict[str, Any]
                   ) -> Dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` flax tree (numpy leaves) of a
    model with the ``.model`` header ``config`` -> the port's state dict
    (without the step head's entries where the tree has no head)."""
    return _from_jax(state, _key_map(config))


def state_to_jax(state_dict: Dict[str, torch.Tensor],
                 config: Dict[str, Any]) -> Dict[str, Any]:
    """The port's state dict of a model with header ``config`` -> the flax
    variable tree."""
    return _to_jax(state_dict, _key_map(config))


def unet_state_from_jax(state: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The flax tree of a ``Unet3D`` -> the port's ``Unet3D`` state dict."""
    return _from_jax(state, _unet_key_map())


def unet_state_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's ``Unet3D`` state dict -> the flax variable tree."""
    return _to_jax(state_dict, _unet_key_map())


def save_unet_checkpoint(path: str, model) -> None:
    """Write the port's ``Unet3D`` or ``LargeUnet3D`` as a ``.model`` file
    that the JAX package's ``load_checkpoint`` / tester read, with the
    model's own header (``model.config``)."""
    save_checkpoint(path, state_to_jax(model.state_dict(), model.config),
                    model.config)


def save_cae_checkpoint(path: str, model) -> None:
    """Write the port's ``Cae3D`` or ``Cae3DCtp`` as a ``.model`` file that
    the JAX package's ``load_model`` / CAE testers read (header as
    ``cae_learners.py`` writes it)."""
    save_checkpoint(path, state_to_jax(model.state_dict(), model.config),
                    model.config)


def _param_paths(model) -> List[Tuple[Tuple[str, ...], torch.nn.Parameter]]:
    """(flax path under "params", parameter) in ``model.parameters()``
    order, which is the order of the optimizer's state indices; the
    paths of the tree that ``model.config`` names (a U-Net or a CAE)."""
    path_of = {key: path[1:] for path, key in _key_map(model.config)
               if path[0] == "params"}
    return [(path_of[name], p) for name, p in model.named_parameters()]


def adam_state_to_jax(optimizer: torch.optim.Adam, model) -> Dict[str, Any]:
    """The port's Adam state -> the optax state tree of the JAX learner
    (numpy leaves), for ``{"opt_state": tree}`` in a ``.optim`` file; the
    masked layout where ``model`` has frozen parameters.  The learning
    rate, beta1 and the count may be numbers or (device) tensors."""
    group = optimizer.param_groups[0]
    count = 0
    mu: Dict[str, Any] = {}
    nu: Dict[str, Any] = {}
    masked = False
    for path, p in _param_paths(model):
        if not p.requires_grad:
            masked = True
            _tree_set(mu, path, {})
            _tree_set(nu, path, {})
            continue
        st = optimizer.state.get(p, {})
        if st:
            count = int(st["step"])
            m = st["exp_avg"].detach().cpu().numpy().astype(np.float32)
            v = st["exp_avg_sq"].detach().cpu().numpy().astype(np.float32)
        else:
            m = v = np.zeros(tuple(p.shape), np.float32)
        _tree_set(mu, path, m)
        _tree_set(nu, path, v)
    adam = {"0": {}, "2": {},
            "1": {"count": np.asarray(count, np.int32), "mu": mu, "nu": nu}}
    if masked:
        adam = {"0": {"inner_state": adam}, "1": {"inner_state": {}}}
    return {
        "count": np.asarray(count, np.int32),
        "hyperparams": {
            "learning_rate": np.asarray(float(group["lr"]), np.float32),
            "b1": np.asarray(float(group["betas"][0]), np.float32)},
        "hyperparams_states": {},
        "inner_state": adam,
    }


def adam_state_from_jax(opt_state: Dict[str, Any], model,
                        optimizer: torch.optim.Adam) -> Dict[str, Any]:
    """An optax state tree (as read from a ``.optim`` file) -> a state dict
    for ``optimizer.load_state_dict``; the settings that the tree does not
    hold (beta2, eps, weight decay) are the optimizer's own.  Reads the
    masked layout too; the optimizer holds the trainable parameters."""
    sd = optimizer.state_dict()
    inner = opt_state["inner_state"]
    adam = (inner["0"]["inner_state"]["1"] if "inner_state" in inner["0"]
            else inner["1"])
    count = int(adam["count"])
    index = {id(p): i for i, p in enumerate(optimizer.param_groups[0][
        "params"])}
    state = {}
    if count:
        for path, p in _param_paths(model):
            if id(p) not in index:
                continue                # frozen: no Adam state
            state[index[id(p)]] = {
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
