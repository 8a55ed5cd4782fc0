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
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

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


def unet_state_from_jax(state: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"params": ..., "batch_stats": ...}`` flax tree (numpy leaves) ->
    the port's ``Unet3D`` state dict."""
    out = {}
    for path, key in _unet_key_map():
        node = state
        for p in path:
            node = node[p]
        out[key] = torch.from_numpy(np.array(node, dtype=np.float32))
    return out


def unet_state_to_jax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's ``Unet3D`` state dict -> the flax variable tree."""
    tree: Dict[str, Any] = {"params": {}, "batch_stats": {}}
    for path, key in _unet_key_map():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = state_dict[key].detach().cpu().numpy().astype(
            np.float32)
    return tree


def save_unet_checkpoint(path: str, model) -> None:
    """Write the port's ``Unet3D`` as a ``.model`` file that the JAX
    package's ``load_checkpoint`` / tester read (header as
    ``unet_learner.py`` writes it)."""
    save_checkpoint(path, unet_state_to_jax(model.state_dict()),
                    {"kind": "unet3d", "channels": list(model.channels)})
