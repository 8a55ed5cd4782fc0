"""Model reconstruction from checkpoint config headers (port of
models/factory.py).  Only ``kind == "unet3d"`` is ported so far."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from stroke_prediction_tpu_torch.device import resolve_device
from stroke_prediction_tpu_torch.models.convert import unet_state_from_jax
from stroke_prediction_tpu_torch.models.unet3d import Unet3D
from stroke_prediction_tpu_torch.utils.checkpoint import load_checkpoint


def build_model(config: Dict[str, Any]) -> torch.nn.Module:
    kind = config["kind"]
    if kind == "unet3d":
        return Unet3D(channels=tuple(config["channels"]))
    raise NotImplementedError(f"model kind {kind!r}: not ported yet")


def load_model(path: str, device: Optional[Union[str, torch.device]] = None
               ) -> Tuple[torch.nn.Module, Dict[str, Any]]:
    """Load a ``.model`` checkpoint (written by either package) -> (model in
    eval mode on ``device``, config)."""
    state, config = load_checkpoint(path)
    if config is None:
        raise ValueError(f"Checkpoint {path} has no model config header")
    model = build_model(config)
    model.load_state_dict(unet_state_from_jax(state))
    return model.to(resolve_device(device)).eval(), config
