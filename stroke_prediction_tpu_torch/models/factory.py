"""Model reconstruction from checkpoint config headers (port of
models/factory.py): the kinds ``unet3d``, ``large_unet3d``, ``cae3d``
(``step`` false or true), ``cae3d_ctp`` (with its ``padding``), ``enc3d``
and ``enc3d_step``."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from stroke_prediction_tpu_torch.device import resolve_device
from stroke_prediction_tpu_torch.models.cae3d import (
    Cae3D, Cae3DCtp, Dec3D, Enc3D, Enc3DCtp, Enc3DStep)
from stroke_prediction_tpu_torch.models.convert import state_from_jax
from stroke_prediction_tpu_torch.models.unet3d import LargeUnet3D, Unet3D
from stroke_prediction_tpu_torch.utils.checkpoint import load_checkpoint


def build_model(config: Dict[str, Any]) -> torch.nn.Module:
    kind = config["kind"]
    if kind == "unet3d":
        return Unet3D(channels=tuple(config["channels"]))
    if kind == "large_unet3d":
        return LargeUnet3D(channels=tuple(config["channels"]))
    ch, ng = tuple(config.get("channels", ())), config.get("n_ch_global", 5)
    if kind == "cae3d":
        enc_cls = Enc3DStep if config.get("step") else Enc3D
        return Cae3D(enc=enc_cls(ch, ng), dec=Dec3D(ch, ng))
    if kind == "cae3d_ctp":
        pad = tuple(config.get("padding", (20, 20, 20)))
        return Cae3DCtp(enc=Enc3DCtp(ch, ng, padding=pad), dec=Dec3D(ch, ng))
    if kind in ("enc3d", "enc3d_step"):
        return (Enc3DStep if kind == "enc3d_step" else Enc3D)(ch, ng)
    raise ValueError(f"Unknown model kind: {kind}")


def load_model(path: str, device: Optional[Union[str, torch.device]] = None
               ) -> Tuple[torch.nn.Module, Dict[str, Any]]:
    """Load a ``.model`` checkpoint (written by either package) -> (model in
    eval mode on ``device``, config).  An ``Enc3DStep`` whose tree has no
    step head loads without one and raises where it would regress the step,
    as flax does."""
    state, config = load_checkpoint(path)
    if config is None:
        raise ValueError(f"Checkpoint {path} has no model config header")
    model = build_model(config)
    state = state_from_jax(state, config)
    if not any("step_head" in k.split(".") for k in state):
        for m in model.modules():
            if isinstance(m, Enc3DStep):
                m.drop_head()
    model.load_state_dict(state)
    return model.to(resolve_device(device)).eval(), config
