"""Inference adapters: batch tensors -> DTO -> model forward (port of the
U-Net half of inference.py; the CAE half comes with the CAE slice)."""

from __future__ import annotations

from dataclasses import replace
from typing import Optional

import torch

from stroke_prediction_tpu_torch.core.dto import UnetDto, init_unet_dto


def unet_dto_from_batch(images: torch.Tensor,
                        labels: Optional[torch.Tensor]) -> UnetDto:
    """labels channel 0 is the core ground truth, channel 1 the penumbra."""
    core = penu = None
    if labels is not None:
        core = labels[..., 0:1]
        penu = labels[..., 1:2]
    return init_unet_dto(images, core, penu)


def unet_inference(model: torch.nn.Module, images: torch.Tensor,
                   labels: Optional[torch.Tensor] = None) -> UnetDto:
    dto = unet_dto_from_batch(images, labels)
    seg = model(dto.given_variables.input_modalities)
    return replace(dto, outputs=replace(dto.outputs, core=seg[..., 0:1],
                                        penu=seg[..., 1:2]))
