"""Inference adapters: batch tensors -> DTO -> model forward (port of
inference.py).

``clinical`` is ``(B, n_globals)`` with clinical[:, 0] = tO_to_tA and
clinical[:, 1] = tA_to_tR, in hours."""

from __future__ import annotations

from dataclasses import replace
from typing import Optional, Sequence, Union

import torch

from stroke_prediction_tpu_torch.core.dto import (
    BRANCH_GTRUTH, BRANCH_INPUTS, CaeBranches, CaeDto, UnetDto, init_cae_dto,
    init_unet_dto)

# colour scale limits of the CBV / TTD panels in the learners' PNG grids
IMSHOW_VMAX_CBV = 12
IMSHOW_VMAX_TTD = 40


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


def normalization_hours(clinical, normalization_hours_penumbra: float = 10.0):
    """``normalization = 10 h - tO_to_tA``, (B, 1), for a (B, n_globals)
    tensor or array."""
    return normalization_hours_penumbra - clinical[:, 0:1]


def time_to_treatment(clinical: torch.Tensor,
                      step: Union[None, float, Sequence[float]],
                      normalization_hours_penumbra: float = 10.0,
                      learn_step: bool = False) -> Optional[torch.Tensor]:
    """Normalized interpolation step: ``tA_to_tR / normalization`` (B, 1)
    for ``step`` None; ``step / normalization`` for a counterfactual step in
    hours, (B, 1), or for S of them, (S, 1) (one case, B = 1); None for
    ``learn_step`` with ``step`` None (Enc3DStep's head then regresses
    it)."""
    norm = normalization_hours(clinical, normalization_hours_penumbra)
    if step is None:
        return None if learn_step else clinical[:, 1:2] / norm
    return torch.as_tensor(step, dtype=torch.float32,
                           device=clinical.device).reshape(-1, 1) / norm


def cae_dto_from_batch(images: Optional[torch.Tensor],
                       labels: Optional[torch.Tensor],
                       clinical: torch.Tensor,
                       step: Union[None, float, Sequence[float]] = None,
                       normalization_hours_penumbra: float = 10.0,
                       learn_step: bool = False,
                       inputs_from_images: bool = False) -> CaeDto:
    """The CAE's given variables: labels channels 0 / 1 / 2 are the core /
    penumbra / lesion masks of the gtruth branch; with
    ``inputs_from_images``, images channels 0 / 1 fill the inputs branch."""
    b = clinical.shape[0]
    ttt = time_to_treatment(clinical, step, normalization_hours_penumbra,
                            learn_step)
    gt = [None] * 3 if labels is None else [labels[..., i:i + 1]
                                             for i in range(3)]
    inputs = [None] * 2
    if inputs_from_images and images is not None:
        inputs = [images[..., 0:1], images[..., 1:2]]
    f32 = dict(dtype=torch.float32, device=clinical.device)
    return init_cae_dto(
        global_variables=clinical, time_to_treatment=ttt,
        type_core=torch.zeros((b, 1), **f32),
        type_penumbra=torch.ones((b, 1), **f32),
        inputs_core=inputs[0], inputs_penu=inputs[1],
        gtruth_core=gt[0], gtruth_penumbra=gt[1], gtruth_lesion=gt[2])


def cae_inference(model: torch.nn.Module, dto: CaeDto,
                  branches: CaeBranches = BRANCH_GTRUTH) -> CaeDto:
    """The whole CAE forward over the given branches."""
    return model(dto, branches)


def cae_enc_inference(cae_model: torch.nn.Module, enc_model: torch.nn.Module,
                      dto: CaeDto, train: bool = False) -> CaeDto:
    """Phase 2's two-model forward: the new encoder over the inputs branch
    (in training mode when ``train``), the frozen CAE's decoder over those
    latents, then the frozen full CAE over the gtruth branch, which gives
    the supervision targets.  The CAE runs in evaluation mode, and its
    gtruth branch under ``torch.no_grad()``: nothing of it reaches a
    trainable parameter."""
    enc_model.train(train)
    cae_model.eval()
    dto = cae_model.dec(enc_model(dto, BRANCH_INPUTS), BRANCH_INPUTS)
    with torch.no_grad():
        return cae_model(dto, BRANCH_GTRUTH)
