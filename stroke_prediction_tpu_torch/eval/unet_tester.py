"""Per-case U-Net segmentation evaluation (port of eval/unet_tester.py):
full-volume inference on the held-out fold, per-case core/penumbra
measures, NIfTI dumps at 2x in-plane zoom with source affines, and the
per-case console line."""

from __future__ import annotations

import numpy as np
import torch

from stroke_prediction_tpu_torch.data.dataset import (
    KEY_CASE_ID, KEY_IMAGES, KEY_LABELS, LABEL_PENU)
from stroke_prediction_tpu_torch.eval.metrics import binary_measures_host
from stroke_prediction_tpu_torch.eval.tester import Tester
from stroke_prediction_tpu_torch.inference import unet_inference
from stroke_prediction_tpu_torch.utils.nifti import (
    dhw_to_xyz, save_nifti, zoom2x_inplane_xyz)


class UnetSegmentationTester(Tester):
    def __init__(self, dataloader, path_model, path_outputs_base="/tmp/",
                 padding=None, device=None):
        super().__init__(dataloader, path_model, path_outputs_base, device)
        self._pad = padding

    def infer_batch(self, batch):
        dto = unet_inference(self._model, self._to_device(batch[KEY_IMAGES]),
                             self._to_device(batch[KEY_LABELS]))
        gv, out = dto.given_variables, dto.outputs
        metrics = {
            "core": binary_measures_host(out.core, gv.core),
            "penu": binary_measures_host(out.penu, gv.penu),
        }
        seg = torch.cat([out.core, out.penu], dim=-1)
        return metrics, seg

    def _to_native(self, vol_dhw):
        """(D, H, W) -> unpadded (X, Y, Z) at native (2x) resolution."""
        xyz = dhw_to_xyz(vol_dhw)
        if self._pad is not None:
            px, py, pz = self._pad
            xyz = xyz[px:-px, py:-py, pz:-pz]
        return zoom2x_inplane_xyz(xyz)

    def save_inference(self, seg, batch, suffix=""):
        case_id = int(batch[KEY_CASE_ID][0])
        idx = self._case_index(case_id)
        affine = (self._dataloader.dataset.affine(idx, LABEL_PENU)
                  if idx is not None else None)
        seg_np = seg.cpu().numpy()
        save_nifti(self._fn(case_id, "_core", suffix),
                   self._to_native(seg_np[0, :, :, :, 0]), affine)
        save_nifti(self._fn(case_id, "_penu", suffix),
                   self._to_native(seg_np[0, :, :, :, 1]), affine)

    def print_inference(self, batch, metrics, out=None):
        print("Case Id {}:\t DC Core:{:.3},\tDC Penumbra:{:.3}".format(
            int(batch[KEY_CASE_ID][0]), metrics["core"].dc,
            metrics["penu"].dc))
