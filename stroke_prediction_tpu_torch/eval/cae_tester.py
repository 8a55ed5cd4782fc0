"""Per-case CAE reconstruction evaluation and the counterfactual
time-to-treatment curves (port of eval/cae_tester.py).

* :class:`CaeReconstructionTester` — per case: encode core, penumbra and
  lesion masks, interpolate the core and penumbra latents at the case's
  normalized time to treatment, decode all four; lesion measures of the
  interpolation against the follow-up lesion, Dice of the core and
  penumbra reconstructions; NIfTI dumps ``_core`` / ``_pred`` / ``_penu`` at
  2x in-plane zoom with the source affines; the reference's console line.
* :class:`CaeReconstructionTesterCurve` — the lesion measures over four
  sweeps of counterfactual tA -> tR times: the ground truth, fixed hours,
  multiples of the case's tA -> tR, and uniform steps between recanalization
  and the penumbra assumption.

A sweep is one batched forward whose batch axis holds the step values: the
core and penumbra are encoded and decoded once, their latents interpolated
at every step, and the interpolations decoded as one batch and measured
with one EDT call a direction (``binary_measures_per_sample``).
"""

from __future__ import annotations

import time
from dataclasses import replace
from typing import Optional, Sequence

import numpy as np
import torch

from stroke_prediction_tpu_torch.core.dto import BinaryMeasures
from stroke_prediction_tpu_torch.data.dataset import (
    KEY_CASE_ID, KEY_GLOBAL, KEY_LABELS, LABEL_CORE, LABEL_LESION,
    LABEL_PENU)
from stroke_prediction_tpu_torch.eval.metrics import (
    binary_measures_host, binary_measures_per_sample)
from stroke_prediction_tpu_torch.eval.tester import Tester
from stroke_prediction_tpu_torch.inference import (
    cae_dto_from_batch, cae_inference, normalization_hours)
from stroke_prediction_tpu_torch.utils.nifti import (
    dhw_to_xyz, save_nifti, zoom2x_inplane_xyz)


class CaeReconstructionTester(Tester):
    def __init__(self, dataloader, path_model, path_outputs_base="/tmp/",
                 normalization_hours_penumbra: float = 10, device=None):
        super().__init__(dataloader, path_model, path_outputs_base, device)
        self._norm_hours = normalization_hours_penumbra

    def _inputs(self, batch):
        return (self._to_device(batch[KEY_LABELS]),
                self._to_device(batch[KEY_GLOBAL]))

    def infer_batch(self, batch, step: Optional[float] = None):
        """The case at the step of ``step`` hours tA -> tR, or at its own
        (ground-truth) tA -> tR for ``step`` None -> (metrics, dto)."""
        labels, clinical = self._inputs(batch)
        dto = cae_inference(self._model, cae_dto_from_batch(
            None, labels, clinical, step, self._norm_hours))
        rec, gt = dto.reconstructions.gtruth, dto.given_variables.gtruth
        metrics = {
            "lesion": binary_measures_host(rec.interpolation, gt.lesion),
            "core": binary_measures_host(rec.core, gt.core),
            "penu": binary_measures_host(rec.penu, gt.penu),
        }
        return metrics, dto

    def infer_batch_steps(self, batch, steps_hours: Sequence[float]):
        """The lesion measures at each of ``steps_hours`` from one batched
        forward -> (list of BinaryMeasures, dto).  The dto's gtruth
        interpolation latents and reconstructions hold one sample a step;
        its core and penumbra, one."""
        labels, clinical = self._inputs(batch)
        dto = cae_dto_from_batch(None, labels, clinical, steps_hours,
                                 self._norm_hours)
        gt = dto.given_variables.gtruth
        # the follow-up lesion is measured, not encoded
        dto = cae_inference(self._model, replace(dto, given_variables=replace(
            dto.given_variables, gtruth=replace(gt, lesion=None))))
        interp = dto.reconstructions.gtruth.interpolation
        m = binary_measures_per_sample(interp,
                                       gt.lesion.expand_as(interp))
        fields = torch.stack([m.dc, m.hd, m.assd, m.precision,
                              m.sensitivity, m.specificity], 1).tolist()
        return [BinaryMeasures(*row) for row in fields], dto

    def save_inference(self, dto, batch, suffix=""):
        case_id = int(batch[KEY_CASE_ID][0])
        idx = self._case_index(case_id)
        rec = dto.reconstructions.gtruth

        def dump(vol, type_, affine_suffix):
            affine = (self._dataloader.dataset.affine(idx, affine_suffix)
                      if idx is not None else None)
            xyz = zoom2x_inplane_xyz(dhw_to_xyz(vol[0, ..., 0].cpu().numpy()))
            save_nifti(self._fn(case_id, type_, suffix), xyz, affine)

        dump(rec.core, "_core", LABEL_CORE)
        dump(rec.interpolation, "_pred", LABEL_LESION)
        dump(rec.penu, "_penu", LABEL_PENU)

    def print_inference(self, batch, metrics, dto=None, note="", ttt=None):
        clinical = np.asarray(batch[KEY_GLOBAL])[0]
        if ttt is None:
            ttt = (float(dto.given_variables.time_to_treatment[0, 0])
                   if dto is not None else float("nan"))
        lesion = metrics["lesion"]
        print("Case Id={}\ttA-tO={:.3f}\ttR-tA={:.3f}\t"
              "normalized_time_to_treatment={:.3f}\t-->\tDC={:.3f}\t"
              "HD={:.3f}\tASSD={:.3f}\tDC Core={:.3f}\tDC Penumbra={:.3f}\t"
              "Precision={:.3}\tRecall/Sensitivity={:.3}\tSpecificity={:.3}\t"
              "DistToCornerPRC={:.3}\t{}".format(
                  int(batch[KEY_CASE_ID][0]), clinical[0], clinical[1], ttt,
                  lesion.dc, lesion.hd, lesion.assd, metrics["core"].dc,
                  metrics["penu"].dc, lesion.precision, lesion.sensitivity,
                  lesion.specificity, lesion.prc_euclidean_distance, note))


class CaeReconstructionTesterCurve(CaeReconstructionTester):
    def __init__(self, dataloader, path_model, path_outputs_base="/tmp/",
                 normalization_hours_penumbra: float = 10,
                 ta_to_tr_fixed_hours: Sequence[float] = tuple(range(11)),
                 ta_to_tr_relative_steps: Sequence[float] = (
                     0, 0.25, 0.5, 0.75, 1, 1.25, 1.5, 1.75, 2),
                 device=None):
        super().__init__(dataloader, path_model, path_outputs_base,
                         normalization_hours_penumbra, device)
        self._steps_fixed = list(ta_to_tr_fixed_hours)
        self._steps_relative = list(ta_to_tr_relative_steps)

    def sweeps(self, batch):
        """The case's normalization (hours) and its three counterfactual
        sweeps, each a (step hours, console notes) pair: fixed tA -> tR
        hours, multiples of the case's tA -> tR, and uniform [0, 1] steps
        between recanalization and the penumbra assumption."""
        clinical = np.asarray(batch[KEY_GLOBAL], np.float64)
        norm = float(normalization_hours(clinical, self._norm_hours)[0, 0])
        ta_to_tr = float(clinical[0, 1])
        uni = [i / 10.0 for i in range(11)]
        return norm, [
            ([float(s) for s in self._steps_fixed],
             ["ta_to_tr fixed=" + str(s) for s in self._steps_fixed]),
            ([s * ta_to_tr for s in self._steps_relative],
             ["ta_to_tr ratio=" + str(s) + "\t(" + str(s * ta_to_tr) + ")"
              for s in self._steps_relative]),
            ([s * norm for s in uni],
             ["tr_to_penumbra=" + str(s) + "\t(" + str(s * norm) + ")"
              for s in uni])]

    def run_inference(self):
        for batch in self._dataloader:
            # the ground-truth tA -> tR, which also gives the
            # step-independent core / penumbra measures of the sweeps
            t0 = time.perf_counter()
            with torch.inference_mode():
                m_gt, dto = self.infer_batch(batch, None)
            t1 = time.perf_counter()
            self.print_inference(batch, m_gt, dto)
            self.save_inference(dto, batch)

            norm, sweeps = self.sweeps(batch)
            for steps_hours, notes in sweeps:
                with torch.inference_mode():
                    lesions, _ = self.infer_batch_steps(batch, steps_hours)
                for lesion, hours, note in zip(lesions, steps_hours, notes):
                    self.print_inference(batch, {"lesion": lesion,
                                                 "core": m_gt["core"],
                                                 "penu": m_gt["penu"]},
                                         None, note, ttt=hours / norm)
            self.case_seconds.append((int(batch[KEY_CASE_ID][0]), t1 - t0,
                                      time.perf_counter() - t0))
