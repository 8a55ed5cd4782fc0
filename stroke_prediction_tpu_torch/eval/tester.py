"""Tester engine: per-case inference, metrics, NIfTI dumps (port of
eval/tester.py).  The model is rebuilt from the checkpoint's config header
and runs on the tester's device in inference mode."""

from __future__ import annotations

import time
from typing import List, Optional, Tuple, Union

import torch

from stroke_prediction_tpu_torch.data.dataset import KEY_CASE_ID
from stroke_prediction_tpu_torch.device import resolve_device
from stroke_prediction_tpu_torch.models.factory import load_model


class Tester:
    def __init__(self, dataloader, path_model: str,
                 path_outputs_base: str = "/tmp/",
                 device: Optional[Union[str, torch.device]] = None):
        if dataloader.batch_size != 1:
            raise ValueError("You must ensure a batch size of 1 for correct "
                             "case metric measures.")
        self._dataloader = dataloader
        self._path_outputs_base = path_outputs_base
        self.device = resolve_device(device)
        self._model, self._config = load_model(path_model, self.device)
        # (case id, seconds to metrics on the host, seconds incl. saving)
        self.case_seconds: List[Tuple[int, float, float]] = []

    def _fn(self, case_id, type_: str, suffix: str = "") -> str:
        return (self._path_outputs_base + "_" + str(case_id) + str(type_)
                + str(suffix) + ".nii.gz")

    def _case_index(self, case_id) -> Optional[int]:
        ds = self._dataloader.dataset
        for i in self._dataloader.indices:
            if ds.case_id(i) == case_id:
                return i
        return None

    def _to_device(self, array) -> Optional[torch.Tensor]:
        if array is None:
            return None
        return torch.as_tensor(array).to(self.device)

    # subclass hooks ----------------------------------------------------
    def infer_batch(self, batch):
        raise NotImplementedError

    def save_inference(self, out, batch):
        pass

    def print_inference(self, batch, metrics, out=None):
        pass

    def run_inference(self):
        for batch in self._dataloader:
            t0 = time.perf_counter()
            with torch.inference_mode():
                metrics, out = self.infer_batch(batch)
            t1 = time.perf_counter()
            self.save_inference(out, batch)
            self.print_inference(batch, metrics, out)
            self.case_seconds.append((int(batch[KEY_CASE_ID][0]), t1 - t0,
                                      time.perf_counter() - t0))
