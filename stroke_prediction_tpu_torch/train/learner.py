"""The training engine (port of train/learner.py).

The same epoch protocol as the JAX learner: adapt lr -> train pass ->
validation pass -> on a new validation minimum save ``.model``, ``.optim``
and ``.json`` (the resume snapshot) -> the visual grid every 50 epochs and on
an optimum -> the loss-curve plot from epoch 1 -> the final model.  File
names ``<base><FNB_MARKS><suffix>.{model,optim,json,png}``; checkpoints in
the JAX package's formats, so a run can resume in either package.

Data on the device: each loader's cases are stacked on the device once, and
each batch is gathered there by row index in the order that the loader's
numpy RNG gives (the JAX learner's device cache and epoch plan).  A step is
plain eager PyTorch: forward, loss, backward, Adam; the per-step metrics
stay on the device until one fetch at the end of the epoch phase.

PNGs need matplotlib, imported when first needed; without it the learner
prints one line and writes no PNGs.  Nothing else depends on it.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from stroke_prediction_tpu_torch.data.dataset import (
    KEY_GLOBAL, KEY_IMAGES, KEY_LABELS)
from stroke_prediction_tpu_torch.device import resolve_device
from stroke_prediction_tpu_torch.models.convert import (
    adam_state_from_jax, adam_state_to_jax)
from stroke_prediction_tpu_torch.train.optim import set_learning_rate
from stroke_prediction_tpu_torch.utils import checkpoint as ckpt


class Learner:
    """Base class with the standard training routine."""

    FNB_MARKS = "_learner"
    FN_VIS_BASE = "_visual_"
    EXT_MODEL = ".model"
    EXT_OPTIM = ".optim"
    EXT_TRAIN = ".json"
    EXT_IMAGE = ".png"

    def __init__(self, dataloader_training, dataloader_validation, model,
                 optimizer, lr_schedule, n_epochs: int,
                 path_previous_base: Optional[str] = None,
                 path_outputs_base: str = "/tmp/stroke-prediction",
                 seed: int = 4, distances_on_training: bool = False,
                 device=None):
        if dataloader_training.batch_size <= 1:
            raise ValueError("For normalization layers batch_size > 1 is "
                             "required.")
        self.device = resolve_device(device)
        self._dataloader_training = dataloader_training
        self._dataloader_validation = dataloader_validation
        self._model = model
        self._optimizer = optimizer
        self._lr_schedule = lr_schedule
        self._n_epochs = n_epochs
        self._path_outputs_base = path_outputs_base
        self._path_previous_base = path_previous_base
        # HD/ASSD on validation batches always, on training batches too
        # when set (``--distances``)
        self._distances_on_training = distances_on_training
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        self._dev_data: Dict[Any, tuple] = {}
        self._no_plots_said = False
        self._metric_dtos: Dict[str, List[dict]] = {"training": [],
                                                    "validate": []}
        # steps run, by kind, and the training passes' (seconds, steps):
        # read by callers that count kernel launches or time steps
        self.step_counts = {"train": 0, "eval": 0, "visual": 0}
        self.train_pass_seconds: List[tuple] = []

        if path_previous_base is not None:
            self.load_model()
            self.load_training()
            print("Continue training", path_previous_base, "...")
        if len(self._metric_dtos["training"]) != len(
                self._metric_dtos["validate"]):
            raise ValueError("Incomplete training data!")

    # ---------------------------------------------------------------- paths

    def path(self, mode: str, type_: str, suffix: str = "") -> Optional[str]:
        base = {"load": self._path_previous_base,
                "save": self._path_outputs_base}.get(mode)
        if base is None:
            return None
        ext = {"model": self.EXT_MODEL, "optim": self.EXT_OPTIM,
               "train": self.EXT_TRAIN, "plots": self.EXT_IMAGE,
               "image": self.EXT_IMAGE}.get(type_)
        if ext is None:
            return None
        return base + self.FNB_MARKS + suffix + ext

    def _with_distances(self, training: bool) -> bool:
        return not training or self._distances_on_training

    # ------------------------------------------------------- subclass hooks

    def train_step(self, batch: Dict[str, torch.Tensor]) -> dict:
        """One optimizer step on a device batch; returns 0-d metric
        tensors (still on the device)."""
        raise NotImplementedError

    def eval_step(self, batch: Dict[str, torch.Tensor]) -> dict:
        raise NotImplementedError

    def model_config(self) -> Dict[str, Any]:
        return {}

    def state_tree(self) -> Dict[str, Any]:
        """The model's flax variable tree (numpy leaves) for ``.model``."""
        raise NotImplementedError

    def load_state_tree(self, state: Dict[str, Any]) -> None:
        raise NotImplementedError

    def print_epoch(self, epoch, phase, m: dict):
        pass

    def plot_epoch(self, plot, epochs):
        pass

    def visualize_epoch(self, epoch):
        pass

    # ------------------------------------------------------------ schedules

    def adapt_lr(self, epoch):
        """MultiStepLR step at epoch start."""
        if self._lr_schedule is not None:
            set_learning_rate(self._optimizer, self._lr_schedule(epoch))

    # --------------------------------------------------------- resume hooks

    def get_start_epoch(self) -> int:
        return len(self._metric_dtos["training"])

    def get_start_min_loss(self) -> float:
        losses = [m["loss"] for m in self._metric_dtos["validate"]
                  if m.get("loss") is not None]
        return min(losses) if losses else np.inf

    # ------------------------------------------------------------ persist

    def save_model(self, suffix: str = ""):
        ckpt.save_checkpoint(self.path("save", "model", suffix),
                             self.state_tree(), self.model_config())

    def load_model(self):
        state, _ = ckpt.load_checkpoint(self.path("load", "model"))
        self.load_state_tree(state)

    def save_training(self):
        ckpt.save_checkpoint(
            self.path("save", "optim"),
            {"opt_state": adam_state_to_jax(self._optimizer, self._model)})
        ckpt.save_curves(self.path("save", "train"), self._metric_dtos)

    def load_training(self):
        path_t = self.path("load", "train")
        path_o = self.path("load", "optim")
        print("Loading:", path_t, path_o)
        opt, _ = ckpt.load_checkpoint(path_o)
        self._optimizer.load_state_dict(adam_state_from_jax(
            opt["opt_state"], self._model, self._optimizer))
        self._metric_dtos = ckpt.load_curves(path_t)

    # ------------------------------------------------------------ the loop

    def device_data(self, loader):
        """The loader's cases stacked on the device once: (arrays,
        dataset index -> row)."""
        key = (id(loader.dataset), tuple(loader.indices))
        entry = self._dev_data.get(key)
        if entry is None:
            stack = loader.dataset.stack(loader.indices)
            data = {k: (None if stack.get(k) is None else
                        torch.from_numpy(stack[k]).to(self.device))
                    for k in (KEY_IMAGES, KEY_LABELS, KEY_GLOBAL)}
            rowmap = {idx: row for row, idx in enumerate(loader.indices)}
            entry = (data, rowmap)
            self._dev_data[key] = entry
        return entry

    def _run_epoch(self, loader, epoch: int, training: bool) -> dict:
        data, rowmap = self.device_data(loader)
        rows = [torch.tensor([rowmap[i] for i in chunk], dtype=torch.int64,
                             device=self.device)
                for chunk in loader.epoch_chunks()]
        t0 = time.perf_counter()
        results = []
        for r in rows:
            batch = {k: (None if v is None else v.index_select(0, r))
                     for k, v in data.items()}
            results.append(self.train_step(batch) if training
                           else self.eval_step(batch))
        # ONE device -> host fetch per epoch phase
        keys = sorted(results[0]) if results else []
        host = (torch.stack([torch.stack([m[k].float() for k in keys])
                             for m in results]).cpu().tolist()
                if results else [])
        if training:
            self.train_pass_seconds.append((time.perf_counter() - t0,
                                            len(rows)))
        # accumulate like MeasuresDto.add (inf propagates through +=),
        # divide like MeasuresDto.div (inf kept as-is)
        accum: Dict[str, float] = {}
        for vals in host:
            for k, v in zip(keys, vals):
                accum[k] = accum.get(k, 0.0) + float(v)
        count = max(len(host), 1)
        return {k: (v / count if np.isfinite(v) else v)
                for k, v in accum.items()}

    def run_training(self):
        min_loss = self.get_start_min_loss()
        epoch = self.get_start_epoch()
        for epoch in range(self.get_start_epoch(), self._n_epochs):
            self.adapt_lr(epoch)

            m_train = self._run_epoch(self._dataloader_training, epoch,
                                      training=True)
            self.print_epoch(epoch, "training", m_train)
            self._metric_dtos["training"].append(m_train)

            if self._dataloader_validation is None:
                m_valid = {"loss": 0.0}
            else:
                m_valid = self._run_epoch(self._dataloader_validation,
                                          epoch, training=False)
            self.print_epoch(epoch, "validate", m_valid)
            self._metric_dtos["validate"].append(m_valid)

            if m_valid.get("loss") is not None and m_valid["loss"] < min_loss:
                min_loss = m_valid["loss"]
                self.save_model()
                self.save_training()
                print("(New optimum: Training saved)", end=" ")
                self.visualize_epoch(epoch)

            if epoch % 50 == 0:
                self.visualize_epoch(epoch)

            if epoch > 0:
                self._plot_curves(epoch)

        self.save_model("_final")
        self.visualize_epoch(epoch)

    # ------------------------------------------------------------- plots

    def pyplot(self):
        """matplotlib.pyplot (Agg), or None after saying once that no PNGs
        are written."""
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            if not self._no_plots_said:
                print("matplotlib is not installed: no PNGs are written")
                self._no_plots_said = True
            return None
        return plt

    def _plot_curves(self, epoch):
        plt = self.pyplot()
        if plt is None:
            return
        fig, plot = plt.subplots()
        try:
            self.plot_epoch(plot, range(1, epoch + 2))
            fig.savefig(self._path_outputs_base + self.FN_VIS_BASE
                        + "plots.png", bbox_inches="tight", dpi=300)
        finally:
            plt.close(fig)
