"""The training engine (port of train/learner.py).

The same epoch protocol as the JAX learner: adapt lr and beta1 -> train
pass -> validation pass -> on a new validation minimum save ``.model``,
``.optim`` and ``.json`` (the resume snapshot) -> the visual grid every 50
epochs and on an optimum -> the loss-curve plot from epoch 1 -> the final
model.  File
names ``<base><FNB_MARKS><suffix>.{model,optim,json,png}``; checkpoints in
the JAX package's formats, so a run can resume in either package.

Data on the device: each loader's cases are stacked on the device once, and
each batch is gathered there by row index in the order that the loader's
numpy RNG gives (the JAX learner's device cache and epoch plan).  A step is
plain eager PyTorch: forward, loss, backward, Adam; the per-step metrics
stay on the device until one fetch at the end of the epoch phase.

Data parallelism (``mesh``, a ``parallel.mesh.Mesh`` of one process per
card), as the JAX learner runs it on a ``data`` mesh: each step is the
one-process step on the global batch.  Every rank draws the same epoch
order and random crops from the shared seed and takes its rows of each
chunk by the row rule (``parallel.mesh.row_sharding``): a chunk that
divides over the ranks is sharded, and its BN moments, Dice sums, measures
and gradients are reduced over them (``parallel/collectives.py``); any
other chunk runs whole on every rank, with no collective.  A loader with
``process_shard`` (``--distributed``) takes the host path instead: each
process stacks only its share of a chunk on the host, and
``data.prefetch`` stages the next one on the card while a step runs.  Only
the lead process (rank 0) writes checkpoints, curves and PNGs and prints
the epoch and momentum lines; every rank loads a snapshot to resume.

Each training pass is timed from its start to that fetch
(``utils.profiling.StepTimer`` over the mesh's chips, the first pass left
out as warm-up, the global batch counted), and ``log_throughput`` prints
``[throughput] ... volumes/sec/chip`` before the epoch line.  Each step
runs in an ``annotate("train_step")`` / ``"eval_step"`` range, and
``profile_dir`` traces the second training pass (or the only one) with
``torch.profiler`` into that directory.

PNGs need matplotlib, imported when first needed; without it the learner
prints one line and writes no PNGs.  Nothing else depends on it.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from stroke_prediction_tpu_torch.data.dataset import (
    KEY_GLOBAL, KEY_IMAGES, KEY_LABELS)
from stroke_prediction_tpu_torch.data.prefetch import (
    DevicePut, prefetch_to_device)
from stroke_prediction_tpu_torch.device import resolve_device
from stroke_prediction_tpu_torch.models.convert import (
    adam_state_from_jax, adam_state_to_jax)
from stroke_prediction_tpu_torch.parallel.distributed import is_lead
from stroke_prediction_tpu_torch.parallel.mesh import (
    batch_sharding, row_sharding)
from stroke_prediction_tpu_torch.train.optim import (
    beta1_ramp, set_beta1, set_learning_rate)
from stroke_prediction_tpu_torch.utils import checkpoint as ckpt
from stroke_prediction_tpu_torch.utils.profiling import (
    StepTimer, annotate, trace)


class Learner:
    """Base class with the standard training routine."""

    FNB_MARKS = "_learner"
    FN_VIS_BASE = "_visual_"
    EXT_MODEL = ".model"
    EXT_OPTIM = ".optim"
    EXT_TRAIN = ".json"
    EXT_IMAGE = ".png"

    N_EPOCHS_ADAPT_BETA1: Optional[int] = None    # set by the CAE learners

    def __init__(self, dataloader_training, dataloader_validation, model,
                 optimizer, lr_schedule, n_epochs: int,
                 path_previous_base: Optional[str] = None,
                 path_outputs_base: str = "/tmp/stroke-prediction",
                 seed: int = 4, distances_on_training: bool = False,
                 log_throughput: bool = False,
                 profile_dir: Optional[str] = None, device=None, mesh=None):
        if dataloader_training.batch_size <= 1:
            raise ValueError("For normalization layers batch_size > 1 is "
                             "required.")
        self.device = resolve_device(device)
        self._dataloader_training = dataloader_training
        self._dataloader_validation = dataloader_validation
        self._model = model
        self._optimizer = optimizer
        # the ramp's end point: the optimizer's betas as it was built
        self._base_betas = tuple(optimizer.param_groups[0]["betas"])
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
        self._mesh = mesh
        self._no_plots_said = False
        self._metric_dtos: Dict[str, List[dict]] = {"training": [],
                                                    "validate": []}
        # steps run, by kind, and the training passes' (seconds, steps):
        # read by callers that count kernel launches or time steps
        self.step_counts = {"train": 0, "eval": 0, "visual": 0}
        self.train_pass_seconds: List[tuple] = []
        # pass-level timing: the first training pass is warm-up
        self._timer = StepTimer(warmup_steps=1,
                                n_chips=mesh.world if mesh else 1)
        self._log_throughput = log_throughput
        self._profile_dir = profile_dir

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

    def train_step(self, batch: Dict[str, torch.Tensor],
                   factor: float = 0.0) -> dict:
        """One optimizer step on a device batch at the epoch's
        :meth:`loss_factor`; returns 0-d metric tensors (still on the
        device)."""
        raise NotImplementedError

    def eval_step(self, batch: Dict[str, torch.Tensor],
                  factor: float = 0.0) -> dict:
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

    def adapt_betas(self, epoch):
        """The beta1 warm ramp over the first ``N_EPOCHS_ADAPT_BETA1``
        epochs; none unless that is set."""
        if self.N_EPOCHS_ADAPT_BETA1 is None:
            return
        b1 = beta1_ramp(self._base_betas[0], epoch, self.N_EPOCHS_ADAPT_BETA1)
        set_beta1(self._optimizer, b1)
        if epoch <= self.N_EPOCHS_ADAPT_BETA1 and is_lead():
            print("Momentum betas have been set to:",
                  (b1, self._base_betas[1]), end=" ")

    def loss_factor(self, epoch: int) -> float:
        """Curriculum weight of epoch-dependent loss terms (subclasses)."""
        return 0.0

    # --------------------------------------------------------- resume hooks

    def get_start_epoch(self) -> int:
        return len(self._metric_dtos["training"])

    def get_start_min_loss(self) -> float:
        losses = [m["loss"] for m in self._metric_dtos["validate"]
                  if m.get("loss") is not None]
        return min(losses) if losses else np.inf

    # ------------------------------------------------------------ persist

    def save_model(self, suffix: str = ""):
        if not is_lead():
            return
        ckpt.save_checkpoint(self.path("save", "model", suffix),
                             self.state_tree(), self.model_config())

    def load_model(self):
        state, _ = ckpt.load_checkpoint(self.path("load", "model"))
        self.load_state_tree(state)

    def save_training(self):
        if not is_lead():
            return
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

    def _batches(self, loader):
        """(sharding, device batch, global volumes) for each chunk of one
        epoch: from the device cache by the row rule, or, for a
        ``process_shard`` loader, this process's share staged from the
        host."""
        if loader.process_shard:
            sharding = batch_sharding(self._mesh)
            put = DevicePut(self.device, (KEY_IMAGES, KEY_LABELS, KEY_GLOBAL))
            for staged in prefetch_to_device(loader, put):
                batch = staged.wait()
                yield (sharding, batch,
                       sharding.global_size(len(batch[KEY_IMAGES])))
            return
        data, rowmap = self.device_data(loader)
        for chunk in loader.epoch_chunks():
            sharding = row_sharding(self._mesh, len(chunk))
            rows = torch.tensor([rowmap[i] for i in sharding.take(chunk)],
                                dtype=torch.int64, device=self.device)
            batch = {k: (None if v is None else v.index_select(0, rows))
                     for k, v in data.items()}
            yield sharding, batch, len(chunk)

    def _run_epoch(self, loader, epoch: int, training: bool) -> dict:
        factor = self.loss_factor(epoch)
        phase = "train_step" if training else "eval_step"
        step = self.train_step if training else self.eval_step
        t0 = time.perf_counter()
        if training:
            self._timer.start()
        results, n_volumes = [], 0
        for sharding, batch, n in self._batches(loader):
            with annotate(phase), sharding.active():
                results.append(step(batch, factor))
            n_volumes += n
        # ONE device -> host fetch per epoch phase
        keys = sorted(results[0]) if results else []
        host = (torch.stack([torch.stack([m[k].float() for k in keys])
                             for m in results]).cpu().tolist()
                if results else [])
        if training:
            self.train_pass_seconds.append((time.perf_counter() - t0,
                                            len(results)))
            self._timer.stop(n_volumes)
            if self._log_throughput:
                print(f"[throughput] {self._timer.summary()}", end=" ")
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
            self.adapt_betas(epoch)

            # trace the second training pass (the first holds the kernel
            # build and warm-up), or the only one
            trace_epoch = min(self.get_start_epoch() + 1, self._n_epochs - 1)
            with (trace(self._profile_dir) if self._profile_dir is not None
                  and epoch == trace_epoch else contextlib.nullcontext()):
                m_train = self._run_epoch(self._dataloader_training, epoch,
                                          training=True)
            lead = is_lead()
            if lead:
                self.print_epoch(epoch, "training", m_train)
            self._metric_dtos["training"].append(m_train)

            if self._dataloader_validation is None:
                m_valid = {"loss": 0.0}
            else:
                m_valid = self._run_epoch(self._dataloader_validation,
                                          epoch, training=False)
            if lead:
                self.print_epoch(epoch, "validate", m_valid)
            self._metric_dtos["validate"].append(m_valid)

            if m_valid.get("loss") is not None and m_valid["loss"] < min_loss:
                min_loss = m_valid["loss"]
                self.save_model()
                self.save_training()
                if lead:
                    print("(New optimum: Training saved)", end=" ")
                    self.visualize_epoch(epoch)

            if epoch % 50 == 0 and lead:
                self.visualize_epoch(epoch)

            if epoch > 0 and lead:
                self._plot_curves(epoch)

        self.save_model("_final")
        if is_lead():
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
