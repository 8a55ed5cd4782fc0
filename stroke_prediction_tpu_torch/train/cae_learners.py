"""The CAE learners (port of train/cae_learners.py): phase-1 shape-space
reconstruction (``CaeReconstructionLearner``), step learning on a frozen
phase-1 CAE (``CaeStepLearner``) and phase-2 prediction against a frozen
phase-1 CAE (``CaePredictionLearner``).

Phase 1, per training step: a random hemispheric flip and an elastic
deformation of the labels (data/augment.py, from the learner's device
generator), the CAE in training mode over the gtruth branch (three encodes,
the latent interpolation at the case's time to treatment, four decodes),
and the curriculum loss

    (hinge(penu - interp) + hinge(penu - core) + Dice(core) + Dice(penu)
     + Dice(lesion) + factor * mean|z_interp - z_lesion|) / (5 + factor),

``factor = min(0.04 * max(0, epoch - 25), 1)``, then backward and Adam with
the beta1 ramp over the first four epochs.  Validation steps run the CAE in
evaluation mode on the unaugmented batch.  Per step the measures of the
interpolation against the lesion and of the core and penumbra
reconstructions, HD / ASSD on validation steps.  Console line, loss curve
and the 6-sample x 15-panel time-sweep grid as in the JAX learner.

The CTP learner (``inputs_from_images``, an ``Enc3DCtp`` CAE): the same
step with the padded CBV and TTD images in the inputs branch, which the
encoder concatenates with each mask; the images are flipped with the labels
and not deformed.

Step learning: the same step on an ``Enc3DStep`` CAE whose step head
regresses the interpolation step from the clinical vector (in training and
validation; the grid's fixed hours give it), loss
``(hinge(penu - interp) + Dice(interp, lesion)) / 2``; the CLI freezes all
but the head (``train.optim.trainable_by_path``), and the whole CAE runs in
training mode, so the frozen trunk's BN statistics move.

Phase 2: a new encoder over the inputs branch (the U-Net segmentations,
flipped and deformed with the labels), the frozen CAE's decoder over its
latents and the frozen CAE over the gtruth branch, both in evaluation mode
(``inference.cae_enc_inference``); loss ``(hinge(penu_in - interp_in) +
hinge(penu_in - core_in) + Dice(interp_in, lesion) + the three latents'
mean |z_gt - z_in|) / 6``, no beta1 ramp; the frozen CAE is saved under the
main name, the encoder under ``_enc``.  Its measures are the frozen CAE's
gtruth-branch reconstructions', as the JAX learner's are.

Data parallelism (the base learner's ``mesh``): in a sharded step the flip
masks and displacement fields are drawn for the global batch and each rank
takes its rows' (``data/augment.py``); the loss is that of the global
batch (BN's moments, the Dice sums, the hinges' and the latent L1 terms'
means, ``parallel.collectives.global_mean``), every rank reports it, the
gradients are averaged over the ranks after backward, and the measures are
the global batch's.  Only the lead rank writes (phase 2's frozen CAE and
encoder too).
"""

from __future__ import annotations

import numpy as np
import torch

from stroke_prediction_tpu_torch.data.augment import (
    random_cae_augment, random_cae_augment_ctp, random_cae_augment_images)
from stroke_prediction_tpu_torch.data.dataset import (
    KEY_GLOBAL, KEY_IMAGES, KEY_LABELS)
from stroke_prediction_tpu_torch.eval.metrics import (
    batch_dice_loss, binary_measures, monotonicity_hinge)
from stroke_prediction_tpu_torch.inference import (
    IMSHOW_VMAX_CBV, IMSHOW_VMAX_TTD, cae_dto_from_batch, cae_enc_inference)
from stroke_prediction_tpu_torch.models.convert import (
    state_from_jax, state_to_jax)
from stroke_prediction_tpu_torch.parallel.collectives import (
    average_gradients, global_mean)
from stroke_prediction_tpu_torch.parallel.distributed import is_lead
from stroke_prediction_tpu_torch.train.learner import Learner
from stroke_prediction_tpu_torch.train.unet_learner import _measures_dict
from stroke_prediction_tpu_torch.utils import checkpoint as ckpt


def _with_scalar(fn, x: torch.Tensor, factor) -> torch.Tensor:
    """``fn(x, factor)`` as torch computes it for a Python number
    ``factor``, also where ``factor`` is a 0-d float64 tensor (the planned
    pass's loss factor, which a captured step reads on the device): in
    x's computation type (float32 for bfloat16), the result in x's type."""
    if not isinstance(factor, torch.Tensor):
        return fn(x, factor)
    op = torch.promote_types(x.dtype, torch.float32)
    return fn(x.to(op), factor.to(op)).to(x.dtype)


def cae_loss(dto, factor) -> torch.Tensor:
    """The phase-1 loss of a gtruth-branch CAE output at curriculum
    ``factor`` (a number, or the planned pass's device tensor)."""
    rec, gt = dto.reconstructions.gtruth, dto.given_variables.gtruth
    loss = monotonicity_hinge(rec.penu - rec.interpolation)
    loss = loss + monotonicity_hinge(rec.penu - rec.core)
    loss = loss + batch_dice_loss(rec.core, gt.core)
    loss = loss + batch_dice_loss(rec.penu, gt.penu)
    loss = loss + batch_dice_loss(rec.lesion, gt.lesion)
    lat = dto.latents.gtruth
    loss = loss + _with_scalar(torch.mul, global_mean(torch.abs(
        lat.interpolation - lat.lesion)), factor)
    return _with_scalar(torch.div, loss, 5.0 + factor)


def step_loss(dto) -> torch.Tensor:
    """The step learner's loss of a gtruth-branch CAE output."""
    rec, gt = dto.reconstructions.gtruth, dto.given_variables.gtruth
    loss = monotonicity_hinge(rec.penu - rec.interpolation)
    loss = loss + batch_dice_loss(rec.interpolation, gt.lesion)
    return loss / 2.0


def prediction_loss(dto) -> torch.Tensor:
    """Phase 2's loss: the inputs branch's reconstructions and latents
    against the frozen CAE's gtruth branch."""
    rec_in, gt = dto.reconstructions.inputs, dto.given_variables.gtruth
    lat_gt, lat_in = dto.latents.gtruth, dto.latents.inputs
    loss = monotonicity_hinge(rec_in.penu - rec_in.interpolation)
    loss = loss + monotonicity_hinge(rec_in.penu - rec_in.core)
    loss = loss + batch_dice_loss(rec_in.interpolation, gt.lesion)
    for name in ("interpolation", "core", "penu"):
        loss = loss + global_mean(torch.abs(getattr(lat_gt, name)
                                            - getattr(lat_in, name)))
    return loss / 6.0


class CaeReconstructionLearner(Learner):

    FNB_MARKS = "_cae1"
    FN_VIS_BASE = "_cae1_"
    N_EPOCHS_ADAPT_BETA1 = 4
    # the grid's columns: the case's own time, then fixed tA -> tR hours
    VIS_STEPS = (None, -10, -1, 0, 1, 2, 3, 4, 5, 20)

    def __init__(self, dataloader_training, dataloader_validation, cae_model,
                 optimizer, lr_schedule, n_epochs,
                 normalization_hours_penumbra: float = 10,
                 inputs_from_images: bool = False, **kw):
        self._norm_hours = normalization_hours_penumbra
        self._inputs_from_images = inputs_from_images
        super().__init__(dataloader_training, dataloader_validation,
                         cae_model, optimizer, lr_schedule, n_epochs, **kw)

    def model_config(self) -> dict:
        """The true encoder class: ``--steplearning`` trains an Enc3DStep
        under this learner, and its checkpoint reloads with its head."""
        return self._model.config

    def state_tree(self) -> dict:
        """The trained model's tree (phase 2: the encoder's)."""
        return state_to_jax(self._model.state_dict(), self._model.config)

    def load_state_tree(self, state) -> None:
        self._model.load_state_dict(state_from_jax(state,
                                                   self._model.config))

    def loss_factor(self, epoch: int) -> float:
        return min(0.04 * max(0, epoch - 25), 1)

    # ------------------------------------------------------------ stepping

    def make_dto(self, labels, clinical, step=None, images=None):
        """The step is the case's time to treatment, or fixed ``step``
        hours; ``images`` fill the inputs branch with
        ``inputs_from_images`` (the CTP encoder's CBV and TTD)."""
        return cae_dto_from_batch(
            images if self._inputs_from_images else None, labels, clinical,
            step, self._norm_hours,
            inputs_from_images=self._inputs_from_images)

    def augment(self, batch):
        """The training batch with its labels after the random flip and
        elastic deformation, and with ``inputs_from_images`` its images
        flipped by the same mask."""
        if self._inputs_from_images:
            images, labels = random_cae_augment_ctp(
                self._generator, batch[KEY_IMAGES], batch[KEY_LABELS])
            return dict(batch, **{KEY_IMAGES: images, KEY_LABELS: labels})
        return dict(batch, **{KEY_LABELS: random_cae_augment(
            self._generator, batch[KEY_LABELS])})

    def forward(self, dto):
        return self._model(dto)

    def loss(self, dto, factor: float) -> torch.Tensor:
        return cae_loss(dto, factor)

    def forward_loss(self, batch, factor: float):
        dto = self.forward(self.make_dto(batch[KEY_LABELS], batch[KEY_GLOBAL],
                                         images=batch.get(KEY_IMAGES)))
        return self.loss(dto, factor), dto

    def _metrics(self, loss, dto, training: bool) -> dict:
        wd = self._with_distances(training)
        rec, gt = dto.reconstructions.gtruth, dto.given_variables.gtruth
        out = {"loss": loss.detach()}
        for name, got, want in (("lesion", rec.interpolation, gt.lesion),
                                ("core", rec.core, gt.core),
                                ("penu", rec.penu, gt.penu)):
            out.update(_measures_dict(name, binary_measures(
                got.detach(), want, with_distances=wd)))
        return out

    def train_step(self, batch, factor: float = 0.0):
        batch = self.augment(batch)
        self._model.train()
        loss, dto = self.forward_loss(batch, factor)
        self._optimizer.zero_grad(set_to_none=True)
        # cuDNN reads its TF32 and determinism flags when the stride-2 and
        # transposed convs' backward runs: float32 stays float32 there as in
        # their forward, and the algorithms are the deterministic ones
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False,
                                        deterministic=True):
            loss.backward()
        # a trainable parameter off the loss's path (Enc3DStep's head when
        # the time is given) gets a zero gradient, as jax.grad gives it, so
        # that Adam's L2 term moves it as optax does; after it, every rank
        # averages the same tensors
        for p in self._model.parameters():
            if p.requires_grad and p.grad is None:
                p.grad = torch.zeros_like(p)
        average_gradients(self._model.parameters())
        self._optimizer.step()
        self.step_counts["train"] += 1
        with torch.no_grad():
            return self._metrics(loss, dto, training=True)

    def eval_step(self, batch, factor: float = 0.0):
        self._model.eval()
        with torch.no_grad():
            loss, dto = self.forward_loss(batch, factor)
            self.step_counts["eval"] += 1
            return self._metrics(loss, dto, training=False)

    # --------------------------------------------------------- reporting

    def print_epoch(self, epoch, phase, m):
        print("\nEpoch {}/{} {} loss: {:.3} - DC:{:.3}, HD:{:.3}, ASSD:{:.3},"
              " DC core:{:.3}, DC penu.:{:.3}".format(
                  epoch + 1, self._n_epochs, phase, m.get("loss", 0.0),
                  m.get("lesion_dc", 0.0), m.get("lesion_hd", np.inf),
                  m.get("lesion_assd", np.inf), m.get("core_dc", 0.0),
                  m.get("penu_dc", 0.0)), end=" ")

    def plot_epoch(self, plot, epochs):
        tr, va = self._metric_dtos["training"], self._metric_dtos["validate"]
        plot.plot(epochs, [m["loss"] for m in tr], "r-")
        plot.plot(epochs, [m["loss"] for m in va], "g-")
        plot.plot(epochs, [m.get("lesion_dc", 0) for m in va], "k-")
        plot.plot(epochs, [m.get("core_dc", 0) for m in va], "c+")
        plot.plot(epochs, [m.get("penu_dc", 0) for m in va], "m+")
        plot.set_ylabel("L Train.(red)/Val.(green) | "
                        "Dice Val. Lesion(b), Core(c), Penu(m)")
        plot.set_ylim(0, 1)
        ax2 = plot.twinx()
        ax2.plot(epochs, [min(m.get("lesion_assd", np.inf), 1e3)
                          for m in va], "b-")
        ax2.set_ylabel("Validation ASSD (blue)", color="b")
        ax2.tick_params("y", colors="b")

    def _vis_reconstructions(self, batch):
        """The gtruth branch's interpolation reconstruction of a one-case
        batch at each of ``VIS_STEPS``, (10, D, H, W): one forward at the
        case's own time (the step learner's: its head's), one for the fixed
        hours decoded as one batch."""
        labels, clinical = batch[KEY_LABELS], batch[KEY_GLOBAL]
        images = batch.get(KEY_IMAGES)
        self._model.eval()
        with torch.no_grad():
            own = self.forward(self.make_dto(labels, clinical, images=images))
            fixed = self.forward(self.make_dto(
                labels, clinical, list(self.VIS_STEPS[1:]), images))
        self.step_counts["visual"] += 2
        return torch.cat([own.reconstructions.gtruth.interpolation,
                          fixed.reconstructions.gtruth.interpolation])[..., 0]

    def visualize_epoch(self, epoch):
        """6-sample x 15-panel grid: CBV, TTD, lesion, p(own time), core, p
        at -10, -1, 0, 1, 2, 3, 4, 5, 20 h, penumbra."""
        plt = self.pyplot()
        if plt is None:
            return
        samples = self._vis_samples()
        if not samples:
            return
        f, axarr = plt.subplots(max(len(samples), 2), 15)
        for inc, sample in enumerate(samples):
            batch = {k: (None if sample.get(k) is None else torch.from_numpy(
                sample[k][None]).to(self.device))
                     for k in (KEY_IMAGES, KEY_LABELS, KEY_GLOBAL)}
            rec = self._vis_reconstructions(batch).cpu().numpy()
            zs = min(rec.shape[1] - 1, 14)
            for col, r in zip((3,) + tuple(range(5, 14)), rec):
                axarr[inc, col].imshow(r[zs], vmin=0, vmax=1, cmap="gray")
            imgs, labs = sample.get(KEY_IMAGES), sample[KEY_LABELS]
            zs = min(labs.shape[0] - 1, 14)
            if imgs is not None:
                axarr[inc, 0].imshow(imgs[zs, :, :, 0], vmin=0,
                                     vmax=IMSHOW_VMAX_CBV, cmap="jet")
                axarr[inc, 1].imshow(imgs[zs, :, :, 1], vmin=0,
                                     vmax=IMSHOW_VMAX_TTD, cmap="jet")
            for col, ch in ((2, 2), (4, 0), (14, 1)):
                axarr[inc, col].imshow(labs[zs, :, :, ch], vmin=0, vmax=1,
                                       cmap="gray")
            time = float(sample[KEY_GLOBAL][1])
            titles = ["CBV", "TTD", "Lesion", "p({:03.1f}h)".format(time),
                      "Core", "p(-10h)", "p(-1h)", "p(0h)", "p(1h)", "p(2h)",
                      "p(3h)", "p(4h)", "p(5h)", "p(20h)", "Penumbra"]
            for ax, title in zip(axarr[inc], titles):
                ax.set_title(title)
        for ax in np.asarray(axarr).flatten():
            ax.title.set_fontsize(3)
            ax.xaxis.set_visible(False)
            ax.yaxis.set_visible(False)
        f.subplots_adjust(hspace=0.05)
        f.savefig(self._path_outputs_base + self.FN_VIS_BASE
                  + str(epoch + 1) + ".png", bbox_inches="tight", dpi=300)
        plt.close(f)

    def _vis_samples(self, n: int = 6):
        """First 3 train + 3 valid samples."""
        samples = []
        for i in self._dataloader_training.indices[:n // 2]:
            samples.append(self._dataloader_training.dataset.sample(i))
        if self._dataloader_validation is not None:
            for i in self._dataloader_validation.indices[:n - len(samples)]:
                samples.append(self._dataloader_validation.dataset.sample(i))
        return samples


class CaeStepLearner(CaeReconstructionLearner):
    """Trains an ``Enc3DStep`` CAE's clinical step head (and whatever else
    the optimizer holds): the time to treatment is not given, so the head
    regresses the step in training and validation."""

    FNB_MARKS = "_cae1step"
    FN_VIS_BASE = "_cae1step_"

    def make_dto(self, labels, clinical, step=None, images=None):
        # fixed hours (the grid's sweeps) give the step; else the head
        return cae_dto_from_batch(None, labels, clinical, step,
                                  self._norm_hours, learn_step=step is None)

    def loss(self, dto, factor: float) -> torch.Tensor:
        return step_loss(dto)


class CaePredictionLearner(CaeReconstructionLearner):
    """Phase 2: trains ``enc_model`` (an ``Enc3D``) on the images (U-Net
    segmentations) against ``cae_model``, a phase-1 CAE that this learner
    freezes (``requires_grad`` False: its convs' backward is dx alone) and
    runs in evaluation mode.  The optimizer holds the encoder's
    parameters."""

    FNB_MARKS = "_cae2"
    FN_VIS_BASE = "_cae2_"
    N_EPOCHS_ADAPT_BETA1 = None        # no beta1 ramp

    def __init__(self, dataloader_training, dataloader_validation, cae_model,
                 enc_model, optimizer, lr_schedule, n_epochs, **kw):
        self._cae = cae_model.eval()
        for p in self._cae.parameters():
            p.requires_grad_(False)
        super().__init__(dataloader_training, dataloader_validation,
                         enc_model, optimizer, lr_schedule, n_epochs, **kw)

    def model_config(self) -> dict:
        """The frozen CAE's header, written without a step head as the JAX
        learner writes it."""
        return dict(self._cae.config, step=False)

    def enc_config(self) -> dict:
        return self._model.config

    def make_dto(self, labels, clinical, step=None, images=None):
        return cae_dto_from_batch(images, labels, clinical, step,
                                  self._norm_hours, inputs_from_images=True)

    def augment(self, batch):
        """The training batch with its images and labels flipped and
        deformed together."""
        images, labels = random_cae_augment_images(
            self._generator, batch[KEY_IMAGES], batch[KEY_LABELS])
        return dict(batch, **{KEY_IMAGES: images, KEY_LABELS: labels})

    def forward(self, dto):
        return cae_enc_inference(self._cae, self._model, dto,
                                 self._model.training)

    def loss(self, dto, factor: float) -> torch.Tensor:
        return prediction_loss(dto)

    def save_model(self, suffix: str = ""):
        """The frozen CAE under the main name, the encoder under
        ``_enc`` (the lead rank alone)."""
        if not is_lead():
            return
        ckpt.save_checkpoint(
            self.path("save", "model", suffix),
            state_to_jax(self._cae.state_dict(), self._cae.config),
            self.model_config())
        ckpt.save_checkpoint(self.path("save", "model", "_enc" + suffix),
                             self.state_tree(), self.enc_config())

    def load_model(self):
        state, _ = ckpt.load_checkpoint(self.path("load", "model", "_enc"))
        self.load_state_tree(state)
