"""U-Net segmentation learner (port of train/unet_learner.py).

The loss is the mean of the core and penumbra batch-Dice losses; per step
the binary measures of both structures.  Training and validation steps
both crop a random patch (offsets from the learner's device generator);
training steps normalise with the batch statistics, validation steps with
the running ones.  Console line, loss/Dice curve plot and the 6-sample x
6-panel visual grid as in the JAX learner.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from stroke_prediction_tpu_torch.data.augment import (
    crop_patch, random_offsets)
from stroke_prediction_tpu_torch.data.dataset import KEY_IMAGES, KEY_LABELS
from stroke_prediction_tpu_torch.eval.metrics import (
    batch_dice_loss, binary_measures)
from stroke_prediction_tpu_torch.models.convert import (
    unet_state_from_jax, unet_state_to_jax)
from stroke_prediction_tpu_torch.train.learner import Learner


def _measures_dict(prefix: str, m) -> dict:
    return {f"{prefix}_dc": m.dc, f"{prefix}_hd": m.hd,
            f"{prefix}_assd": m.assd, f"{prefix}_precision": m.precision,
            f"{prefix}_sensitivity": m.sensitivity,
            f"{prefix}_specificity": m.specificity}


class UnetSegmentationLearner(Learner):

    FNB_MARKS = "_unet"
    FN_VIS_BASE = "_visual_"

    def __init__(self, dataloader_training, dataloader_validation,
                 unet_model, optimizer, lr_schedule, n_epochs,
                 patch_whd: Tuple[int, int, int],
                 pad_xyz: Tuple[int, int, int] = (20, 20, 20), **kw):
        self._patch = tuple(patch_whd)
        self._pad = tuple(pad_xyz)
        super().__init__(dataloader_training, dataloader_validation,
                         unet_model, optimizer, lr_schedule, n_epochs, **kw)

    def model_config(self) -> dict:
        return {"kind": "unet3d", "channels": list(self._model.channels)}

    def state_tree(self) -> dict:
        return unet_state_to_jax(self._model.state_dict())

    def load_state_tree(self, state) -> None:
        self._model.load_state_dict(unet_state_from_jax(state))

    # ------------------------------------------------------------ stepping

    def loss(self, core, penu, core_gt, penu_gt) -> torch.Tensor:
        """Mean of the core and penumbra Dice losses."""
        return (batch_dice_loss(core, core_gt)
                + batch_dice_loss(penu, penu_gt)) / 2.0

    def crop(self, batch):
        images, labels = batch[KEY_IMAGES], batch[KEY_LABELS]
        offsets = random_offsets(self._generator, images.shape[0],
                                 tuple(images.shape[1:4]), self._patch)
        return crop_patch(images, labels, offsets, self._patch, self._pad)

    def forward_loss(self, images, labels):
        seg = self._model(images)
        core, penu = seg[..., 0:1], seg[..., 1:2]
        core_gt, penu_gt = labels[..., 0:1], labels[..., 1:2]
        return (self.loss(core, penu, core_gt, penu_gt),
                (core, penu, core_gt, penu_gt))

    def _metrics(self, loss, core, penu, core_gt, penu_gt,
                 training: bool) -> dict:
        wd = self._with_distances(training)
        out = {"loss": loss.detach()}
        out.update(_measures_dict(
            "core", binary_measures(core, core_gt, with_distances=wd)))
        out.update(_measures_dict(
            "penu", binary_measures(penu, penu_gt, with_distances=wd)))
        return out

    def train_step(self, batch):
        images, labels = self.crop(batch)
        self._model.train()
        loss, outs = self.forward_loss(images, labels)
        self._optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self._optimizer.step()
        self.step_counts["train"] += 1
        with torch.no_grad():
            return self._metrics(loss, *(o.detach() for o in outs),
                                 training=True)

    def eval_step(self, batch):
        images, labels = self.crop(batch)
        self._model.eval()
        with torch.no_grad():
            loss, outs = self.forward_loss(images, labels)
            self.step_counts["eval"] += 1
            return self._metrics(loss, *outs, training=False)

    # --------------------------------------------------------- reporting

    def print_epoch(self, epoch, phase, m):
        print("\nEpoch {}/{} {} loss: {:.3} - DC Core:{:.3}, DC Penumbra:{:.3}"
              .format(epoch + 1, self._n_epochs, phase, m.get("loss", 0.0),
                      m.get("core_dc", 0.0), m.get("penu_dc", 0.0)),
              end=" ")

    def plot_epoch(self, plot, epochs):
        tr, va = self._metric_dtos["training"], self._metric_dtos["validate"]
        plot.plot(epochs, [m["loss"] for m in tr], "r-")
        plot.plot(epochs, [m["loss"] for m in va], "g-")
        plot.plot(epochs, [m.get("core_dc", 0) for m in va], "c+")
        plot.plot(epochs, [m.get("penu_dc", 0) for m in va], "m+")
        plot.set_ylabel("L Train.(red)/Val.(green) | "
                        "Dice Val. Core(c), Penu(m)")

    def visualize_epoch(self, epoch):
        """6-sample x 6-panel grid: CBV, core GT, p(core), p(penu), penu GT,
        TTD."""
        plt = self.pyplot()
        if plt is None:
            return
        from stroke_prediction_tpu_torch.inference import (
            IMSHOW_VMAX_CBV, IMSHOW_VMAX_TTD)

        samples = self._vis_samples()
        if not samples:
            return
        f, axarr = plt.subplots(max(len(samples), 2), 6)
        pad = self._pad
        self._model.eval()
        for inc, sample in enumerate(samples):
            imgs = sample[KEY_IMAGES][None]
            labels = sample[KEY_LABELS][None]
            with torch.no_grad():
                seg = self._model(torch.from_numpy(imgs).to(self.device))
            self.step_counts["visual"] += 1
            seg = seg.cpu().numpy()
            zs = min(imgs.shape[1] - 1, 34)
            zso = min(seg.shape[1] - 1, 14)
            axarr[inc, 0].imshow(
                imgs[0, zs, pad[1]:-pad[1], pad[0]:-pad[0], 0],
                vmin=0, vmax=IMSHOW_VMAX_CBV, cmap="jet")
            axarr[inc, 1].imshow(labels[0, zso, :, :, 0], vmin=0, vmax=1,
                                 cmap="gray")
            axarr[inc, 2].imshow(seg[0, zso, :, :, 0], vmin=0, vmax=1,
                                 cmap="gray")
            axarr[inc, 3].imshow(seg[0, zso, :, :, 1], vmin=0, vmax=1,
                                 cmap="gray")
            axarr[inc, 4].imshow(labels[0, zso, :, :, 1], vmin=0, vmax=1,
                                 cmap="gray")
            axarr[inc, 5].imshow(
                imgs[0, zs, pad[1]:-pad[1], pad[0]:-pad[0], 1],
                vmin=0, vmax=IMSHOW_VMAX_TTD, cmap="jet")
            for ax, title in zip(axarr[inc], ["CBV", "Core GT", "p(Core)",
                                              "p(Penu.)", "Penu. GT", "TTD"]):
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
