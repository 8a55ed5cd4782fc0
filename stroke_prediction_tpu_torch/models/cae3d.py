"""3-D convolutional autoencoder (CAE) of lesion shapes (port of
models/cae3d.py).

* :class:`Enc3D` — ten BN -> conv -> ELU layers with z-only padding and
  three stride-2 downsamples, mapping (B, 28, 128, 128, 1) masks to a
  (B, 1, 10, 10, n_ch_fc) latent, and the latent interpolation
  ``core + t * (penu - core)``.
* :class:`Enc3DStep` — adds the clinical-scalar head that regresses the
  interpolation step when no time to treatment is given.
* :class:`Enc3DCtp` — encodes each mask concatenated with the CBV and TTD
  images (cropped back from their padding) on the channel axis.
* :class:`Dec3D` — the 14-layer mirrored decoder.
* :class:`Cae3D` / :class:`Cae3DCtp` — enc ∘ dec.

The channel list ``[in, origin, down2x, down4x, down8x, fc, ..., classes]``
is the ``--channelscae`` contract.  Structures (core, penumbra, lesion,
interpolation) are encoded and decoded one pass each, the JAX package's
default; with ``STROKE_TPU_CAE_BATCH=1`` (:func:`structure_batching`, read
at every call, as in the JAX package) the present structures of a branch
are stacked on the batch axis, group-major, and run as one pass with
grouped BN (per-structure batch statistics, the running ones chained in
stacking order; ``models/layers.py``), which is the same function.  The
stride-1 3^3 convs run in K1 (:mod:`..ops.conv3x3`): the encoder's z-SAME
convs and its fc conv with BN folded in (with grouped BN in training, after
it), the decoder's (1, 2, 2)-padded convs after BN.  The stride-2 and
transposed convs are cuDNN's, the 1^3 convs matmuls.  ``train()`` uses BN
batch statistics (the running ones chain over the structures' passes, in
call order), ``eval()`` the running ones.  The volumes run in
``compute_dtype`` (float32 or bfloat16; float64 on the CPU) from the
encoder's and the decoder's entry on (the encoder's entry BN takes its
moments of the input as given, as the JAX package's ``BatchNorm`` does of
its float32 input, and the entry conv its cast); parameters, BN statistics
and the sigmoid's output stay float32.

Under a spatial step (``parallel.mesh.batch_sharding(mesh,
spatial=True)``) the same code runs on this rank's block of H of the
masks (and of the padded CBV and TTD images, by their own block rule):
each conv, transposed conv and crop fetches the rows it reads from their
owners (``parallel/spatial.py``), and every latent and reconstruction is
this rank's block of the one-process one.
"""

from __future__ import annotations

import os
from dataclasses import replace
from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn

from stroke_prediction_tpu_torch.core.dto import (
    BRANCH_GTRUTH, CaeBranches, CaeDto)
from stroke_prediction_tpu_torch.models.layers import (
    BatchNorm, BnConvActBlock, Conv3d, ConvTranspose3d, Dense,
    check_compute_dtype)
from stroke_prediction_tpu_torch.ops.conv3x3 import activation
from stroke_prediction_tpu_torch.parallel import spatial


def elu(x: torch.Tensor, alpha: float = 1.0) -> torch.Tensor:
    return activation(x, "elu", alpha)


def structure_batching() -> bool:
    """Whether the CAE encodes and decodes a branch's structures as one
    group-stacked pass (cae3d.py ``structure_batching``): opt in with
    ``STROKE_TPU_CAE_BATCH=1``, the variable the JAX package reads, with
    its default ``"0"``."""
    return os.environ.get("STROKE_TPU_CAE_BATCH", "0") == "1"


def _run_many(trunk: nn.Module, xs: List[Optional[torch.Tensor]]
              ) -> List[Optional[torch.Tensor]]:
    """``trunk`` over each of ``xs``, None kept: one pass each, or with
    :func:`structure_batching` and two or more present, one pass over them
    concatenated on the batch axis with ``groups`` = their number, split
    back into their slots (cae3d.py ``_encode_many`` / ``_decode_many``).
    In training the groups must hold equal batches (grouped BN); in
    evaluation BN uses the running statistics, so the curve tester's sweep
    (a core and a penumbra of one row, interpolations of one a step) stacks
    too."""
    present = [i for i, x in enumerate(xs) if x is not None]
    if len(present) < 2 or not structure_batching():
        return [None if x is None else trunk(x) for x in xs]
    sizes = [xs[i].shape[0] for i in present]
    if trunk.training and len(set(sizes)) > 1:
        raise ValueError(f"grouped BN needs equal batches, got {sizes}")
    stacked = spatial.like(torch.cat([xs[i] for i in present]),
                           xs[present[0]])
    y = trunk(stacked, groups=len(present))
    out: List[Optional[torch.Tensor]] = [None] * len(xs)
    for i, part in zip(present, y.split(sizes)):
        out[i] = spatial.like(part, y)
    return out


def cae_latent_spatial(spatial: Tuple[int, int, int]) -> Tuple[int, int, int]:
    """Latent (D, H, W) of an input (D, H, W), e.g. 28x128x128 -> 1x10x10."""
    dz, hy, wx = spatial
    for _ in range(2):     # two z-SAME, in-plane VALID convs, stride-2 pad 1
        hy, wx = hy - 4, wx - 4
        dz, hy, wx = ((v - 1) // 2 + 1 for v in (dz, hy, wx))
    hy, wx = hy - 4, wx - 4                    # third pair of z-SAME convs
    dz, hy, wx = ((v - 3) // 2 + 1 for v in (dz, hy, wx))  # stride-2 VALID
    return dz - 2, hy - 2, wx - 2              # the fc conv, 3^3 VALID


def interpolate_latent(latent_core: Optional[torch.Tensor],
                       latent_penu: Optional[torch.Tensor],
                       step: Optional[torch.Tensor]
                       ) -> Optional[torch.Tensor]:
    """``core + step * (penu - core)`` per sample; step (B, 1)."""
    if latent_core is None or latent_penu is None:
        return None
    if step is None:
        raise ValueError("Step must be given for interpolation!")
    s = step.reshape(step.shape[0], 1, 1, 1, 1).to(latent_core.dtype)
    return spatial.like(latent_core + s * (latent_penu - latent_core),
                        latent_core)


def _reset(module: nn.Module, generator: Optional[torch.Generator]) -> None:
    for m in module.modules():
        if hasattr(m, "reset_parameters") and m is not module:
            m.reset_parameters(generator)


class EncoderStack(nn.Module):
    """The encoder's ten BN -> conv -> ELU layers (cae3d.py ``EncoderStack``):
    z-SAME pairs between stride-2 convs (padding 1, 1, then VALID) and a
    VALID 3^3 fc conv."""

    def __init__(self, channels: Sequence[int], alpha: float = 1.0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        check_compute_dtype(compute_dtype)
        self.compute_dtype = compute_dtype
        c_in, origin, d2, d4, d8, fc = channels[:6]
        zpad, down = (1, 0, 0), (2, 2, 2)
        layers = [(c_in, origin, {"padding": zpad}),
                  (origin, origin, {"padding": zpad}),
                  (origin, d2, {"strides": down, "padding": (1, 1, 1)}),
                  (d2, d2, {"padding": zpad}), (d2, d2, {"padding": zpad}),
                  (d2, d4, {"strides": down, "padding": (1, 1, 1)}),
                  (d4, d4, {"padding": zpad}), (d4, d4, {"padding": zpad}),
                  (d4, d8, {"strides": down}), (d8, fc, {})]
        self.blocks = nn.ModuleList([
            BnConvActBlock(ci, co, act="elu", act_param=alpha, **kw)
            for ci, co, kw in layers])

    def forward(self, x: torch.Tensor, groups: int = 1) -> torch.Tensor:
        """The latents of x; ``groups`` equal blocks of rows take their own
        BN statistics in training."""
        # the entry BN's moments of x as given (float32: the mask, or CBV
        # and TTD, whose bfloat16 rounding would reach them), then the cast
        # to compute_dtype, as layers.py ``BatchNorm`` does
        self.blocks[0].conv_dtype = self.compute_dtype
        for block in self.blocks:
            x = block(x, groups)
        return x


class DecoderStack(nn.Module):
    """The decoder's layers in the JAX package's order (cae3d.py
    ``DecoderStack``, lax path): BN before each of four transposed convs,
    six (1, 2, 2)-padded 3^3 convs and two 1^3 convs, ELU after all but the
    last, then a sigmoid.  ``bns``, ``convs`` and ``cts`` are numbered as
    flax numbers ``BatchNorm_i``, ``Conv3d_i`` and ``ConvTranspose3d_i``."""

    # the decoder's layers: (kind, index into its list)
    ORDER = (("ct", 0), ("ct", 1), ("conv", 0), ("conv", 1), ("ct", 2),
             ("conv", 2), ("conv", 3), ("ct", 3), ("conv", 4), ("conv", 5),
             ("conv", 6), ("conv", 7))

    def __init__(self, channels: Sequence[int], alpha: float = 1.0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        check_compute_dtype(compute_dtype)
        _, origin, d2, d4, d8, fc = channels[:6]
        n_classes = channels[-1]
        self.alpha, self.compute_dtype = alpha, compute_dtype
        pad = {"padding": (1, 2, 2)}
        self.cts = nn.ModuleList([
            ConvTranspose3d(fc, d8, (3, 3, 3), (1, 1, 1)),
            ConvTranspose3d(d8, d4, (3, 3, 3), (2, 2, 2)),
            ConvTranspose3d(d2, d2, (2, 2, 2), (2, 2, 2)),
            ConvTranspose3d(origin, origin, (2, 2, 2), (2, 2, 2))])
        self.convs = nn.ModuleList([
            Conv3d(d4, d4, **pad), Conv3d(d4, d2, **pad),
            Conv3d(d2, d2, **pad), Conv3d(d2, origin, **pad),
            Conv3d(origin, origin, **pad), Conv3d(origin, origin, **pad),
            Conv3d(origin, origin, (1, 1, 1)),
            Conv3d(origin, n_classes, (1, 1, 1))])
        lists = {"ct": self.cts, "conv": self.convs}
        self.bns = nn.ModuleList([              # BN over each layer's input
            BatchNorm(lists[kind][i].kernel.shape[-2])
            for kind, i in self.ORDER])

    def forward(self, z: torch.Tensor, groups: int = 1) -> torch.Tensor:
        """The reconstructions of z; ``groups`` equal blocks of rows take
        their own BN statistics in training."""
        x = spatial.like(z.to(self.compute_dtype), z)
        last = len(self.ORDER) - 1
        for n, ((kind, i), bn) in enumerate(zip(self.ORDER, self.bns)):
            x = bn(x, groups)
            if kind == "ct":
                y = self.cts[i](x)
                x = spatial.like(elu(y, self.alpha), y)
            else:
                x = self.convs[i](x, "none" if n == last else "elu",
                                  self.alpha)
        return spatial.like(torch.sigmoid(x.to(torch.promote_types(
            x.dtype, torch.float32))), x)


class Enc3D(nn.Module):
    """The CAE encoder over the given branches (cae3d.py ``Enc3D``)."""

    KIND = "enc3d"              # the kind of its ``.model`` header

    def __init__(self, channels: Sequence[int], n_ch_global: int = 5,
                 alpha: float = 1.0,
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.channels, self.n_ch_global = tuple(channels), n_ch_global
        self.alpha = alpha
        self.encoder = EncoderStack(self.channels, alpha, compute_dtype)
        self._build_head()
        _reset(self, generator)

    @property
    def config(self) -> dict:
        """The ``.model`` header of the encoder alone, as the JAX phase-2
        learner writes it (``enc_config``)."""
        return {"kind": self.KIND, "channels": list(self.channels),
                "n_ch_global": self.n_ch_global}

    def _build_head(self) -> None:
        pass

    def _encode_many(self, xs: List[Optional[torch.Tensor]]):
        return _run_many(self.encoder, xs)

    def _get_step(self, dto: CaeDto) -> Optional[torch.Tensor]:
        return dto.given_variables.time_to_treatment

    def forward(self, dto: CaeDto,
                branches: CaeBranches = BRANCH_GTRUTH) -> CaeDto:
        step = self._get_step(dto)
        latents = dto.latents
        given = dto.given_variables
        if branches.gtruth:
            core, penu, lesion = self._encode_many(
                [given.gtruth.core, given.gtruth.penu, given.gtruth.lesion])
            latents = replace(latents, gtruth=replace(
                latents.gtruth, core=core, penu=penu, lesion=lesion,
                interpolation=interpolate_latent(core, penu, step)))
        if branches.inputs:
            core, penu = self._encode_many([given.inputs.core,
                                            given.inputs.penu])
            latents = replace(latents, inputs=replace(
                latents.inputs, core=core, penu=penu,
                interpolation=interpolate_latent(core, penu, step)))
        if step is not given.time_to_treatment:
            # the learned step (Enc3DStep) is recorded for losses / testers
            dto = replace(dto, given_variables=replace(
                given, time_to_treatment=step))
        return replace(dto, latents=latents)


class Enc3DStep(Enc3D):
    """Enc3D with the clinical-scalar step head (cae3d.py ``Enc3DStep``):
    used when ``time_to_treatment`` is None."""

    KIND = "enc3d_step"

    def _build_head(self) -> None:
        g = self.n_ch_global
        self.reduce1 = Dense(g, g)
        self.reduce2 = Dense(g, g // 2)
        self.step_head = Dense(g // 2, 1, kernel_init=(0.0, 0.001),
                               bias_init=(0.5, 0.01))

    def drop_head(self) -> None:
        """Remove the head, as a tree written without it has none (flax
        creates it at its first call); the step must then be given."""
        self.reduce1 = self.reduce2 = self.step_head = None

    def _get_step(self, dto: CaeDto) -> Optional[torch.Tensor]:
        step = dto.given_variables.time_to_treatment
        if step is None:
            if self.step_head is None:
                raise ValueError("this Enc3DStep has no step head: give a "
                                 "time to treatment")
            g = dto.given_variables.globals
            h = elu(self.reduce1(g.reshape(g.shape[0], -1).to(
                self.reduce1.kernel.dtype)), self.alpha)
            h = elu(self.reduce2(h), self.alpha)
            step = torch.sigmoid(self.step_head(h))
        return step


class Enc3DCtp(Enc3D):
    """The CAE encoder over each mask concatenated with the CBV and TTD
    images on the channel axis (cae3d.py ``Enc3DCtp``): ``given.inputs.core``
    / ``.penu`` hold the images padded by ``padding`` (D, H, W), cropped
    back to the masks' size here.  Gtruth branch only; channels[0] (the
    entry conv's C_in) must be at least 3."""

    def __init__(self, channels: Sequence[int], n_ch_global: int = 5,
                 alpha: float = 1.0,
                 padding: Tuple[int, int, int] = (20, 20, 20),
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: torch.dtype = torch.float32):
        if channels[0] <= 2:
            raise ValueError("At least 3 channels required")
        self.padding = tuple(padding)
        super().__init__(channels, n_ch_global, alpha, generator,
                         compute_dtype)

    def forward(self, dto: CaeDto,
                branches: CaeBranches = BRANCH_GTRUTH) -> CaeDto:
        pd, ph, pw = self.padding
        given = dto.given_variables

        def crop(v):
            if spatial.active():
                # the images' own blocks of H, cropped to the masks' blocks
                h = spatial.height(v)
                v = spatial.crop_rows(v, h, h - 2 * ph, ph)
                return spatial.like(
                    v[:, pd:v.shape[1] - pd, :, pw:v.shape[3] - pw], v)
            return v[:, pd:v.shape[1] - pd, ph:v.shape[2] - ph,
                     pw:v.shape[3] - pw]

        cbv, ttd = crop(given.inputs.core), crop(given.inputs.penu)
        latents = dto.latents
        if branches.gtruth:
            core, penu, lesion = self._encode_many([
                None if m is None else spatial.like(
                    torch.cat([m, cbv, ttd], dim=-1), cbv)
                for m in (given.gtruth.core, given.gtruth.penu,
                          given.gtruth.lesion)])
            latents = replace(latents, gtruth=replace(
                latents.gtruth, core=core, penu=penu, lesion=lesion,
                interpolation=interpolate_latent(
                    core, penu, self._get_step(dto))))
        return replace(dto, latents=latents)


class Dec3D(nn.Module):
    """The CAE decoder over the given branches (cae3d.py ``Dec3D``)."""

    def __init__(self, channels: Sequence[int], n_ch_global: int = 5,
                 alpha: float = 1.0,
                 generator: Optional[torch.Generator] = None,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.channels, self.n_ch_global = tuple(channels), n_ch_global
        self.decoder = DecoderStack(self.channels, alpha, compute_dtype)
        _reset(self, generator)

    def _decode_many(self, zs: List[Optional[torch.Tensor]]):
        return _run_many(self.decoder, zs)

    def forward(self, dto: CaeDto,
                branches: CaeBranches = BRANCH_GTRUTH) -> CaeDto:
        recon = dto.reconstructions
        if branches.gtruth:
            lg = dto.latents.gtruth
            core, penu, lesion, interp = self._decode_many(
                [lg.core, lg.penu, lg.lesion, lg.interpolation])
            recon = replace(recon, gtruth=replace(
                recon.gtruth, core=core, penu=penu, lesion=lesion,
                interpolation=interp))
        if branches.inputs:
            li = dto.latents.inputs
            core, penu, interp = self._decode_many(
                [li.core, li.penu, li.interpolation])
            recon = replace(recon, inputs=replace(
                recon.inputs, core=core, penu=penu, interpolation=interp))
        return replace(dto, reconstructions=recon)


class Cae3D(nn.Module):
    """enc ∘ dec (cae3d.py ``Cae3D``)."""

    def __init__(self, enc: Enc3D, dec: Dec3D):
        super().__init__()
        self.enc, self.dec = enc, dec

    @property
    def config(self) -> dict:
        """The ``.model`` header of this model, as the JAX learner writes
        it."""
        return {"kind": "cae3d", "channels": list(self.enc.channels),
                "n_ch_global": self.enc.n_ch_global,
                "step": isinstance(self.enc, Enc3DStep)}

    def forward(self, dto: CaeDto,
                branches: CaeBranches = BRANCH_GTRUTH) -> CaeDto:
        return self.dec(self.enc(dto, branches), branches)


class Cae3DCtp(Cae3D):
    """Enc3DCtp ∘ Dec3D (cae3d.py ``Cae3DCtp``)."""

    @property
    def config(self) -> dict:
        return dict(super().config, kind="cae3d_ctp",
                    padding=list(self.enc.padding))
