"""Data-transfer objects (port of core/dto.py).

Plain dataclasses over channels-last ``(B, D, H, W, C)`` tensors; use
``dataclasses.replace`` to derive updated records.  ``None`` fields are
absent structures.  The CAE's branch selection (:class:`CaeBranches`) is a
plain argument of the model's forward.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

Tensor = Any  # torch.Tensor | None


@dataclass(frozen=True)
class UnetGiven:
    input_modalities: Tensor = None     # (B, D, H, W, 2)  CBV + TTD
    core: Tensor = None                 # (B, D, H, W, 1)  manual core gt
    penu: Tensor = None                 # (B, D, H, W, 1)  manual penumbra gt
    lesion: Tensor = None               # (B, D, H, W, 1)  follow-up lesion gt


@dataclass(frozen=True)
class UnetOutputs:
    core: Tensor = None
    penu: Tensor = None
    lesion: Tensor = None


@dataclass(frozen=True)
class UnetDto:
    given_variables: UnetGiven
    outputs: UnetOutputs = field(default_factory=UnetOutputs)


def init_unet_dto(input_modalities, gtruth_core=None, gtruth_penumbra=None,
                  gtruth_lesion=None) -> UnetDto:
    return UnetDto(given_variables=UnetGiven(
        input_modalities=input_modalities, core=gtruth_core,
        penu=gtruth_penumbra, lesion=gtruth_lesion))


@dataclass(frozen=True)
class CaeBranch:
    """One of the gtruth / inputs branches of latents or reconstructions."""

    core: Tensor = None
    penu: Tensor = None
    lesion: Tensor = None            # gtruth branch only
    interpolation: Tensor = None


@dataclass(frozen=True)
class CaePair:
    inputs: CaeBranch = field(default_factory=CaeBranch)
    gtruth: CaeBranch = field(default_factory=CaeBranch)


@dataclass(frozen=True)
class CaeGiven:
    globals: Tensor = None             # (B, n_globals) clinical scalars
    time_to_treatment: Tensor = None   # (B, 1) normalized step, or None
    type_core: Tensor = None           # (B, 1) zeros
    type_penumbra: Tensor = None       # (B, 1) ones
    inputs: CaeBranch = field(default_factory=CaeBranch)
    gtruth: CaeBranch = field(default_factory=CaeBranch)


@dataclass(frozen=True)
class CaeDto:
    given_variables: CaeGiven
    latents: CaePair = field(default_factory=CaePair)
    reconstructions: CaePair = field(default_factory=CaePair)


def init_cae_dto(global_variables=None, time_to_treatment=None,
                 type_core=None, type_penumbra=None,
                 inputs_core=None, inputs_penu=None,
                 gtruth_core=None, gtruth_penumbra=None,
                 gtruth_lesion=None) -> CaeDto:
    return CaeDto(given_variables=CaeGiven(
        globals=global_variables, time_to_treatment=time_to_treatment,
        type_core=type_core, type_penumbra=type_penumbra,
        inputs=CaeBranch(core=inputs_core, penu=inputs_penu),
        gtruth=CaeBranch(core=gtruth_core, penu=gtruth_penumbra,
                         lesion=gtruth_lesion)))


@dataclass(frozen=True)
class CaeBranches:
    """Which branches a CAE forward encodes and decodes."""

    gtruth: bool = True
    inputs: bool = False


BRANCH_GTRUTH = CaeBranches(gtruth=True, inputs=False)
BRANCH_INPUTS = CaeBranches(gtruth=False, inputs=True)
BRANCH_BOTH = CaeBranches(gtruth=True, inputs=True)


@dataclass(frozen=True)
class BinaryMeasures:
    """Per-structure binary metrics."""

    dc: Any = None
    hd: Any = None
    assd: Any = None
    precision: Any = None
    sensitivity: Any = None       # recall
    specificity: Any = None

    @property
    def prc_euclidean_distance(self):
        """Distance to the ideal top-right corner (1, 1) of the
        precision-recall plot."""
        if self.precision is None or self.sensitivity is None:
            return None
        return ((1 - self.precision) ** 2 + (1 - self.sensitivity) ** 2) ** 0.5
