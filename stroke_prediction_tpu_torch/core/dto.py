"""Data-transfer objects (port of core/dto.py, U-Net and metric parts).

Plain dataclasses over channels-last ``(B, D, H, W, C)`` tensors; use
``dataclasses.replace`` to derive updated records.  The CAE records come
with the CAE slice.
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
