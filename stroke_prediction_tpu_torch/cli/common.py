"""Shared CLI wiring: dataset construction from args (port of
cli/common.py).

The synthetic provider caches its cases under
``<tempfile.gettempdir()>/stroke_tpu_torch_synth_cache``, a directory of
its own: the JAX package writes its cache files in place, so the port never
reads them (the cases are byte-identical, only the files are not shared).
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional, Sequence, Tuple

from stroke_prediction_tpu_torch.data.dataset import (
    NiftiCaseProvider, StrokeDataset3D, SyntheticCaseProvider)

# The reference's institute-share defaults; only used when --datadir /
# --clinicalcsv are given or reachable.
DEFAULT_ROOT = "/share/data_zoe1/lucas/Linda_Segmentations"
DEFAULT_CSV = "/share/data_zoe1/lucas/Linda_Segmentations/clinical_cleaned.csv"


def synthetic_cache_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "stroke_tpu_torch_synth_cache")


def make_provider(args):
    if args.synthetic or (args.datadir is None
                          and not os.path.isdir(DEFAULT_ROOT)):
        return SyntheticCaseProvider(
            n_cases=29, shape_xyz=(args.xyoriginal, args.xyoriginal,
                                   args.zsize), seed=args.seed,
            cache_dir=synthetic_cache_dir())
    return NiftiCaseProvider(args.datadir or DEFAULT_ROOT,
                             args.clinicalcsv or DEFAULT_CSV)


def make_dataset(args, modalities: Sequence[str], labels: Sequence[str],
                 flip_split_id: Optional[float] = None,
                 pad: Optional[Tuple[int, int, int]] = None,
                 provider=None) -> StrokeDataset3D:
    if provider is None:
        provider = make_provider(args)
    resample = args.xyresample if args.xyresample != 1 else None
    return StrokeDataset3D(provider, modalities, labels, resample=resample,
                           flip_split_id=flip_split_id, pad=pad)
