"""Shared CLI wiring: dataset construction and the data-parallel mesh
from args (port of cli/common.py).

The synthetic provider caches its cases under
``<tempfile.gettempdir()>/stroke_tpu_torch_synth_cache``, a directory of
its own: the JAX package writes its cache files in place, so the port never
reads them (the cases are byte-identical, only the files are not shared).

Data parallelism from the flags: ``--ndevices N`` runs N local processes,
one card each (``--device cpu``: N gloo processes on the CPU), which
:func:`spawn_ranks` starts; ``--distributed`` joins this process to the
process group at ``--coordinator`` as rank ``--procid`` of ``--nprocs``,
and the mesh spans the group, as the JAX package's spans the global devices
(``--ndevices``, where given, must then equal ``--nprocs``: a process
drives one card).  In each process :func:`make_mesh` returns the mesh and
the device.
"""

from __future__ import annotations

import copy
import importlib
import os
import socket
import tempfile
from typing import Optional, Sequence, Tuple

import torch

from stroke_prediction_tpu_torch.data.dataset import (
    NiftiCaseProvider, StrokeDataset3D, SyntheticCaseProvider)
from stroke_prediction_tpu_torch.device import resolve_device
from stroke_prediction_tpu_torch.parallel import distributed
from stroke_prediction_tpu_torch.parallel.mesh import Mesh, make_data_mesh
from stroke_prediction_tpu_torch.utils.args import NDEVICES_ERROR

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


def free_port() -> int:
    """A TCP port free on localhost now."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def spawn_ranks(module: str, args) -> None:
    """Run ``module.train(args)`` in ``args.ndevices`` processes, rank
    ``r`` on ``cuda:r`` (or the CPU with ``--device cpu``), joined by a
    process group on a free localhost port; returns when all have ended
    and raises if one failed.  Raises before it starts any when the
    machine has fewer cards than ranks: ranks never share a card."""
    n = args.ndevices
    if resolve_device(args.device).type == "cuda" and \
            n > torch.cuda.device_count():
        raise RuntimeError(f"--ndevices {n} needs {n} cards, this machine "
                           f"has {torch.cuda.device_count()}")
    torch.multiprocessing.start_processes(
        _rank_main, args=(module, args, f"127.0.0.1:{free_port()}"),
        nprocs=n, join=True, start_method="spawn")


def spawned(module: str, args) -> bool:
    """Whether this process starts the ranks itself (``--ndevices N`` with
    neither ``--distributed`` nor a rank): if so, runs ``module.train`` in
    them (:func:`spawn_ranks`) and returns True when they have ended."""
    if args.ndevices > 1 and not args.distributed and args.procid is None:
        spawn_ranks(module, args)
        return True
    return False


def _rank_main(rank: int, module: str, args, coordinator: str) -> None:
    args = copy.copy(args)
    args.coordinator, args.nprocs, args.procid = (coordinator,
                                                  args.ndevices, rank)
    importlib.import_module(module).train(args)


def make_mesh(args) -> Tuple[Optional[Mesh], torch.device]:
    """(mesh, device) of this process.  ``--distributed``, or a rank of
    :func:`spawn_ranks` (``--ndevices N`` with the addresses filled in):
    joins the process group and returns the mesh over it and this rank's
    device.  Otherwise (None, the ``--device``)."""
    if args.distributed and args.ndevices > 1 and \
            args.ndevices != args.nprocs:
        raise ValueError(NDEVICES_ERROR.format(args.ndevices, args.nprocs))
    if args.procid is None:
        return None, resolve_device(args.device)
    device = distributed.initialize(args.coordinator, args.nprocs,
                                    args.procid, device=args.device)
    return make_data_mesh(), device
