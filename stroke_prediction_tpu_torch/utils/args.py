"""CLI flags (port of utils/args.py: the U-Net parsers, the CAE training
parsers, the shape-testing parser and the SDM baseline's parser).

The same flags and defaults as the JAX package's ``ExpParser`` /
``UnetParser`` / ``CAEParser`` / ``SDMParser`` / ``get_args_shape_training``
/ ``get_args_step_training`` / ``get_args_shape_prediction_training`` /
``get_args_shape_testing`` / ``get_args_sdm``, plus ``--device {cuda,cpu}``
(default ``cuda``).
``--dtype`` picks the training compute type (bfloat16 by default; the tester
runs float32), ``--distances`` computes HD/ASSD on training batches too and
``--profile LOGDIR`` traces one training pass with ``torch.profiler``.
The runtime flags of the parallel path (``--ndevices``, ``--distributed``
and its addresses) parse as in the JAX package.  U-Net training and the
CAE training entry points read them (``get_args_unet_training``,
``get_args_shape_training``, ``get_args_step_training``,
``get_args_shape_prediction_training``; ``cli/common.py::make_mesh``);
there ``--distributed`` takes ``--ndevices`` only equal to ``--nprocs``.
The U-Net and SDM testers take them and ignore them: they run on one
process, as the JAX testers do, which build no mesh.  The shape-testing
parser has no such flags, as in the JAX package.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

# flag -> default; the U-Net and SDM testers read none of them
PARALLEL_FLAGS = {"ndevices": 1, "distributed": False, "coordinator": None,
                  "nprocs": None, "procid": None}
# a process drives one card, so with --distributed the mesh spans the
# process group, and --ndevices can only name its size
NDEVICES_ERROR = ("--ndevices {} with --distributed: each process drives one "
                  "card, so --ndevices must equal --nprocs ({})")


def _add_device(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="Device to run on; cpu runs every kernel's "
                             "plain PyTorch version")


class ExpParser(argparse.ArgumentParser):
    """The common flags; ``parallel`` marks the entry points that read the
    data-parallel flags (``--distributed`` there needs its addresses); the
    others take them and ignore them."""

    def __init__(self, parallel: bool = False, **kw):
        super().__init__(**kw)
        self.parallel = parallel
        self.add_argument("--fold", type=int, nargs="+",
                          help="Fold case indices", default=list(range(29)))
        self.add_argument("--hemisflipid", type=float, default=15,
                          help="Case id or greater at which hemispheric flip is applied")
        self.add_argument("--validsetsize", type=float, default=0.5,
                          help="Fraction of validation set size")
        self.add_argument("--seed", type=int, default=4,
                          help="Seed for any randomization")
        self.add_argument("--xyoriginal", type=int, default=256,
                          help="Original size of slices")
        self.add_argument("--xyresample", type=float, default=0.5,
                          help="Factor for resampling slices")
        self.add_argument("--zsize", type=int, default=28,
                          help="Number of z slices")
        self.add_argument("--padding", type=int, nargs="+",
                          default=[20, 20, 20], help="Padding of patches")
        self.add_argument("--lrsteps", type=int, nargs="+", default=[],
                          help="MultiStepLR epochs")
        self.add_argument("--datadir", type=str, default=None,
                          help="NIfTI dataset root directory")
        self.add_argument("--clinicalcsv", type=str, default=None,
                          help="Clinical CSV path")
        self.add_argument("--synthetic", action="store_true", default=False,
                          help="Use the synthetic stand-in dataset")
        self.add_argument("--ndevices", type=int, default=1,
                          help="Data-parallel device count")
        self.add_argument("--dtype", type=str, default="bfloat16",
                          choices=["bfloat16", "float32"],
                          help="Model compute dtype for training (the "
                               "tester runs float32)")
        self.add_argument("--fastmetrics", action="store_true",
                          default=True,
                          help="No-op, kept for compatibility")
        self.add_argument("--distances", action="store_true",
                          default=False,
                          help="Compute HD/ASSD every training AND "
                               "validation batch (default: validation "
                               "only)")
        self.add_argument("--profile", type=str, default=None,
                          metavar="LOGDIR",
                          help="Profile one training epoch into LOGDIR")
        self.add_argument("--distributed", action="store_true",
                          default=False,
                          help="Multi-process runtime")
        self.add_argument("--coordinator", type=str, default=None,
                          metavar="HOST:PORT",
                          help="Distributed coordinator address")
        self.add_argument("--nprocs", type=int, default=None,
                          help="Distributed process count")
        self.add_argument("--procid", type=int, default=None,
                          help="This process's distributed rank")
        _add_device(self)

    def parse_args(self, args=None, namespace=None):
        ns = super().parse_args(args, namespace)
        if self.parallel and ns.distributed:
            if None in (ns.coordinator, ns.nprocs, ns.procid):
                self.error("--distributed needs --coordinator, --nprocs "
                           "and --procid")
            if ns.ndevices > 1 and ns.ndevices != ns.nprocs:
                self.error(NDEVICES_ERROR.format(ns.ndevices, ns.nprocs))
        print(ns)
        return ns


class UnetParser(ExpParser):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_argument("unetpath", type=str,
                          help="Path to model of Unet")
        self.add_argument("--channels", type=int, nargs="+",
                          default=[2, 16, 32, 64, 32, 16, 32, 2],
                          help="Unet channels")
        self.add_argument("--epochs", type=int, default=200)
        self.add_argument("--inbasepath", type=str, default=None)
        self.add_argument("--outbasepath", type=str, default="/tmp/unet")
        self.add_argument("--batchsize", type=int, default=6)


class CAEParser(ExpParser):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_argument("--epochs", type=int, default=300)
        self.add_argument("--batchsize", type=int, default=4)
        self.add_argument("--globals", type=int, default=5,
                          help="Number of global variables")
        self.add_argument("--normalize", type=int, default=10,
                          help="Normalization corresponding to penumbra (hours)")
        self.add_argument("--inbasepath", type=str, default=None,
                          help="Path and filename base for loading")
        self.add_argument("--outbasepath", type=str, default="/tmp/tmp_out",
                          help="Path and filename base for saving")
        self.add_argument("--steplearning", action="store_true",
                          default=False,
                          help="Also learn interpolation step from clinical data")


class SDMParser(ExpParser):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.add_argument("unet", type=str, nargs="?",
                          default="/tmp/unet.model",
                          help="Path to model of Segmentation Unet")
        self.add_argument("--channels", type=int, nargs="+",
                          default=[2, 16, 32, 64, 32, 16, 32, 2])
        self.add_argument("--downsample", type=int, default=1,
                          help="Downsampling to CAE latent representation size")
        self.add_argument("--groundtruth", type=int, default=1,
                          help="Use groundtruth instead of UNet segmentations")
        self.add_argument("--visualinspection", type=int, default=0)
        self.add_argument("--outbasepath", type=str, default="/tmp/sdm")
        self.add_argument("--normalize", type=int, default=10)


def get_args_sdm(argv: Optional[Sequence[str]] = None):
    return SDMParser().parse_args(argv)


def get_args_unet_training(argv: Optional[Sequence[str]] = None):
    """U-Net training's flags, the data-parallel ones included."""
    return UnetParser(parallel=True).parse_args(argv)


def get_args_unet_testing(argv: Optional[Sequence[str]] = None):
    """The U-Net tester's flags (those of training; the data-parallel ones
    are ignored)."""
    return UnetParser().parse_args(argv)


def get_args_shape_training(argv: Optional[Sequence[str]] = None):
    """Phase-1 (and CTP) CAE training's flags, the data-parallel ones
    included."""
    parser = CAEParser(parallel=True)
    parser.add_argument("--channelscae", type=int, nargs="+",
                        default=[1, 16, 24, 32, 100, 200, 1],
                        help="CAE channels")
    return parser.parse_args(argv)


def get_args_step_training(argv: Optional[Sequence[str]] = None):
    """Step learning on a phase-1 CAE: its ``.model`` path first; the
    data-parallel flags included."""
    parser = CAEParser(parallel=True)
    parser.add_argument("caepath", type=str,
                        help="Path to previously trained cae phase1 model")
    parser.add_argument("--channelscae", type=int, nargs="+",
                        default=[1, 16, 24, 32, 100, 200, 1])
    return parser.parse_args(argv)


def get_args_shape_prediction_training(
        argv: Optional[Sequence[str]] = None):
    """Phase-2 training against a phase-1 CAE: its ``.model`` path first;
    the data-parallel flags included."""
    parser = CAEParser(parallel=True)
    parser.add_argument("caepath", type=str,
                        help="Path to previously trained cae phase1 model")
    parser.add_argument("--channelsenc", type=int, nargs="+",
                        default=[1, 16, 24, 32, 100, 200, 1])
    parser.add_argument("--initbycae", action="store_true", default=False,
                        help="Init enc weights by cae's enc")
    return parser.parse_args(argv)


def get_args_shape_testing(argv: Optional[Sequence[str]] = None):
    """The CAE testers' flags: one ``--path`` and one ``--fold`` list per
    model to test."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--path", action="append", type=str,
                        help="Path to model of Shape CAE")
    parser.add_argument("--fold", action="append", type=int, nargs="+",
                        help="Fold case indices")
    parser.add_argument("--normalize", type=int, default=10)
    parser.add_argument("--outbasepath", type=str, default="/tmp/shape")
    parser.add_argument("--xyresample", type=float, default=0.5)
    parser.add_argument("--xyoriginal", type=int, default=256)
    parser.add_argument("--zsize", type=int, default=28)
    parser.add_argument("--padding", type=int, nargs="+",
                        default=[20, 20, 20])
    parser.add_argument("--hemisflipid", type=float, default=15)
    parser.add_argument("--seed", type=int, default=4)
    parser.add_argument("--datadir", type=str, default=None)
    parser.add_argument("--clinicalcsv", type=str, default=None)
    parser.add_argument("--synthetic", action="store_true", default=False)
    _add_device(parser)
    args = parser.parse_args(argv)
    print(args)
    return args
