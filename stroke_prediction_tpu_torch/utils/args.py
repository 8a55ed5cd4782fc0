"""CLI flags (port of utils/args.py, the U-Net parsers).

The same flags and defaults as the JAX package's ``ExpParser`` /
``UnetParser``, plus ``--device {cuda,cpu}`` (default ``cuda``).
``--dtype`` picks the training compute type (bfloat16 by default; the tester
runs float32) and ``--distances`` computes HD/ASSD on training batches too.
The runtime flags of the parallel path and the profiler (``--ndevices``,
``--distributed`` and its addresses, ``--profile``) parse as in the JAX
package, but the port has not ported what reads them yet:
:meth:`ExpParser.parse_args` raises ``NotImplementedError`` when one of them
is set to anything but its default.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

# flag -> default; any other value raises until its slice is ported
UNPORTED_FLAGS = {"ndevices": 1, "distributed": False, "coordinator": None,
                  "nprocs": None, "procid": None, "profile": None}


class ExpParser(argparse.ArgumentParser):
    def __init__(self, **kw):
        super().__init__(**kw)
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
        self.add_argument("--device", type=str, default="cuda",
                          choices=["cuda", "cpu"],
                          help="Device to run on; cpu runs every kernel's "
                               "plain PyTorch version")

    def parse_args(self, args=None, namespace=None):
        ns = super().parse_args(args, namespace)
        for name, default in UNPORTED_FLAGS.items():
            if getattr(ns, name) != default:
                raise NotImplementedError(f"--{name} is not ported yet")
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


def get_args_unet_training(argv: Optional[Sequence[str]] = None):
    return UnetParser().parse_args(argv)
