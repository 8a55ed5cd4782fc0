"""Full-volume U-Net evaluation on a held-out fold (port of
cli/test_unet_segmentation.py): fully-convolutional full-volume inference,
pad 20^3, per-case Dice + NIfTI dumps.

    python -m stroke_prediction_tpu_torch.cli.test_unet_segmentation \\
        <unet.model> [--synthetic] [--fold ...] [--device cuda|cpu]
"""

import datetime

from stroke_prediction_tpu_torch.cli.common import make_dataset
from stroke_prediction_tpu_torch.data.dataset import (
    LABEL_CORE, LABEL_PENU, MOD_CBV, MOD_TTD)
from stroke_prediction_tpu_torch.data.loader import get_testdata
from stroke_prediction_tpu_torch.eval.unet_tester import UnetSegmentationTester
from stroke_prediction_tpu_torch.utils.args import get_args_unet_testing


def test(args) -> UnetSegmentationTester:
    pad = tuple(args.padding)
    dataset = make_dataset(args, [MOD_CBV, MOD_TTD],
                           [LABEL_CORE, LABEL_PENU], pad=pad)
    ds_test = get_testdata(dataset, args.fold, seed=args.seed)
    print("Size test set:", len(ds_test.indices),
          "| # batches:", len(ds_test))
    tester = UnetSegmentationTester(ds_test, args.unetpath,
                                    args.outbasepath, None, args.device)
    tester.run_inference()
    return tester


if __name__ == "__main__":
    print(datetime.datetime.now())
    test(get_args_unet_testing())
    print(datetime.datetime.now())
