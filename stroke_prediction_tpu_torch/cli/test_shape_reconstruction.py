"""CAE shape-reconstruction evaluation of one or more models (port of
cli/test_shape_reconstruction.py): for each ``--path`` / ``--fold`` pair,
per-case measures and NIfTI dumps through ``CaeReconstructionTester``.

    python -m stroke_prediction_tpu_torch.cli.test_shape_reconstruction \\
        --path <cae.model> --fold 0 1 2 [--synthetic] [--device cuda|cpu]
"""

import datetime
from typing import List

from stroke_prediction_tpu_torch.cli.common import make_dataset
from stroke_prediction_tpu_torch.data.dataset import (
    LABEL_CORE, LABEL_LESION, LABEL_PENU, MOD_CBV, MOD_TTD)
from stroke_prediction_tpu_torch.data.loader import get_testdata
from stroke_prediction_tpu_torch.eval.cae_tester import (
    CaeReconstructionTester)
from stroke_prediction_tpu_torch.utils.args import get_args_shape_testing


def test(args) -> List[CaeReconstructionTester]:
    pad = tuple(args.padding)
    testers = []
    for idx in range(len(args.path)):
        dataset = make_dataset(args, [MOD_CBV, MOD_TTD],
                               [LABEL_CORE, LABEL_PENU, LABEL_LESION],
                               pad=pad)
        ds_test = get_testdata(dataset, args.fold[idx], seed=args.seed)
        print("Size test set:", len(ds_test.indices),
              "| # batches:", len(ds_test))
        tester = CaeReconstructionTester(ds_test, args.path[idx],
                                         args.outbasepath, args.normalize,
                                         args.device)
        tester.run_inference()
        testers.append(tester)
    return testers


if __name__ == "__main__":
    print(datetime.datetime.now())
    test(get_args_shape_testing())
    print(datetime.datetime.now())
