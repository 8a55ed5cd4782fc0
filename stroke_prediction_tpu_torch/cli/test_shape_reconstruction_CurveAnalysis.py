"""CAE evaluation with the counterfactual time-curve analysis (port of
cli/test_shape_reconstruction_CurveAnalysis.py): per model and fold, the
ground-truth case measures, fixed tA -> tR steps of 0-5 h, relative and
uniform sweeps through ``CaeReconstructionTesterCurve``.

    python -m \\
        stroke_prediction_tpu_torch.cli.test_shape_reconstruction_CurveAnalysis \\
        --path <cae.model> --fold 0 1 2 [--synthetic] [--device cuda|cpu]
"""

import datetime
from typing import List

from stroke_prediction_tpu_torch.cli.common import make_dataset
from stroke_prediction_tpu_torch.data.dataset import (
    LABEL_CORE, LABEL_LESION, LABEL_PENU, MOD_CBV, MOD_TTD)
from stroke_prediction_tpu_torch.data.loader import get_testdata
from stroke_prediction_tpu_torch.eval.cae_tester import (
    CaeReconstructionTesterCurve)
from stroke_prediction_tpu_torch.utils.args import get_args_shape_testing


def test(args) -> List[CaeReconstructionTesterCurve]:
    if len(args.fold) != len(args.path):
        raise ValueError("You must provide as many --fold arguments as "
                         "caepath model arguments in the exact same order!")
    steps = range(6)   # fixed tAdmission -> tReca steps: 0-5 hrs
    pad = tuple(args.padding)
    testers = []
    for i, path in enumerate(args.path):
        print("Model " + path + " of fold " + str(i + 1) + "/"
              + str(len(args.fold)) + " with indices: " + str(args.fold[i]))
        dataset = make_dataset(args, [MOD_CBV, MOD_TTD],
                               [LABEL_CORE, LABEL_PENU, LABEL_LESION],
                               pad=pad)
        ds_test = get_testdata(dataset, args.fold[i], seed=args.seed)
        print("Size test set:", len(ds_test.indices),
              "| # batches:", len(ds_test))
        tester = CaeReconstructionTesterCurve(
            ds_test, path, args.outbasepath, args.normalize, steps,
            device=args.device)
        tester.run_inference()
        testers.append(tester)
    return testers


if __name__ == "__main__":
    print(datetime.datetime.now())
    test(get_args_shape_testing())
    print(datetime.datetime.now())
