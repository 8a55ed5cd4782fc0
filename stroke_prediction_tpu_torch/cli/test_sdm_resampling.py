"""The signed-distance-map interpolation baseline, per test case (port of
cli/test_sdm_resampling.py): the signed EDTs of the core and penumbra (the
ground-truth labels with ``--groundtruth 1``, the U-Net segmentations
``MOD_UNET_CORE`` / ``MOD_UNET_PENU`` with ``0``), with ``--downsample 1``
the 1/12 in-plane latent and the zoom back, the linear interpolation at the
normalized time to treatment, the thresholds at 0 and the binary measures,
all on the device (:mod:`..eval.sdm`); one results line per case appended
to ``<BASE>_sdm_results.txt``, and four NIfTI dumps at 2x in-plane zoom.

    python -m stroke_prediction_tpu_torch.cli.test_sdm_resampling \\
        [--synthetic] [--fold ...] [--groundtruth 1|0] [--downsample 1|0] \\
        [--normalize 10] [--visualinspection 0|1] [--device cuda|cpu] \\
        [--outbasepath BASE]

Writes ``<BASE>_<case>_{lesion,fuctgt,core,penu}.nii.gz`` and, with
``--visualinspection 1`` where matplotlib is installed,
``<BASE>_<case>_inspect.png``.
"""

import datetime
import time
from typing import List, Tuple

import numpy as np
import torch

from stroke_prediction_tpu_torch.cli.common import make_dataset
from stroke_prediction_tpu_torch.data.dataset import (
    KEY_CASE_ID, KEY_GLOBAL, KEY_IMAGES, KEY_LABELS, LABEL_CORE,
    LABEL_LESION, LABEL_PENU, MOD_CBV, MOD_UNET_CORE, MOD_UNET_PENU)
from stroke_prediction_tpu_torch.data.loader import get_testdata
from stroke_prediction_tpu_torch.device import resolve_device
from stroke_prediction_tpu_torch.eval.metrics import (
    binary_measures_per_sample)
from stroke_prediction_tpu_torch.eval.sdm import sdm_interpolate
from stroke_prediction_tpu_torch.utils.args import get_args_sdm
from stroke_prediction_tpu_torch.utils.nifti import (
    dhw_to_xyz, save_nifti, zoom2x_inplane_xyz)


def _inspect(path, rows):
    """The visual-inspection figure: per structure the mask, the latent,
    the reconstruction and its threshold at one plane; False without
    matplotlib."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False
    zs = min(rows[0][0].shape[0] - 1, 16)
    fig, axes = plt.subplots(3, 4)
    for row, panels in enumerate(rows):
        m, lat, rec, thr = panels
        axes[row, 0].imshow(m[zs], cmap="gray", vmin=0, vmax=1)
        axes[row, 1].imshow(lat[zs], cmap="gray")
        axes[row, 2].imshow(rec[zs], cmap="gray")
        axes[row, 3].imshow(thr[zs], cmap="gray", vmin=0, vmax=1)
    fig.savefig(path, dpi=150)
    plt.close(fig)
    return True


def sdm_case(core: torch.Tensor, penu: torch.Tensor, lesion: torch.Tensor,
             time_to_treatment: float, resample: bool = True):
    """One case's SDM interpolation and measures, on its masks' device ->
    (``sdm_interpolate``'s six outputs, [DC, HD, ASSD] each a list of the
    lesion's, the core's and the penumbra's): the lesion measures of
    ``recon_intp > 0``, the core's of ``recon_core < 0`` and the penumbra's
    of ``recon_penu > 0``, one EDT call a direction for the three."""
    with torch.inference_mode():
        out = sdm_interpolate(core, penu, time_to_treatment, threshold=0.5,
                              zoom=12, resample=resample)
        recon_core, recon_intp, recon_penu = out[:3]
        got = torch.stack([recon_intp > 0, recon_core < 0,
                           recon_penu > 0]).float()
        want = torch.stack([lesion, core, penu])
        m = binary_measures_per_sample(got[..., None], want[..., None])
        measures = torch.stack([m.dc, m.hd, m.assd]).tolist()
    return out, measures


def infer(args) -> List[Tuple[int, float, float]]:
    """Runs the baseline over ``--fold``'s cases -> per case (case id,
    seconds from its tensors to the measures on the host, seconds with the
    results line and the dumps)."""
    print("Evaluate validation set", args.fold)
    normalization_hours_penumbra = float(args.normalize)
    device = resolve_device(args.device)

    dataset = make_dataset(
        args, [MOD_UNET_CORE, MOD_UNET_PENU],
        [LABEL_CORE, LABEL_PENU, LABEL_LESION],
        flip_split_id=args.hemisflipid)
    ds_test = get_testdata(dataset, args.fold, seed=args.seed)

    results_txt = args.outbasepath + "_sdm_results.txt"
    case_seconds = []
    no_plots_said = False
    for sample in ds_test:
        case_id = int(sample[KEY_CASE_ID][0])
        clinical = np.asarray(sample[KEY_GLOBAL])[0]
        to_to_ta, ta_to_tr = float(clinical[0]), float(clinical[1])
        normalization = normalization_hours_penumbra - to_to_ta
        time_to_treatment = ta_to_tr / normalization

        t0 = time.perf_counter()
        labels = torch.as_tensor(sample[KEY_LABELS][0]).to(device)
        lesion = labels[..., 2]
        if args.groundtruth:
            core, penu = labels[..., 0], labels[..., 1]
        else:
            images = torch.as_tensor(sample[KEY_IMAGES][0]).to(device)
            core, penu = images[..., 0], images[..., 1]

        ((recon_core, recon_intp, recon_penu, latent_core, latent_intp,
          latent_penu), (dc, hd, assd)) = sdm_case(
            core, penu, lesion, time_to_treatment, bool(args.downsample))
        t1 = time.perf_counter()

        print(case_id, "TO-->TR", time_to_treatment)

        if args.visualinspection:
            host = [t.cpu().numpy() for t in (
                core, latent_core, recon_core, recon_core < 0,
                lesion, latent_intp, recon_intp, recon_intp > 0,
                penu, latent_penu, recon_penu, recon_penu > 0)]
            drawn = _inspect(args.outbasepath + "_" + str(case_id)
                             + "_inspect.png",
                             [host[i:i + 4] for i in (0, 4, 8)])
            if not drawn and not no_plots_said:
                print("matplotlib is not installed: no PNGs are written")
                no_plots_said = True

        with open(results_txt, "a") as f:
            print("Evaluate case: {} - DC:{:.3}, HD:{:.3}, ASSD:{:.3}, "
                  "Core recon DC:{:.3}, Penu recon DC:{:.3}".format(
                      case_id, dc[0], hd[0], assd[0], dc[1], dc[2]), file=f)

        idx = next((i for i in ds_test.indices
                    if dataset.case_id(i) == case_id), None)
        affine = dataset.affine(idx, MOD_CBV) if idx is not None else None

        def dump(vol_dhw, name, binarize):
            xyz = zoom2x_inplane_xyz(dhw_to_xyz(vol_dhw.cpu().numpy()))
            if binarize == ">":
                xyz = (xyz > 0).astype(np.float32)
            elif binarize == "<":
                xyz = (xyz < 0).astype(np.float32)
            save_nifti(args.outbasepath + "_" + str(case_id) + name, xyz,
                       affine)

        dump(recon_intp, "_lesion.nii.gz", ">")
        dump(lesion, "_fuctgt.nii.gz", None)
        dump(recon_core, "_core.nii.gz", "<")
        dump(recon_penu, "_penu.nii.gz", ">")
        case_seconds.append((case_id, t1 - t0, time.perf_counter() - t0))
    return case_seconds


if __name__ == "__main__":
    print(datetime.datetime.now())
    infer(get_args_sdm())
    print(datetime.datetime.now())
