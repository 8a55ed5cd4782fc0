"""The stroke dataset: NIfTI ingest, synthetic stand-in, host cache (port of
data/dataset.py, numpy only).

For the same seed this module gives byte-identical volumes to the JAX
package's.  The synthetic disk cache writes each case atomically (temporary
file, then rename), so concurrent processes never read a partial file.
Volumes are loaded
(or generated) once, preprocessed (in-plane resample, deterministic
hemispheric flip, padding) and cached in host RAM in the device layout
``(D, H, W, C)`` float32.

The clinical vector follows the reference: index 0 = tO_to_tA (onset to
admission, hours), index 1 = tA_to_tR (admission to recanalization,
hours), then NHISS, sex, age.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from stroke_prediction_tpu_torch.ops.resize import zoom_inplane_xyz

KEY_CASE_ID = "case_id"
KEY_IMAGES = "images"
KEY_LABELS = "labels"
KEY_GLOBAL = "clinical"

# Modality / label file-name suffixes of the reference dataset
MOD_CBV = "_CBV_reg1_downsampled"
MOD_TTD = "_TTD_reg1_downsampled"
MOD_UNET_CORE = "_unet_core"
MOD_UNET_PENU = "_unet_penu"
LABEL_CORE = "_CBVmap_subset_reg1_downsampled"
LABEL_PENU = "_TTDmap_subset_reg1_downsampled"
LABEL_LESION = "_FUCT_MAP_T_Samplespace_subset_reg1_downsampled"


class NiftiCaseProvider:
    """Loads cases from the reference dataset's on-disk layout
    (``<root>/<case>/train<case><suffix>.nii.gz`` and a clinical CSV with
    one row per case, first column = case id)."""

    FN_PREFIX = "train"

    def __init__(self, root_dir: str, clinical_csv: str):
        self._root = root_dir
        self._clinical = self._load_csv(clinical_csv)

    @staticmethod
    def _load_csv(filename: str, row_offset: int = 1) -> List[List[str]]:
        with open(filename, "r") as f:
            return [row for i, row in enumerate(csv.reader(f, delimiter=","))
                    if i >= row_offset]

    def __len__(self) -> int:
        return len(self._clinical)

    def case_id(self, index: int) -> int:
        return int(self._clinical[index][0])

    def clinical(self, index: int) -> np.ndarray:
        return np.array([float(v) for v in self._clinical[index][1:]],
                        dtype=np.float32)

    def _path(self, index: int, suffix: str) -> str:
        cid = self.case_id(index)
        return os.path.join(self._root, str(cid),
                            f"{self.FN_PREFIX}{cid}{suffix}.nii.gz")

    def volume(self, index: int, suffix: str) -> np.ndarray:
        """Returns (X, Y, Z) float32."""
        from stroke_prediction_tpu_torch.utils.nifti import load_volume
        return load_volume(self._path(index, suffix))

    def affine(self, index: int, suffix: str):
        from stroke_prediction_tpu_torch.utils.nifti import load_affine
        return load_affine(self._path(index, suffix))


class SyntheticCaseProvider:
    """Generates shape-consistent synthetic stroke cases, deterministic per
    (seed, case id): a penumbra blob, a core blob inside it, a follow-up
    lesion between the two, CBV / TTD images correlated with the masks,
    pseudo-U-Net segmentations and 5 clinical scalars."""

    N_GLOBALS = 5

    def __init__(self, n_cases: int = 29,
                 shape_xyz: Tuple[int, int, int] = (256, 256, 28),
                 seed: int = 4,
                 penu_radius_frac: Tuple[float, float] = (0.12, 0.2),
                 cache_dir: Optional[str] = None):
        self._n = n_cases
        self._shape = tuple(shape_xyz)
        self._seed = seed
        self._penu_frac = penu_radius_frac
        self._cache: Dict[int, Dict[str, np.ndarray]] = {}
        self._cache_dir = cache_dir

    def __len__(self) -> int:
        return self._n

    def case_id(self, index: int) -> int:
        return index

    def _blob(self, rng, center, radii, wobble=0.25):
        x, y, z = self._shape
        gx = np.arange(x, dtype=np.float64)[:, None, None]
        gy = np.arange(y, dtype=np.float64)[None, :, None]
        gz = np.arange(z, dtype=np.float64)[None, None, :]
        # low-frequency radial wobble makes the blob non-ellipsoidal
        ph = rng.uniform(0, 2 * np.pi, 3)
        fx = 1 + wobble * np.sin(2 * np.pi * gx / x * 2 + ph[0])
        fy = 1 + wobble * np.sin(2 * np.pi * gy / y * 2 + ph[1])
        r2 = (((gx - center[0]) / (radii[0] * fx)) ** 2
              + ((gy - center[1]) / (radii[1] * fy)) ** 2
              + ((gz - center[2]) / radii[2]) ** 2)
        return (r2 <= 1.0).astype(np.float32)

    def _gen(self, index: int) -> Dict[str, np.ndarray]:
        x, y, z = self._shape
        rng = np.random.RandomState(self._seed * 1000 + index)
        center = np.array([rng.uniform(0.35, 0.65) * x,
                           rng.uniform(0.35, 0.65) * y,
                           rng.uniform(0.4, 0.6) * z])
        lo, hi = self._penu_frac
        r_penu = np.array([rng.uniform(lo, hi) * x,
                           rng.uniform(lo, hi) * y,
                           rng.uniform(0.25, 0.45) * z])
        frac_core = rng.uniform(0.3, 0.6)

        penu = self._blob(rng, center, r_penu)
        core_center = center + rng.uniform(-0.05, 0.05, 3) * [x, y, z] * 0.2
        core = self._blob(rng, core_center, r_penu * frac_core)
        core = core * penu  # core within penumbra

        to_to_ta = rng.uniform(0.5, 4.0)          # onset -> admission (h)
        ta_to_tr = rng.uniform(0.5, 5.0)          # admission -> recanalization
        t_norm = ta_to_tr / (10.0 - to_to_ta)
        frac_lesion = frac_core + (1 - frac_core) * np.clip(t_norm, 0, 1)
        lesion = self._blob(rng, core_center, r_penu * frac_lesion) * penu
        lesion = np.maximum(lesion, core)

        noise = rng.randn(x, y, z).astype(np.float32)
        cbv = 4.0 + 2.0 * noise - 3.0 * core + 1.0 * penu
        ttd = 5.0 + 3.0 * np.abs(noise) + 20.0 * penu + 5.0 * lesion

        def noisy_seg(m):
            s = m + 0.15 * rng.randn(x, y, z).astype(np.float32)
            return np.clip(s, 0.0, 1.0)

        clinical = np.array([to_to_ta, ta_to_tr, rng.uniform(0, 20),
                             rng.randint(0, 2), rng.uniform(30, 90)],
                            dtype=np.float32)
        return {
            MOD_CBV: cbv.astype(np.float32),
            MOD_TTD: ttd.astype(np.float32),
            MOD_UNET_CORE: noisy_seg(core),
            MOD_UNET_PENU: noisy_seg(penu),
            LABEL_CORE: core,
            LABEL_PENU: penu,
            LABEL_LESION: lesion,
            KEY_GLOBAL: clinical,
        }

    def _case(self, index: int) -> Dict[str, np.ndarray]:
        if index in self._cache:
            return self._cache[index]
        if self._cache_dir is None:
            self._cache[index] = self._gen(index)
            return self._cache[index]
        x, y, z = self._shape
        fn = os.path.join(
            self._cache_dir,
            f"synth_s{self._seed}_{x}x{y}x{z}_"
            f"p{self._penu_frac[0]}-{self._penu_frac[1]}_c{index}.npz")
        if os.path.exists(fn):
            with np.load(fn) as d:
                self._cache[index] = {k: d[k] for k in d.files}
            return self._cache[index]
        case = self._gen(index)
        os.makedirs(self._cache_dir, exist_ok=True)
        tmp = f"{fn}.{os.getpid()}.tmp.npz"
        np.savez(tmp, **case)
        os.replace(tmp, fn)      # atomic: a concurrent reader sees all or none
        self._cache[index] = case
        return case

    def clinical(self, index: int) -> np.ndarray:
        return self._case(index)[KEY_GLOBAL]

    def volume(self, index: int, suffix: str) -> np.ndarray:
        case = self._case(index)
        if suffix not in case:
            raise KeyError(f"Unknown modality suffix: {suffix}")
        return case[suffix]

    def affine(self, index: int, suffix: str):
        return np.eye(4, dtype=np.float32)


class StrokeDataset3D:
    """Cached, preprocessed dataset view over a case provider.

    Samples are in device layout: images/labels ``(D, H, W, C)`` float32
    with (D, H, W) = (Z, Y, X); clinical is a flat ``(n_globals,)`` vector.
    Preprocessing at cache time, in reference transform order: in-plane
    resample -> hemispheric flip fixed by case id -> pad images.
    """

    def __init__(self, provider, modalities: Sequence[str],
                 labels: Sequence[str], resample: Optional[float] = None,
                 resample_order_images: int = 1,
                 resample_order_labels: int = 0,
                 flip_split_id: Optional[float] = None,
                 pad: Optional[Tuple[int, int, int]] = None,
                 pad_value: float = 0.0):
        self._provider = provider
        self._modalities = list(modalities)
        self._labels = list(labels)
        self._resample = resample
        self._orders = (resample_order_images, resample_order_labels)
        self._flip_split_id = flip_split_id
        self._pad = pad
        self._pad_value = pad_value
        self._cache: Dict[int, Dict[str, np.ndarray]] = {}

    def __len__(self) -> int:
        return len(self._provider)

    def case_id(self, index: int) -> int:
        return self._provider.case_id(index)

    def affine(self, index: int, suffix: str):
        return self._provider.affine(index, suffix)

    def _prep(self, index: int, suffixes: Sequence[str], order: int,
              pad: bool) -> Optional[np.ndarray]:
        if not suffixes:
            return None
        chans = []
        flip = (self._flip_split_id is not None
                and self._provider.case_id(index) > self._flip_split_id)
        for sfx in suffixes:
            v = self._provider.volume(index, sfx)          # (X, Y, Z)
            if self._resample is not None and self._resample != 1:
                v = zoom_inplane_xyz(v, self._resample, order)
            if flip:
                v = v[::-1]                                  # X-axis flip
            chans.append(np.transpose(v, (2, 1, 0)))        # (D, H, W)
        vol = np.stack(chans, axis=-1).astype(np.float32)   # (D, H, W, C)
        if pad and self._pad is not None:
            # the reference pads (X, Y, Z) by (px, py, pz); here (Z, Y, X)
            px, py, pz = self._pad
            vol = np.pad(vol, ((pz, pz), (py, py), (px, px), (0, 0)),
                         constant_values=self._pad_value)
        return vol

    def sample(self, index: int) -> Dict[str, np.ndarray]:
        if index not in self._cache:
            self._cache[index] = {
                KEY_CASE_ID: self._provider.case_id(index),
                KEY_IMAGES: self._prep(index, self._modalities,
                                       self._orders[0], pad=True),
                KEY_LABELS: self._prep(index, self._labels,
                                       self._orders[1], pad=False),
                KEY_GLOBAL: self._provider.clinical(index),
            }
        return self._cache[index]

    def stack(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        """Stack cases into a batch dict (host)."""
        samples = [self.sample(i) for i in indices]
        out = {KEY_CASE_ID: np.array([s[KEY_CASE_ID] for s in samples])}
        for key in (KEY_IMAGES, KEY_LABELS, KEY_GLOBAL):
            if samples[0][key] is None:
                out[key] = None
            else:
                out[key] = np.stack([s[key] for s in samples], axis=0)
        return out
