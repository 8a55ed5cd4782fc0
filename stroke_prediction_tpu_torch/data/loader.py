"""Fold split and batch iteration (port of data/loader.py, numpy only).

The train/valid split of a fold index list is a seeded shuffle followed by a
``floor(valid_size * n)`` cut (valid first); each epoch visits a fresh
permutation of the subset, from the same numpy RNG stream as the JAX
package, so both give the same case order for the same seed.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from stroke_prediction_tpu_torch.data.dataset import StrokeDataset3D


def fold_split(n_cases: int, indices: Sequence[int], valid_size: float,
               seed: Optional[int], shuffle: bool = True
               ) -> Tuple[List[int], List[int]]:
    """Returns (train, valid) case indices."""
    if not 0 <= valid_size <= 1:
        raise ValueError("[!] valid_size should be in the range [0, 1].")
    items = sorted(set(range(n_cases)).intersection(set(indices)))
    split = int(np.floor(valid_size * len(items)))
    if shuffle:
        np.random.RandomState(seed).shuffle(items)
    return list(items[split:]), list(items[:split])


class BatchLoader:
    """Iterates a dataset subset in shuffled batches of host arrays."""

    def __init__(self, dataset: StrokeDataset3D, indices: Sequence[int],
                 batch_size: int, shuffle: bool = True,
                 seed: Optional[int] = None):
        self.dataset = dataset
        self.indices = list(indices)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._rs = np.random.RandomState(seed)

    def __len__(self) -> int:
        return (len(self.indices) + self.batch_size - 1) // self.batch_size

    def epoch_chunks(self) -> List[List[int]]:
        """One epoch's visiting order as batch-sized index chunks (consumes
        exactly one shuffle from the loader RNG)."""
        order = list(self.indices)
        if self.shuffle:
            self._rs.shuffle(order)
        return [order[start:start + self.batch_size]
                for start in range(0, len(order), self.batch_size)]

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for chunk in self.epoch_chunks():
            yield self.dataset.stack(chunk)


def get_stroke_shape_training_data(dataset: StrokeDataset3D,
                                   fold_indices: Sequence[int], ratio: float,
                                   seed: int = 4, batchsize: int = 2):
    """(training loader, validation loader or None), both shuffled per epoch
    from their own ``seed``-seeded RNG, as in the JAX package."""
    train_idx, valid_idx = fold_split(len(dataset), fold_indices, ratio, seed)
    train = BatchLoader(dataset, train_idx, batchsize, shuffle=True,
                        seed=seed)
    valid = (BatchLoader(dataset, valid_idx, batchsize, shuffle=True,
                         seed=seed)
             if valid_idx else None)
    return train, valid


def get_testdata(dataset, indices, seed=None, shuffle=True) -> BatchLoader:
    """Batch-size-1 loader for per-case test metrics."""
    items = sorted(set(range(len(dataset))).intersection(set(indices)))
    return BatchLoader(dataset, items, batch_size=1, shuffle=shuffle,
                       seed=seed)
