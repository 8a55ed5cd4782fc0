"""Fold split and batch iteration (port of data/loader.py, numpy only).

The train/valid split of a fold index list is a seeded shuffle followed by a
``floor(valid_size * n)`` cut (valid first); each epoch visits a fresh
permutation of the subset, from the same numpy RNG stream as the JAX
package, so both give the same case order for the same seed.

With ``process_shard`` each process of a ``--distributed`` run loads only
its share of every batch, ``chunk[pid::nproc]`` of the order every process
draws alike from the shared seed; a final chunk that does not divide over
the processes is dropped by all of them (``data/loader.py:72-85`` of the
JAX package).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from stroke_prediction_tpu_torch.data.dataset import StrokeDataset3D
from stroke_prediction_tpu_torch.parallel.distributed import (
    process_count, process_index)


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
                 seed: Optional[int] = None, drop_last: bool = False,
                 process_shard: bool = False):
        self.dataset = dataset
        self.indices = list(indices)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.process_shard = process_shard
        self._rs = np.random.RandomState(seed)

    def __len__(self) -> int:
        n = len(self.indices)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def epoch_chunks(self) -> List[List[int]]:
        """One epoch's visiting order as batch-sized index chunks (consumes
        exactly one shuffle from the loader RNG); with ``process_shard``
        this process's share of each."""
        order = list(self.indices)
        if self.shuffle:
            self._rs.shuffle(order)
        pid, nproc = process_index(), process_count()
        chunks: List[List[int]] = []
        for start in range(0, len(order), self.batch_size):
            chunk = order[start:start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                break
            if self.process_shard and nproc > 1:
                if len(chunk) % nproc:
                    break
                chunk = chunk[pid::nproc]
            chunks.append(chunk)
        return chunks

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        for chunk in self.epoch_chunks():
            yield self.dataset.stack(chunk)


def get_stroke_shape_training_data(dataset: StrokeDataset3D,
                                   fold_indices: Sequence[int], ratio: float,
                                   seed: int = 4, batchsize: int = 2,
                                   split: bool = True,
                                   process_shard: bool = False):
    """(training loader, validation loader or None), both shuffled per epoch
    from their own ``seed``-seeded RNG, as in the JAX package.  With
    ``split`` False every fold case trains and there is no validation
    loader (``--steplearning``); ``process_shard`` as
    :class:`BatchLoader`'s."""
    train_idx, valid_idx = fold_split(len(dataset), fold_indices,
                                      ratio if split else 0.0, seed)
    train = BatchLoader(dataset, train_idx, batchsize, shuffle=True,
                        seed=seed, process_shard=process_shard)
    valid = (BatchLoader(dataset, valid_idx, batchsize, shuffle=True,
                         seed=seed, process_shard=process_shard)
             if split and valid_idx else None)
    return train, valid


def get_stroke_prediction_training_data(dataset: StrokeDataset3D,
                                        fold_indices: Sequence[int],
                                        ratio: float, seed: int = 4,
                                        batchsize: int = 2,
                                        split: bool = True,
                                        process_shard: bool = False):
    """Phase 2's loaders (U-Net segmentations as images): the same split,
    order and ``process_shard`` as :func:`get_stroke_shape_training_data`,
    as in the JAX package."""
    return get_stroke_shape_training_data(dataset, fold_indices, ratio,
                                          seed, batchsize, split,
                                          process_shard)


def get_testdata(dataset, indices, seed=None, shuffle=True) -> BatchLoader:
    """Batch-size-1 loader for per-case test metrics."""
    items = sorted(set(range(len(dataset))).intersection(set(indices)))
    return BatchLoader(dataset, items, batch_size=1, shuffle=shuffle,
                       seed=seed)
