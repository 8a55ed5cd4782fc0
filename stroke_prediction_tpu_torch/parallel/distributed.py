"""The process group (port of parallel/distributed.py).

One process runs on one card.  Every process calls :func:`initialize`
once with the coordinator's ``host:port``, the world size and its rank;
``torch.distributed`` joins them over TCP, with NCCL between cards and
gloo on the CPU.  Nothing on the machine announces a cluster, so the caller
always passes all three.  Process ``i`` takes ``cuda:(i % device_count)``.

Each process loads only its share of a global batch
(``data.loader.BatchLoader(process_shard=True)``) and keeps it: there is
no global array to assemble, as JAX's ``global_batch`` does.  The
collectives that make the sharded step equal the one-process step are in
``parallel/collectives.py``.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.distributed as dist

from stroke_prediction_tpu_torch.device import resolve_device


def initialize(coordinator: str, nprocs: int, procid: int,
               backend: Optional[str] = None,
               device: Optional[Union[str, torch.device]] = None
               ) -> torch.device:
    """Join the process group and return this process's device.

    ``device`` ``None`` or ``"cuda"``: ``cuda:(procid % device_count)``
    (raises without a card), ``"cpu"``: the CPU.  ``backend`` ``None``
    picks ``"nccl"`` for the card and ``"gloo"`` for the CPU; an explicit
    backend is used as given (gloo lets two ranks share one card, which
    NCCL refuses)."""
    if not 0 <= procid < nprocs:
        raise ValueError(f"procid {procid} is outside 0..{nprocs - 1}")
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", procid % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=nprocs, rank=procid)
    return dev


def shutdown() -> None:
    """Leave the process group, where this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_lead() -> bool:
    """Process 0 writes the checkpoints, curves and PNGs: every process
    holds the same parameters."""
    return process_index() == 0
