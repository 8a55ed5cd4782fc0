"""Device selection for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU.  There is no
silent fallback: asking for (or defaulting to) ``cuda`` on a machine without
a usable card raises.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` or ``"cuda"`` -> the CUDA device (raises if there is none);
    ``"cpu"`` -> the CPU, which runs every kernel's plain PyTorch version."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a CUDA device was requested but torch.cuda.is_available() "
                "is False; pass device='cpu' (--device cpu) to run the "
                "plain CPU path")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
