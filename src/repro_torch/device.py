"""Device selection for the port's entry points.

Everything runs on the CUDA card by default.  On a machine without one,
an entry point raises unless the caller asks for the CPU explicitly
(``device="cpu"``, as the CPU tests do); nothing moves to the CPU on its
own.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device`` (default ``cuda``).  Raises when a
    CUDA device is asked for and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           "run the port on the CPU")
    return dev
